"""PyTorch/CUDA port of pyramidkv_tpu for one NVIDIA H100.

Imports torch and numpy only: never jax, never pyramidkv_tpu.
"""
