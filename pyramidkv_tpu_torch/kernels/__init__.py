"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their wrappers."""

from .decode_attn import decode_attention
from .flash_prefill import flash_causal_attention

__all__ = ["decode_attention", "flash_causal_attention"]
