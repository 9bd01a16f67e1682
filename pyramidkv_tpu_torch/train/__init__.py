"""The trained tiny retrieval checkpoint on the port: its tokenizer
(:mod:`tokenizer`), the needle prompts (:mod:`data`) and a numpy-only
loader (:mod:`checkpoint`).  No training: the checkpoint was trained by the
JAX package's rig (``pyramidkv_tpu/train``)."""

from .checkpoint import CHECKPOINT, load_checkpoint, tiny_retrieval_spec
from .tokenizer import ToyTokenizer

__all__ = ["CHECKPOINT", "ToyTokenizer", "load_checkpoint",
           "tiny_retrieval_spec"]
