"""Load the trained tiny retrieval checkpoint with numpy alone.

The port's counterpart of ``pyramidkv_tpu/train/loop.py``'s
``load_checkpoint`` and ``tiny_retrieval_spec``: the npz holds the model's
geometry as JSON (``spec``) and each parameter leaf as ``arr_<path>``
(f32), the JAX parameter tree's layout, which
``models.convert.params_from_numpy`` takes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import ModelSpec
from ..models.convert import params_from_numpy

#: the repo's trained checkpoint: 8 layers, 8 query heads on 4 KV heads,
#: D = 32, hidden 256, intermediate 1024, tied embeddings, trained on the
#: needle task
CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "tiny_retrieval.npz")


def tiny_retrieval_spec(vocab_size: int, max_pos: int = 4096) -> ModelSpec:
    """The checkpoint's geometry: Llama in miniature with GQA 8 / 4."""
    return ModelSpec(
        name="tiny-retrieval", vocab_size=vocab_size, hidden_size=256,
        intermediate_size=1024, num_hidden_layers=8,
        num_attention_heads=8, num_key_value_heads=4, head_dim=32,
        rope_theta=10000.0, max_position_embeddings=max_pos,
        tie_word_embeddings=True,
    )


def load_numpy_tree(path: str = CHECKPOINT):
    """(spec, nested dict of f32 numpy arrays) of an npz checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        spec = ModelSpec(**json.loads(str(z["spec"])))
        tree: dict = {}
        for name in z.files:
            if name.startswith("arr_"):
                *parents, leaf = name[4:].split("/")
                d = tree
                for p in parents:
                    d = d.setdefault(p, {})
                d[leaf] = np.asarray(z[name], np.float32)
    return spec, tree


def load_checkpoint(path: str = CHECKPOINT, device=None,
                    dtype: torch.dtype = torch.float32):
    """(spec, params) of an npz checkpoint: the port's ``ModelSpec`` and
    ``params_from_numpy``'s tree in ``dtype`` on ``device`` (f32 on the CPU
    for the tests; bf16 on the card)."""
    spec, tree = load_numpy_tree(path)
    return spec, params_from_numpy(tree, device=device, dtype=dtype)
