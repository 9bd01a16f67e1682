"""The weight bridge between the JAX param tree and the port's params.

The port keeps the JAX package's layout (``pyramidkv_tpu/models/llama.py::
init_params``): a dict with ``embed`` [V, Dm], ``final_norm`` [Dm],
``lm_head`` [Dm, V] (absent when embeddings are tied) and ``layers``, whose
leaves are stacked along a leading layer axis with matmul weights as
``[L, in, out]`` used as ``x @ w``.  Keeping the layout makes the bridge an
identity on names and shapes, and a layer's weights are views
(``w[i]``), never copies.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ModelSpec
from ..ops.quant import QuantizedKVRegion, QuantizedTensor
from .weights import QuantW


def _device(device, what: str):
    """``device=None`` means the CUDA card, and raises when there is none
    (as ``Engine`` does)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}: no CUDA device; pass device='cpu' "
                               "for the CPU")
        device = "cuda"
    return device


def params_from_numpy(tree: dict, *, device=None,
                      dtype: torch.dtype = None) -> dict:
    """JAX param tree as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    params)``) -> the port's params on ``device``.

    ``device=None`` means the CUDA card, and raises when there is none (as
    ``Engine`` does); pass ``device="cpu"`` for the CPU.  ``dtype`` casts
    every float leaf (None keeps each leaf's dtype; bf16 numpy leaves from
    ml_dtypes go through float32 exactly).  Quantized leaves (the JAX
    ``QuantW`` NamedTuple, recognised by its fields) become the port's
    :class:`~.weights.QuantW` with int8 codes and f32 scales kept as they
    are."""
    device = _device(device, "params_from_numpy")

    def tensor(x, cast):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device=device, dtype=cast or t.dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if getattr(x, "_fields", None) == QuantW._fields:
            return QuantW(codes=tensor(x.codes, None),
                          scale=tensor(x.scale, None))
        return tensor(x, dtype)

    return conv(tree)


def region_from_numpy(reg, *, device=None) -> QuantizedKVRegion:
    """A JAX KIVI ``QuantizedKVRegion`` (leaves as numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, reg)``) -> the port's on
    ``device``, leaves unchanged (int8 codes, f32 scales and zeros, the JAX
    shapes).  ``device`` as :func:`params_from_numpy`.  Outlier sidecars
    (KVQuant) are not ported and must be None."""
    if reg.k_out_idx is not None or reg.v_out_idx is not None:
        raise NotImplementedError(
            "KVQuant outlier sidecars are not ported yet (ROADMAP queue 1 #6)")
    device = _device(device, "region_from_numpy")

    def part(qt):
        return QuantizedTensor(*(torch.from_numpy(np.array(x)).to(device)
                                 for x in (qt.codes, qt.scale, qt.zero)))

    return QuantizedKVRegion(k=part(reg.k), v=part(reg.v))


def init_params(spec: ModelSpec, generator: torch.Generator, device,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random-normal params of the JAX ``init_params`` distribution (not its
    bits): matmul weights ~ N(0, 1/fan_in), embed, lm_head and (with
    ``attention_bias``) the QKV biases ~ N(0, 0.02^2), norms at 1 (at 0
    under Gemma-2's (1 + w) form, with its ``attn_post_norm`` and
    ``mlp_post_norm`` leaves; no lm_head when the embedding is tied).
    Drawn in f32 one layer at a time on ``device`` (the generator's device),
    then cast, so the f32 transient is one layer."""
    from .llama import check_ported

    check_ported(spec)
    L, Dm, I = spec.num_hidden_layers, spec.hidden_size, spec.intermediate_size
    H, KV, Dh, V = (spec.num_attention_heads, spec.num_key_value_heads,
                    spec.head_dim, spec.vocab_size)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    shapes = {
        "wq": (Dm, H * Dh), "wk": (Dm, KV * Dh), "wv": (Dm, KV * Dh),
        "wo": (H * Dh, Dm), "w_gate": (Dm, I), "w_up": (Dm, I),
        "w_down": (I, Dm),
    }
    layers = {}
    for name, shape in shapes.items():
        w = torch.empty((L, *shape), dtype=dtype, device=device)
        for i in range(L):
            w[i] = normal(shape, 1.0 / math.sqrt(shape[0]))
        layers[name] = w
    if spec.attention_bias:
        # Qwen2's QKV biases ~ N(0, 0.02^2), as JAX's init_params draws them
        for name, width in (("bq", H * Dh), ("bk", KV * Dh), ("bv", KV * Dh)):
            layers[name] = normal((L, width), 0.02)
    # unit-offset RMSNorm ((1 + w), Gemma-2) zero-initialises its weights
    norm1 = torch.zeros if spec.rmsnorm_unit_offset else torch.ones
    norms = ["attn_norm", "mlp_norm"]
    if spec.post_block_norms:
        norms += ["attn_post_norm", "mlp_post_norm"]
    for name in norms:
        layers[name] = norm1((L, Dm), dtype=dtype, device=device)
    params = {
        "embed": normal((V, Dm), 0.02),
        "final_norm": norm1((Dm,), dtype=dtype, device=device),
        "layers": layers,
    }
    if not spec.tie_word_embeddings:
        params["lm_head"] = normal((Dm, V), 0.02)
    return params
