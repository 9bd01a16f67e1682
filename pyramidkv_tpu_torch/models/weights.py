"""Weight quantization (int8 / packed int4, optional group scales):
counterpart of ``pyramidkv_tpu/models/weights.py`` on torch tensors.

Decode reads every weight once per step, so it is bound by weight bytes:
int8 halves them and packed int4 halves them again.  With per-output-channel
symmetric scales the dequant factors out of the matmul exactly,

    x @ (codes * scale_col) == (x @ codes) * scale_col,

and with AWQ-style group scales ``[G, out]`` it factors out of each group's
partial product, ``y = sum_G (x_G @ codes_G) * scale[G]``.

Layout (the JAX package's, so the weight bridge is an identity): int4 codes
are int8 bytes ``[..., in, out/2]`` holding two signed nibbles in the
span-planar order of :func:`pack_span`; int8 codes keep ``[..., in, out]``.
The embedding quantizes per row; embed and lm_head stay int8 unless
``lm_head_nbits=4``.

:func:`mm` routes decode-sized products to the streaming kernels by the JAX
package's eligibility rules (``_int4_kernel_mm``, ``_int8_kernel_mm``), and
everything else to dequant + ``torch.matmul`` (outside any Pallas kernel in
JAX too).  JAX needs a ``LayerView`` so that its kernels index a stacked
buffer in-kernel; here ``codes[i]`` of a contiguous stack is already a view
that costs no copy, so the model passes 2-D views.  MoE's ``expert_mm`` and
the TPU tile knobs (``_INT4_KERNEL_BLOCKS/_SUBIN/_OP``) are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels.int4_matmul import (int4_matmul, int4_matmul_dma,
                                   int4_matmul_dma_plain, int4_matmul_plain,
                                   int8_matmul, int8_matmul_plain, int8_tiles,
                                   pack_span)
from ..kernels.int4_matmul import unpack_nibbles as unpack4

__all__ = ["QuantW", "pack_span", "pack4", "unpack4", "is_packed4",
           "dq_codes", "quantize_weights", "fuse_packed_matmuls", "mm",
           "embed_lookup", "weight_dtype"]


class QuantW(NamedTuple):
    """Quantized weight: ``codes`` int8 (``[..., in, out]``, or packed int4
    ``[..., in, out/2]``) and f32 ``scale`` (``[..., out]`` per channel,
    ``[..., G, out]`` per group, ``[vocab]`` for the embedding's rows)."""

    codes: torch.Tensor
    scale: torch.Tensor


def pack4(c: torch.Tensor) -> torch.Tensor:
    """Signed values in [-8, 7], last axis even -> int8 bytes, planar within
    :func:`pack_span`-byte spans."""
    out2 = c.shape[-1] // 2
    s = pack_span(out2)
    v = (c.to(torch.int32) & 0xF).to(torch.uint8)
    v = v.reshape(*c.shape[:-1], out2 // s, 2, s)
    return (v[..., 0, :] | (v[..., 1, :] << 4)).view(torch.int8).reshape(
        *c.shape[:-1], out2)


def is_packed4(w: QuantW) -> bool:
    """True when ``w.codes`` holds packed int4 nibbles (out axis halved
    relative to the scale's)."""
    return w.codes.shape[-1] * 2 == w.scale.shape[-1]


def _logical_codes(w: QuantW) -> torch.Tensor:
    """Codes at their logical ``[..., in, out]`` shape, still integer."""
    return unpack4(w.codes) if is_packed4(w) else w.codes


def dq_codes(w: QuantW, dtype) -> torch.Tensor:
    """The integer codes at their logical shape, cast to ``dtype``."""
    return _logical_codes(w).to(dtype)


def _quantize_one(wf: torch.Tensor, nbits: int,
                  group_size: Optional[int]) -> QuantW:
    qmax = 127.0 if nbits == 8 else 7.0
    in_dim = wf.shape[-2]
    if group_size and in_dim % group_size == 0 and in_dim > group_size:
        g = group_size
        wg = wf.reshape(*wf.shape[:-2], in_dim // g, g, wf.shape[-1])
        amax = wg.abs().amax(dim=-2)                          # [..., G, out]
        scale = amax.clamp_min(1e-8) / qmax
        codes = torch.clamp(torch.round(wg / scale[..., None, :]),
                            -qmax, qmax).reshape(wf.shape).to(torch.int8)
    else:
        amax = wf.abs().amax(dim=-2)                          # [..., out]
        scale = amax.clamp_min(1e-8) / qmax
        codes = torch.clamp(torch.round(wf / scale[..., None, :]),
                            -qmax, qmax).to(torch.int8)
    if nbits == 4:
        codes = pack4(codes)
    return QuantW(codes=codes, scale=scale)


def _quantize_leaf(w: torch.Tensor, nbits: int = 8,
                   group_size: Optional[int] = None) -> QuantW:
    """One weight -> QuantW, the JAX package's arithmetic.  A stacked
    ``[L, in, out]`` leaf is quantized one layer at a time (scales are per
    layer, so the result is the same) to keep the f32 transient to one
    layer."""
    if nbits not in (8, 4):
        raise ValueError(f"weight nbits must be 4 or 8, got {nbits}")
    if w.dim() < 3:
        return _quantize_one(w.float(), nbits, group_size)
    parts = [_quantize_one(w[i].float(), nbits, group_size)
             for i in range(w.shape[0])]
    return QuantW(codes=torch.stack([p.codes for p in parts]),
                  scale=torch.stack([p.scale for p in parts]))


#: weight leaves that flow through matmuls (norm vectors stay as they are)
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "router")


def quantize_weights(params: dict, nbits: int = 8,
                     group_size: Optional[int] = None,
                     lm_head_nbits: Optional[int] = None,
                     lm_head_pad_to: Optional[int] = None) -> dict:
    """bf16/f32 params -> quantized params (same structure, matmul leaves
    replaced by :class:`QuantW`), codes and scales bit-equal to the JAX
    package's ``quantize_weights``.

    ``group_size`` applies to stacked layer leaves ``[L, in, out]``; the
    embedding quantizes per row to int8; the (untied) lm_head to
    ``lm_head_nbits`` (default 8) per channel, its vocab axis first
    zero-padded to a multiple of ``lm_head_pad_to`` (the model slices the
    logits back to ``spec.vocab_size``)."""
    if nbits not in (8, 4):
        raise ValueError(f"weight nbits must be 4 or 8, got {nbits}")
    out = dict(params)
    out["layers"] = {
        k: (_quantize_leaf(v, 8 if k == "router" else nbits,
                           group_size if k != "router" and v.dim() == 3
                           else None)
            if k in _MATMUL_LEAVES else v)
        for k, v in params["layers"].items()
    }
    emb = params["embed"].float()
    esc = emb.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    out["embed"] = QuantW(
        codes=torch.clamp(torch.round(emb / esc[:, None]), -127,
                          127).to(torch.int8),
        scale=esc)
    del emb
    if "lm_head" in params:
        lm = params["lm_head"]
        if lm_head_pad_to and lm.shape[-1] % lm_head_pad_to:
            pad = lm_head_pad_to - lm.shape[-1] % lm_head_pad_to
            lm = torch.nn.functional.pad(lm, (0, pad))
        out["lm_head"] = _quantize_leaf(lm, lm_head_nbits or 8)
    return out


#: above this many x rows the grouped dequant path switches from per-group
#: partials ([rows, G, out] transient) to one dequantized [in, out] matmul
_GROUP_EINSUM_MAX_ROWS = 256


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1]) if x.dim() > 1 else 1


def _mm_grouped(x: torch.Tensor, w: QuantW) -> torch.Tensor:
    """x @ dequant(w) for group scales: logical codes [in, out], scale
    [G, out].  Partials stay in x's dtype and the scale-weighted sum over
    groups is f32, as in JAX."""
    codes = _logical_codes(w)
    in_dim, out_dim = codes.shape
    n_groups = w.scale.shape[0]
    g = in_dim // n_groups
    codes_g = codes.reshape(n_groups, g, out_dim)
    if _rows(x) <= _GROUP_EINSUM_MAX_ROWS:
        xr = x.reshape(*x.shape[:-1], n_groups, g)
        p = torch.einsum("...Gg,Ggo->...Go", xr, codes_g.to(x.dtype))
        return (p.float() * w.scale.float()).sum(dim=-2).to(x.dtype)
    deq = (codes_g.to(x.dtype) * w.scale[:, None, :].to(x.dtype)).reshape(
        in_dim, out_dim)
    return x @ deq


#: row cap of the packed-int4 kernel (decode and verify-sized x)
_INT4_KERNEL_MAX_ROWS = 384
#: the windowed int4 kernel instead of the streaming one: [flag, win]
_INT4_KERNEL_DMA = [False, 512]
#: the int4 kernel's in-block in the JAX package: group sizes must divide
#: min(this, in) there, so the same rule decides eligibility here
_INT4_BLOCK_IN = 2048


def kernel_route(w: QuantW, rows: int):
    """Which streaming kernel :func:`mm` sends a product of ``rows`` x rows
    with ``w`` to, by the JAX package's rules (``_int4_kernel_mm``,
    ``_int8_kernel_mm``): ``(name, group_size)`` with name one of
    ``"int4_matmul"``, ``"int4_matmul_dma"``, ``"int8_matmul"``, or None for
    the dequant path."""
    if w.codes.dim() != 2:
        return None
    in_dim = w.codes.shape[0]
    if is_packed4(w):
        if rows > _INT4_KERNEL_MAX_ROWS:
            return None
        if w.scale.dim() == 2:
            gs = in_dim // w.scale.shape[0]
            if gs <= 0 or in_dim % gs or min(_INT4_BLOCK_IN, in_dim) % gs:
                return None
            return "int4_matmul", gs
        if _INT4_KERNEL_DMA[0] and w.codes.shape[-1] % 128 == 0:
            return "int4_matmul_dma", 0
        return "int4_matmul", 0
    if (w.scale.dim() == 1 and rows <= 8
            and int8_tiles(in_dim, w.codes.shape[-1])[0]):
        return "int8_matmul", 0
    return None


#: each streaming kernel by name, with its plain version
KERNELS = {
    "int4_matmul": (int4_matmul, int4_matmul_plain),
    "int4_matmul_dma": (int4_matmul_dma, int4_matmul_dma_plain),
    "int8_matmul": (int8_matmul, int8_matmul_plain),
}


def kernel_mm(x: torch.Tensor, w: QuantW, impl: str = "kernel"):
    """The streaming-kernel product for a decode-sized ``x`` (its plain
    version when ``impl == "plain"``), or None when :func:`kernel_route`
    sends it elsewhere.  Returns [..., out] in x's dtype."""
    route = kernel_route(w, _rows(x))
    if route is None:
        return None
    name, gs = route
    fn = KERNELS[name][impl == "plain"]
    kw = {"group_size": gs} if name == "int4_matmul" else {}
    if name == "int4_matmul_dma" and impl != "plain":
        kw["win"] = _INT4_KERNEL_DMA[1]
    y = fn(x.reshape(_rows(x), x.shape[-1]), w.codes, w.scale, **kw)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def mm(x: torch.Tensor, w, impl: str = "kernel") -> torch.Tensor:
    """x @ w for plain or quantized weights.  ``impl="plain"`` sends the
    products the kernels would take to their plain versions instead."""
    if not isinstance(w, QuantW):
        return x @ w
    y = kernel_mm(x, w, impl)
    if y is not None:
        return y
    if w.scale.dim() == w.codes.dim():          # group-wise scales
        return _mm_grouped(x, w)
    y = x @ dq_codes(w, x.dtype)
    return y * (w.scale[..., None, :] if w.scale.dim() > 1
                else w.scale).to(y.dtype)


def embed_lookup(embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the (possibly per-row quantized) embedding, in ``dtype``."""
    if isinstance(embed, QuantW):
        rows = embed.codes[tokens].to(dtype)
        return rows * embed.scale[tokens].to(dtype)[..., None]
    return embed[tokens]


def weight_dtype(params: dict):
    """The activation dtype to use (embed codes are int8 when quantized)."""
    emb = params["embed"]
    return torch.bfloat16 if isinstance(emb, QuantW) else emb.dtype


def _fusable(*ws) -> bool:
    """Stacked packed-int4 leaves with the same stack/in dims and scale
    layout (the JAX rule, without its sharding test)."""
    if not all(isinstance(w, QuantW) and is_packed4(w) and w.codes.dim() == 3
               for w in ws):
        return False
    w0 = ws[0]
    if not all(w.codes.shape[:2] == w0.codes.shape[:2]
               and w.scale.dim() == w0.scale.dim() for w in ws):
        return False
    return w0.scale.dim() != 3 or all(
        w.scale.shape[1] == w0.scale.shape[1] for w in ws)


def fuse_packed_matmuls(params: dict) -> dict:
    """Concatenate ``wq/wk/wv -> wqkv`` and ``w_gate/w_up -> w_gateup`` along
    the out axis for stacked packed-int4 leaves: one kernel launch instead of
    three (two) with the same arithmetic.  Opt-in, as in JAX: the fused
    copy is new memory while the caller still holds the unfused tree."""
    lay = params.get("layers")
    if not isinstance(lay, dict):
        return params

    def spans_ok(names):
        # concatenation keeps the span-planar layout only when every part
        # has the span the fused width derives
        ws = [lay[n] for n in names]
        fused_out2 = sum(w.codes.shape[-1] for w in ws)
        return all(pack_span(w.codes.shape[-1]) == pack_span(fused_out2)
                   for w in ws)

    def cat(names):
        ws = [lay[n] for n in names]
        return QuantW(codes=torch.cat([w.codes for w in ws], dim=-1),
                      scale=torch.cat([w.scale for w in ws], dim=-1))

    lay = dict(lay)
    changed = False
    for fused, names in (("wqkv", ("wq", "wk", "wv")),
                         ("w_gateup", ("w_gate", "w_up"))):
        if (all(n in lay for n in names)
                and _fusable(*(lay[n] for n in names)) and spans_ok(names)):
            lay[fused] = cat(names)
            for n in names:
                del lay[n]
            changed = True
    if not changed:
        return params
    out = dict(params)
    out["layers"] = lay
    return out
