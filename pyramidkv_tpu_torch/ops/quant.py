"""KIVI KV-cache quantization in PyTorch (counterpart of
``pyramidkv_tpu/ops/quant.py``).

Asymmetric min/max affine quantization (HQQ's scheme: code =
round((x - min) / scale), x_hat = code * scale + min) of the compacted
prefill region, with int4/int2 codes PLANAR-packed into int8 along the slot
axis: byte j holds slots ``{j + p * W}`` in bit-plane p (W = plane width),
not adjacent slots.  Keys are grouped along slots (per-channel scales), values
along channels (per-token scales); ``layout="pa"`` widens each group to its
whole axis.

Also here: the plain versions of the port's region kernels
(``kernels/quant_decode.py``, ``kernels/quant_fused_decode.py``) —
:func:`quant_decode_attention_plain` (f32 dequantization, then f32
attention partials, as the JAX package's tests define the reference of its
group-layout kernels, JAX's opt-in route) and
:func:`quant_region_attention_fused` (the factored dequantization, per
bit-plane, with the JAX function's bf16 roundings: JAX's default decode of
both layouts).

Not ported yet (ROADMAP queue 1 #6): KVQuant's outlier sidecar and the
chunked dequantization scan ``quant_region_attention_partials``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .attention import decode_attention_partials, merge_attention_partials

_NEG_INF = torch.finfo(torch.float32).min


class QuantizedTensor(NamedTuple):
    #: packed codes, int8 with uint8 meaning; for 4/2 bits the packed axis is
    #: divided by 8 // nbits
    codes: torch.Tensor
    scale: torch.Tensor  #: [..., groups, 1] float32
    zero: torch.Tensor   #: [..., groups, 1] float32


class QuantizedKVRegion(NamedTuple):
    """The post-compaction prefill slots of one layer (or, in a cache, the
    layers stacked on a leading axis) in KIVI form.

    k: codes slot-major ``[B, H, S_pad/per, D]``, scale/zero
    ``[B, H, D, S_pad/g, 1]`` (groups along slots); v: codes
    ``[B, H, S_pad/per, Dp]``, scale/zero ``[B, H, S_pad, Dp/g, 1]`` (groups
    along channels, ``Dp = round_up(D, g)``).  ``S_pad = round_up(S, g *
    per)``; "pa" has g = S_pad for K and g = Dp for V."""

    k: QuantizedTensor
    v: QuantizedTensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pack(vals: torch.Tensor, nbits: int, axis: int = -1) -> torch.Tensor:
    """Unsigned ints < 2^nbits -> int8, planar along ``axis``: byte j holds
    positions ``{j + p * (n / per)}`` in bit-plane p."""
    if nbits == 8:
        return vals.to(torch.uint8).view(torch.int8)
    per = 8 // nbits
    n = vals.shape[axis]
    assert n % per == 0, (n, per)
    u = vals.to(torch.uint8)
    planes = torch.chunk(u, per, dim=axis)
    packed = planes[0].clone()
    for p in range(1, per):
        packed |= planes[p] << (p * nbits)
    return packed.view(torch.int8)


def _unpack(codes: torch.Tensor, nbits: int, axis: int = -1) -> torch.Tensor:
    """Planar int8 codes -> int32 values, the planes concatenated along
    ``axis``."""
    u = codes.view(torch.uint8).to(torch.int32)
    if nbits == 8:
        return u
    mask = (1 << nbits) - 1
    return torch.cat([(u >> (p * nbits)) & mask for p in range(8 // nbits)],
                     dim=axis)


def quantize(x: torch.Tensor, *, nbits: int, group_size: int = 64,
             pack_axis: int = -1, compiled: bool = False) -> QuantizedTensor:
    """Asymmetric per-group min/max quantization along the last axis.
    ``compiled``: the scale as XLA compiles the JAX function, (max - min)
    times the f32 reciprocal of 2^nbits - 1 instead of the division
    (bit-equal to a jitted caller such as the prefix resume)."""
    xf = x.float()
    *lead, n = xf.shape
    assert n % group_size == 0, (n, group_size)
    g = xf.reshape(*lead, n // group_size, group_size)
    mn = g.amin(dim=-1, keepdim=True)
    mx = g.amax(dim=-1, keepdim=True)
    qmax = float(2 ** nbits - 1)
    span = mx - mn
    scale = (span * torch.tensor(1.0 / qmax, dtype=torch.float32)
             if compiled else span / qmax).clamp_min(1e-8)
    codes = torch.clamp(torch.round((g - mn) / scale), 0, qmax)
    codes = codes.reshape(*lead, n).to(torch.int32)
    return QuantizedTensor(codes=_pack(codes, nbits, axis=pack_axis),
                           scale=scale, zero=mn)


def dequantize(qt: QuantizedTensor, *, nbits: int, group_size: int,
               pack_axis: int = -1) -> torch.Tensor:
    """f32 values of ``quantize``'s output: code * scale + zero."""
    codes = _unpack(qt.codes, nbits, axis=pack_axis)
    *lead, n = codes.shape
    g = codes.reshape(*lead, n // group_size, group_size).float()
    return (g * qt.scale + qt.zero).reshape(*lead, n)


def quantize_kv_region(k: torch.Tensor, v: torch.Tensor, *, nbits: int,
                       group_size: int = 64, layout: str = "group"
                       ) -> QuantizedKVRegion:
    """Quantize a compacted ``[B, H, S, D]`` prefill region once (its slots
    never change after compaction).  The K grid is computed in the
    ``[B, H, D, S_pad]`` orientation and the codes stored slot-major."""
    if layout not in ("group", "pa"):
        raise ValueError(f"layout must be group|pa, got {layout!r}")
    s, d = k.shape[2], k.shape[3]
    per = 8 // nbits
    s_pad = _round_up(s, group_size * per)
    kt = torch.nn.functional.pad(k.float().transpose(2, 3), (0, s_pad - s))
    kq = quantize(kt, nbits=nbits,
                  group_size=s_pad if layout == "pa" else group_size)
    kq = kq._replace(codes=kq.codes.transpose(-1, -2).contiguous())
    d_pad = _round_up(d, group_size)
    vp = torch.nn.functional.pad(v.float(), (0, d_pad - d, 0, s_pad - s))
    vq = quantize(vp, nbits=nbits,
                  group_size=d_pad if layout == "pa" else group_size,
                  pack_axis=-2)
    return QuantizedKVRegion(k=kq, v=vq)


def region_geometry(reg: QuantizedKVRegion, nbits: int):
    """(plane width W, S_pad, K slots per group, V channels per group) of a
    one-layer region, read from its shapes (both layouts)."""
    w = reg.k.codes.shape[-2]
    s_pad = w * (8 // nbits)
    return (w, s_pad, s_pad // reg.k.scale.shape[-2],
            reg.v.codes.shape[-1] // reg.v.scale.shape[-2])


def dequantize_kv_region(reg: QuantizedKVRegion, *, num_slots: int,
                         head_dim: int, nbits: int, dtype=torch.float32):
    """-> (k, v) ``[B, H, num_slots, head_dim]``; group sizes are read from
    the scale shapes, so both layouts round-trip."""
    _, _, kg, vg = region_geometry(reg, nbits)
    kcm = reg.k._replace(codes=reg.k.codes.transpose(-1, -2))
    k = dequantize(kcm, nbits=nbits, group_size=kg).transpose(2, 3)
    v = dequantize(reg.v, nbits=nbits, group_size=vg, pack_axis=-2)
    return (k[:, :, :num_slots, :].to(dtype),
            v[:, :, :num_slots, :head_dim].to(dtype))


def _pad_mask(mask: torch.Tensor, s_pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(mask, (0, s_pad - mask.shape[-1]))


def quant_decode_attention_plain(q: torch.Tensor, reg: QuantizedKVRegion,
                                 mask: torch.Tensor, *, nbits: int,
                                 scale: Optional[float] = None,
                                 softcap: Optional[float] = None,
                                 mm_bf16: bool = False):
    """Plain version of the group-layout region kernels' f32 route: f32
    dequantization of the whole region, then f32 attention partials, the
    logits scaled by ``scale`` (default 1/sqrt(D)) and capped under
    ``softcap`` before the mask.  ``mm_bf16`` (JAX
    ``kernels/quant_decode.py:378-384``, the tiled kernel's mode): the
    logits are the factored ones of :func:`quant_region_attention_fused`
    (bf16(q * scale * ks) . code in f32, plus the K zero term
    q * scale . kz in f32), P.V the f32 dequantization.

    q: [B, H, D]; ``reg`` one layer's region; mask: [B, Hk, n] (n <= S_pad;
    slots beyond it are padding).  Returns (acc [B, H, D], m [B, H],
    l [B, H]) f32 with out = acc / l after merging."""
    b, h, d = q.shape
    _, s_pad, _, _ = region_geometry(reg, nbits)
    k, v = dequantize_kv_region(reg, num_slots=s_pad, head_dim=d,
                                nbits=nbits)
    vis = _pad_mask(mask, s_pad)
    if not mm_bf16:
        return decode_attention_partials(q.float(), k, v, vis, scale=scale,
                                         softcap=softcap)
    m, pe, l = _softmax_stats(_folded_logits(q, reg, nbits, scale), vis,
                              softcap)
    acc = torch.matmul(pe, v)
    return acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


def _folded_logits(q: torch.Tensor, reg: QuantizedKVRegion, nbits: int,
                   scale: Optional[float]) -> torch.Tensor:
    """The factored logits of :func:`quant_region_attention_fused` (JAX
    ``ops/quant.py:466-511``), [B, Hk, G, S_pad] f32 in planar slot order:
    per bit-plane and K group, the query times the scale (default
    1/sqrt(D)) folded with the group's K scale and rounded to bf16, dotted
    with the raw codes in f32, plus the K zero term q * scale . kz (f32)."""
    b, h, d = q.shape
    hk = reg.k.codes.shape[1]
    g = h // hk
    per = 8 // nbits
    w, s_pad, kg_sz, _ = region_geometry(reg, nbits)
    gk = reg.k.scale.shape[-2]
    if gk > 1 and w % kg_sz:
        raise ValueError("quant_region_attention_fused takes K groups that "
                         "tile each bit-plane")
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hk, g, d) * sc
    ku = reg.k.codes.view(torch.uint8)
    mb = (1 << nbits) - 1
    ks, kz = reg.k.scale[..., 0], reg.k.zero[..., 0]        # [B, Hk, D, Gk]
    planes = []
    for p in range(per):
        cp = ((ku >> (p * nbits)) & mb).float()             # [B, Hk, W, D]
        if gk == 1:
            qs = (qg * ks[:, :, None, :, 0]).to(torch.bfloat16).float()
            z = torch.einsum("bkqd,bkd->bkq", qg, kz[..., 0])
            planes.append(torch.einsum("bkqd,bkwd->bkqw", qs, cp)
                          + z[..., None])
            continue
        gpl = w // kg_sz  # K groups per plane, plane p holds [p*gpl, ...)
        grp = slice(p * gpl, (p + 1) * gpl)
        qs = (qg[..., None] * ks[:, :, None, :, grp]).to(
            torch.bfloat16).float()                          # [B,Hk,G,D,gpl]
        z = torch.einsum("bkqd,bkdg->bkqg", qg, kz[..., grp])
        s5 = torch.einsum("bkqdg,bkgtd->bkqgt", qs,
                          cp.reshape(b, hk, gpl, kg_sz, d))
        planes.append((s5 + z[..., None]).reshape(b, hk, g, w))
    return torch.cat(planes, dim=-1)


def _softmax_stats(s: torch.Tensor, mask: torch.Tensor,
                   softcap: Optional[float]):
    """(m, p, l) of logits ``s`` [B, Hk, G, S] under ``mask`` [B, Hk, S]:
    the cap first (cap * tanh(s / cap), JAX ``ops/quant.py:523-524``),
    then the mask (float32.min), p = exp(s - m) zero where masked; m stays
    float32.min and l = 0 where no slot is visible, never -cap."""
    if softcap is not None:
        s = torch.tanh(s * (1.0 / softcap)) * softcap
    valid = mask[:, :, None, :]
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1)
    pe = torch.exp(s - m.clamp_min(_NEG_INF / 2)[..., None]).masked_fill(
        ~valid, 0.0)
    return m, pe, pe.sum(-1)


def quant_region_attention_fused(q: torch.Tensor, reg: QuantizedKVRegion,
                                 visible: torch.Tensor, *, nbits: int,
                                 scale: Optional[float] = None,
                                 softcap: Optional[float] = None):
    """Attention partials over a KIVI region without a dequantized copy
    (JAX ``ops/quant.py::quant_region_attention_fused``; plain version of
    ``kernels/quant_fused_decode.py`` and of
    ``kernels/quant_decode.py::quant_fused_attention_group``).

    The affine dequantization folds through the attention algebra: the K
    scale into the query (rounded to bf16, as the JAX function feeds its
    bf16 dot), the K zero into a logit bias q . kz (f32); the V scale into
    the probabilities (rounded to bf16), the V zero into the sum
    sum_t p_t vz_t (f32) added to the channels of its group.  Bit-planes are
    separate slot spans whose logits concatenate in planar slot order.  K
    may have Gk > 1 slot groups (the group layout, or the chunked prefill's
    pa carry: one group per chunk), each plane holding whole groups: the
    query then folds once per group and the zero term is a per-group bias.
    V may have Gv > 1 channel groups (the group layout): the probabilities
    then fold once per group.  The query is scaled by ``scale`` (default
    1/sqrt(D)) before the folds, and the logits capped under ``softcap``
    after the zero term, before the mask (JAX :467, :523-526).

    q: [B, H, D]; visible: [B, Hk, n] (n <= S_pad).  Returns (acc [B, H, D],
    m [B, H], l [B, H]) f32."""
    b, h, d = q.shape
    hk = reg.k.codes.shape[1]
    g = h // hk
    per = 8 // nbits
    w, s_pad, _, vg_sz = region_geometry(reg, nbits)
    gv = reg.v.scale.shape[-2]
    m, pe, l = _softmax_stats(_folded_logits(q, reg, nbits, scale),
                              _pad_mask(visible, s_pad), softcap)
    vu = reg.v.codes.view(torch.uint8)
    mb = (1 << nbits) - 1
    vs, vz = reg.v.scale[..., 0], reg.v.zero[..., 0]        # [B, Hk, S, Gv]
    dp = reg.v.codes.shape[-1]
    acc = torch.zeros((b, hk, g, dp), dtype=torch.float32, device=q.device)
    for p in range(per):
        pe_p = pe[..., p * w:(p + 1) * w]                    # [B,Hk,G,W]
        vp = ((vu >> (p * nbits)) & mb).float()              # [B,Hk,W,Dp]
        vs_p, vz_p = vs[:, :, p * w:(p + 1) * w], vz[:, :, p * w:(p + 1) * w]
        if gv == 1:
            ps = (pe_p * vs_p[:, :, None, :, 0]).to(torch.bfloat16).float()
            acc += torch.einsum("bkqw,bkwe->bkqe", ps, vp)
            acc += torch.einsum("bkqw,bkw->bkq", pe_p,
                                vz_p[..., 0])[..., None]
            continue
        ps5 = (pe_p[..., None] * vs_p[:, :, None]).to(
            torch.bfloat16).float()                          # [B,Hk,G,W,Gv]
        acc5 = torch.einsum("bkqwg,bkwge->bkqge", ps5,
                            vp.reshape(b, hk, w, gv, vg_sz))
        zv5 = torch.einsum("bkqw,bkwg->bkqg", pe_p, vz_p)
        acc += (acc5 + zv5[..., None]).reshape(b, hk, g, dp)
    return (acc[..., :d].reshape(b, h, d), m.reshape(b, h), l.reshape(b, h))


def merge_tail(part, q: torch.Tensor, tail, *,
               scale: Optional[float] = None,
               softcap: Optional[float] = None):
    """A KIVI layer's decode attention from its region's partials ``part``
    and the step's bf16 decode tail ``(k, v, mask)`` (k/v [B, Hk, T, D],
    mask [B, Hk, T]): the tail's partials (with ``scale`` and ``softcap``)
    merged after the region's, [B, H, D] in q's dtype.  The plain version
    of the region kernels' tail pass; ``tail=None`` returns ``part`` as it
    is."""
    if tail is None:
        return part
    k, v, mask = tail
    return merge_attention_partials(
        [part, decode_attention_partials(q, k, v, mask, scale=scale,
                                         softcap=softcap)]).to(q.dtype)


def stack_regions(regions) -> QuantizedKVRegion:
    """Per-layer regions -> one region whose leaves are stacked [L, ...]."""
    def st(field, part):
        return torch.stack([getattr(getattr(r, part), field) for r in regions])
    return QuantizedKVRegion(
        *(QuantizedTensor(*(st(f, part) for f in QuantizedTensor._fields))
          for part in ("k", "v")))


def layer_region(reg: QuantizedKVRegion, i: int) -> QuantizedKVRegion:
    """Layer ``i`` of a stacked region (views)."""
    return QuantizedKVRegion(*(QuantizedTensor(*(t[i] for t in part))
                               for part in reg))


def region_leaves(reg: Optional[QuantizedKVRegion]):
    return [] if reg is None else [t for part in reg for t in part]
