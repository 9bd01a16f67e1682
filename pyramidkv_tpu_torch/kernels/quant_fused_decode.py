"""Decode attention over a pa-layout KIVI region: wrapper of
``csrc/quant_fused_decode.cu``.

Counterpart of ``pyramidkv_tpu/kernels/quant_fused_decode.py``'s
``quant_fused_attention_pa`` with its adapter
``region_attention_fused_kernel``: the affine dequantization folds through
the attention algebra (K scale into the bf16 query, K zero into a logit
bias, V scale into the bf16 probabilities, V zero into a per-row scalar), so
no dequantized copy exists.  K may carry one scale group per chunk (the
chunked prefill's region): the query then folds once per group.  On a CUDA
tensor it launches the hand-written sm_90a kernel (slots split across
blocks on :func:`pa_split_plan`, a finish pass merging them and attending
over the bf16 decode tail); on a CPU
tensor it runs the plain version (``ops.quant.quant_region_attention_fused``).
:func:`pa_split_plain` runs the kernel's schedule in plain PyTorch (the CPU
tests hold it to the plain version and to the Pallas kernel).  Arguments
and results as ``kernels/quant_decode.py``: the model's ``scale`` and
``softcap`` too, the kernel instantiated at D = 128 uncapped and at D = 256
capped (``quant_decode.INSTANCES``).  Under Gemma-2's cap the JAX engine
does not run its Pallas kernel (``supports_fused_kernel`` refuses a cap)
but ``ops/quant.py::quant_region_attention_fused`` in XLA: there this
kernel is the CUDA counterpart of that XLA route, as the group layout's
factored kernel is of its grouped branch.
"""

from __future__ import annotations

import torch

from ..ops.attention import decode_attention_partials
from ..ops.quant import (QuantizedKVRegion, merge_tail,
                         quant_region_attention_fused, region_geometry)
from .quant_decode import _merge_parts, _sm_count, launch_region


#: CUDA kernels a call launches: the split kernel and its finish pass
PA_KERNELS = 2
#: warps of a split-kernel block, byte-rows a warp takes at a time (a unit)
#: and units in flight a warp (as PA_WARPS, PA_UNIT and PA_STAGES in
#: csrc/quant_region.cuh)
PA_WARPS = 4
PA_UNIT = 16
PA_STAGES = 3


def pa_row(d: int = 128) -> int:
    """Padded bytes of a staged code row (pa_row in csrc/quant_region.cuh)."""
    return d + 16


def fq_quads(d: int = 128) -> int:
    """16-byte A fragments of a folded query row: D / 4 and a pad
    (fq_quads in csrc/quant_region.cuh)."""
    return d // 4 + 1


def pa_blocks(d: int = 128) -> int:
    """Split-kernel blocks an SM holds (pa_blocks in csrc/quant_region.cuh):
    two at D = 128, one at D = 256 (~116 KB of rings a block)."""
    return 1 if d == 256 else 2


def pa_split_plan(device: torch.device, bhk: int, w: int, seg: int = 0,
                  d: int = 128):
    """(nsplit, byte-rows per split) of the pa kernel for ``bhk`` regions
    of ``w`` byte-rows whose K groups span ``seg`` byte-rows each (0: one
    group, the whole plane), at head dim ``d``, on ``device``, from the
    shapes alone.  The splits tile each group's byte-rows (a split never
    crosses a group, so it folds one query a plane); a split is whole
    quanta of PA_WARPS * PA_UNIT byte-rows, the units going to the warps in
    turn, so each warp of a split gets the same rows (the last split of a
    group may be shorter); as many splits a group as one wave of
    :func:`pa_blocks` blocks an SM holds."""
    seg = seg or w
    if seg < 1 or w % seg:
        raise ValueError(f"K groups of {seg} byte-rows do not tile {w}")
    quantum = PA_WARPS * PA_UNIT
    quanta = -(-seg // quantum)
    want = max(1, min(quanta, pa_blocks(d) * _sm_count(device)
                      // (bhk * (w // seg))))
    rows = quantum * -(-quanta // want)
    return w // seg * -(-seg // rows), rows


def pa_split_rows(s: int, rows: int, seg: int, w: int):
    """Byte-rows [r0, r1) of split ``s`` (pa_split_rows in
    csrc/quant_region.cuh)."""
    sps = -(-seg // rows)
    r0 = (s // sps) * seg + (s % sps) * rows
    return r0, min(r0 + rows, (s // sps + 1) * seg, w)


def pa_smem_bytes(g: int, nbits: int, d: int = 128) -> int:
    """Dynamic shared memory of one split-kernel block at head dim ``d``
    (pa_smem_bytes in csrc/quant_region.cuh): the warps' rings (a stage: K
    and V codes of a unit, its V scales and zeros), the folded queries (one
    per <= 4-bit field of a code byte) and the warps' sums of the K zero
    terms."""
    per = 8 // nbits
    fields = 2 if nbits == 8 else per
    stage = 2 * PA_UNIT * pa_row(d) + 2 * per * PA_UNIT * 4
    return (PA_WARPS * PA_STAGES * stage + fields * g * fq_quads(d) * 16
            + PA_WARPS * per * g * 4)


def _k_segment(reg: QuantizedKVRegion, nbits: int) -> int:
    """Byte-rows of one K group (0: one group)."""
    w, _, kg, _ = region_geometry(reg, nbits)
    gk = reg.k.scale.shape[-2]
    if reg.v.scale.shape[-2] != 1 or (gk > 1 and w % kg):
        raise ValueError("quant_fused_attention_pa takes the pa layout: one "
                         "V group, K groups that tile each bit-plane")
    return kg if gk > 1 else 0


def quant_fused_attention_pa(q: torch.Tensor, reg: QuantizedKVRegion,
                             mask: torch.Tensor, *, nbits: int, tail=None,
                             scale=None, softcap=None):
    """q: [B, H, D]; ``reg`` one layer's pa-layout region; mask
    [B, Hk, n <= S_pad] -> (acc [B, H, D], m [B, H], l [B, H]) f32; with
    ``tail`` the layer's attention output over region and tail, [B, H, D]
    in q's dtype; ``scale`` (default 1/sqrt(D)) and ``softcap`` on region
    and tail (see ``quant_decode_attention``)."""
    akw = dict(scale=scale, softcap=softcap)
    seg = _k_segment(reg, nbits)
    if q.device.type == "cpu":
        return merge_tail(quant_region_attention_fused(q, reg, mask,
                                                       nbits=nbits, **akw),
                          q, tail, **akw)
    b, hk, w = reg.k.codes.shape[:3]
    out = launch_region("pkv_quant_fused_pa", "quant_fused_decode", q, reg,
                        mask, nbits,
                        pa_split_plan(q.device, b * hk, w, seg, q.shape[-1]),
                        tail=tail, workspace=True, **akw)
    quant_fused_attention_pa.launches += 1
    quant_fused_attention_pa.kernels += PA_KERNELS
    return out


def pa_split_plain(q: torch.Tensor, reg: QuantizedKVRegion,
                   mask: torch.Tensor, *, nbits: int, plan, tail=None,
                   scale=None, softcap=None):
    """The pa kernel's schedule in plain PyTorch, on ``plan`` = (nsplit,
    byte-rows per split) (:func:`pa_split_rows`): split s's 16-row units go
    to its PA_WARPS warps in turn; a warp takes its units in order, each
    unit's logits on every bit-plane from the query folded with the K scale
    of the split's group (rounded to bf16) and the K zero term (f32), its
    own e-domain online softmax (p at the warp's running max, p times the V
    scale rounded to bf16, p times the V zero summed apart); the warps merge
    in order (the zero sum added to every channel), then the splits in
    order (the finish pass), then the bf16 tail (f32, as
    ``decode_attention_partials``) after them.  The query is scaled by
    ``scale`` (default 1/sqrt(D)) before the folds; each logit is capped
    under ``softcap`` after the zero term, before the mask.  Arguments and
    results as :func:`quant_fused_attention_pa`."""
    b, h, d = q.shape
    hk = reg.k.codes.shape[1]
    g = h // hk
    per = 8 // nbits
    w, s_pad, kg, _ = region_geometry(reg, nbits)
    seg = _k_segment(reg, nbits) or w
    nsplit, rows = plan
    if nsplit != w // seg * -(-seg // rows):
        raise ValueError(f"the plan must tile each {seg}-row K group, got "
                         f"{nsplit} x {rows}")
    neg = torch.finfo(torch.float32).min
    vis = torch.nn.functional.pad(mask, (0, s_pad - mask.shape[-1]))
    qg = q.float().reshape(b, hk, g, d) * (scale if scale is not None
                                           else 1.0 / d ** 0.5)
    ku = reg.k.codes.view(torch.uint8)
    vu = reg.v.codes.view(torch.uint8)[..., :d]
    mb = (1 << nbits) - 1
    ks, kz = reg.k.scale[..., 0], reg.k.zero[..., 0]  # [B, Hk, D, Gk]
    vs, vz = reg.v.scale[..., 0, 0], reg.v.zero[..., 0, 0]  # [B, Hk, S]
    parts = []
    for s in range(nsplit):
        r0, r1 = pa_split_rows(s, rows, seg, w)
        grp = [p * (w // kg) + r0 // kg for p in range(per)]
        fq = [(qg * ks[:, :, None, :, gi]).to(torch.bfloat16).float()
              for gi in grp]                              # [B, Hk, G, D]
        zb = [torch.einsum("bkgd,bkd->bkg", qg, kz[..., gi]) for gi in grp]
        warps = []
        for wp in range(PA_WARPS):
            m = torch.full((b, hk, g), -float("inf"))
            l = torch.zeros((b, hk, g))
            zv = torch.zeros((b, hk, g))
            acc = torch.zeros((b, hk, g, d))
            for u0 in range(r0 + wp * PA_UNIT, r1, PA_WARPS * PA_UNIT):
                u1 = min(u0 + PA_UNIT, r1)
                slots = [torch.arange(u0, u1) + p * w for p in range(per)]
                sv = []
                for p in range(per):
                    kc = ((ku[:, :, u0:u1] >> (p * nbits)) & mb).float()
                    x = torch.einsum("bkgd,bktd->bkgt", fq[p], kc)
                    x = x + zb[p][..., None]
                    if softcap is not None:
                        x = torch.tanh(x * (1.0 / softcap)) * softcap
                    sv.append(x.masked_fill(~vis[:, :, None, slots[p]], neg))
                sv = torch.cat(sv, -1)                    # [B, Hk, G, T]
                m_new = torch.maximum(m, sv.amax(-1))
                alpha = torch.exp(m - m_new)
                e = torch.where(sv > neg, torch.exp(sv - m_new[..., None]),
                                torch.zeros(()))
                cat = torch.cat(slots)
                l = l * alpha + e.sum(-1)
                zv = zv * alpha + (e * vz[:, :, None, cat]).sum(-1)
                pr = (e * vs[:, :, None, cat]).to(torch.bfloat16).float()
                vc = torch.cat([((vu[:, :, u0:u1] >> (p * nbits)) & mb).float()
                                for p in range(per)], 2)  # [B, Hk, T, D]
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgt,bktd->bkgd", pr, vc)
                m = m_new
            warps.append((acc + zv[..., None], m, l))
        parts.append(_merge_parts(warps))
    acc, m, l = _merge_parts(parts)
    part = (acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h))
    if tail is None:
        return part
    tk, tv, tm = tail
    acc, m, l = _merge_parts([part, decode_attention_partials(
        q, tk, tv, tm, scale=scale, softcap=softcap)])
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


#: wrapper calls that launched on the card since the last reset (CPU calls
#: do not count), and the CUDA kernels those calls launched
quant_fused_attention_pa.launches = quant_fused_attention_pa.kernels = 0
