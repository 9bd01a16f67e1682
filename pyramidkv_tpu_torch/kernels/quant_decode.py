"""Decode attention over a group-layout KIVI region: wrappers of
``csrc/quant_decode.cu``.

:func:`quant_fused_attention_group` is the default route: the factored
dequantization of JAX ``ops/quant.py::quant_region_attention_fused`` (its
grouped branch), the JAX engine's default decode of a group-layout region,
with its bf16 roundings (the query folded with each slot-group's K scale,
the probabilities with each channel-group's V scale).  Its plain version is
``ops.quant.quant_region_attention_fused``; it launches the whole-region or
the split kernel as :func:`split_plan` says.

:func:`quant_decode_attention` (one block per region) and
:func:`quant_decode_attention_tiled` (the slots split across blocks, a
finish pass merging the splits) are the counterparts of
``pyramidkv_tpu/kernels/quant_decode.py``'s kernels of the same names, the
JAX engine's opt-in ``use_quant_kernel`` / ``use_quant_tiled`` route: f32
dequantization, then f32 partials (plain version
``ops.quant.quant_decode_attention_plain``).

Each returns the region's e-domain partials (acc [B, H, D], m [B, H],
l [B, H], f32), or with a tail the layer's output.  On a CUDA tensor it
launches the hand-written sm_90a kernel; on a CPU tensor it runs the plain
version.

The region is one layer's ``QuantizedKVRegion`` (``ops/quant.py``); its
slot-major K codes are read as they lie.  ``mask`` is the region's
visibility ``[B, Hk, n]`` (n <= S_pad), a prefix view of the cache's
full-length mask: slots at or past n are padding.
"""

from __future__ import annotations

import functools
import math

import torch

from ..ops.quant import (QuantizedKVRegion, merge_tail,
                         quant_decode_attention_plain,
                         quant_region_attention_fused, region_geometry)
from . import _build

HEAD_DIM = 128
GROUPS = (1, 2, 4, 8)
NBITS = (2, 4, 8)
#: an H100's SM count: split plans made for CPU tensors (where the wrappers
#: run their plain versions) are the card's
H100_SMS = 132
#: byte-rows per warp iteration in the kernels
_CHUNK = 32


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(device: torch.device, bhk: int, w: int):
    """(nsplit, byte-rows per split) for ``bhk`` regions of ``w`` byte-rows
    on ``device``: about 4 blocks per SM, and at least one 32-row chunk per
    warp (8 warps) in each split.  One split means the whole-region kernel
    fills the card as well as the tiled one, without its finish pass."""
    chunks = -(-w // _CHUNK)
    want = max(1, min(chunks // 8, -(-4 * _sm_count(device) // bhk)))
    rows = _CHUNK * -(-chunks // want)
    return -(-w // rows), rows


def check_unsupported(scale, softcap) -> None:
    if scale is not None or softcap is not None:
        raise NotImplementedError(
            "a custom attention scale or a softcap over a KIVI region is not "
            "ported yet (Gemma-2, ROADMAP queue 1 #10)")


def _check_tail(tail, q: torch.Tensor, hk: int):
    """The step's bf16 decode tail (k, v, mask): k/v contiguous
    [B, Hk, T >= 1, D] in q's dtype, mask a bool [B, Hk, T] prefix-of-row
    view.  Returns (k, v, mask, T)."""
    k, v, mask = tail
    b, _, d = q.shape
    t = k.shape[2]
    for name, x in (("k", k), ("v", v)):
        if (x.dtype != q.dtype or tuple(x.shape) != (b, hk, t, d) or t < 1
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"tail {name}: want contiguous {q.dtype} "
                             f"{(b, hk, t, d)} (T >= 1) on {q.device}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if (mask.dtype != torch.bool or mask.device != q.device
            or tuple(mask.shape) != (b, hk, t) or mask.stride(-1) != 1
            or mask.stride(0) != hk * mask.stride(1)):
        raise ValueError(f"tail mask must be a bool {(b, hk, t)} view of "
                         f"rows of a contiguous array, got {tuple(mask.shape)}"
                         f" strides {mask.stride()}")
    return k, v, mask, t


def launch_region(symbol: str, lib: str, q: torch.Tensor,
                  reg: QuantizedKVRegion, mask: torch.Tensor, nbits: int,
                  split: bool, tail=None, split_within: int = 0):
    """Check the shapes, allocate the outputs (and the workspace) and
    launch ``symbol`` of ``csrc/<lib>.cu``.  Returns (acc, m, l), or with
    ``tail`` the attention output over region and tail, [B, H, D] in q's
    dtype.  ``split_within``: a byte-row count each split's rows must lie
    inside (their count divides it)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, d = q.shape
    kc, vc = reg.k.codes, reg.v.codes
    hk = kc.shape[1]
    w, s_pad, _, vg = region_geometry(reg, nbits)
    ng, ngv, dp = reg.k.scale.shape[-2], reg.v.scale.shape[-2], vc.shape[-1]
    want = {"k.codes": (kc, torch.int8, (b, hk, w, d)),
            "k.scale": (reg.k.scale, torch.float32, (b, hk, d, ng, 1)),
            "k.zero": (reg.k.zero, torch.float32, (b, hk, d, ng, 1)),
            "v.codes": (vc, torch.int8, (b, hk, w, dp)),
            "v.scale": (reg.v.scale, torch.float32, (b, hk, s_pad, ngv, 1)),
            "v.zero": (reg.v.zero, torch.float32, (b, hk, s_pad, ngv, 1))}
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("q must be contiguous bfloat16")
    for name, (t, dt, shape) in want.items():
        if (t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"region {name}: want contiguous {dt} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    n = mask.shape[-1]
    if (mask.dtype != torch.bool or mask.device != q.device
            or tuple(mask.shape[:2]) != (b, hk) or n > s_pad
            or mask.stride(-1) != 1 or mask.stride(0) != hk * mask.stride(1)):
        raise ValueError("mask must be a bool [B, Hk, n <= S_pad] prefix view "
                         f"of a contiguous array, got {tuple(mask.shape)} "
                         f"strides {mask.stride()}")
    pa = ng == ngv == 1
    if (d != HEAD_DIM or h % hk or h // hk not in GROUPS or nbits not in NBITS
            or (vg % 4 and not pa) or ((dp % 4 or w % 4) and not split)):
        raise ValueError(f"kernel takes D == {HEAD_DIM}, H/Hk in {GROUPS}, "
                         f"nbits in {NBITS}, V groups of a multiple of 4 "
                         f"channels (and, over a whole region, V rows of a "
                         f"multiple of 4 bytes and a multiple of 4 byte-rows)"
                         f"; got D={d} H/Hk={h / hk} nbits={nbits} V group "
                         f"{vg}, V row {dp} bytes, {w} byte-rows")
    g = h // hk
    f32 = dict(dtype=torch.float32, device=q.device)
    if tail is None:
        res = (torch.empty((b, h, d), **f32), torch.empty((b, h), **f32),
               torch.empty((b, h), **f32))
        outs = tuple(x.data_ptr() for x in res) + (None,)
        tk = tv = tm = None
        t_len = t_stride = 0
    else:
        tk, tv, tm, t_len = _check_tail(tail, q, hk)
        t_stride = tm.stride(1)
        res = torch.empty_like(q)
        outs = (None, None, None, res.data_ptr())
    nsplit, rows = split_plan(q.device, b * hk, w) if split else (1, w)
    if split_within:
        rows = math.gcd(rows, split_within)
        nsplit = -(-w // rows)
    if split:
        ws = (torch.empty((b * hk * nsplit, g, d), **f32),
              torch.empty((b * hk * nsplit, g), **f32),
              torch.empty((b * hk * nsplit, g), **f32))
        ws_ptrs = tuple(x.data_ptr() for x in ws)
    else:
        ws_ptrs = (None, None, None)
    err = getattr(_build.library(lib), symbol)(
        q.data_ptr(), kc.data_ptr(), reg.k.scale.data_ptr(),
        reg.k.zero.data_ptr(), vc.data_ptr(), reg.v.scale.data_ptr(),
        reg.v.zero.data_ptr(), mask.data_ptr(), *outs[:3], *ws_ptrs, b * hk,
        g, nbits, w, s_pad, ng, dp, ngv, mask.stride(1), n, nsplit, rows,
        1.0 / math.sqrt(d), tk.data_ptr() if tk is not None else None,
        tv.data_ptr() if tv is not None else None,
        tm.data_ptr() if tm is not None else None, t_len, t_stride, outs[3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, symbol)
    return res


def region_kernels(split: bool) -> int:
    """CUDA kernels one region call launches: the whole-region kernel
    attends over the region and the bf16 tail and writes the output in one
    launch; the split kernel is followed by its finish pass."""
    return 2 if split else 1


def group_plan(device: torch.device, bhk: int, w: int):
    """(entry point, CUDA kernels a call launches) of the factored group
    route for ``bhk`` regions of ``w`` byte-rows: the whole-region kernel
    where :func:`split_plan` gives one split, else the split kernel."""
    whole = split_plan(device, bhk, w)[0] == 1
    return ("pkv_quant_group_fused" if whole
            else "pkv_quant_group_fused_tiled", region_kernels(not whole))


def quant_decode_attention(q: torch.Tensor, reg: QuantizedKVRegion,
                           mask: torch.Tensor, *, nbits: int, tail=None,
                           scale=None, softcap=None):
    """Whole-region kernel: one block per (batch row, KV head) covers the G
    query heads of the KV head.  q: [B, H, D] -> (acc, m, l); with ``tail``,
    the step's bf16 decode slots (k, v [B, Hk, T, D], mask [B, Hk, T]), the
    layer's attention output over region and tail, [B, H, D] in q's dtype
    (the same launch attends over the tail and merges)."""
    check_unsupported(scale, softcap)
    if q.device.type == "cpu":
        return merge_tail(quant_decode_attention_plain(q, reg, mask,
                                                       nbits=nbits), q, tail)
    out = launch_region("pkv_quant_decode", "quant_decode", q, reg, mask,
                        nbits, split=False, tail=tail)
    quant_decode_attention.launches += 1
    quant_decode_attention.kernels += region_kernels(False)
    return out


def quant_decode_attention_tiled(q: torch.Tensor, reg: QuantizedKVRegion,
                                 mask: torch.Tensor, *, nbits: int, tail=None,
                                 scale=None, softcap=None):
    """The same function with the slots split across blocks (long regions)
    and a finish pass merging the splits (and the tail).  Arguments and
    results as :func:`quant_decode_attention`."""
    check_unsupported(scale, softcap)
    if q.device.type == "cpu":
        return merge_tail(quant_decode_attention_plain(q, reg, mask,
                                                       nbits=nbits), q, tail)
    out = launch_region("pkv_quant_decode_tiled", "quant_decode", q, reg,
                        mask, nbits, split=True, tail=tail)
    quant_decode_attention_tiled.launches += 1
    quant_decode_attention_tiled.kernels += region_kernels(True)
    return out


def quant_fused_attention_group(q: torch.Tensor, reg: QuantizedKVRegion,
                                mask: torch.Tensor, *, nbits: int, tail=None,
                                scale=None, softcap=None):
    """The factored dequantization with the JAX function's bf16 roundings
    (``ops.quant.quant_region_attention_fused``), over a group-layout
    region: the whole-region kernel where :func:`split_plan` gives one
    split, else the split kernel.  Arguments and results as
    :func:`quant_decode_attention`."""
    check_unsupported(scale, softcap)
    if q.device.type == "cpu":
        return merge_tail(quant_region_attention_fused(q, reg, mask,
                                                       nbits=nbits), q, tail)
    b, hk, w = reg.k.codes.shape[:3]
    symbol, kernels = group_plan(q.device, b * hk, w)
    out = launch_region(symbol, "quant_decode", q, reg, mask, nbits,
                        split=kernels > 1, tail=tail)
    quant_fused_attention_group.launches += 1
    quant_fused_attention_group.kernels += kernels
    return out


#: wrapper calls that launched on the card since the last reset (CPU calls
#: do not count), and the CUDA kernels those calls launched
for _fn in (quant_decode_attention, quant_decode_attention_tiled,
            quant_fused_attention_group):
    _fn.launches = _fn.kernels = 0
del _fn
