"""Decode attention over a group-layout KIVI region: wrappers of
``csrc/quant_decode.cu``.

:func:`quant_fused_attention_group` is the default route: the factored
dequantization of JAX ``ops/quant.py::quant_region_attention_fused`` (its
grouped branch), the JAX engine's default decode of a group-layout region,
with its bf16 roundings (the query folded with each slot-group's K scale,
the probabilities with each channel-group's V scale).  Its plain version is
``ops.quant.quant_region_attention_fused``.

:func:`quant_decode_attention` (one block per region) and
:func:`quant_decode_attention_tiled` (the slots split across blocks) are
the counterparts of ``pyramidkv_tpu/kernels/quant_decode.py``'s kernels of
the same names, the JAX engine's opt-in ``use_quant_kernel`` /
``use_quant_tiled`` route: f32 dequantization, then f32 partials (plain
version ``ops.quant.quant_decode_attention_plain``); with ``mm_bf16`` the
tiled TPU kernel's mode of that name (the factored route's bf16-folded
logits, the f32 dequantized P.V).

Each takes the model's attention ``scale`` (default 1/sqrt(D)) and logit
cap ``softcap`` (Gemma-2: on each logit after the K zero term, before the
masks).  The CUDA kernel is instantiated at D = 128 without a cap (G in
:data:`GROUPS`), at D = 256 with one (G in (1, 2): Gemma-2-9B) and at
D = 32 without one in the factored mode alone (G = 2: the trained tiny
retrieval checkpoint's fullkv cache, whose V rows are padded to the
quantization group, 64 bytes), as :data:`INSTANCES` says; the plain
versions take any.

All three launch one CUDA kernel (``region_kernel``) on a plan of splits
(:func:`split_plan`, from the shapes alone; the whole-region wrapper takes
one split), which merges up to MAX_CLUSTER splits in a thread-block
cluster, and more in a merge kernel after it.  :func:`region_split_plain`
runs that schedule in plain PyTorch (the CPU tests hold it to the plain
versions).

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

from ..ops.attention import decode_attention_partials
from ..ops.quant import (QuantizedKVRegion, merge_tail,
                         quant_decode_attention_plain,
                         quant_region_attention_fused, region_geometry)
from . import _build

#: GQA group sizes the region kernels are instantiated for (7: Qwen2.5-7B)
GROUPS = (1, 2, 4, 7, 8)
#: (head dim, capped) -> the group sizes instantiated there: D = 128
#: uncapped (Llama, Mistral, Qwen2), D = 256 under a logit cap (Gemma-2-9B:
#: per-head caches G = 1, fullkv G = 2); as PKVQ_DISPATCH in
#: csrc/quant_region.cuh
INSTANCES = {(128, False): GROUPS, (256, True): (1, 2), (32, False): (2,)}
#: the refusal of D = 32 by the modes and layout not ported there yet
D32_QUEUED = ("the KIVI pa kernel and the f32 / mm_bf16 group modes at "
              "D = 32 are not ported yet (ROADMAP queue 2A #4)")
NBITS = (2, 4, 8)
#: the library and C entry point of each mode of the group kernel
ENTRIES = {"f32": ("quant_decode", "pkv_quant_decode"),
           "fold": ("quant_group_fused", "pkv_quant_group_fused"),
           "mm_bf16": ("quant_decode_mm_bf16", "pkv_quant_decode_mm_bf16")}
#: an H100's SM count: split plans made for CPU tensors (where the wrappers
#: run their plain versions) are the card's
H100_SMS = 132
#: splits of a region the group kernel merges through a thread-block
#: cluster in one launch at D = 128 (as MAX_CLUSTER in
#: csrc/quant_region.cuh; at D = 256 two: :func:`max_cluster`); more take a
#: merge kernel after it
MAX_CLUSTER = 4
#: byte-rows an item of the group kernel's ring, slots a tail item
ITEM_ROWS = 32
TAIL_ROWS = 32
#: ring stages, and the dynamic shared memory a block may have
RING_STAGES = 4
MAX_SMEM = 232448
#: items a split takes at least, and staged K columns (bit-planes x K
#: groups) at most under :func:`split_plan`: at D = 128 the tables of G = 8
#: with V groups of 16 channels or more fit shared memory; at D = 256
#: (``_MAX_COLS_256``) those of G <= 2 beside the 128 KB ring (226.7 KB at
#: most with a tail of 256 slots); at D = 32 (``_MAX_COLS_32``) those of
#: G = 2 in the folded mode (328 bytes a column) beside the 16 KB ring
#: within half an SM's shared memory (two blocks an SM: 84 KB of tables at
#: 256 columns).  Plans for other head dims (CPU tensors only: no kernel
#: takes them) are D = 128's.
_MIN_ITEMS = 4
_MAX_COLS = 28
_MAX_COLS_256 = 36
_MAX_COLS_32 = 256


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def staged_groups(rows: int, kg: int, ng: int) -> int:
    """K groups the group kernel stages per bit-plane for splits of
    ``rows`` byte-rows: a run of ``rows`` consecutive slots touches at most
    ceil(rows / kg) + 1 groups of ``kg`` slots, and a plane no more than
    ``ng`` (staged_groups in csrc/quant_region.cuh)."""
    return min(ng, (rows + 2 * kg - 2) // kg)


def max_cluster(d: int = 128) -> int:
    """Splits the group kernel merges in a thread-block cluster at head dim
    ``d`` (max_cluster in csrc/quant_region.cuh): MAX_CLUSTER at D = 128;
    two at D = 256, where a block fills an SM and clusters of 4 ran 1.9x
    slower than the merge kernel (PERF.md §6)."""
    return 2 if d == 256 else MAX_CLUSTER


def blocks_per_sm(d: int = 128) -> int:
    """Blocks of the group kernel an SM holds at head dim ``d``: two at
    D = 128; one at D = 256, whose ring of 32 KB tail stages alone takes
    128 KB."""
    return 1 if d == 256 else 2


def split_plan(device: torch.device, bhk: int, w: int, nbits: int, kg: int,
               d: int = 128):
    """(nsplit, byte-rows per split) of the group kernel for ``bhk``
    regions of ``w`` byte-rows, ``nbits``-bit codes, K groups of ``kg``
    slots and head dim ``d``, on ``device``, from the shapes alone: one
    wave of :func:`blocks_per_sm` blocks an SM at most, at least 4 ring
    items a split, no more than :func:`max_cluster` splits where
    ``bhk * max_cluster(d)`` blocks already fill the card (one launch), and
    splits short enough that their staged K columns (planes x groups) stay
    within ``_MAX_COLS`` (``_MAX_COLS_256`` at D = 256; shared memory then
    holds them whole).  Splits
    are whole items; one split takes all ``w`` rows."""
    per = 8 // nbits
    items = -(-w // ITEM_ROWS)
    sms = _sm_count(device)
    want = max(1, min(items // _MIN_ITEMS, blocks_per_sm(d) * sms // bhk))
    if bhk * max_cluster(d) >= sms:
        want = min(want, max_cluster(d))
    cap = {256: _MAX_COLS_256, 32: _MAX_COLS_32}.get(d, _MAX_COLS)
    if per * (w * per // kg) > cap:
        # staged_groups(rows) <= cap / per  <=>  rows <= (that - 1) kg + 1
        top = ((cap // per - 1) * kg + 1) // ITEM_ROWS * ITEM_ROWS
        want = max(want, -(-w // max(ITEM_ROWS, top)))
    rows = ITEM_ROWS * -(-items // want)
    nsplit = -(-w // rows)
    return (1, w) if nsplit == 1 else (nsplit, rows)


def region_kernels(nsplit: int, d: int = 128) -> int:
    """CUDA kernels one group-region call launches at head dim ``d``: one
    up to :func:`max_cluster` splits (one split, or a cluster merging
    them), two beyond (the split kernel, then a merge kernel)."""
    return 1 if nsplit <= max_cluster(d) else 2


def region_smem_bytes(g: int, nbits: int, fold: bool, rows: int, kg: int,
                      ng: int, dp: int, ngv: int, t: int,
                      win: int | None = None, d: int = 128) -> int:
    """Dynamic shared memory of one group-kernel block (region_layout in
    csrc/quant_region.cuh) at head dim ``d`` for splits of ``rows``
    byte-rows whose K tables are staged ``win`` byte-rows at a time
    (default: all ``rows``): the ring, the query, the staged K tables
    (``fold``: the folded queries of the kFold and mm_bf16 modes), the
    region's and the tail's visibility words and the tail's item list."""
    per = 8 // nbits
    qrow = d + 4 * (d // 16)
    cols = per * staged_groups(rows if win is None else win, kg, ng)
    region = ITEM_ROWS * (d + dp) + 2 * per * ITEM_ROWS * ngv * 4
    stage = -(-max(region, 2 * TAIL_ROWS * d * 2) // 16) * 16
    states = (2 * 8 * 8 + 9 * g * d + 16) * 4
    ktab = cols * g * (qrow + 1) * 4 if fold else 2 * cols * qrow * 4
    ntail = -(-t // TAIL_ROWS)
    return (max(RING_STAGES * stage, states) + g * qrow * 4
            + -(-ktab // 16) * 16 + per * -(-rows // 32) * 4 + 8 * ntail)


@functools.lru_cache(maxsize=None)
def region_window(g: int, nbits: int, fold: bool, rows: int, kg: int,
                  ng: int, dp: int, ngv: int, t: int, d: int = 128) -> int:
    """Byte-rows one staging of the group kernel's K tables covers for
    splits of ``rows`` byte-rows (region_window in csrc/quant_region.cuh):
    all of them where their tables fit MAX_SMEM (every :func:`split_plan`
    plan), else the most whole ring items that fit (a long region on the
    one-split plan; the kernel stages each window's tables in turn); 0
    where not one item fits."""
    def fits(win):
        return region_smem_bytes(g, nbits, fold, rows, kg, ng, dp, ngv, t,
                                 win, d) <= MAX_SMEM
    if fits(rows):
        return rows
    win = (rows - 1) // ITEM_ROWS * ITEM_ROWS
    while win > 0 and not fits(win):
        win -= ITEM_ROWS
    return win


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
                  plan, tail=None, workspace: bool = False,
                  scale=None, softcap=None):
    """Check the shapes, allocate the outputs (and the workspace) and
    launch ``symbol`` of ``csrc/<lib>.cu`` on ``plan`` = (nsplit, byte-rows
    per split) with the attention ``scale`` (default 1/sqrt(D)) and logit
    cap ``softcap``.  Returns (acc, m, l), or with ``tail`` the attention
    output over region and tail, [B, H, D] in q's dtype.  ``workspace``:
    the kernel writes the splits' partials to a workspace (the pa kernel,
    and the group kernel beyond MAX_CLUSTER splits)."""
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
    pa = symbol == "pkv_quant_fused_pa"
    if d == 32 and symbol != "pkv_quant_group_fused":
        raise ValueError(D32_QUEUED)
    capped = softcap is not None
    if capped and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if (h % hk or h // hk not in INSTANCES.get((d, capped), ())
            or nbits not in NBITS
            or (not pa and (vg % 4 or vg % (d // 32) or dp % 4 or w % 4))):
        raise ValueError(f"kernel takes (D, capped) -> H/Hk in {INSTANCES}, "
                         f"nbits in {NBITS} and, over a group-layout region, "
                         f"V groups of a multiple of 4 and of D / 32 "
                         f"channels, V rows of a multiple of 4 bytes and a "
                         f"multiple of 4 byte-rows; got D={d} capped="
                         f"{capped} H/Hk={h / hk} nbits={nbits} V group "
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
    nsplit, rows = plan
    if workspace:
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
        d, g, nbits, w, s_pad, ng, dp, ngv, mask.stride(1), n, nsplit, rows,
        scale if scale is not None else 1.0 / math.sqrt(d),
        softcap if capped else 0.0, tk.data_ptr() if tk is not None else None,
        tv.data_ptr() if tv is not None else None,
        tm.data_ptr() if tm is not None else None, t_len, t_stride, outs[3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, symbol)
    return res


def region_plan(q: torch.Tensor, reg: QuantizedKVRegion, nbits: int):
    """:func:`split_plan` of a region call's shapes."""
    b, hk, w = reg.k.codes.shape[:3]
    kg = region_geometry(reg, nbits)[2]
    return split_plan(q.device, b * hk, w, nbits, kg, q.shape[-1])


def launch_group(mode: str, q, reg, mask, nbits: int, plan, tail=None,
                 scale=None, softcap=None):
    """Launch the group kernel in ``mode`` (a key of :data:`ENTRIES`) on
    ``plan``; returns (result, CUDA kernels launched).  Raises where not
    even one ring item's K tables fit shared memory (:func:`region_window`:
    K groups of a few slots at G = 8)."""
    w, _, kg, _ = region_geometry(reg, nbits)
    if not region_window(
            q.shape[1] // reg.k.codes.shape[1], nbits, mode != "f32",
            plan[1], kg, reg.k.scale.shape[-2], reg.v.codes.shape[-1],
            reg.v.scale.shape[-2], 0 if tail is None else tail[0].shape[2],
            q.shape[-1]):
        raise ValueError(f"the K tables of one {ITEM_ROWS}-row item of a "
                         f"{w}-byte-row region (K groups of {kg} slots) "
                         f"exceed shared memory ({MAX_SMEM} bytes)")
    kernels = region_kernels(plan[0], q.shape[-1])
    lib, symbol = ENTRIES[mode]
    return launch_region(symbol, lib, q, reg, mask, nbits, plan, tail=tail,
                         workspace=kernels > 1, scale=scale,
                         softcap=softcap), kernels


def _merge_parts(parts):
    """(acc, m, l) partials merged in list order, as the kernels merge
    them: a part whose m <= float32.min / 2 (no visible slot) adds nothing,
    and m stays float32.min where no part has a visible slot."""
    neg = torch.finfo(torch.float32).min
    m_all = parts[0][1]
    for _, m, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    acc = l_all = 0.0
    for a, m, l in parts:
        f = torch.exp(m - m_all).masked_fill(m <= neg / 2, 0.0)
        acc = acc + a * f[..., None]
        l_all = l_all + l * f
    return acc, m_all, l_all


def region_split_plain(q: torch.Tensor, reg: QuantizedKVRegion,
                       mask: torch.Tensor, *, nbits: int, plan, fold: bool,
                       tail=None, scale=None, softcap=None,
                       mm_bf16: bool = False):
    """The group kernel's schedule in plain PyTorch, on ``plan`` =
    (nsplit, byte-rows per split): split s attends over byte-rows
    [s * rows, (s + 1) * rows) on every bit-plane (slot j + p * W) with
    the kernel's arithmetic (``fold``: ``ops.quant.
    quant_region_attention_fused``, its bf16 folds with p rounded at the
    split's max; else f32 dequantization, ``quant_decode_attention_plain``,
    with ``mm_bf16`` its folded logits) under ``scale`` and ``softcap``,
    and over its share of the bf16 tail (the 32-slot items with a visible
    slot, item i of them to split i % nsplit); the splits' partials merge
    in split order.  Arguments and results as :func:`quant_decode_attention`
    (a split or a row with no visible slot: m = float32.min, l = 0,
    acc = 0)."""
    nsplit, rows = plan
    w = reg.k.codes.shape[2]
    if rows < 1 or not (nsplit - 1) * rows < w <= nsplit * rows:
        raise ValueError(f"the plan must cover {w} byte-rows with non-empty "
                         f"splits, got {nsplit} x {rows}")
    akw = dict(scale=scale, softcap=softcap)

    def region(q, reg, mask, nbits):
        if fold:
            return quant_region_attention_fused(q, reg, mask, nbits=nbits,
                                                **akw)
        return quant_decode_attention_plain(q, reg, mask, nbits=nbits,
                                            mm_bf16=mm_bf16, **akw)

    split_of = (torch.arange(mask.shape[-1], device=q.device) % w) // rows
    if tail is not None:
        tk, tv, tm = tail
        t = tm.shape[-1]
        items = -(-t // TAIL_ROWS)
        vis = torch.nn.functional.pad(tm, (0, items * TAIL_ROWS - t)).reshape(
            *tm.shape[:2], items, TAIL_ROWS).any(-1)
        share = (torch.cumsum(vis.long(), -1) - 1) % nsplit
        tail_of = share.repeat_interleave(TAIL_ROWS, -1)[..., :t]
    parts = []
    for s in range(nsplit):
        part = region(q, reg, mask & (split_of == s), nbits)
        if tail is not None:
            part = _merge_parts([part, decode_attention_partials(
                q, tk, tv, tm & (tail_of == s), **akw)])
        parts.append(part)
    acc, m, l = _merge_parts(parts)
    if tail is None:
        return acc, m, l
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _group_call(fn, mode: str, q, reg, mask, nbits, plan, tail, scale,
                softcap, mm_bf16=False):
    """One group-kernel wrapper call: on a CPU tensor the plain version
    (``mode`` "fold": the factored function; else the f32 one, with
    ``mm_bf16`` its folded logits), on a CUDA tensor the kernel on ``plan``
    (a function of the shapes), counted on ``fn``."""
    akw = dict(scale=scale, softcap=softcap)
    if mm_bf16:
        mode = "mm_bf16"
    if q.device.type == "cpu":
        part = (quant_region_attention_fused(q, reg, mask, nbits=nbits, **akw)
                if mode == "fold" else
                quant_decode_attention_plain(q, reg, mask, nbits=nbits,
                                             mm_bf16=mm_bf16, **akw))
        return merge_tail(part, q, tail, **akw)
    out, kernels = launch_group(mode, q, reg, mask, nbits, plan(), tail,
                                **akw)
    fn.launches += 1
    fn.kernels += kernels
    fn.mm_bf16 += int(mm_bf16)
    return out


def quant_decode_attention(q: torch.Tensor, reg: QuantizedKVRegion,
                           mask: torch.Tensor, *, nbits: int, tail=None,
                           scale=None, softcap=None, mm_bf16: bool = False):
    """Whole-region kernel: one block per (batch row, KV head) covers the G
    query heads of the KV head and the whole region (the one-split plan).
    q: [B, H, D] -> (acc, m, l); with ``tail``, the step's bf16 decode slots
    (k, v [B, Hk, T, D], mask [B, Hk, T]), the layer's attention output over
    region and tail, [B, H, D] in q's dtype (the same launch attends over
    the tail and merges).  ``scale`` (default 1/sqrt(D)) and ``softcap``
    apply to region and tail alike; ``mm_bf16``: the tiled TPU kernel's
    mode of that name (logits from bf16-folded queries)."""
    return _group_call(quant_decode_attention, "f32", q, reg, mask, nbits,
                       lambda: (1, reg.k.codes.shape[2]), tail, scale,
                       softcap, mm_bf16)


def quant_decode_attention_tiled(q: torch.Tensor, reg: QuantizedKVRegion,
                                 mask: torch.Tensor, *, nbits: int, tail=None,
                                 scale=None, softcap=None,
                                 mm_bf16: bool = False):
    """The same function with the slots split across blocks as
    :func:`split_plan` says (long regions), the splits merged in a cluster
    or by a merge kernel.  Arguments and results as
    :func:`quant_decode_attention`."""
    return _group_call(quant_decode_attention_tiled, "f32", q, reg, mask,
                       nbits, lambda: region_plan(q, reg, nbits), tail,
                       scale, softcap, mm_bf16)


def quant_fused_attention_group(q: torch.Tensor, reg: QuantizedKVRegion,
                                mask: torch.Tensor, *, nbits: int, tail=None,
                                scale=None, softcap=None):
    """The factored dequantization with the JAX function's bf16 roundings
    (``ops.quant.quant_region_attention_fused``), over a group-layout
    region, on :func:`split_plan`'s plan.  Arguments and results as
    :func:`quant_decode_attention`."""
    return _group_call(quant_fused_attention_group, "fold", q, reg, mask,
                       nbits, lambda: region_plan(q, reg, nbits), tail,
                       scale, softcap)


#: wrapper calls that launched on the card since the last reset (CPU calls
#: do not count), the CUDA kernels those calls launched, and the calls in
#: the mm_bf16 mode
for _fn in (quant_decode_attention, quant_decode_attention_tiled,
            quant_fused_attention_group):
    _fn.launches = _fn.kernels = _fn.mm_bf16 = 0
del _fn
