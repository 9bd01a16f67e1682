"""Weight-quantized decode matmuls: wrappers of ``csrc/int4_matmul.cu``.

Counterparts of ``pyramidkv_tpu/kernels/int4_matmul.py::int4_matmul``,
``int8_matmul`` and ``int4_matmul_dma``, with the same signatures (2-D
codes, or stacked ``[L, in, out']`` codes with ``layer``; ``group_size``).
On a CUDA tensor each launches its hand-written sm_90a kernel and adds one
to its ``.launches``; on a CPU tensor it runs its plain PyTorch version
(``*_plain`` below), which follows the TPU kernel's numerics:

- int4: products of x with the exact nibble values accumulate in f32
  (bf16 x is upcast, as the TPU wrapper does for <= 8 rows and its MXU does
  exactly for more); per-channel scales are an f32 epilogue, group scales
  multiply each group's f32 partial; the result is cast to x's dtype.
- int8: x is rounded to bf16 first (the TPU kernel's bf16 operands), even
  when the caller passes f32 — the lm_head does — then as int4.

Both int4 wrappers launch one kernel a call (``int4_mm_kernel``): strips of
the codes by clusters of in-dim slices, a TMA ring, tensor-core products on
bit-decoded nibbles.  :func:`int4_tile_plan` chooses its schedule and
:func:`int4_tiled_plain` repeats its order of sums; the int8 kernel splits
the in-dim across blocks as ``_plan_stream`` says.  Both plans are pure
Python, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

#: SMs of the card, read from the device at first launch (132 on an H100)
_SMS: dict = {}
#: blocks per SM the int8 kernel's launch aims for (split-K fills the card
#: with them)
_BLOCKS_PER_SM = 4


def pack_span(out2: int) -> int:
    """Bytes per planar span of the packed-int4 layout (a copy of
    ``models/weights.py::pack_span``): 128 when ``out2 % 128 == 0``, else 1."""
    return 128 if out2 % 128 == 0 else 1


def unpack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Packed int4 bytes ``[..., out2]`` -> signed int8 values ``[..., 2*out2]``
    in natural column order (span-planar: byte ``s*S + p`` holds columns
    ``s*2S + p`` (low nibble) and ``s*2S + S + p`` (high))."""
    out2 = codes.shape[-1]
    s = pack_span(out2)
    u = codes.view(torch.uint8).reshape(*codes.shape[:-1], out2 // s, 1, s)
    nib = torch.cat([u & 0xF, u >> 4], dim=-2).to(torch.int8)
    nib = torch.where(nib > 7, nib - 16, nib)
    return nib.reshape(*codes.shape[:-1], out2 * 2)


def _largest_tile(n: int, cap: int, unit: int = 128) -> int:
    """Largest divisor of ``n`` that is <= cap and a multiple of ``unit``
    (the JAX package's tiling rule, kept as the int8 eligibility test)."""
    for t in range(min(cap, n) - min(cap, n) % unit, 0, -unit):
        if n % t == 0:
            return t
    return 0


def int8_tiles(in_dim: int, out: int, block_in: int = 4096,
               block_out: int = 2048):
    """(bi, bo) of the TPU kernel's tiling, zeros when the dims do not tile.
    The CUDA kernel tiles differently; this is the eligibility rule that
    ``models/weights.py::mm`` mirrors from the JAX package."""
    bi = _largest_tile(in_dim, block_in)
    bo = _largest_tile(out, block_out)
    while bi and bo and bi * bo * 3 > (12 << 20) and bi > 512:
        bi //= 2
    if not bi or not bo or in_dim % bi or out % bo:
        return 0, 0
    return bi, bo


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _layer_codes(codes: torch.Tensor, layer) -> torch.Tensor:
    stacked = codes.dim() == 3
    if stacked != (layer is not None):
        raise ValueError(f"codes {tuple(codes.shape)} with layer={layer!r}: "
                         "stacked codes need a layer, 2-D codes none")
    return codes[int(layer)] if stacked else codes


def int4_matmul_plain(x, codes, scale, *, layer=None, group_size: int = 0):
    """``x @ dequant(codes, scale)`` in plain PyTorch (the kernel's numerics)."""
    c = unpack_nibbles(_layer_codes(codes, layer)).float()  # [in, out]
    xf = x.float()
    sc = scale.float()
    if group_size:
        rows, in_dim = xf.shape
        g = in_dim // group_size
        p = torch.einsum("rGg,Ggo->rGo", xf.reshape(rows, g, group_size),
                         c.reshape(g, group_size, -1))
        y = (p * sc[None]).sum(dim=1)
    else:
        y = (xf @ c) * sc
    return y.to(x.dtype)


def int8_matmul_plain(x, codes, scale, *, layer=None):
    """``bf16(x) @ (codes * scale)`` in plain PyTorch (the kernel's numerics)."""
    c = _layer_codes(codes, layer).float()
    xb = x.to(torch.bfloat16).float()
    return ((xb @ c) * scale.float()).to(x.dtype)


def int4_matmul_dma_plain(x, codes, scale, *, layer=None):
    """The DMA kernel computes :func:`int4_matmul_plain`'s per-channel product."""
    _check_dma_layout(codes, scale)
    return int4_matmul_plain(x, codes, scale, layer=layer)


def _check_dma_layout(codes, scale):
    if codes.shape[-1] % 128 or scale.dim() != 1:
        raise ValueError("int4_matmul_dma takes span-128 codes (out2 % 128 == "
                         f"0) and per-channel scales; got codes "
                         f"{tuple(codes.shape)}, scale {tuple(scale.shape)}")


# ---------------------------------------------------------------------------
# Host-side plans of the CUDA kernels
# ---------------------------------------------------------------------------


def _row_tile(rows: int) -> int:
    return 1 if rows == 1 else 2 if rows == 2 else 4 if rows <= 4 else 8


def _vec_bytes(ncb: int, rt: int) -> int:
    """Code bytes a thread loads at once: 16 for 1-2 rows, else 4 (keeps the
    f32 accumulators at <= 64 a thread); narrower when ``ncb`` is not a
    multiple."""
    for vb in ((16, 4, 1) if rt <= 2 else (4, 1)):
        if ncb % vb == 0:
            return vb
    return 1


@functools.lru_cache(maxsize=None)
def _plan_stream(rows: int, in_dim: int, ncb: int, group_size: int = 0,
                 sms: int = 132):
    """(rt, vb, kc, splits) for the split-K streaming kernel: each block
    takes ``kc`` in-dim rows of a 32*vb-byte column strip for ``rt`` x rows,
    and there are about ``_BLOCKS_PER_SM * sms`` blocks where the shape
    allows.  With group scales a split holds whole groups and each warp's
    ``kc / 8`` rows lie inside one group."""
    rt = _row_tile(rows)
    vb = _vec_bytes(ncb, rt)
    col_tiles = -(-ncb // (32 * vb))
    row_tiles = -(-rows // rt)
    per_block = in_dim * col_tiles * row_tiles / (_BLOCKS_PER_SM * sms)
    kc_t = min(512, max(64, 64 * math.ceil(per_block / 64)))
    if group_size:
        # kc = 8 * group_size / m: warps of group_size / m rows, m | 8
        opts = [8 * group_size // m for m in (8, 4, 2, 1)
                if group_size % m == 0]
        kc = min(opts, key=lambda k: abs(math.log(k / kc_t)))
    else:
        kc = kc_t
    if rt * kc * 4 > 160 * 1024:
        raise ValueError(f"group_size {group_size} needs an x tile of "
                         f"{rt * kc * 4} bytes; the kernel takes <= 160 KB")
    return rt, vb, kc, -(-in_dim // kc)


#: bytes of a strip column of the int4 kernel (a TMA box's width)
_COL = 64
#: consumer warps an int4 block may have (strip columns x warps a column)
_CONSUMERS = (8, 4)
#: registers a thread of the int4 kernel takes (its builds: per-channel,
#: grouped scales), for the blocks an SM holds
_INT4_REGS = (96, 168)
#: SMs of a GPC that clusters of one launch can count on (the H100's GPCs
#: hold 16-18 SMs of its 132, some taken by other clusters' remainders)
_GPC_SMS = 15
#: bytes of an int4 ring stage (int4_matmul_dma's window sets its rows)
_STAGE_BYTES = 16 * 1024
#: bytes of an int4 block's ring
_RING_BYTES = 48 * 1024
#: bytes of a slice's group scales staged in shared memory at most
_SCALE_BYTES = 16 * 1024
#: a block's fixed cost (start, staging x, the cluster's sum) in code
#: bytes streamed meanwhile, in the plan's cost
_BLOCK_COST = 96 * 1024
#: and a cluster's more (its barrier waits for the slowest rank)
_CLUSTER_COST = 32 * 1024
#: shared memory a block may take, and an SM holds, on the H100
_SMEM_MAX = 232448
_SMEM_SM = 233472


class Int4Plan(NamedTuple):
    """The int4 kernel's schedule: strips of ``64 * ncol`` code bytes,
    ``kw`` consumer warps a 64-byte column (each takes every kw-th 16-row
    k-step of a stage), ring stages of ``ks`` rows, ``stages`` of them,
    clusters of ``cluster`` in-dim slices of ``slice`` rows (the last
    shorter), ``rp`` x rows a pass, ``ss_rows`` group-scale rows of a slice
    staged in shared memory (0: read from L2); ``smem`` bytes of shared
    memory a block, ``blocks`` in the grid."""
    ncol: int
    kw: int
    ks: int
    stages: int
    cluster: int
    slice: int
    rp: int
    ss_rows: int
    smem: int
    blocks: int


def box_rows(ks: int) -> int:
    """Rows of one TMA box of a stage (``box_rows`` in the CUDA source)."""
    return 256 if ks % 256 == 0 else 128 if ks % 128 == 0 else 64


def int4_smem_bytes(ncol, kw, ks, stages, cluster, slice_, rp, ss_rows,
                    x_f32, gs=0) -> int:
    """A block's shared memory (``i4::layout`` in the CUDA source): the
    ring, or the warps' f32 partials where larger, x's slice in bf16 (three
    planes for f32 x), the staged scales (the slice's groups, or the
    per-channel row), the partials rank 0 receives from a cluster, the
    barriers and 1024 bytes of base alignment."""
    sb = _COL * ncol
    region = -(-max(stages * ks * sb, kw * rp * 2 * sb * 4) // 1024) * 1024
    pitch = -(-slice_ // ks) * ks + 8
    xs = -(-(3 if x_f32 else 1) * rp * pitch * 2 // 16) * 16
    recv = cluster * rp * 2 * sb * 4 if cluster > 1 else 0
    ss = (ss_rows if gs else 1) * 2 * sb * 4
    return region + xs + ss + recv + 2 * stages * 8 + 1024


@functools.lru_cache(maxsize=None)
def int4_tile_plan(rows: int, in_dim: int, out2: int, group_size: int = 0,
                   sms: int = 132, x_f32: bool = False,
                   ks: int | None = None) -> Int4Plan:
    """The int4 kernel's schedule for x [rows, in_dim] and codes [in_dim,
    out2] on a card of ``sms`` SMs.  A block has 8 or 4 consumer warps (4
    with group scales) on 1, 2 or 4 columns of 64 bytes, ring stages of
    16 KB (``ks``: rows of a stage instead, ``int4_matmul_dma``'s window,
    rounded down to 64) and a 48 KB ring; the in-dim is cut into up to 8
    slices of whole stages and whole groups.  Of the strip widths, warps
    and slice counts that give every SM a block (all, where none does),
    the plan takes the one of least cost: the busiest SM's code bytes
    (blocks spread evenly) plus a block's fixed cost, and a cluster's,
    once a wave (the blocks an SM holds by registers and shared memory,
    clusters whole within 15 SMs of each 16); then the fewest waves, the
    narrowest strips, the most blocks and warps.  x rows a pass drop below
    8 only where no plan fits shared memory."""
    gs = group_size
    for rp in (min(8, rows), 4, 2, 1):
        if rp > min(8, rows):
            continue
        cands = []
        for ncol, nc in ((n, c) for n in (1, 2, 4) for c in _CONSUMERS):
            if nc > _CONSUMERS[bool(gs)] or nc % ncol:
                continue
            kw = nc // ncol
            k = (_STAGE_BYTES // (_COL * ncol) if ks is None
                 else max(64, ks // 64 * 64))
            while k % (16 * kw):
                kw //= 2
            strips = -(-out2 // (_COL * ncol))
            unit = k * gs // math.gcd(k, gs) if gs else k
            for c in range(min(8, -(-in_dim // unit)), 0, -1):
                slice_ = -(-in_dim // (c * unit)) * unit
                c = -(-in_dim // slice_)
                stages = max(1, min(_RING_BYTES // (k * _COL * ncol),
                                    -(-slice_ // k)))
                ss_rows = (slice_ // gs if gs and slice_ // gs * 2 * _COL
                           * ncol * 4 <= _SCALE_BYTES else 0)
                smem = int4_smem_bytes(ncol, kw, k, stages, c, slice_, rp,
                                       ss_rows, x_f32, gs)
                if smem > _SMEM_MAX:
                    continue
                per_sm = min(65536 // (_INT4_REGS[bool(gs)] * 32
                                       * (ncol * kw + 1)),
                             _SMEM_SM // (smem + 1024))
                # blocks the card holds at once: clusters of c whole in a GPC
                slots = (sms * per_sm if c == 1 else
                         sms // 16 * (_GPC_SMS * per_sm // c) * c)
                blocks = strips * c
                # the busiest SM's code bytes, and a block's fixed cost
                # (start, x, the cluster's sum) once a wave
                waves = -(-blocks // max(slots, 1))
                cost = (-(-blocks // sms) * slice_ * _COL * ncol
                        + waves * (_BLOCK_COST + (c > 1) * _CLUSTER_COST))
                cands.append(((blocks < sms, cost, waves, ncol, -blocks,
                               -ncol * kw),
                              Int4Plan(ncol, kw, k, stages, c, slice_, rp,
                                       ss_rows, smem, blocks)))
        if cands:
            return min(cands)[1]
    raise ValueError(f"int4 kernel: no plan fits shared memory for in "
                     f"{in_dim}, out2 {out2}, group_size {gs}, ks {ks}")


def split_x3(x: torch.Tensor):
    """f32 x as three bf16 terms with x == hi + mid + lo exactly for |x| >=
    2^-110 (the int4 kernel's f32 path; below, lo rounds at bf16's smallest
    subnormal, 2^-133)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def int4_tiled_plain(x, codes, scale, plan: Int4Plan, *, layer=None,
                     group_size: int = 0):
    """:func:`int4_matmul_plain` in the int4 kernel's order of sums: each
    warp of a slice sums its k-steps (every ``plan.kw``-th 16-row step of
    the slice), group by group, each group's partial scaled; a slice's
    warps add in warp order, the slices (cluster ranks) in rank order; the
    per-channel scale comes last."""
    c = unpack_nibbles(_layer_codes(codes, layer)).float()
    xf, sc = x.float(), scale.float()
    rows, in_dim = xf.shape
    k = torch.arange(in_dim, device=xf.device)
    y = None
    for rank in range(plan.cluster):
        lo = rank * plan.slice
        hi = min(in_dim, lo + plan.slice)
        block = None
        for w in range(plan.kw):
            xm = xf * ((k >= lo) & (k < hi)
                       & ((k - lo) // 16 % plan.kw == w)).to(xf.dtype)
            if group_size:
                g = in_dim // group_size
                p = torch.einsum("rGg,Ggo->rGo",
                                 xm.reshape(rows, g, group_size),
                                 c.reshape(g, group_size, -1))
                part = (p * sc[None]).sum(dim=1)
            else:
                part = xm @ c
            block = part if block is None else block + part
        y = block if y is None else y + block
    if not group_size:
        y = y * sc
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _sms(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _cuda_args(name, x, codes, layer, scale):
    """Check what the kernels take; returns (x, 2-D codes view, f32 scale,
    flags)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    c = _layer_codes(codes, layer)  # a view of the stack: no copy
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be 2-D bfloat16 or float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if c.dtype != torch.int8 or not c.is_contiguous() or c.dim() != 2:
        raise ValueError(f"{name}: codes must be contiguous int8 [in, out']")
    if c.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs codes "
                         f"{tuple(c.shape)}")
    for t in (c, scale):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device}, x on {x.device}")
    flags = 3 if x.dtype == torch.float32 else 0  # x f32 (1), y f32 (2)
    return (x.contiguous(), c, scale.to(torch.float32).contiguous(), flags)


def _launch(fn, x, codes, scale, out, splits, *ints):
    """Call entry point ``fn`` (x, codes, scale, f32 workspace [splits,
    rows, out], y [rows, out], ``ints``..., stream); returns y."""
    rows = x.shape[0]
    ws = torch.empty((splits, rows, out), dtype=torch.float32, device=x.device)
    y = torch.empty((rows, out), dtype=x.dtype, device=x.device)
    err = getattr(_build.library("int4_matmul"), fn)(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), ws.data_ptr(),
        y.data_ptr(), *ints, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, fn)
    return y


#: tensor maps of int4 codes, built once each: (address, in, out2, box
#: rows) -> 128 bytes (a map describes only the address and the shape, so
#: a later tensor at the same address and shape reuses it rightly)
_MAPS: dict = {}


def _tensor_map(lib, c: torch.Tensor, ks: int):
    """The address of the TMA tensor map of 2-D codes ``c`` for stages of
    ``ks`` rows, or None where TMA cannot read them (rows not 16-byte
    aligned: out2 % 16 != 0, or a view that starts off alignment)."""
    in_dim, out2 = c.shape
    if out2 % 16 or c.data_ptr() % 16:
        return None
    key = (c.data_ptr(), in_dim, out2, box_rows(ks))
    buf = _MAPS.get(key)
    if buf is None:
        buf = ctypes.create_string_buffer(128)
        _build.check(lib.pkv_int4_map(ctypes.addressof(buf), c.data_ptr(),
                                      in_dim, out2, ks), "pkv_int4_map")
        _MAPS[key] = buf
    return ctypes.addressof(buf)


def _launch_int4(x, c, sc, plan: Int4Plan, group_size: int):
    """One launch of the int4 kernel on (x, 2-D codes view, f32 scale)."""
    rows, in_dim = x.shape
    out2 = c.shape[1]
    lib = _build.library("int4_matmul")
    y = torch.empty((rows, 2 * out2), dtype=x.dtype, device=x.device)
    err = lib.pkv_int4_mm(
        x.data_ptr(), c.data_ptr(), sc.data_ptr(), y.data_ptr(),
        _tensor_map(lib, c, plan.ks), rows, in_dim, out2, group_size,
        plan.ncol, plan.kw, plan.ks, plan.stages, plan.cluster, plan.slice,
        plan.rp, plan.ss_rows, int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pkv_int4_mm")
    return y


def int4_matmul(x, codes, scale, *, layer=None, group_size: int = 0):
    """``x @ dequant(codes, scale)`` reading only the packed bytes.

    x: [rows, in] bf16/f32; codes: int8 [in, out/2] span-planar packed
    nibbles, or stacked [L, in, out/2] with ``layer``; scale: [out]
    per-channel, or [in / group_size, out] with ``group_size``.  Returns
    [rows, out] in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, codes, scale, layer=layer,
                                 group_size=group_size)
    x, c, sc, _ = _cuda_args("int4_matmul", x, codes, layer, scale)
    rows, in_dim = x.shape
    out2 = c.shape[1]
    want = ((in_dim // group_size, 2 * out2) if group_size else (2 * out2,))
    if tuple(sc.shape) != want or (group_size and in_dim % group_size):
        raise ValueError(f"int4_matmul: scale {tuple(sc.shape)}, want {want}")
    plan = int4_tile_plan(rows, in_dim, out2, group_size, _sms(x.device),
                          x.dtype == torch.float32)
    y = _launch_int4(x, c, sc, plan, group_size)
    int4_matmul.launches += 1
    return y


def int8_matmul(x, codes, scale, *, layer=None):
    """``x @ (codes * scale)`` streaming int8 bytes, x rounded to bf16.

    x: [rows, in]; codes: int8 [in, out] or stacked with ``layer``; scale
    [out].  Returns [rows, out] in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, codes, scale, layer=layer)
    x, c, sc, flags = _cuda_args("int8_matmul", x, codes, layer, scale)
    rows, in_dim = x.shape
    out = c.shape[1]
    if tuple(sc.shape) != (out,):
        raise ValueError(f"int8_matmul: scale {tuple(sc.shape)}, want ({out},)")
    rt, vb, kc, splits = _plan_stream(rows, in_dim, out, 0, _sms(x.device))
    y = _launch("pkv_int8_matmul", x, c, sc, out, splits, rows, in_dim, out,
                rt, vb, kc, splits, flags)
    int8_matmul.launches += 1
    return y


def dma_stage_rows(in_dim: int, win: int = 512) -> int:
    """The window of ``int4_matmul_dma`` (shrunk to divide in_dim, as the
    JAX package does), which sets the rows of the int4 kernel's ring
    stages."""
    w = min(win, in_dim)
    while in_dim % w:
        w //= 2
    return w


def int4_matmul_dma(x, codes, scale, *, layer=None, win: int = 512):
    """:func:`int4_matmul` (per-channel, span-128 codes only) with ring
    stages of ``win`` rows: the int4 kernel's TMA ring is the windowed copy
    of the TPU kernel."""
    _check_dma_layout(codes, scale)
    if x.device.type == "cpu":
        return int4_matmul_dma_plain(x, codes, scale, layer=layer)
    x, c, sc, _ = _cuda_args("int4_matmul_dma", x, codes, layer, scale)
    rows, in_dim = x.shape
    out2 = c.shape[1]
    if tuple(sc.shape) != (2 * out2,):
        raise ValueError(f"int4_matmul_dma: scale {tuple(sc.shape)}")
    plan = int4_tile_plan(rows, in_dim, out2, 0, _sms(x.device),
                          x.dtype == torch.float32,
                          dma_stage_rows(in_dim, win))
    y = _launch_int4(x, c, sc, plan, 0)
    int4_matmul_dma.launches += 1
    return y


#: kernel launches since the last reset (CPU calls do not count)
int4_matmul.launches = 0
int8_matmul.launches = 0
int4_matmul_dma.launches = 0
