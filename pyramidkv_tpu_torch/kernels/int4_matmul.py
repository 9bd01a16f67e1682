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

The CUDA kernels split the in-dim across blocks; ``_plan_*`` choose that
split on the host (pure Python, so the CPU tests reach them).
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build

#: SMs of the card, read from the device at first launch (132 on an H100)
_SMS: dict = {}
#: blocks per SM a launch aims for (split-K fills the card with them)
_BLOCKS_PER_SM = 4
#: bytes of the DMA kernel's column strip
_DMA_BO = 64


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


@functools.lru_cache(maxsize=None)
def _plan_dma(rows: int, in_dim: int, out2: int, win: int = 512,
              sms: int = 132):
    """(rt, vb, win, wpb, splits) for the windowed kernel: ``win`` shrinks
    to a divisor of in_dim as in the JAX package; each block walks ``wpb``
    windows of its 64-byte strip."""
    rt = _row_tile(rows)
    vb = 16 if rt <= 2 else 4
    w = min(win, in_dim)
    while in_dim % w:
        w //= 2
    nw = in_dim // w
    tiles = (out2 // _DMA_BO) * -(-rows // rt)
    splits_t = max(1, min(nw, -(-_BLOCKS_PER_SM * sms // tiles)))
    wpb = -(-nw // splits_t)
    return rt, vb, w, wpb, -(-nw // wpb)


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


def int4_matmul(x, codes, scale, *, layer=None, group_size: int = 0):
    """``x @ dequant(codes, scale)`` reading only the packed bytes.

    x: [rows, in] bf16/f32; codes: int8 [in, out/2] span-planar packed
    nibbles, or stacked [L, in, out/2] with ``layer``; scale: [out]
    per-channel, or [in / group_size, out] with ``group_size``.  Returns
    [rows, out] in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, codes, scale, layer=layer,
                                 group_size=group_size)
    x, c, sc, flags = _cuda_args("int4_matmul", x, codes, layer, scale)
    rows, in_dim = x.shape
    out2 = c.shape[1]
    want = ((in_dim // group_size, 2 * out2) if group_size else (2 * out2,))
    if tuple(sc.shape) != want or (group_size and in_dim % group_size):
        raise ValueError(f"int4_matmul: scale {tuple(sc.shape)}, want {want}")
    rt, vb, kc, splits = _plan_stream(rows, in_dim, out2, group_size,
                                      _sms(x.device))
    y = _launch("pkv_int4_matmul", x, c, sc, 2 * out2, splits, rows, in_dim,
                out2, group_size, rt, vb, kc, splits, flags)
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


def int4_matmul_dma(x, codes, scale, *, layer=None, win: int = 512):
    """:func:`int4_matmul` (per-channel, span-128 codes only) through the
    windowed kernel: each block streams ``[win, 64-byte]`` code windows
    into shared memory by a cp.async double buffer."""
    _check_dma_layout(codes, scale)
    if x.device.type == "cpu":
        return int4_matmul_dma_plain(x, codes, scale, layer=layer)
    x, c, sc, flags = _cuda_args("int4_matmul_dma", x, codes, layer, scale)
    rows, in_dim = x.shape
    out2 = c.shape[1]
    if tuple(sc.shape) != (2 * out2,):
        raise ValueError(f"int4_matmul_dma: scale {tuple(sc.shape)}")
    rt, vb, w, wpb, splits = _plan_dma(rows, in_dim, out2, win,
                                       _sms(x.device))
    y = _launch("pkv_int4_matmul_dma", x, c, sc, 2 * out2, splits, rows,
                in_dim, out2, rt, vb, w, wpb, splits, flags)
    int4_matmul_dma.launches += 1
    return y


#: kernel launches since the last reset (CPU calls do not count)
int4_matmul.launches = 0
int8_matmul.launches = 0
int4_matmul_dma.launches = 0
