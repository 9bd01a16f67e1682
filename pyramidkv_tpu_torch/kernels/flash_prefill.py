"""Causal flash-attention prefill: wrappers of ``csrc/flash_prefill.cu``.

Counterparts of ``pyramidkv_tpu/kernels/flash_prefill.py``'s
``flash_causal_attention`` (``sub_k=1``, any ``q_start``) in its default
one-pass schedule and its two-pass schedule (``two_pass=True``: pass A
:func:`flash_row_max`, pass B :func:`flash_pass_b`), and of
``flash_attention_partials``.  On a CUDA tensor each launches its
hand-written sm_90a kernel; on a CPU tensor it runs the plain version
(``ops.attention.causal_prefill_attention``, ``flash_row_max_plain``,
``flash_pass_b_plain``, ``flash_partials_plain``).  Every entry takes head
dims 128 and 256 (Gemma-2), a softmax ``scale`` and a logit cap
``softcap`` (Gemma-2's ``attn_logit_softcapping``: cap * tanh(s / cap)
before the softmax, log2(e) applied after the tanh, as the TPU kernel does).
The one-pass entry also takes head dim 32 (the trained tiny retrieval
checkpoint, ``data/tiny_retrieval.npz``: an mma.sync kernel of 64-key
tiles that scales each f32 product instead of folding the scale into a
bf16 q, ``ops.attention.folds_q``); the partials and two-pass entries
refuse it
(ROADMAP queue 2A #4).

:func:`flash_tile_plan` mirrors the key-tile plan of the one-pass,
partials and pass-B kernel (``flash_wgmma_kernel``), and
:func:`flash_tiled_plain` runs that kernel's schedule in plain PyTorch (the
CPU tests hold it to the plain versions and to the Pallas kernels);
:func:`row_max_unit_plan` and :func:`row_max_tiled_plain` do the same for
pass A's kernel (``row_max_kernel``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import (cap_base2, causal_prefill_attention,
                             flash_partials_plain, flash_pass_b_plain,
                             flash_row_max_plain, q_fold, q_scaled)
from . import _build

#: the kernels' granularity: N and Nq are multiples of it
TILE = 64
#: head dims every entry is instantiated for (256: Gemma-2)
HEAD_DIMS = (128, 256)
#: head dims of the one-pass entry (32: the trained tiny retrieval
#: checkpoint, ``csrc/flash_prefill.cu`` namespace d32)
ONE_PASS_DIMS = (32, *HEAD_DIMS)
#: the refusal of D = 32 by the entries not ported there yet
D32_QUEUED = ("flash's partials, pass A and pass B at D = 32 are not ported "
              "yet (ROADMAP queue 2A #4)")
#: q rows per block and keys per tile of the one-pass, partials and pass-B
#: kernel (``csrc/flash_prefill.cu``, namespace ``wg``) at D = 128
BLOCK_Q = 128
BLOCK_K = 128


def block_k(d: int) -> int:
    """Keys a tile of the one-pass, partials and pass-B kernel at head dim
    ``d``: 128, or 64 at D = 256 (Q and two stages of 128-key K and V tiles
    would need 321 KB of shared memory; 64-key tiles take 193 KB) and at
    D = 32 (the mma.sync kernel: 8 n-tiles of S a warp)."""
    return 64 if d in (32, 256) else BLOCK_K


def _check(q, k, v, true_len, nq_ok: bool, ldk: int, dims=HEAD_DIMS):
    """Shape/dtype/device checks shared by both wrappers; returns the
    true_len tensor the kernel reads.  k and v may be the first N rows of
    a buffer of ``ldk`` rows per head; ``dims``: the entry's head dims."""
    b, h, nq, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    want = (hk * ldk * d, ldk * d, d, 1)
    if not q.is_contiguous() or ldk < n or any(
            st != w for t in (k, v)
            for size, st, w in zip(t.shape, t.stride(), want) if size > 1):
        raise ValueError("q must be contiguous, k and v [B, Hk, N, D] views "
                         "of contiguous [B, Hk, >= N, D] buffers")
    if k.shape != (b, hk, n, d) or v.shape != k.shape or h % hk or not nq_ok:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d == 32 and d not in dims:
        raise ValueError(D32_QUEUED)
    if d not in dims or n % TILE or nq % TILE:
        raise ValueError(f"kernel takes D in {dims} and N, Nq % {TILE} "
                         f"== 0, got D={d} N={n} Nq={nq}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start 16-byte aligned (the copy "
                         "engine's tensor maps)")
    tl = true_len.to(device=q.device, dtype=torch.int32).contiguous()
    if tl.shape != (b,):
        raise ValueError(f"true_len must be [{b}], got {tuple(tl.shape)}")
    return tl


def flash_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    true_len: torch.Tensor,
    *,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    q_start: int = 0,
    two_pass: bool = False,
) -> torch.Tensor:
    """Causal GQA attention over a left-padded buffer.

    q: [B, H, Nq, D]; k, v: [B, Hk, N, D] (on the card: contiguous, or the
    first N rows of a contiguous [B, Hk, >= N, D] buffer, as a prefill chunk
    reads its carry); true_len: [B] int.  The queries sit at global columns
    [q_start, q_start + Nq) of the keys (a prefill chunk: q_start + Nq == N;
    the monolithic prefill: q_start = 0, Nq == N).  ``two_pass``: the TPU's
    two-pass schedule, :func:`flash_row_max` then :func:`flash_pass_b`.
    ``scale``: the softmax scale (default 1/sqrt(D)); ``softcap``: cap the
    logits at cap * tanh(s / cap).  Returns [B, H, Nq, D]; rows below the
    left pad are 0 on the card (no visible key) and unspecified on the CPU
    path — callers never read them.
    """
    kw = dict(sliding_window=sliding_window, scale=scale, softcap=softcap,
              q_start=q_start)
    if two_pass:
        return flash_pass_b(q, k, v, flash_row_max(q, k, true_len, **kw),
                            true_len, **kw)
    if q.device.type == "cpu":
        return causal_prefill_attention(q, k, v, true_len=true_len, **kw)
    out = torch.empty_like(q)
    err = _launch("pkv_flash_prefill", q, k, v, true_len, (out,), **kw)
    _build.check(err, "flash_prefill")
    flash_causal_attention.launches += 1
    return out


def _launch(symbol, q, k, v, true_len, outs, *, sliding_window, scale,
            softcap, q_start, m=None):
    """Check the arguments of a normalised-attention entry point of
    ``csrc/flash_prefill.cu`` and launch ``symbol`` (pass A takes no v: it
    is given k's); returns its error code."""
    b, h, nq, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    # rows per head of the buffer k and v view (size-1 dims carry no stride)
    ldk = (k.stride(1) // d if hk > 1 else k.stride(0) // d if b > 1 else n)
    tl = _check(q, k, v, true_len,
                q_start + nq == n or (q_start == 0 and nq == n), ldk,
                ONE_PASS_DIMS if symbol == "pkv_flash_prefill" else HEAD_DIMS)
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    ins = [q.data_ptr(), k.data_ptr()]
    cap = _cap_arg(softcap)
    if symbol != "pkv_flash_row_max":
        ins.append(v.data_ptr())
    ins.append(tl.data_ptr())
    if m is not None:
        ins.append(m.data_ptr())
    return getattr(_build.library("flash_prefill"), symbol)(
        *ins, *(o.data_ptr() for o in outs), b, h, hk, d, n, ldk, nq, q_start,
        int(sliding_window or 0), float(sc), cap,
        torch.cuda.current_stream(q.device).cuda_stream)


def _cap_arg(softcap: Optional[float]) -> float:
    """The C entries' cap argument: the cap, or 0 for none."""
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return float(softcap or 0.0)


def flash_row_max(q: torch.Tensor, k: torch.Tensor, true_len: torch.Tensor,
                  *, sliding_window: Optional[int] = None,
                  scale: Optional[float] = None,
                  softcap: Optional[float] = None,
                  q_start: int = 0) -> torch.Tensor:
    """Pass A of the two-pass schedule (the TPU's ``_max_kernel``): each
    query row's max base-2 logit (capped under ``softcap``) over its
    visible keys.  Arguments as :func:`flash_causal_attention`.  Returns m
    [B, H, Nq] f32 (float32.min for a row with no visible key)."""
    if q.device.type == "cpu":
        return flash_row_max_plain(q, k, true_len,
                                   sliding_window=sliding_window,
                                   scale=scale, softcap=softcap,
                                   q_start=q_start)
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = _launch("pkv_flash_row_max", q, k, k, true_len, (m,),
                  sliding_window=sliding_window, scale=scale,
                  softcap=softcap, q_start=q_start)
    _build.check(err, "flash_row_max")
    flash_row_max.launches += 1
    return m


def flash_pass_b(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 m: torch.Tensor, true_len: torch.Tensor, *,
                 sliding_window: Optional[int] = None,
                 scale: Optional[float] = None,
                 softcap: Optional[float] = None,
                 q_start: int = 0) -> torch.Tensor:
    """Pass B of the two-pass schedule (the TPU's ``_kernel_pass_b``): the
    rescale-free accumulation against pass A's row maxes ``m`` [B, H, Nq]
    f32, on the one-pass kernel's pipeline (``flash_tiled_plain`` with
    ``m_known`` is its schedule).  Returns [B, H, Nq, D] in q's dtype, 0 on
    rows with no visible key."""
    if q.device.type == "cpu":
        return flash_pass_b_plain(q, k, v, m, true_len,
                                  sliding_window=sliding_window, scale=scale,
                                  softcap=softcap, q_start=q_start)
    if (m.dtype != torch.float32 or tuple(m.shape) != tuple(q.shape[:3])
            or not m.is_contiguous() or m.device != q.device):
        raise ValueError(f"m must be contiguous float32 {tuple(q.shape[:3])} "
                         f"on {q.device}, got {m.dtype} {tuple(m.shape)}")
    out = torch.empty_like(q)
    err = _launch("pkv_flash_pass_b", q, k, v, true_len, (out,), m=m,
                  sliding_window=sliding_window, scale=scale,
                  softcap=softcap, q_start=q_start)
    _build.check(err, "flash_pass_b")
    flash_pass_b.launches += 1
    return out


def flash_attention_partials(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    true_len: torch.Tensor,
    *,
    q_start: int = 0,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
):
    """Online-softmax partials of causal GQA attention, statistics in the
    BASE-2 domain (see ``ops.attention.flash_partials_plain``; ``scale``
    and ``softcap`` as :func:`flash_causal_attention`'s).

    q: [B, H, Nq, D]; k, v: [B, Hk, N, D]; true_len: [B] valid keys (at the
    right end of the tile).  ``q_start == 0`` (Nq == N): the causal self
    tile; ``q_start >= N``: every key precedes every query, ``q_start``
    rows before the first (a history tile at its true distance, so that
    ``sliding_window`` hides the keys ``q_start + r - c >= W`` behind row
    r).  Returns (acc [B, H, Nq, D], m [B, H, Nq], l [B, H, Nq]) f32."""
    if q.device.type == "cpu":
        return flash_partials_plain(q, k, v, true_len, q_start=q_start,
                                    sliding_window=sliding_window,
                                    scale=scale, softcap=softcap)
    b, h, nq, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    tl = _check(q, k, v, true_len,
                (q_start == 0 and nq == n) or q_start >= n, n)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((b, h, nq, d), **f32)
    m = torch.empty((b, h, nq), **f32)
    l = torch.empty((b, h, nq), **f32)
    lib = _build.library("flash_prefill")
    err = lib.pkv_flash_partials(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tl.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, hk, d, n, nq,
        q_start, int(sliding_window or 0),
        float(scale if scale is not None else 1.0 / math.sqrt(d)),
        _cap_arg(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_partials")
    flash_attention_partials.launches += 1
    return acc, m, l


def flash_tile_plan(n: int, nq: int, q_start: int, pad: int,
                    window: Optional[int] = None, bk: int = BLOCK_K):
    """The key tiles of ``bk`` keys (:func:`block_k`) each q tile of the
    one-pass, partials and pass-B kernel visits.

    Queries sit at global rows [q_start, q_start + nq) of n keys, the first
    ``pad`` of which are padding.  q tile t holds rows q_start + t *
    BLOCK_Q up to the last real row; it visits the key tiles from the one
    holding its pad or window edge (its first row's) to
    the one holding its causal edge (its last row's; none past n: a history
    tile, q_start >= n, sees every key).  A tile is interior when every
    (row, key) pair of the q tile's rows and the tile's keys is visible:
    past the pad, causal, below n and inside the window; the kernel masks
    only the others.  Returns one (range of key-tile indices, [interior
    flag per tile]) per q tile."""
    bq = BLOCK_Q
    plan = []
    for t in range(-(-nq // bq)):
        g0 = q_start + t * bq
        g1 = min(g0 + bq, q_start + nq) - 1
        lo = max(pad, g0 - window + 1) if window else pad
        hi = min(g1, n - 1)
        tiles = range(lo // bk, hi // bk + 1) if lo <= hi else range(0)
        plan.append((tiles, [
            kt * bk >= pad and kt * bk + bk - 1 <= g0 and kt * bk + bk <= n
            and (not window or g1 - kt * bk < window) for kt in tiles]))
    return plan


def flash_tiled_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      true_len: torch.Tensor, *,
                      sliding_window: Optional[int] = None,
                      scale: Optional[float] = None,
                      softcap: Optional[float] = None, q_start: int = 0,
                      partials: bool = False,
                      m_known: Optional[torch.Tensor] = None):
    """The schedule of the one-pass, partials and pass-B kernel
    (``flash_wgmma_kernel``) in plain PyTorch: each q tile walks its
    :func:`flash_tile_plan` (tiles of :func:`block_k` keys), masks only the
    tiles that are not interior, and runs the base-2 online softmax tile by
    tile, with q scaled by scale * log2(e) (by scale alone under
    ``softcap``, each tile's logits then capped in base 2) and rounded to
    q's dtype (at D = 32 q is kept and each f32 product scaled instead:
    ``ops.attention.q_scaled``) and each tile's P rounded to v's dtype at
    the running max (as the kernel does in bf16; with f32 inputs nothing is
    rounded).  Arguments as :func:`flash_causal_attention`; ``partials``:
    return (acc, m, l) f32 as
    :func:`flash_attention_partials` does, else the output in q's dtype (0
    on rows with no visible key).  ``m_known`` [B, H, Nq]: pass B against
    these row maxes (pass A's), clamped to float32.min / 2, edge tiles
    masked to float32.min: P = exp2(S - m) with no running max and no
    rescale, P rounded at the known max."""
    b, h, nq, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    g = h // hk
    bq, bk = BLOCK_Q, block_k(d)
    qr, post = q_scaled(q, scale, softcap)
    kf, vf = k.float(), v.float()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, nq, d), **f32)
    m = torch.full((b, h, nq), -math.inf, **f32)
    l = torch.zeros((b, h, nq), **f32)
    neg = torch.finfo(torch.float32).min
    if m_known is not None:
        m = m_known.float().clamp_min(neg / 2)
    for bi in range(b):
        pad = n - int(true_len[bi])
        plan = flash_tile_plan(n, nq, q_start, pad, sliding_window, bk)
        for t, (tiles, interior) in enumerate(plan):
            r0, r1 = t * bq, min(t * bq + bq, nq)
            rows = q_start + torch.arange(r0, r1, device=q.device)[:, None]
            qt = qr[bi, :, r0:r1].reshape(hk, g, r1 - r0, d)
            mt = m[bi, :, r0:r1].reshape(hk, g, -1)
            lt = l[bi, :, r0:r1].reshape(hk, g, -1)
            at = acc[bi, :, r0:r1].reshape(hk, g, r1 - r0, d)
            for kt, inner in zip(tiles, interior):
                c0, c1 = kt * bk, min(kt * bk + bk, n)
                s = cap_base2(torch.matmul(
                    qt, kf[bi, :, None, c0:c1].transpose(-1, -2)) * post,
                    softcap)
                if not inner:
                    cols = torch.arange(c0, c1, device=q.device)[None, :]
                    vis = (cols >= pad) & (cols <= rows)
                    if sliding_window:
                        vis &= rows - cols < sliding_window
                    s = s.masked_fill(
                        ~vis, -math.inf if m_known is None else neg)
                if m_known is not None:  # pass B: the known max
                    p = torch.exp2(s - mt[..., None])
                    lt.add_(p.sum(-1))
                    at.add_(torch.matmul(p.to(v.dtype).float(),
                                         vf[bi, :, None, c0:c1]))
                    continue
                m_new = torch.maximum(mt, s.amax(-1))
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(mt - m_use)
                p = torch.exp2(s - m_use[..., None])
                lt.mul_(alpha).add_(p.sum(-1))
                at.mul_(alpha[..., None]).add_(torch.matmul(
                    p.to(v.dtype).float(), vf[bi, :, None, c0:c1]))
                mt.copy_(m_new)
    if partials:
        return acc, torch.where(m == -math.inf, neg, m), l
    inv = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), 0.0)
    return (acc * inv[..., None]).to(q.dtype)


#: keys of one unit of pass A's kernel (``row_max_kernel``): a 128-key
#: tile is walked as two units by each 64-row consumer warpgroup
UNIT = 64


def row_max_unit_plan(n: int, nq: int, q_start: int, pad: int,
                      window: Optional[int] = None):
    """The units pass A's kernel (``csrc/flash_prefill.cu``, namespace
    ``rm``) walks: per q tile of BLOCK_Q rows, per 64-row consumer
    warpgroup, every 64-key unit of the tiles :func:`flash_tile_plan`
    gives the q tile, in order, as (first key, interior).  A unit is
    interior when every (row, key) pair of the warpgroup's 64 rows
    (counted to 64 even past nq) and the unit's 64 keys is visible: past
    the pad, causal, below n and inside the window; the kernel masks only
    the others (the diagonal, the pad edge, the window edge, a tile cut
    short by n).  Returns [q tile][warpgroup] -> [(first key, interior)]."""
    plan = []
    for t, (tiles, _) in enumerate(flash_tile_plan(n, nq, q_start, pad,
                                                   window)):
        g0 = q_start + t * BLOCK_Q
        groups = []
        for cw in range(BLOCK_Q // UNIT):
            r_lo = g0 + cw * UNIT
            groups.append([
                (cu, cu >= pad and cu + UNIT - 1 <= r_lo and cu + UNIT <= n
                 and (not window or r_lo + UNIT - 1 - cu < window))
                for kt in tiles for cu in (kt * BLOCK_K, kt * BLOCK_K + UNIT)])
        plan.append(groups)
    return plan


def row_max_tiled_plain(q: torch.Tensor, k: torch.Tensor,
                        true_len: torch.Tensor, *,
                        sliding_window: Optional[int] = None,
                        scale: Optional[float] = None,
                        softcap: Optional[float] = None,
                        q_start: int = 0) -> torch.Tensor:
    """Pass A's kernel schedule in plain PyTorch: each warpgroup's 64 rows
    of bf16(q * scale * log2 e) (q * scale under ``softcap``; q's dtype,
    f32 is not rounded) walk their :func:`row_max_unit_plan` units, the
    mask applied only to units that are not interior, a running max per
    row, capped at the end under ``softcap`` (the cap is monotonic).
    Arguments as :func:`flash_row_max`; returns m [B, H, Nq] f32,
    float32.min on a row with no visible key."""
    b, h, nq, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    g = h // hk
    qr = q_fold(q, scale, softcap)
    kf = k.float()
    m = torch.full((b, h, nq), -math.inf, dtype=torch.float32,
                   device=q.device)
    for bi in range(b):
        pad = n - int(true_len[bi])
        plan = row_max_unit_plan(n, nq, q_start, pad, sliding_window)
        for t, groups in enumerate(plan):
            for cw, units in enumerate(groups):
                r0 = t * BLOCK_Q + cw * UNIT
                r1 = min(r0 + UNIT, nq)
                if r0 >= r1:
                    continue  # rows past Nq: never written
                rows = q_start + torch.arange(r0, r1, device=q.device)[:, None]
                qt = qr[bi, :, r0:r1].reshape(hk, g, r1 - r0, d)
                mt = m[bi, :, r0:r1].reshape(hk, g, -1)
                for cu, inner in units:
                    c1 = min(cu + UNIT, n)
                    if c1 <= cu:
                        continue  # keys past n: zeros, all masked
                    s = torch.matmul(qt, kf[bi, :, None, cu:c1].transpose(
                        -1, -2))
                    if not inner:
                        cols = torch.arange(cu, c1, device=q.device)[None, :]
                        vis = (cols >= pad) & (cols <= rows)
                        if sliding_window:
                            vis &= rows - cols < sliding_window
                        s = s.masked_fill(~vis, -math.inf)
                    mt.copy_(torch.maximum(mt, s.amax(-1)))
    return torch.where(m == -math.inf, torch.finfo(torch.float32).min,
                       cap_base2(m, softcap))


#: kernel launches since the last reset (CPU calls do not count)
flash_causal_attention.launches = 0
flash_row_max.launches = 0
flash_pass_b.launches = 0
flash_attention_partials.launches = 0
