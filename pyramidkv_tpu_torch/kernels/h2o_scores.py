"""H2O heavy-hitter scores: wrappers of ``csrc/h2o_scores.cu``.

Counterpart of ``pyramidkv_tpu/kernels/h2o_scores.py::h2o_scores_pallas``:
two passes, the row statistics (m, l) of the base-2 softmax over every
visible column (:func:`h2o_row_stats`), then the column sums of
exp2(s - m) / l down every valid row (:func:`h2o_colsum`); nothing O(N^2) is
held.  :func:`h2o_scores` runs both.  On a CUDA tensor each wrapper launches
its hand-written sm_90a kernel; on a CPU tensor it runs the plain version
(``ops.scoring.h2o_row_stats``, ``h2o_colsum``, and for the whole score
``ops.scoring.h2o_scores``).

Both kernels read the query pre-scaled: q times scale * log2(e), rounded
to bf16 (:func:`scaled_query`, the TPU wrapper's ``qr``; scale defaults to
1/sqrt(D)).  Under an attention logit cap (Gemma-2) q is scaled by
``scale`` alone and each logit s becomes cap * tanh(s / cap) * log2(e) in
the kernel before any mask (log2(e) cannot pass the tanh).  At D = 32
the kernels read q as it is and multiply each f32 product by that scale
instead (``ops.attention.q_scaled``: the trained checkpoint's logits of up
to 3000 nats lose several to the fold's rounding).  Each wrapper computes
the kernels' query for itself (:func:`kernel_query`); :func:`h2o_scores`
once for both passes.  Head dims 128 and 256 (the wgmma kernels), and 32
(the trained tiny retrieval checkpoint: the mma.sync kernels of namespace
``d32``).

:func:`h2o_tile_plan` mirrors the tiles each kernel's blocks visit and
which of them they mask, and :func:`h2o_tiled_plain` runs both kernels'
schedule in plain PyTorch (the CPU tests hold it to the plain versions and
to the Pallas kernels).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import scoring
from ..ops.attention import cap_base2, folds_q, product_scale, q_scaled
from . import _build

#: the kernels' granularity: N is a multiple of it
TILE = 64
#: the head dims the kernels are built for (32: namespace ``d32`` of
#: ``csrc/h2o_scores.cu``, the same plan in 64-row tiles)
HEAD_DIMS = (32, 128, 256)
#: rows a block owns and rows of a tile of the walked axis (stats: queries,
#: then keys; colsum: keys, then queries)
BLOCK = 128
_NEG = torch.finfo(torch.float32).min
_MAX = torch.finfo(torch.float32).max


def _check(q, k, window_size, true_len, softcap=None):
    b, h, n, d = q.shape
    hk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("q", q), ("k", k)):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name} must be contiguous bfloat16 on "
                             f"{q.device}")
    if k.shape != (b, hk, n, d) or h % hk:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if d not in HEAD_DIMS or n % TILE or not 0 <= window_size < n:
        raise ValueError(f"kernel takes D in {HEAD_DIMS}, N % {TILE} == 0 "
                         f"and 0 <= W < N; got D={d} N={n} W={window_size}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if any(t.data_ptr() % 16 for t in (q, k)):
        raise ValueError("q and k must start 16-byte aligned (the copy "
                         "engine's tensor maps)")
    tl = true_len.to(device=q.device, dtype=torch.int32).contiguous()
    if tl.shape != (b,):
        raise ValueError(f"true_len must be [{b}], got {tuple(tl.shape)}")
    return tl


def scaled_query(q: torch.Tensor, scale: Optional[float] = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """q times scale * log2(e) (scale defaults to 1/sqrt(D)), or times
    scale alone under a cap, rounded to q's dtype: an f32 product rounded
    to nearest even, the TPU wrapper's ``qr`` and the plain versions'
    (``ops.attention.q_fold``).  The rounding is the kernels': Gemma-2-9B's
    scale 1/16 is a power of two, so q * scale is exact in bf16 there; a
    general scale rounds q once, where the XLA scorer scales the f32
    logits instead (``ops.scoring.h2o_scores``)."""
    d = q.shape[-1]
    if softcap is not None:
        return q * (scale if scale is not None else 1.0 / math.sqrt(d))
    return q * (math.log2(math.e) / math.sqrt(d) if scale is None
                else scale * math.log2(math.e))


def kernel_query(q: torch.Tensor, scale: Optional[float] = None,
                 softcap: Optional[float] = None):
    """(the query the kernels read, the f32 multiplier of their products):
    :func:`scaled_query` and 1 at D = 128 and 256; at D = 32 q itself and
    scale * log2(e) (scale alone under a cap)."""
    if folds_q(q.shape[-1]):
        return scaled_query(q, scale, softcap), 1.0
    return q, product_scale(q.shape[-1], scale, softcap)


def _args(qs, k, window_size, softcap, mult):
    """The C entries' trailing arguments: B, H, Hk, D, N, W, the cap (0 for
    none), the products' multiplier (read at D = 32) and the stream."""
    b, h, n, d = qs.shape
    return (b, h, k.shape[1], d, n, window_size,
            float(softcap) if softcap is not None else 0.0, float(mult),
            torch.cuda.current_stream(qs.device).cuda_stream)


def _stats(qs, k, tl, window_size, softcap, mult):
    b, h, n, _ = qs.shape
    m = torch.empty((b, h, n), dtype=torch.float32, device=qs.device)
    l = torch.empty_like(m)
    err = _build.library("h2o_scores").pkv_h2o_stats(
        qs.data_ptr(), k.data_ptr(), tl.data_ptr(), m.data_ptr(),
        l.data_ptr(), *_args(qs, k, window_size, softcap, mult))
    _build.check(err, "h2o_stats")
    h2o_row_stats.launches += 1
    return m, l


def _colsum(qs, k, tl, m, l, window_size, softcap, mult):
    b, h, n, _ = qs.shape
    for name, t in (("m", m), ("l", l)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, n)
                or not t.is_contiguous() or t.device != qs.device
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous float32 {(b, h, n)} "
                             f"on {qs.device}, 16-byte aligned")
    out = torch.empty((b, h, n - window_size), dtype=torch.float32,
                      device=qs.device)
    err = _build.library("h2o_scores").pkv_h2o_colsum(
        qs.data_ptr(), k.data_ptr(), tl.data_ptr(), m.data_ptr(),
        l.data_ptr(), out.data_ptr(), *_args(qs, k, window_size, softcap,
                                             mult))
    _build.check(err, "h2o_colsum")
    h2o_colsum.launches += 1
    return out


def h2o_row_stats(q: torch.Tensor, k: torch.Tensor, *, window_size: int,
                  true_len: torch.Tensor, scale: Optional[float] = None,
                  softcap: Optional[float] = None):
    """Pass 1: q [B, H, N, D], k [B, Hk, N, D] -> (m, l) [B, H, N] f32, the
    base-2 max and exp2-sum of each row's visible logits (padding rows on
    the card: m = float32.min, l = 0; pass 2 skips them)."""
    if q.device.type == "cpu":
        return scoring.h2o_row_stats(q, k, window_size=window_size,
                                     true_len=true_len, scale=scale,
                                     softcap=softcap)
    tl = _check(q, k, window_size, true_len, softcap)
    qs, mult = kernel_query(q, scale, softcap)
    return _stats(qs, k, tl, window_size, softcap, mult)


def h2o_colsum(q: torch.Tensor, k: torch.Tensor, m: torch.Tensor,
               l: torch.Tensor, *, window_size: int,
               true_len: torch.Tensor, scale: Optional[float] = None,
               softcap: Optional[float] = None) -> torch.Tensor:
    """Pass 2: the column sums of exp2(s - m) / max(l, 1e-30) down the valid
    rows, [B, H, N - W] f32, -inf at padding columns."""
    if q.device.type == "cpu":
        return scoring.h2o_colsum(q, k, m, l, window_size=window_size,
                                  true_len=true_len, scale=scale,
                                  softcap=softcap)
    tl = _check(q, k, window_size, true_len, softcap)
    qs, mult = kernel_query(q, scale, softcap)
    return _colsum(qs, k, tl, m, l, window_size, softcap, mult)


def h2o_scores(q: torch.Tensor, k: torch.Tensor, *, window_size: int,
               true_len: torch.Tensor, scale: Optional[float] = None,
               softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, H, N, D], k [B, Hk, N, D] (H % Hk == 0, no repeat_kv) ->
    [B, H, N - W] f32 scores, -inf at padding columns (the contract of
    ``ops.scoring.h2o_scores``, its plain version, with the model's
    ``scale`` and ``softcap``)."""
    if q.device.type == "cpu":
        return scoring.h2o_scores(q, k, window_size=window_size,
                                  true_len=true_len, scale=scale,
                                  softcap=softcap)
    tl = _check(q, k, window_size, true_len, softcap)
    qs, mult = kernel_query(q, scale, softcap)
    m, l = _stats(qs, k, tl, window_size, softcap, mult)
    return _colsum(qs, k, tl, m, l, window_size, softcap, mult)


def h2o_tile_plan(n: int, true_len: int, w: int, tile: int = BLOCK):
    """The tiles each block of the two kernels visits, for one batch row of
    ``true_len`` tokens in a buffer of n (pad = n - true_len), window w.

    A pair (row r, column c) is visible when r >= pad, c >= pad and not
    (r >= n - w and c > r): the causal part of the trailing W x W block
    (c > r >= n - w puts c there too).

    - ``"stats"``: one entry per q tile t (rows [t * tile, min(t * tile +
      tile, n))): a q tile made wholly of padding visits nothing; any other
      visits every key tile from floor(pad / tile) to the last.  A key tile
      is an edge tile, masked elementwise, when it holds a masked pair of
      the q tile's rows: it holds the pad edge, the q tile straddles the
      pad, it is cut short by n (its columns past n), or it meets the
      W x W block's causal part.
    - ``"colsum"``: one entry per column block (keys [c * tile, min(c *
      tile + tile, n - w)) are written): a block of padding columns only
      visits nothing; any other visits every query tile from floor(pad /
      tile) to the last.  A query tile is an edge tile, with its hidden rows
      masked, when it holds the pad edge or is cut short by n; columns
      below n - w never meet the W x W block, and those below the pad are
      written as -inf.

    Returns {"stats": [(range of key tiles, [edge flag per tile]), ...],
    "colsum": [(range of query tiles, [edge flags]), ...]}."""
    pad = n - true_len
    nt = -(-n // tile)
    stats = []
    for t in range(nt):
        r0, r1 = t * tile, min(t * tile + tile, n) - 1
        if r1 < pad:
            stats.append((range(0), []))
            continue
        tiles = range(pad // tile, nt)
        rb = max(r0, n - w)  # the first of the rows in the W x W block

        def edge(kt):
            c0 = kt * tile
            c1 = min(c0 + tile, n) - 1
            return (r0 < pad or c0 < pad or c0 + tile > n
                    or (rb <= r1 and c1 > rb))
        stats.append((tiles, [edge(kt) for kt in tiles]))
    colsum = []
    for c in range(-(-(n - w) // tile)):
        if min(c * tile + tile, n - w) <= pad:
            colsum.append((range(0), []))
            continue
        tiles = range(pad // tile, nt)
        colsum.append((tiles, [qt * tile < pad or qt * tile + tile > n
                               for qt in tiles]))
    return {"stats": stats, "colsum": colsum}


def h2o_tiled_plain(q: torch.Tensor, k: torch.Tensor, *, window_size: int,
                    true_len: torch.Tensor, scale: Optional[float] = None,
                    softcap: Optional[float] = None):
    """Both kernels' schedule in plain PyTorch: q [B, H, N, D], k [B, Hk, N,
    D] -> (m, l) [B, H, N] and the scores [B, H, N - W], f32 (the same
    schedule at D = 128 and 256, and at D = 32, whose kernels walk 64-row
    tiles: the same 64-key online steps and the same per-lane order of the
    column sums, a 64-row tile being 8 of the 16 query groups j).

    The query is :func:`scaled_query`'s (in f32 nothing is rounded; at
    D = 32 q itself, each product scaled: ``ops.attention.q_scaled``);
    logits are f32 products, under a cap cap * tanh(s / cap) * log2(e)
    before any mask (``ops.attention.cap_base2``).  Stats: each q tile of
    :func:`h2o_tile_plan` walks its key tiles, masks only the edge tiles
    (to -inf), and keeps the base-2 online max and exp2-sum 64 keys at a
    time (the kernel's units: a tile's two halves);
    a row with nothing visible (padding) gets m = float32.min, l = 0.
    Colsum: each column block walks its query tiles; a query's exponent
    offset is m + log2(max(l, 1e-30)) (m clamped at float32.min / 2), a
    hidden row's (an edge tile's rows below the pad or past n) float32.max;
    the kernel's thread holding key c sums exp2(s - offset) over queries j
    * 8 + 2 lane + {0, 1} of each tile (lane 0-3, j = 0..15, pairs first),
    one partial sum per lane across every tile in order, then (lane 0 +
    lane 1) + (lane 2 + lane 3); -inf at padding columns."""
    b, h, n, d = q.shape
    hk = k.shape[1]
    g = h // hk
    w = window_size
    bt = BLOCK
    qs, post = q_scaled(q, scale, softcap)
    kf = k.float()
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, h, n), -math.inf, **f32)
    l = torch.zeros((b, h, n), **f32)
    scores = torch.full((b, h, n - w), -math.inf, **f32)
    for bi in range(b):
        pad = n - int(true_len[bi])
        plan = h2o_tile_plan(n, int(true_len[bi]), w, bt)
        qb = qs[bi].reshape(hk, g, n, d)
        for t, (tiles, edges) in enumerate(plan["stats"]):
            r0, r1 = t * bt, min(t * bt + bt, n)
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            mt = m[bi, :, r0:r1].reshape(hk, g, -1)
            lt = l[bi, :, r0:r1].reshape(hk, g, -1)
            for kt, edge in zip(tiles, edges):
                # the tile's two 64-key units, the kernel's online steps
                for c0 in range(kt * bt, min(kt * bt + bt, n), bt // 2):
                    c1 = min(c0 + bt // 2, n)
                    s = cap_base2(torch.matmul(
                        qb[:, :, r0:r1],
                        kf[bi, :, None, c0:c1].transpose(-1, -2)) * post,
                        softcap)
                    if edge:
                        cols = torch.arange(c0, c1, device=q.device)[None, :]
                        hid = ((torch.minimum(rows, cols) < pad)
                               | ((rows >= n - w) & (cols > rows)))
                        s = s.masked_fill(hid, -math.inf)
                    m_new = torch.maximum(mt, s.amax(-1))
                    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                    lt.mul_(torch.exp2(mt - m_use)).add_(
                        torch.exp2(s - m_use[..., None]).sum(-1))
                    mt.copy_(m_new)
        m[bi] = torch.where(m[bi] == -math.inf, _NEG, m[bi])
        off = m[bi].clamp_min(_NEG / 2) + torch.log2(l[bi].clamp_min(1e-30))
        off = torch.cat([off, torch.full((h, bt), _MAX, **f32)], -1)
        for c, (tiles, edges) in enumerate(plan["colsum"]):
            if not tiles:
                continue
            c0, c1 = c * bt, min(c * bt + bt, n - w)
            kb = kf[bi, :, None, c0:c1]  # [hk, 1, cols, d]
            lanes = torch.zeros((h, c1 - c0, 4), **f32)
            for qt, edge in zip(tiles, edges):
                t0, t1 = qt * bt, min(qt * bt + bt, n)
                o = off[:, t0:t0 + bt].clone()
                if edge:
                    r = torch.arange(t0, t0 + bt, device=q.device)
                    o[:, (r < pad) | (r >= n)] = _MAX
                s = cap_base2(torch.matmul(
                    kb, qb[:, :, t0:t1].transpose(-1, -2)) * post, softcap)
                s = torch.nn.functional.pad(s.reshape(h, c1 - c0, -1),
                                            (0, bt - (t1 - t0)))
                p = torch.exp2(s - o[:, None, :]).reshape(h, c1 - c0, 16, 4,
                                                          2)
                pairs = p[..., 0] + p[..., 1]  # [h, cols, j, lane]
                for j in range(16):
                    lanes += pairs[:, :, j]
            cs = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2]
                                                    + lanes[..., 3])
            cols = torch.arange(c0, c1, device=q.device)
            scores[bi, :, c0:c1] = torch.where(cols >= pad, cs, -math.inf)
    return m, l, scores


#: kernel launches since the last reset (CPU calls do not count)
h2o_row_stats.launches = 0
h2o_colsum.launches = 0
