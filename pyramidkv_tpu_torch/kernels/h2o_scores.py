"""H2O heavy-hitter scores: wrappers of ``csrc/h2o_scores.cu``.

Counterpart of ``pyramidkv_tpu/kernels/h2o_scores.py::h2o_scores_pallas``:
two passes, the row statistics (m, l) of the base-2 softmax over every
visible column (:func:`h2o_row_stats`), then the column sums of
exp2(s - m) / l down every valid row (:func:`h2o_colsum`); nothing O(N^2) is
held.  :func:`h2o_scores` runs both.  On a CUDA tensor each wrapper launches
its hand-written sm_90a kernel; on a CPU tensor it runs the plain version
(``ops.scoring.h2o_row_stats``, ``h2o_colsum``, and for the whole score
``ops.scoring.h2o_scores``).
"""

from __future__ import annotations

import math

import torch

from ..ops import scoring
from . import _build

#: rows per block and tile width of the CUDA kernels
TILE = 64
HEAD_DIM = 128


def _check(q, k, window_size, true_len):
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
    if d != HEAD_DIM or n % TILE or not 0 <= window_size < n:
        raise ValueError(f"kernel takes D == {HEAD_DIM}, N % {TILE} == 0 and "
                         f"0 <= W < N; got D={d} N={n} W={window_size}")
    tl = true_len.to(device=q.device, dtype=torch.int32).contiguous()
    if tl.shape != (b,):
        raise ValueError(f"true_len must be [{b}], got {tuple(tl.shape)}")
    return tl


def _args(q, k, window_size):
    """The C entries' trailing arguments: B, H, Hk, N, W, the base-2 scale
    log2(e)/sqrt(D) and the stream."""
    b, h, n, d = q.shape
    return (b, h, k.shape[1], n, window_size, math.log2(math.e) / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)


def h2o_row_stats(q: torch.Tensor, k: torch.Tensor, *, window_size: int,
                  true_len: torch.Tensor):
    """Pass 1: q [B, H, N, D], k [B, Hk, N, D] -> (m, l) [B, H, N] f32, the
    base-2 max and exp2-sum of each row's visible logits (padding rows on
    the card: m = float32.min, l = 0; pass 2 skips them)."""
    if q.device.type == "cpu":
        return scoring.h2o_row_stats(q, k, window_size=window_size,
                                     true_len=true_len)
    tl = _check(q, k, window_size, true_len)
    b, h, n, _ = q.shape
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = _build.library("h2o_scores").pkv_h2o_stats(
        q.data_ptr(), k.data_ptr(), tl.data_ptr(), m.data_ptr(), l.data_ptr(),
        *_args(q, k, window_size))
    _build.check(err, "h2o_stats")
    h2o_row_stats.launches += 1
    return m, l


def h2o_colsum(q: torch.Tensor, k: torch.Tensor, m: torch.Tensor,
               l: torch.Tensor, *, window_size: int,
               true_len: torch.Tensor) -> torch.Tensor:
    """Pass 2: the column sums of exp2(s - m) / max(l, 1e-30) down the valid
    rows, [B, H, N - W] f32, -inf at padding columns."""
    if q.device.type == "cpu":
        return scoring.h2o_colsum(q, k, m, l, window_size=window_size,
                                  true_len=true_len)
    tl = _check(q, k, window_size, true_len)
    b, h, n, _ = q.shape
    for name, t in (("m", m), ("l", l)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, n)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {(b, h, n)}")
    out = torch.empty((b, h, n - window_size), dtype=torch.float32,
                      device=q.device)
    err = _build.library("h2o_scores").pkv_h2o_colsum(
        q.data_ptr(), k.data_ptr(), tl.data_ptr(), m.data_ptr(), l.data_ptr(),
        out.data_ptr(), *_args(q, k, window_size))
    _build.check(err, "h2o_colsum")
    h2o_colsum.launches += 1
    return out


def h2o_scores(q: torch.Tensor, k: torch.Tensor, *, window_size: int,
               true_len: torch.Tensor) -> torch.Tensor:
    """q [B, H, N, D], k [B, Hk, N, D] (H % Hk == 0, no repeat_kv) ->
    [B, H, N - W] f32 scores, -inf at padding columns (the contract of
    ``ops.scoring.h2o_scores``, its plain version)."""
    if q.device.type == "cpu":
        return scoring.h2o_scores(q, k, window_size=window_size,
                                  true_len=true_len)
    m, l = h2o_row_stats(q, k, window_size=window_size, true_len=true_len)
    return h2o_colsum(q, k, m, l, window_size=window_size, true_len=true_len)


#: kernel launches since the last reset (CPU calls do not count)
h2o_row_stats.launches = 0
h2o_colsum.launches = 0
