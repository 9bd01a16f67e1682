"""Key scoring (counterparts of ``pyramidkv_tpu/ops/scoring.py``'s
``window_scores``, ``h2o_scores``, ``h2o_partial_scores``, ``l2norm_scores``,
``position_scores`` and ``random_scores``).

Scorers take post-RoPE projections in a left-padded buffer of length N
(real tokens at ``[N - true_len, N)``) and return one score per non-window
column, ``[B, H, N - W]``, with -inf at padding columns so selection is one
fixed-width top-k.  The last W queries attend every key with the causal
mask applied ONLY inside the trailing W x W block (the reference's quirk),
softmax in f32, summed over the W rows, then pooled.  H2O sums the same
softmax over ALL query rows, unpooled; :func:`h2o_scores` is the plain
version of ``kernels/h2o_scores.py``.  Every scorer that forms attention
logits takes the model's ``scale`` (default 1/sqrt(D)) and ``softcap``
(Gemma-2: cap * tanh(s / cap) of the scaled logit, masks after the cap).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..prng import uniform
from .attention import _row_block, cap_base2, q_scaled, scale_softcap
from .pooling import pool1d

_NEG_INF = float("-inf")


def _column_valid(n: int, true_len: torch.Tensor) -> torch.Tensor:
    """[B, n] bool: the buffer column holds a real token (left padding)."""
    col = torch.arange(n, device=true_len.device)[None, :]
    pad = (n - true_len).to(torch.int64)[:, None]
    return col >= pad


def _window_causal_bias(window: int, n: int, device=None) -> torch.Tensor:
    """[W, n] additive bias: -inf where window query i may not see window
    key j (j > i inside the trailing W x W block); 0 elsewhere."""
    bias = torch.zeros((window, n), dtype=torch.float32, device=device)
    i = torch.arange(window, device=device)[:, None]
    j = torch.arange(window, device=device)[None, :]
    bias[:, n - window:] = torch.where(j > i, _NEG_INF, 0.0)
    return bias


def window_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    window_size: int,
    true_len: torch.Tensor,
    kernel_size: int,
    pooling: str,
    aggregation: str = "sum",
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """SnapKV-family window score, ``[B, H, N - W]`` f32, -inf at padding.

    q: [B, H, N, D]; k: [B, Hk, N, D] with H % Hk == 0 — the grouped product
    gives the same per-query-head scores as scoring after repeat_kv, with
    no repeated copy of K.  ``aggregation``: the W rows' softmax summed
    (SnapKV, PyramidKV, CAM, ThinK) or averaged (AdaKV, HeadKV).
    ``scale`` (default 1/sqrt(D)) and ``softcap`` mirror the model's
    attention (Gemma-2: the cap applies before the mask, JAX
    ``ops/scoring.py:90-100``).
    """
    b, h, n, d = q.shape
    hk = k.shape[1]
    w = window_size
    qw = q[:, :, n - w:, :].float().reshape(b, hk, (h // hk) * w, d)
    logits = scale_softcap(
        torch.matmul(qw, k.float().transpose(-1, -2)).reshape(b, h, w, n),
        scale if scale is not None else 1.0 / math.sqrt(d), softcap)
    logits = logits + _window_causal_bias(w, n, q.device)[None, None]
    colv = _column_valid(n, true_len)  # [B, N]
    logits = logits.masked_fill(~colv[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if aggregation == "sum":
        s = probs[..., : n - w].sum(dim=2)
    elif aggregation == "mean":
        s = probs[..., : n - w].mean(dim=2)
    else:
        raise ValueError(f"unknown aggregation {aggregation!r}")
    past_valid = colv[:, None, : n - w]
    s = s.masked_fill(~past_valid, 0.0)  # zero padding so pooling edges match
    s = pool1d(s, kernel_size, pooling)
    return s.masked_fill(~past_valid, _NEG_INF)


def l2norm_scores(k: torch.Tensor, *, true_len: torch.Tensor) -> torch.Tensor:
    """L2Norm: the negated f32 norm of every key, ``[B, Hk, N]`` (all
    columns, no window), -inf at padding: the top-k keeps the keys of
    lowest norm."""
    n = k.shape[2]
    norms = torch.linalg.vector_norm(k.float(), dim=-1)
    return (-norms).masked_fill(~_column_valid(n, true_len)[:, None],
                                _NEG_INF)


def position_scores(shape_ref: torch.Tensor, *, window_size: int,
                    true_len: torch.Tensor) -> torch.Tensor:
    """StreamingLLM: the negated column index, ``[B, H, N - W]``, -inf at
    padding, so the top-k keeps the earliest real tokens (the sinks)."""
    b, h, n, _ = shape_ref.shape
    w = window_size
    s = -torch.arange(n - w, dtype=torch.float32, device=shape_ref.device)
    past_valid = _column_valid(n, true_len)[:, None, : n - w]
    return s.expand(b, h, n - w).masked_fill(~past_valid, _NEG_INF)


def random_scores(key: torch.Tensor, shape_ref: torch.Tensor, *,
                  window_size: int, true_len: torch.Tensor) -> torch.Tensor:
    """Uniform-random eviction: ``jax.random.uniform(key, (B, H, N - W))``
    computed by ``prng``, -inf at padding."""
    b, h, n, _ = shape_ref.shape
    w = window_size
    s = uniform(key, (b, h, n - w))
    past_valid = _column_valid(n, true_len)[:, None, : n - w]
    return s.masked_fill(~past_valid, _NEG_INF)


def h2o_partial_scores(
    q_rows: torch.Tensor,
    k: torch.Tensor,
    *,
    row_start: int,
    window_size: int,
    true_len: torch.Tensor,
    block: int = 512,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Column-sum contribution of the query rows [row_start, row_start + C)
    to the H2O statistic, given the FULL key buffer.

    Every row's softmax normalises over all n columns (the reference's
    non-causal quirk: the causal mask only inside the trailing W x W block),
    so a row's contribution is final once the whole K buffer exists; the
    chunked prefill's second pass adds these per chunk.  q_rows: [B, H, C,
    D]; k: [B, Hk, n, D] (the grouped product: no repeat_kv copy).  Logits
    are f32 products of the operands (bf16 x bf16 is exact in f32), times
    ``scale`` (default 1/sqrt(D)), capped under ``softcap`` before the
    masks (JAX ``ops/scoring.py:118``).
    Returns the UNMASKED [B, H, n - W] f32 accumulator (padding rows add
    nothing; callers mask the padding columns once)."""
    b, h, c, d = q_rows.shape
    hk, n = k.shape[1], k.shape[2]
    g = h // hk
    w = window_size
    block = _row_block(block, b * h * n, c)
    colv = _column_valid(n, true_len)  # [B, n]
    pad = (n - true_len).to(torch.int64)
    kf = k.float().transpose(-1, -2)
    qg = q_rows.reshape(b, hk, g, c, d)
    col = torch.arange(n, device=k.device)
    acc = torch.zeros((b, hk, g, n - w), dtype=torch.float32, device=k.device)
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    for r0 in range(0, c, block):
        r = row_start + r0 + torch.arange(block, device=k.device)
        logits = scale_softcap(torch.matmul(
            qg[:, :, :, r0:r0 + block].float().reshape(b, hk, g * block, d),
            kf).reshape(b, hk, g, block, n), sc, softcap)
        # causal only where both row and column lie in the last W block
        in_blk = (r[:, None] >= n - w) & (col[None, :] >= n - w)
        hide = (in_blk & (col[None, :] > r[:, None]))[None] | ~colv[:, None]
        logits = logits.masked_fill(hide[:, None, None], _NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        row_valid = (r[None, :] >= pad[:, None]).float()  # [B, block]
        acc += (probs[..., :n - w]
                * row_valid[:, None, None, :, None]).sum(dim=3)
    return acc.reshape(b, h, n - w)


def h2o_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    window_size: int,
    true_len: torch.Tensor,
    block: int = 512,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """H2O heavy-hitter score, ``[B, H, N - W]`` f32, -inf at padding
    columns: the softmax of ALL query rows (causal only inside the trailing
    W x W block, padding rows and columns masked) summed down each
    non-window column, unpooled.  q: [B, H, N, D]; k: [B, Hk, N, D];
    ``scale`` and ``softcap`` as :func:`h2o_partial_scores`'s."""
    n = q.shape[2]
    acc = h2o_partial_scores(q, k, row_start=0, window_size=window_size,
                             true_len=true_len, block=block, scale=scale,
                             softcap=softcap)
    past_valid = _column_valid(n, true_len)[:, None, :n - window_size]
    return acc.masked_fill(~past_valid, _NEG_INF)


def _h2o_logits2(q, k, r0: int, rows: int, scale=None, softcap=None):
    """Base-2 logits of query rows [r0, r0 + rows) against every key, as
    the H2O kernels form them: q times scale * log2(e) (scale alone under
    a cap) rounded to q's dtype (``attention.q_fold``), f32 products (at
    D = 32 q as it is, each product scaled: ``attention.q_scaled``), then
    under a cap cap * tanh(s / cap) * log2(e) (``attention.cap_base2``).
    -> [B, H, rows, N]."""
    b, h, _, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    g = h // hk
    qs, post = q_scaled(q[:, :, r0:r0 + rows], scale, softcap)
    qs = qs.reshape(b, hk, g * rows, d)
    return cap_base2((torch.matmul(qs, k.float().transpose(-1, -2))
                      * post).reshape(b, h, rows, n), softcap)


def _h2o_hidden(r0: int, rows: int, n: int, w: int, colv: torch.Tensor):
    """[B, rows, N] bool: key hidden from the row (padding column, or the
    causal part of the trailing W x W block)."""
    r = r0 + torch.arange(rows, device=colv.device)
    col = torch.arange(n, device=colv.device)
    blk = ((r[:, None] >= n - w) & (col[None, :] >= n - w)
           & (col[None, :] > r[:, None]))
    return blk[None] | ~colv[:, None, :]


def h2o_row_stats(q: torch.Tensor, k: torch.Tensor, *, window_size: int,
                  true_len: torch.Tensor, block: int = 512,
                  scale: Optional[float] = None,
                  softcap: Optional[float] = None):
    """Plain version of the H2O stats kernel (``kernels/h2o_scores.py``):
    per query row, m = max and l = sum of exp2(s - m) of its base-2 logits
    (:func:`_h2o_logits2`, the cap before the mask) over the visible keys.
    -> (m, l) [B, H, N] f32."""
    b, h, n, _ = q.shape
    block = _row_block(block, b * h * n, n)
    colv = _column_valid(n, true_len)
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    for r0 in range(0, n, block):
        s = _h2o_logits2(q, k, r0, block, scale, softcap).masked_fill(
            _h2o_hidden(r0, block, n, window_size, colv)[:, None],
            _NEG_INF)
        mb = s.amax(dim=-1)
        m[..., r0:r0 + block] = mb
        l[..., r0:r0 + block] = torch.exp2(s - mb[..., None]).sum(-1)
    return m, l


def h2o_colsum(q: torch.Tensor, k: torch.Tensor, m: torch.Tensor,
               l: torch.Tensor, *, window_size: int, true_len: torch.Tensor,
               block: int = 512, scale: Optional[float] = None,
               softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version of the H2O colsum kernel: given the row statistics
    (m, l) [B, H, N], sum exp2(s - m) / max(l, 1e-30) down the valid rows
    of each non-window column.  -> [B, H, N - W] f32, -inf at padding
    columns.  (Columns < N - W never lie in the W x W block.)"""
    b, h, n, _ = q.shape
    w = window_size
    block = _row_block(block, b * h * n, n)
    colv = _column_valid(n, true_len)
    acc = torch.zeros((b, h, n - w), dtype=torch.float32, device=q.device)
    for r0 in range(0, n, block):
        s = _h2o_logits2(q, k, r0, block, scale, softcap)[..., :n - w]
        mr = m[..., r0:r0 + block, None].clamp_min(-3.4e38 / 2)
        inv = 1.0 / l[..., r0:r0 + block, None].clamp_min(1e-30)
        p = torch.exp2(s - mr) * inv
        row_valid = colv[:, None, r0:r0 + block, None]  # padding rows
        acc += p.masked_fill(~row_valid, 0.0).sum(dim=2)
    return acc.masked_fill(~colv[:, None, :n - w], _NEG_INF)
