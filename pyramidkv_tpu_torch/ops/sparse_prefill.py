"""MInference-style vertical-and-slash sparse prefill attention
(counterpart of ``pyramidkv_tpu/ops/sparse_prefill.py``).

The pattern is estimated from the last ``last_q`` queries' attention: a
per-head set of VERTICAL key columns (attended by every later query) and
SLASH diagonals (fixed offsets i - j).  Attention then costs
N * (Vs + tile_budget * k_tile) * D instead of N^2 * D:

* the Vs vertical columns are gathered per query head into a dense
  [B, H, Vs, D] buffer and every query attends to them exactly
  (``vertical_attention_partials``);
* slash coverage is block-granular: each q-block attends its
  ``tile_budget`` k-tiles of highest slash coverage, with the causal and
  padding masks and with the vertical columns masked out
  (``slash_tile_attention``; ``slash_tile_attention_db`` takes the first
  ``tile_valid.sum(-1)`` entries of each list instead, as the TPU db
  kernel's loop bound does: the same on valid-first lists).

Both emit online-softmax partials (unnormalised acc, row max m in natural
units, row sum l), merged here in plain torch as the JAX package leaves the
merge to XLA.  The estimation, the tile selection and the gather are plain
torch, as they are plain XLA in JAX; the three partials functions are CUDA
kernels (``kernels/block_sparse_prefill.py``) whose plain versions live
here: the CPU path runs them, and on the card the kernels are held to them.

Top-k everywhere is a stable descending sort: among equal values the lower
index comes first, as ``jax.lax.top_k`` orders them (tile scores tie all
the time).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_NEG_INF = torch.finfo(torch.float32).min
#: f32 elements one intermediate of a plain partials function may hold
#: (512 MB): heads are processed in chunks below it
_CHUNK_ELEMS = 1 << 27


class VerticalSlashPattern(NamedTuple):
    vert: torch.Tensor        #: [B, H, N] bool — kept absolute key columns
    slash: torch.Tensor       #: [B, H, N] bool — kept diagonal offsets (i - j)
    vert_idx: torch.Tensor    #: [B, H, Vs] int32 — vertical column ids
    vert_valid: torch.Tensor  #: [B, H, Vs] bool


def _topk(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: ties keep the lower index
    first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def estimate_vertical_slash(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    true_len: torch.Tensor,
    vertical_size,
    slash_size,
    last_q: int = 64,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    max_vertical: Optional[int] = None,
    max_slash: Optional[int] = None,
) -> VerticalSlashPattern:
    """Estimate the per-head pattern from the last ``last_q`` queries.

    q: [B, H, N, D], k: [B, Hk, N, D] post-RoPE, left-padded.  Sinks (the
    first 4 real tokens) and the local diagonals (offsets 0..last_q) are
    always kept.  ``vertical_size`` / ``slash_size`` are ints (one budget
    for every head) or [H] integer tensors (per-head budgets, with the top-k
    widths from the static ``max_vertical`` / ``max_slash`` and each head's
    kept set capped by rank).  Masks use float32.min, not -inf, so a window
    row that is all padding softmaxes to 1/N over every column, as in JAX.
    """
    b, h, n, d = q.shape
    hk = k.shape[1]
    dev = q.device
    w = min(last_q, n)
    pad = (n - true_len.to(dev)).to(torch.int64)
    col = torch.arange(n, device=dev)
    colv = col[None, :] >= pad[:, None]  # [B, N]

    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qw = q[:, :, n - w:, :].float()
    kf = k.float()
    if hk == h:
        logits = torch.einsum("bhwd,bhnd->bhwn", qw, kf) * sc
    else:
        g = h // hk
        logits = torch.einsum(
            "bkgwd,bknd->bkgwn", qw.reshape(b, hk, g, w, d), kf
        ).reshape(b, h, w, n) * sc
    del kf
    if softcap is not None:
        logits = torch.tanh(logits * (1.0 / softcap)) * softcap
    # causal inside the trailing w x w block
    i = torch.arange(w, device=dev)[:, None]
    j = torch.arange(w, device=dev)[None, :]
    tri = torch.where(j > i, _NEG_INF, 0.0)
    logits[:, :, :, n - w:] += tri[None, None]
    logits = torch.where(colv[:, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)  # [B, H, w, N]
    del logits

    # vertical scores: column sums; sinks boosted so they always rank in
    vscore = probs.sum(dim=2)  # [B, H, N]
    sink = colv & (col[None, :] < (pad + 4)[:, None])
    vscore = torch.where(sink[:, None, :], 1e30, vscore)
    vscore = torch.where(colv[:, None, :], vscore, float("-inf"))

    # slash scores: window row r (absolute n - w + r) adds probs[r, n-w+r-d]
    # to offset d, which is flip(probs)[r, (w-1-r) + d]: a static slice per
    # row, summed in row order as in JAX
    rev = torch.nn.functional.pad(torch.flip(probs, dims=(-1,)), (0, w))
    del probs
    sscore = torch.zeros((b, h, n), dtype=torch.float32, device=dev)
    for r in range(w):
        sscore += rev[:, :, r, w - 1 - r: w - 1 - r + n]
    del rev

    per_head = not isinstance(vertical_size, int)
    if per_head:
        assert max_vertical is not None and max_slash is not None
        vs_cap = min(max_vertical + 4, n)
        vs_true = torch.clamp(
            torch.as_tensor(vertical_size, device=dev).to(torch.int64) + 4,
            max=n)[None, :, None]
        ss_true = torch.clamp(
            torch.as_tensor(slash_size, device=dev).to(torch.int64),
            max=n)[None, :, None]
        ss = min(max_slash, n)
    else:
        vs_cap = min(vertical_size + 4, n)
        vs_true = vs_cap
        ss = min(slash_size, n)
    # the vertical width is padded to a multiple of 128 (the TPU's lane
    # width, kept so both packages gather the same columns); validity caps
    # the kept set at the configured count
    vs = min(((vs_cap + 127) // 128) * 128, n)
    vvals, vidx = _topk(vscore, vs)
    rank_v = torch.arange(vs, device=dev)[None, None, :]
    vert_valid = (torch.isfinite(vvals) | (vvals >= 1e29)) & (rank_v < vs_true)
    vert = torch.zeros((b, h, n), dtype=torch.bool, device=dev).scatter(
        -1, vidx, vert_valid)

    _, sidx = _topk(sscore, ss)
    if per_head:
        skeep = (torch.arange(ss, device=dev)[None, None, :]
                 < ss_true).expand(b, h, ss)
    else:
        skeep = torch.ones((b, h, ss), dtype=torch.bool, device=dev)
    slash = torch.zeros((b, h, n), dtype=torch.bool, device=dev).scatter(
        -1, sidx, skeep)
    # always keep the local band (offsets 0..last_q)
    slash = slash | (col <= w)[None, None, :]
    return VerticalSlashPattern(vert=vert, slash=slash,
                                vert_idx=vidx.to(torch.int32),
                                vert_valid=vert_valid)


def _slash_tile_selection(
    pattern: VerticalSlashPattern, n: int, q_block: int, k_tile: int,
    tile_budget: int,
):
    """Per q-block top-``tile_budget`` k-tiles by slash coverage.

    Offset d hits tile (qb, kb) iff d lies in
    [qb*Q - (kb+1)*K + 1, (qb+1)*Q - 1 - kb*K]; coverage counts come from
    prefix sums of the slash set.  The tile holding the q-block's first row
    and its left neighbour score n + 1 (forced); tiles with no causal
    overlap score -1.  Returns (tile_idx [B,H,nq,T] int32, tile_valid
    [B,H,nq,T] bool), valid tiles first.
    """
    b, h, _ = pattern.slash.shape
    dev = pattern.slash.device
    nq, nk = n // q_block, n // k_tile
    t = min(tile_budget, nk)
    psum = torch.cat(
        [torch.zeros((b, h, 1), dtype=torch.int32, device=dev),
         torch.cumsum(pattern.slash.to(torch.int32), dim=-1,
                      dtype=torch.int32)], dim=-1)  # [B, H, N+1]
    qb = torch.arange(nq, device=dev)[:, None]
    kb = torch.arange(nk, device=dev)[None, :]
    lo = torch.clamp(qb * q_block - (kb + 1) * k_tile + 1, 0, n)
    hi = torch.clamp((qb + 1) * q_block - kb * k_tile, 0, n)  # exclusive
    cnt = (psum[..., hi.reshape(-1)] - psum[..., lo.reshape(-1)]).reshape(
        b, h, nq, nk)
    causal_tiles = kb * k_tile <= (qb + 1) * q_block - 1
    first = (qb * q_block) // k_tile
    forced = (kb == first) | (kb == torch.clamp(first - 1, min=0))
    score = torch.where(forced[None, None], n + 1, cnt)
    score = torch.where(causal_tiles[None, None], score, -1)
    vals, idx = _topk(score, t)
    return idx.to(torch.int32), vals > 0


def gather_vertical_kv(k: torch.Tensor, v: torch.Tensor,
                       vert_idx: torch.Tensor):
    """The vertical columns of each QUERY head from grouped K/V:
    [B, Hk, N, D] + idx [B, H, Vs] -> [B, H, Vs, D] each.  An index gather,
    equal to the JAX package's one-hot contraction for finite inputs."""
    b, hk = k.shape[:2]
    h = vert_idx.shape[1]
    bi = torch.arange(b, device=k.device)[:, None, None]
    hi = (torch.arange(h, device=k.device) // (h // hk))[None, :, None]
    idx = vert_idx.long()
    return k[bi, hi, idx], v[bi, hi, idx]


def _scaled_q(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """The softmax scale folded into q and rounded to q's dtype, as the TPU
    wrappers do: ``(q.f32 * scale).astype(q.dtype)``."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return (q.float() * sc).to(q.dtype)


def _head_chunk(per_head: int, h: int) -> int:
    """Heads per chunk so that one f32 intermediate of ``per_head`` elements
    a head stays under _CHUNK_ELEMS."""
    return max(1, min(h, _CHUNK_ELEMS // max(per_head, 1)))


def slash_tile_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tile_idx: torch.Tensor,
    tile_valid: torch.Tensor,
    vert: torch.Tensor,
    true_len: torch.Tensor,
    *,
    q_block: int = 128,
    k_tile: int = 128,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
):
    """Online-softmax partials of each q-block against its listed k-tiles:
    the plain version of ``slash_tile_attention`` and, given the valid
    prefix of each list (``kernels.block_sparse_prefill.valid_prefix``)
    for ``tile_valid``, of ``slash_tile_attention_db`` (an invalid tile
    leaves the partials exactly as they were, so on a valid-first list the
    two give the same result).

    q: [B, H, N, D]; k, v: [B, Hk, N, D]; tile_idx / tile_valid
    [B, H, N/q_block, T]; vert: [B, H, N] bool, the columns to leave out
    (the vertical partials hold them).  Walks the list in order with the
    TPU kernel's online softmax, p rounded to v's dtype at the running max.
    Returns (acc [B,H,N,D] f32 unnormalised, m [B,H,N] f32, l [B,H,N] f32);
    a row with nothing visible has m = float32.min, l = 0.
    """
    b, h, n, d = q.shape
    hk = k.shape[1]
    g = h // hk
    nq, nk = n // q_block, n // k_tile
    t = tile_idx.shape[-1]
    dev = q.device
    qs = _scaled_q(q, scale)
    pad = (n - true_len.to(dev)).to(torch.int64)[:, None, None, None]
    rows = torch.arange(n, device=dev).reshape(nq, q_block)[None, None, :, :,
                                                            None]
    kt = k.reshape(b, hk, nk, k_tile, d)
    vt = v.reshape(b, hk, nk, k_tile, d)
    vertt = vert.reshape(b, h, nk, k_tile)
    ar = torch.arange(k_tile, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None]
    acc = torch.empty((b, h, n, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    l = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    hc = _head_chunk(n * k_tile, h)
    for h0 in range(0, h, hc):
        hs = slice(h0, min(h0 + hc, h))
        nh = hs.stop - h0
        qc = qs[:, hs].reshape(b, nh, nq, q_block, d).float()
        heads = torch.arange(h0, hs.stop, device=dev)[None, :, None]
        acc_c = torch.zeros((b, nh, nq, q_block, d), dtype=torch.float32,
                            device=dev)
        m_c = torch.full((b, nh, nq, q_block), _NEG_INF, dtype=torch.float32,
                         device=dev)
        l_c = torch.zeros((b, nh, nq, q_block), dtype=torch.float32,
                          device=dev)
        for ti in range(t):
            idx = tile_idx[:, hs, :, ti].long()  # [B, nh, nq]
            kk = kt[bi, heads // g, idx].float()  # [B, nh, nq, k_tile, D]
            vv = vt[bi, heads // g, idx]
            s = torch.einsum("bhqrd,bhqcd->bhqrc", qc, kk)
            del kk
            if softcap is not None:
                # tanh-cap the scaled logits before masking
                s = torch.tanh(s * (1.0 / softcap)) * softcap
            cols = (idx[..., None] * k_tile + ar)[..., None, :]
            ok = ((cols <= rows) & (cols >= pad[..., None])
                  & ~vertt[bi, heads, idx][..., None, :]
                  & tile_valid[:, hs, :, ti][..., None, None])
            s = torch.where(ok, s, _NEG_INF)
            del ok
            m_new = torch.maximum(m_c, s.amax(dim=-1))
            # masked entries underflow to exactly 0 through the clamped
            # subtraction, as in the TPU kernel
            p = torch.exp(s - torch.clamp(m_new, min=_NEG_INF / 2)[..., None])
            del s
            alpha = torch.exp(torch.clamp(m_c - m_new, max=0.0))
            l_c = alpha * l_c + p.sum(dim=-1)
            acc_c = acc_c * alpha[..., None] + torch.einsum(
                "bhqrc,bhqcd->bhqrd", p.to(v.dtype).float(), vv.float())
            m_c = m_new
            del p
        acc[:, hs] = acc_c.reshape(b, nh, n, d)
        m[:, hs] = m_c.reshape(b, nh, n)
        l[:, hs] = l_c.reshape(b, nh, n)
    return acc, m, l


def vertical_attention_partials_plain(
    q: torch.Tensor,
    k_vert: torch.Tensor,
    v_vert: torch.Tensor,
    vcol: torch.Tensor,
    vvalid: torch.Tensor,
    true_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
):
    """One-shot partials of every query against its head's Vs gathered
    vertical columns, visible where ``vcol <= row & vvalid``: the plain
    version of ``vertical_attention_partials``.  (``true_len`` is taken for
    the TPU kernel's signature; valid vertical columns lie right of the pad,
    so the mask needs none.)

    q: [B, H, N, D]; k_vert, v_vert: [B, H, Vs, D]; vcol, vvalid: [B, H, Vs].
    Returns (acc [B,H,N,D] f32 unnormalised, m [B,H,N] f32, l [B,H,N] f32).
    """
    del true_len
    b, h, n, d = q.shape
    vs = k_vert.shape[2]
    dev = q.device
    qs = _scaled_q(q, scale)
    rows = torch.arange(n, device=dev)[None, None, :, None]
    acc = torch.empty((b, h, n, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    l = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    hc = _head_chunk(b * n * vs, h)
    for h0 in range(0, h, hc):
        hs = slice(h0, min(h0 + hc, h))
        s = torch.einsum("bhnd,bhvd->bhnv", qs[:, hs].float(),
                         k_vert[:, hs].float())
        if softcap is not None:
            s = torch.tanh(s * (1.0 / softcap)) * softcap
        ok = (vcol[:, hs, None, :] <= rows) & vvalid[:, hs, None, :]
        s = torch.where(ok, s, _NEG_INF)
        del ok
        mc = s.amax(dim=-1)
        p = torch.exp(s - torch.clamp(mc, min=_NEG_INF / 2)[..., None])
        del s
        m[:, hs] = mc
        l[:, hs] = p.sum(dim=-1)
        acc[:, hs] = torch.einsum("bhnv,bhvd->bhnd",
                                  p.to(v_vert.dtype).float(),
                                  v_vert[:, hs].float())
        del p
    return acc, m, l


def _partials_fns(impl: str, slash_impl: str):
    """(vertical, slash) partials functions: the kernel wrappers (the CUDA
    kernels on CUDA tensors, the plain versions on CPU tensors) or, with
    ``impl="plain"``, the plain versions."""
    if impl == "plain":
        return vertical_attention_partials_plain, slash_tile_attention_plain
    from ..kernels import block_sparse_prefill as bsp

    return bsp.vertical_attention_partials, (
        bsp.slash_tile_attention_db if slash_impl == "db"
        else bsp.slash_tile_attention)


def merge_partials(part_v, part_s, dtype: torch.dtype) -> torch.Tensor:
    """Flash-merge the vertical and slash partials and normalise (in place
    on the partials, which are consumed).  Returns [B, H, N, D] in
    ``dtype``; a row with nothing visible on either side is 0."""
    acc_v, m_v, l_v = part_v
    acc_s, m_s, l_s = part_s
    m_all = torch.maximum(m_v, m_s)
    w_v = torch.where(m_v <= _NEG_INF / 2, 0.0,
                      torch.exp(torch.clamp(m_v - m_all, max=0.0)))
    w_s = torch.where(m_s <= _NEG_INF / 2, 0.0,
                      torch.exp(torch.clamp(m_s - m_all, max=0.0)))
    num = acc_v.mul_(w_v[..., None]).add_(acc_s.mul_(w_s[..., None]))
    den = torch.clamp(l_v * w_v + l_s * w_s, min=1e-30)
    return num.div_(den[..., None]).to(dtype)


def sparse_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pattern: VerticalSlashPattern,
    *,
    true_len: torch.Tensor,
    q_block: int = 512,
    k_tile: int = 256,
    tile_budget: int = 16,
    slash_impl: str = "grid",
    impl: str = "kernel",
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention over the pattern: the vertical columns exactly, the
    slash coverage by k-tile.  K/V may be grouped (no repeat_kv).
    ``slash_impl``: "db" takes each list's first ``tile_valid.sum(-1)``
    entries (its valid prefix), anything else its valid entries.  ``impl``:
    "kernel" (the kernel wrappers) or "plain".  Returns [B, H, N, D] in q's
    dtype."""
    n = q.shape[2]
    if n % q_block != 0:
        q_block = math.gcd(n, q_block) or n
    if n % k_tile != 0:
        k_tile = math.gcd(n, k_tile) or n
    vert_fn, slash_fn = _partials_fns(impl, slash_impl)
    tile_idx, tile_valid = _slash_tile_selection(pattern, n, q_block, k_tile,
                                                 tile_budget)
    k_vert, v_vert = gather_vertical_kv(k, v, pattern.vert_idx)
    part_v = vert_fn(q, k_vert, v_vert, pattern.vert_idx, pattern.vert_valid,
                     true_len, scale=scale, softcap=softcap)
    del k_vert, v_vert
    part_s = slash_fn(q, k, v, tile_idx, tile_valid, pattern.vert, true_len,
                      q_block=q_block, k_tile=k_tile, scale=scale,
                      softcap=softcap)
    return merge_partials(part_v, part_s, q.dtype)


def sparse_prefill_attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pattern: VerticalSlashPattern,
    *,
    true_len: torch.Tensor,
    q_block: int = 128,
    k_tile: int = 128,
    tile_budget: int = 16,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """O(N^2) oracle applying the same coverage as the gathered path
    (vertical columns exactly, slash tiles by block).  K/V at H heads or
    grouped.  Tests only."""
    b, h, n, d = q.shape
    g = h // k.shape[1]
    if n % q_block != 0:
        q_block = math.gcd(n, q_block) or n
    if n % k_tile != 0:
        k_tile = math.gcd(n, k_tile) or n
    nq, nk = n // q_block, n // k_tile
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    pad = (n - true_len.to(dev)).to(torch.int64)
    col = torch.arange(n, device=dev)
    colv = col[None, :] >= pad[:, None]
    tile_idx, tile_valid = _slash_tile_selection(pattern, n, q_block, k_tile,
                                                 tile_budget)
    covered = torch.zeros((b, h, nq, nk), dtype=torch.bool, device=dev)
    covered.scatter_(-1, tile_idx.long(), tile_valid)
    cov_cols = covered.repeat_interleave(q_block, dim=2).repeat_interleave(
        k_tile, dim=3)  # [B, H, N, N]
    allowed = pattern.vert[:, :, None, :] | cov_cols
    causal = col[None, :] <= col[:, None]
    mask = allowed & causal[None, None] & colv[:, None, None, :]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhnd->bhqn", q.float(), kf) * scale
    if softcap is not None:
        logits = torch.tanh(logits * (1.0 / softcap)) * softcap
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqn,bhnd->bhqd", probs, vf).to(q.dtype)
