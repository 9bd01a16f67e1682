"""MInference's block-sparse prefill partials: wrappers of
``csrc/block_sparse_prefill.cu``.

Counterparts of ``pyramidkv_tpu/kernels/block_sparse_prefill.py``'s
``slash_tile_attention``, ``slash_tile_attention_db`` and
``vertical_attention_partials_kernel``.  On a CUDA tensor each launches its
hand-written sm_90a kernel (``sp::sparse_wgmma_kernel``; both slash
functions its slash walk); on a CPU tensor it runs the plain version
(``ops/sparse_prefill.py``).  All three return online-softmax partials
(acc [B,H,N,D] f32 unnormalised, m and l [B,H,N] f32, m in natural units);
a row with nothing visible has m = float32.min and l = 0.  Head dims 128
and 256 (``s2::sparse256_kernel``: 64-key tiles, no producer warp), each
with and without Gemma-2's attention logit cap (cap * tanh(s / cap) of the
scaled logit once it lands, before any mask; the query is bf16(q * scale)
either way, as the TPU wrappers fold it).

The two slash functions differ only in which list entries count: every
valid one (``slash_tile_attention``), or the first ``tile_valid.sum(-1)``
entries whatever their flags (``slash_tile_attention_db``, the TPU db
kernel's loop bound; :func:`valid_prefix`).  On a valid-first list, as
the tile selection makes them, the two are one function.

The kernels trust the index arrays they are given: tile ids in
[0, N/k_tile) and vertical column ids in [0, N), as the estimation and tile
selection of ``ops/sparse_prefill.py`` produce them.

:func:`vertical_tile_plan` and :func:`slash_unit_plan` mirror the walks of
the vertical and grid slash kernel (``sp::sparse_wgmma_kernel``), and
:func:`vertical_tiled_plain` and :func:`slash_tiled_plain` run its schedule
in plain PyTorch (the CPU tests hold them to the plain versions and to the
Pallas kernels).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..ops.sparse_prefill import (_scaled_q, slash_tile_attention_plain,
                                  vertical_attention_partials_plain)
from . import _build

#: the kernels' grain (rows of a consumer warpgroup, keys of a unit): N,
#: q_block, k_tile and Vs are multiples of it
TILE = 64
#: the head dims the kernels are built for
HEAD_DIMS = (128, 256)
#: the refusal of head dim 32 (the trained tiny retrieval checkpoint)
D32_QUEUED = ("the block-sparse kernels at D = 32 are not ported yet "
              "(ROADMAP queue 2A #4)")
#: q rows per block, keys per unit and keys per tile of the vertical and
#: grid slash kernel (namespace ``sp``)
BLOCK_Q = 128
UNIT = 64
BLOCK_K = 2 * UNIT
#: the sort key of an invalid vertical column: after every row
NO_KEY = 2 ** 31 - 1


def _check_operands(named, device) -> None:
    for name, t, dtype in named:
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{device}, got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_card(q: torch.Tensor, softcap) -> float:
    """The C entries' cap (0 for none) of a call on the card."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return float(softcap) if softcap is not None else 0.0


def _outputs(q: torch.Tensor):
    b, h, n, d = q.shape
    return (torch.empty((b, h, n, d), dtype=torch.float32, device=q.device),
            torch.empty((b, h, n), dtype=torch.float32, device=q.device),
            torch.empty((b, h, n), dtype=torch.float32, device=q.device))


def _slash(q, k, v, tile_idx, tile_valid, vert, true_len, q_block,
           k_tile, scale, softcap):
    cap = _check_card(q, softcap)
    b, h, n, d = q.shape
    hk = k.shape[1]
    if k.shape != (b, hk, n, d) or v.shape != k.shape or hk < 1 or h % hk:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d == 32:
        raise ValueError(D32_QUEUED)
    if (d not in HEAD_DIMS or n % TILE or q_block % TILE or k_tile % TILE
            or n % q_block or n % k_tile):
        raise ValueError(
            f"kernel takes D in {HEAD_DIMS}, N % {TILE} == 0 and q_block, "
            f"k_tile multiples of {TILE} dividing N; got D={d} N={n} "
            f"q_block={q_block} k_tile={k_tile}")
    nq = n // q_block
    t = tile_idx.shape[-1]
    if (tile_idx.shape != (b, h, nq, t) or tile_valid.shape != tile_idx.shape
            or vert.shape != (b, h, n) or t < 1):
        raise ValueError(f"bad shapes tile_idx {tuple(tile_idx.shape)} "
                         f"tile_valid {tuple(tile_valid.shape)} vert "
                         f"{tuple(vert.shape)} for q {tuple(q.shape)}, "
                         f"q_block {q_block}")
    tl = true_len.to(device=q.device, dtype=torch.int32).contiguous()
    if tl.shape != (b,):
        raise ValueError(f"true_len must be [{b}], got {tuple(tl.shape)}")
    bf = torch.bfloat16
    _check_operands((("q", q, bf), ("k", k, bf), ("v", v, bf),
                     ("tile_idx", tile_idx, torch.int32),
                     ("tile_valid", tile_valid, torch.bool),
                     ("vert", vert, torch.bool)), q.device)
    acc, m, l = _outputs(q)
    sc = float(scale if scale is not None else 1.0 / math.sqrt(d))
    lib = _build.library("block_sparse_prefill")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    vbits = pack_vertical_bits(vert)
    err = lib.pkv_slash_tiles(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tile_idx.data_ptr(),
        tile_valid.data_ptr(), vbits.data_ptr(), tl.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, hk, d, n, q_block,
        k_tile, t, vbits.shape[-1], sc, cap, stream)
    _build.check(err, "slash_tiles")
    return acc, m, l


def valid_prefix(tile_valid: torch.Tensor) -> torch.Tensor:
    """The entries the TPU db kernel visits: [B, H, nq, T] bool, true for
    the first ``tile_valid.sum(-1)`` entries of each list, whatever their
    own flags.  Equal to ``tile_valid`` on a valid-first list."""
    t = tile_valid.shape[-1]
    nval = tile_valid.sum(dim=-1, keepdim=True)
    return (torch.arange(t, device=tile_valid.device) < nval).contiguous()


def pack_vertical_bits(vert: torch.Tensor) -> torch.Tensor:
    """vert [B, H, N] bool as [B*H, W] int64 words, bit c of word w the
    flag of column 64 w + c; W = 2 ceil(N / 128), even, so the kernel's
    16-byte copies of a word pair stay aligned and inside the row."""
    b, h, n = vert.shape
    words = 2 * -(-n // BLOCK_K)
    bits = torch.zeros((b * h, words * UNIT), dtype=torch.bool,
                       device=vert.device)
    bits[:, :n] = vert.reshape(b * h, n)
    shift = torch.arange(UNIT, dtype=torch.int64, device=vert.device)
    # distinct powers of two: the sum is the bitwise or (bit 63 wraps to
    # the sign, as in the kernel's unsigned words)
    return (bits.view(b * h, words, UNIT).to(torch.int64) << shift).sum(-1)


def slash_tile_attention(
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
    """Partials of each q-block against its T listed k-tiles (every entry
    visited, invalid ones skipped), causal, right of the pad, vertical
    columns left out.  q: [B, H, N, D]; k, v: [B, Hk, N, D] bf16;
    tile_idx int32 / tile_valid bool [B, H, N/q_block, T]; vert [B, H, N]
    bool; true_len [B]."""
    if q.device.type == "cpu":
        return slash_tile_attention_plain(
            q, k, v, tile_idx, tile_valid, vert, true_len, q_block=q_block,
            k_tile=k_tile, scale=scale, softcap=softcap)
    out = _slash(q, k, v, tile_idx, tile_valid, vert, true_len, q_block,
                 k_tile, scale, softcap)
    slash_tile_attention.launches += 1
    return out


def slash_tile_attention_db(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tile_idx: torch.Tensor,
    tile_valid: torch.Tensor,
    vert: torch.Tensor,
    true_len: torch.Tensor,
    *,
    q_block: int = 512,
    k_tile: int = 256,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
):
    """:func:`slash_tile_attention` over each list's valid prefix
    (:func:`valid_prefix`): its first ``tile_valid.sum(-1)`` entries, as
    the TPU db kernel walks them.  On the card the same kernel as
    :func:`slash_tile_attention`, given the prefix for the flags."""
    prefix = valid_prefix(tile_valid)
    if q.device.type == "cpu":
        return slash_tile_attention_plain(
            q, k, v, tile_idx, prefix, vert, true_len, q_block=q_block,
            k_tile=k_tile, scale=scale, softcap=softcap)
    out = _slash(q, k, v, tile_idx, prefix, vert, true_len, q_block, k_tile,
                 scale, softcap)
    slash_tile_attention_db.launches += 1
    return out


def vertical_attention_partials(
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
    """Partials of every query against its head's Vs gathered vertical
    columns, visible where ``vcol <= row & vvalid``.  q: [B, H, N, D];
    k_vert, v_vert: [B, H, Vs, D] bf16; vcol int32 / vvalid bool
    [B, H, Vs]."""
    if q.device.type == "cpu":
        return vertical_attention_partials_plain(
            q, k_vert, v_vert, vcol, vvalid, true_len, scale=scale,
            softcap=softcap)
    cap = _check_card(q, softcap)
    b, h, n, d = q.shape
    vs = k_vert.shape[2]
    if (k_vert.shape != (b, h, vs, d) or v_vert.shape != k_vert.shape
            or vcol.shape != (b, h, vs) or vvalid.shape != vcol.shape):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_vert "
                         f"{tuple(k_vert.shape)} v_vert {tuple(v_vert.shape)}"
                         f" vcol {tuple(vcol.shape)} vvalid "
                         f"{tuple(vvalid.shape)}")
    if d == 32:
        raise ValueError(D32_QUEUED)
    if d not in HEAD_DIMS or n % TILE or vs % TILE or vs < 1:
        raise ValueError(f"kernel takes D in {HEAD_DIMS}, N and Vs "
                         f"multiples of {TILE}; got D={d} N={n} Vs={vs}")
    bf = torch.bfloat16
    _check_operands((("q", q, bf), ("k_vert", k_vert, bf),
                     ("v_vert", v_vert, bf), ("vcol", vcol, torch.int32),
                     ("vvalid", vvalid, torch.bool)), q.device)
    order, keys, counts = sort_vertical_columns(vcol, vvalid, n)
    # the kernel's scratch: K and V rows in key order
    k_sorted, v_sorted = torch.empty_like(k_vert), torch.empty_like(v_vert)
    acc, m, l = _outputs(q)
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _build.library("block_sparse_prefill")
    err = lib.pkv_vertical_partials(
        q.data_ptr(), k_vert.data_ptr(), v_vert.data_ptr(), order.data_ptr(),
        keys.data_ptr(), counts.data_ptr(), k_sorted.data_ptr(),
        v_sorted.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), b,
        h, d, n, vs, keys.shape[-1], float(sc), cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vertical_partials")
    vertical_attention_partials.launches += 1
    return acc, m, l


def _vertical_keys(vcol: torch.Tensor, vvalid: torch.Tensor):
    """(sorted keys, order) of vertical columns: a column's key is its id
    where valid and NO_KEY otherwise, ascending along the last axis (a
    stable sort: equal keys keep their order)."""
    key = torch.where(vvalid, vcol.to(torch.int32),
                      torch.full_like(vcol, NO_KEY, dtype=torch.int32))
    return torch.sort(key, dim=-1, stable=True)


def sort_vertical_columns(vcol: torch.Tensor, vvalid: torch.Tensor, n: int):
    """The vertical kernel's walk inputs: each (b, h)'s Vs columns in key
    order (its ``gather_sorted_kernel`` copies their K and V rows in that
    order).  Returns (order [B, H, Vs] int64; keys [B, H, vs_pad] int32,
    the sorted keys padded with NO_KEY to a multiple of BLOCK_K; counts
    [B, H, ceil(N / BLOCK_Q), 2] int32: per q tile, the sorted columns with
    key <= its first row (every row of the tile sees them) and <= its
    last)."""
    keys, order = _vertical_keys(vcol, vvalid)
    if keys.shape[-1] % BLOCK_K:
        keys = torch.nn.functional.pad(keys, (0, -keys.shape[-1] % BLOCK_K),
                                       value=NO_KEY)
    bounds = _tile_bounds(n, keys.device)
    counts = torch.searchsorted(
        keys, bounds.expand(*keys.shape[:-1], -1).contiguous(), right=True,
        out_int32=True)
    return order, keys, counts.view(*keys.shape[:-1], -1, 2)


@functools.lru_cache(maxsize=None)
def _tile_bounds(n: int, device: torch.device) -> torch.Tensor:
    """[2 ceil(n / BLOCK_Q)] int32: each q tile's first and last row."""
    q0 = torch.arange(0, n, BLOCK_Q, dtype=torch.int32)
    return torch.stack([q0, q0 + BLOCK_Q - 1], dim=-1).reshape(-1).to(device)


def vertical_tile_plan(vcol: torch.Tensor, vvalid: torch.Tensor, n: int):
    """The vertical kernel's walk for one (b, h): vcol, vvalid [Vs].

    The columns are sorted by key (:func:`sort_vertical_columns`); q tile t
    (rows 128 t up to 128 t + 127) visits the 128-column tiles of the
    sorted order up to the last column with key <= its last row, and a
    tile is interior (unmasked) when every key in it is <= the q tile's
    first row.  Returns (order [Vs] int64, sorted keys [Vs] int32, one
    [(tile index, interior)] per q tile)."""
    keys, order = _vertical_keys(vcol, vvalid)
    plan = []
    for q0 in range(0, n, BLOCK_Q):
        n_first = int((keys <= q0).sum())
        n_last = int((keys <= q0 + BLOCK_Q - 1).sum())
        plan.append([(u, (u + 1) * BLOCK_K <= n_first)
                     for u in range(-(-n_last // BLOCK_K))])
    return order, keys, plan


def slash_unit_plan(tile_idx: torch.Tensor, tile_valid: torch.Tensor,
                    vert: torch.Tensor, n: int, pad: int, q_block: int,
                    k_tile: int):
    """The grid slash kernel's walk for one (b, h): tile_idx, tile_valid
    [N/q_block, T], vert [N].

    q tile t holds rows 128 t on: warpgroup w its 64 rows from 128 t + 64 w
    (none past N).  A warpgroup with a row past the pad walks the list of
    its q-block: both in one walk where their rows lie in one q-block.  A
    walk visits the valid entries in list order and, in each, the 64-key
    units that are not above its last row nor wholly left of the pad,
    paired into 128-key tiles as they come (a last unit alone, the other
    missing).  A warpgroup masks a tile where a unit is missing, starts
    left of the pad, reaches past the warpgroup's first row or holds a
    vertical column.  Returns one [(warpgroups as bits, (first key of each
    unit, -1: missing), (masked for warpgroup 0, for warpgroup 1))] per q
    tile."""
    idx, valid = tile_idx.tolist(), tile_valid.tolist()
    vert_units = vert.reshape(-1)[:n].tolist()
    plan = []
    for q0 in range(0, n, BLOCK_Q):
        wgs_rows = 3 if q0 + UNIT < n else 1
        last = (min(q0 + UNIT - 1, n - 1), min(q0 + BLOCK_Q - 1, n - 1))
        live = (last[0] >= pad, wgs_rows == 3 and last[1] >= pad)
        qb = (q0 // q_block, (q0 + UNIT) // q_block)
        if live[0] and live[1] and qb[0] == qb[1]:
            walks = [(qb[0], 3, last[1])]
        else:
            walks = [(qb[w], 1 << w, last[w]) for w in (0, 1) if live[w]]
        tiles = []
        for q_b, wgs, last_row in walks:
            units = [k0 for t, ok in zip(idx[q_b], valid[q_b]) if ok
                     for k0 in range(t * k_tile, (t + 1) * k_tile, UNIT)
                     if k0 <= last_row and k0 + UNIT - 1 >= pad]
            for j in range(0, len(units), 2):
                pair = (units[j], units[j + 1] if j + 1 < len(units) else -1)
                masked = tuple(
                    bool(wgs >> w & 1) and any(
                        k0 < 0 or k0 < pad or k0 + UNIT - 1 > q0 + UNIT * w
                        or any(vert_units[k0:k0 + UNIT]) for k0 in pair)
                    for w in (0, 1))
                tiles.append((wgs, pair, masked))
        plan.append(tiles)
    return plan


def _online_update(acc, m, l, s, v) -> None:
    """One tile of the kernels' online softmax on the views acc [R, D],
    m, l [R] (in place): natural-unit maxes, P rounded to v's dtype at the
    running max."""
    m_new = torch.maximum(m, s.amax(-1))
    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
    alpha = torch.exp(m - m_use)
    p = torch.exp(s - m_use[..., None])
    l.mul_(alpha).add_(p.sum(-1))
    acc.mul_(alpha[..., None]).add_(p.to(v.dtype).float() @ v.float())
    m.copy_(m_new)


def _partials_out(acc, m, l):
    return acc, torch.where(m == -math.inf, torch.finfo(torch.float32).min,
                            m), l


def vertical_tiled_plain(q, k_vert, v_vert, vcol, vvalid, true_len, *,
                         scale: Optional[float] = None):
    """The vertical kernel's schedule in plain PyTorch: each (b, h)'s
    columns in key order, each q tile's :func:`vertical_tile_plan` tiles
    in order, the key mask only on tiles that are not interior, P rounded
    to v's dtype at each tile's running max (with f32 inputs nothing is
    rounded).  Arguments and result as
    :func:`vertical_attention_partials`."""
    del true_len
    b, h, n, d = q.shape
    vs = k_vert.shape[2]
    qs = _scaled_q(q, scale).float()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, n, d), **f32)
    m = torch.full((b, h, n), -math.inf, **f32)
    l = torch.zeros((b, h, n), **f32)
    for bi in range(b):
        for hi in range(h):
            order, keys, plan = vertical_tile_plan(vcol[bi, hi],
                                                   vvalid[bi, hi], n)
            kf, vv = k_vert[bi, hi, order].float(), v_vert[bi, hi, order]
            for t, tiles in enumerate(plan):
                r0, r1 = t * BLOCK_Q, min(t * BLOCK_Q + BLOCK_Q, n)
                rows = torch.arange(r0, r1, device=q.device)[:, None]
                for u, interior in tiles:
                    c0, c1 = u * BLOCK_K, min(u * BLOCK_K + BLOCK_K, vs)
                    s = qs[bi, hi, r0:r1] @ kf[c0:c1].T
                    if not interior:
                        s = s.masked_fill(keys[c0:c1][None, :] > rows,
                                          -math.inf)
                    _online_update(acc[bi, hi, r0:r1], m[bi, hi, r0:r1],
                                   l[bi, hi, r0:r1], s, vv[c0:c1])
    return _partials_out(acc, m, l)


def slash_tiled_plain(q, k, v, tile_idx, tile_valid, vert, true_len, *,
                      q_block: int = 128, k_tile: int = 128,
                      scale: Optional[float] = None):
    """The grid slash kernel's schedule in plain PyTorch: each warpgroup's
    64 rows walk the tiles of :func:`slash_unit_plan` that are theirs, the
    mask (causal, pad, vertical columns, a missing unit) only on tiles
    masked for them, P rounded to v's dtype at each tile's running max.
    Arguments and result as :func:`slash_tile_attention`."""
    b, h, n, d = q.shape
    g = h // k.shape[1]
    qs = _scaled_q(q, scale).float()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, n, d), **f32)
    m = torch.full((b, h, n), -math.inf, **f32)
    l = torch.zeros((b, h, n), **f32)
    for bi in range(b):
        pad = n - int(true_len[bi])
        for hi in range(h):
            kf, vv = k[bi, hi // g].float(), v[bi, hi // g]
            vert_h = vert[bi, hi]
            plan = slash_unit_plan(tile_idx[bi, hi], tile_valid[bi, hi],
                                   vert_h, n, pad, q_block, k_tile)
            for t, tiles in enumerate(plan):
                for w in (0, 1):
                    r0 = t * BLOCK_Q + w * UNIT
                    r1 = min(r0 + UNIT, n)
                    rows = torch.arange(r0, r1, device=q.device)[:, None]
                    for wgs, pair, masked in tiles:
                        if not wgs >> w & 1:
                            continue
                        cols = torch.cat([
                            torch.arange(k0, k0 + UNIT, device=q.device)
                            if k0 >= 0 else torch.full(
                                (UNIT,), -1, device=q.device)
                            for k0 in pair])
                        have = cols >= 0
                        cc = cols.clamp_min(0)
                        s = qs[bi, hi, r0:r1] @ kf[cc].T
                        if masked[w]:
                            vis = (have & (cols >= pad) & ~vert_h[cc])[None]
                            s = s.masked_fill(~(vis & (cols[None] <= rows)),
                                              -math.inf)
                        # a missing unit is read as zeros
                        vt = torch.where(have[:, None], vv[cc],
                                         torch.zeros_like(vv[cc]))
                        _online_update(acc[bi, hi, r0:r1], m[bi, hi, r0:r1],
                                       l[bi, hi, r0:r1], s, vt)
    return _partials_out(acc, m, l)


#: kernel launches since the last reset (CPU calls do not count)
slash_tile_attention.launches = 0
slash_tile_attention_db.launches = 0
vertical_attention_partials.launches = 0
