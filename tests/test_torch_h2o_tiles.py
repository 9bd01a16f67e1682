"""The tile plan and schedule of the port's two H2O kernels
(``csrc/h2o_scores.cu``: row statistics, column sums), on the CPU.

- ``h2o_tile_plan`` against the plain mask (a pair (r, c) is visible when
  r >= pad, c >= pad and not c > r >= N - W): every visible pair lies in
  exactly one visited tile, no visible pair lies in a tile that is not
  visited, an interior tile holds no masked pair and every edge tile holds
  one.  Stats: a q tile's rows below N against every column, columns past
  N masked; colsum: the written columns past the pad (those below it are
  written -inf, those from N - W on are not written) against every row,
  rows past N masked.
- ``h2o_tiled_plain`` (both kernels' schedule: 128-wide tiles, masks on
  edge tiles only, the online statistics tile by tile, colsum's exponent
  offset m + log2 l and its per-lane partial sums) against the plain
  versions (``ops.scoring.h2o_row_stats``, ``h2o_colsum``, ``h2o_scores``)
  and JAX's ``h2o_scores_pallas(..., interpret=True)`` on the same numpy
  inputs: padding inside a tile and on a tile boundary, a q tile made
  wholly of padding, GQA 4:1, W = 8 and a W x W block across two tiles, N
  - W no multiple of 128.  In f32 within 2e-5 (relative and absolute): the
  same f32 terms in other orders, and exp2(s - (m + log2 l)) for exp2(s -
  m) / l, which moves a term by about ulp(m + log2 l) ~ 1e-6 relative.
  With bf16 inputs (the query rounded after scaling, as the kernels and
  the plain versions both do) within the limits ``chip_smoke.py`` holds
  the kernels to: m within 2^-12 max(1, |m|) and l within 2^-10 l on the
  rows past the pad (``STATS_TOL_TEXT``); the scores against the plain
  colsum fed the same (m, l) within 2^-14 |want| + 2^-14 rms of the row
  (``COLSUM_TOL``), the same logits exponentiated and summed in other
  orders; padding rows exactly (float32.min, 0), padding columns -inf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu.kernels.h2o_scores import h2o_scores_pallas
from pyramidkv_tpu_torch.kernels.h2o_scores import (BLOCK, h2o_tile_plan,
                                                    h2o_tiled_plain)
from pyramidkv_tpu_torch.ops import scoring
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KTOL = 2e-5
D = 128
NEG = np.finfo(np.float32).min

#: (n, true_len, w): no padding, a pad inside a tile, a pad on a tile
#: boundary, a q tile wholly padding, N % 128 = 64 (N - W = 440), a W x W
#: block across two tiles, no real token, W = 0, a window wider than the
#: prompt
PLAN_CASES = [
    (512, 512, 8),
    (512, 435, 8),
    (512, 256, 8),
    (640, 400, 8),
    (448, 300, 8),
    (512, 500, 200),
    (384, 0, 8),
    (384, 384, 0),
    (640, 128, 130),
]


def _visible(n, pad, w, nrows, ncols):
    r = np.arange(nrows)[:, None]
    c = np.arange(ncols)[None, :]
    return ((r >= pad) & (c >= pad) & ~((r >= n - w) & (c > r))
            & (r < n) & (c < n))


@pytest.mark.parametrize("n,true_len,w", PLAN_CASES)
def test_tile_plan_covers_visible_pairs_once(n, true_len, w):
    pad, bt = n - true_len, BLOCK
    nt = -(-n // bt)
    plan = h2o_tile_plan(n, true_len, w)
    vis = _visible(n, pad, w, nt * bt, nt * bt)

    # stats: q tile t's real rows (< n) against every column
    assert len(plan["stats"]) == nt
    hits = np.zeros_like(vis, dtype=np.int64)
    for t, (tiles, edges) in enumerate(plan["stats"]):
        r0, r1 = t * bt, min(t * bt + bt, n)
        assert len(edges) == len(tiles)
        assert list(tiles) == sorted(set(tiles))
        for kt, edge in zip(tiles, edges):
            block = vis[r0:r1, kt * bt:kt * bt + bt]
            hits[r0:r1, kt * bt:kt * bt + bt] += 1
            assert bool(block.all()) != edge, ("stats", t, kt, edge)
    assert (hits[:n][vis[:n]] == 1).all() and (hits <= 1).all()

    # colsum: the written columns past the pad against every row
    nout = n - w
    assert len(plan["colsum"]) == -(-nout // bt)
    hits[:] = 0
    for c, (tiles, edges) in enumerate(plan["colsum"]):
        c0, c1 = max(c * bt, pad), min(c * bt + bt, nout)
        assert len(edges) == len(tiles)
        if c1 <= c0:  # padding columns only
            assert not tiles
            continue
        for qt, edge in zip(tiles, edges):
            block = vis[qt * bt:qt * bt + bt, c0:c1]
            hits[qt * bt:qt * bt + bt, c0:c1] += 1
            assert bool(block.all()) != edge, ("colsum", c, qt, edge)
    assert (hits[:, :nout][vis[:, :nout]] == 1).all() and (hits <= 1).all()


def test_tile_plan_of_one_row():
    """The plan written out for N = 448, 300 tokens (pad 148), W = 8: q tile
    0 is padding; q tile 1 straddles the pad, so all its key tiles are
    edge tiles; q tiles 2 and 3 mask key tile 1 (the pad edge) and key tile
    3 (cut short by N: 64 keys; for q tile 3 also the W x W block); colsum's
    block 0 holds padding columns only, the others mask query tile 1 (the
    pad edge) and 3 (cut short by N)."""
    plan = h2o_tile_plan(448, 300, 8)
    stats = [(list(t), e) for t, e in plan["stats"]]
    assert stats == [([], []), ([1, 2, 3], [True, True, True]),
                     ([1, 2, 3], [True, False, True]),
                     ([1, 2, 3], [True, False, True])]
    colsum = [(list(t), e) for t, e in plan["colsum"]]
    assert colsum == [([], [])] + [([1, 2, 3], [True, False, True])] * 3


def _inputs(b, h, hk, n, seed, bf16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, n, D)).astype(np.float32)
    k = rng.normal(size=(b, hk, n, D)).astype(np.float32)
    if bf16:  # round once, then hand both sides the same values
        q, k = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                for x in (q, k))
    return q, k


def _torch(x, bf16):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if bf16 else t


#: (b, h, hk, n, true_len, w): G = 1 with a pad inside a tile; GQA 4:1
#: with a pad on a tile boundary (256) and one inside (77); a q tile made
#: wholly of padding (pad 240, G = 4); N % 128 = 64 (N - W = 440); a W x W
#: block across two tiles (W = 200, rows 312-511)
CASES = [
    (2, 4, 4, 384, (384, 150), 8),
    (2, 8, 2, 512, (256, 435), 8),
    (1, 4, 1, 640, (400,), 8),
    (1, 4, 2, 448, (448,), 8),
    (1, 4, 1, 512, (500,), 200),
]


def _live_rows(n, tl):
    """[B, 1, N] bool: rows past the pad."""
    return (np.arange(n)[None, :] >= n - np.asarray(tl)[:, None])[:, None]


def _check_padding(m, l, tl, n):
    dead = np.broadcast_to(~_live_rows(n, tl), m.shape)
    assert (m[dead] == NEG).all() and (l[dead] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_tiled_h2o_matches_plain_and_pallas_f32(case):
    b, h, hk, n, tl, w = case
    q, k = _inputs(b, h, hk, n, seed=n + w, bf16=False)
    qt, kt, tlt = _torch(q, False), _torch(k, False), torch.tensor(tl)
    m, l, got = (x.numpy() for x in h2o_tiled_plain(
        qt, kt, window_size=w, true_len=tlt))
    pm, pl = (x.numpy() for x in scoring.h2o_row_stats(
        qt, kt, window_size=w, true_len=tlt))
    live = np.broadcast_to(_live_rows(n, tl), m.shape)
    np.testing.assert_allclose(m[live], pm[live], rtol=KTOL, atol=KTOL)
    np.testing.assert_allclose(l[live], pl[live], rtol=KTOL, atol=KTOL)
    _check_padding(m, l, tl, n)
    want = scoring.h2o_scores(qt, kt, window_size=w, true_len=tlt).numpy()
    fed = scoring.h2o_colsum(qt, kt, torch.from_numpy(m), torch.from_numpy(l),
                             window_size=w, true_len=tlt).numpy()
    blk = BLOCK if n % BLOCK == 0 else 64
    pallas = np.asarray(h2o_scores_pallas(
        jnp.asarray(q), jnp.asarray(k), window_size=w,
        true_len=jnp.asarray(tl, jnp.int32), block_q=blk, block_k=blk,
        interpret=True))
    fin = np.isfinite(want)
    for other in (fed, pallas):
        assert np.array_equal(np.isfinite(other), fin)
        assert np.array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], other[fin], rtol=KTOL,
                                   atol=KTOL)
        np.testing.assert_allclose(want[fin], other[fin], rtol=KTOL,
                                   atol=KTOL)


@pytest.mark.parametrize("case", CASES)
def test_tiled_h2o_bf16_within_the_kernel_limits(case):
    b, h, hk, n, tl, w = case
    q, k = _inputs(b, h, hk, n, seed=7 + n, bf16=True)
    qt, kt, tlt = _torch(q, True), _torch(k, True), torch.tensor(tl)
    m, l, got = h2o_tiled_plain(qt, kt, window_size=w, true_len=tlt)
    pm, pl = scoring.h2o_row_stats(qt, kt, window_size=w, true_len=tlt)
    live = torch.from_numpy(np.broadcast_to(_live_rows(n, tl), m.shape)
                            .copy())
    assert ((m - pm).abs() <= 2.0 ** -12 * pm.abs().clamp_min(1.0))[live].all()
    assert ((l - pl).abs() <= 2.0 ** -10 * pl)[live].all()
    _check_padding(m.numpy(), l.numpy(), tl, n)
    fed = scoring.h2o_colsum(qt, kt, m, l, window_size=w, true_len=tlt)
    fin = torch.isfinite(fed)
    assert torch.equal(torch.isfinite(got), fin)
    g0, f0 = got.masked_fill(~fin, 0.0), fed.masked_fill(~fin, 0.0)
    rms = (f0.square().sum(-1, keepdim=True)
           / fin.sum(-1, keepdim=True).clamp_min(1)).sqrt()
    assert ((g0 - f0).abs() <= 2.0 ** -14 * (f0.abs() + rms)).all()
