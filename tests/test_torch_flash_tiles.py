"""The tile plan and schedule of the port's one-pass and partials flash
kernel (``csrc/flash_prefill.cu``, ``flash_wgmma_kernel``), on the CPU.

- ``flash_tile_plan`` against the plain mask: every visible (row, key)
  pair lies in exactly one visited tile, no visible pair lies in a tile
  that is not visited, an interior tile holds no masked pair and every
  other visited tile holds one (masked: before the pad, after the causal
  edge, at or past N, outside the window).
- ``flash_tiled_plain`` (the kernel's schedule: the plan's tiles, the mask
  only on edge tiles, the base-2 online softmax tile by tile) in both modes
  against the plain versions (``causal_prefill_attention``,
  ``flash_partials_plain``) and against JAX's ``flash_causal_attention`` /
  ``flash_attention_partials`` in interpret mode, on the same numpy inputs.
  In f32 (nothing is rounded) within 2e-5, the bound
  ``tests/test_torch_chunked.py`` holds these functions to: the same f32
  terms summed in other orders.  In bf16 the oracle rounds P at each
  tile's running max, the plain versions at the row's final max: a P term
  can differ by a few bf16 ulps, so the outputs are held within two bf16
  ulps of themselves plus 2^-5 of their row's rms (the limit
  ``chip_smoke.py`` holds the kernel to); against JAX's kernel with the
  same 128-key tiles (P rounded at the same running maxima) within 2^-7 of
  themselves plus 2^-7 of their row's rms: a P term whose f32 value differs
  in its last bits (other summation orders) can still round to the other
  bf16 neighbour and move an output by 2^-8 p v / l.
- The pass-B mode of ``flash_tiled_plain`` (``m_known``: P = exp2(S - m)
  against pass A's row maxes, no running max, edge tiles masked to
  float32.min) against ``flash_pass_b_plain`` and JAX's
  ``flash_causal_attention(two_pass=True)`` in interpret mode, with
  padding, ``q_start`` and a sliding window: in f32 within 2e-5 (the same
  terms, other orders); in bf16 against the plain version within 2^-7
  |want| + 2^-7 rms (both round P at the same known max, so only a P term
  whose f32 value differs in its last bits can round to the other bf16
  neighbour, and the output's own bf16 ulp).  Rows with no visible key
  write exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu.kernels import flash_attention_partials as jax_partials
from pyramidkv_tpu.kernels import flash_causal_attention as jax_flash
from pyramidkv_tpu_torch.kernels.flash_prefill import (BLOCK_K, BLOCK_Q,
                                                      flash_tile_plan,
                                                      flash_tiled_plain)
from pyramidkv_tpu_torch.ops.attention import (causal_prefill_attention,
                                               flash_partials_plain,
                                               flash_pass_b_plain,
                                               flash_row_max_plain)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KTOL = 2e-5
D = 128

#: (n, nq, q_start, pad, window): the monolithic prefill, a pad inside a
#: tile, N % 128 = 64, a window, prefill chunks (q_start + nq = n, a last q
#: tile of 64 rows), history tiles (q_start >= n), no real key at all
PLAN_CASES = [
    (512, 512, 0, 0, None),
    (512, 512, 0, 77, None),
    (192, 192, 0, 70, None),
    (192, 192, 0, 150, None),
    (512, 512, 0, 200, 50),
    (448, 448, 0, 10, 128),
    (448, 192, 256, 100, None),
    (384, 64, 320, 300, None),
    (512, 256, 256, 0, 200),
    (192, 192, 192, 70, None),
    (256, 256, 512, 0, None),
    (256, 256, 0, 256, None),
]


def _visible(n, nq, q_start, pad, window, ncols):
    """[nq, ncols] bool: key c visible from query row r (global q_start + r):
    c >= pad, c <= the row, c < n, inside the window."""
    rows = q_start + np.arange(nq)[:, None]
    cols = np.arange(ncols)[None, :]
    vis = (cols >= pad) & (cols <= rows) & (cols < n)
    if window:
        vis &= rows - cols < window
    return vis


@pytest.mark.parametrize("n,nq,q_start,pad,window", PLAN_CASES)
def test_tile_plan_covers_visible_pairs_once(n, nq, q_start, pad, window):
    nk = -(-n // BLOCK_K)
    vis = _visible(n, nq, q_start, pad, window, nk * BLOCK_K)
    plan = flash_tile_plan(n, nq, q_start, pad, window)
    assert len(plan) == -(-nq // BLOCK_Q)
    hits = np.zeros_like(vis, dtype=np.int64)
    for t, (tiles, interior) in enumerate(plan):
        r0, r1 = t * BLOCK_Q, min(t * BLOCK_Q + BLOCK_Q, nq)
        assert len(interior) == len(tiles)
        assert list(tiles) == sorted(set(tiles))
        for kt, inner in zip(tiles, interior):
            c0 = kt * BLOCK_K
            block = vis[r0:r1, c0:c0 + BLOCK_K]
            hits[r0:r1, c0:c0 + BLOCK_K] += 1
            # interior: nothing to mask; edge: something to mask
            assert bool(block.all()) == inner, (t, kt, inner)
            assert block.any(), (t, kt)  # no tile is visited for nothing
    assert (hits[vis] == 1).all()  # every visible pair exactly once
    assert (hits <= 1).all()


@pytest.mark.parametrize("n,nq,q_start,pad,window", [
    (192, 192, 0, 70, None), (192, 192, 192, 70, None)])
def test_tile_plan_of_one_block_row(n, nq, q_start, pad, window):
    """The plan's numbers for two small cases, written out: N = 192 with a
    pad of 70 (both key tiles edge tiles: the pad, the diagonal, the tile
    cut short by N); the same as a history tile (no causal edge: tile 0
    holds the pad, tile 1 is cut short by N)."""
    plan = [(list(t), i) for t, i in flash_tile_plan(n, nq, q_start, pad,
                                                     window)]
    if q_start == 0:
        assert plan == [([0], [False]), ([0, 1], [False, False])]
    else:
        assert plan == [([0, 1], [False, False]), ([0, 1], [False, False])]


def _inputs(b, h, hk, n, nq, seed, bf16=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, nq, D)).astype(np.float32)
    k = rng.normal(size=(b, hk, n, D)).astype(np.float32)
    v = rng.normal(size=(b, hk, n, D)).astype(np.float32)
    if bf16:  # round once, then hand both sides the same values
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                   for x in (q, k, v))
    return q, k, v


def _torch(x, bf16):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if bf16 else t


def _jax(x, bf16):
    return jnp.asarray(x, dtype=jnp.bfloat16 if bf16 else jnp.float32)


def _err_over_tol(got, want, rtol, row_tol):
    g, w = (torch.tensor(np.asarray(x, np.float32)) for x in (got, want))
    rms = w.square().mean(-1, keepdim=True).sqrt()
    lim = (rtol * w.abs() + row_tol * rms).clamp_min(1e-30)
    return float(((g - w).abs() / lim).max())


#: one-pass cases: (b, h, hk, n, nq, q_start, true_len, window)
FLASH_CASES = [
    (2, 4, 4, 384, 384, 0, (384, 150), None),   # G = 1, pad inside a tile
    (2, 8, 2, 448, 192, 256, (448, 300), None),  # G = 4, a chunk, N % 128
    (1, 4, 1, 512, 512, 0, (435,), 100),         # G = 4, a window
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_tiled_flash_matches_plain_and_pallas_f32(case):
    b, h, hk, n, nq, q_start, tl, window = case
    q, k, v = _inputs(b, h, hk, n, nq, seed=n + nq)
    tlt = torch.tensor(tl)
    got = flash_tiled_plain(*(_torch(x, False) for x in (q, k, v)), tlt,
                            sliding_window=window, q_start=q_start).numpy()
    plain = causal_prefill_attention(
        *(_torch(x, False) for x in (q, k, v)), true_len=tlt,
        sliding_window=window, q_start=q_start).numpy()
    pallas = np.asarray(jax_flash(
        *(_jax(x, False) for x in (q, k, v)), jnp.asarray(tl, jnp.int32),
        sliding_window=window, q_start=q_start, interpret=True))
    for bi, t in enumerate(tl):
        rows = slice(max(0, n - t - q_start), None)  # past the pad
        np.testing.assert_allclose(got[bi, :, rows], plain[bi, :, rows],
                                   rtol=KTOL, atol=KTOL)
        np.testing.assert_allclose(got[bi, :, rows], pallas[bi, :, rows],
                                   rtol=KTOL, atol=KTOL)
        assert (got[bi, :, :rows.start] == 0).all()  # no visible key: 0


#: partials cases: (b, h, hk, n, q_start, true_len): the causal self tile
#: and a history tile, N % 128 = 64, a pad inside the second key tile, a
#: row with no real key
PARTIAL_CASES = [
    (2, 4, 4, 192, 0, (192, 50)),
    (2, 8, 2, 192, 192, (192, 50)),
    (2, 4, 1, 256, 256, (256, 0)),
]


def _check_partials(got, want, tol):
    acc, m, l = (np.asarray(x) for x in got)
    wacc, wm, wl = (np.asarray(x) for x in want)
    live = wl > 0
    np.testing.assert_array_equal(live, l > 0)
    neg = np.finfo(np.float32).min
    assert (m[~live] == neg).all() and (acc[~live] == 0).all()
    for x, y in ((acc, wacc), (m, wm), (l, wl)):
        np.testing.assert_allclose(x[live], y[live], rtol=tol, atol=tol)


@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_tiled_partials_match_plain_and_pallas_f32(case):
    b, h, hk, n, q_start, tl = case
    q, k, v = _inputs(b, h, hk, n, n, seed=n + q_start)
    tlt = torch.tensor(tl)
    got = flash_tiled_plain(*(_torch(x, False) for x in (q, k, v)), tlt,
                            q_start=q_start, partials=True)
    plain = flash_partials_plain(*(_torch(x, False) for x in (q, k, v)), tlt,
                                 q_start=q_start)
    pallas = jax_partials(*(_jax(x, False) for x in (q, k, v)),
                          jnp.asarray(tl, jnp.int32), q_start=q_start,
                          interpret=True)
    _check_partials(got, plain, KTOL)
    # JAX's kernel writes its float32.min convention on dead rows too
    _check_partials(got, pallas, KTOL)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_tiled_flash_bf16_rounds_p_at_running_max(case):
    """bf16 inputs: the oracle against the plain version (P rounded at the
    row's final max; 2^-6 |want| + 2^-5 rms) and, where N is a multiple of
    128, against JAX's kernel with the same 128-key tiles (a row's P is
    rounded at the same running maxima whatever the q tiling; 2^-7 |want|
    + 2^-7 rms: a bf16 ulp of the output, which JAX rounds after a
    division and the oracle after a multiplication by 1 / l, and a P term
    rounded to the other bf16 neighbour)."""
    b, h, hk, n, nq, q_start, tl, window = case
    q, k, v = _inputs(b, h, hk, n, nq, seed=7, bf16=True)
    tlt = torch.tensor(tl)
    got = flash_tiled_plain(*(_torch(x, True) for x in (q, k, v)), tlt,
                            sliding_window=window, q_start=q_start)
    plain = causal_prefill_attention(
        *(_torch(x, True) for x in (q, k, v)), true_len=tlt,
        sliding_window=window, q_start=q_start)
    got, plain = got.float().numpy(), plain.float().numpy()
    pallas = None
    if n % BLOCK_K == 0:
        pallas = np.asarray(jax_flash(
            *(_jax(x, True) for x in (q, k, v)), jnp.asarray(tl, jnp.int32),
            sliding_window=window, q_start=q_start, block_q=64,
            block_k=BLOCK_K, interpret=True).astype(jnp.float32))
    for bi, t in enumerate(tl):
        rows = slice(max(0, n - t - q_start), None)
        assert _err_over_tol(got[bi, :, rows], plain[bi, :, rows],
                             2.0 ** -6, 2.0 ** -5) <= 1
        if pallas is not None:
            assert _err_over_tol(got[bi, :, rows], pallas[bi, :, rows],
                                 2.0 ** -7, 2.0 ** -7) <= 1


def test_tiled_partials_bf16_match_pallas():
    """bf16 partials (a history tile, G = 4) against JAX's kernel with the
    same tiles: acc / l within 2^-7 |want| + 2^-7 rms, m within 2^-12,
    l within 2^-10 relative (f32 sums in other orders on bf16 terms)."""
    b, h, hk, n, q_start, tl = 2, 8, 2, 256, 256, (256, 100)
    q, k, v = _inputs(b, h, hk, n, n, seed=11, bf16=True)
    acc, m, l = flash_tiled_plain(*(_torch(x, True) for x in (q, k, v)),
                                  torch.tensor(tl), q_start=q_start,
                                  partials=True)
    wacc, wm, wl = (np.asarray(x) for x in jax_partials(
        *(_jax(x, True) for x in (q, k, v)), jnp.asarray(tl, jnp.int32),
        q_start=q_start, block_q=64, block_k=BLOCK_K, interpret=True))
    acc, m, l = acc.numpy(), m.numpy(), l.numpy()
    live = wl > 0
    assert (live == (l > 0)).all()
    assert _err_over_tol((acc / np.maximum(l, 1e-30)[..., None])[live],
                         (wacc / np.maximum(wl, 1e-30)[..., None])[live],
                         2.0 ** -7, 2.0 ** -7) <= 1
    np.testing.assert_allclose(m[live], wm[live], rtol=2.0 ** -12,
                               atol=2.0 ** -12)
    np.testing.assert_allclose(l[live], wl[live], rtol=2.0 ** -10)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_tiled_pass_b_matches_plain_and_pallas_f32(case):
    b, h, hk, n, nq, q_start, tl, window = case
    q, k, v = _inputs(b, h, hk, n, nq, seed=3 * n + nq)
    tlt = torch.tensor(tl)
    qt, kt, vt = (_torch(x, False) for x in (q, k, v))
    kw = dict(sliding_window=window, q_start=q_start)
    m = flash_row_max_plain(qt, kt, tlt, **kw)
    got = flash_tiled_plain(qt, kt, vt, tlt, m_known=m, **kw).numpy()
    plain = flash_pass_b_plain(qt, kt, vt, m, tlt, **kw).numpy()
    pallas = np.asarray(jax_flash(
        *(_jax(x, False) for x in (q, k, v)), jnp.asarray(tl, jnp.int32),
        two_pass=True, interpret=True, **kw))
    for bi, t in enumerate(tl):
        rows = slice(max(0, n - t - q_start), None)  # past the pad
        np.testing.assert_allclose(got[bi, :, rows], plain[bi, :, rows],
                                   rtol=KTOL, atol=KTOL)
        np.testing.assert_allclose(got[bi, :, rows], pallas[bi, :, rows],
                                   rtol=KTOL, atol=KTOL)
        assert (got[bi, :, :rows.start] == 0).all()  # no visible key: 0


@pytest.mark.parametrize("case", FLASH_CASES)
def test_tiled_pass_b_bf16_matches_plain(case):
    b, h, hk, n, nq, q_start, tl, window = case
    q, k, v = _inputs(b, h, hk, n, nq, seed=5, bf16=True)
    tlt = torch.tensor(tl)
    qt, kt, vt = (_torch(x, True) for x in (q, k, v))
    kw = dict(sliding_window=window, q_start=q_start)
    m = flash_row_max_plain(qt, kt, tlt, **kw)
    got = flash_tiled_plain(qt, kt, vt, tlt, m_known=m, **kw).float().numpy()
    plain = flash_pass_b_plain(qt, kt, vt, m, tlt, **kw).float().numpy()
    for bi, t in enumerate(tl):
        rows = slice(max(0, n - t - q_start), None)
        assert _err_over_tol(got[bi, :, rows], plain[bi, :, rows],
                             2.0 ** -7, 2.0 ** -7) <= 1
        assert (got[bi, :, :rows.start] == 0).all()


def test_tiled_pass_b_clamps_the_known_max():
    """A row with no visible key carries m = float32.min from pass A; the
    pass-B schedule clamps it to float32.min / 2, so its masked logits
    (float32.min) give p = 0 and the row writes 0.  Unclamped, they would
    give p = 1 and the mean of the visited values."""
    b, h, hk, n = 1, 2, 2, 192
    q, k, v = _inputs(b, h, hk, n, n, seed=19)
    tlt = torch.tensor([60])
    qt, kt, vt = (_torch(x, False) for x in (q, k, v))
    m = flash_row_max_plain(qt, kt, tlt)
    neg = torch.finfo(torch.float32).min
    assert (m[0, :, :n - 60] == neg).all()
    out = flash_tiled_plain(qt, kt, vt, tlt, m_known=m)
    assert (out[0, :, :n - 60] == 0).all()
    assert torch.isfinite(out).all() and (out[0, :, n - 60:] != 0).any()
