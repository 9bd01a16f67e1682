"""The walks and schedules of the port's vertical and grid slash kernels
(``csrc/block_sparse_prefill.cu``, ``sp::sparse_wgmma_kernel``), on the CPU.

- ``vertical_tile_plan`` against the plain mask: the columns sorted by key
  (their id where valid, int max otherwise), every visible (row, column)
  pair lies in exactly one visited 128-column tile of its q tile, no tile
  is visited for nothing, an interior tile holds no masked pair; the
  wrapper's ``sort_vertical_columns`` (order, padded keys, per-tile
  counts) agrees with the plan.
- ``slash_unit_plan`` against the plain mask (a listed valid tile of the
  row's q-block, causal, right of the pad, not vertical): every visible
  pair is visited exactly once, by the warpgroup that holds its row; a
  tile a warpgroup does not mask holds no masked pair and every masked one
  holds one.  ``pack_vertical_bits`` holds the flags bit for bit.
- ``vertical_tiled_plain`` and ``slash_tiled_plain`` (the kernels'
  schedules: the plan's tiles, masks only where the plan masks, P rounded
  at each 128-key tile's running max) against the plain versions and
  JAX's Pallas kernels in interpret mode, on the same numpy inputs: with
  the vertical columns in shuffled order and invalid ones among them, at
  ``q_block`` 64 and ``k_tile`` 64 with N % 128 = 64, with a pad inside a
  unit and q tiles that are all padding, at G = 1, 4 and 8.  In f32
  (nothing is rounded) within 2e-5, as ``tests/test_torch_flash_tiles.py``:
  the same f32 terms summed in other orders.  In bf16 the schedules round
  P at each tile's running max, the plain versions and JAX's kernels at
  other maxima (the row's final one, or each k_tile's): acc / l within
  2^-6 |want| + 2^-5 of its row's rms (the limit ``chip_smoke.py`` holds
  the kernels to), m within 2^-12 max(1, |m|), l within 2^-10 l (f32 dots
  and sums in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu.kernels import block_sparse_prefill as jk
from pyramidkv_tpu_torch.kernels.block_sparse_prefill import (
    BLOCK_K, BLOCK_Q, NO_KEY, UNIT, pack_vertical_bits, slash_tiled_plain,
    slash_unit_plan, sort_vertical_columns, vertical_tile_plan,
    vertical_tiled_plain)
from pyramidkv_tpu_torch.ops import sparse_prefill as sp
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KTOL = 2e-5
D = 32
NEG = np.finfo(np.float32).min


def _vertical_columns(rng, n, vs, pad, n_valid):
    """vcol, vvalid [vs]: n_valid distinct valid ids right of the pad, the
    rest invalid (ids anywhere), all in a random order."""
    vcol = np.empty(vs, np.int32)
    vcol[:n_valid] = rng.choice(np.arange(pad, n), size=n_valid,
                                replace=False)
    vcol[n_valid:] = rng.integers(0, n, size=vs - n_valid)
    valid = np.arange(vs) < n_valid
    perm = rng.permutation(vs)
    return torch.from_numpy(vcol[perm]), torch.from_numpy(valid[perm])


#: (n, Vs, pad, valid columns): N % 128 = 64, Vs % 128 = 64, a pad, no
#: valid column at all, every column valid
VPLAN_CASES = [(448, 192, 0, 150), (512, 256, 77, 100), (320, 64, 200, 0),
               (384, 384, 0, 384), (192, 128, 30, 70)]


@pytest.mark.parametrize("n,vs,pad,n_valid", VPLAN_CASES)
def test_vertical_plan_covers_visible_pairs_once(n, vs, pad, n_valid):
    rng = np.random.default_rng(n + vs)
    vcol, vvalid = _vertical_columns(rng, n, vs, pad, n_valid)
    order, keys, plan = vertical_tile_plan(vcol, vvalid, n)
    want_keys = torch.where(vvalid, vcol, NO_KEY)[order]
    assert torch.equal(keys, want_keys)
    assert bool((keys[1:] >= keys[:-1]).all())
    assert sorted(order.tolist()) == list(range(vs))
    rows = np.arange(n)[:, None]
    vis = keys.numpy()[None, :] <= rows  # [n, vs] in sorted order
    assert len(plan) == -(-n // BLOCK_Q)
    hits = np.zeros_like(vis, dtype=np.int64)
    for t, tiles in enumerate(plan):
        r0, r1 = t * BLOCK_Q, min(t * BLOCK_Q + BLOCK_Q, n)
        assert [u for u, _ in tiles] == list(range(len(tiles)))
        for u, interior in tiles:
            c0 = u * BLOCK_K
            block = vis[r0:r1, c0:c0 + BLOCK_K]
            hits[r0:r1, c0:c0 + BLOCK_K] += 1
            assert c0 < vs
            assert block.any(), (t, u)  # no tile is visited for nothing
            if interior:  # every key <= the q tile's first row
                assert block.all() and block.shape[1] == BLOCK_K, (t, u)
    assert (hits[vis] == 1).all()  # every visible pair exactly once
    # the wrapper's inputs: the same order, keys padded to 128, the counts
    # the plan's walk reads
    got_order, kp, counts = sort_vertical_columns(
        vcol[None, None], vvalid[None, None], n)
    assert torch.equal(got_order[0, 0], order)
    assert kp.shape[-1] == -(-vs // BLOCK_K) * BLOCK_K
    assert torch.equal(kp[0, 0, :vs], keys)
    assert bool((kp[0, 0, vs:] == NO_KEY).all())
    for t, tiles in enumerate(plan):
        n_first, n_last = counts[0, 0, t].tolist()
        assert len(tiles) == -(-n_last // BLOCK_K)
        assert [i for _, i in tiles] == [
            (u + 1) * BLOCK_K <= n_first for u in range(len(tiles))]


def _tile_lists(rng, n, q_block, k_tile, t):
    """tile_idx, tile_valid [N/q_block, T]: distinct tiles per list, the
    causal ones more often, some entries invalid (valid or not anywhere in
    the list)."""
    nq, nk = n // q_block, n // k_tile
    idx = np.zeros((nq, t), np.int32)
    valid = np.zeros((nq, t), bool)
    for qb in range(nq):
        last = min(((qb + 1) * q_block - 1) // k_tile, nk - 1)
        pick = rng.choice(np.arange(last + 1), size=min(t, last + 1),
                          replace=False)
        idx[qb, :len(pick)] = pick
        valid[qb, :len(pick)] = rng.random(len(pick)) < 0.8
    return torch.from_numpy(idx), torch.from_numpy(valid)


#: (n, q_block, k_tile, T, pad): 64-row q-blocks of 64-key tiles at
#: N % 128 = 64 (each warpgroup its own list), 192-row q-blocks (a q tile
#: across two lists), 512 / 256, a pad inside a unit and q tiles that are
#: all padding, no padding, N = 64
SPLAN_CASES = [(448, 64, 64, 4, 100), (576, 192, 64, 5, 0),
               (1024, 512, 256, 3, 300), (384, 128, 128, 3, 29),
               (320, 320, 64, 4, 250), (64, 64, 64, 1, 10)]


@pytest.mark.parametrize("n,q_block,k_tile,t,pad", SPLAN_CASES)
def test_slash_plan_covers_visible_pairs_once(n, q_block, k_tile, t, pad):
    rng = np.random.default_rng(n + q_block + pad)
    tile_idx, tile_valid = _tile_lists(rng, n, q_block, k_tile, t)
    vert = torch.from_numpy(rng.random(n) < 0.01)
    plan = slash_unit_plan(tile_idx, tile_valid, vert, n, pad, q_block,
                           k_tile)
    rows = np.arange(n)[:, None]
    cols = np.arange(n)[None, :]
    listed = np.zeros((n, n), bool)
    for r in range(n):
        qb = r // q_block
        for ti, ok in zip(tile_idx[qb].tolist(), tile_valid[qb].tolist()):
            if ok:
                listed[r, ti * k_tile:(ti + 1) * k_tile] = True
    vis = listed & (cols <= rows) & (cols >= pad) & ~vert.numpy()[None, :]
    assert len(plan) == -(-n // BLOCK_Q)
    hits = np.zeros((n, n), np.int64)
    for t_, tiles in enumerate(plan):
        for wgs, pair, masked in tiles:
            assert wgs in (1, 2, 3) and pair[0] >= 0
            assert pair[0] % UNIT == 0 and pair[1] % UNIT == 0 or (
                pair[1] == -1)
            for w in (0, 1):
                r0 = t_ * BLOCK_Q + w * UNIT
                if not wgs >> w & 1:
                    assert not masked[w]
                    continue
                assert r0 < n  # a warpgroup with rows
                r1 = min(r0 + UNIT, n)
                blk = np.concatenate([
                    vis[r0:r1, k0:k0 + UNIT] if k0 >= 0
                    else np.zeros((r1 - r0, UNIT), bool) for k0 in pair],
                    axis=1)
                for k0 in pair:
                    if k0 >= 0:
                        hits[r0:r1, k0:k0 + UNIT] += 1
                # unmasked: nothing to mask; masked: something to mask
                assert bool(blk.all()) == (not masked[w]), (t_, w, pair)
    assert (hits[vis] == 1).all()  # every visible pair exactly once
    assert (hits <= 1).all()
    # the kernel's bits: column 64 w + c is bit c of word w
    words = pack_vertical_bits(vert[None, None]).numpy()[0]
    assert len(words) % 2 == 0 and len(words) * UNIT >= n
    bits = (words[:, None].view(np.uint64) >> np.arange(
        UNIT, dtype=np.uint64)) & np.uint64(1)
    assert (bits.reshape(-1)[:n] == vert.numpy()).all()
    assert not bits.reshape(-1)[n:].any()


def _inputs(b, h, hk, n, seed, bf16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, n, D)).astype(np.float32)
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


def _check_partials(got, want, bf16):
    acc, m, l = (np.asarray(x, np.float32) for x in got)
    wacc, wm, wl = (np.asarray(x, np.float32) for x in want)
    live = wl > 0
    np.testing.assert_array_equal(live, l > 0)
    # a row with nothing visible: acc = 0, m = float32.min, l = 0
    assert (m[~live] == NEG).all() and (acc[~live] == 0).all()
    if not bf16:
        for x, y in ((acc, wacc), (m, wm), (l, wl)):
            np.testing.assert_allclose(x[live], y[live], rtol=KTOL,
                                       atol=KTOL)
        return
    o = (acc / np.maximum(l, 1e-30)[..., None])[live]
    ow = (wacc / np.maximum(wl, 1e-30)[..., None])[live]
    rms = np.sqrt(np.square(ow).mean(-1, keepdims=True))
    assert (np.abs(o - ow) <= 2.0 ** -6 * np.abs(ow) + 2.0 ** -5 * rms
            + 1e-30).all()
    assert (np.abs(m - wm)[live] <= 2.0 ** -12 * np.maximum(
        1.0, np.abs(wm[live]))).all()
    assert (np.abs(l - wl)[live] <= 2.0 ** -10 * wl[live]).all()


def _pattern(q, k, true_len, vertical, slash):
    """The port's estimate on f32 copies: the same pattern for every side."""
    return sp.estimate_vertical_slash(
        torch.from_numpy(q), torch.from_numpy(k),
        true_len=torch.tensor(true_len), vertical_size=vertical,
        slash_size=slash, last_q=16)


#: vertical: (b, h, n, true_len, vertical_size): N % 128 = 64 with a pad
#: inside a unit and q tiles that are all padding; Vs 128 of 124 valid
VERT_CASES = [(2, 4, 448, (448, 150), 40), (1, 2, 512, (500,), 120)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", VERT_CASES)
def test_vertical_tiled_matches_plain_and_pallas(case, bf16):
    b, h, n, tl, vsize = case
    q, k, v = _inputs(b, h, h, n, seed=n + vsize, bf16=bf16)
    pat = _pattern(q, k, tl, vsize, 16)
    # shuffled: the invalid columns (Vs padded to 128) among the valid ones
    perm = torch.from_numpy(np.random.default_rng(n).permutation(
        pat.vert_idx.shape[-1]))
    vcol = pat.vert_idx[..., perm].contiguous()
    vvalid = pat.vert_valid[..., perm].contiguous()
    assert not bool(vvalid.all()) and bool(vvalid.any())
    kt, vt = sp.gather_vertical_kv(_torch(k, bf16), _torch(v, bf16), vcol)
    tlt = torch.tensor(tl)
    args = (_torch(q, bf16), kt, vt, vcol, vvalid, tlt)
    got = vertical_tiled_plain(*args)
    _check_partials(got, sp.vertical_attention_partials_plain(*args), bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = jk.vertical_attention_partials_kernel(
        _jax(q, bf16), jnp.asarray(kt.float().numpy(), jdt),
        jnp.asarray(vt.float().numpy(), jdt), jnp.asarray(vcol.numpy()),
        jnp.asarray(vvalid.numpy()), jnp.asarray(tl, jnp.int32), q_block=64,
        interpret=True)
    _check_partials(got, want, bf16)


#: slash: (b, h, hk, n, true_len, q_block, k_tile, budget): G = 1 at 64 /
#: 64 with N % 128 = 64, a pad inside a unit and q tiles all padding; G = 4
#: at 128 / 128; G = 8 with 192-row q-blocks of 64-key tiles
SLASH_CASES = [(2, 2, 2, 448, (448, 100), 64, 64, 3),
               (1, 8, 2, 512, (437,), 128, 128, 3),
               (1, 8, 1, 384, (384,), 192, 64, 3)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", SLASH_CASES)
def test_slash_tiled_matches_plain_and_pallas(case, bf16):
    b, h, hk, n, tl, q_block, k_tile, budget = case
    q, k, v = _inputs(b, h, hk, n, seed=n + q_block, bf16=bf16)
    pat = _pattern(q, k, tl, 24, 24)
    ti, tv = sp._slash_tile_selection(pat, n, q_block, k_tile, budget)
    tlt = torch.tensor(tl)
    args = (_torch(q, bf16), _torch(k, bf16), _torch(v, bf16), ti, tv,
            pat.vert, tlt)
    kw = dict(q_block=q_block, k_tile=k_tile)
    got = slash_tiled_plain(*args, **kw)
    _check_partials(got, sp.slash_tile_attention_plain(*args, **kw), bf16)
    want = jk.slash_tile_attention(
        _jax(q, bf16), _jax(k, bf16), _jax(v, bf16),
        jnp.asarray(ti.numpy()), jnp.asarray(tv.numpy()),
        jnp.asarray(pat.vert.numpy()), jnp.asarray(tl, jnp.int32),
        interpret=True, **kw)
    _check_partials(got, want, bf16)
