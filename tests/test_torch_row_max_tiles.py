"""The unit plan and schedule of the port's pass-A kernel (the two-pass
flash schedule's row maxes, ``csrc/flash_prefill.cu``, ``row_max_kernel``),
on the CPU.

- ``row_max_unit_plan`` against the plain mask: each 64-row warpgroup's
  units cover every visible (row, key) pair of its rows exactly once, and a
  unit is interior exactly when all of its warpgroup's 64 rows see all of
  its 64 keys (the kernel masks only the other units).
- ``row_max_tiled_plain`` (the kernel's schedule: the plan's units, the
  mask only on units that are not interior, a running max per row) against
  ``flash_row_max_plain`` and against the row maxes of JAX's pass A
  (``flash_causal_attention(two_pass=True)``'s first ``pallas_call``, in
  interpret mode, captured on its way to pass B), on the same numpy inputs:
  a pad inside a tile, G = 8 and G = 1, a window, a prefill chunk at
  ``q_start`` with N % 128 = 64 and Nq cut short of a 128-row q tile, and
  rows that are all padding.  The logits are the same f32 sums of the same
  products in other orders, held within 2^-12 max(1, |m|) (the limit
  ``chip_smoke.py`` holds the kernel to); a row with no visible key is
  exactly float32.min in all three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyramidkv_tpu.kernels.flash_prefill as jax_fp
from pyramidkv_tpu_torch.kernels.flash_prefill import (BLOCK_Q, UNIT,
                                                      row_max_tiled_plain,
                                                      row_max_unit_plan)
from pyramidkv_tpu_torch.ops.attention import flash_row_max_plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

D = 128
NEG = float(np.finfo(np.float32).min)

#: (b, h, hk, n, nq, q_start, true_len, window)
CASES = [
    (2, 8, 1, 384, 384, 0, (384, 150), None),    # G = 8, pad inside a tile
    (2, 4, 4, 448, 192, 256, (448, 300), None),  # G = 1, a chunk, Nq = 192
    (1, 4, 1, 512, 512, 0, (435,), 100),         # a window
    (2, 2, 2, 256, 256, 0, (256, 40), 64),       # a q tile all padding
]


def _visible(n, q_start, pad, window, rows, ncols):
    r = q_start + np.arange(rows)[:, None]
    c = np.arange(ncols)[None, :]
    vis = (c >= pad) & (c <= r) & (c < n)
    if window:
        vis &= r - c < window
    return vis


@pytest.mark.parametrize("n,nq,q_start,pad,window", [
    (512, 512, 0, 0, None), (512, 512, 0, 77, None), (192, 192, 0, 70, None),
    (512, 512, 0, 200, 50), (448, 192, 256, 100, None),
    (384, 64, 320, 300, None), (256, 256, 0, 256, None)])
def test_unit_plan_covers_visible_pairs_once(n, nq, q_start, pad, window):
    ntile = -(-nq // BLOCK_Q)
    rows = ntile * BLOCK_Q  # warpgroup rows past nq too (never written)
    vis = _visible(n, q_start, pad, window, rows, -(-n // 128) * 128 + 128)
    plan = row_max_unit_plan(n, nq, q_start, pad, window)
    assert len(plan) == ntile
    hits = np.zeros_like(vis, dtype=np.int64)
    for t, groups in enumerate(plan):
        assert len(groups) == BLOCK_Q // UNIT
        for cw, units in enumerate(groups):
            r0 = t * BLOCK_Q + cw * UNIT
            firsts = [cu for cu, _ in units]
            assert firsts == sorted(set(firsts))
            for cu, inner in units:
                block = vis[r0:r0 + UNIT, cu:cu + UNIT]
                hits[r0:r0 + UNIT, cu:cu + UNIT] += 1
                assert bool(block.all()) == inner, (t, cw, cu)
    live = vis[:nq]
    assert (hits[:nq][live] == 1).all()
    assert (hits <= 1).all()


def _inputs(b, h, hk, n, nq, seed, bf16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, nq, D)).astype(np.float32)
    k = rng.normal(size=(b, hk, n, D)).astype(np.float32)
    if bf16:
        q, k = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                for x in (q, k))
    return q, k


def _close(got, want, dead_rows):
    got, want = np.asarray(got), np.asarray(want)
    assert (got[:, :, :dead_rows] == NEG).all()
    assert (want[:, :, :dead_rows] == NEG).all()
    g, w = got[:, :, dead_rows:], want[:, :, dead_rows:]
    assert (np.abs(g - w) <= 2.0 ** -12 * np.maximum(1.0, np.abs(w))).all()


def _jax_row_max(q, k, tl, monkeypatch, **kw):
    """The m of JAX's pass A: the first pallas_call of the two-pass
    schedule, captured (its [B*H, Nq, 8] sidecar, column 0) from the
    function run eagerly (``__wrapped__``: outside ``jax.jit``)."""
    got = []
    real = jax_fp.pl.pallas_call

    def spy(*a, **k2):
        f = real(*a, **k2)

        def call(*args):
            out = f(*args)
            got.append(out)
            return out
        return call
    monkeypatch.setattr(jax_fp.pl, "pallas_call", spy)
    jax_fp.flash_causal_attention.__wrapped__(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(tl),
        two_pass=True, interpret=True, block_q=64, block_k=64, **kw)
    monkeypatch.undo()
    b, h, nq = q.shape[:3]
    return np.asarray(got[0])[..., 0].reshape(b, h, nq)


@pytest.mark.parametrize("case", CASES)
def test_tiled_row_max_matches_plain_and_pallas(case, monkeypatch):
    b, h, hk, n, nq, q_start, tl, window = case
    q, k = _inputs(b, h, hk, n, nq, seed=n + nq + h, bf16=False)
    tlt = torch.tensor(tl)
    kw = dict(sliding_window=window, q_start=q_start)
    got = row_max_tiled_plain(torch.from_numpy(q), torch.from_numpy(k), tlt,
                              **kw).numpy()
    plain = flash_row_max_plain(torch.from_numpy(q), torch.from_numpy(k),
                                tlt, **kw).numpy()
    pallas = _jax_row_max(q, k, np.asarray(tl, np.int32), monkeypatch, **kw)
    for bi, t in enumerate(tl):
        dead = max(0, min(nq, n - t - q_start))  # local rows before the pad
        for want in (plain, pallas):
            _close(got[bi:bi + 1], want[bi:bi + 1], dead)


@pytest.mark.parametrize("case", CASES[:2])
def test_tiled_row_max_bf16_rounds_q_once(case):
    """bf16 inputs: q is scaled by scale * log2(e) and rounded to bf16
    once, as the kernel folds it; the same numbers as the plain version."""
    b, h, hk, n, nq, q_start, tl, window = case
    q, k = _inputs(b, h, hk, n, nq, seed=5, bf16=True)
    qt, kt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k))
    tlt = torch.tensor(tl)
    kw = dict(sliding_window=window, q_start=q_start)
    got = row_max_tiled_plain(qt, kt, tlt, **kw).numpy()
    plain = flash_row_max_plain(qt, kt, tlt, **kw).numpy()
    for bi, t in enumerate(tl):
        dead = max(0, min(nq, n - t - q_start))
        _close(got[bi:bi + 1], plain[bi:bi + 1], dead)
