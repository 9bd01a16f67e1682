"""The plan and schedule of the port's KIVI group-region kernel
(``csrc/quant_region.cuh``, ``region_kernel``), on the CPU.

- ``kernels/quant_decode.py::split_plan`` covers every byte-row [0, W), on
  every bit-plane, with non-empty splits of whole 32-row items (one split:
  all W rows), from the shapes alone; up to MAX_CLUSTER splits take one
  launch (a cluster merges them), more two (a merge kernel).  The K groups
  a split's byte-rows touch on each plane (slot j + p * W) fit the columns
  the kernel stages (``staged_groups``: ceil(rows / kg) + 1 at most), and
  the shared memory a block asks for (``region_smem_bytes``, the mirror of
  ``region_layout``) fits a block's 227 KB at the engine's shapes and at
  ragged ones (W no multiple of 32, K groups of 12 straddling splits, a
  last split shorter than the others), for G in {1, 2, 4, 8}, both modes.
- ``region_split_plain`` (the kernel's schedule: each split's partials over
  its byte-rows on every plane, its share of the bf16 tail's 32-slot items,
  the splits merged in split order) against the plain versions: in f32
  (``quant_decode_attention_plain``) within 2e-5 relative, the same f32
  terms summed in other orders; with the bf16 folds
  (``quant_region_attention_fused``) within 2^-6 |want| + 2^-6 rms(row) =
  4 x 2^-8 (l within 2^-7): each split rounds p * vs to bf16 at its own max
  where the plain version rounds at the row's (a relative 2^-9 per term
  either way, up to a few terms' worth on a 32-channel row).  Also
  against JAX's ``quant_decode_attention_tiled`` (interpret) within the JAX
  test's 2e-4, and with a wholly masked split and a row masked everywhere
  (m = float32.min, l = 0, acc = 0 exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu.kernels.quant_decode import (
    quant_decode_attention_tiled as jax_qda_tiled)
from pyramidkv_tpu.ops import quant as jq
from pyramidkv_tpu_torch.kernels import quant_decode as qd
from pyramidkv_tpu_torch.models.convert import region_from_numpy
from pyramidkv_tpu_torch.ops import quant as tq
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
NEG = float(np.finfo(np.float32).min)

#: (B * Hk, W, nbits, K group size): the engine's group regions (bench.py's
#: 32k snapkv, the 8k batch's snapkv kivi4 / kivi2, 32k fullkv kivi4 /
#: kivi2), chip_smoke.py's ragged ones, and others
PLAN_CASES = [
    (32, 64, 4, 64), (128, 1024, 4, 64), (128, 512, 2, 64),
    (8, 16384, 4, 64), (8, 8192, 2, 64),
    (6, 504, 4, 12), (8, 1232, 2, 16), (4, 320, 8, 32), (8, 2496, 4, 64),
    (8, 1024, 4, 64), (600, 4096, 2, 64), (1, 32, 4, 16), (2, 100, 4, 25),
    (3, 12, 2, 12), (64, 32768, 8, 64),
]


def _groups_touched(r0, r1, p, w, kg):
    return (r1 - 1 + p * w) // kg - (r0 + p * w) // kg + 1


@pytest.mark.parametrize("bhk,w,nbits,kg", PLAN_CASES)
def test_split_plan_covers_every_plane(bhk, w, nbits, kg):
    nsplit, rows = qd.split_plan(CPU, bhk, w, nbits, kg)
    assert qd.split_plan(CPU, bhk, w, nbits, kg) == (nsplit, rows)
    assert nsplit >= 1 and (nsplit - 1) * rows < w <= nsplit * rows
    if nsplit == 1:
        assert rows == w
    else:
        assert rows % qd.ITEM_ROWS == 0
    assert qd.region_kernels(nsplit) == (1 if nsplit <= qd.MAX_CLUSTER
                                         else 2)
    per = 8 // nbits
    ng = w * per // kg
    staged = qd.staged_groups(rows, kg, ng)
    assert staged <= -(-rows // kg) + 1
    covered = np.zeros((per, w), np.int64)
    for s in range(nsplit):
        r0, r1 = s * rows, min(w, (s + 1) * rows)
        assert r0 < r1  # no empty split
        for p in range(per):
            covered[p, r0:r1] += 1
            assert _groups_touched(r0, r1, p, w, kg) <= staged
    assert (covered == 1).all()


@pytest.mark.parametrize("bhk,w,nbits,kg", PLAN_CASES)
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_split_plan_fits_shared_memory(bhk, w, nbits, kg, g):
    """Whatever the plan, each block's staged tables, ring and tail lists
    fit a block's shared memory, in both modes, for V groups of 16
    channels or more and tails up to 128 slots."""
    nsplit, rows = qd.split_plan(CPU, bhk, w, nbits, kg)
    ng = w * (8 // nbits) // kg
    for fold in (False, True):
        for vg in (16, 64):
            for t in (0, 37, 128):
                assert qd.region_smem_bytes(
                    g, nbits, fold, rows, kg, ng, 128, 128 // vg,
                    t) <= qd.MAX_SMEM, (fold, vg, t)


def test_split_plan_of_the_engine_shapes():
    """The plans of the engine's group regions, written out: one launch at
    the 8k batch (2 splits in a cluster: 256 blocks, one wave of two an
    SM) and on bench.py's 32k snapkv (one split); 32 splits and a merge
    kernel at 32k fullkv (8 regions: a cluster plan would leave 100 of 132
    SMs idle)."""
    assert qd.split_plan(CPU, 32, 64, 4, 64) == (1, 64)
    assert qd.split_plan(CPU, 128, 1024, 4, 64) == (2, 512)
    assert qd.split_plan(CPU, 128, 512, 2, 64) == (2, 256)
    assert qd.split_plan(CPU, 8, 16384, 4, 64) == (32, 512)
    assert [qd.region_kernels(n) for n in (1, 4, 5, 64)] == [1, 1, 2, 2]


#: (W, nbits, K group size, G, tail): long regions on the one-split plan
#: (the whole-region wrapper): 32k fullkv kivi4 / kivi2 at G = 4, and
#: chip_smoke.py's short case of K groups of 12 slots at G = 8
WINDOW_CASES = [(16384, 4, 64, 4, 128), (8192, 2, 64, 4, 128),
                (2208, 2, 12, 8, 5), (16384, 8, 32, 8, 0)]


@pytest.mark.parametrize("w,nbits,kg,g,t", WINDOW_CASES)
@pytest.mark.parametrize("fold", [False, True])
def test_region_window_stages_what_fits(w, nbits, kg, g, t, fold):
    """Where one split's K tables exceed shared memory, the kernel stages
    them a window at a time: the window is whole ring items, the longest
    that fits, and each window's rows touch no more K groups per plane
    than it stages.  Every split_plan plan takes one staging."""
    per = 8 // nbits
    ng = w * per // kg
    args = (g, nbits, fold, w, kg, ng, 128, 2, t)
    win = qd.region_window(*args)
    assert 0 < win < w and win % qd.ITEM_ROWS == 0
    assert qd.region_smem_bytes(*args, win) <= qd.MAX_SMEM
    assert qd.region_smem_bytes(*args, win + qd.ITEM_ROWS) > qd.MAX_SMEM
    staged = qd.staged_groups(win, kg, ng)
    for r0 in range(0, w, win):
        for p in range(per):
            assert _groups_touched(r0, min(w, r0 + win), p, w, kg) <= staged
    nsplit, rows = qd.split_plan(CPU, 8, w, nbits, kg)
    assert qd.region_window(g, nbits, fold, rows, kg, ng, 128, 2,
                            t) == rows


def test_smem_mirror_of_the_8k_block():
    """region_smem_bytes at a kivi4 split of the 8k batch's (G = 1, 256 rows,
    kg 64, 32 K groups, V rows of 128 bytes, 2 V groups, tail 32), by
    hand: ring 4 x 16384 (a stage holds a region item, 32 K rows, 32 V
    rows and 2 planes x 32 rows x 2 V groups of scales and of zeros: 9216
    bytes, or a tail item, 32 bf16 K and V rows), the query 640, f32
    tables 2 x 10 x 640 (5 groups a plane), visibility 2 x 8 x 4, the
    tail's word and list 8."""
    assert qd.region_smem_bytes(1, 4, False, 256, 64, 32, 128, 2, 32) == (
        4 * 16384 + 640 + 2 * 10 * 640 + 64 + 8)
    # the folded query: 10 columns x (640 + 4) bytes, rounded to 16
    assert qd.region_smem_bytes(1, 4, True, 256, 64, 32, 128, 2, 32) == (
        4 * 16384 + 640 + 6448 + 64 + 8)


def _region(nbits, b, hk, g, s, d, group, seed, valid=0.85):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hk * g, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    k *= np.exp(rng.normal(size=(1, 1, 1, d))).astype(np.float32)
    v = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    jreg = jq.quantize_kv_region(jnp.asarray(k), jnp.asarray(v), nbits=nbits,
                                 group_size=group)
    treg = region_from_numpy(jreg, device="cpu")
    mask = rng.random((b, hk, s)) < valid
    mask[0, 0] = False  # a row masked everywhere
    tail_k = rng.normal(size=(b, hk, 70, d)).astype(np.float32)
    tail_v = rng.normal(size=(b, hk, 70, d)).astype(np.float32)
    tmask = rng.random((b, hk, 70)) < 0.7
    tmask[:, :, 0] = True
    tmask[:, :, 32:64] = False  # a tail item with no visible slot
    return q, mask, jreg, treg, (tail_k, tail_v, tmask)


def _norm(acc, l):
    return acc / np.maximum(l, 1e-30)[..., None]


def _err_over_tol(got, want, rtol, row_tol):
    rms = np.sqrt(np.square(want).mean(-1, keepdims=True))
    lim = np.maximum(rtol * np.abs(want) + row_tol * rms, 1e-30)
    return float((np.abs(got - want) / lim).max())


#: (nbits, G, slots, head dim, K group, split counts, masked byte-rows):
#: plans of one split, a cluster's and more; a wholly masked split
SCHEDULE_CASES = [
    (4, 1, 1000, 32, 12, (1, 2, 4), None),
    (2, 4, 700, 32, 16, (1, 3, 6), (32, 64)),
    (8, 1, 600, 32, 32, (1, 5), (128, 256)),
    (4, 4, 512, 32, 64, (2, 8), (64, 128)),
]


def _plans(w, counts):
    items = -(-w // qd.ITEM_ROWS)
    for n in counts:
        rows = qd.ITEM_ROWS * -(-items // n) if n > 1 else w
        yield -(-w // rows), rows


@pytest.mark.parametrize("case", SCHEDULE_CASES)
@pytest.mark.parametrize("fold", [False, True])
def test_split_schedule_matches_plain(case, fold):
    nbits, g, s, d, group, counts, masked = case
    q, mask, _, treg, tail = _region(nbits, 2, 3, g, s, d, group,
                                     seed=s + g + nbits)
    w = treg.k.codes.shape[2]
    if masked:
        rows_of = np.arange(s) % w
        mask &= ~((rows_of >= masked[0]) & (rows_of < masked[1]))
    qt, mt = torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(mask)
    tl = tuple(torch.from_numpy(x) for x in tail)
    tl = (tl[0].to(torch.bfloat16), tl[1].to(torch.bfloat16), tl[2])
    plain = (tq.quant_region_attention_fused if fold
             else tq.quant_decode_attention_plain)
    acc, m, l = (x.numpy() for x in plain(qt, treg, mt, nbits=nbits))
    want_o = tq.merge_tail(plain(qt, treg, mt, nbits=nbits), qt,
                           tl).float().numpy()
    rtol, row_tol = (2.0 ** -6, 2.0 ** -6) if fold else (2e-5, 2e-5)
    for plan in _plans(w, counts):
        gacc, gm, gl = (x.numpy() for x in qd.region_split_plain(
            qt, treg, mt, nbits=nbits, plan=plan, fold=fold))
        live = l > 0
        assert (live == (gl > 0)).all()
        assert (gm[~live] == NEG).all() and (gacc[~live] == 0).all()
        assert (gm[0, :g] == NEG).all()  # the row masked everywhere
        np.testing.assert_allclose(gm, m, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(gl, l, rtol=(2.0 ** -7 if fold else 2e-5))
        assert _err_over_tol(_norm(gacc, gl)[live], _norm(acc, l)[live],
                             rtol, row_tol) <= 1, plan
        got_o = qd.region_split_plain(qt, treg, mt, nbits=nbits, plan=plan,
                                      fold=fold, tail=tl).float().numpy()
        # plus one bf16 ulp of the output
        assert _err_over_tol(got_o, want_o, rtol + 2.0 ** -7,
                             row_tol) <= 1, plan


@pytest.mark.parametrize("nbits", [8, 4, 2])
def test_split_schedule_matches_pallas_tiled(nbits):
    """The f32 schedule on a 3-split plan against JAX's tiled kernel
    (tile 256: its online softmax carried across tiles), as
    test_torch_quant.py holds the plain version."""
    q, mask, jreg, treg, _ = _region(nbits, 1, 2, 2, 1000, 32, 32,
                                     seed=40 + nbits)
    w = treg.k.codes.shape[2]
    s_pad = w * (8 // nbits)
    m_pad = np.zeros(mask.shape[:2] + (s_pad,), bool)
    m_pad[..., :mask.shape[-1]] = mask
    want = jax_qda_tiled(jnp.asarray(q), jreg.k.codes, jreg.k.scale[..., 0],
                         jreg.k.zero[..., 0], jreg.v.codes,
                         jreg.v.scale[..., 0], jreg.v.zero[..., 0],
                         jnp.asarray(m_pad), nbits=nbits, group_size=32,
                         tile=256, interpret=True)
    plan = next(_plans(w, (3,)))
    assert plan[0] == 3
    acc, m, l = (x.numpy() for x in qd.region_split_plain(
        torch.from_numpy(q), treg, torch.from_numpy(mask), nbits=nbits,
        plan=plan, fold=False))
    wacc, wm, wl = (np.asarray(x) for x in want)
    live = wl > 0
    np.testing.assert_allclose(_norm(acc, l)[live], _norm(wacc, wl)[live],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(m[live], wm[live], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(l[live], wl[live], rtol=2e-4, atol=2e-4)


def test_split_schedule_refuses_a_plan_that_misses_rows():
    q, mask, _, treg, _ = _region(4, 1, 1, 1, 256, 32, 32, seed=1)
    qt, mt = torch.from_numpy(q), torch.from_numpy(mask)
    for plan in ((2, 32), (3, 64), (1, 64)):  # W = 128
        with pytest.raises(ValueError, match="cover"):
            qd.region_split_plain(qt, treg, mt, nbits=4, plan=plan,
                                  fold=False)
