"""The port's compression-stack ops for streamingllm, l2norm, random,
per-layer capacities, AdaKV, HeadKV, CAM, pivot merging, ThinK and GQA
aggregation against the JAX package on the same seeded inputs.

Integer results (keep counts, allocations, selections, masks, positions,
channel picks, random bits) must be equal; f32 results agree within 1e-5
(the same f32 arithmetic, other summation orders), or 1e-6 where stated.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu import policy as jpolicy
from pyramidkv_tpu.ops import attention as jattn
from pyramidkv_tpu.ops import merge as jmerge
from pyramidkv_tpu.ops import scoring as jscore
from pyramidkv_tpu.ops import selection as jsel
from pyramidkv_tpu.ops import think as jthink
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch import policy as tpolicy
from pyramidkv_tpu_torch import prng
from pyramidkv_tpu_torch.ops import attention as tattn
from pyramidkv_tpu_torch.ops import merge as tmerge
from pyramidkv_tpu_torch.ops import scoring as tscore
from pyramidkv_tpu_torch.ops import selection as tsel
from pyramidkv_tpu_torch.ops import think as tthink
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


def _qkv(seed, b=2, h=4, hk=2, n=64, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, h, n, d), (b, hk, n, d), (b, hk, n, d)))


#: left padding, one row at the bucket, one below the capacity of 16
TRUE_LEN = np.asarray([64, 13], np.int32)


# ---------------------------------------------------------------------------
# prng: JAX's bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num", [1, 4, 32])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
def test_prng_matches_jax(seed, num):
    jkeys = jax.random.split(jax.random.PRNGKey(seed), num)
    tkeys = prng.split(prng.PRNGKey(seed), num)
    assert np.array_equal(np.asarray(jkeys).astype(np.int64), tkeys.numpy())
    for shape in ((3,), (2, 4, 57), (1, 32, 8184)):
        want = np.asarray(jax.random.uniform(jkeys[num - 1], shape))
        got = prng.uniform(tkeys[num - 1], shape).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def test_l2norm_position_random_scores():
    q, k, _ = _qkv(1)
    tl = TRUE_LEN
    _close(tscore.l2norm_scores(_t(k), true_len=_t(tl)),
           jscore.l2norm_scores(jnp.asarray(k), true_len=jnp.asarray(tl)),
           1e-6)
    assert np.array_equal(
        tscore.position_scores(_t(q), window_size=4, true_len=_t(tl)),
        np.asarray(jscore.position_scores(jnp.asarray(q), window_size=4,
                                          true_len=jnp.asarray(tl))))
    got = tscore.random_scores(prng.PRNGKey(7), _t(q), window_size=4,
                               true_len=_t(tl)).numpy()
    want = np.asarray(jscore.random_scores(
        jax.random.PRNGKey(7), jnp.asarray(q), window_size=4,
        true_len=jnp.asarray(tl)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("pooling", ["avgpool", "maxpool"])
def test_window_scores_mean(pooling):
    q, k, _ = _qkv(2)
    kw = dict(window_size=4, kernel_size=5, pooling=pooling,
              aggregation="mean")
    _close(tscore.window_scores(_t(q), _t(k), true_len=_t(TRUE_LEN), **kw),
           jscore.window_scores(jnp.asarray(q), jnp.asarray(k),
                                true_len=jnp.asarray(TRUE_LEN), **kw), 1e-6)


# ---------------------------------------------------------------------------
# keep counts, widths, plans, layer contexts
# ---------------------------------------------------------------------------

SCHEDULE = (40, 24, 16, 9)


@pytest.mark.parametrize("kind", ["layer_capacity", "l2norm",
                                  "l2norm-noskip"])
def test_keep_counts_every_true_len(kind):
    tl = np.arange(1, 65, dtype=np.int32)
    kw = dict(max_capacity_prompt=16, window_size=4)
    if kind == "layer_capacity":
        jc, tc = (m.CompressionSpec(method="snapkv", layer_capacity=SCHEDULE,
                                    **kw) for m in (jcfg, tcfg))
        want = jsel.per_layer_keep_counts(jc, 4, jnp.asarray(tl), 4)
        got = tsel.per_layer_keep_counts(tc, 4, _t(tl), 4)
    else:
        skip = (0, 1) if kind == "l2norm" else ()
        jc, tc = (m.CompressionSpec(method="l2norm", skip_layers=skip, **kw)
                  for m in (jcfg, tcfg))
        want = jsel.l2norm_keep_counts(jc, 4, jnp.asarray(tl))
        got = tsel.l2norm_keep_counts(tc, 4, _t(tl))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


HEAD_CAPS = ((20, 8, 12, 16), (10, 30, 6, 14), (12, 12, 12, 12),
             (4, 22, 9, 17))

PLAN_CASES = [
    dict(method="streamingllm", max_capacity_prompt=24),
    dict(method="l2norm"),
    dict(method="l2norm", skip_layers=()),
    dict(method="random"),
    dict(method="adakv"),
    dict(method="headkv", head_capacity=HEAD_CAPS),
    dict(method="cam"),
    dict(method="think"),
    dict(method="think", think_dense=True),
    dict(method="think", quant_method="kivi", nbits=4),
    dict(method="snapkv", merge="pivot"),
    dict(method="snapkv", gqa_aggregate=True),
    dict(method="h2o", gqa_aggregate=True),
    dict(method="snapkv", layer_capacity=SCHEDULE),
    dict(method="cam", layer_capacity=SCHEDULE),
]


def _specs(case):
    kw = dict(max_capacity_prompt=16, window_size=4, kernel_size=5,
              recent_size=8)
    kw.update(case)
    return jcfg.CompressionSpec(**kw), tcfg.CompressionSpec(**kw)


@pytest.mark.parametrize("bucket", [64, 256])
@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_and_layer_contexts(case, bucket):
    jc, tc = _specs(case)
    want = jpolicy.make_plan(jc, 4, bucket, 8)
    got = tpolicy.make_plan(tc, 4, bucket, 8)
    assert (got.width, got.window, got.segments, got.total_slots,
            got.think_narrow, got.think_pruned_slots) == (
        want.width, want.window, want.segments, want.total_slots,
        want.think_narrow, want.think_pruned_slots)
    tl = np.asarray([bucket, bucket - 21, 13, 3], np.int32)
    jctx = jpolicy.layer_contexts(want, jnp.asarray(tl), 4,
                                  jax.random.PRNGKey(11))
    tctx = tpolicy.layer_contexts(got, _t(tl), 4, prng.PRNGKey(11))
    for g, w in zip(tctx, jctx):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_l2norm_skip_layers_segment():
    """l2norm's skipped layers keep the whole bucket: a segmented plan."""
    jc, tc = _specs(dict(method="l2norm"))
    got = tpolicy.make_plan(tc, 8, 256, 8)
    assert got.segments == jpolicy.make_plan(jc, 8, 256, 8).segments
    assert got.segments == ((0, 2, 256), (2, 8, 16))


# ---------------------------------------------------------------------------
# AdaKV / HeadKV allocation
# ---------------------------------------------------------------------------


def _alloc_scores(seed, dominant=False):
    q, k, _ = _qkv(seed, h=4, hk=2, n=96)
    s = np.array(jscore.window_scores(
        jnp.asarray(q), jnp.asarray(k), window_size=4, kernel_size=5,
        pooling="maxpool", aggregation="mean",
        true_len=jnp.asarray([96, 40], np.int32)))
    if dominant:  # head 0 outweighs the rest: it hits the slot bound
        s[:, 0] *= 100.0
    return s, np.asarray([96, 40], np.int32)


@pytest.mark.parametrize("floor", [0.2, 0.0])
@pytest.mark.parametrize("dominant", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_adakv_allocate(normalize, dominant, floor):
    scores, tl = _alloc_scores(3, dominant)
    kw = dict(base_capacity=12, floor_ratio=floor, normalize=normalize,
              window_size=4, max_head_capacity=24)
    want = jsel.adakv_allocate(jnp.asarray(scores),
                               true_len=jnp.asarray(tl), **kw)
    got = tsel.adakv_allocate(_t(scores), true_len=_t(tl), **kw)
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.order.numpy(), np.asarray(want.order))
    if dominant and floor == 0.0:
        assert int(got.counts[0, 0]) == 24  # at max_head_capacity
    sw = jsel.selection_from_allocation(want, 24)
    sg = tsel.selection_from_allocation(got, 24)
    assert np.array_equal(sg.indices.numpy(), np.asarray(sw.indices))
    assert np.array_equal(sg.valid.numpy(), np.asarray(sw.valid))


@pytest.mark.parametrize("normalize", [True, False])
def test_allocation_subnormal_scores(normalize):
    """Peaked attention leaves exact zeros and subnormals in the scores:
    JAX's sorts and products treat subnormals as zero (its top_k does not),
    and the cut of the global top-k falls among them."""
    rng = np.random.default_rng(21)
    pool = np.asarray([0.0, 0.0, 1e-40, 3e-39, 1e-37, 2e-30, 0.25, 0.125],
                      np.float32)
    scores = rng.choice(pool, size=(2, 4, 80)).astype(np.float32)
    scores[:, :, :5] = -np.inf
    tl = np.asarray([84, 60], np.int32)
    kw = dict(base_capacity=24, floor_ratio=0.2, normalize=normalize,
              window_size=4, max_head_capacity=48)
    want = jsel.adakv_allocate(jnp.asarray(scores),
                               true_len=jnp.asarray(tl), **kw)
    got = tsel.adakv_allocate(_t(scores), true_len=_t(tl), **kw)
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.order.numpy(), np.asarray(want.order))
    caps = jnp.asarray([30, 8, 20, 5], np.int32)
    want = jsel.headkv_allocate(jnp.asarray(scores), head_capacity=caps,
                                base_capacity=24, true_len=jnp.asarray(tl),
                                window_size=4, max_head_capacity=48)
    got = tsel.headkv_allocate(_t(scores), head_capacity=_t(caps),
                               base_capacity=24, true_len=_t(tl),
                               window_size=4, max_head_capacity=48)
    assert np.array_equal(got.order.numpy(), np.asarray(want.order))


def test_headkv_allocate():
    scores, tl = _alloc_scores(4)
    caps = np.asarray([20, 8, 30, 5], np.int32)
    kw = dict(base_capacity=12, window_size=4, max_head_capacity=24)
    want = jsel.headkv_allocate(jnp.asarray(scores),
                                head_capacity=jnp.asarray(caps),
                                true_len=jnp.asarray(tl), **kw)
    got = tsel.headkv_allocate(_t(scores), head_capacity=_t(caps),
                               true_len=_t(tl), **kw)
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.order.numpy(), np.asarray(want.order))


def test_headkv_capacity_from_scores():
    s = np.random.default_rng(5).random(16).tolist()
    assert tcfg.headkv_capacity_from_scores(s, 4, 4, 16) == \
        jcfg.headkv_capacity_from_scores(s, 4, 4, 16)


# ---------------------------------------------------------------------------
# merging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [7, 30, 60])
def test_pivot_merge_in_row_blocks(monkeypatch, rows):
    """The port searches the nearest pool row for a block of past rows at a
    time: the 60 past rows in 9 blocks, in 2, in one."""
    _, k, v = _qkv(6, h=4, hk=4, n=64)
    q = np.random.default_rng(7).normal(size=k.shape).astype(np.float32)
    tl = TRUE_LEN
    scores = jscore.window_scores(jnp.asarray(q), jnp.asarray(k),
                                  window_size=4, kernel_size=5,
                                  pooling="maxpool", true_len=jnp.asarray(tl))
    keep = jnp.asarray([12, 9], np.int32)
    jsel_ = jsel.topk_select(scores, 12, keep)
    tsel_ = tsel.Selection(indices=_t(jsel_.indices).long(),
                           valid=_t(jsel_.valid))
    wk, wv = jmerge.pivot_merge(jnp.asarray(k), jnp.asarray(v), jsel_,
                                window_size=4, true_len=jnp.asarray(tl))
    # b * h * m = 2 * 4 * (12 + 4): a block of `rows` past rows
    monkeypatch.setattr(tmerge, "PIVOT_BLOCK_ELEMS", rows * 2 * 4 * 16)
    gk, gv = tmerge.pivot_merge(_t(k), _t(v), tsel_, window_size=4,
                                true_len=_t(tl))
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("r", [4, 8])
def test_cam_banded_solve(r):
    rng = np.random.default_rng(r)
    b, h, L, d = 2, 3, 16 * r, 8
    v = rng.normal(size=(b, h, L, d)).astype(np.float32)
    c = np.where(rng.random((b, h, L)) < 0.5, 1.0 / r, 0.0).astype(
        np.float32)
    u0 = rng.normal(size=(b, h, r, d)).astype(np.float32)
    c0 = np.where(rng.random((b, h, r)) < 0.5, 1.0 / r, 0.0).astype(
        np.float32)
    wu, (wl, wc) = jmerge.cam_banded_solve(*(jnp.asarray(x)
                                             for x in (v, c)), r,
                                           jnp.asarray(u0), jnp.asarray(c0))
    gu, (gl, gc) = tmerge.cam_banded_solve(_t(v), _t(c), r, _t(u0), _t(c0))
    _close(gu, wu)
    _close(gl, wl)
    assert np.array_equal(gc.numpy(), np.asarray(wc))


def test_cam_merge_values():
    q, k, v = _qkv(8, h=4, hk=4, n=64)
    w, n = 4, 64
    tl = TRUE_LEN
    qw = q[:, :, n - w:]
    logits = np.einsum("bhwd,bhnd->bhwn", qw, k) / np.sqrt(16)
    logits = logits + np.asarray(jscore._window_causal_bias(w, n))[None, None]
    colv = np.arange(n)[None, :] >= (n - tl)[:, None]
    logits = np.where(colv[:, None, None, :], logits, -np.inf)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    sb = np.ceil(0.1 * tl.astype(np.float32)).astype(np.int32)
    want = jpolicy._cam_merge_values(
        jnp.asarray(v), jnp.asarray(probs), rng=jax.random.PRNGKey(9),
        start_budget=jnp.asarray(sb), recent_budget=w,
        true_len=jnp.asarray(tl))
    got = tpolicy._cam_merge_values(
        _t(v), _t(probs), rng=prng.PRNGKey(9), start_budget=_t(sb),
        recent_budget=w, true_len=_t(tl))
    _close(got, want)
    assert not np.allclose(np.asarray(want), v)  # some rows were merged


# ---------------------------------------------------------------------------
# ThinK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_think_channel_selection_and_gather(masked):
    q, k, _ = _qkv(10, h=4, hk=4, n=64, d=32)
    tl = TRUE_LEN
    kw = dict(ratio=0.4)
    vm = None
    if masked:  # a compacted buffer: valid rows lead, a per-head count
        cnt = np.asarray([[50, 40, 30, 20], [9, 12, 5, 1]])
        vm = np.arange(64)[None, None, :] < cnt[..., None]
    want = jthink.think_channel_selection(
        jnp.asarray(k), jnp.asarray(q), true_len=jnp.asarray(tl),
        valid_mask=None if vm is None else jnp.asarray(vm), **kw)
    got = tthink.think_channel_selection(
        _t(k), _t(q), true_len=_t(tl),
        valid_mask=None if vm is None else _t(vm), **kw)
    assert got.kept_channels.shape[-1] == 32 - int(32 * 0.4)
    assert np.array_equal(got.kept_channels.numpy(),
                          np.asarray(want.kept_channels))
    assert np.array_equal(got.channel_mask.numpy(),
                          np.asarray(want.channel_mask))
    assert np.array_equal(
        tthink.gather_channels(_t(k), got.kept_channels).numpy(),
        np.asarray(jthink.gather_channels(jnp.asarray(k),
                                          want.kept_channels)))


def test_decode_attention_think():
    rng = np.random.default_rng(12)
    b, h, d, dk, sp, sr = 2, 4, 32, 20, 24, 12
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(b, h, sp, dk)).astype(np.float32)
    kc = np.sort(np.stack([[rng.permutation(d)[:dk] for _ in range(h)]
                           for _ in range(b)]), axis=-1).astype(np.int32)
    kr = rng.normal(size=(b, h, sr, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sp + sr, d)).astype(np.float32)
    mask = rng.random((b, h, sp + sr)) < 0.7
    mask[1, 2] = False  # a row with every slot masked
    want = jattn.decode_attention_think(*(jnp.asarray(x) for x in (
        q, kp, kc, kr, v, mask)))
    got = tattn.decode_attention_think(*(_t(x) for x in (
        q, kp, kc, kr, v, mask)))
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# compress_layer, every new branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_compress_layer(case):
    jc, tc = _specs(case)
    q, k, v = _qkv(13, b=4, h=4, hk=2, n=64, d=32)
    tl = np.asarray([64, 43, 13, 3], np.int32)
    jp = jpolicy.make_plan(jc, 4, 64, 8)
    tp = tpolicy.make_plan(tc, 4, 64, 8)
    li = 1
    jctx = jax.tree_util.tree_map(
        lambda x: x[li], jpolicy.layer_contexts(jp, jnp.asarray(tl), 4,
                                                jax.random.PRNGKey(5)))
    tctx = tpolicy.layer_contexts(tp, _t(tl), 4, prng.PRNGKey(5)).layer(li)
    for (s0, s1, jsub), (_, _, tsub) in zip(jp.segment_plans(),
                                            tp.segment_plans()):
        if s0 <= li < s1:
            break
    want = jpolicy.compress_layer(jsub, jctx, *(jnp.asarray(x)
                                               for x in (q, k, v)),
                                  true_len=jnp.asarray(tl))
    got = tpolicy.compress_layer(tsub, tctx, _t(q), _t(k), _t(v),
                                 true_len=_t(tl), attention_impl="plain")
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert np.array_equal(got.positions.numpy(), np.asarray(want.positions))
    _close(got.k, want.k)
    _close(got.v, want.v)
    if tsub.think_narrow:
        wk = jpolicy.think_split(want, jnp.asarray(q), jsub,
                                 jnp.asarray(tl))
        gk = tpolicy.think_split(got, _t(q), tsub, _t(tl))
        assert np.array_equal(gk[1].numpy(), np.asarray(wk[1]))
        _close(gk[0], wk[0])
        _close(gk[2], wk[2])
