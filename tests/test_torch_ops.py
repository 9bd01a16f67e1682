"""The port's compression ops against the JAX package on the same inputs.

Integer and selection results must match exactly; f32 scores to 1e-6
(same f32 sums, other summation order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu import policy as jpolicy
from pyramidkv_tpu.models import llama as jllama
from pyramidkv_tpu.ops import pooling as jpool
from pyramidkv_tpu.ops import scoring as jscore
from pyramidkv_tpu.ops import selection as jsel
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch import policy as tpolicy
from pyramidkv_tpu_torch.models import llama as tllama
from pyramidkv_tpu_torch.ops import pooling as tpool
from pyramidkv_tpu_torch.ops import scoring as tscore
from pyramidkv_tpu_torch.ops import selection as tsel
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCORE_TOL = 1e-6


@pytest.mark.parametrize("mode", ["avgpool", "maxpool"])
@pytest.mark.parametrize("kernel", [1, 5, 7])
def test_pool1d(mode, kernel):
    x = np.random.default_rng(kernel).random((2, 3, 50)).astype(np.float32)
    want = np.asarray(jpool.pool1d(jnp.asarray(x), kernel, mode))
    got = tpool.pool1d(torch.from_numpy(x), kernel, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("hk", [4, 2])
@pytest.mark.parametrize("pooling", ["avgpool", "maxpool"])
def test_window_scores(hk, pooling):
    rng = np.random.default_rng(hk)
    q = rng.normal(size=(2, 4, 64, 16)).astype(np.float32)
    k = rng.normal(size=(2, hk, 64, 16)).astype(np.float32)
    tl = np.asarray([64, 30], np.int32)
    kw = dict(window_size=4, kernel_size=5, pooling=pooling)
    want = np.asarray(jscore.window_scores(
        jnp.asarray(q), jnp.asarray(k), true_len=jnp.asarray(tl), **kw))
    got = tscore.window_scores(torch.from_numpy(q), torch.from_numpy(k),
                               true_len=torch.from_numpy(tl), **kw).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("cap,window,beta,layers", [
    (16, 4, 20, 4), (24, 8, 2, 5), (2048, 8, 20, 32)])
def test_keep_counts_every_true_len(cap, window, beta, layers):
    bucket = 64 if cap < 100 else 8192
    tl = np.arange(1, bucket + 1, dtype=np.int32)
    jspec = jcfg.CompressionSpec(method="pyramidkv", max_capacity_prompt=cap,
                                 window_size=window, beta=beta)
    tspec = tcfg.CompressionSpec(method="pyramidkv", max_capacity_prompt=cap,
                                 window_size=window, beta=beta)
    want = np.asarray(jsel.pyramid_keep_counts(jspec, layers, jnp.asarray(tl)))
    got = tsel.pyramid_keep_counts(tspec, layers, torch.from_numpy(tl))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jsel.uniform_keep_counts(jspec, jnp.asarray(tl), window))
    got = tsel.uniform_keep_counts(tspec, torch.from_numpy(tl), window)
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_select_breaks_ties_like_jax():
    scores = np.asarray([[[1, 3, 3, 2, 3, 3, 0]]], np.float32)
    keep = np.asarray([3], np.int32)
    want = jsel.topk_select(jnp.asarray(scores), 3, jnp.asarray(keep))
    got = tsel.topk_select(torch.from_numpy(scores), 3, torch.from_numpy(keep))
    assert got.indices.tolist() == [[[1, 2, 4]]]
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_topk_select_maxpool_scores():
    """Maxpooled scores tie exactly; -inf padding columns are invalid."""
    rng = np.random.default_rng(3)
    raw = rng.random((2, 4, 40)).astype(np.float32)
    raw[1, :, :15] = 0.0
    scores = np.array(jpool.pool1d(jnp.asarray(raw), 5, "maxpool"))
    scores[1, :, :15] = -np.inf
    keep = np.asarray([12, 30], np.int32)
    want = jsel.topk_select(jnp.asarray(scores), 30, jnp.asarray(keep))
    got = tsel.topk_select(torch.from_numpy(scores), 30,
                           torch.from_numpy(keep))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("hk", [4, 2])
def test_compact_kv(hk):
    rng = np.random.default_rng(10 + hk)
    b, h, n, d, w = 2, 4, 32, 8, 4
    k = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    tl = np.asarray([32, 13], np.int32)
    scores = rng.random((b, h, n - w)).astype(np.float32)
    scores[1, :, : n - 13] = -np.inf
    keep = np.asarray([10, 9], np.int32)
    jsel_ = jsel.topk_select(jnp.asarray(scores), 10, jnp.asarray(keep))
    want = jsel.compact_kv(jnp.asarray(k), jnp.asarray(v), jsel_,
                           window_size=w, decode_slots=3,
                           true_len=jnp.asarray(tl))
    tsel_ = tsel.topk_select(torch.from_numpy(scores), 10,
                             torch.from_numpy(keep))
    got = tsel.compact_kv(torch.from_numpy(k), torch.from_numpy(v), tsel_,
                          window_size=w, decode_slots=3,
                          true_len=torch.from_numpy(tl))
    for name in ("k", "v", "mask", "positions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("method,layers,bucket,cap,window", [
    ("fullkv", 4, 64, 16, 4),
    ("snapkv", 4, 64, 16, 4),
    ("pyramidkv", 4, 64, 16, 4),     # the golden-trace plan: 2 segments
    ("pyramidkv", 32, 8192, 2048, 8),  # the on-card plan: 4 segments
    ("pyramidkv", 32, 512, 2048, 8),   # bucket below cap: uniform
])
def test_make_plan(method, layers, bucket, cap, window):
    kw = dict(method=method, max_capacity_prompt=cap, window_size=window)
    want = jpolicy.make_plan(jcfg.CompressionSpec(**kw), layers, bucket, 32)
    got = tpolicy.make_plan(tcfg.CompressionSpec(**kw), layers, bucket, 32)
    assert (got.width, got.window, got.segments, got.total_slots) == (
        want.width, want.window, want.segments, want.total_slots)
    if method == "pyramidkv" and bucket == 64:
        assert got.segments == ((0, 1, 24), (1, 4, 16))
    if bucket == 8192:
        assert [s[2] for s in got.segments] == [3978, 3480, 2728, 2040]


def test_unported_method_raises():
    spec = tcfg.CompressionSpec(method="streamingllm",
                                quant_method="kvquant")
    with pytest.raises(NotImplementedError, match="queue 1"):
        tpolicy.make_plan(spec, 4, 64, 8)


@pytest.mark.parametrize("scaling", [None, "llama3"])
def test_rope_inv_freq(scaling):
    kw = dict(head_dim=64, rope_theta=500000.0)
    if scaling:
        kw.update(rope_scaling_type="llama3", rope_scaling_factor=8.0,
                  rope_original_max_position=8192)
    want = np.asarray(jllama.rope_inv_freq(jcfg.ModelSpec.tiny(**kw)))
    got = tllama.rope_inv_freq(tcfg.ModelSpec.tiny(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
