"""The port's two-pass flash schedule (``flash_causal_attention(
two_pass=True)``: pass A ``flash_row_max``, pass B ``flash_pass_b``) against
the JAX package's Pallas kernels in interpret mode, on the CPU.

On the CPU the wrappers run their plain versions (``ops/attention.py``'s
``flash_row_max_plain`` and ``flash_pass_b_plain``), which the CUDA kernels
are held to on the card.  Inputs are made with numpy from a seed and handed
to both packages in f32; the tolerances are the JAX tests' own
(``tests/test_kernels.py``: 2e-4 on the rows past the pad; the tiny model's
logits within ``tests/test_torch_model.py``'s 1e-4).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu import policy as jpolicy
from pyramidkv_tpu.kernels.flash_prefill import (
    flash_causal_attention as jax_flash)
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch import policy as tpolicy
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.kernels import (flash_causal_attention,
                                         flash_pass_b, flash_row_max)
from pyramidkv_tpu_torch.models import llama as tl
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
_NEG = float(np.finfo(np.float32).min)


def _rand(b, h, hk, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, n, d)).astype(np.float32),
            rng.normal(size=(b, hk, n, d)).astype(np.float32),
            rng.normal(size=(b, hk, n, d)).astype(np.float32))


def _both(q, k, v, tl_, **kw):
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(tl_), block_q=32, block_k=32, interpret=True,
                     two_pass=True, **kw)
    got = flash_causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(tl_),
                                 two_pass=True, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("true_len", [128, 100, 17])
@pytest.mark.parametrize("hk", [3, 1])
def test_two_pass_plain_matches_pallas(true_len, hk):
    """``tests/test_kernels.py::test_flash_two_pass_matches_xla``'s inputs
    (B=2, H=3, D=64, N=128), and with all three heads on one KV head."""
    n = 128
    q, k, v = _rand(2, 3, hk, n, 64, 11)
    tl_ = np.asarray([true_len, max(true_len - 9, 1)], np.int32)
    got, want = _both(q, k, v, tl_)
    for bi in range(2):
        pad = n - int(tl_[bi])
        np.testing.assert_allclose(got[bi, :, pad:], want[bi, :, pad:],
                                   rtol=2e-4, atol=2e-4)


def test_two_pass_sliding_window_matches_pallas():
    n = 128
    q, k, v = _rand(2, 3, 3, n, 64, 12)
    tl_ = np.asarray([n, n - 40], np.int32)
    got, want = _both(q, k, v, tl_, sliding_window=48)
    for bi in range(2):
        pad = n - int(tl_[bi])
        np.testing.assert_allclose(got[bi, :, pad:], want[bi, :, pad:],
                                   rtol=2e-4, atol=2e-4)


def test_two_pass_q_start_matches_one_pass():
    """A prefill chunk's shape (queries at columns [q_start, N)): the two
    passes against the one-pass plain version on the same rows."""
    n, c = 128, 64
    q, k, v = _rand(2, 4, 2, n, 32, 13)
    tl_ = torch.tensor([n, 70], dtype=torch.int32)
    qc = torch.from_numpy(q[:, :, n - c:].copy())
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = flash_causal_attention(qc, kt, vt, tl_, q_start=n - c,
                                 two_pass=True)
    want = flash_causal_attention(qc, kt, vt, tl_, q_start=n - c)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_row_max_and_pass_b_definitions():
    """Pass A's m is the max of the base-2 logits (q scaled by
    log2(e)/sqrt(D)) over the visible keys, float32.min on a row with none;
    pass B writes 0 there and acc / l elsewhere."""
    n, d = 64, 16
    q, k, v = _rand(1, 2, 2, n, d, 14)
    tl_ = torch.tensor([40], dtype=torch.int32)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    m = flash_row_max(qt, kt, tl_)
    s = np.einsum("bhqd,bhkd->bhqk", q * (np.log2(np.e) / np.sqrt(d)), k)
    pad = n - 40
    rows, cols = np.arange(n)[:, None], np.arange(n)[None, :]
    vis = (cols <= rows) & (cols >= pad)
    want = np.where(vis, s, -np.inf).max(-1)
    np.testing.assert_allclose(m[..., pad:].numpy(), want[..., pad:],
                               rtol=1e-6, atol=1e-6)
    assert (m[..., :pad] == _NEG).all()
    out = flash_pass_b(qt, kt, vt, m, tl_)
    assert (out[..., :pad, :] == 0).all()
    p = np.where(vis, np.exp2(s - want[..., None]), 0.0)[..., pad:, :]
    np.testing.assert_allclose(
        out[..., pad:, :].numpy(), p @ v / p.sum(-1, keepdims=True),
        rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(7),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.mark.parametrize("method", ["snapkv", "fullkv"])
def test_prefill_two_pass_matches_jax(params, method):
    """``llama.prefill(prefill_two_pass=True)`` against JAX's prefill
    through its two Pallas kernels (interpret mode), bucket 64."""
    jp, tp = params
    kw = dict(method=method, max_capacity_prompt=16, window_size=4,
              kernel_size=5)
    jplan = jpolicy.make_plan(jcfg.CompressionSpec(**kw), 4, 64, 4)
    tplan = tpolicy.make_plan(tcfg.CompressionSpec(**kw), 4, 64, 4)
    tokens = np.random.default_rng(0).integers(0, 256, size=(3, 64)).astype(
        np.int32)
    tlen = np.asarray([64, 40, 17], np.int32)
    jlog, jcache = jl.prefill(jp, jcfg.ModelSpec.tiny(), jplan,
                              jnp.asarray(tokens), jnp.asarray(tlen),
                              attention_impl="pallas_interpret",
                              prefill_two_pass=True)
    tlog, tcache = tl.prefill(tp, tcfg.ModelSpec.tiny(), tplan,
                              torch.from_numpy(tokens),
                              torch.from_numpy(tlen), prefill_two_pass=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    for name in ("mask", "positions"):
        np.testing.assert_array_equal(getattr(tcache, name).numpy(),
                                      np.asarray(getattr(jcache, name)))
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("method", ["snapkv", "pyramidkv"])
def test_engine_two_pass_same_tokens(params, method):
    """The engine with ``prefill_two_pass=True`` gives the greedy tokens of
    the one-pass prefill."""
    _, tp = params
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (60, 37, 12)]
    comp = tcfg.CompressionSpec(method=method, max_capacity_prompt=16,
                                window_size=4, kernel_size=5)
    out = [Engine(tcfg.ModelSpec.tiny(), comp, tcfg.EngineSpec(
        max_new_tokens=8, prefill_buckets=(64,), prefill_two_pass=tp_),
        tp, device="cpu").generate(prompts) for tp_ in (False, True)]
    assert out[0].tokens == out[1].tokens
    assert out[0].kv_cache_bytes == out[1].kv_cache_bytes
