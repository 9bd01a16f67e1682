"""H2O on the PyTorch/CUDA port against the JAX package, on the CPU.

The scores: the port's ``h2o_scores`` / ``h2o_partial_scores`` against
JAX's, and the plain versions of the port's two H2O kernels (row statistics,
then column sums, base 2) against JAX's ``h2o_scores_pallas`` in interpret
mode, with Hk == H and with GQA, with and without left padding.  Both sides
are f32 and sum the same terms in other orders: scores are sums of up to
N = 128 probabilities, held to 1e-5 relative (plus 1e-6 absolute for the
near-zero ones).  Then ``Engine.generate`` with ``method="h2o"`` against the
golden trace and a live JAX engine (tokens equal).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.kernels.h2o_scores import h2o_scores_pallas
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.ops import scoring as jscoring
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch import kernels
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from pyramidkv_tpu_torch.ops import scoring
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_traces.json")
#: the golden-trace configuration (tests/test_golden_traces.py)
COMP = dict(max_capacity_prompt=16, window_size=4, kernel_size=5,
            recent_size=8)
ENG = dict(max_new_tokens=8, prefill_buckets=(64,))
#: (H, Hk, true_len): per-query-head K, GQA groups of 2 and 4, left pads
#: inside and across tiles, and a prompt shorter than the window
CASES = [(4, 4, (128, 128)), (4, 2, (100, 37)), (8, 2, (128, 5))]


def _inputs(h, hk, true_len, n=128, d=32, seed=0):
    rng = np.random.default_rng(seed + 10 * h + hk)
    q = rng.normal(size=(len(true_len), h, n, d)).astype(np.float32)
    k = rng.normal(size=(len(true_len), hk, n, d)).astype(np.float32)
    return q, k, np.asarray(true_len, np.int32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    # padding columns: -inf (or float32.min in the XLA path) on both sides
    assert np.array_equal(fin, np.isfinite(got) & (got > -1e30))
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("h,hk,true_len", CASES)
def test_h2o_scores_match_jax(h, hk, true_len):
    q, k, tl = _inputs(h, hk, true_len)
    want = jscoring.h2o_scores(jnp.asarray(q), jnp.asarray(k), window_size=8,
                               true_len=jnp.asarray(tl), block=32)
    got = scoring.h2o_scores(torch.from_numpy(q), torch.from_numpy(k),
                             window_size=8, true_len=torch.from_numpy(tl),
                             block=32)
    _close(got.numpy(), want)


@pytest.mark.parametrize("row_start", [0, 64, 96])
def test_h2o_partial_scores_match_jax(row_start):
    q, k, tl = _inputs(4, 2, (100, 60))
    rows = slice(row_start, row_start + 32)
    want = jscoring.h2o_partial_scores(
        jnp.asarray(q[:, :, rows]), jnp.asarray(k), row_start=row_start,
        window_size=8, true_len=jnp.asarray(tl), block=16)
    got = scoring.h2o_partial_scores(
        torch.from_numpy(q[:, :, rows]), torch.from_numpy(k),
        row_start=row_start, window_size=8, true_len=torch.from_numpy(tl),
        block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_h2o_partial_scores_sum_to_the_whole():
    """The chunked prefill's second pass: per-chunk contributions, added,
    equal the one-shot statistic (f32 adds in another order)."""
    q, k, tl = _inputs(4, 2, (100, 128))
    qt, kt, tlt = (torch.from_numpy(x) for x in (q, k, tl))
    acc = sum(scoring.h2o_partial_scores(
        qt[:, :, r:r + 32], kt, row_start=r, window_size=8, true_len=tlt)
        for r in range(0, 128, 32))
    whole = scoring.h2o_scores(qt, kt, window_size=8, true_len=tlt)
    valid = torch.isfinite(whole)
    torch.testing.assert_close(acc[valid], whole[valid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("h,hk,true_len", CASES)
def test_plain_h2o_matches_pallas(h, hk, true_len):
    """The kernel wrappers' plain versions on CPU tensors (the plain score,
    and the two-pass base-2 row stats + column sums the CUDA kernels
    compute) against the Pallas kernel in interpret mode, 32-wide tiles:
    the W x W boundary (row and column 120) falls inside a tile."""
    q, k, tl = _inputs(h, hk, true_len)
    want = h2o_scores_pallas(jnp.asarray(q), jnp.asarray(k), window_size=8,
                             true_len=jnp.asarray(tl), block_q=32, block_k=32,
                             interpret=True)
    qt, kt, tlt = (torch.from_numpy(x) for x in (q, k, tl))
    before = (kernels.h2o_row_stats.launches, kernels.h2o_colsum.launches)
    _close(kernels.h2o_scores(qt, kt, window_size=8, true_len=tlt).numpy(),
           want)
    m, l = kernels.h2o_row_stats(qt, kt, window_size=8, true_len=tlt)
    _close(kernels.h2o_colsum(qt, kt, m, l, window_size=8,
                              true_len=tlt).numpy(), want)
    # CPU calls run the plain versions and count no launch
    assert (kernels.h2o_row_stats.launches,
            kernels.h2o_colsum.launches) == before


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(42),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.mark.parametrize("use_pallas", [True, False])
def test_h2o_golden_trace(params, use_pallas):
    with open(GOLDEN) as f:
        golden = json.load(f)
    te = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(method="h2o",
                                                            **COMP),
                tcfg.EngineSpec(use_pallas=use_pallas, **ENG), params[1],
                device="cpu")
    assert te.generate([golden["_prompt"]]).tokens[0] == golden["h2o"]


def test_h2o_generate_matches_jax_engine(params):
    jp, tp = params
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (60, 37, 12)]
    want = JaxEngine(jcfg.ModelSpec.tiny(),
                     jcfg.CompressionSpec(method="h2o", **COMP),
                     jcfg.EngineSpec(**ENG), jp).generate(prompts)
    got = Engine(tcfg.ModelSpec.tiny(),
                 tcfg.CompressionSpec(method="h2o", **COMP),
                 tcfg.EngineSpec(**ENG), tp, device="cpu").generate(prompts)
    assert got.tokens == want.tokens
    assert got.kv_cache_bytes == want.kv_cache_bytes


def _h2o_err_over_tol(got, want):
    """Largest |got - want| / (2^-6 |want| + 2^-5 rms of want's row) over
    the finite entries (``chip_smoke.py``'s H2O limit; <= 1 passes)."""
    fin = torch.isfinite(want)
    w = want.masked_fill(~fin, 0.0)
    g = got.masked_fill(~fin, 0.0)
    rms = (w.square().sum(-1, keepdim=True)
           / fin.sum(-1, keepdim=True).clamp_min(1)).sqrt()
    lim = (2.0 ** -6 * w.abs() + 2.0 ** -5 * rms).clamp_min(1e-30)
    return float(((g - w).abs() / lim).max())


@pytest.mark.cuda
def test_cuda_h2o_kernels_match_plain_on_card():
    """Both H2O kernels against their plain versions in bf16 on the card,
    with GQA, ragged pads and the W x W boundary inside a tile
    (``chip_smoke.py`` covers the main-path shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, hk, n, d = 2, 8, 2, 384, 128
    q = torch.randn((b, h, n, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, hk, n, d), generator=g, device=dev).bfloat16()
    tl = torch.tensor([384, 150], dtype=torch.int32, device=dev)
    m, l = kernels.h2o_row_stats(q, k, window_size=8, true_len=tl)
    pm, pl = scoring.h2o_row_stats(q, k, window_size=8, true_len=tl)
    valid = (torch.arange(n, device=dev)[None, :]
             >= (n - tl.long())[:, None])[:, None].expand(b, h, n)
    assert float((m - pm)[valid].abs().max()) <= 2.0 ** -12 * max(
        1.0, float(pm[valid].abs().max()))
    assert float(((l - pl) / pl)[valid].abs().max()) <= 2.0 ** -10
    got = kernels.h2o_scores(q, k, window_size=8, true_len=tl)
    want = scoring.h2o_scores(q, k, window_size=8, true_len=tl)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert _h2o_err_over_tol(got, want) <= 1
