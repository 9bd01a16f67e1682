"""Gemma-2's H2O, MInference and ThinK on the port, against the JAX package
on the CPU in f32.

Engine level, the tiny Gemma-2 of ``test_torch_gemma2.py`` (4 layers
alternating sliding (window 16) and full attention, GQA 4/2 heads of
D = 16, ``query_pre_attn_scalar`` 32, attention cap 5 and final cap 3),
f32 weights converted once: a live JAX ``Engine.generate`` and the port's
on the same prompts, greedy tokens, decode steps and cache bytes equal, the
last-position prefill logits within 1e-4 (``tests/test_torch_model.py``'s
bound).  The cases: ``h2o`` with and without ``gqa_aggregate`` (its scores
with the scale and the cap: JAX's XLA scorer, the port's H2O kernel
wrapper, whose plain version runs on CPU tensors); ``minference`` on the
sparse path (``minference_dense_below=0``: the full layers sparse, the
sliding ones the windowed dense attention) at bucket 128 (one 128-key
tile) and at bucket 512 with ``minference_tile_budget=1`` (q_block 512,
k_tile 256: the budget drops a causal tile); ``think`` (its narrow decode
with the scale and the cap); ``h2o`` with ``prefill_chunk`` 32 (the second
pass's partial scores with the scale and the cap).

Function level, on seeded numpy inputs through both packages, q drawn
large enough that the cap bends the logits (each case also checks that the
uncapped function lies outside the tolerance):
- the plain H2O scores (``ops.scoring.h2o_scores``, ``h2o_partial_scores``
  chunk by chunk, the stats/colsum pair and the kernels' schedule
  ``h2o_tiled_plain``) with a scale and a cap against JAX's
  ``ops/scoring.py::h2o_scores`` / ``h2o_partial_scores`` at D = 64 and
  256, within 2e-5 (relative and absolute: the base-2 schedule and JAX's
  natural softmax sum the same f32 terms in other orders);
- the plain slash, db slash and vertical partials with Gemma-2-9B's scale
  and a cap at D = 256 against the Pallas kernels in interpret mode, within
  ``test_torch_minference.py``'s 2e-5 (the db function also on lists that
  are not valid-first);
- ``decode_attention_think`` with a scale and a cap against JAX's, within
  2e-5.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pyramidkv_tpu.kernels import block_sparse_prefill as jk
from pyramidkv_tpu.ops import attention as jatt
from pyramidkv_tpu.ops import scoring as jscore
from pyramidkv_tpu.ops import sparse_prefill as js
from pyramidkv_tpu_torch.kernels import block_sparse_prefill as tk
from pyramidkv_tpu_torch.kernels.h2o_scores import h2o_tiled_plain
from pyramidkv_tpu_torch.ops import attention as tatt
from pyramidkv_tpu_torch.ops import scoring as tscore
from test_torch_gemma2 import engines, rig  # noqa: F401 (module fixtures)
from test_torch_mistral import _assert_same, _prefill_logits, _prompts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4      # prefill logits (tests/test_torch_model.py)
FTOL = 2e-5     # f32 functions (tests/test_torch_minference.py)
#: Gemma-2-9B's attention scale and a cap low enough to bend these logits
SCALE, CAP = 1.0 / 16, 5.0
COMP = dict(max_capacity_prompt=24, window_size=4, kernel_size=5,
            recent_size=8, minference_vertical_size=16,
            minference_slash_size=16, minference_last_q=8)

#: name -> (CompressionSpec arguments beyond COMP, EngineSpec arguments)
CASES = {
    "h2o": (dict(method="h2o"), {}),
    "h2o gqa": (dict(method="h2o", gqa_aggregate=True), {}),
    "minference sparse": (dict(method="minference",
                               minference_dense_below=0), {}),
    "think": (dict(method="think"), {}),
    "h2o chunk": (dict(method="h2o"), dict(prefill_chunk=32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax_engine(engines, case):  # noqa: F811
    comp, eng = CASES[case]
    je, te = engines(dict(COMP, **comp), eng)
    assert te.chunked_prefill_supported(128) == ("chunk" in case)
    prompts = _prompts()
    _assert_same(te.generate(prompts), je.generate(prompts))
    got, want = _prefill_logits(je, te, prompts)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_minference_tile_budget_matches_jax_engine(rig):  # noqa: F811
    """Bucket 512: q_block 512 and k_tile 256 give one q-block of 2
    k-tiles, and a budget of 1 drops one of them on the full layers."""
    from pyramidkv_tpu import config as jcfg
    from pyramidkv_tpu.engine import Engine as JaxEngine
    from pyramidkv_tpu_torch import config as tcfg
    from pyramidkv_tpu_torch.engine import Engine

    js_, ts_, params = rig
    jp, tp = params["f32"]
    comp = dict(COMP, method="minference", minference_dense_below=0,
                minference_tile_budget=1)
    eng = dict(max_new_tokens=4, prefill_buckets=(512,))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (500, 380)]
    want = JaxEngine(js_, jcfg.CompressionSpec(**comp),
                     jcfg.EngineSpec(**eng), jp).generate(prompts)
    got = Engine(ts_, tcfg.CompressionSpec(**comp), tcfg.EngineSpec(**eng),
                 tp, device="cpu").generate(prompts)
    _assert_same(got, want)


def _h2o_inputs(d, n, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(2, 4, n, d)) * 2.0).astype(np.float32)
    k = rng.normal(size=(2, 2, n, d)).astype(np.float32)
    return q, k, np.asarray([n, n - 70], np.int32)


def _close_scores(got, want, tol=FTOL):
    got = np.asarray(got)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    live = ~np.isinf(want)
    np.testing.assert_allclose(got[live], want[live], rtol=tol, atol=tol)


@pytest.mark.parametrize("d,n", [(64, 192), (256, 128)])
def test_h2o_scores_scale_softcap_matches_jax(d, n):
    """Every plain H2O function with a scale and a cap against JAX's XLA
    scorer (the cap before the masks: the padding rows of batch row 1 and
    the W x W block's causal part)."""
    w = 8
    q, k, lens = _h2o_inputs(d, n, d + n)
    kw = dict(window_size=w, scale=SCALE, softcap=CAP)
    want = np.asarray(jscore.h2o_scores(jnp.asarray(q), jnp.asarray(k),
                                        true_len=jnp.asarray(lens), **kw))
    tq, tk_, tl_ = map(torch.from_numpy, (q, k, lens))
    _close_scores(tscore.h2o_scores(tq, tk_, true_len=tl_, **kw), want)
    m, l = tscore.h2o_row_stats(tq, tk_, true_len=tl_, **kw)
    _close_scores(tscore.h2o_colsum(tq, tk_, m, l, true_len=tl_, **kw),
                  want)
    tm, tl2, tiled = h2o_tiled_plain(tq, tk_, true_len=tl_, **kw)
    _close_scores(tiled, want)
    live = torch.arange(n)[None, :] >= (n - tl_.long())[:, None]
    for got, ref in ((tm, m), (tl2, l)):
        torch.testing.assert_close(got[live[:, None].expand_as(got)],
                                   ref[live[:, None].expand_as(ref)],
                                   rtol=FTOL, atol=FTOL)
    # the second pass of the chunked prefill: chunk by chunk against JAX's
    c = 64
    acc = 0.0
    for r0 in range(0, n, c):
        part = tscore.h2o_partial_scores(tq[:, :, r0:r0 + c], tk_,
                                         row_start=r0, true_len=tl_, **kw)
        jpart = np.asarray(jscore.h2o_partial_scores(
            jnp.asarray(q[:, :, r0:r0 + c]), jnp.asarray(k), row_start=r0,
            true_len=jnp.asarray(lens), **kw))
        np.testing.assert_allclose(part.numpy(), jpart, rtol=FTOL, atol=FTOL)
        acc = acc + part.numpy()
    np.testing.assert_allclose(np.where(np.isinf(want), 0.0, acc),
                               np.where(np.isinf(want), 0.0, want),
                               rtol=FTOL, atol=FTOL)
    # the cap bends these logits: without it the scores are elsewhere
    uncapped = tscore.h2o_scores(tq, tk_, true_len=tl_, window_size=w,
                                 scale=SCALE).numpy()
    live = ~np.isinf(want)
    assert np.abs(uncapped[live] - want[live]).max() > 100 * FTOL


def _sparse_inputs(seed, n=128, d=256):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(1, 4, n, d)) * 2.0).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, n, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _partials_close(got, want):
    acc_g, m_g, l_g = (np.asarray(x, np.float64) for x in got)
    acc_w, m_w, l_w = (np.asarray(x, np.float64) for x in want)
    np.testing.assert_allclose(m_g, m_w, rtol=FTOL, atol=FTOL)
    np.testing.assert_allclose(l_g, l_w, rtol=FTOL, atol=FTOL)
    np.testing.assert_allclose(acc_g / np.maximum(l_g, 1e-30)[..., None],
                               acc_w / np.maximum(l_w, 1e-30)[..., None],
                               rtol=FTOL, atol=FTOL)


@pytest.mark.parametrize("true_len,permute", [(128, False), (100, False),
                                              (100, True)])
def test_block_sparse_softcap_matches_pallas(true_len, permute):
    """The plain slash, db slash and vertical partials at D = 256 with the
    scale and the cap against the Pallas kernels (interpret mode) on one
    estimated pattern; ``permute``: each tile list in a seeded random
    order (not valid-first: the db function's prefix is not the flags)."""
    q, k, v = _sparse_inputs(true_len + permute)
    tl = np.asarray([true_len], np.int32)
    sem = dict(scale=SCALE, softcap=CAP)
    pat = js.estimate_vertical_slash(jnp.asarray(q), jnp.asarray(k),
                                     true_len=jnp.asarray(tl),
                                     vertical_size=12, slash_size=8,
                                     last_q=8, **sem)
    ti, tv = (np.array(x) for x in js._slash_tile_selection(
        pat, 128, 32, 32, 2))
    if permute:
        perm = np.argsort(np.random.default_rng(3).random(ti.shape), -1)
        ti = np.take_along_axis(ti, perm, -1)
        tv = np.take_along_axis(tv, perm, -1)
    kw = dict(q_block=32, k_tile=32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(ti), jnp.asarray(tv), pat.vert, jnp.asarray(tl))
    targs = (*map(torch.from_numpy, (q, k, v, ti, tv)),
             torch.from_numpy(np.asarray(pat.vert)), torch.from_numpy(tl))
    for tfn, jfn in ((tk.slash_tile_attention, jk.slash_tile_attention),
                     (tk.slash_tile_attention_db,
                      jk.slash_tile_attention_db)):
        got = tfn(*targs, **kw, **sem)  # CPU: the plain version
        _partials_close(got, jfn(*jargs, interpret=True, **kw, **sem))
        uncapped = tfn(*targs, **kw, scale=SCALE)
        assert np.abs(uncapped[1].numpy() - got[1].numpy()).max() > 1e-2
    jkv = js.gather_vertical_kv(jnp.asarray(k), jnp.asarray(v),
                                pat.vert_idx)
    want = jk.vertical_attention_partials_kernel(
        jnp.asarray(q), *jkv, pat.vert_idx, pat.vert_valid, jnp.asarray(tl),
        q_block=64, interpret=True, **sem)
    vargs = (torch.from_numpy(q), *(torch.from_numpy(np.asarray(x))
                                    for x in (*jkv, pat.vert_idx,
                                              pat.vert_valid)),
             torch.from_numpy(tl))
    _partials_close(tk.vertical_attention_partials(*vargs, **sem), want)


def test_think_decode_scale_softcap_matches_jax():
    """ThinK's narrow decode with the scale and the cap (both logit blocks
    capped before the mask) against JAX's."""
    rng = np.random.default_rng(21)
    b, h, d, dk, sp_, sr = 2, 4, 16, 8, 24, 12
    q = (rng.normal(size=(b, h, d)) * 3.0).astype(np.float32)
    kp = rng.normal(size=(b, h, sp_, dk)).astype(np.float32)
    kc = np.sort(np.stack([rng.permutation(d)[:dk] for _ in range(b * h)])
                 .reshape(b, h, dk), -1).astype(np.int32)
    kr = rng.normal(size=(b, h, sr, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sp_ + sr, d)).astype(np.float32)
    mask = rng.random(size=(b, h, sp_ + sr)) < 0.7
    args = (q, kp, kc, kr, v, mask)
    kw = dict(scale=32.0 ** -0.5, softcap=CAP)
    want = np.asarray(jatt.decode_attention_think(*map(jnp.asarray, args),
                                                  **kw))
    targs = tuple(map(torch.from_numpy, args))
    got = tatt.decode_attention_think(*targs, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=FTOL, atol=FTOL)
    uncapped = tatt.decode_attention_think(*targs,
                                           scale=32.0 ** -0.5).numpy()
    assert np.abs(uncapped - want).max() > 100 * FTOL
