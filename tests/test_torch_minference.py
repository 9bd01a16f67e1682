"""MInference's vertical-and-slash sparse prefill on the port against the
JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
JAX block-sparse Pallas kernels run in interpret mode, the JAX ``Engine``
on the CPU (``impl="xla"``, which runs them in interpret mode too).  On CPU
tensors the port's kernel wrappers run their plain versions.

Tolerances:
- the pattern, the tile lists and the gathered K/V are exact (the top-k
  ties break toward the lower index in both packages);
- f32 partials and outputs within 2e-5 (relative and absolute): the two
  packages sum the same f32 terms in other orders (D <= 32 dots, softmax
  over <= 256 keys), ~1e-6 apart;
- bf16 operands within one bf16 ulp of the row (2^-7 of its largest
  element): p is rounded to bf16 at the same running max on both sides, so
  a rounding can only flip where the f32 p values differ in their last bit.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.kernels import block_sparse_prefill as jk
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.models import weights as jw
from pyramidkv_tpu.ops import sparse_prefill as js
from pyramidkv_tpu.policy import make_plan as jax_make_plan
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.kernels import block_sparse_prefill as tk
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from pyramidkv_tpu_torch.ops import sparse_prefill as ts
from pyramidkv_tpu_torch.policy import make_plan
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_traces.json")
TOL = 2e-5
#: one estimation case: GQA, a top-k cut inside the buffer (n = 256)
B, H, HK, N, D, LAST_Q = 1, 4, 2, 256, 16, 8
#: per-head budgets (vertical, slash) and the maxima they imply
VSZ, SSZ = [8, 32, 16, 24], [16, 8, 64, 32]


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _pattern_np(p):
    return [np.asarray(x) for x in p]


def _to_torch_pattern(p):
    return ts.VerticalSlashPattern(*(torch.from_numpy(np.array(x))
                                     for x in p))


def _qkv(seed, h=H, hk=HK, n=N, d=D):
    rng = np.random.default_rng(seed)
    return _normal(rng, B, h, n, d), _normal(rng, B, hk, n, d), \
        _normal(rng, B, hk, n, d)


def _budgets(per_head: bool):
    if per_head:
        return dict(vertical_size=VSZ, slash_size=SSZ,
                    max_vertical=max(VSZ), max_slash=max(SSZ))
    return dict(vertical_size=12, slash_size=8)


def _estimate_both(q, k, true_len, per_head, **kw):
    tl = np.asarray([true_len], np.int32)
    bud = _budgets(per_head)
    jbud = dict(bud)
    tbud = dict(bud)
    if per_head:
        jbud.update(vertical_size=jnp.asarray(VSZ, jnp.int32),
                    slash_size=jnp.asarray(SSZ, jnp.int32))
        tbud.update(vertical_size=torch.tensor(VSZ, dtype=torch.int32),
                    slash_size=torch.tensor(SSZ, dtype=torch.int32))
    want = js.estimate_vertical_slash(
        jnp.asarray(q), jnp.asarray(k), true_len=jnp.asarray(tl),
        last_q=LAST_Q, **jbud, **kw)
    got = ts.estimate_vertical_slash(
        torch.from_numpy(q), torch.from_numpy(k),
        true_len=torch.from_numpy(tl), last_q=LAST_Q, **tbud, **kw)
    return want, got


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("true_len", [N, 200, 5])  # full, ragged, < last_q
def test_estimate_matches_jax(per_head, true_len):
    q, k, _ = _qkv(1)
    want, got = _estimate_both(q, k, true_len, per_head)
    vert, slash, vidx, vvalid = _pattern_np(want)
    np.testing.assert_array_equal(got.vert.numpy(), vert)
    np.testing.assert_array_equal(got.slash.numpy(), slash)
    np.testing.assert_array_equal(got.vert_valid.numpy(), vvalid)
    np.testing.assert_array_equal(np.where(vvalid, got.vert_idx.numpy(), -1),
                                  np.where(vvalid, vidx, -1))
    assert got.vert_idx.dtype == torch.int32
    # sinks and the local band are always kept
    pad = N - true_len
    assert bool(got.vert[0, :, pad:pad + min(4, true_len)].all())
    assert bool(got.slash[0, :, :LAST_Q + 1].all())


def test_estimate_with_scale_and_softcap_matches_jax():
    q, k, _ = _qkv(2)
    want, got = _estimate_both(q, k, 200, False, scale=0.35, softcap=8.0)
    for w, g in zip(_pattern_np(want)[:2], (got.vert, got.slash)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("true_len", [128, 100])
def test_tile_selection_matches_jax(true_len):
    """n = 128, q_block = k_tile = 16, budget 3: 8 q-blocks of 8 k-tiles,
    so the budget cuts causal tiles (and the coverage scores tie)."""
    q, k, _ = _qkv(3, n=128)
    tl = jnp.asarray([true_len], jnp.int32)
    pat = js.estimate_vertical_slash(jnp.asarray(q), jnp.asarray(k),
                                     true_len=tl, vertical_size=12,
                                     slash_size=8, last_q=LAST_Q)
    ti, tv = js._slash_tile_selection(pat, 128, 16, 16, 3)
    got_i, got_v = ts._slash_tile_selection(_to_torch_pattern(pat), 128, 16,
                                            16, 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ti))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(tv))
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.bool
    # valid-first per list, which the db kernel relies on
    v = got_v.numpy()
    assert (np.sort(v, axis=-1)[..., ::-1] == v).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_matches_jax(dtype):
    _, k, v = _qkv(4)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, N, size=(B, H, 128)).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    wk, wv = js.gather_vertical_kv(jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                   jnp.asarray(idx))
    gk, gv = ts.gather_vertical_kv(torch.from_numpy(k).to(tdt),
                                   torch.from_numpy(v).to(tdt),
                                   torch.from_numpy(idx))
    assert gk.dtype == tdt and tuple(gk.shape) == (B, H, 128, D)
    np.testing.assert_array_equal(gk.float().numpy(),
                                  np.asarray(wk, np.float32))
    np.testing.assert_array_equal(gv.float().numpy(),
                                  np.asarray(wv, np.float32))


def _assert_partials_close(got, want, dtype="float32"):
    """acc / l, m and l of two partials triples."""
    acc_g, m_g, l_g = (np.asarray(x, np.float64) for x in got)
    acc_w, m_w, l_w = (np.asarray(x, np.float64) for x in want)
    og = acc_g / np.maximum(l_g, 1e-30)[..., None]
    ow = acc_w / np.maximum(l_w, 1e-30)[..., None]
    np.testing.assert_allclose(m_g, m_w, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l_g, l_w, rtol=TOL, atol=TOL)
    if dtype == "float32":
        np.testing.assert_allclose(og, ow, rtol=TOL, atol=TOL)
    else:
        ulp = 2.0 ** -7 * np.abs(ow).max(axis=-1, keepdims=True)
        assert (np.abs(og - ow) <= ulp + 1e-30).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("true_len", [N, 150])
def test_vertical_plain_matches_pallas(dtype, true_len):
    q, k, v = _qkv(6)
    want_pat, pat = _estimate_both(q, k, true_len, True)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tl = np.asarray([true_len], np.int32)
    jkv = js.gather_vertical_kv(jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                want_pat.vert_idx)
    want = jk.vertical_attention_partials_kernel(
        jnp.asarray(q, jdt), *jkv, want_pat.vert_idx, want_pat.vert_valid,
        jnp.asarray(tl), q_block=64, interpret=True)
    tkv = ts.gather_vertical_kv(torch.from_numpy(k).to(tdt),
                                torch.from_numpy(v).to(tdt), pat.vert_idx)
    args = (torch.from_numpy(q).to(tdt), *tkv, pat.vert_idx, pat.vert_valid,
            torch.from_numpy(tl))
    got = tk.vertical_attention_partials(*args)  # CPU: the plain version
    _assert_partials_close(got, want, dtype)
    plain = ts.vertical_attention_partials_plain(*args)
    for a, b_ in zip(got, plain):
        assert torch.equal(a, b_)
    # padding rows see nothing: m = float32.min, l = 0, acc = 0
    pad = N - true_len
    assert bool((got[1][:, :, :pad] == torch.finfo(torch.float32).min).all())
    assert bool((got[2][:, :, :pad] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("true_len", [128, 100])
def test_slash_plain_matches_both_pallas_kernels(dtype, true_len):
    """The inputs of tests/test_minference.py's grid-vs-db test: GQA
    (H=4, Hk=2), q_block = k_tile = 16, budget 3."""
    b, h, hk, n, d = 1, 4, 2, 128, 16
    rng = np.random.default_rng(11)
    q = _normal(rng, b, h, n, d)
    k = _normal(rng, b, hk, n, d)
    v = _normal(rng, b, hk, n, d)
    tl = np.asarray([true_len], np.int32)
    pat = js.estimate_vertical_slash(jnp.asarray(q), jnp.asarray(k),
                                     true_len=jnp.asarray(tl),
                                     vertical_size=12, slash_size=8,
                                     last_q=8)
    ti, tv = js._slash_tile_selection(pat, n, 16, 16, 3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = (jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
             ti, tv, pat.vert, jnp.asarray(tl))
    targs = (torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
             torch.from_numpy(v).to(tdt), torch.from_numpy(np.asarray(ti)),
             torch.from_numpy(np.asarray(tv)),
             torch.from_numpy(np.asarray(pat.vert)), torch.from_numpy(tl))
    kw = dict(q_block=16, k_tile=16)
    got = tk.slash_tile_attention(*targs, **kw)
    got_db = tk.slash_tile_attention_db(*targs, **kw)
    for a, b_ in zip(got, got_db):
        assert torch.equal(a, b_)
    for kern in (jk.slash_tile_attention, jk.slash_tile_attention_db):
        want = kern(*jargs, interpret=True, **kw)
        _assert_partials_close(got, want, dtype)


def _sparse_both(q, k, v, true_len, *, per_head=False, sem=None,
                 slash_impl="grid", **kw):
    tl = np.asarray([true_len], np.int32)
    sem = sem or {}
    h = q.shape[1]
    if per_head:
        vsz, ssz = VSZ[:h], SSZ[:h]
        jb = dict(vertical_size=jnp.asarray(vsz, jnp.int32),
                  slash_size=jnp.asarray(ssz, jnp.int32),
                  max_vertical=max(vsz), max_slash=max(ssz))
        tb = dict(vertical_size=torch.tensor(vsz, dtype=torch.int32),
                  slash_size=torch.tensor(ssz, dtype=torch.int32),
                  max_vertical=max(vsz), max_slash=max(ssz))
    else:
        jb = tb = dict(vertical_size=12, slash_size=8)
    jpat = js.estimate_vertical_slash(jnp.asarray(q), jnp.asarray(k),
                                      true_len=jnp.asarray(tl), last_q=8,
                                      **jb, **sem)
    want = np.asarray(js.sparse_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpat,
        true_len=jnp.asarray(tl), interpret=True, slash_impl=slash_impl,
        **kw, **sem))
    tq, tkk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ttl = torch.from_numpy(tl)
    tpat = ts.estimate_vertical_slash(tq, tkk, true_len=ttl, last_q=8, **tb,
                                      **sem)
    got = ts.sparse_prefill_attention(tq, tkk, tv, tpat, true_len=ttl,
                                      slash_impl=slash_impl, **kw, **sem)
    oracle = ts.sparse_prefill_attention_dense(tq, tkk, tv, tpat,
                                               true_len=ttl, **kw, **sem)
    pad = q.shape[2] - true_len
    return got.numpy()[:, :, pad:], want[:, :, pad:], \
        oracle.numpy()[:, :, pad:]


@pytest.mark.parametrize("slash_impl", ["grid", "db"])
@pytest.mark.parametrize("true_len", [128, 100])
def test_sparse_attention_matches_jax_and_oracle(slash_impl, true_len):
    rng = np.random.default_rng(12)
    q, k, v = (_normal(rng, 1, 2, 128, 16) for _ in range(3))
    got, want, oracle = _sparse_both(q, k, v, true_len,
                                     slash_impl=slash_impl, q_block=16,
                                     k_tile=16, tile_budget=3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


def test_sparse_attention_gqa_per_head_budgets():
    """Per-head budgets, grouped K/V, the default q_block / k_tile (the gcd
    fallback makes them 256 at n = 256)."""
    q, k, v = _qkv(6)
    got, want, oracle = _sparse_both(q, k, v, 200, per_head=True,
                                     tile_budget=4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("slash_impl", ["grid", "db"])
def test_sparse_attention_scale_and_softcap(slash_impl):
    """The inputs of tests/test_minference.py's Gemma-2 semantics test:
    scale and softcap through the estimation and both plain partials."""
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, 1, 2, 128, 16) for _ in range(3))
    sem = dict(scale=0.35, softcap=8.0)
    kw = dict(q_block=16, k_tile=16, tile_budget=3, slash_impl=slash_impl)
    got, want, oracle = _sparse_both(q, k, v, 100, sem=sem, **kw)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)
    plain, _, _ = _sparse_both(q, k, v, 100, **kw)
    assert np.abs(got - plain).max() > 1e-3  # softcap did something


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

#: the golden-trace configuration (tests/test_golden_traces.py)
COMP = dict(max_capacity_prompt=16, window_size=4, kernel_size=5,
            recent_size=8, minference_vertical_size=16,
            minference_slash_size=16, minference_last_q=8)
ENG = dict(max_new_tokens=8, prefill_buckets=(64,))


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(42),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _generate_both(jp, tp, comp, eng, prompts):
    want = JaxEngine(jcfg.ModelSpec.tiny(), jcfg.CompressionSpec(**comp),
                     jcfg.EngineSpec(**eng), jp).generate(prompts)
    got = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                 tcfg.EngineSpec(**eng), tp, device="cpu").generate(prompts)
    return got, want


def _pcfg(layers=4):
    """tests/test_minference.py's per-head config: heads alternate
    vertical budgets 24 / 8, slash 16."""
    return tuple(tuple((8 if hi % 2 else 24, 16) for hi in range(4))
                 for _ in range(layers))


@pytest.mark.parametrize("case", ["bucket64", "per_head", "slash_db",
                                  "kivi4"])
def test_sparse_generate_matches_jax_engine(params, case):
    """The sparse path (minference_dense_below=0) at bucket 64, where the gcd
    fallback makes one 64-key tile: the uniform budgets, the per-head
    config, the db slash kernel, and a KIVI cache (the JAX group region
    kernel forced on, as tests/test_torch_engine.py does)."""
    jp, tp = params
    comp = dict(COMP, method="minference", minference_dense_below=0)
    if case == "per_head":
        comp["minference_pattern_config"] = _pcfg()
    if case == "slash_db":
        comp["minference_slash_impl"] = "db"
    if case == "kivi4":
        comp.update(quant_method="kivi", nbits=4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (60, 37, 12)]
    jl._FORCE_QUANT_KERNEL[0] = case == "kivi4"
    try:
        # the port's group regions on the f32 kernels, as JAX's forced
        got, want = _generate_both(jp, tp, comp, dict(
            ENG, use_quant_kernel=case == "kivi4"), prompts)
    finally:
        jl._FORCE_QUANT_KERNEL[0] = False
    assert got.tokens == want.tokens
    assert got.decode_steps == want.decode_steps
    assert got.kv_cache_bytes == want.kv_cache_bytes


def test_sparse_generate_bucket1024_tile_budget2(params):
    """Bucket 1024: q_block 512 and k_tile 256 give 2 q-blocks of 4 k-tiles
    and a budget of 2 cuts causal tiles."""
    jp, tp = params
    comp = dict(method="minference", minference_dense_below=0,
                minference_tile_budget=2, minference_vertical_size=64,
                minference_slash_size=32, minference_last_q=16)
    eng = dict(max_new_tokens=4, prefill_buckets=(1024,))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (1000, 700)]
    got, want = _generate_both(jp, tp, comp, eng, prompts)
    assert got.tokens == want.tokens
    assert got.kv_cache_bytes == want.kv_cache_bytes


def test_sparse_generate_int4_matches_jax_engine(params):
    jp, _ = params
    jq = jw.quantize_weights(jp, nbits=4)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                           device="cpu")
    comp = dict(COMP, method="minference", minference_dense_below=0)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (60, 23)]
    got, want = _generate_both(jq, tq, comp, ENG, prompts)
    assert got.tokens == want.tokens


def test_golden_minference_trace(params):
    """The golden fixture runs bucket 64, below minference_dense_below: the
    dense path."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    te = Engine(tcfg.ModelSpec.tiny(),
                tcfg.CompressionSpec(method="minference", **COMP),
                tcfg.EngineSpec(**ENG), params[1], device="cpu")
    assert te.generate([golden["_prompt"]]).tokens[0] == golden["minference"]


def test_dense_pattern_recovers_fullkv(params):
    """With pattern sizes >= N every column is vertical: the sparse prefill
    is the dense one, and generation equals fullkv's."""
    _, tp = params
    ids = [int(x) for x in np.random.default_rng(5).integers(0, 256, size=40)]
    outs = []
    for method, kw in (("fullkv", {}),
                       ("minference", dict(minference_vertical_size=64,
                                           minference_slash_size=64,
                                           minference_dense_below=0))):
        eng = Engine(tcfg.ModelSpec.tiny(),
                     tcfg.CompressionSpec(method=method, **kw),
                     tcfg.EngineSpec(max_new_tokens=6, prefill_buckets=(64,)),
                     tp, device="cpu")
        outs.append(eng.generate([ids]).tokens[0])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("bucket", [64, 1024])
def test_plan_and_cache_layout_match_jax(params, bucket):
    """minference keeps fullkv's layout: window 0, width = bucket, KV-head
    storage; the port's prefill cache equals its fullkv cache."""
    comp = dict(method="minference", minference_dense_below=0)
    jplan = jax_make_plan(jcfg.CompressionSpec(**comp), 4, bucket, 8)
    plan = make_plan(tcfg.CompressionSpec(**comp), 4, bucket, 8)
    for f in ("width", "window", "decode_slots", "segments", "prefill_slots",
              "total_slots"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.width == bucket and plan.window == 0
    if bucket != 64:
        return
    from pyramidkv_tpu_torch.models import llama as tl_

    _, tp = params
    spec = tcfg.ModelSpec.tiny()
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(1, 256, size=(2, 64)))
    tlen = torch.tensor([64, 20], dtype=torch.int32)
    _, cache = tl_.prefill(tp, spec, plan, tokens, tlen)
    fplan = make_plan(tcfg.CompressionSpec(method="fullkv"), 4, 64, 8)
    _, fcache = tl_.prefill(tp, spec, fplan, tokens, tlen)
    assert tuple(cache.k.shape) == (4, 2, spec.num_key_value_heads, 72, 16)
    for a, b_ in ((cache.mask, fcache.mask),
                  (cache.positions, fcache.positions)):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_cuda_block_sparse_kernels_match_plain_on_card():
    """The three CUDA kernels against their plain versions in bf16 at a
    small shape, the vertical one under a logit cap too (runs only where a
    card and nvcc are present;
    ``chip_smoke.py`` covers the main-path shapes): acc / l within
    2^-6 |want| + 2^-5 rms(row), m within 2^-12 max(1, |m|), l within
    2^-10 l."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, hk, n = 2, 8, 2, 1024
    q, k, v = (torch.randn((b, hh, n, 128), generator=g, device=dev).to(
        torch.bfloat16) for hh in (h, hk, hk))
    tl = torch.tensor([1024, 300], dtype=torch.int32, device=dev)
    pat = ts.estimate_vertical_slash(q, k, true_len=tl, vertical_size=100,
                                     slash_size=50)
    ti, tv = ts._slash_tile_selection(pat, n, 512, 256, 2)
    kv_ = ts.gather_vertical_kv(k, v, pat.vert_idx)
    cases = [
        (tk.vertical_attention_partials, ts.vertical_attention_partials_plain,
         (q, *kv_, pat.vert_idx, pat.vert_valid, tl), {}),
        (tk.slash_tile_attention, ts.slash_tile_attention_plain,
         (q, k, v, ti, tv, pat.vert, tl), dict(q_block=512, k_tile=256)),
        (tk.slash_tile_attention_db, ts.slash_tile_attention_plain,
         (q, k, v, ti, tv, pat.vert, tl), dict(q_block=512, k_tile=256)),
        # an attention logit cap (Gemma-2's) is taken since it was ported
        (tk.vertical_attention_partials, ts.vertical_attention_partials_plain,
         (q, *kv_, pat.vert_idx, pat.vert_valid, tl), dict(softcap=8.0)),
    ]
    for kern, plain, args, kw in cases:
        before = kern.launches
        got, want = kern(*args, **kw), plain(*args, **kw)
        assert kern.launches == before + 1
        og = got[0] / got[2].clamp_min(1e-30)[..., None]
        ow = want[0] / want[2].clamp_min(1e-30)[..., None]
        rms = ow.square().mean(-1, keepdim=True).sqrt()
        assert bool(((og - ow).abs() <= 2.0 ** -6 * ow.abs()
                     + 2.0 ** -5 * rms + 1e-30).all())
        assert bool(((got[1] - want[1]).abs()
                     <= 2.0 ** -12 * want[1].abs().clamp_min(1.0)).all())
        assert bool(((got[2] - want[2]).abs() <= 2.0 ** -10 * want[2]).all())
