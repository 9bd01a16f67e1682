"""Gemma-2 on the port, against the JAX package on the CPU in f32.

The tiny Gemma-2 of ``tests/test_golden_traces.py:96-115``: 4 layers
alternating sliding (window 16) and full attention, GQA 4/2 heads of
D = 16, GeGLU, (1 + w) and post-block norms, scaled and tied embeddings,
``query_pre_attn_scalar`` 32 (scale 32^-0.5, not 16^-0.5) and soft caps of
5 (attention) and 3 (final logits), set low so that the tanh bends the tiny
model's logits.  f32 weights from JAX's ``init_params`` through numpy and
``params_from_numpy``.

- The greedy tokens equal the golden ``gemma2_fullkv`` and ``gemma2_snapkv``
  traces (bucket 64, the golden prompt).
- Each engine case runs a live JAX ``Engine.generate`` and the port's on
  the prompts of ``test_torch_mistral.py`` (bucket 128: 100 / 77 / 30
  tokens, past the window): tokens, decode steps and cache bytes equal,
  last-position prefill logits within 1e-4 (``tests/test_torch_model.py``'s
  bound).  The cases: every method the port admits on Gemma-2 (fullkv,
  snapkv, pyramidkv, streamingllm, l2norm, random, adakv, headkv, cam,
  pivot merging, ``gqa_aggregate``, per-layer capacities), two-pass, the
  chunked bf16 carry (chunk 32), int8 and int4 weights.
- The port's prefill logits match HF's ``Gemma2ForCausalLM`` (eager) on
  ``tests/test_gemma2.py``'s configuration within its 2e-4, with the
  weights through JAX's ``load_params_from_hf`` and the numpy bridge.
- Every cache runs on Gemma-2 (H2O, MInference and ThinK:
  ``test_torch_gemma2_methods.py``; KIVI: ``test_torch_gemma2_kivi.py``);
  KVQuant and 1- or 3-bit KIVI stay refused there as everywhere.

Kernel level, the plain versions the CPU runs with a scale and a cap at
D = 16 and at Gemma-2-9B's D = 256, full and windowed, against JAX's on
the same numpy inputs: the one-pass flash (the wrapper on CPU tensors and
the kernel's schedule ``flash_tiled_plain``, whose tiles are 64 keys at
D = 256) and each ``q_start`` chunk against ``flash_causal_attention(
interpret=True)``, the two-pass schedule against JAX's, pass A's row
maxes (``flash_row_max_plain`` and the kernel's schedule, which caps the
raw max) against JAX's pass A, ``flash_attention_partials`` on self and
history tiles, all within 2e-5 (``test_torch_chunked.py``'s bound); the
decode (the wrapper and the split kernel's schedule) against JAX's
``decode_attention`` within 2e-4 (``test_torch_decode_split.py``'s); and
``window_scores`` against JAX's within 1e-5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.kernels import flash_attention_partials as jax_partials
from pyramidkv_tpu.kernels import flash_causal_attention as jax_flash
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.models import weights as jw
from pyramidkv_tpu.ops import attention as jatt
from pyramidkv_tpu.ops import scoring as jscore
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.kernels import (decode_attention, decode_attn,
                                         flash_attention_partials,
                                         flash_causal_attention)
from pyramidkv_tpu_torch.kernels.flash_prefill import (block_k,
                                                      flash_tiled_plain,
                                                      row_max_tiled_plain)
from pyramidkv_tpu_torch.models import llama as tl
from pyramidkv_tpu_torch.models import weights as tw
from pyramidkv_tpu_torch.models.convert import init_params, params_from_numpy
from pyramidkv_tpu_torch.ops import scoring as tscore
from pyramidkv_tpu_torch.ops.attention import flash_row_max_plain
from pyramidkv_tpu_torch.policy import make_plan
from test_torch_mistral import (BUCKET, _Shared, _assert_same,
                                _prefill_logits, _prompts)
from test_torch_row_max_tiles import _close as _close_row_max
from test_torch_row_max_tiles import _jax_row_max
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CHUNK = 32
TOL = 1e-4      # prefill logits (tests/test_torch_model.py)
HF_TOL = 2e-4   # against HF (tests/test_gemma2.py)
KTOL = 2e-5     # flash and partials (tests/test_torch_chunked.py)
DTOL = 2e-4     # decode (tests/test_torch_decode_split.py)
#: the golden traces' Gemma-2 (tests/test_golden_traces.py:96-115)
GEMMA = dict(name="tiny-gemma2", hidden_act="gelu_tanh",
             query_pre_attn_scalar=32.0, attn_logit_softcapping=5.0,
             final_logit_softcapping=3.0, rmsnorm_unit_offset=True,
             scale_embeddings=True, post_block_norms=True,
             tie_word_embeddings=True, sliding_window=16,
             layer_types=("sliding_attention", "full_attention") * 2)
COMP = dict(max_capacity_prompt=24, window_size=4, kernel_size=5,
            recent_size=8)
HEADKV_CAPS = jcfg.headkv_capacity_from_scores(
    np.random.default_rng(17).random(16).tolist(), 4, 4, 24)

#: name -> (CompressionSpec arguments beyond COMP, EngineSpec arguments,
#: weights): every method the port admits on Gemma-2, then the paths
CASES = {
    **{m: (dict(method=m), {}, "f32") for m in (
        "fullkv", "snapkv", "pyramidkv", "streamingllm", "l2norm", "random",
        "adakv", "cam")},
    "headkv": (dict(method="headkv", head_capacity=HEADKV_CAPS), {}, "f32"),
    "snapkv pivot": (dict(method="snapkv", merge="pivot"), {}, "f32"),
    "snapkv gqa": (dict(method="snapkv", gqa_aggregate=True), {}, "f32"),
    "snapkv layer_capacity": (dict(method="snapkv",
                                   layer_capacity=(40, 24, 16, 9)), {},
                              "f32"),
    "snapkv two-pass": (dict(method="snapkv"), dict(prefill_two_pass=True),
                        "f32"),
    **{f"{m} chunk": (dict(method=m), dict(prefill_chunk=CHUNK), "f32")
       for m in ("fullkv", "snapkv")},
    "snapkv int8": (dict(method="snapkv"), {}, "int8"),
    "snapkv int4": (dict(method="snapkv"), {}, "int4"),
    "fullkv int4": (dict(method="fullkv"), {}, "int4"),
}


@pytest.fixture(scope="module")
def rig():
    """Both packages' specs and params, converted once: f32, int8, int4."""
    js = jcfg.ModelSpec.tiny(**GEMMA)
    jp = jl.init_params(js, jax.random.PRNGKey(42), dtype=jnp.float32)
    trees = {"f32": jp, "int8": jw.quantize_weights(jp, nbits=8),
             "int4": jw.quantize_weights(jp, nbits=4)}
    params = {name: (p, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu"))
        for name, p in trees.items()}
    return js, tcfg.ModelSpec.tiny(**GEMMA), params


@pytest.fixture(scope="module")
def engines(rig):
    """(JAX engine, port engine) per configuration, built once a module.
    JAX's engine prefills through XLA on the CPU whatever
    ``prefill_two_pass`` says, so a two-pass port engine shares the
    one-pass JAX engine of its configuration."""
    js, ts, params = rig
    jax_cache, port_cache = {}, {}

    def get(comp, eng, weights="f32"):
        jp, tp = params[weights]
        comp = dict(COMP, **comp)
        eng = dict(max_new_tokens=8, prefill_buckets=(BUCKET,), **eng)
        jeng = {k: v for k, v in eng.items() if k != "prefill_two_pass"}
        jkey = repr((sorted(comp.items()), sorted(jeng.items()), weights))
        tkey = repr((sorted(comp.items()), sorted(eng.items()), weights))
        if jkey not in jax_cache:
            jax_cache[jkey] = _Shared(JaxEngine(
                js, jcfg.CompressionSpec(**comp), jcfg.EngineSpec(**jeng),
                jp))
        if tkey not in port_cache:
            port_cache[tkey] = Engine(ts, tcfg.CompressionSpec(**comp),
                                      tcfg.EngineSpec(**eng), tp,
                                      device="cpu")
        return jax_cache[jkey], port_cache[tkey]

    return get


@pytest.mark.parametrize("method", ["fullkv", "snapkv"])
def test_golden_traces(rig, method):
    """The golden traces' engine (bucket 64, cap 16, window 4, kernel 5)
    on the port: the pinned ``gemma2_<method>`` tokens."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__),
                           "golden_traces.json")) as f:
        golden = json.load(f)
    _, ts, params = rig
    eng = Engine(ts, tcfg.CompressionSpec(method=method,
                                          max_capacity_prompt=16,
                                          window_size=4, kernel_size=5),
                 tcfg.EngineSpec(max_new_tokens=8, prefill_buckets=(64,)),
                 params["f32"][1], device="cpu")
    out = eng.generate([golden["_prompt"]]).tokens[0]
    assert out == golden[f"gemma2_{method}"], (method, out)


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax_engine(engines, case):
    comp, eng, weights = CASES[case]
    je, te = engines(comp, eng, weights)
    if "chunk" in case:
        assert te.chunked_prefill_supported(BUCKET)
    prompts = _prompts()
    _assert_same(te.generate(prompts), je.generate(prompts))
    got, want = _prefill_logits(je, te, prompts)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_prefill_logits_match_hf(tmp_path):
    """``tests/test_gemma2.py``'s HF Gemma-2 (4 layers, window 8, caps 5
    and 3, query_pre_attn_scalar 32, eager attention) through JAX's loader
    and ``params_from_numpy``: the port's last-position prefill logits
    within 2e-4 of HF's on 24 tokens (past the window)."""
    from pyramidkv_tpu.models.loader import (load_params_from_hf,
                                             spec_from_hf_dir)
    from test_gemma2 import _tiny_hf_gemma2

    model, d = _tiny_hf_gemma2(tmp_path)
    jspec = spec_from_hf_dir(d)
    jp = load_params_from_hf(d, jspec, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    spec = tcfg.ModelSpec(**{f: getattr(jspec, f)
                             for f in jspec.__dataclass_fields__})
    assert spec.mixed_sliding and "lm_head" not in tp
    n = 24
    ids = np.random.default_rng(0).integers(0, 128, size=(1, n))
    with torch.no_grad():
        ref = model(torch.tensor(ids)).logits.float().numpy()
    plan = make_plan(tcfg.CompressionSpec(method="fullkv"),
                     spec.num_hidden_layers, n, 4)
    logits, _ = tl.prefill(tp, spec, plan, torch.from_numpy(ids),
                           torch.tensor([n], dtype=torch.int32))
    np.testing.assert_allclose(logits.numpy()[0], ref[0, -1], rtol=HF_TOL,
                               atol=HF_TOL)


def test_refusals(rig):
    """On Gemma-2 every method and every KIVI cache (group and pa, 2/4/8
    bits, the f32 route) is admitted since the KIVI region kernels took the
    scale and the cap; what stays refused there is what is refused
    everywhere: KVQuant's outliers and 1- or 3-bit KIVI (ROADMAP queue
    1 #6).  The full-width preset passes ``check_ported``; Mixtral's MoE
    stays refused."""
    _, ts, params = rig
    es = tcfg.EngineSpec(max_new_tokens=8, prefill_buckets=(BUCKET,))
    for comp in (dict(method="h2o"), dict(method="minference"),
                 dict(method="think"),
                 dict(method="fullkv", quant_method="kivi", nbits=4),
                 dict(method="snapkv", quant_method="kivi", nbits=2,
                      q_layout="pa"),
                 dict(method="h2o", quant_method="kivi", nbits=8)):
        Engine(ts, tcfg.CompressionSpec(**dict(COMP, **comp)), es,
               params["f32"][1], device="cpu")
    Engine(ts, tcfg.CompressionSpec(**dict(COMP, method="fullkv",
                                           quant_method="kivi", nbits=4)),
           tcfg.EngineSpec(max_new_tokens=8, prefill_buckets=(BUCKET,),
                           use_quant_kernel=True), params["f32"][1],
           device="cpu")
    for comp in (dict(method="snapkv", quant_method="kvquant"),
                 dict(method="fullkv", quant_method="kivi", nbits=3)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 #6"):
            Engine(ts, tcfg.CompressionSpec(**dict(COMP, **comp)), es,
                   params["f32"][1], device="cpu")
    tl.check_ported(tcfg.ModelSpec.preset("gemma2-9b"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 #5d"):
        tl.check_ported(tcfg.ModelSpec.preset("mixtral-8x7b"))


def test_weight_leaves(rig):
    """The bridge carries ``attn_post_norm`` / ``mlp_post_norm`` and the
    tied embedding (no lm_head); ``quantize_weights`` keeps the four norms
    as floats, bit for bit with JAX's; the port's seeded ``init_params``
    draws Gemma-2's leaves as JAX's does: (1 + w) norms at 0, no lm_head."""
    _, ts, params = rig
    jp, tp = params["f32"]
    assert "lm_head" not in tp and tp["embed"].shape == (ts.vocab_size, 64)
    q4 = tw.quantize_weights(tp, nbits=4)
    j4 = params["int4"][0]
    for name in ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm"):
        np.testing.assert_array_equal(tp["layers"][name].numpy(),
                                      np.asarray(jp["layers"][name]))
        assert not isinstance(q4["layers"][name], tw.QuantW)
        np.testing.assert_array_equal(q4["layers"][name].numpy(),
                                      np.asarray(j4["layers"][name]))
    spec = tcfg.ModelSpec.preset("gemma2-9b", num_hidden_layers=1,
                                 hidden_size=64, intermediate_size=32,
                                 vocab_size=48)
    p = init_params(spec, torch.Generator().manual_seed(0), "cpu",
                    torch.float32)
    assert "lm_head" not in p
    for name in ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm"):
        assert tuple(p["layers"][name].shape) == (1, 64)
        assert not p["layers"][name].any()
    assert not p["final_norm"].any()
    assert tuple(p["layers"]["wq"].shape) == (1, 64, 16 * 256)


# ---------------------------------------------------------------------------
# Kernel level: the plain versions with a scale and a cap, D = 16 and 256
# ---------------------------------------------------------------------------

#: (scale, cap) of the kernel cases: the tiny model's, and Gemma-2-9B's
#: scale with a cap low enough to bend logits of these inputs
CAPS = {16: (32.0 ** -0.5, 5.0), 256: (1.0 / 16, 5.0)}


def _qkv(d, n=128, nq=None, b=2, h=4, hk=2, seed=0):
    """Random q, k, v; q scaled so the logits reach the cap."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, nq or n, d)) * 2.0).astype(np.float32)
    k, v = (rng.normal(size=(b, hk, n, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("d,window", [(16, None), (16, 48), (256, None),
                                      (256, 48)])
def test_flash_softcap_matches_pallas(d, window, monkeypatch):
    """One pass (the wrapper and ``flash_tiled_plain``), every q_start
    chunk of 64, the two-pass schedule, and pass A's row maxes
    (``flash_row_max_plain`` and ``row_max_tiled_plain``) with Gemma-2's
    scale and cap, against JAX's kernels in interpret mode; batch row 0 is
    90 tokens (its first 38 rows are padding: undefined)."""
    scale, cap = CAPS[d]
    n, c = 128, 64
    q, k, v = _qkv(d, n, seed=d + (window or 0))
    lens = np.asarray([90, 128], np.int32)
    kw = dict(sliding_window=window, scale=scale, softcap=cap)
    jkw = dict(block_q=32, block_k=32, interpret=True, **kw)
    rows = slice(n - 90, None)

    def close(got, want, r=rows):
        got = got.numpy()
        np.testing.assert_allclose(got[0, :, r], want[0, :, r], rtol=KTOL,
                                   atol=KTOL)
        np.testing.assert_allclose(got[1], want[1], rtol=KTOL, atol=KTOL)

    args = (q, k, v, lens)
    targs = tuple(map(torch.from_numpy, args))
    want = np.asarray(jax_flash(*map(jnp.asarray, args), **jkw))
    for got in (flash_causal_attention(*targs, **kw),
                flash_tiled_plain(*targs, **kw)):
        close(got, want)
    want2 = np.asarray(jax_flash(*map(jnp.asarray, args), two_pass=True,
                                 **jkw))
    close(flash_causal_attention(*targs, two_pass=True, **kw), want2)
    pallas = _jax_row_max(q, k, lens, monkeypatch, **kw)
    for got in (flash_row_max_plain(targs[0], targs[1], targs[3], **kw),
                row_max_tiled_plain(targs[0], targs[1], targs[3], **kw)):
        for bi, t in enumerate(lens):
            _close_row_max(got.numpy()[bi:bi + 1], pallas[bi:bi + 1], n - t)
    for i in range(n // c):
        m = (i + 1) * c
        args = (q[:, :, i * c:m], k[:, :, :m], v[:, :, :m], lens - (n - m))
        want = np.asarray(jax_flash(*map(jnp.asarray, args), q_start=i * c,
                                    **jkw))
        targs = tuple(map(torch.from_numpy, args))
        for got in (flash_causal_attention(*targs, q_start=i * c, **kw),
                    flash_tiled_plain(*targs, q_start=i * c, **kw)):
            close(got, want, slice(max(0, n - 90 - i * c), None))
    assert block_k(d) == (64 if d == 256 else 128)


@pytest.mark.parametrize("d,q_start,window", [(16, 0, None), (16, 96, 48),
                                              (256, 0, 48), (256, 64, None)])
def test_partials_softcap_matches_pallas(d, q_start, window):
    """``flash_attention_partials`` (the wrapper and the kernel's schedule)
    with Gemma-2's scale and cap on a causal self tile and on a history
    tile ``q_start`` rows before its queries, against JAX's in interpret
    mode (base-2 statistics)."""
    scale, cap = CAPS[d]
    q, k, v = _qkv(d, n=64, seed=q_start + d)
    lens = np.asarray([64, 40], np.int32)
    kw = dict(q_start=q_start, sliding_window=window, scale=scale,
              softcap=cap)
    targs = tuple(map(torch.from_numpy, (q, k, v, lens)))
    want = jax_partials(*map(jnp.asarray, (q, k, v, lens)), block_q=64,
                        block_k=32, interpret=True, **kw)
    for part in (flash_attention_partials(*targs, **kw),
                 flash_tiled_plain(*targs, partials=True, **kw)):
        for g, w in zip(part, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=KTOL,
                                       atol=KTOL)


@pytest.mark.parametrize("d,g,nsplit,s", [(16, 2, 1, 50), (16, 1, 3, 175),
                                          (256, 2, 3, 160),
                                          (256, 1, 5, 300)])
def test_decode_softcap_matches_jax(d, g, nsplit, s):
    """The decode with Gemma-2's scale and cap: the wrapper on CPU tensors
    and the split kernel's schedule (several splits, a wholly masked split,
    a row masked everywhere) against JAX's ``decode_attention``."""
    scale, cap = CAPS[d]
    rng = np.random.default_rng(s + g)
    b, hk = 2, 2
    q = (rng.normal(size=(b, hk * g, d)) * 2.0).astype(np.float32)
    k, v = (rng.normal(size=(b, hk, s, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random(size=(b, hk, s)) < 0.6
    rows = decode_attn.TILE
    if nsplit > 1:
        mask[0, 1, rows:2 * rows] = False   # a wholly masked split
    mask[1, 1] = False                      # a row masked everywhere
    want = np.asarray(jatt.decode_attention(
        *map(jnp.asarray, (q, k, v, mask)), scale=scale, softcap=cap))
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    kw = dict(scale=scale, softcap=cap)
    for got in (decode_attention(*t, **kw),
                decode_attn.decode_attention_split_plain(
                    *t, nsplit, max(rows, s) if nsplit == 1 else rows,
                    **kw)):
        np.testing.assert_allclose(got.numpy(), want, rtol=DTOL, atol=DTOL)


def test_decode_split_plan_is_one_wave_at_d256():
    """At D = 256 the kernel holds one block an SM (a 192 KB ring), so the
    plan fills the H100's 132 SMs once: Gemma-2's fullkv cache at the 8k
    batch (4 x 8 regions of 8224 slots, G = 2) in 4 splits of 2112 (a
    split takes up to 64 tiles at D = 256: the 32 of D = 128 would make 5
    splits, two waves), snapkv's (4 x 16 regions of 2080, G = 1) in 2 of
    1088."""
    cpu = torch.device("cpu")
    assert decode_attn.blocks_per_sm(1, 256) == 1
    assert decode_attn.blocks_per_sm(2, 256) == 1
    assert decode_attn.blocks_per_sm(2) == 2
    assert decode_attn.decode_split_plan(cpu, 32, 8224, 2, 256) == (4, 2112)
    assert decode_attn.decode_split_plan(cpu, 64, 2080, 1, 256) == (2, 1088)
    for bhk, s in ((32, 8224), (64, 2080), (4, 4100), (1, 1)):
        nsplit, rows = decode_attn.decode_split_plan(cpu, bhk, s, 2, 256)
        assert (nsplit - 1) * rows < s <= nsplit * rows
        assert bhk * nsplit <= 132 or rows == 64 * decode_attn.TILE
    assert decode_attn.GROUPS_BY_DIM[256] == (1, 2)


@pytest.mark.parametrize("aggregation", ["sum", "mean"])
def test_window_scores_scale_softcap(aggregation):
    """``window_scores`` with Gemma-2's scale and cap (applied before the
    mask, JAX ``ops/scoring.py:90-100``) against JAX's."""
    rng = np.random.default_rng(3)
    b, h, hk, n, d = 2, 4, 2, 96, 16
    q = (rng.normal(size=(b, h, n, d)) * 2.0).astype(np.float32)
    k = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    lens = np.asarray([96, 50], np.int32)
    kw = dict(window_size=8, kernel_size=5, pooling="maxpool",
              aggregation=aggregation, scale=32.0 ** -0.5, softcap=5.0)
    want = np.asarray(jscore.window_scores(
        jnp.asarray(q), jnp.asarray(k), true_len=jnp.asarray(lens), **kw))
    got = tscore.window_scores(torch.from_numpy(q), torch.from_numpy(k),
                               true_len=torch.from_numpy(lens), **kw).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    live = ~np.isinf(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)
