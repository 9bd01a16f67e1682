"""The port's ``Engine.generate`` against a live JAX ``Engine.generate`` and
the golden traces, on the CPU in f32 (greedy tokens must match exactly)."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.models import weights as jw
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from pyramidkv_tpu_torch.models.weights import quantize_weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_traces.json")
METHODS = ["fullkv", "snapkv", "pyramidkv"]
#: the golden-trace configuration (tests/test_golden_traces.py)
COMP = dict(max_capacity_prompt=16, window_size=4, kernel_size=5,
            recent_size=8)
ENG = dict(max_new_tokens=8, prefill_buckets=(64,))


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(42),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.fixture(scope="module")
def engines(params):
    """(JAX engine, port engine) per method, built once a module and
    shared by the tests that run it."""
    cache = {}

    def get(method):
        if method not in cache:
            jp, tp = params
            cache[method] = (
                JaxEngine(jcfg.ModelSpec.tiny(),
                          jcfg.CompressionSpec(method=method, **COMP),
                          jcfg.EngineSpec(**ENG), jp),
                Engine(tcfg.ModelSpec.tiny(),
                       tcfg.CompressionSpec(method=method, **COMP),
                       tcfg.EngineSpec(**ENG), tp, device="cpu"))
        return cache[method]

    return get


@pytest.mark.parametrize("method", METHODS)
def test_golden_trace(engines, method):
    with open(GOLDEN) as f:
        golden = json.load(f)
    _, te = engines(method)
    assert te.generate([golden["_prompt"]]).tokens[0] == golden[method]


@pytest.mark.parametrize("method", METHODS)
def test_generate_matches_jax_engine(engines, method):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (60, 37, 12)]
    je, te = engines(method)
    # an EOS id the model emits mid-sequence for the first prompt, so the
    # done / -1 / early-exit paths run
    eos = je.generate(prompts).tokens[0][2]
    want = je.generate(prompts, eos_token_ids=[eos])
    got = te.generate(prompts, eos_token_ids=[eos])
    assert got.tokens == want.tokens
    assert got.decode_steps == want.decode_steps
    assert got.kv_cache_bytes == want.kv_cache_bytes
    assert any(len(t) < ENG["max_new_tokens"] for t in got.tokens)


def test_unported_engine_options_raise(params):
    _, tp = params
    spec = tcfg.ModelSpec.tiny()
    comp = tcfg.CompressionSpec(method="snapkv", **COMP)
    for es in (tcfg.EngineSpec(greedy=False, **ENG),
               tcfg.EngineSpec(speculative="ngram", **ENG)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(spec, comp, es, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(spec, tcfg.CompressionSpec(method="snapkv",
                                          quant_method="kvquant", **COMP),
               tcfg.EngineSpec(**ENG), tp, device="cpu")
    # a uniform window and Gemma-2's alternating sliding and full layers
    # are ported (tests/test_torch_mistral.py, test_torch_gemma2.py), H2O
    # over alternating windows too (test_torch_gemma2_methods.py), and a
    # KIVI cache over them (test_torch_gemma2_kivi.py)
    alt = tcfg.ModelSpec.tiny(
        sliding_window=32,
        layer_types=("sliding_attention", "full_attention") * 2)
    Engine(alt, comp, tcfg.EngineSpec(**ENG), tp, device="cpu")
    Engine(alt, tcfg.CompressionSpec(method="h2o", **COMP),
           tcfg.EngineSpec(**ENG), tp, device="cpu")
    Engine(alt, tcfg.CompressionSpec(method="h2o", quant_method="kivi",
                                     nbits=4, **COMP),
           tcfg.EngineSpec(**ENG), tp, device="cpu")


# ---------------------------------------------------------------------------
# Quantized weights (models/weights.py)
# ---------------------------------------------------------------------------

#: the golden int-weight traces' configuration (tests/test_golden_traces.py)
QCOMP = dict(max_capacity_prompt=16, window_size=4)


@pytest.mark.parametrize("name,kw", [
    ("snapkv_int8w", dict(nbits=8)),
    ("snapkv_int4w", dict(nbits=4)),
    ("snapkv_int4w_g16", dict(nbits=4, group_size=16)),
])
def test_quantized_golden_trace(params, name, kw):
    with open(GOLDEN) as f:
        golden = json.load(f)
    te = Engine(tcfg.ModelSpec.tiny(),
                tcfg.CompressionSpec(method="snapkv", **QCOMP),
                tcfg.EngineSpec(**ENG),
                quantize_weights(params[1], **kw), device="cpu")
    assert te.generate([golden["_prompt"]]).tokens[0] == golden[name]


#: span-128 widths, so the packed layout and fusion are those of real models
WIDE = dict(hidden_size=256, intermediate_size=512, num_attention_heads=8,
            num_key_value_heads=4, head_dim=64, vocab_size=512)
QUANT = {
    "int4": dict(nbits=4, lm_head_nbits=4, lm_head_pad_to=384),
    "int4-g128": dict(nbits=4, group_size=128),
    "int8": dict(nbits=8),
}


@pytest.fixture(scope="module")
def wide_params():
    return jl.init_params(jcfg.ModelSpec.tiny(**WIDE), jax.random.PRNGKey(11),
                          dtype=jnp.float32)


@pytest.fixture(scope="module")
def quant_trees(wide_params):
    """Each QUANT format's fused JAX tree and its port twin, quantized and
    converted once a module (shared by the fullkv and snapkv cases)."""
    cache = {}

    def get(quant):
        if quant not in cache:
            jq = jw.fuse_packed_matmuls(jw.quantize_weights(wide_params,
                                                            **QUANT[quant]))
            cache[quant] = jq, params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jq), device="cpu")
        return cache[quant]

    return get


@pytest.mark.parametrize("method", ["fullkv", "snapkv"])
@pytest.mark.parametrize("quant", list(QUANT))
def test_quantized_generate_matches_jax_engine(quant_trees, quant, method):
    """The JAX engine with its int4/int8 kernels forced on (interpret mode)
    against the port's CPU engine on the same quantized tree, fused as the
    runners fuse it: int4 with a padded int4 lm_head, int4 with 128-row
    groups and the int8 lm_head, int8."""
    jq, tq = quant_trees(quant)
    comp = dict(method=method, **COMP)
    # The int8 kernels round x to bf16 (both packages), so an f32 difference
    # of ~1e-7 between the two flips a rounding now and then: one activation
    # moves by 2^-9 and a logit by ~1e-4.  Prompt seed 6 met such a near-tie
    # (int8, fullkv, row 3, step 4: top-2 gap 6.2e-4, the argmax flipped);
    # seeds 7, 8 and 9 have none, and 7 is used.
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (60, 37, 12)]
    jw._FORCE_INT4_KERNEL[0] = jw._FORCE_INT8_KERNEL[0] = True
    try:
        want = JaxEngine(jcfg.ModelSpec.tiny(**WIDE),
                         jcfg.CompressionSpec(**comp), jcfg.EngineSpec(**ENG),
                         jq).generate(prompts)
    finally:
        jw._FORCE_INT4_KERNEL[0] = jw._FORCE_INT8_KERNEL[0] = False
    te = Engine(tcfg.ModelSpec.tiny(**WIDE), tcfg.CompressionSpec(**comp),
                tcfg.EngineSpec(**ENG), tq, device="cpu")
    got = te.generate(prompts)
    assert got.tokens == want.tokens
    assert got.kv_cache_bytes == want.kv_cache_bytes


# ---------------------------------------------------------------------------
# KIVI-quantized KV cache (ops/quant.py and the region kernels)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,nbits", [("snapkv_kivi4", 4),
                                        ("snapkv_kivi2", 2)])
def test_kivi_golden_trace(params, name, nbits):
    with open(GOLDEN) as f:
        golden = json.load(f)
    te = Engine(tcfg.ModelSpec.tiny(),
                tcfg.CompressionSpec(method="snapkv", quant_method="kivi",
                                     nbits=nbits, **QCOMP),
                tcfg.EngineSpec(**ENG), params[1], device="cpu")
    assert te.generate([golden["_prompt"]]).tokens[0] == golden[name]


#: KIVI formats: (nbits, layout).  pa runs at bucket 256 (snapkv cap 200),
#: where the JAX pa kernel's plane widths are multiples of 128
#: (tests/test_quant_fused_kernel.py:94-123), so its Pallas kernel runs.
KIVI = {"kivi4": (4, "group"), "kivi2": (2, "group"),
        "kivi8-pa": (8, "pa"), "kivi4-pa": (4, "pa")}


@pytest.mark.parametrize("method", ["fullkv", "snapkv"])
@pytest.mark.parametrize("fmt", list(KIVI) + ["kivi4-default"])
def test_kivi_generate_matches_jax_engine(params, fmt, method):
    """The JAX engine with its region kernels forced on (interpret mode:
    ``_FORCE_QUANT_KERNEL`` for group regions, ``_FORCE_QUANT_FUSED_KERNEL``
    for pa) against the port's CPU engine on the same route (group: the f32
    kernels, ``use_quant_kernel``); ``kivi4-default``: both engines' default
    group route (the factored dequantization with bf16 folds).  Tokens,
    decode steps and cache bytes (region codes, scales and zeros plus the
    bf16 decode slots)."""
    jp, tp = params
    default = fmt == "kivi4-default"
    nbits, layout = KIVI["kivi4" if default else fmt]
    pa = layout == "pa"
    comp = dict(method=method, quant_method="kivi", nbits=nbits,
                q_layout=layout, max_capacity_prompt=200 if pa else 16,
                window_size=8 if pa else 4)
    eng = dict(max_new_tokens=8, prefill_buckets=(256,) if pa else (64,))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 256, size=n).tolist()
               for n in ((250, 211, 40) if pa else (60, 37, 12))]
    force = jl._FORCE_QUANT_FUSED_KERNEL if pa else jl._FORCE_QUANT_KERNEL
    force[0] = not default
    try:
        want = JaxEngine(jcfg.ModelSpec.tiny(), jcfg.CompressionSpec(**comp),
                         jcfg.EngineSpec(**eng), jp).generate(prompts)
    finally:
        force[0] = False
    f32 = dict(use_quant_kernel=not (pa or default))
    got = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                 tcfg.EngineSpec(**eng, **f32), tp,
                 device="cpu").generate(prompts)
    assert got.tokens == want.tokens
    assert got.decode_steps == want.decode_steps
    assert got.kv_cache_bytes == want.kv_cache_bytes


def test_kivi_counterfactual_knobs_raise(params):
    spec = tcfg.ModelSpec.tiny()
    kivi = dict(method="snapkv", quant_method="kivi", nbits=4, **QCOMP)
    for layout, es in (("group", dict(use_quant_scan=True)),
                       ("pa", dict(use_quant_scan=True))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(spec, tcfg.CompressionSpec(q_layout=layout, **kivi),
                   tcfg.EngineSpec(**es, **ENG), params[1], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(spec, tcfg.CompressionSpec(
            method="snapkv", quant_method="kvquant", **QCOMP),
            tcfg.EngineSpec(**ENG), params[1], device="cpu")
    # the routes the port runs are accepted: use_quant_fused names the
    # default of both layouts, use_quant_kernel / use_quant_tiled the f32
    # group kernels
    for layout in ("pa", "group"):
        Engine(spec, tcfg.CompressionSpec(q_layout=layout, **kivi),
               tcfg.EngineSpec(use_quant_kernel=True, use_quant_tiled=True,
                               use_quant_fused=True,
                               use_quant_fused_kernel=True, **ENG),
               params[1], device="cpu")
    assert not Engine(spec, tcfg.CompressionSpec(q_layout="group", **kivi),
                      tcfg.EngineSpec(use_quant_kernel=True,
                                      use_quant_fused=True, **ENG),
                      params[1], device="cpu").f32_quant


# ---------------------------------------------------------------------------
# The KIVI group layout's default route against the JAX engine's default
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params0():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.mark.parametrize("case", ["pyramidkv kivi2", "fullkv kivi2 chunk 64"])
def test_kivi_group_default_matches_jax_default(params0, case):
    """Live JAX engines on their default KIVI group route (no
    ``_FORCE_QUANT_KERNEL``: ``ops/quant.py::quant_region_attention_fused``,
    bf16-rounded folds) against the port's default: the inputs on which the
    port's former default (the f32 kernels) gave request 0 the tokens 40,
    208, 101, 90 against JAX's 40, 208, 101, 61 (pyramidkv), and differed
    at request 0's token 7 (fullkv, chunked)."""
    jp, tp = params0
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (179, 233, 20)]
    kivi = dict(quant_method="kivi", nbits=2, q_group_size=16,
                q_layout="group")
    if case.startswith("pyramidkv"):
        comp = dict(method="pyramidkv", max_capacity_prompt=64,
                    window_size=8, **kivi)
        eng = dict(max_new_tokens=16, prefill_buckets=(256,))
    else:
        comp = dict(method="fullkv", **kivi)
        eng = dict(max_new_tokens=16, prefill_buckets=(256,),
                   prefill_chunk=64)
    want = JaxEngine(jcfg.ModelSpec.tiny(), jcfg.CompressionSpec(**comp),
                     jcfg.EngineSpec(**eng), jp).generate(prompts)
    te = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                tcfg.EngineSpec(**eng), tp, device="cpu")
    assert not te.f32_quant
    got = te.generate(prompts)
    assert got.tokens == want.tokens
    assert got.decode_steps == want.decode_steps
    assert got.kv_cache_bytes == want.kv_cache_bytes
    if case.startswith("pyramidkv"):
        assert got.tokens[0][:4] == [40, 208, 101, 61]
