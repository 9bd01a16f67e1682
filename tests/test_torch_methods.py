"""The port's ``Engine.generate`` for streamingllm, l2norm, random, AdaKV,
HeadKV, CAM, pivot merging, ThinK, GQA aggregation and per-layer capacities
against the golden traces and a live JAX ``Engine.generate``, on the CPU in
f32: greedy tokens, decode steps and cache bytes must be equal.
(The chunked prefill of these methods: ``test_torch_methods_chunked.py``.)
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from pyramidkv_tpu_torch.policy import PORTED_METHODS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_traces.json")
#: the golden-trace configuration (tests/test_golden_traces.py)
COMP = dict(max_capacity_prompt=16, window_size=4, kernel_size=5,
            recent_size=8, minference_vertical_size=16,
            minference_slash_size=16, minference_last_q=8)
#: its variant traces (snapkv_gqa, snapkv_pivot) set only these
VCOMP = dict(max_capacity_prompt=16, window_size=4)
ENG = dict(max_new_tokens=8, prefill_buckets=(64,))

GOLDEN_CASES = {
    "streamingllm": dict(method="streamingllm", **COMP),
    "l2norm": dict(method="l2norm", **COMP),
    "adakv": dict(method="adakv", **COMP),
    "think": dict(method="think", **COMP),
    "cam": dict(method="cam", **COMP),
    "random": dict(method="random", **COMP),
    "snapkv_gqa": dict(method="snapkv", gqa_aggregate=True, **VCOMP),
    "snapkv_pivot": dict(method="snapkv", merge="pivot", **VCOMP),
}

#: seeded synthetic retrieval-head scores (the real priors are not in the
#: repository): one per (layer, head) of the tiny spec
HEADKV_CAPS = jcfg.headkv_capacity_from_scores(
    np.random.default_rng(17).random(16).tolist(), 4, 4, 16)

#: (name, CompressionSpec arguments beyond COMP, generate's rng_seed)
LIVE_CASES = [
    ("streamingllm", dict(method="streamingllm"), 0),
    ("l2norm", dict(method="l2norm"), 0),
    ("l2norm-noskip", dict(method="l2norm", skip_layers=()), 0),
    ("random-seed0", dict(method="random"), 0),
    ("random-seed7", dict(method="random"), 7),
    ("adakv", dict(method="adakv"), 0),
    ("headkv", dict(method="headkv", head_capacity=HEADKV_CAPS), 0),
    ("cam", dict(method="cam"), 0),
    ("snapkv-pivot", dict(method="snapkv", merge="pivot"), 0),
    ("think-narrow", dict(method="think"), 0),
    ("think-dense", dict(method="think", think_dense=True), 0),
    ("think-kivi4", dict(method="think", quant_method="kivi", nbits=4), 0),
    ("snapkv-gqa", dict(method="snapkv", gqa_aggregate=True), 0),
    ("h2o-gqa", dict(method="h2o", gqa_aggregate=True), 0),
    ("snapkv-layer-capacity",
     dict(method="snapkv", layer_capacity=(40, 24, 16, 9)), 0),
]


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(42),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def test_every_method_is_ported():
    assert tuple(PORTED_METHODS) == tuple(jcfg.METHODS)


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_golden_trace(params, name):
    with open(GOLDEN) as f:
        golden = json.load(f)
    te = Engine(tcfg.ModelSpec.tiny(),
                tcfg.CompressionSpec(**GOLDEN_CASES[name]),
                tcfg.EngineSpec(**ENG), params[1], device="cpu")
    assert te.generate([golden["_prompt"]]).tokens[0] == golden[name]


@pytest.mark.parametrize("name,kw,seed", LIVE_CASES,
                         ids=[c[0] for c in LIVE_CASES])
def test_generate_matches_jax_engine(params, name, kw, seed):
    jp, tp = params
    comp = dict(COMP, **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (60, 37, 12)]
    je = JaxEngine(jcfg.ModelSpec.tiny(), jcfg.CompressionSpec(**comp),
                   jcfg.EngineSpec(**ENG), jp)
    te = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                tcfg.EngineSpec(**ENG), tp, device="cpu")
    # an EOS id a prompt's sequence emits mid-way (not as its first token,
    # whose EOS is suppressed), so the done / -1 / early-exit paths run
    eos = next(t for seq in je.generate(prompts, rng_seed=seed).tokens
               for t in seq[2:] if t != seq[0])
    want = je.generate(prompts, eos_token_ids=[eos], rng_seed=seed)
    got = te.generate(prompts, eos_token_ids=[eos], rng_seed=seed)
    assert got.tokens == want.tokens
    assert got.decode_steps == want.decode_steps
    assert got.kv_cache_bytes == want.kv_cache_bytes
    assert any(len(t) < ENG["max_new_tokens"] for t in got.tokens)


def test_think_narrow_cache_layout(params):
    """The narrow layout's cache: pruned keys at D_kept channels, K holding
    the rest, V full length, and fewer bytes than the dense layout."""
    tp = params[1]

    def run(**kw):
        eng = Engine(tcfg.ModelSpec.tiny(),
                     tcfg.CompressionSpec(method="think", **COMP, **kw),
                     tcfg.EngineSpec(**ENG), tp, device="cpu")
        return eng, eng.generate([list(range(1, 61))])

    narrow, out = run()
    _, dense = run(think_dense=True)
    plan = narrow.plan_for(64)
    assert plan.think_narrow and plan.think_pruned_slots == 8
    d_kept = 16 - int(16 * 0.4)
    # K's pruned slots shrink from D to D_kept channels; the kept-channel
    # indices (int32) are added
    l, b, h = 4, 1, 4
    sp = plan.think_pruned_slots
    assert dense.kv_cache_bytes - out.kv_cache_bytes == (
        l * b * h * sp * (16 - d_kept) * 4 - l * b * h * d_kept * 4)


def test_random_seed_changes_selection(params):
    tp = params[1]
    eng = Engine(tcfg.ModelSpec.tiny(),
                 tcfg.CompressionSpec(method="random", **COMP),
                 tcfg.EngineSpec(**ENG), tp, device="cpu")
    prompt = [list(range(1, 61))]
    runs = {s: eng.generate(prompt, rng_seed=s).tokens for s in (0, 0, 7, 9)}
    assert eng.generate(prompt, rng_seed=0).tokens == runs[0]
    assert len({tuple(map(tuple, t)) for t in runs.values()}) > 1
