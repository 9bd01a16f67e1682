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
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.models.convert import params_from_numpy

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
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _engines(params, method):
    jp, tp = params
    je = JaxEngine(jcfg.ModelSpec.tiny(),
                   jcfg.CompressionSpec(method=method, **COMP),
                   jcfg.EngineSpec(**ENG), jp)
    te = Engine(tcfg.ModelSpec.tiny(),
                tcfg.CompressionSpec(method=method, **COMP),
                tcfg.EngineSpec(**ENG), tp, device="cpu")
    return je, te


@pytest.mark.parametrize("method", METHODS)
def test_golden_trace(params, method):
    with open(GOLDEN) as f:
        golden = json.load(f)
    _, te = _engines(params, method)
    assert te.generate([golden["_prompt"]]).tokens[0] == golden[method]


@pytest.mark.parametrize("method", METHODS)
def test_generate_matches_jax_engine(params, method):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (60, 37, 12)]
    je, te = _engines(params, method)
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
               tcfg.EngineSpec(prefill_chunk=16, **ENG),
               tcfg.EngineSpec(speculative="ngram", **ENG)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(spec, comp, es, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(spec, tcfg.CompressionSpec(method="h2o", **COMP),
               tcfg.EngineSpec(**ENG), tp, device="cpu")
