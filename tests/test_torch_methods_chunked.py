"""The chunked prefill (bf16 carry) of AdaKV, StreamingLLM, random, CAM and
ThinK: the port's chunked engine against JAX's chunked engine on the CPU in
f32 (tokens, decode steps and cache bytes equal), and the methods the carry
refuses falling back to the monolithic prefill as JAX's do."""

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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: the bf16-carry tests' configuration (tests/test_torch_chunked.py)
COMP = dict(max_capacity_prompt=64, window_size=8)
ENG = dict(max_new_tokens=16, prefill_buckets=(256,))

#: (name, CompressionSpec arguments, generate's rng_seed); streamingllm's
#: window is cap - 4 = 60 <= the chunk; ThinK reads the last 32 queries,
#: so its window is 32
CASES = [
    ("adakv", dict(method="adakv", **COMP), 0),
    ("streamingllm", dict(method="streamingllm", **COMP), 0),
    ("random", dict(method="random", **COMP), 3),
    ("cam", dict(method="cam", **COMP), 0),
    ("think-w32", dict(method="think", max_capacity_prompt=64,
                       window_size=32), 0),
]


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).tolist() for n in (179, 233, 20)]


@pytest.mark.parametrize("name,comp,seed", CASES, ids=[c[0] for c in CASES])
def test_chunked_generate_matches_jax_engine(params, name, comp, seed):
    jp, tp = params
    je = JaxEngine(jcfg.ModelSpec.tiny(), jcfg.CompressionSpec(**comp),
                   jcfg.EngineSpec(prefill_chunk=64, **ENG), jp)
    te = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                tcfg.EngineSpec(prefill_chunk=64, **ENG), tp, device="cpu")
    assert je.chunked_prefill_supported(256)
    assert te.chunked_prefill_supported(256)
    want = je.generate(_prompts(), rng_seed=seed)
    got = te.generate(_prompts(), rng_seed=seed)
    assert got.tokens == want.tokens
    assert got.decode_steps == want.decode_steps
    assert got.kv_cache_bytes == want.kv_cache_bytes


def test_chunked_support_matches_jax(params):
    """Which plans take the bf16 carry: JAX's list, ThinK only with a
    window of at least 32."""
    jp, tp = params
    for method in jcfg.METHODS:
        for window in (8, 32):
            comp = dict(method=method, max_capacity_prompt=64,
                        window_size=window)
            if method == "headkv":
                comp["head_capacity"] = jcfg.headkv_capacity_from_scores(
                    [1.0] * 16, 4, 4, 64)
            je = JaxEngine(jcfg.ModelSpec.tiny(),
                           jcfg.CompressionSpec(**comp),
                           jcfg.EngineSpec(prefill_chunk=64, **ENG), jp)
            te = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                        tcfg.EngineSpec(prefill_chunk=64, **ENG), tp,
                        device="cpu")
            assert (te.chunked_prefill_supported(256)
                    == je.chunked_prefill_supported(256)), (method, window)
