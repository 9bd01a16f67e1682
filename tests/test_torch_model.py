"""The port's Llama prefill and decode against the JAX package.

Same params (the JAX tree through the weight bridge), same tokens; f32 on
both sides.  Logits and cache values agree to 1e-4: the same f32 products
summed in other orders over a 4-layer tiny model.  Masks and positions must
match exactly (a different selection would show there first).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu import policy as jpolicy
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch import policy as tpolicy
from pyramidkv_tpu_torch.cache import cache_memory_bytes, used_kv_tokens
from pyramidkv_tpu_torch.models import llama as tl
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
BUCKET, DECODE_SLOTS = 64, 4
TRUE_LEN = np.asarray([64, 40, 17], np.int32)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(7),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("method", ["fullkv", "snapkv", "pyramidkv"])
def test_prefill_and_decode_match_jax(params, method):
    jp, tp = params
    kw = dict(method=method, max_capacity_prompt=16, window_size=4,
              kernel_size=5)
    jplan = jpolicy.make_plan(jcfg.CompressionSpec(**kw), 4, BUCKET,
                              DECODE_SLOTS)
    tplan = tpolicy.make_plan(tcfg.CompressionSpec(**kw), 4, BUCKET,
                              DECODE_SLOTS)
    assert tplan.segments == jplan.segments
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(3, BUCKET)).astype(np.int32)
    jlog, jcache = jl.prefill(jp, jcfg.ModelSpec.tiny(), jplan,
                              jnp.asarray(tokens), jnp.asarray(TRUE_LEN))
    tlog, tcache = tl.prefill(tp, tcfg.ModelSpec.tiny(), tplan,
                              torch.from_numpy(tokens),
                              torch.from_numpy(TRUE_LEN))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=TOL, atol=TOL)
    for name in ("k", "v", "mask", "positions"):
        js, ts = _leaves(getattr(jcache, name)), _leaves(getattr(tcache, name))
        assert len(js) == len(ts)
        for j, t in zip(js, ts):
            if name in ("mask", "positions"):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=TOL, atol=TOL)
    from pyramidkv_tpu.cache import cache_memory_bytes as jbytes
    from pyramidkv_tpu.cache import used_kv_tokens as jused

    assert cache_memory_bytes(tcache) == jbytes(jcache)
    assert used_kv_tokens(tcache) == int(jused(jcache))

    for step in range(3):
        tok = rng.integers(0, 256, size=(3,)).astype(np.int32)
        jlog, jcache = jl.decode_step(jp, jcfg.ModelSpec.tiny(), jplan, jcache,
                                      jnp.asarray(tok))
        tlog, tcache = tl.decode_step(tp, tcfg.ModelSpec.tiny(), tplan,
                                      tcache, torch.from_numpy(tok))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=TOL, atol=TOL, err_msg=f"step {step}")
    assert tcache.step == int(jcache.step) == 3
    for j, t in zip(_leaves(jcache.positions), _leaves(tcache.positions)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_plain_and_kernel_impls_agree_on_cpu(params):
    """On CPU tensors the kernel wrappers run the plain versions, so the two
    attention_impl choices give identical results."""
    _, tp = params
    plan = tpolicy.make_plan(tcfg.CompressionSpec(method="snapkv",
                                                  max_capacity_prompt=16,
                                                  window_size=4), 4, BUCKET, 2)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(2, BUCKET)))
    tlen = torch.tensor([60, 20], dtype=torch.int32)
    a, _ = tl.prefill(tp, tcfg.ModelSpec.tiny(), plan, tokens, tlen,
                      attention_impl="kernel")
    b, _ = tl.prefill(tp, tcfg.ModelSpec.tiny(), plan, tokens, tlen,
                      attention_impl="plain")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bridge_keeps_layout_and_bf16():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(3),
                        dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(tree, device="cpu")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    for name, t in [("embed", tp["embed"]), ("lm_head", tp["lm_head"]),
                    ("wq", tp["layers"]["wq"]), ("w_down", tp["layers"]["w_down"])]:
        src = tree[name] if name in tree else tree["layers"][name]
        assert tuple(t.shape) == src.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      src.astype(np.float32))
