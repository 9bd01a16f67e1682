"""The port's weight quantization (``pyramidkv_tpu_torch/models/weights.py``)
against the JAX package's: the same numpy weights give bit-equal codes and
equal scales, the same packed layout, the same fused leaves, and ``mm``
sends the same products to the kernels."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.models import weights as jw
from pyramidkv_tpu_torch.kernels import int4_matmul, int8_matmul
from pyramidkv_tpu_torch.models import weights as tw
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: span-128 widths (hidden 256): the layout every real weight has
WIDE = dict(hidden_size=256, intermediate_size=512, num_attention_heads=8,
            num_key_value_heads=4, head_dim=64, vocab_size=512)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(5, 12), (3, 512), (2, 4, 1024)])
def test_pack_unpack_match_jax(shape):
    """span 1 (out/2 = 6) and span 128 layouts, byte for byte."""
    rng = np.random.default_rng(sum(shape))
    c = rng.integers(-8, 8, size=shape).astype(np.int8)
    want = np.asarray(jw.pack4(jnp.asarray(c)))
    got = tw.pack4(_t(c))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tw.unpack4(got).numpy(), c)
    np.testing.assert_array_equal(tw.unpack4(got).numpy(),
                                  np.asarray(jw.unpack4(jnp.asarray(want))))
    jq = jw.QuantW(jnp.asarray(want), jnp.ones(shape[:-2] + shape[-1:]))
    tq = tw.QuantW(got, torch.ones(shape[:-2] + shape[-1:]))
    assert tw.is_packed4(tq) and jw.is_packed4(jq)
    np.testing.assert_array_equal(tw.dq_codes(tq, torch.float32).numpy(),
                                  np.asarray(jw.dq_codes(jq, jnp.float32)))


def _tree_equal(jtree, ttree, path=""):
    """Leaves of a JAX tree (numpy) and a port tree, exactly equal."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            _tree_equal(jtree[k], ttree[k], f"{path}/{k}")
    elif hasattr(jtree, "_fields"):
        assert isinstance(ttree, tw.QuantW), path
        assert ttree.codes.dtype == torch.int8, path
        assert ttree.scale.dtype == torch.float32, path
        np.testing.assert_array_equal(ttree.codes.numpy(),
                                      np.asarray(jtree.codes), err_msg=path)
        np.testing.assert_array_equal(ttree.scale.numpy(),
                                      np.asarray(jtree.scale), err_msg=path)
    else:
        np.testing.assert_array_equal(ttree.numpy(), np.asarray(jtree),
                                      err_msg=path)


@pytest.fixture(scope="module")
def wide_params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(**WIDE), jax.random.PRNGKey(3),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.mark.parametrize("kw", [
    dict(nbits=8),
    dict(nbits=4),
    dict(nbits=4, group_size=16),
    dict(nbits=4, group_size=128, lm_head_nbits=4, lm_head_pad_to=384),
    dict(nbits=8, lm_head_pad_to=96),
], ids=["int8", "int4", "int4-g16", "int4-g128-lm4-pad", "int8-pad"])
def test_quantize_weights_bit_equal_to_jax(wide_params, kw):
    jp, tp = wide_params
    jqt = jw.quantize_weights(jp, **kw)  # quantized once, fused below
    jq = jax.tree_util.tree_map(np.asarray, jqt)
    tq = tw.quantize_weights(tp, **kw)
    _tree_equal(jq, tq)
    # the bridge carries the quantized JAX tree as the same port tree
    _tree_equal(jq, params_from_numpy(jq, device="cpu"))
    if kw["nbits"] == 4:
        # fused leaves too (wqkv / w_gateup), with the unfused names gone
        jf = jax.tree_util.tree_map(np.asarray, jw.fuse_packed_matmuls(jqt))
        tf = tw.fuse_packed_matmuls(tq)
        assert {"wqkv", "w_gateup"} <= set(tf["layers"])
        _tree_equal(jf, tf)


def test_fuse_declines_int8_and_span_changes(wide_params):
    """int8 leaves stay unfused; at span-1 widths a group fuses only when
    the fused width keeps span 1 (tiny model: wq/wk/wv of 32/16/16 bytes
    fuse to 64, w_gate/w_up of 64 each would make 128, span 128)."""
    _, tp = wide_params
    q8 = tw.quantize_weights(tp, nbits=8)
    assert tw.fuse_packed_matmuls(q8) is q8
    rng = np.random.default_rng(0)
    tiny = {"embed": _t(rng.normal(size=(256, 64)).astype(np.float32)),
            "layers": {n: _t(rng.normal(size=(2, *s)).astype(np.float32))
                       for n, s in (("wq", (64, 64)), ("wk", (64, 32)),
                                    ("wv", (64, 32)), ("w_gate", (64, 128)),
                                    ("w_up", (64, 128)))}}
    fused = tw.fuse_packed_matmuls(tw.quantize_weights(tiny, nbits=4))
    assert set(fused["layers"]) == {"wqkv", "w_gate", "w_up"}


def test_bridge_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"embed": np.zeros((2, 2), np.float32)})


#: (rows, in, out, nbits, group size, 2-D leaf) of mm routing cases
ROUTES = [
    (1, 256, 512, 4, None, True),     # int4 per-channel -> kernel
    (384, 256, 512, 4, None, True),   # the row cap -> kernel
    (385, 256, 512, 4, None, True),   # above it -> dequant
    (3, 256, 512, 4, 128, True),      # grouped, in % gs == 0 -> kernel
    (3, 64, 40, 4, 16, True),         # span 1, grouped -> kernel
    (8, 256, 512, 8, None, True),     # int8, <= 8 rows, tiles -> kernel
    (9, 256, 512, 8, None, True),     # int8, 9 rows -> dequant
    (1, 64, 256, 8, None, True),      # int8_tiles(64, 256) == (0, 0)
    (2, 256, 512, 4, None, False),    # stacked leaf without a layer
]


@pytest.mark.parametrize("rows,in_dim,out,nbits,gs,flat", ROUTES)
def test_mm_routes_like_jax(rows, in_dim, out, nbits, gs, flat):
    """The port's kernel routing against JAX's with its kernels forced on
    (interpret mode): a product goes to a kernel in one exactly when it
    does in the other, and both give the same values."""
    rng = np.random.default_rng(rows + in_dim + nbits)
    shape = (in_dim, out) if flat else (2, in_dim, out)
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    jq = jw._quantize_leaf(jnp.asarray(w), nbits, gs)
    tq = tw.QuantW(_t(jq.codes), _t(jq.scale))
    x = rng.normal(size=(rows, in_dim)).astype(np.float32)
    jw._FORCE_INT4_KERNEL[0] = jw._FORCE_INT8_KERNEL[0] = True
    try:
        if nbits == 4:
            j = jw._int4_kernel_mm(jnp.asarray(x), jq) if flat else None
        else:
            j = jw._int8_kernel_mm(jnp.asarray(x), jq) if flat else None
        jm = np.asarray(jw.mm(jnp.asarray(x), jq)) if flat else None
    finally:
        jw._FORCE_INT4_KERNEL[0] = jw._FORCE_INT8_KERNEL[0] = False
    t = tw.kernel_mm(_t(x), tq)
    assert (t is None) == (j is None)
    if t is not None:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
    if flat:  # and mm, kernel or dequant, computes the JAX product
        np.testing.assert_allclose(tw.mm(_t(x), tq).numpy(), jm,
                                   rtol=1e-4, atol=1e-4)


def test_mm_plain_impl_and_dma_switch():
    """``impl="plain"`` and the DMA switch pick the plain / windowed
    versions; on CPU tensors all agree and nothing counts as a launch."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(256, 512)).astype(np.float32) * 0.05
    q = tw._quantize_leaf(_t(w), 4)
    x = _t(rng.normal(size=(2, 256)).astype(np.float32))
    before = int4_matmul.launches, int8_matmul.launches
    ref = tw.mm(x, q)
    assert torch.equal(tw.mm(x, q, impl="plain"), ref)
    tw._INT4_KERNEL_DMA[0] = True
    try:
        torch.testing.assert_close(tw.mm(x, q), ref, rtol=1e-6, atol=1e-6)
    finally:
        tw._INT4_KERNEL_DMA[0] = False
    assert (int4_matmul.launches, int8_matmul.launches) == before
    emb = tw.quantize_weights({"embed": _t(w.T), "layers": {}})["embed"]
    rows = tw.embed_lookup(emb, torch.tensor([[3, 7]]), torch.float32)
    want = jw.embed_lookup(jw.QuantW(jnp.asarray(emb.codes.numpy()),
                                     jnp.asarray(emb.scale.numpy())),
                           jnp.asarray([[3, 7]]), jnp.float32)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))
