"""The port's KIVI quantization (``pyramidkv_tpu_torch/ops/quant.py``) and
its three region kernels against the JAX package, on the CPU.

On the CPU the kernel wrappers run their plain versions, which the CUDA
kernels are held to on the card; here the plain versions are held to the
JAX package's Pallas kernels in interpret mode on the same regions
(``region_from_numpy``), at the JAX tests' tolerances
(``tests/test_quant_decode_kernel.py``: 2e-4 for the f32 group-layout
kernels; ``tests/test_quant_fused_kernel.py``: 2e-2 on normalised outputs
and l, 1e-2 on m, for the pa kernel's bf16 dots).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pyramidkv_tpu.kernels.quant_decode import (
    quant_decode_attention as jax_qda,
    quant_decode_attention_tiled as jax_qda_tiled)
from pyramidkv_tpu.kernels.quant_fused_decode import (
    region_attention_fused_kernel)
from pyramidkv_tpu.ops import attention as jatt
from pyramidkv_tpu.ops import quant as jq
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.kernels import (quant_decode_attention,
                                         quant_decode_attention_tiled,
                                         quant_fused_attention_pa)
from pyramidkv_tpu_torch.models.convert import region_from_numpy
from pyramidkv_tpu_torch.ops import attention as tatt
from pyramidkv_tpu_torch.ops import quant as tq
from pyramidkv_tpu_torch.policy import make_plan
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(t, a):
    """Bit-equal: same dtype, shape and bits."""
    a = np.asarray(a)
    assert t.dtype == _t(a).dtype and tuple(t.shape) == a.shape
    assert np.array_equal(t.numpy().view(np.uint8), a.view(np.uint8))


def _kv(rng, b, h, s, d):
    """Channel-scaled keys (the regime the pa layout exists for) and
    values."""
    k = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k *= np.exp(rng.normal(size=(1, 1, 1, d))).astype(np.float32)
    return k, rng.normal(size=(b, h, s, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the quantizer, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", [8, 4, 2])
@pytest.mark.parametrize("axis", [-1, -2])
def test_pack_unpack_bit_equal(nbits, axis):
    rng = np.random.default_rng(nbits)
    vals = rng.integers(0, 2 ** nbits, size=(3, 16, 24)).astype(np.int32)
    want = jq._pack(jnp.asarray(vals), nbits, axis=axis)
    got = tq._pack(_t(vals), nbits, axis=axis)
    _same(got, want)
    _same(tq._unpack(got, nbits, axis=axis),
          jq._unpack(want, nbits, axis=axis))


@pytest.mark.parametrize("nbits", [8, 4, 2])
def test_quantize_bit_equal(nbits):
    x = np.random.default_rng(nbits).normal(size=(2, 3, 128)).astype(
        np.float32) * 3
    want = jq.quantize(jnp.asarray(x), nbits=nbits, group_size=32)
    got = tq.quantize(_t(x), nbits=nbits, group_size=32)
    for f in ("codes", "scale", "zero"):
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("nbits", [8, 4, 2])
@pytest.mark.parametrize("layout", ["group", "pa"])
@pytest.mark.parametrize("s,d", [(37, 16), (128, 64)])
def test_quantize_kv_region_bit_equal(nbits, layout, s, d):
    """Both layouts, an odd slot count (S_pad pads it) and D = 16 < the
    group of 64 (Dp pads V's channels)."""
    rng = np.random.default_rng(nbits + s)
    k, v = _kv(rng, 2, 3, s, d)
    want = jq.quantize_kv_region(jnp.asarray(k), jnp.asarray(v), nbits=nbits,
                                 group_size=64, layout=layout)
    got = tq.quantize_kv_region(_t(k), _t(v), nbits=nbits, group_size=64,
                                layout=layout)
    for part in ("k", "v"):
        for f in ("codes", "scale", "zero"):
            _same(getattr(getattr(got, part), f),
                  getattr(getattr(want, part), f))
    wk, wv = jq.dequantize_kv_region(want, num_slots=s, head_dim=d,
                                     nbits=nbits, dtype=jnp.float32)
    gk, gv = tq.dequantize_kv_region(got, num_slots=s, head_dim=d,
                                     nbits=nbits)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# (b) attention partials and their merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hk", [4, 2])
def test_partials_and_merge_match_jax(hk):
    rng = np.random.default_rng(hk)
    b, h, s, d = 2, 4, 96, 16
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v = _kv(rng, b, hk, s, d)
    mask = rng.random((b, hk, s)) > 0.3
    mask[0, 0, 64:] = False  # an all-masked part: weight 0 in the merge
    parts_j, parts_t = [], []
    for lo, hi in ((0, 64), (64, s)):
        pj = jatt.decode_attention_partials(
            jnp.asarray(q), jnp.asarray(k[:, :, lo:hi]),
            jnp.asarray(v[:, :, lo:hi]), jnp.asarray(mask[:, :, lo:hi]))
        pt = tatt.decode_attention_partials(
            _t(q), _t(k[:, :, lo:hi]), _t(v[:, :, lo:hi]),
            _t(mask[:, :, lo:hi]))
        for a, w in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        parts_j.append(pj)
        parts_t.append(pt)
    np.testing.assert_allclose(
        tatt.merge_attention_partials(parts_t).numpy(),
        np.asarray(jatt.merge_attention_partials(parts_j)), rtol=1e-6,
        atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the kernels' plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def _case(nbits, hk, s, d, layout, group, seed):
    rng = np.random.default_rng(seed)
    b, h = 1, 4
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v = _kv(rng, b, hk, s, d)
    mask = rng.random((b, hk, s)) > 0.25
    jreg = jq.quantize_kv_region(jnp.asarray(k), jnp.asarray(v), nbits=nbits,
                                 group_size=group, layout=layout)
    treg = region_from_numpy(jreg, device="cpu")
    return q, mask, jreg, treg


def _group_args(jreg, mask, s_pad):
    m = np.zeros(mask.shape[:2] + (s_pad,), bool)
    m[..., :mask.shape[-1]] = mask
    return (jreg.k.codes, jreg.k.scale[..., 0], jreg.k.zero[..., 0],
            jreg.v.codes, jreg.v.scale[..., 0], jreg.v.zero[..., 0],
            jnp.asarray(m))


def _norm(parts):
    acc, _, l = (np.asarray(x) for x in parts)
    return acc / np.maximum(l, 1e-30)[..., None]


@pytest.mark.parametrize("nbits", [8, 4, 2])
@pytest.mark.parametrize("g", [1, 2])
def test_quant_decode_plain_matches_pallas(nbits, g):
    q, mask, jreg, treg = _case(nbits, 4 // g, 128, 32, "group", 32,
                                nbits * 10 + g)
    s_pad = jreg.k.codes.shape[-2] * (8 // nbits)
    want = jax_qda(jnp.asarray(q), *_group_args(jreg, mask, s_pad),
                   nbits=nbits, group_size=32, interpret=True)
    got = quant_decode_attention(_t(q), treg, _t(mask), nbits=nbits)
    np.testing.assert_allclose(_norm(got), _norm(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("nbits", [8, 4, 2])
def test_quant_decode_tiled_plain_matches_pallas(nbits):
    """tile=256: several tiles carry the online softmax on the TPU side; an
    odd region (1000 slots) pads to S_pad."""
    q, mask, jreg, treg = _case(nbits, 2, 1000, 32, "group", 32, nbits * 7)
    s_pad = jreg.k.codes.shape[-2] * (8 // nbits)
    want = jax_qda_tiled(jnp.asarray(q), *_group_args(jreg, mask, s_pad),
                         nbits=nbits, group_size=32, tile=256,
                         interpret=True)
    got = quant_decode_attention_tiled(_t(q), treg, _t(mask), nbits=nbits)
    np.testing.assert_allclose(_norm(got), _norm(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("nbits", [8, 4, 2])
def test_quant_fused_pa_plain_matches_pallas(nbits):
    q, mask, jreg, treg = _case(nbits, 2, 512, 64, "pa", 64, nbits)
    want = region_attention_fused_kernel(
        jnp.asarray(q), jreg, jnp.asarray(mask), head_dim=64, nbits=nbits,
        tile=128, interpret=True)
    got = quant_fused_attention_pa(_t(q), treg, _t(mask), nbits=nbits)
    np.testing.assert_allclose(_norm(got), _norm(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-2, atol=2e-2)
    # and the XLA factored function it ports, more tightly (same roundings)
    ref = jq.quant_region_attention_fused(
        jnp.asarray(q), jreg, jnp.asarray(mask), num_slots=512, head_dim=64,
        nbits=nbits)
    for a, w in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("nbits", [8, 4, 2])
@pytest.mark.parametrize("s,d,group,hk", [(128, 32, 16, 2), (300, 64, 16, 4),
                                          (1000, 32, 32, 2)])
def test_quant_fused_group_plain_matches_jax(nbits, s, d, group, hk):
    """The grouped branch of the factored dequantization (Gk > 1 K
    slot-groups, Gv > 1 V channel-groups but for d == group) against JAX's
    ``quant_region_attention_fused``, through the port's default group
    route on the CPU.  Both round the folded query and probabilities to
    bf16; their f32 logits and exponentials differ in the last bits, which
    now and then flips one bf16 rounding (~2^-8 of one probability x its
    code: up to ~5e-5 at 8 bits), hence 1e-4 on normalised outputs as the pa
    test above; l and m within 1e-5 relative."""
    from pyramidkv_tpu_torch.kernels import quant_fused_attention_group

    q, mask, jreg, treg = _case(nbits, hk, s, d, "group", group, nbits + s)
    assert treg.k.scale.shape[-2] > 1
    assert (treg.v.scale.shape[-2] > 1) == (d > group)
    want = jq.quant_region_attention_fused(
        jnp.asarray(q), jreg, jnp.asarray(mask), num_slots=s, head_dim=d,
        nbits=nbits)
    got = quant_fused_attention_group(_t(q), treg, _t(mask), nbits=nbits)
    np.testing.assert_allclose(_norm(got), _norm(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["group", "pa"])
def test_tail_mode_matches_jax_merge(layout):
    """Given the step's bf16 decode tail, a wrapper returns the layer's
    attention: the JAX decode step's merge of the region kernel's partials
    and the tail's (slot 0 of the tail visible, the rest at random)."""
    s, d = (128, 32) if layout == "group" else (512, 64)
    q, mask, jreg, treg = _case(4, 2, s, d, layout, d, 17)
    rng = np.random.default_rng(18)
    tk, tv = (rng.normal(size=(1, 2, 9, d)).astype(np.float32)
              for _ in range(2))
    tmask = rng.random((1, 2, 9)) > 0.5
    tmask[..., 0] = True
    if layout == "group":
        s_pad = jreg.k.codes.shape[-2] * 2
        part = jax_qda(jnp.asarray(q), *_group_args(jreg, mask, s_pad),
                       nbits=4, group_size=d, interpret=True)
        fn, tol = quant_decode_attention, 2e-4
    else:
        part = region_attention_fused_kernel(
            jnp.asarray(q), jreg, jnp.asarray(mask), head_dim=d, nbits=4,
            tile=128, interpret=True)
        fn, tol = quant_fused_attention_pa, 2e-2
    want = jatt.merge_attention_partials([part, jatt.decode_attention_partials(
        jnp.asarray(q), jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(tmask))])
    got = fn(_t(q), treg, _t(mask), nbits=4,
             tail=(_t(tk), _t(tv), _t(tmask)))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_all_masked_region_drops_out():
    """Every slot masked: m = float32.min, l = 0, and the merge with a tail
    gives the tail alone (both kernels' plain versions)."""
    for layout, fn in (("group", quant_decode_attention),
                       ("pa", quant_fused_attention_pa)):
        q, mask, _, treg = _case(4, 2, 128, 32, layout, 32, 3)
        mask[:] = False
        acc, m, l = fn(_t(q), treg, _t(mask), nbits=4)
        assert (m == torch.finfo(torch.float32).min).all()
        assert (l == 0).all() and (acc == 0).all()


# ---------------------------------------------------------------------------
# (e) refusals
# ---------------------------------------------------------------------------


def test_unported_quantization_raises():
    for kw in (dict(quant_method="kvquant"),
               dict(quant_method="kivi", nbits=3)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_plan(tcfg.CompressionSpec(method="snapkv", **kw), 4, 64, 8)
    # a logit cap is taken since the region kernels were ported under
    # Gemma-2's (held to JAX in test_torch_gemma2_kivi.py): the wrapper on a
    # CPU tensor is the plain function with the cap
    q, mask, _, treg = _case(4, 2, 128, 32, "group", 32, 1)
    got = quant_decode_attention(_t(q), treg, _t(mask), nbits=4, softcap=30.0)
    want = tq.quant_decode_attention_plain(_t(q), treg, _t(mask), nbits=4,
                                           softcap=30.0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    # the pa kernel takes per-token V with K groups that tile each plane
    # (a chunked prefill's region); a group region with two V channel
    # groups is not one
    q, mask, _, treg = _case(4, 2, 128, 64, "group", 32, 1)
    with pytest.raises(ValueError, match="pa layout"):
        quant_fused_attention_pa(_t(q), treg, _t(mask), nbits=4)


def test_region_route_follows_the_split_plan():
    """Group regions take the factored-dequantization kernel by default
    (JAX's default route); with ``f32_quant`` (JAX's opt-in
    use_quant_kernel) the f32 whole-region kernel when the split plan gives
    one split (made for an H100 on the CPU), else the tiled one; pa regions
    the pa kernel.  The group kernel launches once a call up to
    MAX_CLUSTER splits (the 8k batch: 2 in a cluster), twice beyond (32k
    fullkv: 32 splits and a merge kernel); the pa kernel twice (its split
    kernel and finish pass)."""
    from pyramidkv_tpu_torch.kernels import quant_decode, quant_fused_decode
    from pyramidkv_tpu_torch.kernels import quant_fused_attention_group
    from pyramidkv_tpu_torch.models.llama import region_route

    cpu = torch.device("cpu")
    group = tcfg.CompressionSpec(method="snapkv", quant_method="kivi",
                                 nbits=4)
    pa = tcfg.CompressionSpec(method="fullkv", quant_method="kivi", nbits=4,
                              q_layout="pa")
    assert region_route(pa, 8, 16384, cpu) is quant_fused_attention_pa
    assert region_route(pa, 8, 16384, cpu, True) is quant_fused_attention_pa
    for bhk, w in ((32, 64), (128, 1024), (8, 16384)):
        assert region_route(group, bhk, w, cpu) is quant_fused_attention_group
    # bench.py's 32k snapkv (cap 128): 32 regions of 64 byte-rows
    assert region_route(group, 32, 64, cpu, True) is quant_decode_attention
    # the 8k batch's snapkv (cap 2048) and 32k fullkv
    assert region_route(group, 128, 1024, cpu,
                        True) is quant_decode_attention_tiled
    assert region_route(group, 8, 16384, cpu,
                        True) is quant_decode_attention_tiled
    kernels = {(bhk, w): quant_decode.region_kernels(
        quant_decode.split_plan(cpu, bhk, w, 4, 64)[0])
        for bhk, w in ((32, 64), (128, 1024), (8, 16384))}
    assert kernels == {(32, 64): 1, (128, 1024): 1, (8, 16384): 2}
    assert quant_fused_decode.PA_KERNELS == 2


def test_region_bridge_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _, _, jreg, _ = _case(4, 2, 128, 32, "group", 32, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        region_from_numpy(jreg)


def test_quantized_plans_are_uniform():
    """pyramidkv segments a bf16 cache; under KIVI its plan stays uniform
    (one stacked region), as in the JAX package."""
    spec = dict(method="pyramidkv", max_capacity_prompt=256, window_size=8)
    assert len(make_plan(tcfg.CompressionSpec(**spec), 32, 8192,
                         8).segments) > 1
    plan = make_plan(tcfg.CompressionSpec(quant_method="kivi", **spec), 32,
                     8192, 8)
    assert plan.segments == ((0, 32, plan.width),)
