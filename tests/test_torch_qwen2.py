"""Qwen2's QKV biases and GQA group 7 on the port, against the JAX package
on the CPU in f32.

Qwen2.5-7B has 28 query heads on 4 KV heads (G = 7, the first group that
is not a power of two) and biases on the q/k/v projections.  Two tiny
configurations carry both: ``ModelSpec.tiny(num_attention_heads=7,
num_key_value_heads=1, hidden_size=112, attention_bias=True)`` and the same
with 14 / 2 heads (hidden 224); f32 weights (biases included) from JAX's
``init_params(..., PRNGKey(0))`` through numpy and ``params_from_numpy``.
Bucket 128, prompts of 100 / 77 / 30 tokens (``test_torch_mistral.py``'s,
whose helpers run both engines).  Each engine case runs a live
JAX ``Engine.generate`` and the port's on the same prompts: greedy tokens,
decode steps and cache bytes must be equal, and the last-position prefill
logits agree within 1e-4 (``tests/test_torch_model.py``'s bound: the same
f32 products summed in other orders).  The cases: every method of
``METHODS`` (MInference on both sides of ``minference_dense_below``),
``gqa_aggregate``, chunked prefill with the bf16 and the quantized carries,
``prefill_two_pass``, a prefix handle, int4 weights, and KIVI 4-bit caches
in the group and pa layouts (fullkv: the 7 heads share one region).

Kernel level, the plain versions the CPU runs at G = 7 (and the oracles of
the kernels' schedules) against JAX's functions on the same numpy inputs,
within the bounds of ``test_torch_decode_split.py`` (decode: 2e-4),
``test_torch_quant.py`` (the factored group function: 1e-4) and
``test_torch_pa_split.py`` (pa: acc / l within 2^-6 |want| + 2^-5 rms);
the decode split plan's one wave at G = 7 and the KIVI kernels' shared
memory at G = 7.

HF parity: a tiny HF ``Qwen2ForCausalLM`` with 7 / 1 heads and random
biases (``tests/test_qwen2.py:25-44``), loaded into the JAX tree by JAX's
loader and carried across; the port's prefill logits within 2e-4 of HF's
(``tests/test_qwen2.py:58-74``), also with tied embeddings (Qwen2-0.5B).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.kernels.decode_attn import decode_attention_pallas
from pyramidkv_tpu.kernels.quant_fused_decode import (
    region_attention_fused_kernel)
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.models import weights as jw
from pyramidkv_tpu.ops import quant as jq
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.kernels import (decode_attention, decode_attn,
                                         quant_decode,
                                         quant_fused_attention_group,
                                         quant_fused_attention_pa)
from pyramidkv_tpu_torch.kernels.int4_matmul import int4_tile_plan
from pyramidkv_tpu_torch.kernels.quant_fused_decode import (pa_smem_bytes,
                                                            pa_split_plain,
                                                            pa_split_plan)
from pyramidkv_tpu_torch.models import llama as tl
from pyramidkv_tpu_torch.models import weights as tw
from pyramidkv_tpu_torch.models.convert import (init_params,
                                                params_from_numpy,
                                                region_from_numpy)
from pyramidkv_tpu_torch.ops import quant as tq
from pyramidkv_tpu_torch.policy import make_plan
from test_torch_mistral import (_Shared, _assert_same, _prefill_logits,
                                _prompts)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: the Mistral file's bucket and prompts (its helpers run both engines)
BUCKET, CHUNK = 128, 32
TOL = 1e-4      # prefill logits (tests/test_torch_model.py)
HF_TOL = 2e-4   # against HF (tests/test_qwen2.py)
DTOL = 2e-4     # decode (tests/test_torch_decode_split.py)
CPU = torch.device("cpu")
_NEG = float(np.finfo(np.float32).min)
COMP = dict(max_capacity_prompt=24, window_size=4, kernel_size=5,
            recent_size=8, minference_vertical_size=16,
            minference_slash_size=16, minference_last_q=8)
#: the two G = 7 geometries: (query heads, KV heads, hidden)
SPECS = {"7/1": (7, 1, 112), "14/2": (14, 2, 224)}
KIVI4 = dict(method="fullkv", quant_method="kivi", nbits=4, q_group_size=16)


def _spec_kw(geom):
    h, hk, dm = SPECS[geom]
    return dict(num_attention_heads=h, num_key_value_heads=hk,
                hidden_size=dm, attention_bias=True)


def _headkv_caps(geom):
    """Seeded synthetic retrieval-head scores, one per (layer, head)."""
    h = SPECS[geom][0]
    return jcfg.headkv_capacity_from_scores(
        np.random.default_rng(17).random(4 * h).tolist(), 4, h, 24)


#: name -> (geometry, CompressionSpec arguments beyond COMP, EngineSpec
#: arguments, weights).  Every method of METHODS at 7 / 1, then the other
#: paths; the G = 7 decodes (bf16, KIVI group, the pa carry) again at 14 / 2
#: (two KV heads of 7), beside snapkv.
CASES = {
    **{f"7/1 {m}": ("7/1", dict(method=m), {}, "f32") for m in jcfg.METHODS
       if m != "headkv"},
    "7/1 headkv": ("7/1", dict(method="headkv",
                               head_capacity=_headkv_caps("7/1")), {}, "f32"),
    "7/1 minference sparse": ("7/1", dict(method="minference",
                                          minference_dense_below=0), {},
                              "f32"),
    "7/1 snapkv gqa": ("7/1", dict(method="snapkv", gqa_aggregate=True), {},
                       "f32"),
    "7/1 h2o gqa": ("7/1", dict(method="h2o", gqa_aggregate=True), {},
                    "f32"),
    **{f"7/1 {m} chunk": ("7/1", dict(method=m), dict(prefill_chunk=CHUNK),
                          "f32") for m in ("fullkv", "snapkv", "h2o")},
    "7/1 fullkv kivi4 chunk": ("7/1", dict(KIVI4, q_layout="group"),
                               dict(prefill_chunk=CHUNK), "f32"),
    "7/1 fullkv kivi4-pa chunk": ("7/1", dict(KIVI4, q_layout="pa"),
                                  dict(prefill_chunk=CHUNK), "f32"),
    "7/1 fullkv kivi4": ("7/1", dict(KIVI4, q_layout="group"), {}, "f32"),
    "7/1 fullkv kivi4-pa": ("7/1", dict(KIVI4, q_layout="pa"), {}, "f32"),
    "7/1 snapkv two-pass": ("7/1", dict(method="snapkv"),
                            dict(prefill_two_pass=True), "f32"),
    "7/1 fullkv int4": ("7/1", dict(method="fullkv"), {}, "int4"),
    "7/1 snapkv int4": ("7/1", dict(method="snapkv"), {}, "int4"),
    "14/2 fullkv": ("14/2", dict(method="fullkv"), {}, "f32"),
    "14/2 snapkv": ("14/2", dict(method="snapkv"), {}, "f32"),
    "14/2 fullkv kivi4": ("14/2", dict(KIVI4, q_layout="group"), {}, "f32"),
    "14/2 fullkv kivi4-pa chunk": ("14/2", dict(KIVI4, q_layout="pa"),
                                   dict(prefill_chunk=CHUNK), "f32"),
}


@pytest.fixture(scope="module")
def rig():
    """Per geometry: both packages' specs and params (f32 and int4),
    converted once."""
    out = {}
    for geom in SPECS:
        js = jcfg.ModelSpec.tiny(**_spec_kw(geom))
        jp = jl.init_params(js, jax.random.PRNGKey(0), dtype=jnp.float32)
        j4 = jw.quantize_weights(jp, nbits=4)
        params = {name: (p, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p), device="cpu"))
            for name, p in (("f32", jp), ("int4", j4))}
        out[geom] = (js, tcfg.ModelSpec.tiny(**_spec_kw(geom)), params)
    return out


@pytest.fixture(scope="module")
def engines(rig):
    """(JAX engine, port engine) per configuration, built once a module.
    JAX's engine prefills through XLA on the CPU whatever
    ``prefill_two_pass`` says, so a two-pass port engine shares the
    one-pass JAX engine of its configuration."""
    jax_cache, port_cache = {}, {}

    def get(geom, comp, eng, weights="f32"):
        js, ts, params = rig[geom]
        jp, tp = params[weights]
        comp = dict(COMP, **comp)
        eng = dict(max_new_tokens=8, prefill_buckets=(BUCKET,), **eng)
        jeng = {k: v for k, v in eng.items() if k != "prefill_two_pass"}
        jkey = repr((geom, sorted(comp.items()), sorted(jeng.items()),
                     weights))
        tkey = repr((geom, sorted(comp.items()), sorted(eng.items()),
                     weights))
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


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax_engine(engines, case):
    geom, comp, eng, weights = CASES[case]
    je, te = engines(geom, comp, eng, weights)
    if "chunk" in case:
        assert te.chunked_prefill_supported(BUCKET)
    prompts = _prompts()
    _assert_same(te.generate(prompts), je.generate(prompts))
    got, want = _prefill_logits(je, te, prompts)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_prefix_handle(engines):
    """A 70-token prefix (64 cached columns) shared by prompts of 128, 100
    and 77 tokens (snapkv, chunk 32, G = 7 with biases): the handle's keys,
    the tokens and the resumed prefill logits against JAX's engine with its
    own handle, and the port's tokens with and without the handle."""
    je, te = engines("7/1", dict(method="snapkv"),
                     dict(prefill_chunk=CHUNK))
    prefix = np.random.default_rng(1).integers(1, 250, size=70).tolist()
    prompts = _prompts(seed=2, prefix=prefix, lens=(128, 100, 77))
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    assert th.full_len == jh.full_len == 64
    np.testing.assert_allclose(th.state.k.numpy(), np.asarray(jh.state.k),
                               rtol=TOL, atol=TOL)
    got = te.generate(prompts, prefix=th)
    _assert_same(got, je.generate(prompts, prefix=jh))
    assert got.tokens == te.generate(prompts).tokens
    got, want = _prefill_logits(je, te, prompts, jh, th)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# Weights: the bias leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_leaves_carried_across(rig, dtype):
    """``params_from_numpy`` carries ``bq`` [L, H Dh], ``bk`` / ``bv``
    [L, KV Dh] in the dtype asked for, value for value."""
    js, _, params = rig["7/1"]
    jp = params["f32"][0]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu", dtype=dtype)
    for name, width in (("bq", 7 * 16), ("bk", 16), ("bv", 16)):
        leaf = tp["layers"][name]
        assert leaf.dtype == dtype and tuple(leaf.shape) == (4, width)
        want = torch.from_numpy(np.array(jp["layers"][name])).to(dtype)
        assert torch.equal(leaf, want)


def test_quantized_weights_keep_biases_float(rig):
    """``quantize_weights`` leaves the bias leaves as they are (not in
    ``_MATMUL_LEAVES``), bit for bit with JAX's, and ``fuse_packed_matmuls``
    passes them through beside the fused ``wqkv`` (``tests/test_qwen2.py:
    119-143``)."""
    _, _, params = rig["7/1"]
    jp, tp = params["f32"]
    q4 = tw.quantize_weights(tp, nbits=4)
    fused = tw.fuse_packed_matmuls(q4)
    assert isinstance(q4["layers"]["wq"], tw.QuantW)
    assert "wqkv" in fused["layers"] and "wq" not in fused["layers"]
    j4 = jw.quantize_weights(jp, nbits=4)
    for name in ("bq", "bk", "bv"):
        for tree in (q4, fused):
            leaf = tree["layers"][name]
            assert not isinstance(leaf, tw.QuantW)
            assert leaf.dtype == torch.float32
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(j4["layers"][name]))


def test_fused_int4_wqkv_matches_jax(rig):
    """int4 weights with ``wqkv`` fused on both sides: the biases are added
    after the split, so the fused path gives JAX's fused greedy tokens and
    prefill logits (JAX ``llama.py:190-206``)."""
    js, ts, params = rig["7/1"]
    j4 = jw.fuse_packed_matmuls(params["int4"][0])
    t4 = params_from_numpy(jax.tree_util.tree_map(np.asarray, j4),
                           device="cpu")
    assert "wqkv" in t4["layers"] and "bq" in t4["layers"]
    comp = dict(COMP, method="snapkv")
    eng = dict(max_new_tokens=8, prefill_buckets=(BUCKET,))
    je = JaxEngine(js, jcfg.CompressionSpec(**comp), jcfg.EngineSpec(**eng),
                   j4)
    te = Engine(ts, tcfg.CompressionSpec(**comp), tcfg.EngineSpec(**eng), t4,
                device="cpu")
    prompts = _prompts()
    _assert_same(te.generate(prompts), je.generate(prompts))
    got, want = _prefill_logits(je, te, prompts)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_init_params_draws_biases():
    """The port's on-card initialiser (here on the CPU) draws the bias
    leaves at JAX's shapes and scale, N(0, 0.02^2)."""
    spec = tcfg.ModelSpec.preset("qwen2.5-7b", num_hidden_layers=1,
                                 hidden_size=256, intermediate_size=64,
                                 vocab_size=64, num_attention_heads=14,
                                 num_key_value_heads=2)
    p = init_params(spec, torch.Generator().manual_seed(0), "cpu",
                    torch.float32)
    shapes = {n: tuple(p["layers"][n].shape) for n in ("bq", "bk", "bv")}
    assert shapes == {"bq": (1, 14 * 128), "bk": (1, 256), "bv": (1, 256)}
    std = float(torch.cat([p["layers"][n].flatten()
                           for n in ("bq", "bk", "bv")]).std())
    assert 0.018 < std < 0.022


def test_refusals():
    """QKV biases are admitted, and so are Gemma-2's features since they
    were ported; MoE stays refused, citing its ROADMAP item.  On a capped
    model (or one with a custom attention scale) every method and KIVI
    caches run since they were ported; what stays refused there is what is
    refused everywhere (KVQuant's outliers, queue 1 #6)."""
    tl.check_ported(tcfg.ModelSpec.preset("qwen2.5-7b"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 #5d"):
        tl.check_ported(tcfg.ModelSpec.tiny(num_local_experts=4))
    for kw in (dict(attn_logit_softcapping=50.0), dict(hidden_act="gelu_tanh"),
               dict(post_block_norms=True)):
        tl.check_ported(tcfg.ModelSpec.tiny(**kw))
    es = tcfg.EngineSpec(max_new_tokens=4, prefill_buckets=(64,))
    for kw in (dict(attn_logit_softcapping=50.0),
               dict(query_pre_attn_scalar=64.0)):
        spec = tcfg.ModelSpec.tiny(**kw)
        params = init_params(spec, torch.Generator().manual_seed(0), "cpu",
                             torch.float32)
        for comp in (dict(method="snapkv"), dict(method="h2o"),
                     dict(method="minference"), dict(method="think"),
                     KIVI4, dict(KIVI4, q_layout="pa")):
            Engine(spec, tcfg.CompressionSpec(**comp), es, params,
                   device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 #6"):
            Engine(spec, tcfg.CompressionSpec(method="snapkv",
                                              quant_method="kvquant"), es,
                   params, device="cpu")


# ---------------------------------------------------------------------------
# Kernel level: the plain versions and the kernels' plans at G = 7
# ---------------------------------------------------------------------------


def test_decode_split_plan_is_one_wave_at_g7():
    """At G = 7 the kernel holds one block an SM (packed bf16 query), so
    the plan fills the H100's 132 SMs once: Qwen's 32k fullkv (4 regions
    of 32896 slots) in 33 splits of 1024, the 8k batch (16 of 8224) in 8
    of 1088; G <= 4 keeps two blocks an SM (Llama's plans unchanged)."""
    assert decode_attn.blocks_per_sm(7) == 1
    assert decode_attn.blocks_per_sm(4) == 2
    assert decode_attn.decode_split_plan(CPU, 4, 32896, 7) == (33, 1024)
    assert decode_attn.decode_split_plan(CPU, 16, 8224, 7) == (8, 1088)
    assert decode_attn.decode_split_plan(CPU, 8, 32896, 4) == (33, 1024)
    for bhk, s in ((4, 32896), (16, 8224), (4, 4100), (1, 1)):
        nsplit, rows = decode_attn.decode_split_plan(CPU, bhk, s, 7)
        assert (nsplit - 1) * rows < s <= nsplit * rows
        assert bhk * nsplit <= 132 or rows == 32 * decode_attn.TILE


def _decode_inputs(seed, b, hk, g, s, d=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hk * g, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    mask = rng.random(size=(b, hk, s)) < 0.6
    return q, k, v, mask


@pytest.mark.parametrize("nsplit,s", [(1, 50), (3, 175), (7, 400)])
def test_decode_split_schedule_at_g7(nsplit, s):
    """The kernel's schedule at G = 7 (several splits, a wholly masked
    split, a masked left run, a row masked everywhere) against the port's
    plain decode, the wrapper on CPU tensors and JAX's Pallas kernel
    (interpret), within 2e-4."""
    b, hk, g = 2, 2, 7
    q, k, v, mask = _decode_inputs(nsplit * 10 + g, b, hk, g, s)
    rows = decode_attn.TILE
    if nsplit > 1:
        mask[0, 1, rows:2 * rows] = False   # a wholly masked split
        mask[1, 0, :rows] = False           # a masked left run, as a pad
    mask[1, 1] = False                      # a row masked everywhere
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    got = decode_attn.decode_attention_split_plain(
        *t, nsplit, max(rows, s) if nsplit == 1 else rows)
    pallas = np.asarray(decode_attention_pallas(
        *map(jnp.asarray, (q, k, v, mask)), interpret=True))
    for want in (decode_attention(*t).numpy(), pallas):
        np.testing.assert_allclose(got.numpy(), want, rtol=DTOL, atol=DTOL)
    uni = v[1, 1].mean(0)  # the all-masked row: the uniform mean of V
    for gi in range(g):
        np.testing.assert_allclose(got[1, g + gi].numpy(), uni, rtol=DTOL,
                                   atol=DTOL)


def _jax_region(reg):
    k, v = (jq.QuantizedTensor(*(jnp.asarray(x.numpy()) for x in part),
                               outliers=None) for part in reg)
    return jq.QuantizedKVRegion(k=k, v=v, k_out_idx=None, k_out_val=None,
                                v_out_idx=None, v_out_val=None)


def _check_partials(got, want, rtol, row_tol):
    """acc / l within rtol |want| + row_tol rms(row), m within
    2^-12 max(1, |m|), l within 2^-10 l; rows with nothing visible exact."""
    acc, m, l = (np.asarray(x) for x in got)
    wacc, wm, wl = (np.asarray(x) for x in want)
    live = wl > 0
    assert (live == (l > 0)).all()
    assert (m[~live] == _NEG).all() and (wm[~live] == _NEG).all()
    o = acc[live] / l[live][:, None]
    ow = wacc[live] / wl[live][:, None]
    rms = np.sqrt(np.mean(ow ** 2, -1, keepdims=True))
    assert (np.abs(o - ow) <= rtol * np.abs(ow) + row_tol * rms).all()
    assert (np.abs(m[live] - wm[live])
            <= 2.0 ** -12 * np.maximum(1.0, np.abs(wm[live]))).all()
    assert (np.abs(l[live] - wl[live]) <= 2.0 ** -10 * wl[live]).all()


def _kv_region(nbits, layout, b, hk, g, s, d, group, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hk * g, d)).astype(np.float32)
    k = (rng.normal(size=(b, hk, s, d))
         * np.exp(rng.normal(size=(1, 1, 1, d)))).astype(np.float32)
    v = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    mask = rng.random((b, hk, s)) < 0.8
    mask[0, 0] = False  # a region row with no visible slot
    jreg = jq.quantize_kv_region(jnp.asarray(k), jnp.asarray(v), nbits=nbits,
                                 group_size=group, layout=layout)
    treg = region_from_numpy(jax.tree_util.tree_map(np.asarray, jreg),
                             device="cpu")
    return q, mask, jreg, treg


@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_kivi_group_fold_at_g7(nbits):
    """The group layout's default route (the factored dequantization, mode
    kFold on the card) at G = 7: the plain version against JAX's
    ``quant_region_attention_fused`` within 1e-4 (``test_torch_quant.py``),
    and the kernel's split schedule (2 and 3 splits) against the plain
    version within the fold's 2^-6 |want| + 2^-6 rms (l within 2^-7,
    ``test_torch_quant_split.py``)."""
    b, hk, g, s, d = 1, 2, 7, 400, 32
    q, mask, jreg, treg = _kv_region(nbits, "group", b, hk, g, s, d, 16,
                                     nbits + 70)
    want = jq.quant_region_attention_fused(
        jnp.asarray(q), jreg, jnp.asarray(mask), num_slots=s, head_dim=d,
        nbits=nbits)
    qt, mt = torch.from_numpy(q), torch.from_numpy(mask)
    got = quant_fused_attention_group(qt, treg, mt, nbits=nbits)
    wl = np.asarray(want[2])
    norm = got[0].numpy() / np.maximum(got[2].numpy(), 1e-30)[..., None]
    wnorm = np.asarray(want[0]) / np.maximum(wl, 1e-30)[..., None]
    np.testing.assert_allclose(norm, wnorm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), wl, rtol=1e-5, atol=1e-5)
    w = treg.k.codes.shape[2]
    items = -(-w // quant_decode.ITEM_ROWS)
    for n in (2, 3):
        rows = quant_decode.ITEM_ROWS * -(-items // n)
        sched = quant_decode.region_split_plain(
            qt, treg, mt, nbits=nbits, plan=(-(-w // rows), rows), fold=True)
        acc, m, l = (x.numpy() for x in sched)
        live = l > 0
        assert (live == (got[2].numpy() > 0)).all()
        np.testing.assert_allclose(m, got[1].numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(l, got[2].numpy(), rtol=2.0 ** -7)
        o, ow = acc[live] / l[live][:, None], norm[live]
        rms = np.sqrt(np.mean(ow ** 2, -1, keepdims=True))
        assert (np.abs(o - ow) <= 2.0 ** -6 * np.abs(ow)
                + 2.0 ** -6 * rms).all()


@pytest.mark.parametrize("nbits,gk", [(2, 4), (4, 1), (8, 1)])
def test_kivi_pa_at_g7(nbits, gk):
    """The pa layout at G = 7 (rows 7..15 of the kernel's products idle; JAX
    pads G up to 8): the kernel's schedule (``pa_split_plain``) against the
    plain version and JAX's Pallas kernel (interpret), within the pa bound;
    with ``gk`` K groups a plane (the chunked carry's) when 4."""
    b, hk, g, s, d = 1, 2, 7, 512, 128
    q, mask, _, treg = _kv_region(nbits, "pa", b, hk, g, s, d, 64,
                                  nbits * 11 + gk)
    qt, mt = torch.from_numpy(q), torch.from_numpy(mask)
    if gk > 1:  # K groups of s_pad / gk slots, as the chunked carry's
        rng = np.random.default_rng(5)
        k = torch.from_numpy(rng.normal(size=(b, hk, s, d)).astype(
            np.float32))
        s_pad = treg.k.codes.shape[2] * (8 // nbits)
        kt = torch.nn.functional.pad(k.transpose(2, 3), (0, s_pad - s))
        kq = tq.quantize(kt, nbits=nbits, group_size=s_pad // gk)
        treg = treg._replace(k=kq._replace(
            codes=kq.codes.transpose(-1, -2).contiguous()))
    w, _, kg, _ = tq.region_geometry(treg, nbits)
    seg = kg if gk > 1 else 0
    plan = pa_split_plan(CPU, b * hk, w, seg)
    assert plan[0] > 1
    got = pa_split_plain(qt, treg, mt, nbits=nbits, plan=plan)
    plain = tq.quant_region_attention_fused(qt, treg, mt, nbits=nbits)
    _check_partials(got, plain, 2.0 ** -6, 2.0 ** -5)
    want = region_attention_fused_kernel(
        jnp.asarray(q), _jax_region(treg), jnp.asarray(mask), head_dim=d,
        nbits=nbits, interpret=True)
    _check_partials(got, want, 2.0 ** -6, 2.0 ** -5)
    # the wrapper on CPU tensors is the plain version
    for a, x in zip(quant_fused_attention_pa(qt, treg, mt, nbits=nbits),
                    plain):
        assert torch.equal(a, x)


@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_kivi_shared_memory_at_g7(nbits):
    """At G = 7 two pa blocks share an SM (228 KB, 1 KB reserved a
    block), and the group kernel's block fits 227 KB with its K tables
    staged once on the plans of Qwen's fullkv group regions (32k: 4
    regions of 32768 slots; the 8k batch: 16 of 8192; K groups of 64
    slots, V groups of 64 channels, a 128-slot tail) in both modes."""
    smem = pa_smem_bytes(7, nbits)
    assert 2 * (smem + 1024) <= 228 * 1024
    per = 8 // nbits
    for bhk, s_pad in ((4, 32768), (16, 8192)):
        w = s_pad // per
        nsplit, rows = quant_decode.split_plan(CPU, bhk, w, nbits, 64)
        ng = s_pad // 64
        for fold in (False, True):
            args = (7, nbits, fold, rows, 64, ng, 128 // per, 2, 128)
            assert quant_decode.region_smem_bytes(*args) <= \
                quant_decode.MAX_SMEM
            assert quant_decode.region_window(*args) == rows


#: Qwen2.5-7B's int4 decode matmuls: name -> (in, out2 bytes); the fused
#: wqkv (3584 -> 4608) and w_gateup, and the lm_head padded to 155648
QWEN_INT4 = {"wqkv": (3584, 2304), "wo": (3584, 1792),
             "w_gateup": (3584, 18944), "w_down": (18944, 1792),
             "lm_head4": (3584, 77824)}


@pytest.mark.parametrize("shape", list(QWEN_INT4))
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("fmt", ["per-channel", "g128"])
def test_int4_tile_plan_at_qwen_widths(shape, rows, fmt):
    """``int4_tile_plan`` plans Qwen's in-dims (3584 = 28 x 128, 18944 =
    148 x 128) as the kernel takes them (``test_torch_int4_matmul.py``'s
    conditions), one pass over the codes at <= 8 rows, every SM given a
    block."""
    from test_torch_int4_matmul import _check_plan

    in_dim, out2 = QWEN_INT4[shape]
    gs = 128 if fmt == "g128" else 0
    p = int4_tile_plan(rows, in_dim, out2, gs, 132, shape == "lm_head4")
    _check_plan(p, rows, in_dim, out2, gs)
    assert p.rp == rows and p.blocks >= 132


# ---------------------------------------------------------------------------
# HF parity
# ---------------------------------------------------------------------------


def _hf_qwen2(tmp_path, seed, tied):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=112, intermediate_size=128,
        num_hidden_layers=3 if not tied else 2, num_attention_heads=7,
        num_key_value_heads=1, max_position_embeddings=512,
        tie_word_embeddings=tied, rope_theta=10000.0)
    model = transformers.Qwen2ForCausalLM(cfg)
    # HF zeroes Linear biases: random ones exercise the bias path
    with torch.no_grad():
        for layer in model.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(0, 0.05)
    model.eval()
    d = tmp_path / "qwen2"
    model.save_pretrained(d, safe_serialization=True)
    return model, str(d)


@pytest.mark.parametrize("tied", [False, True])
def test_prefill_logits_match_hf(tmp_path, tied):
    """A 7 / 1-head HF Qwen2 with random biases (untied, and Qwen2-0.5B's
    tied embeddings) through JAX's loader and ``params_from_numpy``: the
    port's last-position prefill logits within 2e-4 of HF's."""
    from pyramidkv_tpu.models.loader import (load_params_from_hf,
                                             spec_from_hf_dir)

    model, d = _hf_qwen2(tmp_path, 5 if tied else 0, tied)
    jspec = spec_from_hf_dir(d)
    assert jspec.attention_bias and jspec.tie_word_embeddings == tied
    jp = load_params_from_hf(d, jspec, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    assert ("lm_head" in tp) != tied
    spec = tcfg.ModelSpec(**{f: getattr(jspec, f)
                             for f in jspec.__dataclass_fields__})
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
