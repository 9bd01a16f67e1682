"""Chunked prefill on the PyTorch/CUDA port against the JAX package, on the
CPU in f32.

- Kernels' plain versions: flash attention with ``q_start`` (chunk by chunk)
  and ``flash_attention_partials`` (base-2 statistics; the causal self tile
  and the all-visible history tile) against the Pallas kernels in interpret
  mode, within 2e-5 (the JAX package's own bound for these kernels:
  the same f32 terms summed in other orders); ``tile_attention_partials``
  and ``merge_partials_pair`` against JAX's within 1e-5.
- The pa region attention with Gk > 1 K slot-groups (the quantized carry's
  layout) against JAX's ``quant_region_attention_fused``, within 1e-4 as
  ``tests/test_torch_quant.py`` holds the Gk = 1 case: the same folds, but
  an f32 difference in a probability can flip the bf16 rounding of p * vs,
  moving one term by 2^-9.
- ``Engine.generate`` with ``prefill_chunk`` (chunk 64, bucket 256): the
  bf16 carry for fullkv, snapkv, pyramidkv and h2o against a live JAX
  chunked engine (tokens equal), H2O's two passes, the quantized carry
  (layer-0 bits against the port's monolithic prefill, as the JAX package
  holds its own; codes and tokens against JAX's carry), and the minference
  fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.kernels import flash_attention_partials as jax_partials
from pyramidkv_tpu.kernels import flash_causal_attention as jax_flash
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.ops import attention as jattn
from pyramidkv_tpu.ops import quant as jquant
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.kernels import (flash_attention_partials,
                                         flash_causal_attention,
                                         quant_fused_attention_pa)
from pyramidkv_tpu_torch.models import chunked_prefill as cp
from pyramidkv_tpu_torch.models import llama as tl
from pyramidkv_tpu_torch.models.convert import (params_from_numpy,
                                                region_from_numpy)
from pyramidkv_tpu_torch.ops import attention as plain
from pyramidkv_tpu_torch.ops.quant import quant_region_attention_fused
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KTOL = 2e-5
_NEG = float(np.finfo(np.float32).min)


def _qkv(b=2, h=4, hk=2, n=256, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, h, n, d), (b, hk, n, d), (b, hk, n, d)))


@pytest.mark.parametrize("hk", [4, 2])
def test_plain_flash_q_start_matches_pallas(hk):
    """Every chunk of a 256-token bucket (chunk 64) through the port's
    wrapper on CPU tensors against JAX's kernel with the same q_start;
    batch row 0 has 200 real tokens (rows < 56 are padding: undefined)."""
    n, c = 256, 64
    q, k, v = _qkv(hk=hk)
    tl_ = np.asarray([200, 256], np.int32)
    for i in range(n // c):
        m = (i + 1) * c
        args = (q[:, :, i * c:m], k[:, :, :m], v[:, :, :m], tl_ - (n - m))
        want = np.asarray(jax_flash(*map(jnp.asarray, args), block_q=32,
                                    block_k=32, interpret=True,
                                    q_start=i * c))
        got = flash_causal_attention(*map(torch.from_numpy, args),
                                     q_start=i * c).numpy()
        rows = slice(max(0, 56 - i * c), None)
        np.testing.assert_allclose(got[0, :, rows], want[0, :, rows],
                                   rtol=KTOL, atol=KTOL)
        np.testing.assert_allclose(got[1], want[1], rtol=KTOL, atol=KTOL)


@pytest.mark.parametrize("q_start,true_len", [
    (0, (64, 40)),     # causal self tile, pad inside the tile
    (0, (64, 0)),      # a tile that is all padding
    (64, (64, 17)),    # history tile: every key precedes every query
    (128, (0, 64)),    # a history tile of padding only
])
def test_plain_flash_partials_match_pallas(q_start, true_len):
    """acc, m (base 2) and l against JAX's interpret-mode partials; rows
    with no visible key are exact: m = float32.min, l = 0, acc = 0."""
    q, k, v = _qkv(n=64, seed=q_start + true_len[1])
    tl_ = np.asarray(true_len, np.int32)
    want = jax_partials(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(tl_), block_q=32, block_k=32,
                        interpret=True, q_start=q_start)
    got = flash_attention_partials(*map(torch.from_numpy, (q, k, v, tl_)),
                                   q_start=q_start)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=KTOL,
                                   atol=KTOL)
    dead = np.asarray(want[2]) == 0  # no visible key
    if q_start == 0:
        assert dead[1, :, :64 - true_len[1]].all()
    assert np.all(got[1].numpy()[dead] == _NEG)
    assert np.all(got[2].numpy()[dead] == 0)
    assert np.all(got[0].numpy()[dead] == 0)


def test_plain_partials_merge_equals_rectangular_flash():
    """A history tile's partials merged in base 2 with the causal self
    tile's equal one rectangular flash call over both (the quantized
    carry's attention, before quantization)."""
    b, h, hk, d, c, hist = 1, 4, 2, 32, 64, 128
    n = hist + c
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(b, h, c, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, hk, n, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, hk, n, d)).astype(np.float32))
    want = flash_causal_attention(q, k, v, torch.tensor([n - 20]),
                                  q_start=hist)
    a = flash_attention_partials(q, k[:, :, :hist], v[:, :, :hist],
                                 torch.tensor([hist - 20]), q_start=hist)
    s = flash_attention_partials(q, k[:, :, hist:], v[:, :, hist:],
                                 torch.tensor([c]), q_start=0)
    acc, _, l = cp.merge_exp2(s, a)
    torch.testing.assert_close(acc / l[..., None], want, rtol=1e-5,
                               atol=1e-5)


def test_tile_partials_and_merge_match_jax():
    q, k, v = _qkv(n=64, seed=3)
    rng = np.random.default_rng(4)
    masks = [rng.random(size=(2, 64, 64)) < 0.5 for _ in range(2)]
    masks[1][0, :5] = False  # rows with nothing visible in one source
    masks[0][0, :3] = False  # ... and in both
    jp = [jattn.tile_attention_partials(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(m),
                                        q_block=32) for m in masks]
    tp = [plain.tile_attention_partials(*map(torch.from_numpy, (q, k, v, m)),
                                        q_block=32) for m in masks]
    for got, want in zip(tp, jp):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
    want = jattn.merge_partials_pair(*jp)
    got = plain.merge_partials_pair(*tp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _chunk_grouped_region(nbits, b=2, hk=2, n=256, d=32, chunk=64, seed=0):
    """A pa region with one K scale group per chunk, as JAX's quantized
    carry lays it out after ``prefill_finish_quant``."""
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.normal(size=(b, hk, d, n)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(b, hk, n, d)).astype(np.float32))
    kq = jquant.quantize(k, nbits=nbits, group_size=chunk)
    vq = jquant.quantize(v, nbits=nbits, group_size=d, pack_axis=-2)
    return jquant.QuantizedKVRegion(
        k=kq._replace(codes=jnp.swapaxes(kq.codes, -1, -2)), v=vq,
        k_out_idx=None, k_out_val=None, v_out_idx=None, v_out_val=None)


@pytest.mark.parametrize("nbits", [8, 4, 2])
@pytest.mark.parametrize("h", [2, 8])
def test_pa_region_k_groups_match_jax(nbits, h):
    """Gk = 4 K slot-groups (planes start on group boundaries) through the
    port's plain pa attention, and the kernel wrapper on CPU tensors."""
    reg = _chunk_grouped_region(nbits)
    rng = np.random.default_rng(nbits + h)
    q = rng.normal(size=(2, h, 32)).astype(np.float32)
    mask = rng.random(size=(2, 2, 250)) < 0.8
    mask[1, 0] = False  # an all-masked region row
    want = jquant.quant_region_attention_fused(
        jnp.asarray(q), reg, jnp.asarray(mask), num_slots=250, head_dim=32,
        nbits=nbits)
    treg = region_from_numpy(jax.tree_util.tree_map(np.asarray, reg),
                             device="cpu")
    assert treg.k.scale.shape[-2] == 4
    for fn in (quant_region_attention_fused, quant_fused_attention_pa):
        got = fn(torch.from_numpy(q), treg, torch.from_numpy(mask),
                 nbits=nbits)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# Engine.generate with prefill_chunk
# ---------------------------------------------------------------------------

COMP = dict(max_capacity_prompt=64, window_size=8)
ENG = dict(max_new_tokens=16, prefill_buckets=(256,))


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).tolist() for n in (179, 233, 20)]


_JAX_RUNS = {}


def _jax_chunked(jp, method):
    """JAX's chunked engine's output for ``method`` (run once a module)."""
    if method not in _JAX_RUNS:
        je = JaxEngine(jcfg.ModelSpec.tiny(),
                       jcfg.CompressionSpec(method=method, **COMP),
                       jcfg.EngineSpec(prefill_chunk=64, **ENG), jp)
        assert je.chunked_prefill_supported(256)
        _JAX_RUNS[method] = je.generate(_prompts())
    return _JAX_RUNS[method]


@pytest.mark.parametrize("method", ["fullkv", "snapkv", "pyramidkv", "h2o"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_chunked_generate_matches_jax_engine(params, method, use_pallas):
    """The bf16 carry: the port's chunked engine (the kernels' plain
    versions, or the plain path) against JAX's chunked engine."""
    jp, tp = params
    te = Engine(tcfg.ModelSpec.tiny(),
                tcfg.CompressionSpec(method=method, **COMP),
                tcfg.EngineSpec(prefill_chunk=64, use_pallas=use_pallas,
                                **ENG), tp, device="cpu")
    assert te.chunked_prefill_supported(256)
    want, got = _jax_chunked(jp, method), te.generate(_prompts())
    assert got.tokens == want.tokens
    assert got.kv_cache_bytes == want.kv_cache_bytes


def test_h2o_chunked_runs_score_pass(params, monkeypatch):
    """H2O's chunked prefill runs every chunk twice, the second time with
    the score accumulator, as the JAX engine lists its chunks
    (tok_starts [0, 1, 2, 3, 0, 1, 2, 3])."""
    calls = []
    orig = cp.prefill_chunk

    def spy(*a, chunk_start, score_acc=None, **kw):
        calls.append((chunk_start // 64, score_acc is not None))
        return orig(*a, chunk_start=chunk_start, score_acc=score_acc, **kw)

    monkeypatch.setattr(cp, "prefill_chunk", spy)
    te = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(method="h2o",
                                                            **COMP),
                tcfg.EngineSpec(prefill_chunk=64, **ENG), params[1],
                device="cpu")
    te.generate(_prompts()[:1], max_new_tokens=2)
    assert calls == [(i, p) for p in (False, True) for i in range(4)]


def test_unsupported_method_falls_back(params):
    """minference cannot chunk: the monolithic prefill runs, with the same
    tokens; a window wider than the chunk falls back too."""
    tp = params[1]
    spec = tcfg.ModelSpec.tiny()

    def eng(method, chunk, **comp):
        return Engine(spec, tcfg.CompressionSpec(method=method, **comp),
                      tcfg.EngineSpec(prefill_chunk=chunk, **ENG), tp,
                      device="cpu")

    chunked = eng("minference", 64)
    assert not chunked.chunked_prefill_supported(256)
    prompts = _prompts()
    assert (chunked.generate(prompts).tokens
            == eng("minference", None).generate(prompts).tokens)
    assert not eng("snapkv", 64, max_capacity_prompt=128,
                   window_size=96).chunked_prefill_supported(256)
    assert not eng("snapkv", 96, **COMP).chunked_prefill_supported(256)


#: the quantized carry's formats: (nbits, layout)
QFMT = {"kivi8": (8, "group"), "kivi4": (4, "group"), "kivi8-pa": (8, "pa"),
        "kivi4-pa": (4, "pa")}


@pytest.fixture(scope="module")
def quant_engines(params):
    """(JAX chunked engine, port chunked engine, port monolithic engine)
    of a quantized-carry format, built once a module and shared by the
    tests of that format: the JAX engine keeps its compiled chunk
    functions."""
    cache = {}

    def get(fmt):
        if fmt not in cache:
            cache[fmt] = _quant_engines(params, fmt)
        return cache[fmt]

    return get


def _quant_engines(params, fmt, chunk=64):
    nbits, layout = QFMT[fmt]
    comp = dict(method="fullkv", quant_method="kivi", nbits=nbits,
                q_group_size=16, q_layout=layout)
    eng = dict(max_new_tokens=8, prefill_buckets=(256,))
    je = JaxEngine(jcfg.ModelSpec.tiny(), jcfg.CompressionSpec(**comp),
                   jcfg.EngineSpec(prefill_chunk=chunk, **eng), params[0])
    # group regions decode through the f32 kernels, the route the JAX
    # engine takes under _FORCE_QUANT_KERNEL (test_torch_engine.py holds
    # the default route to JAX's default)
    f32 = dict(use_quant_kernel=layout == "group")
    tes = [Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                  tcfg.EngineSpec(prefill_chunk=c, **eng, **f32), params[1],
                  device="cpu") for c in (chunk, None)]
    return je, *tes


def _bucket(prompts):
    tokens = np.zeros((len(prompts), 256), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, 256 - len(p):] = p
    return tokens, np.asarray([len(p) for p in prompts], np.int32)


@pytest.mark.parametrize("fmt", list(QFMT))
def test_quant_carry_layer0_bits(params, quant_engines, fmt):
    """Layer 0's K/V depend only on the embeddings, so the chunk-local
    codes repacked region-global equal the monolithic prefill's region bit
    for bit (group layout: every leaf; pa: V, while K takes one scale group
    per chunk), and its codes equal JAX's carry's."""
    je, te, mono = quant_engines(fmt)
    assert te.chunked_prefill_supported(256)
    tokens, tl_ = _bucket(_prompts())
    _, got = te._run_chunked_prefill(256, torch.from_numpy(tokens),
                                     torch.from_numpy(tl_))
    _, want = tl.prefill(params[1], tcfg.ModelSpec.tiny(), mono.plan_for(256),
                         torch.from_numpy(tokens), torch.from_numpy(tl_))
    pa = QFMT[fmt][1] == "pa"
    for part in ("k", "v"):
        for leaf in ("codes", "scale", "zero"):
            g = getattr(getattr(got.quant, part), leaf)
            w = getattr(getattr(want.quant, part), leaf)
            if pa and part == "k" and leaf != "codes":
                assert g.shape[-2] == 256 // 64 and w.shape[-2] == 1
            elif not (pa and part == "k"):
                assert g.shape == w.shape and torch.equal(g[0], w[0])
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.positions, want.positions)
    _, jc = je._run_chunked_prefill(256, jnp.asarray(tokens, jnp.int32),
                                    jnp.asarray(tl_), jax.random.PRNGKey(0))
    for part in ("k", "v"):
        jq, tq = getattr(jc.quant, part), getattr(got.quant, part)
        for leaf in ("codes", "scale", "zero"):
            assert tuple(getattr(jq, leaf).shape) == tuple(
                getattr(tq, leaf).shape)
        assert np.array_equal(np.asarray(jq.codes)[0], tq.codes[0].numpy())


@pytest.mark.parametrize("fmt", list(QFMT))
def test_quant_carry_generate_matches_jax_engine(quant_engines, fmt):
    """Tokens, decode steps and cache bytes of the quantized carry against
    JAX's chunked engine (its group regions decode through its region
    kernel in interpret mode, as the port's do; pa through the fused XLA
    path, which the port's plain pa function mirrors)."""
    je, te, _ = quant_engines(fmt)
    prompts = _prompts()
    force = jl._FORCE_QUANT_KERNEL
    force[0] = QFMT[fmt][1] == "group"
    try:
        want = je.generate(prompts)
    finally:
        force[0] = False
    got = te.generate(prompts)
    assert got.tokens == want.tokens
    assert got.decode_steps == want.decode_steps
    assert got.kv_cache_bytes == want.kv_cache_bytes


@pytest.mark.cuda
def test_cuda_chunk_kernels_match_plain_on_card():
    """flash with q_start, both partials modes and the pa kernel with K
    groups against their plain versions in bf16 on the card
    (``chip_smoke.py`` covers the main-path shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pyramidkv_tpu_torch.ops.quant import quantize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, hk, n, d, c = 2, 8, 2, 512, 128, 128

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).bfloat16()

    def err(got, want):
        rms = want.float().square().mean(-1, keepdim=True).sqrt()
        lim = 2.0 ** -6 * want.float().abs() + 2.0 ** -5 * rms
        return float(((got.float() - want.float()).abs() / lim).max())

    q, k, v = rnd(b, h, n, d), rnd(b, hk, n, d), rnd(b, hk, n, d)
    tl_ = torch.tensor([512, 300], dtype=torch.int32, device=dev)
    for i in range(n // c):
        e = (i + 1) * c
        args = (q[:, :, i * c:e].contiguous(), k[:, :, :e].contiguous(),
                v[:, :, :e].contiguous(), tl_ - (n - e))
        got = flash_causal_attention(*args, q_start=i * c)
        want = plain.causal_prefill_attention(*args[:3], true_len=args[3],
                                              q_start=i * c)
        rows = slice(max(0, 212 - i * c), None)
        assert err(got[1, :, rows], want[1, :, rows]) <= 1
        assert err(got[0], want[0]) <= 1
    for q_start, ktl in ((0, [128, 50]), (128, [128, 0])):
        args = (q[:, :, :c].contiguous(), k[:, :, :c].contiguous(),
                v[:, :, :c].contiguous(),
                torch.tensor(ktl, dtype=torch.int32, device=dev))
        ga, gm, gl = flash_attention_partials(*args, q_start=q_start)
        wa, wm, wl = plain.flash_partials_plain(*args, q_start=q_start)
        live = wl > 0
        assert torch.equal(live, gl > 0)
        assert err((ga / gl.clamp_min(1e-30)[..., None])[live],
                   (wa / wl.clamp_min(1e-30)[..., None])[live]) <= 1
        assert float((gm - wm)[live].abs().max()) <= 2.0 ** -12 * max(
            1.0, float(wm[live].abs().max()))
        assert bool((gm[~live] == _NEG).all() and (ga[~live] == 0).all())
    # pa region, K groups of 128 slots (one per chunk), 4-bit codes
    kq = quantize(rnd(b, hk, d, n).float(), nbits=4, group_size=c)
    vq = quantize(rnd(b, hk, n, d).float(), nbits=4, group_size=d,
                  pack_axis=-2)
    from pyramidkv_tpu_torch.ops.quant import QuantizedKVRegion
    reg = QuantizedKVRegion(
        k=kq._replace(codes=kq.codes.transpose(-1, -2).contiguous()), v=vq)
    qd = rnd(b, h, d)
    mask = torch.rand((b, hk, n), generator=g, device=dev) < 0.8
    got = quant_fused_attention_pa(qd, reg, mask, nbits=4)
    want = quant_region_attention_fused(qd, reg, mask, nbits=4)
    assert err(got[0] / got[2][..., None], want[0] / want[2][..., None]) <= 1
