"""KIVI caches on Gemma-2 on the port, against the JAX package on the CPU.

Gemma-2 scales its attention by ``query_pre_attn_scalar^-0.5`` and caps
each logit (cap * tanh(s / cap), the masks after).  The port's KIVI region
kernels take both since they were ported at D = 256; on the CPU their
wrappers run the plain versions, held here to the JAX package's functions
on the same seeded numpy inputs (``region_from_numpy`` carries a JAX region
across):

- the factored plain function (``quant_region_attention_fused``, group and
  pa layouts, 2/4/8 bits, D = 16 and 256) against JAX's XLA function, with
  scale 32^-0.5 (the tiny Gemma-2's: not a power of two, so a query folded
  to bf16 before the scale rounds elsewhere) and cap 5: normalised outputs
  within 1e-4 and m, l within 1e-5 (``test_torch_quant.py``'s bounds);
- the f32 route (``quant_decode_attention_tiled``) against JAX's tiled
  Pallas kernel in interpret mode with the scale, the cap and ``mm_bf16``
  on and off, within 2e-4 (``test_torch_quant.py``'s);
- ``decode_attention_partials`` / ``tile_attention_partials`` with the
  scale and the cap against JAX's within 1e-5;
- every check asserts that the same call without the cap misses its bound:
  the cap bends these inputs;
- the kernels' schedules (``region_split_plain`` in its three modes,
  ``pa_split_plain``) at D = 256 under the cap against the unsplit plain
  versions, a wholly masked split and a region with no visible slot
  included (m = float32.min, l = 0: never -cap);
- live JAX ``Engine.generate`` against the port's on the tiny Gemma-2 of
  ``test_torch_gemma2.py`` (bucket 128, prompts of 100 / 77 / 30 tokens,
  window 16): snapkv kivi4 group (the default factored route), fullkv
  kivi4-pa, fullkv kivi2 group on the tiled route with
  ``PKV_QUANT_MM_BF16=1`` (the JAX engine reaches its tiled kernel in
  interpret mode through ``_FORCE_QUANT_KERNEL`` and a lowered
  ``_QUANT_CHUNK_THRESHOLD``; the port then takes ``mm_bf16`` on the same
  regions), fullkv kivi4 group chunked at 32 over prompts longer than the
  window (the full layers see every earlier chunk, the sliding ones skip
  the tiles outside their window), and a 70-token prefix handle on the
  quantized carry: tokens, decode steps and cache bytes equal, last-position
  prefill logits within 1e-4 (with the handle, of the rows that resume on
  the handle's chunk grid).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.kernels.quant_decode import (
    quant_decode_attention_tiled as jax_qda_tiled)
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.ops import attention as jatt
from pyramidkv_tpu.ops import quant as jq
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.kernels import quant_decode as qd
from pyramidkv_tpu_torch.kernels import (quant_decode_attention_tiled,
                                         quant_fused_attention_group,
                                         quant_fused_attention_pa)
from pyramidkv_tpu_torch.kernels.quant_fused_decode import pa_split_plain
from pyramidkv_tpu_torch.models import llama as tl
from pyramidkv_tpu_torch.models.convert import region_from_numpy
from pyramidkv_tpu_torch.ops import attention as tatt
from pyramidkv_tpu_torch.ops import quant as tq
from test_torch_gemma2 import COMP, GEMMA
from test_torch_gemma2 import rig  # noqa: F401 (module fixture)
from test_torch_mistral import (BUCKET, _assert_same, _prefill_logits,
                                _prompts)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCALE = 32.0 ** -0.5   # the tiny Gemma-2's query_pre_attn_scalar 32
CAP = 5.0              # its attention logit cap
AKW = dict(scale=SCALE, softcap=CAP)
NEG = float(np.finfo(np.float32).min)
TOL = 1e-4             # prefill logits (tests/test_torch_model.py)
CHUNK = 32
KIVI = dict(quant_method="kivi", q_group_size=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _region(nbits, hk, s, d, layout, group, seed, b=1, g=2):
    """(q, mask, JAX region, port region): channel-scaled keys, the query
    at std 2 so that the cap bends the logits."""
    rng = np.random.default_rng(seed)
    q = 2 * rng.normal(size=(b, hk * g, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    k *= np.exp(rng.normal(size=(1, 1, 1, d))).astype(np.float32)
    v = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    mask = rng.random((b, hk, s)) > 0.25
    jreg = jq.quantize_kv_region(jnp.asarray(k), jnp.asarray(v), nbits=nbits,
                                 group_size=group, layout=layout)
    return q, mask, jreg, region_from_numpy(jreg, device="cpu")


def _norm(parts):
    acc, _, l = (np.asarray(x) for x in parts)
    return acc / np.maximum(l, 1e-30)[..., None]


def _close(got, want, tol, m_tol):
    """Normalised outputs within ``tol``, m and l within ``m_tol``."""
    return (np.allclose(_norm(got), _norm(want), rtol=tol, atol=tol)
            and np.allclose(np.asarray(got[1]), np.asarray(want[1]),
                            rtol=m_tol, atol=m_tol)
            and np.allclose(np.asarray(got[2]), np.asarray(want[2]),
                            rtol=m_tol, atol=m_tol))


# ---------------------------------------------------------------------------
# the plain functions against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 256])
@pytest.mark.parametrize("nbits", [8, 4, 2])
@pytest.mark.parametrize("layout", ["group", "pa"])
def test_fused_region_matches_jax(layout, nbits, d):
    """The factored function (JAX's default decode of both layouts under a
    cap) with the scale and the cap, through the wrapper the port routes
    each layout to, against JAX's ``quant_region_attention_fused``."""
    s = 128
    q, mask, jreg, treg = _region(nbits, 2, s, d, layout, 16, nbits + d)
    want = jq.quant_region_attention_fused(
        jnp.asarray(q), jreg, jnp.asarray(mask), num_slots=s, head_dim=d,
        nbits=nbits, **AKW)
    fn = (quant_fused_attention_pa if layout == "pa"
          else quant_fused_attention_group)
    got = fn(_t(q), treg, _t(mask), nbits=nbits, **AKW)
    assert _close(got, want, 1e-4, 1e-5)
    assert not _close(fn(_t(q), treg, _t(mask), nbits=nbits, scale=SCALE),
                      want, 1e-4, 1e-5)


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("nbits", [8, 4, 2])
def test_f32_route_matches_tiled_kernel(nbits, mm_bf16):
    """The f32 route with the scale, the cap and ``mm_bf16`` against JAX's
    tiled kernel in interpret mode (tile 256: its online softmax carried
    across tiles; an odd region of 1000 slots pads to S_pad), as
    ``test_torch_quant.py`` holds it uncapped."""
    q, mask, jreg, treg = _region(nbits, 2, 1000, 32, "group", 32,
                                  nbits * 7 + mm_bf16)
    s_pad = jreg.k.codes.shape[-2] * (8 // nbits)
    m_pad = np.zeros(mask.shape[:2] + (s_pad,), bool)
    m_pad[..., :1000] = mask
    want = jax_qda_tiled(
        jnp.asarray(q), jreg.k.codes, jreg.k.scale[..., 0],
        jreg.k.zero[..., 0], jreg.v.codes, jreg.v.scale[..., 0],
        jreg.v.zero[..., 0], jnp.asarray(m_pad), nbits=nbits, group_size=32,
        tile=256, interpret=True, mm_bf16=mm_bf16, **AKW)
    got = quant_decode_attention_tiled(_t(q), treg, _t(mask), nbits=nbits,
                                       mm_bf16=mm_bf16, **AKW)
    assert _close(got, want, 2e-4, 2e-4)
    assert not _close(quant_decode_attention_tiled(
        _t(q), treg, _t(mask), nbits=nbits, mm_bf16=mm_bf16, scale=SCALE),
        want, 2e-4, 2e-4)
    # the other mode is another function: bf16 folds move the logits
    other = quant_decode_attention_tiled(_t(q), treg, _t(mask), nbits=nbits,
                                         mm_bf16=not mm_bf16, **AKW)
    assert not np.array_equal(other[1].numpy(), got[1].numpy())


@pytest.mark.parametrize("d", [16, 256])
def test_partials_match_jax(d):
    """The bf16 tail's decode partials and the quantized carry's tile
    partials with the scale and the cap; a row with nothing visible keeps
    m = float32.min and l = 0."""
    rng = np.random.default_rng(d)
    b, h, hk, s, t = 2, 4, 2, 40, 24
    q = 2 * rng.normal(size=(b, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hk, s, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((b, hk, s)) > 0.3
    mask[1, 0] = False
    want = jatt.decode_attention_partials(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        **AKW)
    got = tatt.decode_attention_partials(_t(q), _t(k), _t(v), _t(mask),
                                         **AKW)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert (got[1][1, :2] == NEG).all() and (got[2][1, :2] == 0).all()
    assert not np.allclose(tatt.decode_attention_partials(
        _t(q), _t(k), _t(v), _t(mask), scale=SCALE)[1].numpy(),
        np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    qt = 2 * rng.normal(size=(b, h, t, d)).astype(np.float32)
    tmask = rng.random((b, t, s)) > 0.3
    tmask[0, 3] = False
    want = jatt.tile_attention_partials(
        jnp.asarray(qt), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tmask),
        **AKW)
    got = tatt.tile_attention_partials(_t(qt), _t(k), _t(v), _t(tmask),
                                       **AKW)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert (got[1][0, :, 3] == NEG).all() and (got[2][0, :, 3] == 0).all()


# ---------------------------------------------------------------------------
# the kernels' schedules at D = 256 under the cap
# ---------------------------------------------------------------------------


def _check_schedule(got, want, rtol, row_tol, l_tol):
    acc, m, l = (x.numpy() for x in got)
    wacc, wm, wl = (x.numpy() for x in want)
    live = wl > 0
    assert (live == (l > 0)).all()
    assert (m[~live] == NEG).all() and (acc[~live] == 0).all()
    o, ow = _norm(got)[live], _norm(want)[live]
    rms = np.sqrt(np.mean(ow ** 2, -1, keepdims=True))
    assert (np.abs(o - ow) <= rtol * np.abs(ow) + row_tol * rms).all()
    np.testing.assert_allclose(m[live], wm[live], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l[live], wl[live], rtol=l_tol)


@pytest.mark.parametrize("mode", ["f32", "mm_bf16", "fold"])
def test_group_schedule_at_d256_under_the_cap(mode):
    """``region_split_plain`` at D = 256 under the cap on plans of 1, 2 and
    4 splits with split 1 masked on every plane (it drops out), and a
    region with nothing visible (m = float32.min, l = 0), against the
    unsplit plain version: the f32 modes within 2e-5, the folded one
    within 2^-6 of the element plus 2^-6 of the row (p rounded at each
    split's max; ``test_torch_quant_split.py``'s bounds)."""
    nbits = 4
    q, mask, _, treg = _region(nbits, 2, 512, 256, "group", 64, 5, b=2)
    w = treg.k.codes.shape[2]
    mask &= ~((np.arange(512) % w >= 64) & (np.arange(512) % w < 128))
    mask[1, 1] = False
    qt, mt = _t(q).to(torch.bfloat16), _t(mask)
    fold, mm = mode == "fold", mode == "mm_bf16"
    want = (tq.quant_region_attention_fused(qt, treg, mt, nbits=nbits, **AKW)
            if fold else tq.quant_decode_attention_plain(
                qt, treg, mt, nbits=nbits, mm_bf16=mm, **AKW))
    assert (want[1][1, 2:] == NEG).all() and (want[2][1, 2:] == 0).all()
    tol = (2.0 ** -6, 2.0 ** -6, 2.0 ** -7) if fold else (2e-5, 2e-5, 2e-5)
    for plan in ((1, w), (2, 128), (4, 64)):
        got = qd.region_split_plain(qt, treg, mt, nbits=nbits, plan=plan,
                                    fold=fold, mm_bf16=mm, **AKW)
        _check_schedule(got, want, *tol)
        assert (got[1][1, 2:] == NEG).all() and (got[2][1, 2:] == 0).all()


@pytest.mark.parametrize("nbits,group", [(4, 64), (2, 64), (4, 32), (8, 64)])
@pytest.mark.parametrize("bhk,w_slots", [(32, 8192), (64, 2048)])
def test_split_plans_at_d256(nbits, group, bhk, w_slots):
    """The group kernel's plans at D = 256 (one block an SM, its ring 128
    KB) for Gemma-2-9B's regions (fullkv: B x Hk = 32 regions of 8192
    slots; per-head caches: 64 of 2048): the splits cover the byte-rows,
    their K tables fit shared memory whole (no staging windows) at G = 2 in
    every mode; the fullkv kivi4 and kivi2 regions take one wave of the
    card's 132 SMs (4 splits and the merge kernel: clusters at D = 256 hold
    2 splits), the per-head caches' a cluster of 2."""
    per = 8 // nbits
    w = w_slots // per
    nsplit, rows = qd.split_plan(torch.device("cpu"), bhk, w, nbits, group,
                                 256)
    assert (nsplit - 1) * rows < w <= nsplit * rows and rows % 32 == 0
    ng = w_slots // group
    for fold in (False, True):
        args = (2, nbits, fold, rows, group, ng, 256, 256 // group, 32)
        assert qd.region_smem_bytes(*args, None, 256) <= qd.MAX_SMEM
        assert qd.region_window(*args, 256) == rows
    if bhk == 32 and group == 64 and nbits in (2, 4):
        assert nsplit == 4 and bhk * nsplit <= qd.H100_SMS
        assert qd.region_kernels(nsplit, 256) == 2
    if bhk == 64 and nbits == 4:
        assert nsplit == 2 and qd.region_kernels(nsplit, 256) == 1


def test_pa_schedule_at_d256_under_the_cap():
    """``pa_split_plain`` at D = 256 under the cap (the carry's 4 K groups
    too) against the unsplit plain version, a split and a region wholly
    masked (``test_torch_pa_split.py``'s bounds)."""
    q, mask, _, treg = _region(4, 2, 512, 256, "pa", 64, 6, b=2)
    w = treg.k.codes.shape[2]
    mask &= ~((np.arange(512) % w >= 64) & (np.arange(512) % w < 128))
    mask[1, 1] = False
    qt, mt = _t(q), _t(mask)
    want = tq.quant_region_attention_fused(qt, treg, mt, nbits=4, **AKW)
    got = pa_split_plain(qt, treg, mt, nbits=4, plan=(4, 64), **AKW)
    _check_schedule(got, want, 2.0 ** -6, 2.0 ** -5, 2.0 ** -10)
    assert (got[1][1, 2:] == NEG).all() and (got[2][1, 2:] == 0).all()
    # the chunked carry's K groups: one per 128 slots
    s_pad = w * 2
    kt = torch.nn.functional.pad(tq.dequantize_kv_region(
        treg, num_slots=512, head_dim=256, nbits=4)[0].transpose(2, 3),
        (0, s_pad - 512))
    kq = tq.quantize(kt, nbits=4, group_size=s_pad // 4)
    reg4 = treg._replace(k=kq._replace(
        codes=kq.codes.transpose(-1, -2).contiguous()))
    want = tq.quant_region_attention_fused(qt, reg4, mt, nbits=4, **AKW)
    got = pa_split_plain(qt, reg4, mt, nbits=4, plan=(4, 64), **AKW)
    _check_schedule(got, want, 2.0 ** -6, 2.0 ** -5, 2.0 ** -10)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(rig):  # noqa: F811
    """(JAX engine, port engine) per configuration, built once a module."""
    js, ts, params = rig
    jp, tp = params["f32"]
    cache = {}

    def get(comp, eng):
        key = repr((sorted(comp.items()), sorted(eng.items())))
        if key not in cache:
            comp = dict(COMP, **KIVI, **comp)
            eng = dict(max_new_tokens=8, prefill_buckets=(BUCKET,), **eng)
            cache[key] = (
                JaxEngine(js, jcfg.CompressionSpec(**comp),
                          jcfg.EngineSpec(**eng), jp),
                Engine(ts, tcfg.CompressionSpec(**comp),
                       tcfg.EngineSpec(**eng), tp, device="cpu"))
        return cache[key]

    return get


#: name -> (CompressionSpec arguments beyond COMP and KIVI, EngineSpec
#: arguments)
CASES = {
    "snapkv kivi4 group": (dict(method="snapkv", nbits=4), {}),
    "fullkv kivi4-pa": (dict(method="fullkv", nbits=4, q_layout="pa"), {}),
    "fullkv kivi4 group chunk": (dict(method="fullkv", nbits=4),
                                 dict(prefill_chunk=CHUNK)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax_engine(engines, case):
    comp, eng = CASES[case]
    je, te = engines(comp, eng)
    assert te.chunked_prefill_supported(BUCKET) == ("chunk" in case)
    prompts = _prompts()
    assert max(len(p) for p in prompts) > GEMMA["sliding_window"] * 2
    _assert_same(te.generate(prompts), je.generate(prompts))
    got, want = _prefill_logits(je, te, prompts)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_generate_mm_bf16_matches_jax_tiled_kernel(engines, monkeypatch):
    """fullkv kivi2 group on the tiled route with ``PKV_QUANT_MM_BF16=1``:
    the JAX engine's tiled kernel (interpret mode; every region long, the
    tile gcd(S_pad, tile)) with its bf16 dots, the port's f32 route in the
    ``mm_bf16`` mode on the same regions."""
    monkeypatch.setenv("PKV_QUANT_MM_BF16", "1")
    hooks = ((jl._FORCE_QUANT_KERNEL, True), (jl._QUANT_CHUNK_THRESHOLD, 16),
             (tl.QUANT_CHUNK_THRESHOLD, 16), (tl.FORCE_TILE_ALIGNED, True))
    old = [h[0] for h, _ in hooks]
    for h, value in hooks:
        h[0] = value
    try:
        je, te = engines(dict(method="fullkv", nbits=2),
                         dict(use_quant_tiled=True))
        assert te.f32_quant and tl.region_mm_bf16(
            te.engine_spec, te.model_spec, te.comp_spec, BUCKET)
        prompts = _prompts()
        _assert_same(te.generate(prompts), je.generate(prompts))
    finally:
        for (h, _), value in zip(hooks, old):
            h[0] = value
    # without the switch the port leaves the mode off, as JAX's engine does
    monkeypatch.setenv("PKV_QUANT_MM_BF16", "0")
    assert not tl.region_mm_bf16(te.engine_spec, te.model_spec, te.comp_spec,
                                 BUCKET)


def test_prefix_handle_on_the_quantized_carry(engines):
    """A 70-token prefix (64 cached columns, past the 16-token window)
    shared by prompts of 128, 96 and 77 tokens through the quantized carry
    (fullkv kivi4 group, chunk 32): tokens against JAX's engine with its own
    handle, and the prefill logits of the rows whose pad is a whole number
    of chunks within 1e-4.  The 77-token row resumes on another chunk grid
    and requantizes its 4-bit codes there, a grid that f32 noise moves
    between the frameworks (``test_torch_prefix.py``: only its tokens are
    held)."""
    je, te = engines(dict(method="fullkv", nbits=4),
                     dict(prefill_chunk=CHUNK))
    prefix = np.random.default_rng(1).integers(1, 250, size=70).tolist()
    prompts = _prompts(seed=2, prefix=prefix, lens=(128, 96, 77))
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    assert th.is_quant and jh.is_quant and th.full_len == jh.full_len == 64
    _assert_same(te.generate(prompts, prefix=th),
                 je.generate(prompts, prefix=jh))
    got, want = _prefill_logits(je, te, prompts, jh, th)
    np.testing.assert_allclose(got[:2], want[:2], rtol=TOL, atol=TOL)
