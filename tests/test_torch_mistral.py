"""Mistral's uniform sliding window on the port, against the JAX package on
the CPU in f32.

The configuration of ``tests/test_mistral_adakv_headkv.py``:
``ModelSpec.tiny(sliding_window=48)`` (GQA 4/2 heads), f32 weights from
``init_params(..., PRNGKey(0))`` through numpy and ``params_from_numpy``,
bucket 128, prompts of 100 / 77 / 30 tokens (the longest past the window).
Each engine case runs a live JAX ``Engine.generate`` and the port's on the
same prompts: greedy tokens, decode steps and cache bytes must be equal,
and the last-position prefill logits agree within 1e-4 (the bound of
``tests/test_torch_model.py``: the same f32 products summed in other
orders over 4 layers).  The cases: every method of ``METHODS`` (MInference
below ``minference_dense_below``, where the dense attention takes the
window, and above it, where JAX's sparse attention ignores a uniform
window and the port's does too); chunked prefill with the bf16 carry and
with the quantized carry (chunk 32: chunk 3's first row is 65 rows past
chunk 0's last key, so that history tile is wholly outside the window);
``prefill_two_pass``; a prefix handle of 64 tokens, longer than the
window; int4 weights.  The decode window masks fullkv and minference only:
a compressed cache attends every kept key (JAX ``llama.py:932-951``).

Kernel level, the plain versions the CPU runs (and the oracles of the
kernels' schedules) with a window against JAX's functions on the same
numpy inputs, within 2e-5 as ``test_torch_chunked.py`` holds the unwindowed
cases: flash with ``q_start`` chunk by chunk (the window cases of
``tests/test_chunked_prefill.py:57-86``) and with a pad and a window edge
in one 128-key tile; ``flash_attention_partials`` on a history tile at its
true distance, rows wholly outside the window exact (m = float32.min,
l = 0, acc = 0); the decode and pa region attention on window-shaped masks
(leading slots hidden, a band of W slots and the decode slots visible),
within 2e-4 (decode) and the pa bound of ``test_torch_pa_split.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.kernels import flash_attention_partials as jax_partials
from pyramidkv_tpu.kernels import flash_causal_attention as jax_flash
from pyramidkv_tpu.kernels.decode_attn import decode_attention_pallas
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu.models import weights as jw
from pyramidkv_tpu.ops import quant as jq
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.kernels import (decode_attention,
                                         flash_attention_partials,
                                         flash_causal_attention,
                                         quant_fused_attention_pa)
from pyramidkv_tpu_torch.kernels.decode_attn import (
    decode_attention_split_plain, decode_split_plan)
from pyramidkv_tpu_torch.kernels.flash_prefill import flash_tiled_plain
from pyramidkv_tpu_torch.models import llama as tl
from pyramidkv_tpu_torch.models.convert import (params_from_numpy,
                                                region_from_numpy)
from pyramidkv_tpu_torch.ops import quant as tq
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WINDOW, BUCKET, CHUNK = 48, 128, 32
LENS = (100, 77, 30)
TOL = 1e-4      # prefill logits (tests/test_torch_model.py)
KTOL = 2e-5     # flash and partials (tests/test_torch_chunked.py)
DTOL = 2e-4     # decode (tests/test_torch_decode_split.py)
_NEG = float(np.finfo(np.float32).min)
COMP = dict(max_capacity_prompt=24, window_size=4, kernel_size=5,
            recent_size=8, minference_vertical_size=16,
            minference_slash_size=16, minference_last_q=8)
#: seeded synthetic retrieval-head scores, one per (layer, head)
HEADKV_CAPS = jcfg.headkv_capacity_from_scores(
    np.random.default_rng(17).random(16).tolist(), 4, 4, 24)
KIVI4 = dict(method="fullkv", quant_method="kivi", nbits=4, q_group_size=16)

#: name -> (CompressionSpec arguments beyond COMP, EngineSpec arguments,
#: weights).  Every method of METHODS, then the other paths.
CASES = {
    **{m: (dict(method=m), {}, "f32") for m in jcfg.METHODS
       if m != "headkv"},
    "headkv": (dict(method="headkv", head_capacity=HEADKV_CAPS), {}, "f32"),
    "minference sparse": (dict(method="minference", minference_dense_below=0),
                          {}, "f32"),
    **{f"{m} chunk": (dict(method=m), dict(prefill_chunk=CHUNK), "f32")
       for m in ("fullkv", "snapkv", "pyramidkv", "h2o")},
    "fullkv kivi4 chunk": (dict(KIVI4, q_layout="group"),
                           dict(prefill_chunk=CHUNK), "f32"),
    "fullkv kivi4-pa chunk": (dict(KIVI4, q_layout="pa"),
                              dict(prefill_chunk=CHUNK), "f32"),
    "fullkv kivi4-pa": (dict(KIVI4, q_layout="pa"), {}, "f32"),
    "snapkv two-pass": (dict(method="snapkv"), dict(prefill_two_pass=True),
                        "f32"),
    "fullkv int4": (dict(method="fullkv"), {}, "int4"),
    "snapkv int4": (dict(method="snapkv"), {}, "int4"),
}


@pytest.fixture(scope="module")
def rig():
    """The specs and both packages' params, converted once: f32 and int4."""
    js = jcfg.ModelSpec.tiny(sliding_window=WINDOW)
    jp = jl.init_params(js, jax.random.PRNGKey(0), dtype=jnp.float32)
    j4 = jw.quantize_weights(jp, nbits=4)
    params = {name: (p, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu"))
        for name, p in (("f32", jp), ("int4", j4))}
    return js, tcfg.ModelSpec.tiny(sliding_window=WINDOW), params


def _prompts(seed=7, prefix=(), lens=LENS):
    rng = np.random.default_rng(seed)
    return [list(prefix) + rng.integers(1, 256, size=n - len(prefix)).tolist()
            for n in lens]


@pytest.fixture(scope="module")
def engines(rig):
    """(JAX engine, port engine) per configuration, built once a module
    and shared by every test that runs it: a JAX engine keeps its compiled
    functions and its generate outputs across the tests.  JAX's engine
    prefills through XLA on the CPU whatever ``prefill_two_pass`` says
    (``pyramidkv_tpu/engine.py:336-338``), so a two-pass port engine
    shares the one-pass JAX engine of its configuration."""
    js, ts, params = rig
    jax_cache, port_cache = {}, {}

    def get(comp, eng, weights="f32"):
        jp, tp = params[weights]
        comp = dict(COMP, **comp)
        eng = dict(max_new_tokens=8, prefill_buckets=(BUCKET,), **eng)
        jeng = {k: v for k, v in eng.items() if k != "prefill_two_pass"}
        jkey = repr((sorted(comp.items()), sorted(jeng.items()), weights))
        tkey = repr((sorted(comp.items()), sorted(eng.items()), weights))
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


class _Shared:
    """A JAX engine whose ``generate`` output is kept per prompt list
    (greedy decoding: the same prompts give the same output); calls with
    other arguments (a prefix handle) run."""

    def __init__(self, engine):
        self.engine = engine
        self._outs = {}

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def generate(self, prompts, **kw):
        if kw:
            return self.engine.generate(prompts, **kw)
        key = repr(prompts)
        if key not in self._outs:
            self._outs[key] = self.engine.generate(prompts)
        return self._outs[key]


def _bucket(prompts):
    tokens = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, BUCKET - len(p):] = p
    return tokens, np.asarray([len(p) for p in prompts], np.int32)


def _prefill_logits(je, te, prompts, jh=None, th=None):
    """Both engines' last-position prefill logits on the path ``generate``
    takes (chunked where the plan supports it, with the handles)."""
    tokens, lens = _bucket(prompts)
    rng = jax.random.PRNGKey(0)
    jt, jl_ = jnp.asarray(tokens), jnp.asarray(lens)
    tt, tl_ = torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(lens)
    if te.chunked_prefill_supported(BUCKET):
        kw = dict(lens=[len(p) for p in prompts]) if th is not None else {}
        want, _ = je._run_chunked_prefill(BUCKET, jt, jl_, rng, prefix=jh,
                                          **kw)
        got, _ = te._run_chunked_prefill(BUCKET, tt, tl_, prefix=th, **kw)
    else:
        want, _ = je._get_prefill(BUCKET)(je.params, jt, jl_, rng)
        got, _ = tl.prefill(te.params, te.model_spec, te.plan_for(BUCKET),
                            tt, tl_, attention_impl=te.attention_impl,
                            prefill_two_pass=te.engine_spec.prefill_two_pass)
    return got.numpy(), np.asarray(want)


def _assert_same(got, want):
    assert got.tokens == want.tokens
    assert got.decode_steps == want.decode_steps
    assert got.kv_cache_bytes == want.kv_cache_bytes


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax_engine(engines, case):
    comp, eng, weights = CASES[case]
    je, te = engines(comp, eng, weights)
    if "chunk" in case:
        assert te.chunked_prefill_supported(BUCKET)
    prompts = _prompts()
    _assert_same(te.generate(prompts), je.generate(prompts))
    got, want = _prefill_logits(je, te, prompts)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_prefix_handle_longer_than_window(engines):
    """A 70-token prefix (64 cached columns, past the 48-token window)
    shared by prompts of 128, 100 and 77 tokens: the resumed chunks attend across the
    handle's boundary under the window.  Tokens and prefill logits against
    JAX's engine with its own handle, and the port's tokens with and
    without the handle."""
    je, te = engines(dict(method="snapkv"), dict(prefill_chunk=CHUNK))
    prefix = np.random.default_rng(1).integers(1, 250, size=70).tolist()
    prompts = _prompts(seed=2, prefix=prefix, lens=(128, 100, 77))
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    assert th.full_len == jh.full_len == 64 > WINDOW
    np.testing.assert_allclose(th.state.k.numpy(), np.asarray(jh.state.k),
                               rtol=TOL, atol=TOL)
    got = te.generate(prompts, prefix=th)
    _assert_same(got, je.generate(prompts, prefix=jh))
    assert got.tokens == te.generate(prompts).tokens
    got, want = _prefill_logits(je, te, prompts, jh, th)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_refusals(rig):
    """Per-layer attention types are ported: ``layer_types`` all sliding is
    the uniform window (the same tokens), alternating ones run snapkv
    (Gemma-2's layout; held to JAX in test_torch_gemma2.py), and so do
    H2O, MInference and ThinK (held to JAX in
    test_torch_gemma2_methods.py) and, since the quantized carry took each
    layer's window, KIVI caches (held to JAX in
    test_torch_gemma2_kivi.py)."""
    tp = rig[2]["f32"][1]
    comp = tcfg.CompressionSpec(method="snapkv", **COMP)
    es = tcfg.EngineSpec(max_new_tokens=8, prefill_buckets=(BUCKET,))
    prompts = _prompts()
    uniform = Engine(rig[1], comp, es, tp, device="cpu").generate(prompts)
    same = Engine(tcfg.ModelSpec.tiny(sliding_window=WINDOW,
                                      layer_types=("sliding_attention",) * 4),
                  comp, es, tp, device="cpu").generate(prompts)
    assert same.tokens == uniform.tokens
    alt = tcfg.ModelSpec.tiny(sliding_window=WINDOW, layer_types=(
        "sliding_attention", "full_attention") * 2)
    Engine(alt, comp, es, tp, device="cpu")
    for kw in (dict(method="h2o"), dict(method="minference"),
               dict(method="think")):
        Engine(alt, tcfg.CompressionSpec(**dict(COMP, **kw)), es, tp,
               device="cpu")
    for layout in ("group", "pa"):
        Engine(alt, tcfg.CompressionSpec(**dict(COMP, **KIVI4,
                                                q_layout=layout)),
               tcfg.EngineSpec(max_new_tokens=8, prefill_buckets=(BUCKET,),
                               prefill_chunk=CHUNK), tp, device="cpu")


# ---------------------------------------------------------------------------
# Kernel level: the windowed cases of the plain versions
# ---------------------------------------------------------------------------


def _qkv(b=2, h=4, hk=2, n=256, nq=None, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in (
        (b, h, nq or n, d), (b, hk, n, d), (b, hk, n, d)))


@pytest.mark.parametrize("window", [96, 40])
def test_q_start_flash_window_matches_pallas(window):
    """Every chunk of a 256-token bucket (chunk 64) with a window, through
    the port's wrapper on CPU tensors and through the kernel's schedule
    (``flash_tiled_plain``), against JAX's kernel with the same q_start
    and window (``tests/test_chunked_prefill.py:57-86``); batch row 0 has
    200 real tokens (its first 56 rows are padding: undefined)."""
    n, c = 256, 64
    q, k, v = _qkv()
    lens = np.asarray([200, 256], np.int32)
    for i in range(n // c):
        m = (i + 1) * c
        args = (q[:, :, i * c:m], k[:, :, :m], v[:, :, :m], lens - (n - m))
        want = np.asarray(jax_flash(*map(jnp.asarray, args), block_q=32,
                                    block_k=32, interpret=True,
                                    q_start=i * c, sliding_window=window))
        targs = tuple(map(torch.from_numpy, args))
        rows = slice(max(0, 56 - i * c), None)
        for got in (flash_causal_attention(*targs, q_start=i * c,
                                           sliding_window=window),
                    flash_tiled_plain(*targs, q_start=i * c,
                                      sliding_window=window)):
            got = got.numpy()
            np.testing.assert_allclose(got[0, :, rows], want[0, :, rows],
                                       rtol=KTOL, atol=KTOL)
            np.testing.assert_allclose(got[1], want[1], rtol=KTOL,
                                       atol=KTOL)


def test_flash_pad_and_window_edge_in_one_tile():
    """A chunk at q_start 320 of a 448-key carry whose pad (row 0: 390
    keys, pad 58) and window edge (W = 300: the first row's window starts
    at key 21) both fall in key tile 0 of 128 keys: the port's plain
    version and the kernel's schedule against JAX's kernel."""
    n, nq, q_start, w = 448, 128, 320, 300
    q, k, v = _qkv(n=n, nq=nq, seed=5)
    lens = np.asarray([390, 448], np.int32)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v, lens)),
                                block_q=64, block_k=64, interpret=True,
                                q_start=q_start, sliding_window=w))
    targs = tuple(map(torch.from_numpy, (q, k, v, lens)))
    for got in (flash_causal_attention(*targs, q_start=q_start,
                                       sliding_window=w),
                flash_tiled_plain(*targs, q_start=q_start,
                                  sliding_window=w)):
        np.testing.assert_allclose(got.numpy(), want, rtol=KTOL, atol=KTOL)


@pytest.mark.parametrize("q_start,true_len,window", [
    (96, (64, 40), 48),    # tile 32 rows back: its far keys hidden
    (160, (64, 17), 120),  # rows 0-22 see keys, the rest see none
    (192, (64, 64), 96),   # wholly outside the window of every row
    (0, (64, 40), 24),     # the causal self tile with a window
])
def test_partials_window_at_true_distance(q_start, true_len, window):
    """``flash_attention_partials`` on a tile ``q_start`` rows before its
    queries, with a window: the port's wrapper on CPU tensors and the
    kernel's schedule against JAX's kernel (interpret mode, one q block;
    JAX's kernel refuses a q block with no key inside the window, so the
    tile wholly outside it, which the quantized carry skips, is held to
    the exact empty partials alone); rows with no visible key exact."""
    q, k, v = _qkv(n=64, seed=q_start)
    lens = np.asarray(true_len, np.int32)
    targs = tuple(map(torch.from_numpy, (q, k, v, lens)))
    got = flash_attention_partials(*targs, q_start=q_start,
                                   sliding_window=window)
    sched = flash_tiled_plain(*targs, q_start=q_start, sliding_window=window,
                              partials=True)
    if q_start - 63 >= window:
        dead = np.ones(got[2].shape, bool)
    else:
        want = jax_partials(*map(jnp.asarray, (q, k, v, lens)), block_q=64,
                            block_k=32, interpret=True, q_start=q_start,
                            sliding_window=window)
        dead = np.asarray(want[2]) == 0
        for part in (got, sched):
            for g, w in zip(part, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=KTOL, atol=KTOL)
    for part in (got, sched):
        assert np.all(part[1].numpy()[dead] == _NEG)
        assert np.all(part[2].numpy()[dead] == 0)
        assert np.all(part[0].numpy()[dead] == 0)
    if q_start == 160:
        assert dead[:, :, 23:].all() and not dead[:, :, :23].any()


def _window_mask(b, hk, s, decode, written):
    """A fullkv cache's visible slots under the window: prefill slots
    [0, s - decode) at positions 0.., ``written`` of the ``decode`` decode
    slots filled, the current token the last of them; the last WINDOW
    positions are visible.  Returns [B, Hk, S] bool."""
    sp = s - decode
    pos = sp + written - 1
    slots = np.arange(s)
    vis = (slots > pos - WINDOW) & (slots < sp + written)
    return np.ascontiguousarray(np.broadcast_to(vis, (b, hk, s)))


@pytest.mark.parametrize("b,hk,g,s", [(2, 2, 4, 600), (1, 2, 1, 2100)])
def test_decode_window_mask_matches_pallas(b, hk, g, s):
    """The decode kernel's plain version and its split schedule on a
    window-shaped mask (most slots hidden: several splits wholly masked)
    against JAX's decode kernel (interpret mode)."""
    rng = np.random.default_rng(s)
    d = 32
    q = rng.normal(size=(b, hk * g, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hk, s, d)).astype(np.float32)
            for _ in range(2))
    mask = _window_mask(b, hk, s, decode=8, written=4)
    assert (mask.sum(-1) == WINDOW).all()
    want = np.asarray(decode_attention_pallas(
        *map(jnp.asarray, (q, k, v, mask)), interpret=True))
    targs = tuple(map(torch.from_numpy, (q, k, v, mask)))
    nsplit, rows = decode_split_plan(torch.device("cpu"), b * hk, s)
    assert nsplit > 1
    for got in (decode_attention(*targs),
                decode_attention_split_plain(*targs, nsplit, rows)):
        np.testing.assert_allclose(got.numpy(), want, rtol=DTOL, atol=DTOL)


def test_pa_window_mask_matches_jax():
    """The pa region attention (the plain version the CPU runs) on a
    window-shaped mask over a 1000-slot kivi4 region, against JAX's
    factored function: acc / l within 2^-6 |want| + 2^-5 rms, m within
    2^-12, l within 2^-10 relative (``test_torch_pa_split.py``'s bound),
    rows with nothing visible exact; then the layer's output with a bf16
    tail through the wrapper."""
    b, hk, g, s, d, nbits = 1, 2, 4, 1000, 32, 4
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, hk * g, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hk, s, d)).astype(np.float32)
            for _ in range(2))
    jreg = jq.quantize_kv_region(jnp.asarray(k), jnp.asarray(v), nbits=nbits,
                                 group_size=16, layout="pa")
    reg = region_from_numpy(jax.tree_util.tree_map(np.asarray, jreg),
                            device="cpu")
    full = _window_mask(b, hk, s + 8, decode=8, written=4)
    mask = np.ascontiguousarray(full[:, :, :s])
    want = jq.quant_region_attention_fused(
        jnp.asarray(q), jreg, jnp.asarray(mask), num_slots=s, head_dim=d,
        nbits=nbits)
    q, mask = torch.from_numpy(q), torch.from_numpy(mask)
    got = tq.quant_region_attention_fused(q, reg, mask, nbits=nbits)
    acc, m, l = (x.numpy() for x in got)
    wacc, wm, wl = (np.asarray(x) for x in want)
    live = wl > 0
    assert (live == (l > 0)).all()
    o, ow = acc[live] / l[live][:, None], wacc[live] / wl[live][:, None]
    rms = np.sqrt(np.mean(ow ** 2, -1, keepdims=True))
    assert (np.abs(o - ow) <= 2.0 ** -6 * np.abs(ow) + 2.0 ** -5 * rms).all()
    assert (np.abs(m[live] - wm[live])
            <= 2.0 ** -12 * np.maximum(1.0, np.abs(wm[live]))).all()
    assert (np.abs(l[live] - wl[live]) <= 2.0 ** -10 * wl[live]).all()
    tail = (torch.from_numpy(rng.normal(size=(b, hk, 8, d)).astype(
        np.float32)), torch.from_numpy(rng.normal(size=(b, hk, 8, d)).astype(
            np.float32)), torch.from_numpy(full[:, :, s:]))
    out = quant_fused_attention_pa(q, reg, mask, nbits=nbits, tail=tail)
    torch.testing.assert_close(out, tq.merge_tail(got, q, tail), rtol=0,
                               atol=0)
