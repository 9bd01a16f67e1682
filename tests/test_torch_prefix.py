"""Prefix caching in the port (``Engine.precompute_prefix``,
``PrefixHandle``, ``PrefixRegistry``, ``chunked_prefill.
quant_state_from_prefix``) against a live JAX engine, on the CPU.

The CPU-sized cases of ``tests/test_prefix_cache.py`` (tiny model, bucket
256, chunk 64), each run through the port's engine and the JAX engine on
the same params (the JAX tree through the weight bridge, f32) and the same
prompts: greedy tokens must be exactly equal, as must the port's tokens
with and without the handle wherever the JAX test holds its own so.  Saved
handles cross between the packages in both directions.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pyramidkv_tpu import config as jcfg
from pyramidkv_tpu.engine import Engine as JaxEngine
from pyramidkv_tpu.engine import PrefixHandle as JaxHandle
from pyramidkv_tpu.models import llama as jl
from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine, PrefixHandle, PrefixRegistry
from pyramidkv_tpu_torch.models import chunked_prefill as cp
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from pyramidkv_tpu_torch.ops.quant import QuantizedTensor, dequantize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUCKET, CHUNK = 256, 64
COMP = dict(max_capacity_prompt=64, window_size=8)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.fixture(scope="module")
def engines(params):
    """(JAX engine, port engine) per configuration, built once: the JAX
    engine keeps its compiled chunk functions across the tests."""
    cache = {}

    def get(kind="snapkv", chunk=CHUNK, nbits=8, layout="group"):
        key = (kind, chunk, nbits, layout)
        if key not in cache:
            if kind == "quant":
                comp = dict(method="fullkv", quant_method="kivi",
                            nbits=nbits, q_layout=layout, window_size=8)
            else:
                comp = dict(method=kind, **COMP)
            eng = dict(max_new_tokens=16, prefill_buckets=(BUCKET,),
                       prefill_chunk=chunk)
            cache[key] = (
                JaxEngine(jcfg.ModelSpec.tiny(), jcfg.CompressionSpec(**comp),
                          jcfg.EngineSpec(**eng), params[0]),
                Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                       tcfg.EngineSpec(**eng), params[1], device="cpu"))
        return cache[key]

    return get


def _prompts(prefix, seed=0, lens=(200, 256, 170)):
    """Prompts sharing ``prefix`` with random different-length suffixes
    (``tests/test_prefix_cache.py::_prompts``)."""
    rng = np.random.default_rng(seed)
    return [list(prefix) + rng.integers(
        1, 250, size=n - len(prefix)).tolist() for n in lens]


def _prefix(seed, n):
    return np.random.default_rng(seed).integers(1, 250, size=n).tolist()


def _both(je, te, prompts, jh, th):
    """Greedy tokens (8 new) of both engines, each with its own handle."""
    want = je.generate(prompts, max_new_tokens=8, prefix=jh)
    got = te.generate(prompts, max_new_tokens=8, prefix=th)
    return got.tokens, want.tokens


# ---------------------------------------------------------------------------
# bf16 carry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["snapkv", "pyramidkv", "h2o", "fullkv"])
def test_prefix_matches_jax(engines, method):
    je, te = engines(method)
    prefix = _prefix(1, 130)  # 2 full chunks + 2
    prompts = _prompts(prefix, seed=2)
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    assert (th.full_len, th.chunk_len) == (jh.full_len, jh.chunk_len) == (
        128, 64)
    assert not th.is_quant and th.kv_bytes == jh.kv_bytes
    np.testing.assert_allclose(th.state.k.numpy(), np.asarray(jh.state.k),
                               rtol=1e-4, atol=1e-4)
    got, want = _both(je, te, prompts, jh, th)
    assert got == want
    assert got == te.generate(prompts, max_new_tokens=8).tokens


def test_prefix_handle_reused_across_calls(engines):
    je, te = engines()
    prefix = _prefix(3, 128)
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    for seed in (4, 5):  # two suffix sets through one handle
        prompts = _prompts(prefix, seed=seed, lens=(150, 220))
        got, want = _both(je, te, prompts, jh, th)
        assert got == want
        assert got == te.generate(prompts, max_new_tokens=8).tokens


def test_prefix_bucket_edge(engines):
    """Prompt == prefix filling the whole bucket: k0 is clamped so the last
    chunk still runs."""
    je, te = engines()
    prefix = _prefix(6, 256)
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    assert te._apply_prefix(BUCKET, 1, th, [256])[1] == BUCKET // CHUNK - 1
    got, want = _both(je, te, [prefix], jh, th)
    assert got == want == te.generate([prefix], max_new_tokens=8).tokens


def test_prefix_validation_errors(engines, params):
    je, te = engines()
    prefix = _prefix(7, 128)
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    bad = [p + 1 for p in prefix] + [5, 6]
    cases = [
        ("does not start", lambda e, h: e.generate([bad], prefix=h)),
        ("does not start", lambda e, h: e.generate([prefix[:100]],
                                                   prefix=h)),
        ("shorter than one prefill chunk",
         lambda e, h: e.precompute_prefix(prefix[:30])),
    ]
    for match, fn in cases:
        for eng, h in ((je, jh), (te, th)):
            with pytest.raises(ValueError, match=match):
                fn(eng, h)
    # no chunked prefill configured; a plan without a chunk carry
    # (minference takes the monolithic prefill)
    for kw, match in ((dict(chunk=None), "prefill_chunk"),
                      (dict(kind="minference"), "unsupported")):
        for eng in engines(**kw):
            with pytest.raises(ValueError, match=match):
                eng.precompute_prefix(prefix)
    # a handle of another chunk size
    th32 = engines(chunk=32)[1].precompute_prefix(prefix)
    with pytest.raises(ValueError, match="chunk"):
        te.generate(_prompts(prefix, lens=(200,)), prefix=th32)
    assert te.prefix_usable(th, _prompts(prefix, lens=(200,)), BUCKET)
    assert not te.prefix_usable(th, [bad], BUCKET)
    assert not te.prefix_usable(None, [bad], BUCKET)


# ---------------------------------------------------------------------------
# quantized carry (fullkv + KIVI)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits,layout", [(8, "group"), (4, "pa"),
                                          (2, "pa")])
def test_quant_prefix_aligned_exact(engines, nbits, layout):
    """pad % chunk == 0 (lens 256 and 192): the tokens equal the no-handle
    run's and JAX's.  The resumed carry's codes and zeros equal the
    no-handle carry's bit for bit; its scales lie within 2^-22 of them
    (dequantizing and requantizing grid values rounds the span in f32)."""
    je, te = engines("quant", nbits=nbits, layout=layout)
    prefix = _prefix(40, 128)
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    assert th.is_quant and th.kv_bytes == jh.kv_bytes
    prompts = _prompts(prefix, seed=41, lens=(256, 192))
    got, want = _both(je, te, prompts, jh, th)
    assert got == want
    assert got == te.generate(prompts, max_new_tokens=8).tokens
    resumed, k0 = te._apply_prefix(BUCKET, 1, th, [192])
    plain = _chunk_states(te, prompts[1], cp.init_quant_state(
        te.model_spec, te.plan_for(BUCKET), 1, CHUNK, "cpu"))
    assert k0 == 3

    def covered(st, name):  # the slots of chunks [0, k0)
        x = getattr(st, name)
        axis = 4 if name in ("k_scale", "k_zero") else 3
        return x.narrow(axis, 0, x.shape[axis] * k0 // (BUCKET // CHUNK))

    for name in ("k_codes", "k_zero", "v_codes", "v_zero"):
        assert torch.equal(covered(resumed, name), covered(plain, name))
    for name in ("k_scale", "v_scale"):
        torch.testing.assert_close(covered(resumed, name),
                                   covered(plain, name), rtol=2.0 ** -22,
                                   atol=0)


def test_quant_prefix_misaligned_int8(engines):
    je, te = engines("quant", nbits=8)
    prefix = _prefix(42, 130)
    prompts = _prompts(prefix, seed=43, lens=(230, 256, 170))
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    got, want = _both(je, te, prompts, jh, th)
    assert got == want
    assert got == te.generate(prompts, max_new_tokens=8).tokens


def _from_jax(jh):
    """The port's handle holding a JAX handle's leaves."""
    klass = cp.QuantChunkState if jh.is_quant else cp.ChunkState
    return PrefixHandle(token_ids=jh.token_ids, full_len=jh.full_len,
                        chunk_len=jh.chunk_len, nbits=jh.nbits,
                        state=klass(*(torch.from_numpy(np.array(x))
                                      for x in jh.state)))


def test_quant_prefix_misaligned_low_bits(engines):
    """int4 pa, one aligned and one misaligned row.  Through the port's own
    handle the aligned row equals JAX's and the no-handle run's; the
    misaligned row pays a 4-bit requantization on a grid that f32 noise
    moves (its scales are not JAX's to the bit), and like JAX's own test
    only its length is held.  Through JAX's handle both rows give JAX's
    tokens."""
    je, te = engines("quant", nbits=4, layout="pa")
    prefix = _prefix(44, 128)
    aligned = _prompts(prefix, seed=45, lens=(256,))[0]
    misaligned = _prompts(prefix, seed=46, lens=(230,))[0]
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    got, want = _both(je, te, [aligned, misaligned], jh, th)
    plain = te.generate([aligned, misaligned], max_new_tokens=8).tokens
    assert got[0] == want[0] == plain[0]
    assert len(got[1]) == len(want[1]) == len(plain[1])
    assert te.generate([aligned, misaligned], max_new_tokens=8,
                       prefix=_from_jax(jh)).tokens == want


def _chunk_states(te, prompt, state0):
    """The carry after every chunk of ``prompt`` from ``state0`` (chunks
    the JAX test's ``run_chunks`` runs)."""
    toks = torch.zeros((1, BUCKET), dtype=torch.int64)
    toks[0, BUCKET - len(prompt):] = torch.tensor(prompt)
    tl_ = torch.tensor([len(prompt)], dtype=torch.int32)
    plan = te.plan_for(BUCKET)
    for i in range(BUCKET // CHUNK):
        chunk = toks[:, i * CHUNK:(i + 1) * CHUNK]
        if isinstance(state0, cp.QuantChunkState):
            cp.prefill_chunk_quant(te.params, te.model_spec, plan, state0,
                                   chunk, tl_, i * CHUNK)
        else:
            cp.prefill_chunk(te.params, te.model_spec, plan, state0, chunk,
                             tl_, chunk_start=i * CHUNK)
    return state0


def _dq_k(st, nbits):
    """[L, B, KV, D, N] f32 K of a quantized carry (pa: one group a
    chunk)."""
    return dequantize(QuantizedTensor(st.k_codes.transpose(-2, -1),
                                      st.k_scale, st.k_zero), nbits=nbits,
                      group_size=CHUNK)


def _truth_k(engines, prompt):
    te = engines("fullkv")[1]
    st = _chunk_states(te, prompt, cp.init_state(
        te.model_spec, te.plan_for(BUCKET), 1, torch.float32, "cpu"))
    return st.k.float().transpose(-2, -1)


def test_quant_prefix_roundtrip_error_bounded(engines):
    """The misaligned resume's reconstruction error against the bf16-carry
    truth stays within 2.5x the plain quant carry's (int4 pa, pad 26), and
    the port's quant_state_from_prefix is bit-equal to JAX's on the same
    handle."""
    je, te = engines("quant", nbits=4, layout="pa")
    prefix = _prefix(60, 130)
    prompt = _prompts(prefix, seed=61, lens=(230,))[0]
    th = te.precompute_prefix(prefix)
    plain = _chunk_states(te, prompt, cp.init_quant_state(
        te.model_spec, te.plan_for(BUCKET), 1, CHUNK, "cpu"))
    resumed, k0 = te._apply_prefix(BUCKET, 1, th, [len(prompt)])
    assert k0 >= 2
    span = slice(0, k0 * CHUNK)
    tk = _truth_k(engines, prompt)[..., span]
    e_plain = float(((_dq_k(plain, 4)[..., span] - tk) ** 2).mean())
    e_res = float(((_dq_k(resumed, 4)[..., span] - tk) ** 2).mean())
    assert e_plain > 0
    assert e_res <= 2.5 * e_plain + 1e-10, (e_res, e_plain)
    # bit-equal to JAX's on JAX's handle
    jh = je.precompute_prefix(prefix)
    want, jk0 = je._apply_prefix(BUCKET, 1, jh, [len(prompt)])
    hstate = cp.QuantChunkState(*(torch.from_numpy(np.array(x))
                                  for x in jh.state))
    got = cp.quant_state_from_prefix(te.model_spec, te.plan_for(BUCKET),
                                     hstate, jh.full_len,
                                     [BUCKET - len(prompt)], jk0, CHUNK)
    assert jk0 == k0
    for name in cp.QuantChunkState._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name


def test_low_bit_handle_bounded_error(engines):
    """A kivi2 handle resumed into a kivi4 carry: codes halve, the handle
    shrinks below 0.75x, the resumed error stays within 2.5x a pure kivi2
    carry's, and the tokens equal JAX's with its kivi2 handle."""
    je, te = engines("quant", nbits=4, layout="pa")
    te2 = engines("quant", nbits=2, layout="pa")[1]
    prefix = _prefix(70, 130)
    prompt = _prompts(prefix, seed=71, lens=(192,))[0]  # pad 64: aligned
    h4 = te.precompute_prefix(prefix)
    h2 = te.precompute_prefix(prefix, handle_nbits=2)
    assert h2.nbits == 2 and h4.nbits is None
    assert h2.state.k_codes.shape[-2] == h4.state.k_codes.shape[-2] // 2
    assert h2.kv_bytes < 0.75 * h4.kv_bytes
    resumed, k0 = te._apply_prefix(BUCKET, 1, h2, [len(prompt)])
    assert k0 >= 2
    plain2 = _chunk_states(te2, prompt, cp.init_quant_state(
        te2.model_spec, te2.plan_for(BUCKET), 1, CHUNK, "cpu"))
    span = slice(0, k0 * CHUNK)
    tk = _truth_k(engines, prompt)[..., span]
    e_res = float(((_dq_k(resumed, 4)[..., span] - tk) ** 2).mean())
    e_k2 = float(((_dq_k(plain2, 2)[..., span] - tk) ** 2).mean())
    assert e_k2 > 0
    assert e_res <= 2.5 * e_k2 + 1e-10, (e_res, e_k2)
    jh2 = je.precompute_prefix(prefix, handle_nbits=2)
    got, want = _both(je, te, [prompt], jh2, h2)
    assert got == want and len(got[0]) == 8


def test_handle_nbits_validation(engines):
    prefix = _prefix(74, 128)
    for eng in engines("quant", nbits=2, layout="pa"):
        with pytest.raises(ValueError, match="wider"):
            eng.precompute_prefix(prefix, handle_nbits=4)
        # the same width collapses to a plain handle
        assert eng.precompute_prefix(prefix, handle_nbits=2).nbits is None
    for eng in engines():
        with pytest.raises(ValueError, match="quant-carry"):
            eng.precompute_prefix(prefix, handle_nbits=2)


# ---------------------------------------------------------------------------
# save / load, host handles, registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["snapkv", "quant"])
def test_save_load_both_directions(engines, tmp_path, kind):
    """A handle JAX saved loads in the port and gives JAX's tokens; a
    handle the port saved loads in JAX and gives them too; leaves cross
    bit for bit (quantized: int4 pa)."""
    je, te = (engines("quant", nbits=4, layout="pa") if kind == "quant"
              else engines())
    prefix = _prefix(47, 130)
    prompts = _prompts(prefix, seed=48, lens=(256, 192, 230))
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    jh.save(str(tmp_path / "jax.npz"))
    th.save(str(tmp_path / "port.npz"))
    from_jax = PrefixHandle.load(str(tmp_path / "jax.npz"), device="cpu")
    from_port = JaxHandle.load(str(tmp_path / "port.npz"))
    assert from_jax.is_quant == (kind == "quant") == from_port.is_quant
    assert from_jax.token_ids == jh.token_ids == from_port.token_ids
    for name in jh.state._fields:
        a = np.asarray(getattr(jh.state, name))
        b = getattr(from_jax.state, name).numpy()
        assert b.dtype == a.dtype and np.array_equal(b, a), name
        np.testing.assert_array_equal(np.asarray(getattr(from_port.state,
                                                         name)),
                                      getattr(th.state, name).numpy())
    want = je.generate(prompts, max_new_tokens=8, prefix=jh).tokens
    assert te.generate(prompts, max_new_tokens=8,
                       prefix=from_jax).tokens == want
    assert je.generate(prompts, max_new_tokens=8,
                       prefix=from_port).tokens == want
    assert te.generate(prompts, max_new_tokens=8, prefix=th).tokens == want


def test_save_load_bf16_and_path_without_extension(tmp_path):
    """bf16 leaves cross through the byte-view npz both ways (the port
    reads the 'bfloat16' dtype string as torch.bfloat16), and save('x') /
    load('x') agree on a path without an extension."""
    jp16 = jl.init_params(jcfg.ModelSpec.tiny(), jax.random.PRNGKey(1),
                          dtype=jnp.bfloat16)
    tp16 = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp16),
                             device="cpu")
    comp = dict(method="snapkv", **COMP)
    eng = dict(max_new_tokens=16, prefill_buckets=(BUCKET,),
               prefill_chunk=CHUNK)
    je = JaxEngine(jcfg.ModelSpec.tiny(), jcfg.CompressionSpec(**comp),
                   jcfg.EngineSpec(**eng), jp16)
    te = Engine(tcfg.ModelSpec.tiny(), tcfg.CompressionSpec(**comp),
                tcfg.EngineSpec(**eng), tp16, device="cpu")
    prefix = _prefix(23, 128)
    jh, th = je.precompute_prefix(prefix), te.precompute_prefix(prefix)
    assert th.state.k.dtype == torch.bfloat16
    jh.save(str(tmp_path / "jax16"))
    th.save(str(tmp_path / "port16"))
    from_jax = PrefixHandle.load(str(tmp_path / "jax16"), device="cpu")
    from_port = JaxHandle.load(str(tmp_path / "port16"))
    assert from_jax.state.k.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        from_jax.state.k.view(torch.int16).numpy(),
        np.asarray(jh.state.k).view(np.int16))
    np.testing.assert_array_equal(
        np.asarray(from_port.state.k).view(np.int16),
        th.state.k.view(torch.int16).numpy())
    again = PrefixHandle.load(str(tmp_path / "port16"), device="cpu")
    assert again.token_ids == th.token_ids and torch.equal(again.state.v,
                                                           th.state.v)


def test_host_handles(engines):
    """host=True keeps the handle as CPU tensors; resumed tokens equal the
    device handle's and JAX's host handle's (int8 quantized carry, and the
    bf16 carry against the no-handle run)."""
    je, te = engines("quant", nbits=8)
    prefix = _prefix(49, 128)
    hd = te.precompute_prefix(prefix)
    hh = te.precompute_prefix(prefix, host=True)
    assert hh.state.k_codes.device.type == "cpu"
    for a, b in zip(hd.state, hh.state):
        assert torch.equal(a, b)
    prompts = _prompts(prefix, seed=50, lens=(256, 192))
    got, want = _both(je, te, prompts, je.precompute_prefix(prefix,
                                                            host=True), hh)
    assert got == want
    assert te.generate(prompts, max_new_tokens=8, prefix=hd).tokens == got
    te2 = engines()[1]
    hb = te2.precompute_prefix(prefix, host=True)
    p2 = _prompts(prefix, seed=51, lens=(200,))
    assert (te2.generate(p2, max_new_tokens=8, prefix=hb).tokens
            == te2.generate(p2, max_new_tokens=8).tokens)


def test_prefix_registry_lru_and_match(engines):
    te = engines()[1]
    rng = np.random.default_rng(20)
    p1 = rng.integers(1, 250, size=128).tolist()
    p2 = rng.integers(1, 250, size=192).tolist()
    p3 = p2[:64] + rng.integers(1, 250, size=64).tolist()
    reg = PrefixRegistry(te, max_entries=2)
    h1 = reg.get(p1)
    assert reg.get(p1) is h1  # a hit builds nothing
    h2 = reg.get(p2)
    assert len(reg) == 2 and reg.bytes == h1.kv_bytes + h2.kv_bytes
    # match: the longest registered prefix the prompt starts with
    assert reg.match(p2 + [5, 6, 7]) is h2
    assert reg.match(p1 + [9]) is h1
    assert reg.match([1, 2, 3]) is None
    # LRU: p1 was touched last (by match), so a third entry evicts p2
    h3 = reg.get(p3)
    assert len(reg) == 2 and reg.match(p2 + [5]) is None
    assert reg.match(p1 + [9]) is h1 and reg.match(p3 + [1]) is h3
    # a bytes cap keeps only the newest entry
    reg2 = PrefixRegistry(te, max_entries=8, max_bytes=1)
    reg2.put(h1)
    reg2.put(h3)
    assert len(reg2) == 1 and reg2.match(p3 + [1]) is h3
    # the registry's defaults reach the handles it builds
    reg3 = PrefixRegistry(te, host=True)
    assert reg3.get(p1).state.k.device.type == "cpu"
    tq = engines("quant", nbits=4, layout="pa")[1]
    assert PrefixRegistry(tq, handle_nbits=2).get(p1).nbits == 2


def test_handle_load_needs_a_card_unless_asked_for_cpu(engines, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    th = engines()[1].precompute_prefix(_prefix(8, 64))
    th.save(str(tmp_path / "h"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefixHandle.load(str(tmp_path / "h"))
    assert PrefixHandle.load(str(tmp_path / "h"),
                             device="cpu").token_ids == th.token_ids
