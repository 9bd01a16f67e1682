"""Head dim 32 on the port: the trained tiny retrieval checkpoint's helpers
and the schedules of its kernels, on the CPU.

- The port's copies of the checkpoint's tokenizer and needle helpers
  (``pyramidkv_tpu_torch/train``) against the JAX package's: the same
  strings and ids from the same seeds; the port's numpy loader against
  JAX's ``load_checkpoint`` (the same spec and arrays).
- The plain schedules of the D = 32 kernels at the needle grid's shapes
  (8 query heads on 4 KV heads, left pads) against JAX's kernels in
  interpret mode, or JAX's function where the TPU engine runs XLA:
  ``flash_tiled_plain`` (64-key tiles, the mma.sync kernel's; each f32
  product scaled, no fold of the scale into a bf16 q) against
  ``flash_causal_attention`` within 2e-5 in f32 (the same terms in other
  orders; in f32 the TPU wrapper's fold rounds nothing) and, in bf16,
  against the port's plain version (which folds nothing either) within
  the card's kernel limit, 2^-6 |want| + 2^-5 rms (rows past the pad; rows
  before it exactly 0);
  ``decode_attention_split_plain`` on the card's plans at G = 2 against
  ``decode_attention_pallas`` within 2e-4 (``test_torch_decode_split.py``'s);
  ``h2o_tiled_plain`` against ``h2o_scores_pallas`` within 2e-5;
  ``region_split_plain`` (the folded group kernel's schedule) with V rows
  padded to the 64-channel quantization group against JAX's
  ``quant_region_attention_fused`` at 8, 4 and 2 bits within 2^-6 |want| +
  2^-6 rms on acc / l (``test_torch_quant_split.py``'s folded bound), m
  within 2e-5 and l within 2^-7.
- The D = 32 plans: the decode plan covers short caches (80 and 144 slots)
  with whole tiles; the group kernel's plans fit two blocks an SM.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu.kernels import flash_causal_attention as jax_flash
from pyramidkv_tpu.kernels.decode_attn import decode_attention_pallas
from pyramidkv_tpu.kernels.h2o_scores import h2o_scores_pallas
from pyramidkv_tpu.ops import quant as jq
from pyramidkv_tpu_torch.kernels import decode_attn
from pyramidkv_tpu_torch.kernels import quant_decode as qd
from pyramidkv_tpu_torch.kernels.flash_prefill import (block_k,
                                                      flash_tiled_plain)
from pyramidkv_tpu_torch.kernels.h2o_scores import h2o_tiled_plain
from pyramidkv_tpu_torch.models.convert import region_from_numpy
from pyramidkv_tpu_torch.ops import attention as plain
from pyramidkv_tpu_torch.ops import quant as tq
from pyramidkv_tpu_torch.ops import scoring as tq_scoring
from pyramidkv_tpu_torch.train import checkpoint as tck
from pyramidkv_tpu_torch.train import data as tdata
from pyramidkv_tpu_torch.train.tokenizer import ToyTokenizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

D = 32
CPU = torch.device("cpu")
KTOL = 2e-5
NEG = float(np.finfo(np.float32).min)


# ---------------------------------------------------------------------------
# The checkpoint's tokenizer, needle helpers and loader
# ---------------------------------------------------------------------------


def _jax_text(seed):
    """A needle prompt's text and pieces from the JAX package's helpers."""
    from pyramidkv_tpu.train import data as jd

    rng = np.random.default_rng(seed)
    adj, noun = jd.entity(rng)
    cw = jd.code(rng)
    pieces = [jd.filler_sentence(rng), jd.filler_text(rng, 120),
              jd.filler_text(rng, 90, pool=5), jd.needle_sentence(adj, noun, cw),
              jd.needle_question(adj, noun), jd.needle_answer(adj, noun, cw)]
    return pieces


def _port_text(seed):
    rng = np.random.default_rng(seed)
    adj, noun = tdata.entity(rng)
    cw = tdata.code(rng)
    return [tdata.filler_sentence(rng), tdata.filler_text(rng, 120),
            tdata.filler_text(rng, 90, pool=5),
            tdata.needle_sentence(adj, noun, cw),
            tdata.needle_question(adj, noun),
            tdata.needle_answer(adj, noun, cw)]


@pytest.mark.parametrize("seed", [0, 1, 7, 11])
def test_needle_helpers_and_tokenizer_match_jax(seed):
    from pyramidkv_tpu.train import ToyTokenizer as JaxTok

    want, got = _jax_text(seed), _port_text(seed)
    assert got == want
    jt, tt = JaxTok(), ToyTokenizer()
    assert tt.vocab == jt.vocab
    text = "<|im_start|> " + "".join(got) + "\nAnswer: <book> x </book>"
    ids = tt.encode(text, add_special_tokens=True)
    assert ids == jt.encode(text, add_special_tokens=True)
    assert tt(text).input_ids == jt(text).input_ids
    for skip in (False, True):
        assert tt.decode(ids, skip_special_tokens=skip) == jt.decode(
            ids, skip_special_tokens=skip)
    assert tt.eos_token_id == jt.eos_token_id


def test_needle_prompt_is_the_trained_tests_prompt():
    """The port's needle_prompt (seed 7) is test_torch_trained's prompt,
    laid out with the JAX helpers; another split of the filler keeps the
    seed's needle."""
    from pyramidkv_tpu.train import ToyTokenizer as JaxTok
    from test_torch_trained import _needle_prompt

    ids, cw = tdata.needle_prompt(ToyTokenizer())
    assert ids == _needle_prompt(JaxTok())
    assert len(cw) == 5
    tids, tcw = tdata.needle_prompt(ToyTokenizer(), seed=3, before=600,
                                    after=350)
    assert tcw == tdata.needle_prompt(ToyTokenizer(), seed=3)[1]
    assert len(tids) <= 1024


def test_checkpoint_loader_matches_jax():
    from pyramidkv_tpu.train import load_checkpoint as jload
    from pyramidkv_tpu.train.loop import tiny_retrieval_spec as jspec_of

    jparams, jspec = jload(tck.CHECKPOINT)
    spec, tree = tck.load_numpy_tree()
    fields = [f.name for f in dataclasses.fields(spec)]
    assert fields == [f.name for f in dataclasses.fields(jspec)]
    assert all(getattr(spec, f) == getattr(jspec, f) for f in fields)
    mine = tck.tiny_retrieval_spec(spec.vocab_size)
    theirs = jspec_of(spec.vocab_size)
    assert all(getattr(mine, f) == getattr(theirs, f) for f in fields)
    for f in ("hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "head_dim",
              "tie_word_embeddings"):
        assert getattr(mine, f) == getattr(spec, f), f

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v

    want = dict(leaves(jparams))
    got = dict(leaves(tree))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    _, params = tck.load_checkpoint(device="cpu")
    assert params["embed"].dtype == torch.float32
    np.testing.assert_array_equal(params["embed"].numpy(), got["embed"])
    _, p16 = tck.load_checkpoint(device="cpu", dtype=torch.bfloat16)
    assert p16["layers"]["wq"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The D = 32 kernels' schedules
# ---------------------------------------------------------------------------


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _err_over_tol(got, want, rtol, row_tol):
    rms = np.sqrt(np.square(want).mean(-1, keepdims=True))
    lim = np.maximum(rtol * np.abs(want) + row_tol * rms, 1e-30)
    return float((np.abs(got - want) / lim).max())


#: (b, n, true_len, window): the grid's left pads inside and on a 64-key
#: tile, and a window
FLASH_CASES = [(2, 256, (256, 77), None), (3, 192, (150, 64, 3), None),
               (1, 256, (200,), 50)]


def test_flash_tiled_d32_large_logits_within_the_kernel_limit():
    """Logits of hundreds of nats (q at std 24), as the trained checkpoint's
    (up to 3000): the D = 32 schedule, which scales each f32 product, stays
    within the card's kernel limit of the plain version in bf16."""
    rng = np.random.default_rng(9)
    b, n, tl = 2, 256, (256, 77)
    q = _bf16(_rand(rng, b, 8, n, D) * 24.0)
    k, v = _bf16(_rand(rng, b, 4, n, D)), _bf16(_rand(rng, b, 4, n, D))
    tt = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    tlt = torch.tensor(tl)
    got = flash_tiled_plain(*tt, tlt).float()
    want = plain.causal_prefill_attention(*tt, true_len=tlt).float()
    for bi, t in enumerate(tl):
        assert _err_over_tol(got[bi, :, n - t:].numpy(),
                             want[bi, :, n - t:].numpy(), 2.0 ** -6,
                             2.0 ** -5) <= 1


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_tiled_d32_matches_pallas(case):
    b, n, tl, window = case
    rng = np.random.default_rng(n + b)
    q, k, v = _rand(rng, b, 8, n, D), _rand(rng, b, 4, n, D), _rand(
        rng, b, 4, n, D)
    tlt = torch.tensor(tl)
    assert block_k(D) == 64
    for bf in (False, True):
        qq, kk, vv = (_bf16(x) if bf else x for x in (q, k, v))
        tt = [torch.from_numpy(x) for x in (qq, kk, vv)]
        if bf:
            tt = [x.to(torch.bfloat16) for x in tt]
        got = flash_tiled_plain(*tt, tlt, sliding_window=window).float()
        pl = plain.causal_prefill_attention(
            *tt, true_len=tlt, sliding_window=window).float()
        pallas = None if bf else np.asarray(jax_flash(
            *(jnp.asarray(x) for x in (qq, kk, vv)),
            jnp.asarray(tl, jnp.int32), sliding_window=window, block_q=64,
            block_k=64, interpret=True))
        for bi, t in enumerate(tl):
            g = got[bi, :, n - t:].numpy()
            if bf:
                assert _err_over_tol(
                    g, pl[bi, :, n - t:].numpy(), 2.0 ** -6, 2.0 ** -5) <= 1
            else:
                np.testing.assert_allclose(g, pallas[bi, :, n - t:],
                                           rtol=KTOL, atol=KTOL)
                np.testing.assert_allclose(g, pl[bi, :, n - t:].numpy(),
                                           rtol=KTOL, atol=KTOL)
        if bf:  # rows before the pad see no key: the kernel's 0
            assert all(bool((got[bi, :, :n - t] == 0).all())
                       for bi, t in enumerate(tl))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [80, 144, 1040])
def test_decode_split_d32_matches_pallas(g, s):
    """The card's plan for the grid's caches (cap 64 or 128 plus 16 decode
    slots, fullkv's 1024 + 16) at B = 1 and 30."""
    for b in (1, 30) if s == 1040 else (1,):
        rng = np.random.default_rng(s + g + b)
        hk = 8 // g
        q, k, v = _rand(rng, b, 8, D), _rand(rng, b, hk, s, D), _rand(
            rng, b, hk, s, D)
        mask = rng.random((b, hk, s)) < 0.7
        mask[0, 0] = False  # a row masked everywhere: the uniform mean
        mask[-1, -1, :64] = False  # a masked left run, as a pad
        nsplit, rows = decode_attn.decode_split_plan(CPU, b * hk, s, g, D)
        assert (nsplit - 1) * rows < s <= nsplit * rows and rows % 64 == 0
        t = [torch.from_numpy(x) for x in (q, k, v, mask)]
        got = decode_attn.decode_attention_split_plain(*t, nsplit, rows)
        want = plain.decode_attention(*t)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
        pallas = np.asarray(decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got[0, :g].numpy(),
                                   np.broadcast_to(v[0, 0].mean(0), (g, D)),
                                   rtol=2e-4, atol=2e-4)


def test_decode_plan_d32():
    """Five blocks an SM at D = 32; short caches take 64-slot splits."""
    assert decode_attn.blocks_per_sm(2, D) == 5
    assert decode_attn.decode_split_plan(CPU, 4, 80, 2, D) == (2, 64)
    assert decode_attn.decode_split_plan(CPU, 8, 144, 1, D) == (3, 64)
    assert decode_attn.decode_split_plan(CPU, 120, 1040, 2, D) == (5, 256)
    assert decode_attn.decode_split_plan(CPU, 240, 1040, 1, D) == (2, 576)


#: (b, n, true_len, w): the grid's window 8 with pads inside and on a
#: 64-row tile, a q tile made wholly of padding
H2O_CASES = [(2, 256, (256, 100), 8), (2, 192, (128, 37), 8),
             (1, 320, (300,), 8)]


@pytest.mark.parametrize("case", H2O_CASES)
def test_h2o_tiled_d32_matches_pallas(case):
    b, n, tl, w = case
    rng = np.random.default_rng(n + w + b)
    q, k = _rand(rng, b, 8, n, D), _rand(rng, b, 4, n, D)
    qt, kt, tlt = torch.from_numpy(q), torch.from_numpy(k), torch.tensor(tl)
    m, l, got = (x.numpy() for x in h2o_tiled_plain(
        qt, kt, window_size=w, true_len=tlt))
    pallas = np.asarray(h2o_scores_pallas(
        jnp.asarray(q), jnp.asarray(k), window_size=w,
        true_len=jnp.asarray(tl, jnp.int32), block_q=64, block_k=64,
        interpret=True))
    fin = np.isfinite(pallas)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], pallas[fin], rtol=KTOL, atol=KTOL)
    live = np.broadcast_to((np.arange(n)[None, :] >= n - np.asarray(tl)[
        :, None])[:, None], m.shape)
    assert (m[~live] == NEG).all() and (l[~live] == 0).all()


def test_h2o_tiled_d32_large_logits_match_the_plain_scorer():
    """Logits of hundreds of nats (q at std 24): the D = 32 H2O schedule,
    which scales each f32 product, gives the plain path's scores (``ops.
    scoring.h2o_scores``, the f32 logits scaled) in bf16 within 2^-14
    |want| + 2^-14 rms (the colsum kernel's limit against its plain
    version: the same f32 terms in other orders); a fold of the scale into
    a bf16 q moves them ~150x past it."""
    rng = np.random.default_rng(12)
    b, n, tl, w = 2, 256, (256, 100), 8
    q = torch.from_numpy(_rand(rng, b, 8, n, D) * 24.0).to(torch.bfloat16)
    k = torch.from_numpy(_rand(rng, b, 4, n, D)).to(torch.bfloat16)
    tlt = torch.tensor(tl)
    _, _, got = h2o_tiled_plain(q, k, window_size=w, true_len=tlt)
    want = tq_scoring.h2o_scores(q, k, window_size=w, true_len=tlt)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    g0, w0 = got.masked_fill(~fin, 0.0), want.masked_fill(~fin, 0.0)
    rms = (w0.square().sum(-1, keepdim=True)
           / fin.sum(-1, keepdim=True)).sqrt()
    lim = 2.0 ** -14 * (w0.abs() + rms)
    assert bool(((g0 - w0).abs() <= lim).all())


@pytest.mark.parametrize("nbits", [8, 4, 2])
def test_region_fold_d32_matches_jax(nbits):
    """The folded group kernel's schedule over a fullkv cache's region at
    D = 32 with V padded to the 64-channel group, on the card's plans for
    B = 1 and a cluster-sized plan, against JAX's grouped factored
    function (the TPU engine's default KIVI decode)."""
    b, hk, g, s = 2, 4, 2, 1024
    rng = np.random.default_rng(50 + nbits)
    q = _rand(rng, b, hk * g, D)
    k = _rand(rng, b, hk, s, D) * np.exp(_rand(rng, 1, 1, 1, D))
    v = _rand(rng, b, hk, s, D)
    jreg = jq.quantize_kv_region(jnp.asarray(k), jnp.asarray(v), nbits=nbits,
                                 group_size=64)
    treg = region_from_numpy(jreg, device="cpu")
    assert treg.v.codes.shape[-1] == 64  # V rows padded to the group
    mask = rng.random((b, hk, s)) < 0.85
    mask[0, 0] = False
    qt = torch.from_numpy(q).to(torch.bfloat16)
    jacc, jm, jl = (np.asarray(x) for x in jq.quant_region_attention_fused(
        jnp.asarray(qt.float().numpy()).astype(jnp.bfloat16), jreg,
        jnp.asarray(mask), num_slots=s, head_dim=D, nbits=nbits))
    w = treg.k.codes.shape[2]
    plans = {qd.split_plan(CPU, hk, w, nbits, 64, D),
             qd.split_plan(CPU, b * hk, w, nbits, 64, D), (1, w)}
    for plan in plans:
        acc, m, l = (x.numpy() for x in qd.region_split_plain(
            qt, treg, torch.from_numpy(mask), nbits=nbits, plan=plan,
            fold=True))
        live = jl > 0
        assert (live == (l > 0)).all()
        assert (m[0, :g] == NEG).all() and (acc[0, :g] == 0).all()
        np.testing.assert_allclose(m[live], jm[live], rtol=KTOL, atol=KTOL)
        np.testing.assert_allclose(l[live], jl[live], rtol=2.0 ** -7)
        assert _err_over_tol((acc / l.clip(1e-30)[..., None])[live],
                             (jacc / jl.clip(1e-30)[..., None])[live],
                             2.0 ** -6, 2.0 ** -6) <= 1, plan


@pytest.mark.parametrize("nbits", [8, 4, 2])
def test_region_plan_d32_fits_two_blocks_an_sm(nbits):
    for bhk in (4, 120):
        w = 1024 // (8 // nbits)
        nsplit, rows = qd.split_plan(CPU, bhk, w, nbits, 64, D)
        assert (nsplit - 1) * rows < w <= nsplit * rows
        smem = qd.region_smem_bytes(2, nbits, True, rows, 64, 16, 64, 1, 16,
                                    d=D)
        assert smem <= qd.MAX_SMEM // 2
        assert qd.region_window(2, nbits, True, rows, 64, 16, 64, 1, 16,
                                D) == rows
