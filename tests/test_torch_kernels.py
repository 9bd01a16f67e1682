"""Kernel parity for the PyTorch/CUDA port.

The port's attention kernels are CUDA C++; on the CPU their wrappers run
the plain PyTorch versions, which are what the CUDA kernels are held to on
the card.  Here those plain versions are held to the JAX package's Pallas
kernels, run in interpret mode on the same numpy inputs.

Tolerance: f32 on both sides; the two sum the same terms in other orders
(D=32 dots, softmax over <= 128 keys), so they agree to ~1e-6 — 2e-4 is the
bound the JAX package's own kernel tests use.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pyramidkv_tpu.kernels import flash_causal_attention as jax_flash
from pyramidkv_tpu.kernels.decode_attn import decode_attention_pallas
from pyramidkv_tpu_torch.kernels import decode_attention, flash_causal_attention
from pyramidkv_tpu_torch.ops import attention as plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-4


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("hk,true_len,window", [
    (4, (128, 119), None),   # per-query-head K/V, pad inside a tile
    (2, (100, 17), None),    # GQA group 2, long pad
    (2, (128, 64), 24),      # sliding window
    (1, (96, 1), None),      # GQA group 4, a one-token prompt
])
def test_plain_flash_matches_pallas(hk, true_len, window):
    b, h, n, d = 2, 4, 128, 32
    rng = np.random.default_rng(hk * 100 + true_len[1])
    q, k, v = _normal(rng, b, h, n, d), _normal(rng, b, hk, n, d), \
        _normal(rng, b, hk, n, d)
    tl = np.asarray(true_len, np.int32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(tl),
                                block_q=32, block_k=32, sliding_window=window,
                                interpret=True))
    got = flash_causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(tl),
                                 sliding_window=window).numpy()
    for bi, t in enumerate(true_len):  # padding rows are undefined in JAX
        np.testing.assert_allclose(got[bi, :, n - t:], want[bi, :, n - t:],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2)])
def test_plain_decode_matches_pallas(h, hk):
    b, s, d = 2, 48, 32
    rng = np.random.default_rng(h + hk)
    q = _normal(rng, b, h, d)
    k, v = _normal(rng, b, hk, s, d), _normal(rng, b, hk, s, d)
    mask = rng.random(size=(b, hk, s)) < 0.6
    mask[1, 0] = False  # an all-masked row averages every slot uniformly
    want = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        interpret=True))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cpu_tensors_take_plain_path_without_counting():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_normal(rng, 1, 4, 64, 16))
    k = torch.from_numpy(_normal(rng, 1, 2, 64, 16))
    v = torch.from_numpy(_normal(rng, 1, 2, 64, 16))
    tl = torch.tensor([50], dtype=torch.int32)
    mask = torch.from_numpy(rng.random(size=(1, 2, 64)) < 0.5)
    n_flash = flash_causal_attention.launches
    n_dec = decode_attention.launches
    got = flash_causal_attention(q, k, v, tl)
    torch.testing.assert_close(
        got, plain.causal_prefill_attention(q, k, v, true_len=tl),
        rtol=0, atol=0)
    got = decode_attention(q[:, :, 0], k, v, mask)
    torch.testing.assert_close(
        got, plain.decode_attention(q[:, :, 0], k, v, mask), rtol=0, atol=0)
    assert flash_causal_attention.launches == n_flash
    assert decode_attention.launches == n_dec


def test_unported_flash_options_raise():
    """The flash wrapper takes Gemma-2's cap (monolithic and at q_start: on
    CPU tensors the plain capped attention, held to JAX's kernel in
    test_torch_gemma2.py); so do the KIVI region wrappers since the cap and
    a custom scale over a region were ported (on CPU tensors their plain
    versions, held to JAX's in test_torch_gemma2_kivi.py): the scale and
    the cap bend their results, exactly as the plain function's."""
    from pyramidkv_tpu_torch.kernels import (quant_fused_attention_group,
                                             quant_fused_attention_pa)
    from pyramidkv_tpu_torch.ops import quant

    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 2, 64, 16))
               for _ in range(3))
    tl = torch.tensor([64])
    for kw in (dict(), dict(q_start=8)):
        qq = q[:, :, kw.get("q_start", 0):]
        got = flash_causal_attention(qq, k, v, tl, softcap=50.0, **kw)
        want = plain.causal_prefill_attention(qq, k, v, true_len=tl,
                                              softcap=50.0, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        uncapped = plain.causal_prefill_attention(qq, k, v, true_len=tl,
                                                  **kw)
        assert not torch.equal(got, uncapped)
    qd = torch.from_numpy(_normal(rng, 1, 4, 16)) * 8
    mask = torch.ones((1, 2, 64), dtype=torch.bool)
    akw = dict(scale=0.2, softcap=2.0)
    for layout, fn in (("group", quant_fused_attention_group),
                       ("pa", quant_fused_attention_pa)):
        reg = quant.quantize_kv_region(k, v, nbits=4, group_size=16,
                                       layout=layout)
        got = fn(qd, reg, mask, nbits=4, **akw)
        want = quant.quant_region_attention_fused(qd, reg, mask, nbits=4,
                                                  **akw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(got[1], fn(qd, reg, mask, nbits=4)[1])


def _bf16_err_over_tol(got, want):
    """Largest |got - want| / (2^-6 |want| + 2^-5 rms of want's row over
    D), as ``chip_smoke.py`` holds the kernels (<= 1 passes): two bf16 ulps
    of the element, plus twice the largest noise that rounding
    probabilities at different points leaves (~2^-6 of the row's rms)."""
    g, w = got.float(), want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    lim = (2.0 ** -6 * w.abs() + 2.0 ** -5 * rms).clamp_min(1e-30)
    return float(((g - w).abs() / lim).max())


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    """Both CUDA kernels against their plain versions in bf16 (runs only
    where a card and nvcc are present; ``chip_smoke.py`` covers the
    main-path shapes).  Outputs here have rms ~0.1-0.3 (attention over
    30-256 unit-normal keys), so a typical element is held to
    3 * 2^-6 * rms, 5e-3 to 1.4e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(2, 8, 256, 128), rnd(2, 2, 256, 128), rnd(2, 2, 256, 128)
    tl = torch.tensor([256, 70], dtype=torch.int32, device=dev)
    before = flash_causal_attention.launches
    got = flash_causal_attention(q, k, v, tl)
    want = plain.causal_prefill_attention(q, k, v, true_len=tl)
    assert flash_causal_attention.launches == before + 1
    for bi, t in enumerate((256, 70)):
        assert _bf16_err_over_tol(got[bi, :, 256 - t:],
                                  want[bi, :, 256 - t:]) <= 1
    qd = rnd(2, 8, 128)
    mask = torch.rand((2, 2, 300), generator=g, device=dev) < 0.7
    kd, vd = rnd(2, 2, 300, 128), rnd(2, 2, 300, 128)
    assert _bf16_err_over_tol(decode_attention(qd, kd, vd, mask),
                              plain.decode_attention(qd, kd, vd, mask)) <= 1
