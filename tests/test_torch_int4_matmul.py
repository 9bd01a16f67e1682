"""The weight-quantized matmul kernels of the port against the JAX package.

On the CPU the wrappers of ``pyramidkv_tpu_torch/kernels/int4_matmul.py``
run their plain versions, which the CUDA kernels are held to on the card.
Here those plain versions are held to the JAX package's Pallas kernels in
interpret mode on the same numpy inputs, in f32.

Tolerances are the JAX package's own for these kernels
(``tests/test_weight_quant.py``): 2e-5 relative and absolute for int4 (the
same exact products summed in other orders), 1e-4 for int8.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pyramidkv_tpu.kernels import int4_matmul as jk
from pyramidkv_tpu.models import weights as jw
from pyramidkv_tpu_torch.kernels import int4_matmul, int4_matmul_dma, int8_matmul
from pyramidkv_tpu_torch.kernels.int4_matmul import (
    _SMEM_MAX,
    Int4Plan,
    _plan_stream,
    dma_stage_rows,
    int4_matmul_plain,
    int4_tile_plan,
    int4_tiled_plain,
    int8_matmul_plain,
    split_x3,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL4, TOL8 = 2e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant(rng, layers, in_dim, out, nbits=4, gs=None):
    """(jax QuantW, numpy codes, numpy scale) of random weights of the JAX
    tests' size (N(0, 0.05^2), outputs of order 1); stacked
    [layers, in, out'] when layers, else 2-D."""
    shape = ((layers,) if layers else ()) + (in_dim, out)
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    q = jw._quantize_leaf(jnp.asarray(w), nbits, gs)
    return q, np.asarray(q.codes), np.asarray(q.scale)


# span 128 (out2 % 128 == 0) and span 1 (odd out2) layouts, with the group
# size each takes: (in, out, group size)
SHAPES = {128: (256, 512, 128), 1: (64, 40, 16)}


@pytest.mark.parametrize("span", [128, 1])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("rows,stacked", [(1, False), (3, False), (40, False),
                                          (3, True)])
def test_int4_plain_matches_pallas(span, grouped, rows, stacked):
    in_dim, out, gs = SHAPES[span]
    rng = np.random.default_rng(rows + span + 7 * grouped)
    q, codes, scale = _quant(rng, 3 if stacked else 0, in_dim, out,
                             gs=gs if grouped else None)
    x = rng.normal(size=(rows, in_dim)).astype(np.float32)
    layer = 1 if stacked else None
    sc = scale[1] if stacked else scale
    kw = dict(group_size=gs if grouped else 0)
    want = np.asarray(jk.int4_matmul(
        jnp.asarray(x), q.codes, jnp.asarray(sc),
        layer=None if layer is None else jnp.int32(layer), interpret=True,
        **kw))
    got = int4_matmul(_t(x), _t(codes), _t(sc), layer=layer, **kw).numpy()
    assert got.shape == (rows, out)
    np.testing.assert_allclose(got, want, rtol=TOL4, atol=TOL4)


@pytest.mark.parametrize("rows,stacked", [(1, False), (8, False), (2, True)])
def test_int8_plain_matches_pallas(rows, stacked):
    rng = np.random.default_rng(100 + rows)
    in_dim, out = 256, 384
    q, codes, scale = _quant(rng, 2 if stacked else 0, in_dim, out, nbits=8)
    # f32 x that bf16 cannot hold: the kernels round it first
    x = rng.normal(size=(rows, in_dim)).astype(np.float32)
    assert not np.array_equal(x, np.asarray(jnp.asarray(x).astype(
        jnp.bfloat16).astype(jnp.float32)))
    layer = 1 if stacked else None
    sc = scale[1] if stacked else scale
    want = np.asarray(jk.int8_matmul(
        jnp.asarray(x), q.codes, jnp.asarray(sc),
        layer=None if layer is None else jnp.int32(layer), interpret=True))
    got = int8_matmul(_t(x), _t(codes), _t(sc), layer=layer).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL8, atol=TOL8)
    # the rounding is what it computes: unrounded x misses by far more
    c = _t(codes[1] if stacked else codes).float()
    loose = ((_t(x) @ c) * _t(sc)).numpy()
    assert np.abs(loose - want).max() > 10 * TOL8


@pytest.mark.parametrize("rows,stacked", [(1, False), (5, True)])
def test_int4_dma_plain_matches_pallas(rows, stacked):
    rng = np.random.default_rng(200 + rows)
    in_dim, out = 512, 512
    q, codes, scale = _quant(rng, 2 if stacked else 0, in_dim, out)
    x = rng.normal(size=(rows, in_dim)).astype(np.float32)
    layer = 0 if stacked else None
    sc = scale[0] if stacked else scale
    want = np.asarray(jk.int4_matmul_dma(
        jnp.asarray(x), q.codes, jnp.asarray(sc),
        layer=None if layer is None else jnp.int32(layer), win=128,
        interpret=True))
    got = int4_matmul_dma(_t(x), _t(codes), _t(sc), layer=layer,
                          win=128).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL4, atol=TOL4)
    with pytest.raises(ValueError, match="span-128"):
        int4_matmul_dma(_t(x), _t(codes[..., :100]), _t(sc[:200]),
                        layer=layer)


def test_bf16_x_keeps_dtype_and_f32_products():
    """bf16 x: products of exact bf16 values with nibbles, f32 sums, one
    rounding of the result to bf16 (what the kernels do on the card)."""
    rng = np.random.default_rng(9)
    _, codes, scale = _quant(rng, 0, 256, 512)
    x = _t(rng.normal(size=(4, 256)).astype(np.float32)).to(torch.bfloat16)
    got = int4_matmul(x, _t(codes), _t(scale))
    assert got.dtype == torch.bfloat16
    want = int4_matmul_plain(x.float(), _t(codes), _t(scale)).to(torch.bfloat16)
    assert torch.equal(got, want)
    got8 = int8_matmul(x, _t(codes.reshape(256, 256)), _t(scale[:256]))
    assert got8.dtype == torch.bfloat16


def test_cpu_tensors_take_plain_path_without_counting():
    rng = np.random.default_rng(1)
    _, codes, scale = _quant(rng, 0, 256, 512)
    x = _t(rng.normal(size=(2, 256)).astype(np.float32))
    before = (int4_matmul.launches, int8_matmul.launches,
              int4_matmul_dma.launches)
    assert torch.equal(int4_matmul(x, _t(codes), _t(scale)),
                       int4_matmul_plain(x, _t(codes), _t(scale)))
    assert torch.equal(int4_matmul_dma(x, _t(codes), _t(scale)),
                       int4_matmul_plain(x, _t(codes), _t(scale)))
    c8 = _t(rng.integers(-127, 128, size=(256, 128)).astype(np.int8))
    assert torch.equal(int8_matmul(x, c8, _t(scale[:128])),
                       int8_matmul_plain(x, c8, _t(scale[:128])))
    assert (int4_matmul.launches, int8_matmul.launches,
            int4_matmul_dma.launches) == before
    with pytest.raises(ValueError, match="layer"):
        int4_matmul(x, _t(codes), _t(scale), layer=0)


@pytest.mark.parametrize("rows,in_dim,ncb,gs", [
    (1, 4096, 3072, 0), (1, 4096, 2048, 0), (1, 14336, 2048, 128),
    (8, 4096, 65536, 0), (40, 4096, 2048, 0), (1, 4096, 2048, 128),
    (3, 64, 20, 16), (1, 256, 256, 24),
])
def test_stream_plans_cover_the_in_dim(rows, in_dim, ncb, gs):
    """Split-K plans at Llama-3-8B's decode shapes: the splits cover the
    in-dim exactly once, a split holds whole groups and each warp's rows
    lie in one group, and the x tile fits shared memory."""
    rt, vb, kc, splits = _plan_stream(rows, in_dim, ncb, gs)
    assert rt in (1, 2, 4, 8) and rt >= min(rows, 8)
    assert ncb % vb == 0 and vb in (16, 4, 1)
    assert kc % 8 == 0 and kc * (splits - 1) < in_dim <= kc * splits
    if gs:
        assert kc % gs == 0 and gs % (kc // 8) == 0
    assert rt * kc * 4 <= 160 * 1024


def _check_plan(p, rows, in_dim, out2, gs):
    """What the int4 kernel (``pkv_int4_mm``) asks of a plan."""
    assert 1 <= p.cluster <= 8 and 1 <= p.ncol * p.kw <= (4 if gs else 8)
    assert p.ks % 64 == 0 and p.ks % (16 * p.kw) == 0
    # the slices cover the in-dim once, each non-empty, whole groups each
    assert p.slice % 16 == 0
    assert p.slice * (p.cluster - 1) < in_dim <= p.slice * p.cluster
    if gs:
        assert p.slice % gs == 0 and in_dim % gs == 0
    assert 1 <= p.rp <= min(8, rows) and p.stages >= 1
    # staged group scales: every group of the slice
    assert p.ss_rows == 0 or (gs and p.ss_rows * gs >= p.slice)
    assert p.smem <= _SMEM_MAX
    assert p.blocks == p.cluster * -(-out2 // (64 * p.ncol))


@pytest.mark.parametrize("rows,in_dim,out2,win", [
    (1, 4096, 2048, 512), (1, 14336, 2048, 512), (8, 4096, 65536, 512),
    (2, 512, 256, 128), (1, 384, 128, 512), (40, 4096, 3072, 512),
])
def test_dma_plans_cover_the_in_dim(rows, in_dim, out2, win):
    """int4_matmul_dma runs the int4 kernel with ring stages of its window
    (shrunk to divide the in-dim, as the JAX package does)."""
    w = dma_stage_rows(in_dim, win)
    assert in_dim % w == 0 and w <= win
    p = int4_tile_plan(rows, in_dim, out2, 0, 132, False, w)
    _check_plan(p, rows, in_dim, out2, 0)
    assert p.ks == max(64, w // 64 * 64)


#: Llama-3-8B's int4 decode shapes: name -> (in, out2 bytes)
LLAMA_INT4 = {"wqkv": (4096, 3072), "wo": (4096, 2048),
              "w_gateup": (4096, 14336), "w_down": (14336, 2048),
              "lm_head4": (4096, 65536)}


@pytest.mark.parametrize("shape", list(LLAMA_INT4))
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("fmt", ["per-channel", "g128", "dma"])
def test_int4_tile_plan_fills_the_card(shape, rows, fmt):
    """At each decode shape, as the engine calls it (bf16 x for the layers,
    f32 x for the lm_head), the int4 plan covers the in-dim with clusters
    of at most 8 slices of whole groups, fits shared memory and gives every
    SM of an H100 at least one block (one launch, no second pass)."""
    in_dim, out2 = LLAMA_INT4[shape]
    gs = 128 if fmt == "g128" else 0
    ks = dma_stage_rows(in_dim) if fmt == "dma" else None
    p = int4_tile_plan(rows, in_dim, out2, gs, 132, shape == "lm_head4", ks)
    _check_plan(p, rows, in_dim, out2, gs)
    assert p.blocks >= 132
    assert p.rp == rows  # one pass over the codes at <= 8 rows
    if ks:
        assert p.ks == ks


@pytest.mark.parametrize("rows,in_dim,out2,gs,x_f32", [
    (3, 64, 3, 0, False), (5, 96, 19, 16, True), (1, 4096, 64128, 0, True),
    (40, 4096, 2048, 128, False), (384, 14336, 2048, 0, True),
    (2, 256, 128, 8, False), (3, 192, 64, 24, True), (1, 3000, 2048, 0, True),
    (9, 4096, 3072, 64, False), (8, 14336, 2048, 2048, True),
])
def test_int4_tile_plan_edges(rows, in_dim, out2, gs, x_f32):
    """Odd widths, k-steps across groups (8, 24), an in-dim the slices do not
    divide evenly, 40 and 384 rows (several passes of 8), f32 x at the
    widest shapes: every plan is one the kernel takes."""
    p = int4_tile_plan(rows, in_dim, out2, gs, 132, x_f32)
    _check_plan(p, rows, in_dim, out2, gs)
    assert p.rp == min(8, rows)


# the tiled order's shapes, (in, out, group size), and a plan of several
# ranks and several warps a column: span 128 and span 1
TILED = {128: (1024, 256, 128, 8), 1: (384, 40, 16, 3)}


@pytest.mark.parametrize("span", [128, 1])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("rows,stacked,x_f32", [
    (1, False, False), (3, False, False), (8, False, False),
    (9, False, False), (40, False, False), (3, True, False),
    (2, False, True)])
def test_int4_tiled_plain_matches_pallas(span, grouped, rows, stacked, x_f32):
    """The kernel's order of sums (per-warp k-steps, per-group partials
    scaled, warps then cluster ranks added in order) against the plain
    version and the Pallas kernel in interpret mode."""
    in_dim, out, gs, ranks = TILED[span]
    rng = np.random.default_rng(300 + rows + span + 7 * grouped + 11 * x_f32)
    q, codes, scale = _quant(rng, 3 if stacked else 0, in_dim, out,
                             gs=gs if grouped else None)
    x = rng.normal(size=(rows, in_dim)).astype(np.float32)
    layer = 1 if stacked else None
    sc = scale[1] if stacked else scale
    g = gs if grouped else 0
    # 4 warps on one column, 128-row stages, slices of 128 rows
    plan = Int4Plan(ncol=1, kw=4, ks=128, stages=2, cluster=ranks,
                    slice=128, rp=min(8, rows), ss_rows=0, smem=1,
                    blocks=ranks * -(-(out // 2) // 64))
    _check_plan(plan, rows, in_dim, out // 2, g)
    xt = _t(x) if x_f32 else _t(x).to(torch.bfloat16)
    got = int4_tiled_plain(xt, _t(codes), _t(sc), plan, layer=layer,
                           group_size=g)
    assert got.dtype == xt.dtype and got.shape == (rows, out)
    plain = int4_matmul_plain(xt, _t(codes), _t(sc), layer=layer,
                              group_size=g)
    tol = TOL4 if x_f32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=tol, atol=tol)
    want = np.asarray(jk.int4_matmul(
        jnp.asarray(xt.float().numpy()), q.codes, jnp.asarray(sc),
        layer=None if layer is None else jnp.int32(layer), interpret=True,
        group_size=g))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_split_x3_is_exact():
    """f32 x == hi + mid + lo bit for bit (three bf16 terms, the int4
    kernel's f32 path), over random f32 of every exponent down to 2^-110,
    tiny values (1e-30, 1e-33) included; below, the lo term rounds at bf16's
    smallest subnormal: an error of at most 2^-134."""
    rng = np.random.default_rng(5)
    mant = rng.uniform(1, 2, size=20000) * rng.choice([-1, 1], size=20000)
    exps = rng.integers(-110, 100, size=20000)
    x = np.concatenate([(mant * np.exp2(exps)).astype(np.float32),
                        rng.normal(size=5000).astype(np.float32),
                        np.float32([1e-30, -1e-33, 3e-34, 1.0, -0.0, 0.0])])
    x = x[(np.abs(x) >= 2.0 ** -110) | (x == 0)]
    hi, mid, lo = split_x3(_t(x))
    s64 = hi.double() + mid.double() + lo.double()
    assert torch.equal(s64, _t(x).double())
    # the kernel's f32 sum of the three products' terms: exact as well
    assert torch.equal((hi.float() + mid.float()) + lo.float(), _t(x))
    tiny = (_t(rng.uniform(1, 2, size=1000)) * 2.0 ** -120).float()
    h, m, lt = split_x3(tiny)
    err = (h.double() + m.double() + lt.double() - tiny.double()).abs()
    assert float(err.max()) <= 2.0 ** -134


def _err_over_tol(got, want, f32):
    """|err| over its limit (<= 1 passes), as chip_smoke.py holds the
    kernels: 2^-7 |want| + 2^-14 rms(want's row) for bf16 outputs (one
    output ulp: the products are exact and only the f32 order differs),
    2^-14 rms(want's row) for f32 ones."""
    g, w = got.float(), want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    lim = (0.0 if f32 else 2.0 ** -7) * w.abs() + 2.0 ** -14 * rms
    return float(((g - w).abs() / lim.clamp_min(1e-30)).max())


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    """All three CUDA kernels against their plain versions (runs only where
    a card and nvcc are present; chip_smoke.py covers the Llama-3-8B
    decode shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for in_dim, out, gs in ((4096, 6144, 0), (4096, 1024, 128),
                            (64, 6, 16), (512, 768, 0)):
        _, codes, scale = _quant(rng, 0, in_dim, out, gs=gs or None)
        c, s = _t(codes).to(dev), _t(scale).to(dev)
        for rows, dt in ((1, torch.bfloat16), (8, torch.bfloat16),
                         (40, torch.bfloat16), (2, torch.float32)):
            x = torch.randn((rows, in_dim), device=dev).to(dt)
            before = int4_matmul.launches
            got = int4_matmul(x, c, s, group_size=gs)
            assert int4_matmul.launches == before + 1
            want = int4_matmul_plain(x, c, s, group_size=gs)
            assert _err_over_tol(got, want, dt == torch.float32) <= 1
            if not gs and codes.shape[-1] % 128 == 0:
                got = int4_matmul_dma(x, c, s)
                assert _err_over_tol(got, want, dt == torch.float32) <= 1
    c8 = torch.randint(-127, 128, (4096, 1024), dtype=torch.int8, device=dev)
    s8 = torch.rand((1024,), device=dev) / 127
    for rows, dt in ((1, torch.bfloat16), (8, torch.float32)):
        x = torch.randn((rows, 4096), device=dev).to(dt)
        assert _err_over_tol(int8_matmul(x, c8, s8),
                             int8_matmul_plain(x, c8, s8),
                             dt == torch.float32) <= 1
