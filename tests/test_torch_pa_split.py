"""The plan and schedule of the port's pa-layout KIVI decode kernel
(``csrc/quant_region.cuh``, ``pa_split_kernel`` + ``pa_finish_kernel``), on
the CPU.

- ``pa_split_plan`` (from the shapes alone): every byte-row lies in exactly
  one split on every plane, every warp of a full split gets the same rows
  (whole 64-row quanta, 16-row units dealt in turn), a split stays inside
  one K group's byte-rows (the chunked carry's Gk > 1), the engine shapes'
  plans written out; ``pa_smem_bytes`` (the mirror of ``pa_smem_bytes`` in
  the source) lets two blocks share an SM for G in {1, 2, 4, 8}, nbits in
  {2, 4, 8} and Gk in {1, 4}.
- ``pa_split_plain`` (the kernel's schedule: units dealt to 4 warps, each
  warp's own online softmax, p rounded to bf16 at the warp's running max,
  warps then splits merged in order, the tail last) against the plain
  version (``ops.quant.quant_region_attention_fused``) and against JAX's
  Pallas ``quant_fused_attention_pa`` in interpret mode
  (``region_attention_fused_kernel``), on the same regions: G = 8 kivi2
  with Gk = 4, kivi4 with a split ending inside a unit, kivi8, and an odd
  V row (129 bytes).  The limits are ``chip_smoke.py``'s for the kernel
  (PERF.md section 2): acc / l within 2^-6 |want| + 2^-5 rms(row), m within
  2^-12 max(1, |m|), l within 2^-10 l: the probabilities are rounded to
  bf16 at other maxima (a warp's running max, the TPU's tile maxima, the
  plain version's row max), so a term moves by up to a bf16 ulp.  A row
  whose slots are all masked gives m = float32.min and l = 0 exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu.kernels.quant_fused_decode import (
    region_attention_fused_kernel)
from pyramidkv_tpu.ops import quant as jq
from pyramidkv_tpu_torch.kernels.quant_decode import MAX_SMEM
from pyramidkv_tpu_torch.kernels.quant_fused_decode import (
    PA_UNIT, PA_WARPS, pa_smem_bytes, pa_split_plain, pa_split_plan,
    pa_split_rows)
from pyramidkv_tpu_torch.ops import quant as tq
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
NEG = float(np.finfo(np.float32).min)
QUANTUM = PA_WARPS * PA_UNIT


@pytest.mark.parametrize("bhk,w,seg", [
    (8, 16448, 0), (128, 1024, 0), (8, 16384, 8192), (1, 40, 0),
    (3, 777, 0), (2, 1000, 250), (32, 64, 0), (1, 256, 64)])
def test_pa_split_plan_tiles_each_group(bhk, w, seg):
    nsplit, rows = pa_split_plan(CPU, bhk, w, seg)
    grp = seg or w
    assert rows % QUANTUM == 0
    assert nsplit == w // grp * -(-grp // rows)  # the C entry's check
    cover = np.zeros(w, np.int64)
    for s in range(nsplit):
        r0, r1 = pa_split_rows(s, rows, grp, w)
        assert r0 < r1 and r0 // grp == (r1 - 1) // grp  # one K group
        cover[r0:r1] += 1
        # the warps' rows: units of 16 dealt in turn
        per_warp = [sum(min(u + PA_UNIT, r1) - u
                        for u in range(r0 + wp * PA_UNIT, r1, QUANTUM))
                    for wp in range(PA_WARPS)]
        if r1 - r0 == rows:
            assert len(set(per_warp)) == 1
        else:  # a group's last split: within one unit of each other
            assert max(per_warp) - min(per_warp) <= PA_UNIT
    assert (cover == 1).all()  # every byte-row (so every plane) once
    assert nsplit * bhk <= 2 * 132 or nsplit == w // grp


def test_pa_split_plan_of_the_engine_shapes():
    """32k fullkv kivi4-pa (8 regions of 16448 byte-rows), the 8k batch's
    snapkv kivi4-pa (128 of 1024) and the chunked carry of run (e) (8
    regions, K groups of 8192 byte-rows): one wave of two blocks an SM, 8
    units a warp."""
    assert pa_split_plan(CPU, 8, 16448) == (33, 512)
    assert pa_split_plan(CPU, 128, 1024) == (2, 512)
    assert pa_split_plan(CPU, 8, 16384, 8192) == (32, 512)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("gk", [1, 4])
def test_pa_smem_fits_two_blocks_an_sm(g, nbits, gk):
    """The folded queries live in dynamic shared memory, one copy a field
    whatever Gk (a split folds one K group a plane): two blocks an SM fit
    the SM's 228 KB with 1 KB reserved a block."""
    smem = pa_smem_bytes(g, nbits)
    assert smem <= MAX_SMEM
    assert 2 * (smem + 1024) <= 228 * 1024


def _region(nbits, b, hk, g, s, gs, gk, seed, valid=0.8):
    rng = np.random.default_rng(seed)
    d = 128
    q = torch.from_numpy(rng.normal(size=(b, hk * g, d)).astype(np.float32))
    chan = np.exp(rng.normal(size=(d,))).astype(np.float32)
    k = torch.from_numpy((rng.normal(size=(b, hk, s, d)) * chan).astype(
        np.float32))
    v = torch.from_numpy(rng.normal(size=(b, hk, s, d)).astype(np.float32))
    reg = tq.quantize_kv_region(k, v, nbits=nbits, group_size=gs,
                                layout="pa")
    if gk > 1:  # the chunked carry: K groups of s_pad / gk slots
        s_pad = reg.k.codes.shape[2] * (8 // nbits)
        kt = torch.nn.functional.pad(k.transpose(2, 3), (0, s_pad - s))
        kq = tq.quantize(kt, nbits=nbits, group_size=s_pad // gk)
        reg = reg._replace(k=kq._replace(
            codes=kq.codes.transpose(-1, -2).contiguous()))
    mask = torch.from_numpy(rng.random((b, hk, s)) < valid)
    mask[0, 0] = False  # a region row with no visible slot
    tail = (torch.from_numpy(rng.normal(size=(b, hk, 37, d)).astype(
        np.float32)), torch.from_numpy(rng.normal(size=(b, hk, 37, d)).astype(
            np.float32)), torch.from_numpy(rng.random((b, hk, 37)) < 0.9))
    return q, reg, mask, tail


def _jax_pa(q, reg, mask, nbits):
    k, v = (jq.QuantizedTensor(*(jnp.asarray(x.numpy()) for x in part),
                               outliers=None) for part in reg)
    jreg = jq.QuantizedKVRegion(k=k, v=v, k_out_idx=None, k_out_val=None,
                                v_out_idx=None, v_out_val=None)
    return tuple(np.asarray(x) for x in region_attention_fused_kernel(
        jnp.asarray(q.numpy()), jreg, jnp.asarray(mask.numpy()),
        head_dim=q.shape[-1], nbits=nbits, interpret=True))


def _check(got, want):
    acc, m, l = (np.asarray(x) for x in got)
    wacc, wm, wl = (np.asarray(x) for x in want)
    live = wl > 0
    assert (live == (l > 0)).all()
    assert (m[~live] == NEG).all() and (wm[~live] == NEG).all()
    o = acc[live] / l[live][:, None]
    ow = wacc[live] / wl[live][:, None]
    rms = np.sqrt(np.mean(ow ** 2, -1, keepdims=True))
    assert (np.abs(o - ow) <= 2.0 ** -6 * np.abs(ow) + 2.0 ** -5 * rms).all()
    assert (np.abs(m[live] - wm[live])
            <= 2.0 ** -12 * np.maximum(1.0, np.abs(wm[live]))).all()
    assert (np.abs(l[live] - wl[live]) <= 2.0 ** -10 * wl[live]).all()


#: (nbits, b, hk, g, slots, V group size, Gk, byte-rows a split): G = 8
#: kivi2 with 4 K groups; kivi4 on 5 splits; kivi8 on one split; an odd V
#: row (group size 3: 129-byte rows) over 252 byte-rows, the last split
#: ending inside a unit
CASES = [
    (2, 1, 2, 8, 1000, 64, 4, 64),
    (4, 2, 2, 4, 600, 64, 1, 64),
    (8, 1, 2, 1, 300, 64, 1, 320),
    (4, 1, 1, 2, 500, 3, 1, 128),
]


@pytest.mark.parametrize("case", CASES)
def test_pa_schedule_matches_plain_and_pallas(case):
    nbits, b, hk, g, s, gs, gk, rows = case
    q, reg, mask, tail = _region(nbits, b, hk, g, s, gs, gk, seed=s + g)
    w, s_pad, kg, _ = tq.region_geometry(reg, nbits)
    assert reg.k.scale.shape[-2] == gk and reg.v.codes.shape[-1] % 2 == (
        gs == 3)
    grp = kg if gk > 1 else w
    plan = (w // grp * -(-grp // rows), rows)
    got = pa_split_plain(q, reg, mask, nbits=nbits, plan=plan)
    _check(got, tq.quant_region_attention_fused(q, reg, mask, nbits=nbits))
    _check(got, _jax_pa(q, reg, mask, nbits))
    # with the step's tail: the layer's output, as the plain merge gives it
    out = pa_split_plain(q, reg, mask, nbits=nbits, plan=plan, tail=tail)
    want = tq.merge_tail(tq.quant_region_attention_fused(
        q, reg, mask, nbits=nbits), q, tail).numpy()
    rms = np.sqrt(np.mean(want ** 2, -1, keepdims=True))
    assert (np.abs(out.numpy() - want)
            <= 2.0 ** -6 * np.abs(want) + 2.0 ** -5 * rms).all()
