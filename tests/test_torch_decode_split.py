"""The split-S decode schedule of the port's decode kernel, on the CPU.

``kernels/decode_attn.py::decode_split_plan`` cuts each (batch row, KV
head) into slot ranges from the shapes alone; ``decode_attention_split_plain``
is the kernel's schedule in plain PyTorch (f32 partials per split, a wholly
masked split dropped, an all-masked row averaged over every slot, the
splits merged in order).  Here it is held to the port's plain decode and to
the JAX package's Pallas kernel in interpret mode on the same numpy inputs;
the KIVI group route's plan is held to one CUDA launch exactly where its
splits fit one thread-block cluster.

Tolerance: f32 on every side (the oracle's probabilities stay f32, as the
kernel's; the plain version and the Pallas kernel keep them f32 for f32
V), summed in other orders: 2e-4, as ``test_torch_kernels.py``'s
``test_plain_decode_matches_pallas``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pyramidkv_tpu.kernels.decode_attn import decode_attention_pallas
from pyramidkv_tpu_torch.kernels import decode_attn, quant_decode
from pyramidkv_tpu_torch.ops import attention as plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-4
CPU = torch.device("cpu")


@pytest.mark.parametrize("bhk,s", [
    (8, 32896),    # 32k fullkv, B=1
    (32, 8224),    # the 8k batch's fullkv
    (128, 2080),   # snapkv on the 8k batch
    (128, 4018),   # a pyramidkv segment
    (32, 256),     # 32k snapkv: one split
    (1, 1), (3, 65), (2, 200_000),
])
def test_split_plan_covers_every_slot(bhk, s):
    nsplit, rows = decode_attn.decode_split_plan(CPU, bhk, s)
    assert rows % decode_attn.TILE == 0 and rows <= 32 * decode_attn.TILE
    spans = [(i * rows, min(s, (i + 1) * rows)) for i in range(nsplit)]
    assert all(lo < hi for lo, hi in spans)           # no split is empty
    assert spans[0][0] == 0 and spans[-1][1] == s     # their union is [0, S)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # the plan is a function of the shapes: the same on every call
    assert decode_attn.decode_split_plan(CPU, bhk, s) == (nsplit, rows)


def test_split_plan_fills_the_card():
    """About 2 blocks per SM of an H100 (one wave at the kernel's residency)
    where the slots allow it: 33 splits of 1024 slots for 32k fullkv's 8
    regions, 8 of 1088 for the 8k batch's 32, 4 of one tile for 32k
    snapkv's 256 slots."""
    assert decode_attn.decode_split_plan(CPU, 8, 32896) == (33, 1024)
    assert decode_attn.decode_split_plan(CPU, 32, 8224) == (8, 1088)
    assert decode_attn.decode_split_plan(CPU, 128, 2080) == (2, 1088)
    assert decode_attn.decode_split_plan(CPU, 32, 256) == (4, 64)
    # many regions: a split only where S passes the 2048-slot cap
    assert decode_attn.decode_split_plan(CPU, 264, 2000) == (1, 2048)
    assert decode_attn.decode_split_plan(CPU, 264, 4000) == (2, 2048)


def _inputs(seed, b, h, hk, s, d=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    mask = rng.random(size=(b, hk, s)) < 0.6
    return q, k, v, mask


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("nsplit,s", [(1, 50), (3, 175), (7, 400)])
def test_split_oracle_matches_plain_and_pallas(g, nsplit, s):
    b, hk = 2, 2
    q, k, v, mask = _inputs(nsplit * 10 + g, b, hk * g, hk, s)
    rows = decode_attn.TILE
    if nsplit > 1:
        mask[0, 1, rows:2 * rows] = False   # a wholly masked split
        mask[1, 0, :rows] = False           # a masked left run, as a pad
    mask[1, 1] = False                      # a row masked everywhere
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    got = decode_attn.decode_attention_split_plain(*t, nsplit, max(rows, s)
                                                   if nsplit == 1 else rows)
    want = plain.decode_attention(*t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    pallas = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)
    # the all-masked row is the uniform mean of V, in every split's share
    uni = v[1, 1].mean(0)
    for gi in range(g):
        np.testing.assert_allclose(got[1, g + gi].numpy(), uni, rtol=TOL,
                                   atol=TOL)


def test_split_oracle_refuses_a_plan_that_misses_slots():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(0, 1, 1, 1, 130))
    with pytest.raises(ValueError, match="cover"):
        decode_attn.decode_attention_split_plain(q, k, v, mask, 2, 64)
    with pytest.raises(ValueError, match="cover"):
        decode_attn.decode_attention_split_plain(q, k, v, mask, 4, 64)


@pytest.mark.parametrize("bhk,w", [
    (32, 64),        # bench.py's 32k snapkv kivi4 group (cap 128)
    (128, 1024),     # the 8k batch's snapkv kivi4 group
    (8, 16384),      # 32k fullkv kivi4 group
    (1, 8), (600, 4096), (4, 255), (64, 512),
])
def test_group_route_is_one_launch_exactly_on_one_split(bhk, w):
    """The group route launches one CUDA kernel (region, bf16 tail and
    merge together) where the split plan gives one split and where its
    splits fit one thread-block cluster (up to MAX_CLUSTER: the cluster
    merges them), and the split kernel plus a merge kernel otherwise."""
    nsplit, _ = quant_decode.split_plan(CPU, bhk, w, 4, 64)
    kernels = quant_decode.region_kernels(nsplit)
    assert (kernels == 1) == (nsplit <= quant_decode.MAX_CLUSTER)
    # 8 regions of 32k fullkv kivi4: 32 splits and a merge kernel; 600
    # regions of 4096 byte-rows: 11 splits (their staged K groups)
    assert kernels == (2 if (bhk, w) in ((8, 16384), (600, 4096)) else 1)
