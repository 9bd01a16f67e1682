"""Decode attention over a pa-layout KIVI region: wrapper of
``csrc/quant_fused_decode.cu``.

Counterpart of ``pyramidkv_tpu/kernels/quant_fused_decode.py``'s
``quant_fused_attention_pa`` with its adapter
``region_attention_fused_kernel``: the affine dequantization folds through
the attention algebra (K scale into the bf16 query, K zero into a logit
bias, V scale into the bf16 probabilities, V zero into a per-row scalar), so
no dequantized copy exists.  K may carry one scale group per chunk (the
chunked prefill's region): the query then folds once per group.  On a CUDA
tensor it launches the hand-written sm_90a kernel (slots split across
blocks, a finish pass merging them); on a CPU tensor it runs the plain
version (``ops.quant.quant_region_attention_fused``).  Arguments and
results as ``kernels/quant_decode.py``.
"""

from __future__ import annotations

import math

import torch

from ..ops.quant import (QuantizedKVRegion, merge_tail,
                         quant_region_attention_fused, region_geometry)
from .quant_decode import check_unsupported, launch_region, pa_split_plan


#: CUDA kernels a call launches: the split kernel and its finish pass
PA_KERNELS = 2


def quant_fused_attention_pa(q: torch.Tensor, reg: QuantizedKVRegion,
                             mask: torch.Tensor, *, nbits: int, tail=None,
                             scale=None, softcap=None):
    """q: [B, H, D]; ``reg`` one layer's pa-layout region; mask
    [B, Hk, n <= S_pad] -> (acc [B, H, D], m [B, H], l [B, H]) f32; with
    ``tail`` the layer's attention output over region and tail, [B, H, D]
    in q's dtype (see ``quant_decode_attention``)."""
    check_unsupported(scale, softcap)
    w, _, kg, _ = region_geometry(reg, nbits)
    gk = reg.k.scale.shape[-2]
    if reg.v.scale.shape[-2] != 1 or (gk > 1 and w % kg):
        raise ValueError("quant_fused_attention_pa takes the pa layout: one "
                         "V group, K groups that tile each bit-plane")
    if q.device.type == "cpu":
        return merge_tail(quant_region_attention_fused(q, reg, mask,
                                                       nbits=nbits), q, tail)
    if gk > 1 and q.shape[1] // reg.k.codes.shape[1] * (8 // nbits) > 16:
        raise ValueError("the pa kernel folds K groups for G * 8 / nbits <= "
                         "16 (one query copy per bit-plane in shared memory)")
    b, hk = reg.k.codes.shape[:2]
    nsplit, rows = pa_split_plan(q.device, b * hk, w)
    if gk > 1:  # each split stays inside one group's byte-rows
        rows = math.gcd(rows, kg)
        nsplit = -(-w // rows)
    out = launch_region("pkv_quant_fused_pa", "quant_fused_decode", q, reg,
                        mask, nbits, (nsplit, rows), tail=tail,
                        workspace=True)
    quant_fused_attention_pa.launches += 1
    quant_fused_attention_pa.kernels += PA_KERNELS
    return out


#: wrapper calls that launched on the card since the last reset (CPU calls
#: do not count), and the CUDA kernels those calls launched
quant_fused_attention_pa.launches = quant_fused_attention_pa.kernels = 0
