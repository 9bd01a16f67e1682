"""One-token decode attention: wrapper of ``csrc/decode_attn.cu``.

Counterpart of ``pyramidkv_tpu/kernels/decode_attn.py::
decode_attention_pallas`` — on the H100 it is the port's decode path for
every cache size (the TPU kept it opt-in and capped at 4096 slots).  On a
CUDA tensor it launches the hand-written sm_90a kernel; on a CPU tensor it
runs the plain version (``ops.attention.decode_attention``).
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import decode_attention as decode_attention_plain
from . import _build

HEAD_DIM = 128
#: GQA group sizes the kernel is instantiated for
GROUPS = (1, 2, 4, 8)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """q: [B, H, D]; k, v: [B, Hk, S, D]; mask: [B, Hk, S] bool -> [B, H, D]
    with softmax scale 1/sqrt(D)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask)
    b, h, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if (k.shape != (b, hk, s, d) or v.shape != k.shape
            or mask.shape != (b, hk, s) or h % hk):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} mask {tuple(mask.shape)}")
    if d != HEAD_DIM or h // hk not in GROUPS or s < 1:
        raise ValueError(f"kernel takes D == {HEAD_DIM}, H/Hk in {GROUPS}, "
                         f"S >= 1; got D={d} H/Hk={h / hk} S={s}")
    if (mask.dtype != torch.bool or not mask.is_contiguous()
            or mask.device != q.device):
        raise ValueError("mask must be a contiguous bool tensor on q's device")
    out = torch.empty_like(q)
    lib = _build.library("decode_attn")
    err = lib.pkv_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b, h, hk, s, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attn")
    decode_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
decode_attention.launches = 0
