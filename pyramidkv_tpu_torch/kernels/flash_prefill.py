"""Causal flash-attention prefill: wrapper of ``csrc/flash_prefill.cu``.

Counterpart of ``pyramidkv_tpu/kernels/flash_prefill.py::
flash_causal_attention`` in its default schedule (one pass, ``sub_k=1``,
``q_start=0``).  On a CUDA tensor it launches the hand-written sm_90a
kernel; on a CPU tensor it runs the plain version
(``ops.attention.causal_prefill_attention``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import causal_prefill_attention
from . import _build

#: q rows per block and keys per tile of the CUDA kernel
TILE = 64
HEAD_DIM = 128


def flash_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    true_len: torch.Tensor,
    *,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    q_start: int = 0,
) -> torch.Tensor:
    """Causal GQA attention over a left-padded buffer.

    q: [B, H, N, D]; k, v: [B, Hk, N, D]; true_len: [B] int.
    Returns [B, H, N, D]; rows below the left pad are 0 on the card (no
    visible key) and unspecified on the CPU path — callers never read them.
    """
    if softcap is not None or q_start != 0:
        raise NotImplementedError(
            "softcap and q_start are not ported yet (ROADMAP queue 2)")
    if q.device.type == "cpu":
        return causal_prefill_attention(
            q, k, v, true_len=true_len, sliding_window=sliding_window,
            scale=scale)
    b, h, n, d = q.shape
    hk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k.shape != (b, hk, n, d) or v.shape != k.shape or h % hk:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d != HEAD_DIM or n % TILE:
        raise ValueError(f"kernel takes D == {HEAD_DIM} and N % {TILE} == 0, "
                         f"got D={d} N={n}")
    tl = true_len.to(device=q.device, dtype=torch.int32).contiguous()
    if tl.shape != (b,):
        raise ValueError(f"true_len must be [{b}], got {tuple(tl.shape)}")
    out = torch.empty_like(q)
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _build.library("flash_prefill")
    err = lib.pkv_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tl.data_ptr(),
        out.data_ptr(), b, h, hk, n, int(sliding_window or 0), float(sc),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    flash_causal_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
flash_causal_attention.launches = 0
