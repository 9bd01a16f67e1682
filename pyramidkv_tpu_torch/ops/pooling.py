"""1-D score-vector pooling (counterpart of ``pyramidkv_tpu/ops/pooling.py``).

Stride 1 and ``padding = kernel // 2``, as every observation-window policy
of the reference uses it: ``F.avg_pool1d`` divides by the full kernel
including the zero padding (``count_include_pad=True``), and
``F.max_pool1d`` pads with -inf, so edge windows take the max of the real
elements only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pool1d(x: torch.Tensor, kernel_size: int, mode: str) -> torch.Tensor:
    """Pool the last axis of ``x`` ([..., n] float scores), SAME padding."""
    if kernel_size == 1:
        return x
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    pad = kernel_size // 2
    flat = x.reshape(-1, 1, x.shape[-1])
    if mode == "avgpool":
        y = F.avg_pool1d(flat, kernel_size, stride=1, padding=pad,
                         count_include_pad=True)
    elif mode == "maxpool":
        y = F.max_pool1d(flat, kernel_size, stride=1, padding=pad)
    else:
        raise ValueError(f"unknown pooling mode {mode!r}")
    return y.reshape(x.shape)
