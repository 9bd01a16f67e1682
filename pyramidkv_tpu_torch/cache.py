"""Static-shape compressed KV cache (counterpart of ``pyramidkv_tpu/cache.py``).

Every layer owns a fixed ``[B, H, S, D]`` slot buffer laid out as::

    [ selected past (width) | recency window (W) | decode slots (max_new) ]

with a boolean validity mask.  Per-layer budgets are expressed through the
mask, not through ragged shapes.

Unlike the JAX cache, which is an immutable pytree threaded through the
decode loop, this one is updated IN PLACE: the decode append writes one
slot of each layer's buffers, and :func:`decode_step` returns the same
buffers with ``step`` advanced.  With a KIVI cache the prefill slots live
in ``quant`` (one quantized region per layer, leaves stacked) and ``k``/``v``
hold only the bf16 decode slots.  With ThinK's narrow layout the
pruned-region keys live in ``think`` at ``D_kept`` channels and ``k`` holds
only the recent, window and decode slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import torch

from .ops.quant import QuantizedKVRegion, region_leaves

Stack = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class ThinKRegion(NamedTuple):
    """ThinK's narrow key storage: the pruned-region slots' keys at
    ``D_kept = D - int(D * pruning_ratio)`` channels.  V and the recent,
    window and decode keys stay full width in the cache's buffers."""

    k_pruned: torch.Tensor       #: [L, B, H, S_pruned, D_kept]
    kept_channels: torch.Tensor  #: [L, B, H, D_kept] int32, ascending


@dataclass
class KVCache:
    """Layer-stacked compressed KV cache.

    With a segmented plan (``PolicyPlan.segments``), ``k``/``v``/``mask``/
    ``positions`` each hold a tuple of per-segment stacks
    ``[L_seg, B, H, S_seg, D]`` instead of one ``[L, B, H, S, D]`` tensor.
    """

    k: Stack          #: [L, B, H, S, D] (or a tuple per segment)
    v: Stack          #: [L, B, H, S, D]
    mask: Stack       #: [L, B, H, S] bool — slot holds a real token
    positions: Stack  #: [L, B, H, S] int32 — token position (-1 invalid)
    true_len: torch.Tensor  #: [B] int32 — true prompt length
    step: int = 0     #: decode steps taken so far
    #: KIVI: the prefill region of every layer (leaves stacked [L, ...]);
    #: ``k``/``v`` then hold only the decode slots, while ``mask``/
    #: ``positions`` stay full length (prefill slots, then decode slots)
    quant: Optional[QuantizedKVRegion] = None
    #: ThinK narrow layout: the pruned-region keys; ``k`` then holds only
    #: the slots after them, while ``v``/``mask``/``positions`` stay full
    #: length
    think: Optional[ThinKRegion] = None

    @property
    def segmented(self) -> bool:
        return isinstance(self.k, tuple)

    def current_position(self) -> torch.Tensor:
        """[B] position id of the NEXT token to be generated."""
        return self.true_len.to(torch.int64) + self.step


class LayerCacheView(NamedTuple):
    """One layer's slice of the cache (views, no copies)."""

    k: torch.Tensor          #: [B, H, S, D]
    v: torch.Tensor          #: [B, H, S, D]
    mask: torch.Tensor       #: [B, H, S]
    positions: torch.Tensor  #: [B, H, S]


def _leaves(x: Stack):
    return list(x) if isinstance(x, tuple) else [x]


def cache_memory_bytes(cache: KVCache) -> int:
    """Device bytes of the K/V buffers, the quantized region's codes,
    scales and zeros and ThinK's narrow region (mask and positions
    excluded, as in the JAX package)."""
    think = list(cache.think) if cache.think is not None else []
    return sum(t.numel() * t.element_size()
               for t in _leaves(cache.k) + _leaves(cache.v)
               + region_leaves(cache.quant) + think)


def used_kv_tokens(cache: KVCache) -> int:
    """Live KV entries summed over layers, batch rows and heads."""
    return int(sum(int(m.sum()) for m in _leaves(cache.mask)))
