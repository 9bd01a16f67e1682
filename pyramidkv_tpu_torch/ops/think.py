"""ThinK's query-driven key-channel pruning (counterpart of
``pyramidkv_tpu/ops/think.py``).

A channel's importance per (row, head) is mean(q^2 over the last 32
queries) x mean(k^2 over the real keys); the ``int(D * ratio)`` lowest are
dropped from all but the recent keys.  The kept channels come back as
ascending indices of a static count, so the pruned keys can live in a dense
``[B, H, S, D_kept]`` buffer (the narrow layout of ``cache.ThinKRegion``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ChannelPrune(NamedTuple):
    #: [B, H, D_kept] int64 — kept channel indices, ascending.
    kept_channels: torch.Tensor
    #: [B, H, D] bool — True at kept channels.
    channel_mask: torch.Tensor


def think_channel_selection(
    k: torch.Tensor,
    q: torch.Tensor,
    *,
    ratio: float,
    true_len: torch.Tensor,
    obs_queries: int = 32,
    valid_mask: Optional[torch.Tensor] = None,
) -> ChannelPrune:
    """Score the key channels and pick the kept set.

    k: [B, H, N, D] keys to prune (a left-padded buffer, or a compacted one
    with ``valid_mask`` [B, H, N] naming its real rows); q: [B, H, Nq, D],
    whose last ``obs_queries`` rows drive the score."""
    b, h, n, d = k.shape
    keep = d - int(d * ratio)
    q_norm = q[:, :, -obs_queries:].float().square().mean(dim=2)  # [B,H,D]
    kf = k.float().square()
    if valid_mask is None:
        col = torch.arange(n, device=k.device)[None, :]
        pad = (n - true_len).to(torch.int64)[:, None]
        valid = (col >= pad)[:, None, :, None]
        denom = true_len.float().clamp_min(1.0)[:, None, None]
    else:
        valid = valid_mask[..., None]
        denom = valid_mask.sum(dim=2).float().clamp_min(1.0)[..., None]
    k_norm = kf.masked_fill(~valid, 0.0).sum(dim=2) / denom
    score = q_norm * k_norm
    # lax.top_k's order: descending, lower index first on ties
    kept = torch.sort(score, dim=-1, descending=True, stable=True)[1][
        ..., :keep]
    kept = torch.sort(kept, dim=-1)[0]
    mask = torch.zeros((b, h, d), dtype=torch.bool, device=k.device)
    mask.scatter_(2, kept, True)
    return ChannelPrune(kept_channels=kept, channel_mask=mask)


def gather_channels(x: torch.Tensor,
                    kept_channels: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, D] -> its kept channels [B, H, N, D_kept]."""
    b, h, n, _ = x.shape
    idx = kept_channels[:, :, None, :].expand(b, h, n, -1)
    return torch.gather(x, 3, idx)
