"""Budget schedules, top-k selection and cache compaction (counterpart of
``pyramidkv_tpu/ops/selection.py``).

Selection is a fixed-width top-k whose validity (how many selected slots are
real) is a per-element count mirroring the reference's dynamic branches
(``q_len < cap`` keeps all, PyramidKV's three regimes).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CompressionSpec


# ---------------------------------------------------------------------------
# Keep counts
# ---------------------------------------------------------------------------


def uniform_keep_counts(
    spec: CompressionSpec, true_len: torch.Tensor, window_size: int
) -> torch.Tensor:
    """[B] past (non-window) tokens kept by the single-budget methods:
    everything when ``true_len < cap``, else ``cap - w``."""
    cap = spec.max_capacity_prompt
    avail = torch.clamp(true_len - window_size, min=0)
    return torch.where(true_len < cap, avail,
                       torch.clamp(avail, max=cap - window_size))


def pyramid_keep_counts(
    spec: CompressionSpec, num_layers: int, true_len: torch.Tensor
) -> torch.Tensor:
    """[L, B] PyramidKV past-token keep counts: ``q_len < cap`` keeps all,
    ``q_len < 2 (cap - w)`` keeps ``cap - w``, else the arithmetic pyramid
    (its short-prompt clamp evaluated on the true length)."""
    cap, w = spec.max_capacity_prompt, spec.window_size
    capw = cap - w
    tl = true_len.to(torch.int64)
    qlw = tl - w
    min0 = capw // spec.beta
    max0 = capw * 2 - min0
    clamped = max0 >= qlw
    max_num = torch.where(clamped, qlw, torch.full_like(qlw, max0))
    min_num = torch.where(clamped, capw * 2 - qlw, torch.full_like(qlw, min0))
    steps = torch.div(max_num - min_num, max(num_layers - 1, 1),
                      rounding_mode="floor")
    layer = torch.arange(num_layers, device=tl.device)[:, None]
    b_l = max_num[None, :] - layer * steps[None, :]  # [L, B]
    avail = torch.clamp(qlw, min=0)[None, :]
    n = torch.where(
        (tl < cap)[None, :], avail,
        torch.where((tl < 2 * capw)[None, :], torch.clamp(avail, max=capw),
                    torch.minimum(b_l, avail)))
    return n.to(torch.int32)


def static_selection_width(
    spec: CompressionSpec, num_layers: int, bucket_len: int
) -> int:
    """The static top-k width: an upper bound on any layer's keep count."""
    cap, w = spec.max_capacity_prompt, spec.window_size
    m = spec.method
    if m in ("fullkv", "minference"):  # minference compresses nothing
        return bucket_len
    if m == "pyramidkv":
        capw = cap - w
        max0 = capw * 2 - capw // spec.beta
        return min(max0, max(bucket_len - w, 1))
    if m in ("snapkv", "h2o"):
        return min(cap - w, max(bucket_len - w, 1))
    raise NotImplementedError(
        f"method {m!r} is not ported yet (ROADMAP queue 1)")


def selection_window(spec: CompressionSpec) -> int:
    """The recency window kept verbatim after the selected past tokens."""
    return 0 if spec.method == "fullkv" else spec.window_size


# ---------------------------------------------------------------------------
# Top-k selection + compaction into the static cache layout
# ---------------------------------------------------------------------------


class Selection(NamedTuple):
    #: [B, H, width] int64 buffer-column indices of the kept past tokens.
    indices: torch.Tensor
    #: [B, H, width] bool — which of the static slots are real.
    valid: torch.Tensor


def topk_select(
    scores: torch.Tensor, width: int, keep_counts: torch.Tensor
) -> Selection:
    """Fixed-width top-k with per-element validity.

    Ties break toward the LOWER index, as ``jax.lax.top_k`` does
    (``torch.topk`` does not promise an order among ties, and maxpool
    scores tie exactly): a stable descending sort, cut at ``width``.
    ``keep_counts`` is [B] (broadcast over heads) or [B, H].
    """
    c = scores.shape[-1]
    width = min(width, c)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :width], idx[..., :width]
    if keep_counts.dim() == 1:
        keep_counts = keep_counts[:, None]
    rank = torch.arange(width, device=scores.device)[None, None, :]
    valid = (rank < keep_counts[:, :, None]) & torch.isfinite(vals)
    return Selection(indices=idx, valid=valid)


class CompactedKV(NamedTuple):
    """One layer's compacted cache content, slot layout
    ``[selected past (width) | recency window (W) | decode slots]``."""

    k: torch.Tensor          # [B, H, S, D]
    v: torch.Tensor          # [B, H, S, D]
    mask: torch.Tensor       # [B, H, S] bool — slot holds a real token
    positions: torch.Tensor  # [B, H, S] int32 — token position, -1 if invalid


def compact_kv(
    k: torch.Tensor,
    v: torch.Tensor,
    sel: Selection,
    *,
    window_size: int,
    decode_slots: int,
    true_len: torch.Tensor,
) -> CompactedKV:
    """Gather the selected past tokens and the verbatim window into the slot
    layout.  k, v: [B, Hk, N, D]; ``sel`` has H >= Hk selection heads.

    The gather indexes each query head's KV head directly (exact, like the
    JAX package's one-hot product, which is a TPU workaround for slow
    gathers); only the W window rows are repeated to the H heads."""
    b, hk, n, d = k.shape
    h = sel.indices.shape[1]
    w = window_size
    dev = k.device
    pad = (n - true_len).to(torch.int64)[:, None, None]  # [B,1,1]
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = (torch.arange(h, device=dev) // (h // hk))[None, :, None]
    kept_k = k[bi, hi, sel.indices]  # [B, H, width, D]
    kept_v = v[bi, hi, sel.indices]
    kept_pos = sel.indices - pad
    if w > 0:
        win_k = k[:, :, n - w:].repeat_interleave(h // hk, dim=1)
        win_v = v[:, :, n - w:].repeat_interleave(h // hk, dim=1)
        win_col = torch.arange(n - w, n, device=dev)[None, None, :]
        win_mask = (win_col >= pad).expand(b, h, w)
        win_pos = (win_col - pad).expand(b, h, w)
    else:
        win_k = win_v = win_mask = win_pos = None
    return assemble_slots(kept_k, kept_v, sel.valid, kept_pos,
                          win_k, win_v, win_mask, win_pos, decode_slots)


def assemble_slots(
    kept_k, kept_v, kept_mask, kept_pos,
    win_k: Optional[torch.Tensor], win_v, win_mask, win_pos,
    decode_slots: int,
) -> CompactedKV:
    """Assemble ``[selected | window | decode]`` from gathered parts; every
    invalid slot holds zeros and position -1."""
    b, h, _, d = kept_k.shape
    parts_k, parts_v = [kept_k], [kept_v]
    parts_m, parts_p = [kept_mask], [kept_pos]
    if win_k is not None:
        parts_k.append(win_k)
        parts_v.append(win_v)
        parts_m.append(win_mask)
        parts_p.append(win_pos)
    if decode_slots > 0:
        z = kept_k.new_zeros((b, h, decode_slots, d))
        parts_k.append(z)
        parts_v.append(z)
        parts_m.append(kept_mask.new_zeros((b, h, decode_slots)))
        parts_p.append(kept_pos.new_zeros((b, h, decode_slots)))
    cmask = torch.cat(parts_m, dim=2)
    keep = cmask[..., None]
    ck = torch.cat(parts_k, dim=2).masked_fill(~keep, 0)
    cv = torch.cat(parts_v, dim=2).masked_fill(~keep, 0)
    cpos = torch.cat(parts_p, dim=2).masked_fill(~cmask, -1).to(torch.int32)
    return CompactedKV(k=ck, v=cv, mask=cmask, positions=cpos)
