"""Budget schedules, top-k selection and cache compaction (counterpart of
``pyramidkv_tpu/ops/selection.py``).

Selection is a fixed-width top-k whose validity (how many selected slots are
real) is a per-element count mirroring the reference's dynamic branches
(``q_len < cap`` keeps all, PyramidKV's three regimes).
"""

from __future__ import annotations

import math
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


def per_layer_keep_counts(
    spec: CompressionSpec, num_layers: int, true_len: torch.Tensor,
    window_size: int,
) -> torch.Tensor:
    """[L, B] keep counts from an explicit per-layer capacity schedule
    (``spec.layer_capacity``): :func:`uniform_keep_counts` with each layer's
    own capacity."""
    caps = torch.tensor(spec.layer_capacity, dtype=torch.int64,
                        device=true_len.device)[:, None]  # [L, 1]
    assert caps.shape[0] == num_layers, (caps.shape, num_layers)
    tl = true_len.to(torch.int64)[None, :]
    avail = torch.clamp(tl - window_size, min=0)
    return torch.where(tl < caps, avail,
                       torch.minimum(caps - window_size, avail)).to(
                           torch.int32)


def l2norm_keep_counts(
    spec: CompressionSpec, num_layers: int, true_len: torch.Tensor
) -> torch.Tensor:
    """[L, B] TOTAL keep counts of L2Norm (no window; the budget is the
    whole ``max_capacity_prompt``); ``skip_layers`` keep every token."""
    cap = spec.max_capacity_prompt
    tl = true_len.to(torch.int32)[None, :]
    skip = torch.zeros((num_layers, 1), dtype=torch.bool,
                       device=true_len.device)
    for l in spec.skip_layers:
        if 0 <= l < num_layers:
            skip[l] = True
    return torch.where(skip | (tl < cap), tl, torch.clamp(tl, max=cap))


def static_selection_width(
    spec: CompressionSpec, num_layers: int, bucket_len: int
) -> int:
    """The static top-k width: an upper bound on any layer's (and head's)
    keep count."""
    cap, w = spec.max_capacity_prompt, spec.window_size
    m = spec.method
    if m in ("fullkv", "minference"):  # minference compresses nothing
        return bucket_len
    if m == "l2norm":
        # skip_layers keep everything: the whole buffer must fit
        return bucket_len if spec.skip_layers else min(cap, bucket_len)
    if m == "streamingllm":
        return min(4, bucket_len)  # the sinks: cap - (cap - 4)
    if m == "pyramidkv":
        capw = cap - w
        max0 = capw * 2 - capw // spec.beta
        return min(max0, max(bucket_len - w, 1))
    if m == "adakv":
        return min(int(math.ceil((cap - w) * spec.adakv_head_capacity_mult)),
                   max(bucket_len - w, 1))
    if m == "headkv":
        assert spec.head_capacity is not None, "headkv requires head_capacity"
        mx = max(max(row) for row in spec.head_capacity)
        # the no-compression exit keeps up to cap - w - 1 past tokens
        return min(max(mx, cap - w), max(bucket_len - w, 1))
    # snapkv / h2o / cam / think / random
    if spec.layer_capacity is not None:
        cap = max(spec.layer_capacity)
    return min(cap - w, max(bucket_len - w, 1))


def selection_window(spec: CompressionSpec) -> int:
    """The recency window kept verbatim after the selected past tokens."""
    if spec.method in ("fullkv", "l2norm"):  # l2norm keeps no window
        return 0
    if spec.method == "streamingllm":
        return spec.streaming_window()
    return spec.window_size


# ---------------------------------------------------------------------------
# AdaKV / HeadKV per-head allocation
# ---------------------------------------------------------------------------


class HeadAllocation(NamedTuple):
    #: [B, H] int32 — past tokens each head keeps.
    counts: torch.Tensor
    #: [B, H, C] int64 — each head's columns by descending score (ties:
    #: lower index first).
    order: torch.Tensor


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values as zero.  XLA on the CPU (as on the TPU)
    computes with subnormals flushed: its products round them to zero and
    its sorts compare them equal to zero (``lax.top_k`` alone compares the
    raw bits).  The budgets below mirror that: a trained model's window
    scores hold many exact zeros and subnormals, so their order decides
    where the global top-k cut falls."""
    return x.masked_fill(x.abs() < torch.finfo(torch.float32).tiny, 0.0)


def _descending_order(scores: torch.Tensor) -> torch.Tensor:
    """The order of ``jnp.argsort(-scores)``: a stable descending sort,
    subnormals equal to zero."""
    return torch.sort(_flush(scores), dim=-1, descending=True,
                      stable=True)[1]


def _clip_counts(counts, true_len, window_size, base_capacity,
                 max_head_capacity):
    """Bound per-head counts by the slot width and the available past
    tokens; the no-compression exit (base > available) keeps them all."""
    counts = torch.clamp(counts, max=max_head_capacity)
    avail = torch.clamp(true_len.to(torch.int32) - window_size,
                        min=0)[:, None]
    counts = torch.minimum(counts, avail)
    return torch.where(base_capacity > avail, avail, counts).to(torch.int32)


def adakv_allocate(
    scores: torch.Tensor,
    *,
    base_capacity: int,
    floor_ratio: float,
    normalize: bool,
    true_len: torch.Tensor,
    window_size: int,
    max_head_capacity: int,
) -> HeadAllocation:
    """AdaKV's head-adaptive budgets: a global top-(H * base) over every
    head's descending (optionally mass-normalised) scores decides each
    head's share; a floor guarantees ``floor_ratio * base`` a head.  A head
    is bounded at ``max_head_capacity`` before the shared top-k (ranks it
    could not hold go to the other heads).  scores: [B, H, C]."""
    b, h, c = scores.shape
    order = _descending_order(scores)
    sorted_scores = torch.gather(scores, -1, order)
    adjusted = sorted_scores
    rank = torch.arange(c, device=scores.device)
    if normalize:
        vals = _flush(torch.where(torch.isfinite(sorted_scores),
                                  sorted_scores, 0.0))
        top_mass = torch.where(rank < base_capacity, vals, 0.0).sum(
            -1, keepdim=True)
        total_mass = vals.sum(-1, keepdim=True)
        adjusted = _flush(sorted_scores
                          * (top_mass / total_mass.clamp_min(1e-20)))
    floor_cap = int(base_capacity * floor_ratio)
    # the pre-floor image of the slot bound
    max_pre = int((max_head_capacity - floor_cap)
                  / max(1.0 - floor_ratio, 1e-9))
    if max_pre < c:
        adjusted = adjusted.masked_fill(rank >= max_pre, float("-inf"))
    k = min(h * base_capacity, h * c)
    # lax.top_k order: descending, lower index first on ties
    flat_idx = torch.sort(adjusted.reshape(b, h * c), dim=-1,
                          descending=True, stable=True)[1][:, :k]
    head_of = torch.div(flat_idx, c, rounding_mode="floor")
    counts = torch.zeros((b, h), dtype=torch.float32, device=scores.device)
    counts.scatter_add_(1, head_of, torch.ones_like(head_of,
                                                    dtype=torch.float32))
    keep = torch.tensor(1.0 - floor_ratio, dtype=torch.float32)
    counts = torch.round(counts * keep + floor_cap).to(torch.int32)
    return HeadAllocation(
        counts=_clip_counts(counts, true_len, window_size, base_capacity,
                            max_head_capacity),
        order=order)


def headkv_allocate(
    scores: torch.Tensor,
    *,
    head_capacity: torch.Tensor,
    base_capacity: int,
    true_len: torch.Tensor,
    window_size: int,
    max_head_capacity: int,
) -> HeadAllocation:
    """HeadKV: static per-head budgets ``head_capacity`` [H] (from
    retrieval-head priors), each head's columns by descending score."""
    b, h, _ = scores.shape
    order = _descending_order(scores)
    counts = head_capacity.to(torch.int32)[None, :].expand(b, h)
    return HeadAllocation(
        counts=_clip_counts(counts, true_len, window_size, base_capacity,
                            max_head_capacity),
        order=order)


def selection_from_allocation(alloc: HeadAllocation,
                              width: int) -> "Selection":
    """An AdaKV/HeadKV allocation as a fixed-width Selection: each head's
    first ``width`` columns, its first ``counts`` of them real."""
    idx = alloc.order[..., :width]
    rank = torch.arange(idx.shape[-1], device=idx.device)[None, None, :]
    return Selection(indices=idx, valid=rank < alloc.counts[:, :, None])


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
    Subnormal scores count as zero (:func:`_flush`): the JAX package's
    scores reach ``lax.top_k`` through XLA arithmetic, which flushes them,
    and a trained model's peaked attention leaves runs of exact zeros and
    subnormals at the cut (the trained checkpoint's snapkv at cap 128 kept
    other slots before).  ``keep_counts`` is [B] (broadcast over heads) or
    [B, H].
    """
    c = scores.shape[-1]
    width = min(width, c)
    vals, idx = torch.sort(_flush(scores), dim=-1, descending=True,
                           stable=True)
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
