"""Per-layer KV-compression policy: scoring -> selection -> compaction
(counterpart of ``pyramidkv_tpu/policy.py``).

Ported methods: ``fullkv``, ``snapkv``, ``pyramidkv``, ``h2o`` and
``minference``, each with a bf16 cache or a KIVI-quantized one
(``quant_method="kivi"``, 8/4/2 bits, group or pa layout).  MInference
sparsifies prefill attention only (``models/llama.py``); its cache is
fullkv's.  H2O scores every key by the column sums of the full prefill
softmax (``kernels/h2o_scores.py``).  The others raise
``NotImplementedError`` (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .config import CompressionSpec
from .kernels.h2o_scores import h2o_scores as h2o_kernel
from .ops.scoring import _column_valid, h2o_scores, window_scores
from .ops.selection import (CompactedKV, compact_kv, pyramid_keep_counts,
                            selection_window, static_selection_width,
                            topk_select, uniform_keep_counts)

PORTED_METHODS = ("fullkv", "snapkv", "pyramidkv", "h2o", "minference")


def _check_ported(spec: CompressionSpec) -> None:
    if spec.method not in PORTED_METHODS:
        raise NotImplementedError(
            f"method {spec.method!r} is not ported yet (ROADMAP queue 1); "
            f"ported: {PORTED_METHODS}")
    if spec.quant_method not in (None, "kivi") or (
            spec.quant_method is not None and spec.nbits not in (2, 4, 8)):
        raise NotImplementedError(
            "KVQuant's outlier sidecar and 1- or 3-bit KIVI are not ported "
            "yet (ROADMAP queue 1 #6)")
    if spec.gqa_aggregate or spec.merge or spec.layer_capacity is not None:
        raise NotImplementedError(
            "gqa_aggregate, merging and per-layer capacities are not ported "
            "yet (ROADMAP queue 1)")


@dataclass(frozen=True)
class PolicyPlan:
    """Static layout decisions for one (spec, bucket) pair."""

    spec: CompressionSpec
    num_layers: int
    bucket_len: int
    decode_slots: int
    width: int   #: static top-k width (selected-past slots per layer/head)
    window: int  #: recency slots kept verbatim
    #: contiguous layer runs with their own slot widths:
    #: ((start, stop, width), ...); one entry is the uniform layout
    segments: "Tuple[Tuple[int, int, int], ...]" = ()

    def __post_init__(self):
        if not self.segments:
            object.__setattr__(
                self, "segments", ((0, self.num_layers, self.width),))

    @property
    def prefill_slots(self) -> int:
        return self.width + self.window

    @property
    def total_slots(self) -> int:
        return self.width + self.window + self.decode_slots

    def segment_plans(self):
        """Per-segment sub-plans: (start, stop, plan-with-that-width)."""
        return [
            (start, stop, dataclasses.replace(
                self, width=w, num_layers=stop - start,
                segments=((0, stop - start, w),)))
            for start, stop, w in self.segments
        ]


def _merge_segments(widths, max_segments=4):
    """Contiguous per-layer widths -> at most ``max_segments`` runs, each
    taking the max width inside it.  Greedy: repeatedly merge the adjacent
    pair of runs whose merge wastes the fewest layer-slots."""
    runs = []  # (start, stop, width)
    for i, w in enumerate(widths):
        if runs and runs[-1][2] == w:
            runs[-1] = (runs[-1][0], i + 1, w)
        else:
            runs.append((i, i + 1, w))
    while len(runs) > max_segments:
        best, cost = None, None
        for j in range(len(runs) - 1):
            a, b = runs[j], runs[j + 1]
            w = max(a[2], b[2])
            c = (w - a[2]) * (a[1] - a[0]) + (w - b[2]) * (b[1] - b[0])
            if cost is None or c < cost:
                best, cost = j, c
        a, b = runs[best], runs[best + 1]
        runs[best: best + 2] = [(a[0], b[1], max(a[2], b[2]))]
    return tuple(runs)


def _per_layer_width_bounds(spec, num_layers, bucket_len):
    """Per-layer static width bounds (max keep count over every
    true_len <= bucket) for pyramidkv, else None (uniform widths)."""
    if spec.method != "pyramidkv":
        return None
    cap, w = spec.max_capacity_prompt, spec.window_size
    capw = cap - w
    q = np.arange(1, bucket_len + 1)
    qlw = q - w
    min0 = capw // spec.beta
    max0 = capw * 2 - min0
    clamped = max0 >= qlw
    max_num = np.where(clamped, qlw, max0)
    min_num = np.where(clamped, capw * 2 - qlw, min0)
    steps = (max_num - min_num) // max(num_layers - 1, 1)
    layer = np.arange(num_layers)[:, None]
    b_l = max_num[None, :] - layer * steps[None, :]
    avail = np.maximum(qlw, 0)[None, :]
    n = np.where(
        (q < cap)[None, :], avail,
        np.where((q < 2 * capw)[None, :],
                 np.minimum(capw, avail), np.minimum(b_l, avail)),
    )
    return [int(x) for x in n.max(axis=1)]


def make_plan(
    spec: CompressionSpec,
    num_layers: int,
    bucket_len: int,
    decode_slots: int,
) -> PolicyPlan:
    _check_ported(spec)
    window = min(selection_window(spec), bucket_len)
    width = static_selection_width(spec, num_layers, bucket_len)
    if spec.method in ("fullkv", "minference"):
        window = 0
        width = bucket_len
    width = min(width, bucket_len)

    segments = ()
    # a quantized cache keeps one stacked region: uniform plans only
    bounds = (_per_layer_width_bounds(spec, num_layers, bucket_len)
              if spec.quant_method is None else None)
    if bounds is not None:
        # round slot widths up to 8, clamp at the uniform bound
        bounds = [min(((b + 7) // 8) * 8, width) for b in bounds]
        segs = _merge_segments(bounds)
        # segment only when it saves >= 1/8 of the uniform layout
        uniform = width * num_layers
        used = sum((stop - start) * w for start, stop, w in segs)
        if len(segs) > 1 and used <= uniform * 7 // 8:
            segments = segs
    return PolicyPlan(spec=spec, num_layers=num_layers, bucket_len=bucket_len,
                      decode_slots=decode_slots, width=width, window=window,
                      segments=segments)


def layer_contexts(plan: PolicyPlan, true_len: torch.Tensor) -> torch.Tensor:
    """[L, B] past-token keep count of every layer (the port's
    ``LayerContext`` is just its keep counts: the random/headkv fields belong
    to methods not ported yet)."""
    spec = plan.spec
    num_layers = plan.num_layers
    if spec.method == "pyramidkv":
        return pyramid_keep_counts(spec, num_layers, true_len)
    if spec.method in ("snapkv", "h2o"):
        return uniform_keep_counts(spec, true_len, spec.window_size)[
            None].expand(num_layers, -1)
    # fullkv and minference keep everything
    return true_len[None].expand(num_layers, -1)


def stores_kv_heads(spec: CompressionSpec) -> bool:
    """True when the cache stores ``num_kv_heads`` entries (true GQA) rather
    than the reference's per-query-head post-``repeat_kv`` layout."""
    return spec.method in ("fullkv", "minference") or spec.gqa_aggregate


def compress_layer(
    plan: PolicyPlan,
    keep_counts: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    true_len: torch.Tensor,
    attention_impl: str = "kernel",
    h2o_raw_scores: Optional[torch.Tensor] = None,
) -> CompactedKV:
    """Compress one layer's prefill KV into the static slot layout.

    q: [B, H, N, D]; k, v: [B, Hk, N, D] post-RoPE, left-padded.
    keep_counts: [B] this layer's past-token keep counts.
    ``attention_impl``: H2O's scores through the kernel wrapper
    (``"kernel"``) or the plain function (``"plain"``).
    ``h2o_raw_scores``: [B, H, N - W] column sums accumulated by the
    chunked prefill's second pass; they replace H2O's (q, k) scoring.
    """
    spec = plan.spec
    b, h, n, d = q.shape
    w = plan.window
    if spec.method in ("fullkv", "minference"):
        # the buffer IS the compacted layout: mask the padding, add slots
        # (minference sparsifies prefill attention only; decode runs dense
        # over the full cache)
        hs = k.shape[1]
        col = torch.arange(n, device=k.device)
        pad = (n - true_len).to(torch.int64)[:, None, None]
        colv = (col[None, None, :] >= pad).expand(b, hs, n)
        pos = torch.where(colv, col[None, None, :] - pad, -1)
        ds = plan.decode_slots
        keep = colv[..., None]
        zkv = k.new_zeros((b, hs, ds, d))
        return CompactedKV(
            k=torch.cat([k.masked_fill(~keep, 0), zkv], dim=2),
            v=torch.cat([v.masked_fill(~keep, 0), zkv], dim=2),
            mask=torch.cat([colv, colv.new_zeros((b, hs, ds))], dim=2),
            positions=torch.cat(
                [pos, pos.new_zeros((b, hs, ds))], dim=2).to(torch.int32),
        )
    _check_ported(spec)
    if spec.method == "h2o":
        if h2o_raw_scores is not None:
            past_valid = _column_valid(n, true_len)[:, None, :n - w]
            scores = h2o_raw_scores.masked_fill(~past_valid, float("-inf"))
        else:
            score_fn = (h2o_kernel if attention_impl == "kernel"
                        else h2o_scores)
            scores = score_fn(q, k, window_size=w, true_len=true_len)
    else:
        scores = window_scores(q, k, window_size=w, true_len=true_len,
                               kernel_size=spec.kernel_size,
                               pooling=spec.pooling)
    sel = topk_select(scores, plan.width, keep_counts)
    return compact_kv(k, v, sel, window_size=w,
                      decode_slots=plan.decode_slots, true_len=true_len)
