"""Per-layer KV-compression policy: scoring -> selection -> compaction
(counterpart of ``pyramidkv_tpu/policy.py``).

Every method of ``config.METHODS`` is ported, each with a bf16 cache or a
KIVI-quantized one (``quant_method="kivi"``, 8/4/2 bits, group or pa
layout):

- ``fullkv`` and ``minference`` keep everything (MInference sparsifies
  prefill attention only, ``models/llama.py``);
- ``snapkv`` / ``pyramidkv`` score keys by the observation window
  (uniform, or per-layer pyramid budgets, or a ``layer_capacity``
  schedule); ``h2o`` by the column sums of the full prefill softmax
  (``kernels/h2o_scores.py``);
- ``streamingllm`` keeps the first tokens (sinks) and a long window;
  ``l2norm`` the keys of lowest norm (``skip_layers`` keep everything: a
  segmented plan); ``random`` a uniform draw from ``prng`` (JAX's bits);
- ``adakv`` / ``headkv`` give each head its own budget (a per-head mask);
- ``cam`` merges the values of the tokens it will evict into later ones
  (``ops/merge.py::cam_banded_solve``), ``merge="pivot"`` folds evicted
  rows into their nearest kept row (``ops/merge.py::pivot_merge``);
- ``think`` prunes key channels of the older slots: narrow storage
  (``think_split``, ``cache.ThinKRegion``) or, with ``think_dense`` or a
  KIVI cache, zeroed channels (``_think_zero_channels``);
- ``gqa_aggregate`` averages each query group's scores and stores the
  ``num_kv_heads`` entries (refused for cam, think and headkv, as in JAX).

KVQuant's outlier sidecar and 1- and 3-bit KIVI raise
``NotImplementedError`` (ROADMAP queue 1 #6).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import prng
from .config import METHODS, CompressionSpec
from .kernels.h2o_scores import h2o_scores as h2o_kernel
from .ops.merge import cam_banded_solve, pivot_merge
from .ops.scoring import (_column_valid, _window_causal_bias, h2o_scores,
                          l2norm_scores, position_scores, random_scores,
                          window_scores)
from .ops.selection import (CompactedKV, adakv_allocate,
                            compact_kv, headkv_allocate, l2norm_keep_counts,
                            per_layer_keep_counts, pyramid_keep_counts,
                            selection_from_allocation, selection_window,
                            static_selection_width, topk_select,
                            uniform_keep_counts)
from .ops.think import gather_channels, think_channel_selection

PORTED_METHODS = METHODS


def _check_ported(spec: CompressionSpec) -> None:
    if spec.quant_method not in (None, "kivi") or (
            spec.quant_method is not None and spec.nbits not in (2, 4, 8)):
        raise NotImplementedError(
            "KVQuant's outlier sidecar and 1- or 3-bit KIVI are not ported "
            "yet (ROADMAP queue 1 #6)")


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
    #: the model's attention scale and logit cap (Gemma-2), which the
    #: scorers mirror so that selection follows the model's attention
    #: (JAX ``policy.py:59-60``); None: 1/sqrt(D), no cap
    attn_scale: Optional[float] = None
    attn_softcap: Optional[float] = None

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

    @property
    def think_narrow(self) -> bool:
        """ThinK stores the pruned-region keys at D_kept channels; the dense
        (zeroed, full-width) layout only on request or with KIVI."""
        cs = self.spec
        return (cs.method == "think" and not cs.think_dense
                and cs.quant_method is None)

    @property
    def think_pruned_slots(self) -> int:
        """Slots of the narrow (channel-pruned) key region."""
        recent_sel = max(self.spec.recent_size - self.window, 0)
        return max(self.width - recent_sel, 0)

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
    true_len <= bucket) for l2norm with ``skip_layers`` (whose skipped
    layers keep the whole bucket) and pyramidkv, else None (uniform)."""
    cap, w = spec.max_capacity_prompt, spec.window_size
    if spec.method == "l2norm" and spec.skip_layers:
        skip = set(spec.skip_layers)
        base = min(cap, bucket_len)
        return [bucket_len if l in skip else base for l in range(num_layers)]
    if spec.method != "pyramidkv":
        return None
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
    attn_scale: Optional[float] = None,
    attn_softcap: Optional[float] = None,
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
                      segments=segments, attn_scale=attn_scale,
                      attn_softcap=attn_softcap)


class LayerContext(NamedTuple):
    """Per-layer inputs of :func:`compress_layer` (stacked [L, ...] by
    :func:`layer_contexts`; index one layer with :meth:`layer`)."""

    #: [B] past-token keep count (the single-budget, pyramid and l2norm
    #: methods; unused by adakv/headkv/fullkv)
    keep_counts: torch.Tensor
    #: [H] per-head capacities (headkv), else zeros
    head_capacity: torch.Tensor
    #: [2] the layer's ``prng`` key (random eviction, CAM's draws)
    rng: torch.Tensor

    def layer(self, i: int) -> "LayerContext":
        return LayerContext(*(t[i] for t in self))


_UNIFORM = ("snapkv", "h2o", "cam", "streamingllm", "random", "think")


def layer_contexts(plan: PolicyPlan, true_len: torch.Tensor, num_heads: int,
                   rng: Optional[torch.Tensor] = None) -> LayerContext:
    """The stacked [L, ...] :class:`LayerContext`: keep counts, head
    capacities and per-layer keys ``prng.split(rng, L)`` (``rng`` defaults
    to ``prng.PRNGKey(0)``)."""
    spec = plan.spec
    num_layers = plan.num_layers
    dev = true_len.device
    w = plan.window if spec.method == "streamingllm" else spec.window_size
    if spec.layer_capacity is not None and spec.method in _UNIFORM:
        counts = per_layer_keep_counts(spec, num_layers, true_len, w)
    elif spec.method == "pyramidkv":
        counts = pyramid_keep_counts(spec, num_layers, true_len)
    elif spec.method == "l2norm":
        counts = l2norm_keep_counts(spec, num_layers, true_len)
    elif spec.method in _UNIFORM:
        counts = uniform_keep_counts(spec, true_len, w)[None].expand(
            num_layers, -1)
    else:  # fullkv, minference, adakv, headkv
        counts = true_len.to(torch.int32)[None].expand(num_layers, -1)
    if spec.method == "headkv":
        assert spec.head_capacity is not None
        head_caps = torch.tensor(spec.head_capacity, dtype=torch.int32,
                                 device=dev)
        assert head_caps.shape == (num_layers, num_heads), head_caps.shape
    else:
        head_caps = torch.zeros((num_layers, num_heads), dtype=torch.int32,
                                device=dev)
    if rng is None:
        rng = prng.PRNGKey(0, device=dev)
    return LayerContext(keep_counts=counts, head_capacity=head_caps,
                        rng=prng.split(rng.to(dev), num_layers))


def _cam_merge_values(
    v: torch.Tensor,
    win_probs: torch.Tensor,
    *,
    rng: torch.Tensor,
    start_budget: torch.Tensor,
    recent_budget: int,
    true_len: torch.Tensor,
) -> torch.Tensor:
    """CAM's stochastic value merging.  v: [B, H, N, D]; ``win_probs``:
    [B, H, W, N] the observation window's softmax.

    Source row s (an active column past the sinks and before the last r)
    is merged into the r rows after it, with coefficient 1/r, where its
    draw ``prng.uniform(rng, (B, H, N))[s]`` is below p[s] = colmean[s] /
    max(colmean over the sinks and [s, s + r)).  Later rows see merged
    rows, so the values solve a banded recurrence
    (:func:`ops.merge.cam_banded_solve`)."""
    b, h, w, n = win_probs.shape
    r = recent_budget
    dev = v.device
    colmean = win_probs.mean(dim=2)  # [B, H, N]
    pad = (n - true_len).to(torch.int64)
    col = torch.arange(n, device=dev)
    unif = prng.uniform(rng, (b, h, n))
    start_buf = pad + start_budget.to(torch.int64)  # where the sinks end
    sink = (col[None, :] >= pad[:, None]) & (col[None, :] < start_buf[:, None])
    sink_max = colmean.masked_fill(~sink[:, None, :], float("-inf")).amax(-1)
    cm_pad = torch.nn.functional.pad(colmean, (0, r), value=float("-inf"))
    win_max = cm_pad[:, :, :n]
    for i in range(1, r):
        win_max = torch.maximum(win_max, cm_pad[:, :, i:i + n])
    p = colmean / torch.maximum(sink_max[..., None], win_max)
    p = torch.nan_to_num(p, nan=0.0, posinf=1.0, neginf=0.0).clamp(0.0, 1.0)
    active = (col[None, :] >= start_buf[:, None]) & (col[None, :] < n - r)
    c = torch.where((unif < p) & active[:, None, :], 1.0 / r, 0.0)
    n_pad = ((n + r - 1) // r) * r
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, n_pad - n))
    cf = torch.nn.functional.pad(c, (0, n_pad - n))
    d = v.shape[-1]
    u, _ = cam_banded_solve(vf, cf, r, vf.new_zeros((b, h, r, d)),
                            cf.new_zeros((b, h, r)))
    return u[:, :, :n].to(v.dtype)


def _think_zero_channels(ckv: CompactedKV, q: torch.Tensor, plan: PolicyPlan,
                         true_len: torch.Tensor,
                         keep_counts: torch.Tensor) -> CompactedKV:
    """ThinK, dense layout: zero the dropped key channels of all but the
    last ``recent_size`` rows of the compressed cache (the window rows and
    the lowest-ranked ``recent_size - W`` selected ones).  Prompts shorter
    than the capacity stay unpruned (the reference's early exit)."""
    spec = plan.spec
    w, width = plan.window, plan.width
    prune = think_channel_selection(
        ckv.k[:, :, :width + w], q, ratio=spec.pruning_ratio,
        true_len=true_len, valid_mask=ckv.mask[:, :, :width + w])
    rank = torch.arange(width, device=q.device)[None, None, :]
    recent_sel = max(spec.recent_size - w, 0)
    is_recent = rank >= (keep_counts.to(torch.int64)[:, None, None]
                         - recent_sel)  # [B, 1, width]
    long_enough = true_len >= spec.max_capacity_prompt  # [B]
    pruned = ((~is_recent)[..., None]
              & ~prune.channel_mask[:, :, None, :]
              & long_enough[:, None, None, None])
    past = ckv.k[:, :, :width].masked_fill(pruned, 0.0)
    return ckv._replace(k=torch.cat([past, ckv.k[:, :, width:]], dim=2))


def stores_kv_heads(spec: CompressionSpec) -> bool:
    """True when the cache stores ``num_kv_heads`` entries (true GQA) rather
    than the reference's per-query-head post-``repeat_kv`` layout."""
    return spec.method in ("fullkv", "minference") or spec.gqa_aggregate


def compress_layer(
    plan: PolicyPlan,
    ctx: LayerContext,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    true_len: torch.Tensor,
    attention_impl: str = "kernel",
    h2o_raw_scores: Optional[torch.Tensor] = None,
) -> CompactedKV:
    """Compress one layer's prefill KV into the static slot layout.

    q: [B, H, N, D]; k, v: [B, Hk, N, D] post-RoPE, left-padded (scoring
    and compaction read them grouped; only CAM and pivot merging, which
    change values per query head, repeat them).  ``ctx``: this layer's
    :class:`LayerContext`.  ``attention_impl``: H2O's scores through the
    kernel wrapper (``"kernel"``) or the plain function (``"plain"``).
    ``h2o_raw_scores``: [B, H, N - W] column sums accumulated by the
    chunked prefill's second pass; they replace H2O's (q, k) scoring.
    A think plan's narrow split is :func:`think_split`, applied by the
    caller to the result.
    """
    spec = plan.spec
    m = spec.method
    b, h, n, d = q.shape
    hk = k.shape[1]
    groups = h // hk
    w = plan.window
    hs = hk if stores_kv_heads(spec) else h  # stored head count
    _check_ported(spec)

    if m in ("fullkv", "minference"):
        # the buffer IS the compacted layout: mask the padding, add slots
        # (minference sparsifies prefill attention only; decode runs dense
        # over the full cache)
        col = torch.arange(n, device=k.device)
        pad = (n - true_len).to(torch.int64)[:, None, None]
        colv = (col[None, None, :] >= pad).expand(b, hk, n)
        pos = torch.where(colv, col[None, None, :] - pad, -1)
        ds = plan.decode_slots
        keep = colv[..., None]
        zkv = k.new_zeros((b, hk, ds, d))
        return CompactedKV(
            k=torch.cat([k.masked_fill(~keep, 0), zkv], dim=2),
            v=torch.cat([v.masked_fill(~keep, 0), zkv], dim=2),
            mask=torch.cat([colv, colv.new_zeros((b, hk, ds))], dim=2),
            positions=torch.cat(
                [pos, pos.new_zeros((b, hk, ds))], dim=2).to(torch.int32),
        )

    if spec.gqa_aggregate:
        if m in ("cam", "think", "headkv"):
            raise NotImplementedError(f"gqa_aggregate unsupported for {m}")

        def group_mean(scores):
            return scores.reshape(b, hk, groups, -1).mean(dim=2)
    else:
        def group_mean(scores):
            return scores

    def rep(x):
        """Per-query-head copies (CAM and pivot merging only)."""
        return x.repeat_interleave(groups, dim=1) if groups > 1 else x

    def expand(scores):
        """[B, Hk, C] -> [B, hs, C]: one selection for the whole group."""
        return (scores if scores.shape[1] == hs
                else scores.repeat_interleave(hs // scores.shape[1], dim=1))

    def compact(sel, kc=k, vc=v, window=w):
        return compact_kv(kc, vc, sel, window_size=window,
                          decode_slots=plan.decode_slots, true_len=true_len)

    if m == "l2norm":
        scores = expand(l2norm_scores(k, true_len=true_len))
        return compact(topk_select(scores, plan.width, ctx.keep_counts),
                       window=0)
    if m == "streamingllm":
        scores = expand(position_scores(k, window_size=w, true_len=true_len))
        return compact(topk_select(scores, plan.width, ctx.keep_counts))
    if m == "random":
        # per stored head, as the reference's results-table row
        shape_ref = q if hs == h else k
        scores = random_scores(ctx.rng, shape_ref, window_size=w,
                               true_len=true_len)
        return compact(topk_select(scores, plan.width, ctx.keep_counts))
    akw = dict(scale=plan.attn_scale, softcap=plan.attn_softcap)
    if m == "h2o":
        if h2o_raw_scores is not None:
            past_valid = _column_valid(n, true_len)[:, None, :n - w]
            raw = h2o_raw_scores.masked_fill(~past_valid, float("-inf"))
        else:
            # a capped or custom-scale model's scores too: JAX sends those
            # to XLA (policy.py:539-546), the kernel computes that function
            score_fn = (h2o_kernel if attention_impl == "kernel"
                        else h2o_scores)
            raw = score_fn(q, k, window_size=w, true_len=true_len, **akw)
        sel = topk_select(group_mean(raw), plan.width, ctx.keep_counts)
        return compact(sel)
    if m in ("snapkv", "pyramidkv", "think"):
        scores = group_mean(window_scores(
            q, k, window_size=w, true_len=true_len,
            kernel_size=spec.kernel_size, pooling=spec.pooling, **akw))
        sel = topk_select(scores, plan.width, ctx.keep_counts)
        if spec.merge == "pivot":
            kr, vr = pivot_merge(rep(k), rep(v), sel, window_size=w,
                                 true_len=true_len)
            ckv = compact(sel, kr, vr)
        else:
            ckv = compact(sel)
        if m == "think" and not plan.think_narrow:
            ckv = _think_zero_channels(ckv, q, plan, true_len,
                                       ctx.keep_counts)
        return ckv
    if m == "cam":
        # selection by the unpooled window score; the merge reads the
        # window softmax itself
        qw = q[:, :, n - w:].float().reshape(b, hk, groups * w, d)
        logits = torch.matmul(qw, k.float().transpose(-1, -2)).reshape(
            b, h, w, n) * (plan.attn_scale if plan.attn_scale is not None
                           else 1.0 / math.sqrt(d))
        if plan.attn_softcap is not None:  # JAX policy.py:583-584
            logits = torch.tanh(logits / plan.attn_softcap) * plan.attn_softcap
        logits = logits + _window_causal_bias(w, n, q.device)[None, None]
        colv = _column_valid(n, true_len)
        probs = torch.softmax(
            logits.masked_fill(~colv[:, None, None, :], float("-inf")), -1)
        scores = probs[..., :n - w].sum(dim=2).masked_fill(
            ~colv[:, None, :n - w], float("-inf"))
        start_budget = torch.ceil(
            spec.start_budget_ratio * true_len.float()).to(torch.int32)
        vm = _cam_merge_values(rep(v), probs, rng=ctx.rng,
                               start_budget=start_budget, recent_budget=w,
                               true_len=true_len)
        sel = topk_select(scores, plan.width, ctx.keep_counts)
        return compact(sel, rep(k), vm)
    if m in ("adakv", "headkv"):
        scores = group_mean(window_scores(
            q, k, window_size=w, true_len=true_len,
            kernel_size=spec.kernel_size, pooling=spec.pooling,
            aggregation="mean", **akw))
        base = spec.max_capacity_prompt - spec.window_size
        if m == "adakv":
            alloc = adakv_allocate(
                scores, base_capacity=base, floor_ratio=spec.floor_ratio,
                normalize=spec.normalize, true_len=true_len, window_size=w,
                max_head_capacity=plan.width)
        else:
            alloc = headkv_allocate(
                scores, head_capacity=ctx.head_capacity, base_capacity=base,
                true_len=true_len, window_size=w,
                max_head_capacity=plan.width)
        return compact(selection_from_allocation(alloc, plan.width))
    raise ValueError(f"unknown method {m!r}")


def think_split(ckv: CompactedKV, q: torch.Tensor, plan: PolicyPlan,
                true_len: torch.Tensor):
    """Split a think-compacted layer into the narrow key region and the
    rest: ``(k_pruned [B, H, Sp, D_kept], kept_channels [B, H, D_kept]
    int32, k_rest [B, H, S - Sp, D])`` with ``Sp = plan.think_pruned_slots``.
    The channel selection is the dense layout's (the same scores), applied
    to every prompt (the short-prompt exit needs the dense layout)."""
    spec = plan.spec
    w, width = plan.window, plan.width
    sp = plan.think_pruned_slots
    prune = think_channel_selection(
        ckv.k[:, :, :width + w], q, ratio=spec.pruning_ratio,
        true_len=true_len, valid_mask=ckv.mask[:, :, :width + w])
    return (gather_channels(ckv.k[:, :, :sp], prune.kept_channels),
            prune.kept_channels.to(torch.int32), ckv.k[:, :, sp:])
