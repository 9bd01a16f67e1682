"""Chunked prefill: the prompt forward split into fixed-size token chunks
(counterpart of ``pyramidkv_tpu/models/chunked_prefill.py``).

Two carries, as in the JAX package:

- **bf16** (:class:`ChunkState`): per-layer ``[L, B, KV, N, D]`` K/V buffers
  at the bucket length.  Chunk ``i`` writes its RoPE'd K/V at columns
  ``[i*C, (i+1)*C)`` and attends its C queries over the extent
  ``(i+1)*C`` through the flash kernel with ``q_start = i*C`` (it reads the
  carry in place).  Compression happens once, in :func:`prefill_finish`,
  from the window queries of the last chunk: the same math as the
  monolithic ``llama.prefill``.  H2O's statistic needs every query row's
  softmax over ALL columns, so its chunked prefill runs the chunks twice:
  the second pass recomputes each chunk's forward (the same values: the
  carry holds the same K/V) and adds its rows' exact column sums against
  the full K buffer (``ops.scoring.h2o_partial_scores``).
- **quantized** (:class:`QuantChunkState`, fullkv + KIVI): each chunk's K/V
  are quantized as they leave the chunk's forward, so the bf16 full-context
  cache never exists.  A chunk attends its own bf16 K/V (the causal self
  tile) and each earlier chunk dequantized one tile at a time, through
  ``flash_attention_partials`` merged in the base-2 domain
  (:func:`merge_exp2`); the plain path uses ``tile_attention_partials`` and
  the natural-log merge, as the JAX package's XLA path does; both with the
  model's scale and cap.  Each layer takes its own window (Gemma-2's
  sliding layers; its full layers none): under a window a history tile is
  passed at its true distance (``q_start = chunk_start - hc * C``), so the
  kernel's window test is exact, and a tile outside the window of every
  row is skipped; JAX runs the same function through its XLA tile masks.
  Packing is chunk-local planar; :func:`prefill_finish_quant` repacks it
  region-global.  With ``q_layout="pa"`` each chunk is one K scale group.

Methods outside :func:`supports_chunked` / :func:`supports_chunked_quant`
(minference, and fullkv + KIVI where the chunk does not fit its groups)
take the monolithic prefill (``engine.py``).  A prefix handle
(``engine.py::PrefixHandle``) resumes either carry: the bf16 one by a
scatter of the handle's rows (``Engine._apply_prefix``), the quantized one
through :func:`quant_state_from_prefix`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..cache import KVCache
from ..config import ModelSpec
from ..kernels import flash_attention_partials, flash_causal_attention
from ..ops import attention as plain
from ..ops.quant import (QuantizedKVRegion, QuantizedTensor, _pack, _round_up,
                         _unpack, dequantize, quantize)
from ..ops.scoring import h2o_partial_scores
from ..policy import PolicyPlan, compress_layer, layer_contexts
from . import llama

_NEG_INF = torch.finfo(torch.float32).min


class ChunkState(NamedTuple):
    """The growing full-KV buffers, ``[L, B, KV, N, D]`` in the activation
    dtype; columns [0, chunk_start) hold earlier chunks' RoPE'd K/V
    (padding columns included: validity comes from ``true_len``).  Updated
    in place."""

    k: torch.Tensor
    v: torch.Tensor


def supports_chunked(plan: PolicyPlan) -> bool:
    """True for the bf16 carry: the compressed methods, whose scoring reads
    only the window queries (H2O through its second pass; ThinK's channel
    scores read the last 32 query rows, so only with a window of 32 or
    more), and fullkv without KIVI (fullkv + KIVI takes the quantized
    carry).  MInference reads every query row."""
    spec = plan.spec
    if spec.method == "think":
        return plan.window >= 32
    if spec.method == "fullkv":
        return spec.quant_method is None
    return spec.method in ("snapkv", "pyramidkv", "adakv", "headkv",
                           "streamingllm", "l2norm", "random", "cam",
                           "h2o")


def needs_score_pass(plan: PolicyPlan) -> bool:
    """H2O appends a second (score-reconstruction) pass over the chunks."""
    return plan.spec.method == "h2o"


def init_h2o_scores(spec: ModelSpec, plan: PolicyPlan, batch: int,
                    device) -> torch.Tensor:
    """[L, B, H, N - W] f32 column-sum accumulator of the second pass."""
    return torch.zeros((spec.num_hidden_layers, batch,
                        spec.num_attention_heads,
                        plan.bucket_len - plan.window),
                       dtype=torch.float32, device=device)


def init_state(spec: ModelSpec, plan: PolicyPlan, batch: int, dtype,
               device) -> ChunkState:
    shape = (spec.num_hidden_layers, batch, spec.num_key_value_heads,
             plan.bucket_len, spec.head_dim)
    return ChunkState(k=torch.zeros(shape, dtype=dtype, device=device),
                      v=torch.zeros(shape, dtype=dtype, device=device))


def _chunk_inputs(params, spec, plan, tokens, true_len, chunk_start):
    """(embedded chunk, RoPE positions [B, C], inverse frequencies, pad)."""
    n = plan.bucket_len
    dev = tokens.device
    pad = (n - true_len).to(torch.int64)
    cols = chunk_start + torch.arange(tokens.shape[1], device=dev)
    positions = cols[None, :] - pad[:, None]
    hidden = llama.embed(params, tokens, spec)
    return hidden, positions, llama.rope_inv_freq(spec, dev), pad


def _finish_layer(hidden, attn, wts, spec, impl):
    """The rest of a layer after attention [B, H, C, D]
    (``llama.block_tail``)."""
    b, c = hidden.shape[:2]
    return llama.block_tail(hidden, attn.transpose(1, 2).reshape(b, c, -1),
                            wts, spec, impl)


def prefill_chunk(
    params: dict,
    spec: ModelSpec,
    plan: PolicyPlan,
    state: ChunkState,
    tokens: torch.Tensor,
    true_len: torch.Tensor,
    *,
    chunk_start: int,
    attention_impl: str = "kernel",
    score_acc: Optional[torch.Tensor] = None,
):
    """Forward one token chunk through all layers against the carry.

    tokens: [B, C], columns [chunk_start, chunk_start + C) of the
    left-padded bucket.  ``score_acc`` (H2O's second pass only): the
    [L, B, H, N - W] column-sum accumulator; the carry is then complete and
    each layer adds its rows' contributions against the full K buffer
    (in place).  Returns (window_q [L, B, H, W, D], the plan-window queries
    of this chunk; hidden_last [B, Dm], the chunk's last hidden row); the
    carry is updated in place."""
    b, c = tokens.shape
    n = plan.bucket_len
    w = plan.window
    extent = chunk_start + c
    assert extent <= n and w <= c, (chunk_start, c, n, w)
    hidden, positions, inv_freq, _ = _chunk_inputs(
        params, spec, plan, tokens, true_len, chunk_start)
    # the attention derives the key pad from its own key length (extent)
    eff_len = true_len.to(torch.int32) - (n - extent)
    akw = llama.attn_args(spec)
    window_q = []
    for li in range(spec.num_hidden_layers):
        wts = llama._layer(params, li)
        # the layer's window (H2O's second-pass scores take none, as JAX's)
        win = spec.layer_window(li)
        x = llama._norm(hidden, wts["attn_norm"], spec)
        q, k, v = llama._qkv(x, wts, spec, attention_impl)
        q = llama.apply_rope(q, positions, inv_freq)
        k = llama.apply_rope(k, positions, inv_freq)
        state.k[li, :, :, chunk_start:extent] = k
        state.v[li, :, :, chunk_start:extent] = v
        if score_acc is not None:
            score_acc[li] += h2o_partial_scores(
                q, state.k[li], row_start=chunk_start, window_size=w,
                true_len=true_len, **akw)
        kh = state.k[li, :, :, :extent]
        vh = state.v[li, :, :, :extent]
        if attention_impl == "kernel":
            attn = flash_causal_attention(q, kh, vh, eff_len,
                                          q_start=chunk_start,
                                          sliding_window=win, **akw)
        else:
            attn = plain.causal_prefill_attention(
                q, kh, vh, true_len=eff_len, q_start=chunk_start,
                sliding_window=win, **akw)
        hidden = _finish_layer(hidden, attn, wts, spec, attention_impl)
        window_q.append(q[:, :, c - w:])
    return torch.stack(window_q), hidden[:, -1, :]


def prefill_finish(
    params: dict,
    spec: ModelSpec,
    plan: PolicyPlan,
    state: ChunkState,
    window_q: torch.Tensor,
    hidden_last: torch.Tensor,
    true_len: torch.Tensor,
    *,
    attention_impl: str = "kernel",
    h2o_raw_scores: Optional[torch.Tensor] = None,
    rng: Optional[torch.Tensor] = None,
):
    """Compress the accumulated carry into the slot cache.  Each layer
    rebuilds a bucket-length query buffer that is zero except at the window
    (``compress_layer`` reads only those rows; H2O reads its second pass's
    ``h2o_raw_scores`` instead), so the compression is that of the
    monolithic prefill.  ``rng``: as ``llama.prefill``'s.  Returns (f32
    logits [B, vocab], KVCache)."""
    assert supports_chunked(plan), plan.spec.method
    assert plan.spec.method != "h2o" or h2o_raw_scores is not None
    n, w = plan.bucket_len, plan.window
    b, h, _, d = window_q.shape[1:]
    ctxs = layer_contexts(plan, true_len, h, rng)
    tl = true_len.to(torch.int32)
    regions, thinks, seg_stacks = [], [], []
    for start, stop, sub in plan.segment_plans():
        stack = None
        for li in range(start, stop):
            qfull = window_q.new_zeros((b, h, n, d))
            qfull[:, :, n - w:] = window_q[li]
            ckv = compress_layer(
                sub, ctxs.layer(li), qfull, state.k[li], state.v[li],
                true_len=tl,
                attention_impl=attention_impl,
                h2o_raw_scores=(None if h2o_raw_scores is None
                                else h2o_raw_scores[li]))
            stack = llama.stack_layer(stack, ckv, li - start, stop - start,
                                      sub, regions, thinks, qfull, tl)
        seg_stacks.append(stack)
    logits = llama._logits(hidden_last, params, spec, attention_impl)
    return logits, llama.assemble_cache(seg_stacks, tl, regions, thinks)


# ---------------------------------------------------------------------------
# Quantized chunk carry (fullkv + KIVI)
# ---------------------------------------------------------------------------


class QuantChunkState(NamedTuple):
    """Quantized full-KV carry, chunk-local planar packing (each chunk's
    bit-planes span that chunk's slots), updated in place."""

    k_codes: torch.Tensor  #: [L, B, KV, N/per, D] int8, slot-major
    k_scale: torch.Tensor  #: [L, B, KV, D, N/kg, 1] f32
    k_zero: torch.Tensor
    v_codes: torch.Tensor  #: [L, B, KV, N/per, Dp] int8
    v_scale: torch.Tensor  #: [L, B, KV, N, Dp/vg, 1] f32
    v_zero: torch.Tensor


def _quant_groups(cs, chunk: int, dp: int):
    """(K slot-group, V channel-group) sizes of the carry: ``pa`` makes each
    chunk one K group (the widest slot span whose values exist together
    during prefill) and keeps V per token."""
    if cs.q_layout == "pa":
        return chunk, dp
    return cs.q_group_size, cs.q_group_size


def supports_chunked_quant(plan: PolicyPlan, chunk: int) -> bool:
    """fullkv + KIVI whose chunk holds whole K groups on every bit-plane."""
    spec = plan.spec
    if spec.method != "fullkv" or spec.quant_method != "kivi":
        return False
    per = 8 // spec.nbits
    if spec.q_layout == "pa":
        # the planar repack and the per-plane group slicing of the pa
        # decode need whole groups per bit-plane
        ok = chunk % per == 0 and (plan.bucket_len // chunk) % per == 0
    else:
        ok = chunk % (spec.q_group_size * per) == 0
    return (ok and plan.prefill_slots == plan.bucket_len
            and plan.bucket_len % chunk == 0)


def init_quant_state(spec: ModelSpec, plan: PolicyPlan, batch: int,
                     chunk: int, device) -> QuantChunkState:
    cs = plan.spec
    per = 8 // cs.nbits
    L, kv, d = (spec.num_hidden_layers, spec.num_key_value_heads,
                spec.head_dim)
    n = plan.bucket_len
    dp = _round_up(d, cs.q_group_size)
    kg, vg = _quant_groups(cs, chunk, dp)
    i8 = dict(dtype=torch.int8, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return QuantChunkState(
        k_codes=torch.zeros((L, batch, kv, n // per, d), **i8),
        k_scale=torch.zeros((L, batch, kv, d, n // kg, 1), **f32),
        k_zero=torch.zeros((L, batch, kv, d, n // kg, 1), **f32),
        v_codes=torch.zeros((L, batch, kv, n // per, dp), **i8),
        v_scale=torch.zeros((L, batch, kv, n, dp // vg, 1), **f32),
        v_zero=torch.zeros((L, batch, kv, n, dp // vg, 1), **f32))


def merge_exp2(a, b):
    """Online-merge two base-2 partial triples (acc, m, l) (the
    ``flash_attention_partials`` convention); a source whose m <=
    float32.min / 2 (nothing visible) gets weight 0."""
    acc1, m1, l1 = a
    acc2, m2, l2 = b
    m = torch.maximum(m1, m2)
    w1 = torch.exp2((m1 - m).clamp_max(0.0)).masked_fill(m1 <= _NEG_INF / 2,
                                                         0.0)
    w2 = torch.exp2((m2 - m).clamp_max(0.0)).masked_fill(m2 <= _NEG_INF / 2,
                                                         0.0)
    return (acc1 * w1[..., None] + acc2 * w2[..., None], m, l1 * w1 + l2 * w2)


def _history_tile(state: QuantChunkState, li: int, hc: int, c: int,
                  nbits: int, kg: int, vg: int, dh: int, dtype):
    """Layer ``li``'s chunk ``hc`` of the carry, dequantized: K, V
    [B, KV, C, Dh] in ``dtype``."""
    per = 8 // nbits
    rows = slice(hc * (c // per), (hc + 1) * (c // per))
    kgs = slice(hc * (c // kg), (hc + 1) * (c // kg))
    kt = dequantize(QuantizedTensor(
        state.k_codes[li, :, :, rows].transpose(-1, -2),
        state.k_scale[li, :, :, :, kgs], state.k_zero[li, :, :, :, kgs]),
        nbits=nbits, group_size=kg)
    vs = slice(hc * c, (hc + 1) * c)
    vt = dequantize(QuantizedTensor(
        state.v_codes[li, :, :, rows], state.v_scale[li, :, :, vs],
        state.v_zero[li, :, :, vs]), nbits=nbits, group_size=vg, pack_axis=-2)
    return (kt.to(dtype).transpose(2, 3).contiguous(),
            vt[..., :dh].to(dtype).contiguous())


def _window_mask(rows: torch.Tensor, cols: torch.Tensor,
                 win: Optional[int]) -> torch.Tensor:
    """[R, C] visibility of key columns ``cols`` to query rows ``rows``
    (global columns): causal, and inside the sliding window when set."""
    vis = cols[None, :] <= rows[:, None]
    if win is not None:
        vis &= (rows[:, None] - cols[None, :]) < win
    return vis


def prefill_chunk_quant(
    params: dict,
    spec: ModelSpec,
    plan: PolicyPlan,
    state: QuantChunkState,
    tokens: torch.Tensor,
    true_len: torch.Tensor,
    chunk_start: int,
    *,
    attention_impl: str = "kernel",
) -> torch.Tensor:
    """One chunk forward against a quantized history: the self tile in
    bf16, each earlier chunk dequantized one tile at a time, merged online
    (under ``"kernel"`` through ``flash_attention_partials`` in base 2,
    under ``"plain"`` through ``tile_attention_partials`` in natural
    units), with the model's scale and cap and each layer's own window
    (JAX ``chunked_prefill.py:491-503``); then this chunk's K/V are
    quantized into the carry (in place).  Returns hidden_last [B, Dm]."""
    cs = plan.spec
    nbits = cs.nbits
    per = 8 // nbits
    b, c = tokens.shape
    dh = spec.head_dim
    dp = _round_up(dh, cs.q_group_size)
    kg, vg = _quant_groups(cs, c, dp)
    hidden, positions, inv_freq, pad = _chunk_inputs(
        params, spec, plan, tokens, true_len, chunk_start)
    dev = tokens.device
    cols = chunk_start + torch.arange(c, device=dev)
    colv = cols[None, :] >= pad[:, None]  # [B, C]
    kernel = attention_impl == "kernel"
    act = hidden.dtype
    akw = llama.attn_args(spec)
    for li in range(spec.num_hidden_layers):
        win = spec.layer_window(li)
        # the history chunks some row of this chunk sees in this layer:
        # chunk hc's last key lies inside the window of this chunk's first
        # row (JAX runs every tile under its mask; a tile outside every
        # row's window adds m = -inf, l = 0, so skipping it gives the same
        # result)
        hist = [hc for hc in range(chunk_start // c)
                if win is None or chunk_start - (hc * c + c - 1) < win]
        wts = llama._layer(params, li)
        x = llama._norm(hidden, wts["attn_norm"], spec)
        q, k, v = llama._qkv(x, wts, spec, attention_impl)
        q = llama.apply_rope(q, positions, inv_freq)
        k = llama.apply_rope(k, positions, inv_freq)
        v = v.contiguous()
        if kernel:
            tl_self = c - (pad - chunk_start).clamp(0, c)
            parts = flash_attention_partials(q, k, v, tl_self, q_start=0,
                                             sliding_window=win, **akw)
        else:
            self_mask = _window_mask(cols, cols, win)[None] & colv[:, None, :]
            parts = plain.tile_attention_partials(q, k, v, self_mask, **akw)
        for hc in hist:
            k_t, v_t = _history_tile(state, li, hc, c, nbits, kg, vg, dh, act)
            if kernel:
                # the tile at its true distance: its keys lie chunk_start -
                # hc*c rows before this chunk's queries
                tl_t = c - (pad - hc * c).clamp(0, c)
                parts = merge_exp2(parts, flash_attention_partials(
                    q, k_t, v_t, tl_t, q_start=chunk_start - hc * c,
                    sliding_window=win, **akw))
            else:
                hcols = hc * c + torch.arange(c, device=dev)
                hmask = (_window_mask(cols, hcols, win)[None]
                         & (hcols[None, None, :] >= pad[:, None, None]))
                parts = plain.merge_partials_pair(
                    parts, plain.tile_attention_partials(q, k_t, v_t, hmask,
                                                         **akw))
        acc, _, l = parts
        attn = (acc / l.clamp_min(1e-30)[..., None]).to(act)
        hidden = _finish_layer(hidden, attn, wts, spec, attention_impl)
        # quantize this chunk's K/V, padding columns zeroed first (as
        # compact_kv does before the monolithic quantization)
        keep = colv[:, None, :, None]
        kq = quantize(k.float().masked_fill(~keep, 0.0).transpose(2, 3),
                      nbits=nbits, group_size=kg)
        vq = quantize(torch.nn.functional.pad(
            v.float().masked_fill(~keep, 0.0), (0, dp - dh)),
            nbits=nbits, group_size=vg, pack_axis=-2)
        rows = slice(chunk_start // per, (chunk_start + c) // per)
        kgs = slice(chunk_start // kg, (chunk_start + c) // kg)
        vs = slice(chunk_start, chunk_start + c)
        state.k_codes[li, :, :, rows] = kq.codes.transpose(-1, -2)
        state.k_scale[li, :, :, :, kgs] = kq.scale
        state.k_zero[li, :, :, :, kgs] = kq.zero
        state.v_codes[li, :, :, rows] = vq.codes
        state.v_scale[li, :, :, vs] = vq.scale
        state.v_zero[li, :, :, vs] = vq.zero
    return hidden[:, -1, :]


def prefill_finish_quant(
    params: dict,
    spec: ModelSpec,
    plan: PolicyPlan,
    state: QuantChunkState,
    hidden_last: torch.Tensor,
    true_len: torch.Tensor,
    chunk: int,
    *,
    attention_impl: str = "kernel",
):
    """Repack the chunk-local codes region-global planar and assemble the
    fullkv KIVI cache (bf16 decode slots + the stacked region), the layout
    of the monolithic prefill's.  Returns (f32 logits [B, vocab], KVCache)."""
    cs = plan.spec
    nbits = cs.nbits
    per = 8 // nbits
    n = plan.bucket_len
    nc = n // chunk
    L = spec.num_hidden_layers
    b = hidden_last.shape[0]
    kvh, dh = spec.num_key_value_heads, spec.head_dim
    ds = plan.decode_slots
    dev = hidden_last.device

    def repack(codes):
        if per == 1:
            return codes
        out = torch.empty_like(codes)
        for li in range(L):  # one layer's int32 unpacked codes at a time
            c = codes[li].reshape(b, kvh, nc, chunk // per, -1)
            c = _unpack(c, nbits, axis=3).reshape(b, kvh, n, -1)
            out[li] = _pack(c, nbits, axis=-2)
        return out

    reg = QuantizedKVRegion(
        k=QuantizedTensor(repack(state.k_codes), state.k_scale, state.k_zero),
        v=QuantizedTensor(repack(state.v_codes), state.v_scale, state.v_zero))
    pad = (n - true_len).to(torch.int64)
    col = torch.arange(n, device=dev)
    colv = (col[None, None, :] >= pad[:, None, None]).expand(b, kvh, n)
    pos = torch.where(colv, col[None, None, :] - pad[:, None, None], -1)
    mask = torch.cat([colv, colv.new_zeros((b, kvh, ds))], dim=2)
    positions = torch.cat([pos, pos.new_zeros((b, kvh, ds))],
                          dim=2).to(torch.int32)
    zkv = torch.zeros((L, b, kvh, ds, dh), dtype=hidden_last.dtype,
                      device=dev)
    cache = KVCache(
        k=zkv, v=torch.zeros_like(zkv),
        mask=mask[None].expand(L, -1, -1, -1).contiguous(),
        positions=positions[None].expand(L, -1, -1, -1).contiguous(),
        true_len=true_len.to(torch.int32), quant=reg)
    return llama._logits(hidden_last, params, spec, attention_impl), cache


def quant_state_from_prefix(
    spec: ModelSpec,
    plan: PolicyPlan,
    hstate: QuantChunkState,
    p_full: int,
    pads,
    k0: int,
    chunk: int,
    handle_nbits: Optional[int] = None,
) -> QuantChunkState:
    """The quantized carry of a batch resumed from a quantized prefix handle
    (JAX ``models/chunked_prefill.py::quant_state_from_prefix``).

    ``hstate`` is the prefix's own chunk-local carry ([L, 1, ...] leaves,
    built unpadded, so its chunk grid starts at slot 0; on the carry's
    device).  Request chunk j < ``k0`` of a row with left pad p covers
    slots [j*C, (j+1)*C), whose content is the handle's span shifted by p:
    the (<= 2) overlapping handle chunks are dequantized at the handle's
    width (``handle_nbits``, or the plan's), windowed, the columns before
    the pad zeroed (as ``prefill_chunk_quant`` zeroes them) and requantized
    on the request's chunk grid at the plan's width.  With p % C == 0 the
    grids coincide and requantizing grid-snapped values returns their codes
    and zeros (the scales within an f32 rounding of the span).  The
    arithmetic is that of JAX's function as XLA compiles it (one rounding
    in each dequantization, the scale times the reciprocal of 2^nbits - 1),
    so the carry is JAX's bit for bit on the same handle.  One (layer, chunk
    pair) window is live at a time: no bf16 buffer of the full context is
    built.  ``pads``: one int per batch row.  Returns the carry for chunks
    [k0, N / C) to continue, zero past the covered chunks."""
    cs = plan.spec
    nbits = cs.nbits
    per = 8 // nbits
    h_nbits = handle_nbits or nbits
    h_per = 8 // h_nbits
    c = chunk
    dh = spec.head_dim
    dp = _round_up(dh, cs.q_group_size)
    kg, vg = _quant_groups(cs, c, dp)
    n_hc = p_full // c  # handle chunks
    dev = hstate.k_codes.device
    state = init_quant_state(spec, plan, len(pads), c, dev)
    cols = torch.arange(c, device=dev)

    def dequantize_fused(qt, group_size, pack_axis=-1):
        """``dequantize`` with one rounding (code * scale + zero exact in
        f64, rounded once to f32): the fused multiply-add that XLA makes of
        the JAX function, so the requantized carry is JAX's bit for bit."""
        codes = _unpack(qt.codes, h_nbits, axis=pack_axis)
        *lead, n = codes.shape
        g = codes.reshape(*lead, n // group_size, group_size).double()
        return (g * qt.scale.double() + qt.zero.double()).float().reshape(
            *lead, n)

    def dq(li, m):
        """Handle chunk m of layer li dequantized: K, V [KV, C, Dh] f32
        (zeros outside [0, n_hc))."""
        if not 0 <= m < n_hc:
            z = torch.zeros((spec.num_key_value_heads, c, dh),
                            dtype=torch.float32, device=dev)
            return z, z
        rows = slice(m * (c // h_per), (m + 1) * (c // h_per))
        kgs = slice(m * (c // kg), (m + 1) * (c // kg))
        kt = dequantize_fused(QuantizedTensor(
            hstate.k_codes[li, 0, :, rows].transpose(-1, -2),
            hstate.k_scale[li, 0, :, :, kgs], hstate.k_zero[li, 0, :, :, kgs]),
            kg)
        vs = slice(m * c, (m + 1) * c)
        vt = dequantize_fused(QuantizedTensor(
            hstate.v_codes[li, 0, :, rows], hstate.v_scale[li, 0, :, vs],
            hstate.v_zero[li, 0, :, vs]), vg, pack_axis=-2)
        return kt.transpose(-1, -2), vt[..., :dh]

    for bi, p in enumerate(int(x) for x in pads):
        for j in range(k0):
            a = j * c - p  # handle slot at the window's start
            m0 = a // c
            off = a - m0 * c
            keep = ((a + cols) >= 0)[None, :, None]  # slot >= pad
            rows = slice(j * (c // per), (j + 1) * (c // per))
            kgs = slice(j * (c // kg), (j + 1) * (c // kg))
            vs = slice(j * c, (j + 1) * c)
            for li in range(spec.num_hidden_layers):
                (ka, va), (kb, vb) = dq(li, m0), dq(li, m0 + 1)
                kwin = torch.cat([ka, kb], dim=-2)[:, off:off + c]
                vwin = torch.cat([va, vb], dim=-2)[:, off:off + c]
                kq = quantize(kwin.masked_fill(~keep, 0.0).transpose(-1, -2),
                              nbits=nbits, group_size=kg, compiled=True)
                vq = quantize(torch.nn.functional.pad(
                    vwin.masked_fill(~keep, 0.0), (0, dp - dh)),
                    nbits=nbits, group_size=vg, pack_axis=-2, compiled=True)
                state.k_codes[li, bi, :, rows] = kq.codes.transpose(-1, -2)
                state.k_scale[li, bi, :, :, kgs] = kq.scale
                state.k_zero[li, bi, :, :, kgs] = kq.zero
                state.v_codes[li, bi, :, rows] = vq.codes
                state.v_scale[li, bi, :, vs] = vq.scale
                state.v_zero[li, bi, :, vs] = vq.zero
    return state
