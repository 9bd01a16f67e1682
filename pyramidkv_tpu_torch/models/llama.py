"""Llama-family decoder in PyTorch (counterpart of
``pyramidkv_tpu/models/llama.py``): GQA + RoPE (with llama3 frequency
scaling) + RMSNorm + SwiGLU, dense, with the compression step at the end of
each layer's prefill.

Params use the JAX layout (``models/convert.py``); the layer loop is a
Python loop over views of the stacked weights.  Prompts are left-padded to
the plan's bucket; real tokens occupy the trailing ``true_len`` columns.

``attention_impl`` selects the attention explicitly, like the JAX
package's argument of the same name: ``"kernel"`` calls the kernel wrappers
(the CUDA kernels on CUDA tensors, their plain versions on CPU tensors),
``"plain"`` calls the plain PyTorch functions — for attention and for the
decode-sized weight matmuls of quantized params alike (``weights.mm``).
``attention_impl`` also picks H2O's scores (``policy.compress_layer``).
ThinK's narrow layout splits each compacted layer at the end of prefill
(``policy.think_split``: the pruned-region keys at ``D_kept`` channels in
``cache.ThinKRegion``) and decodes through the plain
``ops.attention.decode_attention_think`` (the JAX package runs it in XLA;
no Pallas kernel computes it); every other decode takes the decode kernel.
With ``method="minference"`` and a bucket of at least
``minference_dense_below`` tokens, each layer's prefill attention is the
vertical-and-slash sparse attention of ``ops/sparse_prefill.py`` (its three
block-sparse kernels) instead of the dense flash kernel.
Qwen2's QKV biases (``attention_bias``: ``bq`` / ``bk`` / ``bv`` leaves)
are added to the projections in ``_qkv``, which every path runs.
A ``sliding_window`` masks the dense prefill attention of every layer
(Mistral) or of the sliding layers of ``layer_types`` (Gemma-2:
``spec.layer_window``); decode masks it only for fullkv and minference,
whose slots are positions (JAX ``llama.py:932-951``), and the sparse
prefill ignores a uniform one, as JAX's does.  Gemma-2's other features
follow JAX's ``llama.py``: (1 + w) RMSNorms in f32, embeddings times
sqrt(hidden) rounded to the activation dtype, post-attention and post-MLP
norms, GeGLU (``gelu_tanh``), the attention scale
``query_pre_attn_scalar^-0.5`` and logit cap (``attn_args``, passed to the
flash, decode, H2O, block-sparse and KIVI region kernels, ThinK's decode,
the plain paths and the scorers), and the final logit cap.
Quantized params (``models/weights.py``) keep the JAX tree's names, plus the
fused ``wqkv`` / ``w_gateup`` leaves of ``fuse_packed_matmuls``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..cache import KVCache, LayerCacheView, ThinKRegion
from ..config import ModelSpec
from ..kernels import (decode_attention, flash_causal_attention,
                       quant_decode_attention, quant_decode_attention_tiled,
                       quant_fused_attention_group, quant_fused_attention_pa)
from ..kernels.quant_decode import split_plan
from ..ops import attention as plain
from ..ops import quant
from ..ops import sparse_prefill as sp
from ..policy import (PolicyPlan, compress_layer, layer_contexts,
                      stores_kv_heads, think_split)
from .weights import QuantW, dq_codes, embed_lookup, kernel_mm, mm

IMPLS = ("kernel", "plain")


def check_ported(spec: ModelSpec) -> None:
    """Raise for the model features the port does not run yet.  Mistral's
    uniform sliding window, Qwen2's QKV biases and Gemma-2's features
    (per-layer ``layer_types``, softcaps, (1 + w) and post-block norms,
    scaled embeddings, GeGLU, ``query_pre_attn_scalar``) are ported;
    Mixtral's MoE is not."""
    if spec.hidden_act not in ("silu", "gelu_tanh"):
        raise ValueError(f"{spec.name}: unknown hidden_act "
                         f"{spec.hidden_act!r}")
    if spec.num_local_experts:
        raise NotImplementedError(
            f"{spec.name}: Mixtral's MoE MLP is not ported yet (ROADMAP "
            "queue 1 #5d)")


def attn_args(spec: ModelSpec) -> dict:
    """The attention's ``scale`` and ``softcap`` (JAX ``llama.py:504-507``):
    ``query_pre_attn_scalar^-0.5`` where set (else None: 1/sqrt(D)) and the
    logit cap (None without one)."""
    return dict(scale=(spec.attn_scale
                       if spec.query_pre_attn_scalar is not None else None),
                softcap=spec.attn_logit_softcapping)


# ---------------------------------------------------------------------------
# RoPE / norms
# ---------------------------------------------------------------------------


def rope_inv_freq(spec: ModelSpec, device=None) -> torch.Tensor:
    """Inverse frequencies, including Llama-3.1 'llama3' scaling."""
    d = spec.head_dim
    inv = 1.0 / (spec.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    if spec.rope_scaling_type == "llama3":
        factor = spec.rope_scaling_factor
        low, high = spec.rope_low_freq_factor, spec.rope_high_freq_factor
        orig = spec.rope_original_max_position
        low_wl, high_wl = orig / low, orig / high
        wl = 2 * math.pi / inv
        smooth = (orig / wl - low) / (high - low)
        smoothed = (1 - smooth) * inv / factor + smooth * inv
        inv = torch.where(wl < high_wl, inv,
                          torch.where(wl > low_wl, inv / factor, smoothed))
    elif spec.rope_scaling_type == "linear":
        inv = inv / spec.rope_scaling_factor
    return inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """HF rotate-half RoPE.  x: [B, H, T, D]; positions: [B, T] (negative
    positions — padding rows — clamp to 0)."""
    pos = positions.clamp(min=0).float()
    ang = pos[:, :, None] * inv_freq[None, None, :]  # [B, T, D/2]
    cos = torch.cos(ang)[:, None]
    sin = torch.sin(ang)[:, None]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    """Llama RMSNorm: normalise in f32, cast back, THEN scale by w.  With
    ``unit_offset`` (Gemma2RMSNorm) multiply by (1 + w) in f32, then cast."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    if unit_offset:
        return (normed * (1.0 + w.float())).to(x.dtype)
    return normed.to(x.dtype) * w


def _norm(x: torch.Tensor, w: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """The spec's RMSNorm (Gemma-2's (1 + w) form where it says so)."""
    return rms_norm(x, w, spec.rms_norm_eps, spec.rmsnorm_unit_offset)


def embed(params: dict, tokens: torch.Tensor, spec: ModelSpec
          ) -> torch.Tensor:
    """The tokens' embedding rows in the activation dtype; Gemma-2 scales
    them by sqrt(hidden) rounded to that dtype (JAX ``llama.py:499-503``)."""
    dtype = params["final_norm"].dtype
    hidden = embed_lookup(params["embed"], tokens.long(), dtype)
    if spec.scale_embeddings:
        hidden = hidden * torch.tensor(math.sqrt(spec.hidden_size),
                                       dtype=dtype, device=hidden.device)
    return hidden


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, KV, T, D] -> [B, KV*groups, T, D] (HF repeat_kv order)."""
    return x if groups == 1 else x.repeat_interleave(groups, dim=1)


# ---------------------------------------------------------------------------
# Projections shared by prefill and decode
# ---------------------------------------------------------------------------


def _qkv(x: torch.Tensor, wts: dict, spec: ModelSpec, impl: str
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, Dm] -> q [B, H, T, Dh], k/v [B, KV, T, Dh].  A fused
    ``wqkv`` leaf computes all three in one matmul and is split; ``bq`` /
    ``bk`` / ``bv`` leaves (Qwen2) are added to the three."""
    b, t, _ = x.shape
    H, KV, Dh = spec.num_attention_heads, spec.num_key_value_heads, spec.head_dim
    if "wqkv" in wts:
        q, k, v = torch.split(mm(x, wts["wqkv"], impl),
                              [H * Dh, KV * Dh, KV * Dh], dim=-1)
    else:
        q, k, v = (mm(x, wts[n], impl) for n in ("wq", "wk", "wv"))
    if "bq" in wts:
        # Qwen2's QKV biases, added after the split (the fused wqkv path
        # composes) in the activation's dtype, as JAX's _qkv
        q = q + wts["bq"].to(q.dtype)
        k = k + wts["bk"].to(k.dtype)
        v = v + wts["bv"].to(v.dtype)
    q = q.reshape(b, t, H, Dh).transpose(1, 2)
    k = k.reshape(b, t, KV, Dh).transpose(1, 2)
    v = v.reshape(b, t, KV, Dh).transpose(1, 2)
    return q, k, v


def _mlp(x: torch.Tensor, wts: dict, impl: str,
         hidden_act: str = "silu") -> torch.Tensor:
    """SwiGLU, or GeGLU with ``gelu_tanh`` (Gemma-2's gelu_pytorch_tanh);
    the activation runs in f32 and is cast before the product."""
    if "w_gateup" in wts:
        g, u = mm(x, wts["w_gateup"], impl).chunk(2, dim=-1)
    else:
        g, u = mm(x, wts["w_gate"], impl), mm(x, wts["w_up"], impl)
    act = (F.gelu(g.float(), approximate="tanh") if hidden_act == "gelu_tanh"
           else F.silu(g.float()))
    return mm(act.to(x.dtype) * u, wts["w_down"], impl)


def block_tail(hidden: torch.Tensor, attn: torch.Tensor, wts: dict,
               spec: ModelSpec, impl: str) -> torch.Tensor:
    """The rest of a layer after its attention ``attn`` [..., H * Dh]: the
    output projection, Gemma-2's post-attention norm, the residual, the
    MLP (its post-MLP norm) and the residual."""
    ao = mm(attn, wts["wo"], impl)
    if spec.post_block_norms:
        ao = _norm(ao, wts["attn_post_norm"], spec)
    hidden = hidden + ao
    mo = _mlp(_norm(hidden, wts["mlp_norm"], spec), wts, impl,
              spec.hidden_act)
    if spec.post_block_norms:
        mo = _norm(mo, wts["mlp_post_norm"], spec)
    return hidden + mo


def _logits(hidden: torch.Tensor, params: dict, spec: ModelSpec,
            impl: str = "kernel") -> torch.Tensor:
    """f32 logits, sliced back to the true vocab when the lm_head was padded
    (``quantize_weights(lm_head_pad_to=...)``; pad channels are all-zero),
    capped at ``final_logit_softcapping`` (Gemma-2) where set."""
    out = _logits_wide(hidden, params, spec, impl)
    if out.shape[-1] != spec.vocab_size:
        out = out[..., :spec.vocab_size]
    cap = spec.final_logit_softcapping
    return out if cap is None else torch.tanh(out * (1.0 / cap)) * cap


def _mm_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [..., K] @ w [K, N] with f32 output, as JAX's ``dot_general(...,
    preferred_element_type=f32)``: on the card a bf16 matmul with f32
    accumulation written in f32 (``torch.mm(..., out_dtype=torch.float32)``;
    no f32 copy of w is made); f32 inputs as they are; other dtypes on the
    CPU through f32 copies (exact products, f32 sums)."""
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    h2 = h.reshape(-1, h.shape[-1])
    if h.device.type == "cuda":
        out = torch.mm(h2, w, out_dtype=torch.float32)
    else:
        out = h2.float() @ w.float()
    return out.reshape(*h.shape[:-1], w.shape[-1])


def _logits_wide(hidden: torch.Tensor, params: dict, spec: ModelSpec,
                 impl: str) -> torch.Tensor:
    """f32 logits of the final-normed hidden state.

    Quantized lm_heads follow JAX's ``_logits_wide``: an int4 lm_head
    (<= 384 rows) and an int8 one (<= 8 rows) go through their streaming
    kernels with f32 h, so the logits are f32 products; other rows, and a
    tied int8 embedding (codes [V, Dm], contracted on their last axis),
    dequantize.  Products outside the kernels are f32 products of h's
    dtype (:func:`_mm_f32`): with f32 weights (the CPU tests) JAX's f32
    product; with bf16 on the card a bf16 matmul with f32 accumulation and
    f32 output, as JAX's ``preferred_element_type`` gives (rounding the
    output to bf16 first flipped 46 of 512 greedy tokens of the trained
    checkpoint against an f32 head, PERF.md §6) — no f32 copy of the
    128256 x 4096 lm_head is ever made."""
    h = _norm(hidden, params["final_norm"], spec)
    tied = spec.tie_word_embeddings
    w = params["embed"] if tied else params["lm_head"]
    if isinstance(w, QuantW):
        if not tied:
            y = kernel_mm(h.float(), w, impl)
            if y is not None:
                return y
        codes = w.codes.T.to(h.dtype) if tied else dq_codes(w, h.dtype)
        return _mm_f32(h, codes) * w.scale.float()
    return _mm_f32(h, w.T if tied else w)


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s weights: views of the stacks (quantized leaves slice
    codes and scale alike)."""
    return {name: (QuantW(w.codes[i], w.scale[i]) if isinstance(w, QuantW)
                   else w[i])
            for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(
    params: dict,
    spec: ModelSpec,
    plan: PolicyPlan,
    tokens: torch.Tensor,
    true_len: torch.Tensor,
    *,
    attention_impl: str = "kernel",
    prefill_two_pass: bool = False,
    rng: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt through the model, compressing each layer's KV.

    tokens: [B, N] left-padded token ids (N == plan.bucket_len);
    true_len: [B] real-token counts.  ``prefill_two_pass``: the dense flash
    attention runs the two-pass schedule (JAX ``llama.py:473/553``; the
    plain path and MInference's sparse attention ignore it, as in JAX).
    ``rng``: the ``prng`` key whose per-layer split drives random eviction
    and CAM (None: ``prng.PRNGKey(0)``).  Returns (f32 logits [B, vocab] of
    the last position, the compressed KVCache).
    """
    check_ported(spec)
    if attention_impl not in IMPLS:
        raise ValueError(f"attention_impl must be one of {IMPLS}")
    b, n = tokens.shape
    assert n == plan.bucket_len, (n, plan.bucket_len)
    dev = tokens.device
    true_len = true_len.to(device=dev, dtype=torch.int32)
    inv_freq = rope_inv_freq(spec, dev)
    pad = (n - true_len).to(torch.int64)
    positions = torch.arange(n, device=dev)[None, :] - pad[:, None]  # [B, N]
    ctxs = layer_contexts(plan, true_len, spec.num_attention_heads, rng)
    akw = attn_args(spec)

    hidden = embed(params, tokens, spec)  # [B, N, Dm]
    cs = plan.spec
    # MInference's vertical-and-slash attention ignores a uniform window,
    # as JAX's does (its pattern has no window semantics); below
    # minference_dense_below the dense attention takes the window, and so
    # do the sliding layers of alternating ones (JAX llama.py:606-618)
    sparse = cs.method == "minference" and n >= cs.minference_dense_below
    budgets = _minference_budgets(cs, dev) if sparse else None
    regions = []  # KIVI: each layer's quantized prefill region
    thinks = []   # ThinK narrow: each layer's (k_pruned, kept_channels)
    seg_stacks = []
    for start, stop, sub in plan.segment_plans():
        stack = None  # [L_seg, ...] buffers of this segment's layers
        for li in range(start, stop):
            wts = _layer(params, li)
            win = spec.layer_window(li)
            x = _norm(hidden, wts["attn_norm"], spec)
            q, k, v = _qkv(x, wts, spec, attention_impl)
            q = apply_rope(q, positions, inv_freq)
            k = apply_rope(k, positions, inv_freq)
            v = v.contiguous()
            if sparse and not (spec.mixed_sliding and win is not None):
                attn = _sparse_attention(q, k, v, true_len, cs, budgets, li,
                                         attention_impl, akw)
            elif attention_impl == "kernel":
                attn = flash_causal_attention(q, k, v, true_len,
                                              sliding_window=win,
                                              two_pass=prefill_two_pass,
                                              **akw)
            else:
                attn = plain.causal_prefill_attention(
                    q, k, v, true_len=true_len, sliding_window=win, **akw)
            hidden = block_tail(hidden, attn.transpose(1, 2).reshape(
                b, n, -1), wts, spec, attention_impl)
            ckv = compress_layer(sub, ctxs.layer(li), q, k, v,
                                 true_len=true_len,
                                 attention_impl=attention_impl)
            stack = stack_layer(stack, ckv, li - start, stop - start, sub,
                                regions, thinks, q, true_len)
        seg_stacks.append(stack)
    logits = _logits(hidden[:, -1, :], params, spec, attention_impl)
    return logits, assemble_cache(seg_stacks, true_len, regions, thinks)


def _minference_budgets(cs, device):
    """The pattern budgets of a minference prefill: (None, None, None) for
    the uniform ``minference_vertical_size`` / ``minference_slash_size``, or
    ``minference_pattern_config`` as an [L, H, 2] tensor with the
    config-wide (max vertical, max slash) that set the static top-k
    widths."""
    pcfg = cs.minference_pattern_config
    if pcfg is None:
        return None, None, None
    return (torch.tensor(pcfg, dtype=torch.int32, device=device),
            max(v for layer in pcfg for v, _ in layer),
            max(s for layer in pcfg for _, s in layer))


def _sparse_attention(q, k, v, true_len, cs, budgets, li: int,
                      impl: str, akw: dict) -> torch.Tensor:
    """Layer ``li``'s MInference prefill attention: estimate the
    vertical-and-slash pattern from the post-RoPE q/k, then attend over it
    (the block-sparse kernels under ``impl="kernel"``, their plain versions
    under ``"plain"``), both with the model's scale and cap ``akw``
    (:func:`attn_args`; JAX ``llama.py:585-597``)."""
    cfg, mv, ms = budgets
    if cfg is None:
        vsz, ssz = cs.minference_vertical_size, cs.minference_slash_size
    else:
        vsz, ssz = cfg[li, :, 0], cfg[li, :, 1]
    pattern = sp.estimate_vertical_slash(
        q, k, true_len=true_len, vertical_size=vsz, slash_size=ssz,
        last_q=cs.minference_last_q, max_vertical=mv, max_slash=ms, **akw)
    return sp.sparse_prefill_attention(
        q, k, v, pattern, true_len=true_len,
        tile_budget=cs.minference_tile_budget,
        slash_impl=cs.minference_slash_impl, impl=impl, **akw)


def stack_layer(stack, ckv, i: int, layers: int, plan: PolicyPlan,
                regions: list, thinks: list, q: torch.Tensor,
                true_len: torch.Tensor):
    """Write one layer's compacted KV into slot ``i`` of its segment's
    ``[layers, ...]`` stack (allocated at the first layer).  With a KIVI
    plan the (immutable) compacted prefill slots are quantized now, so one
    layer's bf16 region is live at a time: the region goes to ``regions``
    and the stack keeps only the bf16 decode slots.  With ThinK's narrow
    layout the pruned-region keys (channel-gathered with the layer's
    queries ``q``) go to ``thinks`` and the stack's K keeps the rest."""
    cs = plan.spec
    if plan.think_narrow:
        kp, kc, k_rest = think_split(ckv, q, plan, true_len)
        thinks.append((kp, kc))
        ckv = ckv._replace(k=k_rest)
    if cs.quant_method is not None:
        sp = plan.prefill_slots
        regions.append(quant.quantize_kv_region(
            ckv.k[:, :, :sp], ckv.v[:, :, :sp], nbits=cs.nbits,
            group_size=cs.q_group_size, layout=cs.q_layout))
        ckv = ckv._replace(k=ckv.k[:, :, sp:], v=ckv.v[:, :, sp:])
    if stack is None:
        stack = [t.new_empty((layers, *t.shape)) for t in ckv]
    for buf, t in zip(stack, ckv):
        buf[i] = t
    return stack


def assemble_cache(seg_stacks: list, true_len: torch.Tensor,
                   regions: list = (), thinks: list = ()) -> KVCache:
    """KVCache from per-segment ``[k, v, mask, positions]`` layer stacks
    (and, for KIVI, the per-layer regions, stacked; for ThinK's narrow
    layout the per-layer pruned keys; quantized and ThinK plans are
    uniform)."""
    if len(seg_stacks) == 1:
        k, v, m, p = seg_stacks[0]
        think = (ThinKRegion(*(torch.stack(t) for t in zip(*thinks)))
                 if thinks else None)
        return KVCache(k=k, v=v, mask=m, positions=p, true_len=true_len,
                       quant=quant.stack_regions(regions) if regions
                       else None, think=think)
    k, v, m, p = (tuple(s[j] for s in seg_stacks) for j in range(4))
    return KVCache(k=k, v=v, mask=m, positions=p, true_len=true_len)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


#: JAX ``llama.py:766``: regions of more padded slots than this take the
#: long-region branch, the only one where the JAX engine runs its tiled
#: kernel (and with it ``mm_bf16``); lowered by tests, as JAX's
QUANT_CHUNK_THRESHOLD = [4096]
#: JAX ``kernels/quant_decode.py:48``: the whole-region kernel's largest
#: region, in padded slots
MAX_KERNEL_SLOTS = 8192
#: test hook, JAX's ``_FORCE_QUANT_KERNEL`` for the tiled route: every
#: long region counts as tile-aligned (JAX's interpret-mode tests take the
#: tile gcd(S_pad, tile), ``llama.py:1082-1084``)
FORCE_TILE_ALIGNED = [False]


def region_mm_bf16(es, spec: ModelSpec, cs, s_pad: int) -> bool:
    """Whether the JAX engine decodes a group region of ``s_pad`` padded
    slots through its tiled kernel with ``mm_bf16`` (``llama.py:952-1102``):
    ``PKV_QUANT_MM_BF16=1`` on the ``use_quant_tiled`` route of the kernels
    (``use_pallas``; the factored default not forced by
    ``use_quant_fused``), where the whole-region
    kernel does not take the region (``use_quant_kernel`` over at most
    MAX_KERNEL_SLOTS slots without a custom scale or cap), the region is
    longer than QUANT_CHUNK_THRESHOLD and the tile (128 K groups a plane)
    divides it.  Elsewhere the JAX engine runs f32 partials, as the port's
    f32 route does."""
    if (os.environ.get("PKV_QUANT_MM_BF16", "0") != "1"
            or not (es.use_pallas and es.use_quant_tiled)
            or es.use_quant_fused
            or cs.quant_method != "kivi" or cs.q_layout != "group"):
        return False
    akw = attn_args(spec)
    whole = (es.use_quant_kernel and s_pad <= MAX_KERNEL_SLOTS
             and akw["scale"] is None and akw["softcap"] is None)
    tile = 128 * cs.q_group_size * (8 // cs.nbits)
    return (not whole and s_pad > QUANT_CHUNK_THRESHOLD[0]
            and (s_pad % tile == 0 or FORCE_TILE_ALIGNED[0]))


def region_route(cs, bhk: int, w: int, device: torch.device,
                 f32_quant: bool = False, d: int = 128):
    """The region kernel a KIVI layer of ``bhk`` regions of ``w`` byte-rows
    at head dim ``d`` decodes through on ``device``: pa regions through
    ``quant_fused_attention_pa``; group regions through
    ``quant_fused_attention_group`` (JAX's default: the factored
    dequantization with bf16 folds), or with ``f32_quant`` (JAX's opt-in
    ``use_quant_kernel`` / ``use_quant_tiled``) through the f32 kernels:
    ``quant_decode_attention`` where the split plan (for the spec's nbits
    and K group size) gives one split, else
    ``quant_decode_attention_tiled`` (either in its ``mm_bf16`` mode where
    :func:`region_mm_bf16` says)."""
    if cs.q_layout == "pa":
        return quant_fused_attention_pa
    if not f32_quant:
        return quant_fused_attention_group
    one = split_plan(device, bhk, w, cs.nbits, cs.q_group_size, d)[0] == 1
    return quant_decode_attention if one else quant_decode_attention_tiled


def _region_attention(q: torch.Tensor, reg, layer: LayerCacheView,
                      visible: torch.Tensor, plan: PolicyPlan, impl: str,
                      akw: dict, f32_quant: bool = False,
                      mm_bf16: bool = False) -> torch.Tensor:
    """One KIVI layer's decode attention over the quantized prefill region
    and the bf16 decode slots (the tail), ``visible`` [B, Hk, S] (a
    contiguous mask over both; its region prefix and tail rows are the
    views the kernels take), with the model's scale and cap ``akw``: one
    region-kernel call (:func:`region_route`), which attends over the tail
    too and merges, or its plain version (region partials, tail partials
    in plain torch as the JAX package leaves them to XLA, merged).
    ``mm_bf16`` (f32 route, group layout): the tiled TPU kernel's mode of
    that name.  Returns [B, H, D] in q's dtype."""
    cs, sp = plan.spec, plan.prefill_slots
    tail = (layer.k, layer.v, visible[:, :, sp:])
    f32 = f32_quant and cs.q_layout == "group"
    mkw = dict(akw, mm_bf16=True) if f32 and mm_bf16 else akw
    if impl == "kernel":
        b, hk, w = reg.k.codes.shape[:3]
        return region_route(cs, b * hk, w, q.device, f32_quant,
                            q.shape[-1])(
            q, reg, visible[:, :, :sp], nbits=cs.nbits, tail=tail, **mkw)
    plain_region = (quant.quant_decode_attention_plain if f32
                    else quant.quant_region_attention_fused)
    return quant.merge_tail(
        plain_region(q, reg, visible[:, :, :sp], nbits=cs.nbits, **mkw), q,
        tail, **akw)


def decode_step(
    params: dict,
    spec: ModelSpec,
    plan: PolicyPlan,
    cache: KVCache,
    token: torch.Tensor,
    *,
    attention_impl: str = "kernel",
    f32_quant: bool = False,
    mm_bf16: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step against the compressed cache.

    token: [B] ids generated at the previous step.  The new K/V row is
    written IN PLACE into decode slot ``prefill_slots + step`` of every
    layer (the JAX version returns a new cache; this one advances
    ``cache.step`` and returns the same buffers); with a KIVI cache, whose
    k/v buffers hold only the decode slots, into k/v slot ``step``.
    ``f32_quant``: group-layout KIVI regions decode through the f32
    region kernels (:func:`region_route`), with ``mm_bf16`` in that mode
    (:func:`region_mm_bf16` decides it for the engine).  Returns (f32
    logits [B, vocab], cache).
    """
    check_ported(spec)
    if attention_impl not in IMPLS:
        raise ValueError(f"attention_impl must be one of {IMPLS}")
    b = token.shape[0]
    groups = spec.num_query_groups
    inv_freq = rope_inv_freq(spec, token.device)
    pos = cache.current_position()  # [B]
    store_kv = stores_kv_heads(plan.spec)
    akw = attn_args(spec)
    # the window masks decode only where rows are positions (fullkv and
    # minference keep every slot), each layer's own (Gemma-2's alternate);
    # a compressed cache attends all its kept keys, the reference's decode
    # semantics (JAX llama.py:932-951)
    windowed = plan.spec.method in ("fullkv", "minference")
    quantized = cache.quant is not None
    think = cache.think is not None
    attend = (decode_attention if attention_impl == "kernel"
              else plain.decode_attention)

    hidden = embed(params, token, spec)  # [B, Dm]
    segs = plan.segment_plans()
    for si, (start, stop, sub) in enumerate(segs):
        if cache.segmented:
            bufs = (cache.k[si], cache.v[si], cache.mask[si],
                    cache.positions[si])
        else:
            bufs = (cache.k, cache.v, cache.mask, cache.positions)
        slot = sub.prefill_slots + cache.step  # mask / positions / V
        # a KIVI cache's k/v buffers hold only the decode slots; a narrow
        # ThinK cache's K starts after the pruned region
        kv_slot = (cache.step if quantized
                   else slot - sub.think_pruned_slots if think else slot)
        v_slot = slot if think else kv_slot
        for i in range(stop - start):
            wts = _layer(params, start + i)
            win = spec.layer_window(start + i) if windowed else None
            x = _norm(hidden, wts["attn_norm"], spec)[:, None, :]
            q, k, v = _qkv(x, wts, spec, attention_impl)  # [B, H/KV, 1, Dh]
            q = apply_rope(q, pos[:, None], inv_freq)[:, :, 0, :].contiguous()
            k = apply_rope(k, pos[:, None], inv_freq)
            if not store_kv:  # per-query-head storage
                k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
            layer = LayerCacheView(*(t[i] for t in bufs))
            layer.k[:, :, kv_slot] = k[:, :, 0]
            layer.v[:, :, v_slot] = v[:, :, 0]
            layer.mask[:, :, slot] = True
            layer.positions[:, :, slot] = pos[:, None].to(torch.int32)
            visible = layer.mask
            if win is not None:  # a fresh contiguous mask, as the kernels take
                visible = visible & (layer.positions
                                     > (pos[:, None, None] - win))
            if quantized:
                attn = _region_attention(
                    q, quant.layer_region(cache.quant, start + i), layer,
                    visible, sub, attention_impl, akw, f32_quant, mm_bf16)
            elif think:
                # no kernel: plain torch, as JAX leaves it to XLA
                attn = plain.decode_attention_think(
                    q, cache.think.k_pruned[start + i],
                    cache.think.kept_channels[start + i], layer.k, layer.v,
                    layer.mask, **akw)
            else:
                attn = attend(q, layer.k, layer.v, visible, **akw)
            hidden = block_tail(hidden, attn.reshape(b, -1), wts, spec,
                                attention_impl)
    cache.step += 1
    return _logits(hidden, params, spec, attention_impl), cache
