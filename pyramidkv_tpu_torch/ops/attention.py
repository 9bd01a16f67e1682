"""Plain PyTorch attention: blockwise causal prefill and masked decode.

These are the plain versions of the port's two CUDA kernels
(``kernels/flash_prefill.py``, ``kernels/decode_attn.py``) and the
counterparts of ``pyramidkv_tpu/ops/attention.py``'s
``causal_prefill_attention`` and ``decode_attention``.  The CPU path runs
them; on the card they are the references the kernels are held against.

Numerics follow the JAX versions: operands in the storage dtype with f32
accumulation (done here by upcasting to f32 — a bf16 x bf16 product is exact
in f32, so this is the same sum), softmax in f32, probabilities rounded to
V's dtype before the PV product.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = torch.finfo(torch.float32).min


def causal_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    true_len: torch.Tensor,
    block: int = 512,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise causal self-attention over a left-padded buffer.

    q: [B, H, N, D]; k, v: [B, Hk, N, D] with H % Hk == 0 (each group of
    H/Hk query heads shares a KV head; no repeat_kv copy is made).
    true_len: [B] — real tokens occupy columns [N - true_len, N).
    The query-block loop bounds the f32 logits at [B, H, block, N]: N x N
    logits are never held.  Returns [B, H, N, D] in q's dtype (padding rows
    hold values the callers never read).
    """
    b, h, n, d = q.shape
    hk = k.shape[1]
    g = h // hk
    # cap the transient [B, H, block, N] f32 logits at ~256 MB, as JAX does
    budget = (1 << 26) // max(b * h * n, 1)
    block = max(min(block, budget), 8)
    if n % block != 0:
        block = math.gcd(n, block) or n
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pad = (n - true_len).to(torch.int64)
    col = torch.arange(n, device=q.device)
    colv = col[None, :] >= pad[:, None]  # [B, N]
    kf = k.float().transpose(-1, -2)     # [B, Hk, D, N]
    vf = v.float()
    qg = q.reshape(b, hk, g, n, d)
    out = torch.empty((b, hk, g, n, d), dtype=q.dtype, device=q.device)
    for r0 in range(0, n, block):
        rows = r0 + torch.arange(block, device=q.device)
        causal = col[None, :] <= rows[:, None]  # [block, N]
        if sliding_window is not None:
            causal &= (rows[:, None] - col[None, :]) < sliding_window
        mask = causal[None] & colv[:, None, :]  # [B, block, N]
        qb = qg[:, :, :, r0:r0 + block].float().reshape(b, hk, g * block, d)
        logits = torch.matmul(qb, kf).reshape(b, hk, g, block, n) * scale
        logits = logits.masked_fill(~mask[:, None, None], _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
        ob = torch.matmul(probs.reshape(b, hk, g * block, n), vf)
        out[:, :, :, r0:r0 + block] = ob.reshape(b, hk, g, block, d).to(q.dtype)
    return out.reshape(b, h, n, d)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against the slot cache.

    q: [B, H, D]; k_cache, v_cache: [B, Hk, S, D] with H % Hk == 0 (Hk == H
    for per-query-head caches, Hk == num_kv_heads for true-GQA storage);
    mask: [B, Hk, S] bool.  Masked logits are float32.min (not -inf), so a
    row with every slot masked averages them uniformly.  Returns [B, H, D].
    """
    b, h, d = q.shape
    hk = k_cache.shape[1]
    g = h // hk
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hk, g, d)
    logits = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * sc
    logits = logits.masked_fill(~mask[:, :, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype).float()
    out = torch.matmul(probs, v_cache.float())  # [B, Hk, G, D]
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_partials(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, mask: torch.Tensor):
    """Online-softmax partials of single-token attention, in f32: (acc
    [B, H, D], m [B, H], l [B, H]) with out = acc / l after merging.
    Shapes as :func:`decode_attention`.  ``m`` is the true max logit
    (float32.min when every slot is masked, and then l = 0)."""
    b, h, d = q.shape
    hk = k_cache.shape[1]
    qg = q.float().reshape(b, hk, h // hk, d)
    logits = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d))
    valid = mask[:, :, None, :]
    logits = logits.masked_fill(~valid, _NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m.clamp_min(_NEG_INF / 2)[..., None]).masked_fill(
        ~valid, 0.0)
    acc = torch.matmul(p, v_cache.float())
    return acc.reshape(b, h, d), m.reshape(b, h), p.sum(-1).reshape(b, h)


def merge_attention_partials(parts) -> torch.Tensor:
    """Combine flash partials [(acc, m, l), ...] -> [B, H, D] f32.  A part
    whose m <= float32.min / 2 (every slot masked) gets weight 0."""
    m_all = parts[0][1]
    for _, m, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    num = den = 0.0
    for acc, m, l in parts:
        w = torch.exp((m - m_all).clamp_max(0.0)).masked_fill(
            m <= _NEG_INF / 2, 0.0)
        num = num + acc * w[..., None]
        den = den + l * w
    return num / den.clamp_min(1e-30)[..., None]
