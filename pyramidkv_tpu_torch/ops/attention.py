"""Plain PyTorch attention: blockwise causal prefill and masked decode.

These are the plain versions of the port's flash and decode kernels
(``kernels/flash_prefill.py``, ``kernels/decode_attn.py``) and the
counterparts of ``pyramidkv_tpu/ops/attention.py``'s
``causal_prefill_attention``, ``decode_attention``, ``tile_attention_partials``
and ``merge_partials_pair``; :func:`flash_partials_plain` is the plain
version of ``flash_attention_partials`` (base-2 statistics), and
:func:`flash_row_max_plain` / :func:`flash_pass_b_plain` the plain versions
of the two passes of ``flash_causal_attention(two_pass=True)``.  The CPU path runs
them; on the card they are the references the kernels are held against.
:func:`decode_attention_think` (ThinK's narrow-layout decode) has no kernel
on either side: both paths run it.

Numerics follow the JAX versions: operands in the storage dtype with f32
accumulation (done here by upcasting to f32 — a bf16 x bf16 product is exact
in f32, so this is the same sum), softmax in f32, probabilities rounded to
V's dtype before the PV product.  ``scale`` (default 1/sqrt(D)) and
``softcap`` (Gemma-2's attention logit cap, cap * tanh(s / cap) of the
scaled logit before the mask: JAX's ``_scale_softcap``) apply everywhere
but the KIVI partials.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = torch.finfo(torch.float32).min
_LOG2E = math.log2(math.e)


def scale_softcap(logits: torch.Tensor, scale: float,
                  softcap: Optional[float]) -> torch.Tensor:
    """Scale raw q . k logits, then (optionally) cap them: cap * tanh(s /
    cap) (JAX ``ops/attention.py::_scale_softcap``; the mask comes after)."""
    logits = logits * scale
    if softcap is not None:
        logits = torch.tanh(logits * (1.0 / softcap)) * softcap
    return logits


def q_fold(q: torch.Tensor, scale: Optional[float],
           softcap: Optional[float]) -> torch.Tensor:
    """The flash kernels' q fold in f32: q times scale * log2(e), or times
    scale alone under a cap (log2(e) cannot pass the tanh: it applies after
    it, :func:`cap_base2`), rounded to q's dtype (the JAX wrapper's)."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if softcap is None:
        sc *= _LOG2E
    return (q.float() * sc).to(q.dtype).float()


def folds_q(d: int) -> bool:
    """Whether the kernels at head dim ``d`` fold the scale (and log2 e)
    into q rounded to q's dtype (:func:`q_fold`, the TPU wrapper's; D = 128
    and 256), or read q as it is and scale each f32 product (D = 32: the
    trained tiny retrieval checkpoint's logits reach 900-3000 nats, and the
    fold's rounding moves them by several)."""
    return d != 32


def q_scaled(q: torch.Tensor, scale: Optional[float],
             softcap: Optional[float]):
    """(q as the kernels at its head dim multiply it, in f32; the f32
    multiplier of each product): :func:`q_fold`'s q and 1 where they fold
    (:func:`folds_q`), else q and scale * log2(e) (scale alone under a
    cap, log2(e) after the tanh: :func:`cap_base2`)."""
    d = q.shape[-1]
    if folds_q(d):
        return q_fold(q, scale, softcap), 1.0
    return q.float(), product_scale(d, scale, softcap)


def product_scale(d: int, scale: Optional[float],
                  softcap: Optional[float]) -> float:
    """The multiplier of a q . k product at head dim ``d`` into the base-2
    domain: scale (default 1/sqrt(d)) times log2(e), or scale alone under
    a cap (:func:`cap_base2` applies log2(e) after the tanh)."""
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    return sc * (1.0 if softcap is not None else _LOG2E)


def cap_base2(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """Base-2 logits from products of :func:`q_fold`'s q: unchanged without
    a cap, else cap * tanh(s / cap) * log2(e) (JAX ``flash_prefill.py``'s
    kernels, ``use_exp2`` with a softcap)."""
    if softcap is None:
        return s
    return torch.tanh(s * (1.0 / softcap)) * (softcap * _LOG2E)


def causal_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    true_len: torch.Tensor,
    block: int = 512,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    q_start: int = 0,
) -> torch.Tensor:
    """Blockwise causal self-attention over a left-padded buffer.

    q: [B, H, Nq, D]; k, v: [B, Hk, N, D] with H % Hk == 0 (each group of
    H/Hk query heads shares a KV head; no repeat_kv copy is made).
    true_len: [B] — real tokens occupy columns [N - true_len, N) of the key
    buffer.  ``q_start`` places the queries at global columns [q_start,
    q_start + Nq) (chunked prefill: q_start + Nq == N); the default 0 with
    Nq == N is plain causal self-attention.
    The query-block loop bounds the f32 logits at [B, H, block, N]: N x N
    logits are never held.  Returns [B, H, Nq, D] in q's dtype (padding rows
    hold values the callers never read).
    """
    b, h, nq, d = q.shape
    hk = k.shape[1]
    n = k.shape[2]
    assert q_start + nq == n or (q_start == 0 and nq == n), (q_start, nq, n)
    g = h // hk
    block = _row_block(block, b * h * n, nq)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pad = (n - true_len).to(torch.int64)
    col = torch.arange(n, device=q.device)
    colv = col[None, :] >= pad[:, None]  # [B, N]
    kf = k.float().transpose(-1, -2)     # [B, Hk, D, N]
    vf = v.float()
    qg = q.reshape(b, hk, g, nq, d)
    out = torch.empty((b, hk, g, nq, d), dtype=q.dtype, device=q.device)
    for r0 in range(0, nq, block):
        rows = q_start + r0 + torch.arange(block, device=q.device)
        causal = col[None, :] <= rows[:, None]  # [block, N]
        if sliding_window is not None:
            causal &= (rows[:, None] - col[None, :]) < sliding_window
        mask = causal[None] & colv[:, None, :]  # [B, block, N]
        qb = qg[:, :, :, r0:r0 + block].float().reshape(b, hk, g * block, d)
        logits = scale_softcap(torch.matmul(qb, kf).reshape(
            b, hk, g, block, n), scale, softcap)
        logits = logits.masked_fill(~mask[:, None, None], _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
        ob = torch.matmul(probs.reshape(b, hk, g * block, n), vf)
        out[:, :, :, r0:r0 + block] = ob.reshape(b, hk, g, block, d).to(q.dtype)
    return out.reshape(b, h, nq, d)


def _row_block(block: int, row_elems: int, rows: int) -> int:
    """A query-row block that divides ``rows`` and caps the transient
    [rows_in_block, row_elems] f32 logits at ~256 MB, as JAX does."""
    block = max(min(block, (1 << 26) // max(row_elems, 1)), 8)
    if rows % block != 0:
        block = math.gcd(rows, block) or rows
    return block


def flash_partials_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    true_len: torch.Tensor,
    *,
    q_start: int = 0,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    block: int = 512,
):
    """Plain version of ``kernels/flash_prefill.py::flash_attention_partials``:
    the online-softmax partials of causal GQA attention, with the statistics
    in the BASE-2 domain, as the JAX kernel returns them.

    q: [B, H, Nq, D]; k, v: [B, Hk, N, D]; true_len: [B] (keys at columns
    < N - true_len are padding).  Queries sit at global columns [q_start,
    q_start + Nq): ``q_start == 0`` with Nq == N is the causal self tile,
    ``q_start >= N`` a rectangle whose keys all precede its queries (a
    history tile at its true distance: with ``sliding_window`` a key is
    visible only when ``q_start + r - c < sliding_window``).  q is scaled
    by log2(e) * scale (scale alone under ``softcap``, the products then
    capped in base 2: :func:`q_fold`, :func:`cap_base2`) and rounded to
    q's dtype (the JAX wrapper's fold), so logits s are base-2 and
    ``m = max s``, ``l = sum exp2(s - m)``,
    ``acc = sum p v`` with p rounded to v's dtype.  A row with no visible
    key has m = float32.min, l = 0, acc = 0.  Returns (acc [B, H, Nq, D],
    m [B, H, Nq], l [B, H, Nq]) f32; merge in base 2
    (``models/chunked_prefill.py::merge_exp2``).
    """
    b, h, nq, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    assert q_start + nq >= n and (q_start == 0 or q_start >= n), (
        q_start, nq, n)
    g = h // hk
    block = _row_block(block, b * h * n, nq)
    qr = q_fold(q, scale, softcap).reshape(b, hk, g, nq, d)
    pad = (n - true_len).to(torch.int64)
    col = torch.arange(n, device=q.device)
    colv = col[None, :] >= pad[:, None]  # [B, N]
    kf = k.float().transpose(-1, -2)
    vf = v.float()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((b, hk, g, nq, d), **f32)
    m = torch.empty((b, hk, g, nq), **f32)
    l = torch.empty((b, hk, g, nq), **f32)
    for r0 in range(0, nq, block):
        rows = q_start + r0 + torch.arange(block, device=q.device)
        vis = col[None, :] <= rows[:, None]
        if sliding_window is not None:
            vis &= (rows[:, None] - col[None, :]) < sliding_window
        mask = vis[None] & colv[:, None, :]
        s = cap_base2(torch.matmul(qr[:, :, :, r0:r0 + block].reshape(
            b, hk, g * block, d), kf).reshape(b, hk, g, block, n), softcap)
        s = s.masked_fill(~mask[:, None, None], _NEG_INF)
        mb = s.amax(dim=-1)
        p = torch.exp2(s - mb.clamp_min(_NEG_INF / 2)[..., None])
        l[..., r0:r0 + block] = p.sum(-1)
        acc[..., r0:r0 + block, :] = torch.matmul(
            p.to(v.dtype).float().reshape(b, hk, g * block, n), vf).reshape(
                b, hk, g, block, d)
        m[..., r0:r0 + block] = mb
    return (acc.reshape(b, h, nq, d), m.reshape(b, h, nq),
            l.reshape(b, h, nq))


def _base2_logit_blocks(q, k, true_len, sliding_window, scale, softcap,
                        q_start, block):
    """Yield (r0, rows, s) per query-row block of the TPU flash kernel's
    base-2 logits: ``s = bf16(q * scale * log2 e) . k`` in f32 (the
    wrapper's fold: log2(e) and the softmax scale multiply q in f32, rounded
    to q's dtype; under ``softcap`` q * scale, the product capped in base 2),
    masked to float32.min outside the causal edge, the left pad and the
    sliding window; s is [B, Hk, G, rows, N]."""
    b, h, nq, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    assert q_start + nq == n or (q_start == 0 and nq == n), (q_start, nq, n)
    g = h // hk
    block = _row_block(block, b * h * n, nq)
    qr = q_fold(q, scale, softcap).reshape(b, hk, g, nq, d)
    pad = (n - true_len).to(torch.int64)
    col = torch.arange(n, device=q.device)
    colv = col[None, :] >= pad[:, None]  # [B, N]
    kf = k.float().transpose(-1, -2)
    for r0 in range(0, nq, block):
        rows = q_start + r0 + torch.arange(block, device=q.device)
        vis = col[None, :] <= rows[:, None]
        if sliding_window is not None:
            vis &= (rows[:, None] - col[None, :]) < sliding_window
        mask = vis[None] & colv[:, None, :]  # [B, block, N]
        s = cap_base2(torch.matmul(qr[:, :, :, r0:r0 + block].reshape(
            b, hk, g * block, d), kf).reshape(b, hk, g, block, n), softcap)
        yield r0, block, s.masked_fill(~mask[:, None, None], _NEG_INF)


def flash_row_max_plain(q, k, true_len, *, sliding_window=None, scale=None,
                        softcap=None, q_start: int = 0,
                        block: int = 512) -> torch.Tensor:
    """Pass A of the two-pass flash schedule (plain version of
    ``kernels/flash_prefill.py``'s row-max kernel; the TPU's ``_max_kernel``):
    the max over every visible key of each query row's base-2 logit
    (:func:`_base2_logit_blocks`).  q: [B, H, Nq, D]; k: [B, Hk, N, D].
    Returns m [B, H, Nq] f32; a row with no visible key has m =
    float32.min."""
    b, h, nq, _ = q.shape
    m = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    mg = m.view(b, k.shape[1], h // k.shape[1], nq)
    for r0, rows, s in _base2_logit_blocks(q, k, true_len, sliding_window,
                                           scale, softcap, q_start, block):
        mg[..., r0:r0 + rows] = s.amax(dim=-1)
    return m


def flash_pass_b_plain(q, k, v, m, true_len, *, sliding_window=None,
                       scale=None, softcap=None, q_start: int = 0,
                       block: int = 512) -> torch.Tensor:
    """Pass B of the two-pass flash schedule (plain version of
    ``kernels/flash_prefill.py``'s pass-B kernel; the TPU's
    ``_kernel_pass_b``): rescale-free accumulation against the known row
    maxes m [B, H, Nq] (:func:`flash_row_max_plain`), clamped to
    float32.min / 2: ``p = exp2(s - m)``, ``l = sum p``, ``acc = sum p v``
    with p rounded to v's dtype; ``out = acc / l`` (0 where l = 0).  Returns
    [B, H, Nq, D] in q's dtype."""
    b, h, nq, d = q.shape
    hk = k.shape[1]
    g = h // hk
    mg = m.reshape(b, hk, g, nq).clamp_min(_NEG_INF / 2)
    vf = v.float()
    out = torch.empty((b, hk, g, nq, d), dtype=q.dtype, device=q.device)
    for r0, rows, s in _base2_logit_blocks(q, k, true_len, sliding_window,
                                           scale, softcap, q_start, block):
        p = torch.exp2(s - mg[..., r0:r0 + rows, None])
        l = p.sum(-1)
        acc = torch.matmul(p.to(v.dtype).float().reshape(b, hk, g * rows, -1),
                           vf).reshape(b, hk, g, rows, d)
        out[:, :, :, r0:r0 + rows] = (
            acc / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)
    return out.reshape(b, h, nq, d)


def tile_attention_partials(
    q: torch.Tensor,
    k_tile: torch.Tensor,
    v_tile: torch.Tensor,
    mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    q_block: int = 1024,
):
    """Natural-log online-softmax partials of a multi-row query block
    against one K/V tile (JAX ``ops/attention.py::tile_attention_partials``).

    q: [B, H, T, D]; k_tile, v_tile: [B, Hk, S, D]; mask: [B, T, S] or
    [B, 1, S] visibility (causality and padding are the caller's).  The
    logits are scaled by ``scale`` (default 1/sqrt(D)) and capped under
    ``softcap`` before the mask.  Returns (acc [B, H, T, D], m [B, H, T],
    l [B, H, T]) f32; merge with :func:`merge_partials_pair`."""
    b, h, t, d = q.shape
    hk, s_len = k_tile.shape[1], k_tile.shape[2]
    g = h // hk
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = mask.expand(b, t, s_len)
    kf = k_tile.float().transpose(-1, -2)
    vf = v_tile.float()
    qf = q.float().reshape(b, hk, g, t, d)
    tb = t if t <= q_block or t % q_block else q_block
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((b, hk, g, t, d), **f32)
    m = torch.empty((b, hk, g, t), **f32)
    l = torch.empty((b, hk, g, t), **f32)
    for r0 in range(0, t, tb):
        mb = mask[:, None, None, r0:r0 + tb]
        logits = scale_softcap(torch.matmul(qf[:, :, :, r0:r0 + tb].reshape(
            b, hk, g * tb, d), kf).reshape(b, hk, g, tb, s_len), sc, softcap)
        logits = logits.masked_fill(~mb, _NEG_INF)
        mx = logits.amax(dim=-1)
        p = torch.exp(logits - mx.clamp_min(_NEG_INF / 2)[..., None])
        p = p.masked_fill(~mb, 0.0)
        l[..., r0:r0 + tb] = p.sum(-1)
        acc[..., r0:r0 + tb, :] = torch.matmul(
            p.to(v_tile.dtype).float().reshape(b, hk, g * tb, s_len),
            vf).reshape(b, hk, g, tb, d)
        m[..., r0:r0 + tb] = mx
    return (acc.reshape(b, h, t, d), m.reshape(b, h, t), l.reshape(b, h, t))


def merge_partials_pair(a, b):
    """Online-merge two natural-log partial triples (acc, m, l); a source
    whose m <= float32.min / 2 (nothing visible) gets weight 0."""
    acc1, m1, l1 = a
    acc2, m2, l2 = b
    m = torch.maximum(m1, m2)
    w1 = torch.exp((m1 - m).clamp_max(0.0)).masked_fill(m1 <= _NEG_INF / 2,
                                                        0.0)
    w2 = torch.exp((m2 - m).clamp_max(0.0)).masked_fill(m2 <= _NEG_INF / 2,
                                                        0.0)
    return (acc1 * w1[..., None] + acc2 * w2[..., None], m, l1 * w1 + l2 * w2)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
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
    logits = scale_softcap(torch.matmul(qg, k_cache.float().transpose(-1, -2)),
                           sc, softcap)
    logits = logits.masked_fill(~mask[:, :, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype).float()
    out = torch.matmul(probs, v_cache.float())  # [B, Hk, G, D]
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_think(
    q: torch.Tensor,
    k_pruned: torch.Tensor,
    kept_channels: torch.Tensor,
    k_rest: torch.Tensor,
    v_cache: torch.Tensor,
    mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """ThinK's decode over the narrow key region: two logit blocks joined
    before the softmax, the channel-gathered query against the pruned keys
    and the full query against the full-width rest, both scaled by
    ``scale`` (default 1/sqrt(D) of the full head) and capped under
    ``softcap`` before the mask (JAX ``ops/attention.py:538``).  Plain
    torch, as the JAX package leaves it to XLA (no Pallas kernel computes
    it).

    q: [B, H, D]; k_pruned: [B, H, Sp, Dk]; kept_channels: [B, H, Dk];
    k_rest: [B, H, Sr, D]; v_cache: [B, H, Sp + Sr, D]; mask: [B, H,
    Sp + Sr].  Masked logits are float32.min.  Returns [B, H, D]."""
    d = q.shape[-1]
    qf = q.float()
    q_kept = torch.gather(qf, 2, kept_channels.long())
    lp = torch.matmul(q_kept[:, :, None], k_pruned.float().transpose(-1, -2))
    lr = torch.matmul(qf[:, :, None], k_rest.float().transpose(-1, -2))
    logits = scale_softcap(torch.cat([lp, lr], dim=-1)[:, :, 0],
                           scale if scale is not None
                           else 1.0 / math.sqrt(d), softcap)
    logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype).float()
    out = torch.matmul(probs[:, :, None], v_cache.float())[:, :, 0]
    return out.to(q.dtype)


def decode_attention_partials(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, mask: torch.Tensor, *,
                              scale: Optional[float] = None,
                              softcap: Optional[float] = None):
    """Online-softmax partials of single-token attention, in f32: (acc
    [B, H, D], m [B, H], l [B, H]) with out = acc / l after merging.
    Shapes, ``scale`` and ``softcap`` as :func:`decode_attention` (the cap
    before the mask).  ``m`` is the true max logit (float32.min when every
    slot is masked, and then l = 0, never -cap)."""
    b, h, d = q.shape
    hk = k_cache.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hk, h // hk, d)
    logits = scale_softcap(
        torch.matmul(qg, k_cache.float().transpose(-1, -2)), sc, softcap)
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
