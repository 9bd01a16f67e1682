"""Observation-window key scoring (counterpart of
``pyramidkv_tpu/ops/scoring.py``'s ``window_scores``).

Scorers take post-RoPE projections in a left-padded buffer of length N
(real tokens at ``[N - true_len, N)``) and return one score per non-window
column, ``[B, H, N - W]``, with -inf at padding columns so selection is one
fixed-width top-k.  The last W queries attend every key with the causal
mask applied ONLY inside the trailing W x W block (the reference's quirk),
softmax in f32, summed over the W rows, then pooled.
"""

from __future__ import annotations

import math

import torch

from .pooling import pool1d

_NEG_INF = float("-inf")


def _column_valid(n: int, true_len: torch.Tensor) -> torch.Tensor:
    """[B, n] bool: the buffer column holds a real token (left padding)."""
    col = torch.arange(n, device=true_len.device)[None, :]
    pad = (n - true_len).to(torch.int64)[:, None]
    return col >= pad


def _window_causal_bias(window: int, n: int, device=None) -> torch.Tensor:
    """[W, n] additive bias: -inf where window query i may not see window
    key j (j > i inside the trailing W x W block); 0 elsewhere."""
    bias = torch.zeros((window, n), dtype=torch.float32, device=device)
    i = torch.arange(window, device=device)[:, None]
    j = torch.arange(window, device=device)[None, :]
    bias[:, n - window:] = torch.where(j > i, _NEG_INF, 0.0)
    return bias


def window_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    window_size: int,
    true_len: torch.Tensor,
    kernel_size: int,
    pooling: str,
) -> torch.Tensor:
    """SnapKV-family window score, ``[B, H, N - W]`` f32, -inf at padding.

    q: [B, H, N, D]; k: [B, Hk, N, D] with H % Hk == 0 — the grouped product
    gives the same per-query-head scores as scoring after repeat_kv, with
    no repeated copy of K.
    """
    b, h, n, d = q.shape
    hk = k.shape[1]
    w = window_size
    qw = q[:, :, n - w:, :].float().reshape(b, hk, (h // hk) * w, d)
    logits = torch.matmul(qw, k.float().transpose(-1, -2)).reshape(
        b, h, w, n) * (1.0 / math.sqrt(d))
    logits = logits + _window_causal_bias(w, n, q.device)[None, None]
    colv = _column_valid(n, true_len)  # [B, N]
    logits = logits.masked_fill(~colv[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    s = probs[..., : n - w].sum(dim=2)
    past_valid = colv[:, None, : n - w]
    s = s.masked_fill(~past_valid, 0.0)  # zero padding so pooling edges match
    s = pool1d(s, kernel_size, pooling)
    return s.masked_fill(~past_valid, _NEG_INF)
