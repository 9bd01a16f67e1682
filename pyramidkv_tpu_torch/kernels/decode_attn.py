"""One-token decode attention: wrapper of ``csrc/decode_attn.cu``.

Counterpart of ``pyramidkv_tpu/kernels/decode_attn.py::
decode_attention_pallas`` — on the H100 it is the port's decode path for
every cache size (the TPU kept it opt-in and capped at 4096 slots).  On a
CUDA tensor it launches the hand-written sm_90a kernel, the slots split
across blocks as :func:`decode_split_plan` says; on a CPU tensor it runs the
plain version (``ops.attention.decode_attention``).
:func:`decode_attention_split_plain` is the kernel's schedule in plain
PyTorch: per-split f32 partials merged in split order.
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import _NEG_INF
from ..ops.attention import decode_attention as decode_attention_plain
from . import _build
from .quant_decode import _sm_count

HEAD_DIM = 128
#: GQA group sizes the kernel is instantiated for (7: Qwen2.5-7B's 28 / 4)
GROUPS = (1, 2, 4, 7, 8)
#: slots a tile of the kernel's ring (its TILE); a split holds at most 32
TILE = 64
_MAX_TILES = 32
#: up to this many splits merge inside a thread-block cluster (the kernel's
#: MAX_CLUSTER); more go through a workspace and a merge kernel
MAX_CLUSTER = 4


def blocks_per_sm(g: int) -> int:
    """Blocks of the kernel an SM holds at group ``g``: its
    ``__launch_bounds__(NT, G <= 4 ? 2 : 1)`` (the query in f32 registers up
    to G = 4, as packed bf16 pairs above).  ``chip_smoke.py`` holds it to
    the card's occupancy of each instantiation (``pkv_decode_occupancy``)."""
    return 2 if g <= 4 else 1


def decode_split_plan(device: torch.device, bhk: int, s: int, g: int = 1):
    """(nsplit, slots per split) for ``bhk`` regions of ``s`` slots and
    ``g`` query heads a KV head on ``device``: one wave of the kernel's
    residency (:func:`blocks_per_sm` blocks an SM), each split at most 32
    64-slot tiles (the last split may be shorter).  Shapes only: the host
    reads no mask, so the decode step never waits on the card."""
    tiles = -(-s // TILE)
    want = max(1, blocks_per_sm(g) * _sm_count(device) // bhk)
    per = min(-(-tiles // want), _MAX_TILES)
    return -(-tiles // per), per * TILE


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, mask: torch.Tensor,
                                 nsplit: int, rows: int) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: split s attends over slots
    [s * rows, min(S, (s + 1) * rows)) in f32 (probabilities kept in f32),
    giving (acc, m, l); a split with no visible slot in a row that has one
    gives (0, -inf, 0), and in a row with none every split attends over all
    its slots at logit float32.min; the partials merge in split order.
    Shapes as :func:`decode_attention`; returns [B, H, D] in q's dtype."""
    b, h, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    if (nsplit - 1) * rows >= s or nsplit * rows < s:
        raise ValueError(f"plan ({nsplit}, {rows}) does not cover {s} slots")
    qg = q.float().reshape(b, hk, h // hk, d)
    row_vis = mask.any(-1)[..., None]                           # [B, Hk, 1]
    parts = []
    for i in range(nsplit):
        sl = slice(i * rows, min(s, (i + 1) * rows))
        mi = mask[:, :, None, sl]
        x = torch.matmul(qg, k[:, :, sl].float().transpose(-1, -2)) * (
            1.0 / math.sqrt(d))
        x = x.masked_fill(~mi, _NEG_INF)
        m = x.amax(-1)
        p = torch.exp(x - m[..., None])
        acc, l = torch.matmul(p, v[:, :, sl].float()), p.sum(-1)
        empty = ~mi.any(-1) & row_vis                           # [B, Hk, G]
        parts.append((acc.masked_fill(empty[..., None], 0.0),
                      m.masked_fill(empty, -math.inf),
                      l.masked_fill(empty, 0.0)))
    m_all = parts[0][1]
    for _, m, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    num = den = 0.0
    for acc, m, l in parts:
        w = torch.exp(m - m_all).masked_fill(m == -math.inf, 0.0)
        num = num + acc * w[..., None]
        den = den + l * w
    return (num / den[..., None]).reshape(b, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """q: [B, H, D]; k, v: [B, Hk, S, D]; mask: [B, Hk, S] bool -> [B, H, D]
    with softmax scale 1/sqrt(D)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask)
    b, h, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if (k.shape != (b, hk, s, d) or v.shape != k.shape
            or mask.shape != (b, hk, s) or h % hk):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} mask {tuple(mask.shape)}")
    if d != HEAD_DIM or h // hk not in GROUPS or s < 1:
        raise ValueError(f"kernel takes D == {HEAD_DIM}, H/Hk in {GROUPS}, "
                         f"S >= 1; got D={d} H/Hk={h / hk} S={s}")
    if (mask.dtype != torch.bool or not mask.is_contiguous()
            or mask.device != q.device):
        raise ValueError("mask must be a contiguous bool tensor on q's device")
    out = torch.empty_like(q)
    nsplit, rows = decode_split_plan(q.device, b * hk, s, h // hk)
    stream = torch.cuda.current_stream(q.device)
    if nsplit > MAX_CLUSTER:
        f32 = dict(dtype=torch.float32, device=q.device)
        ws = (torch.empty((b * hk * nsplit, h // hk, d), **f32),
              torch.empty((b * hk * nsplit, h // hk), **f32),
              torch.empty((b * hk * nsplit, h // hk), **f32))
        ws_ptrs = tuple(x.data_ptr() for x in ws)
    else:
        ws_ptrs = (None, None, None)
    lib = _build.library("decode_attn")
    err = lib.pkv_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), *ws_ptrs, b, h, hk, s, nsplit, rows,
        1.0 / math.sqrt(d), stream.cuda_stream)
    _build.check(err, "decode_attn")
    decode_attention.launches += 1
    decode_attention.blocks += b * hk * nsplit
    return out


#: kernel launches since the last reset (CPU calls do not count), and the
#: split kernel's blocks they ran (B * Hk * nsplit each: the plan's grid)
decode_attention.launches = 0
decode_attention.blocks = 0
