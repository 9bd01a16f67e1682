"""One-token decode attention: wrapper of ``csrc/decode_attn.cu``.

Counterpart of ``pyramidkv_tpu/kernels/decode_attn.py::
decode_attention_pallas`` — on the H100 it is the port's decode path for
every cache size (the TPU kept it opt-in and capped at 4096 slots).  On a
CUDA tensor it launches the hand-written sm_90a kernel, the slots split
across blocks as :func:`decode_split_plan` says; on a CPU tensor it runs the
plain version (``ops.attention.decode_attention``).  Head dims 128, 256
(Gemma-2) and 32 (the trained tiny retrieval checkpoint), a softmax
``scale`` and a logit cap ``softcap`` (Gemma-2's: the
JAX package decodes a capped model in XLA, ``ops/attention.py::
decode_attention``; here the kernel computes it too).
:func:`decode_attention_split_plain` is the kernel's schedule in plain
PyTorch: per-split f32 partials merged in split order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import _NEG_INF, scale_softcap
from ..ops.attention import decode_attention as decode_attention_plain
from . import _build
from .quant_decode import _sm_count

HEAD_DIM = 128
#: GQA group sizes the kernel is instantiated for at D = 128 (7:
#: Qwen2.5-7B's 28 / 4)
GROUPS = (1, 2, 4, 7, 8)
#: head dim -> its instantiated groups (256: Gemma-2-9B's per-head caches,
#: G = 1, and its 16 / 8 heads, G = 2; 32: the trained tiny retrieval
#: checkpoint's per-head caches and its 8 / 4 heads)
GROUPS_BY_DIM = {HEAD_DIM: GROUPS, 256: (1, 2), 32: (1, 2)}
#: slots a tile of the kernel's ring (its TILE); a split holds at most 32
#: of them at D = 128 and 32 and 64 at D = 256 (the kernel's ``max_slots``:
#: one block an SM would otherwise take two waves for Gemma-2's fullkv
#: cache)
TILE = 64
_MAX_TILES = {HEAD_DIM: 32, 256: 64, 32: 32}
#: up to this many splits merge inside a thread-block cluster, by head dim
#: (the kernel's ``max_cluster``: at D = 256 a block fills an SM and clusters
#: of 4 did not all fit one wave); more go through a workspace and a merge
#: kernel
MAX_CLUSTER = {HEAD_DIM: 4, 256: 2, 32: 4}


def blocks_per_sm(g: int, d: int = HEAD_DIM) -> int:
    """Blocks of the kernel an SM holds at group ``g`` and head dim ``d``:
    its ``__launch_bounds__`` (two at D = 128 up to G = 4, the query in f32
    registers, as packed bf16 pairs above; one at D = 256, whose 3-stage
    ring is 192 KB; five at D = 32, a 24 KB ring and 48 registers a
    thread).  ``chip_smoke.py`` holds it to the card's occupancy of each
    instantiation (``pkv_decode_occupancy``)."""
    if d == 32:
        return 5
    return 2 if d == HEAD_DIM and g <= 4 else 1


def decode_split_plan(device: torch.device, bhk: int, s: int, g: int = 1,
                      d: int = HEAD_DIM):
    """(nsplit, slots per split) for ``bhk`` regions of ``s`` slots, ``g``
    query heads a KV head and head dim ``d`` on ``device``: one wave of the
    kernel's residency (:func:`blocks_per_sm` blocks an SM), each split at
    most 32 64-slot tiles (64 at D = 256; the last split may be shorter).
    Shapes only: the host reads no mask, so the decode step never waits on
    the card."""
    tiles = -(-s // TILE)
    want = max(1, blocks_per_sm(g, d) * _sm_count(device) // bhk)
    per = min(-(-tiles // want), _MAX_TILES[d])
    return -(-tiles // per), per * TILE


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, mask: torch.Tensor,
                                 nsplit: int, rows: int, *,
                                 scale: Optional[float] = None,
                                 softcap: Optional[float] = None
                                 ) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: split s attends over slots
    [s * rows, min(S, (s + 1) * rows)) in f32 (probabilities kept in f32),
    giving (acc, m, l); a split with no visible slot in a row that has one
    gives (0, -inf, 0), and in a row with none every split attends over all
    its slots at logit float32.min; the partials merge in split order.
    Shapes, ``scale`` and ``softcap`` as :func:`decode_attention`; returns
    [B, H, D] in q's dtype."""
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
        x = scale_softcap(torch.matmul(qg, k[:, :, sl].float().transpose(
            -1, -2)), scale if scale is not None else 1.0 / math.sqrt(d),
            softcap)
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
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """q: [B, H, D]; k, v: [B, Hk, S, D]; mask: [B, Hk, S] bool -> [B, H, D]
    with softmax scale ``scale`` (default 1/sqrt(D)) and, with ``softcap``,
    the logits capped at cap * tanh(s / cap)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask, scale=scale,
                                      softcap=softcap)
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
    if h // hk not in GROUPS_BY_DIM.get(d, ()) or s < 1:
        raise ValueError(f"kernel takes (D, H/Hk) in {GROUPS_BY_DIM}, "
                         f"S >= 1; got D={d} H/Hk={h / hk} S={s}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if (mask.dtype != torch.bool or not mask.is_contiguous()
            or mask.device != q.device):
        raise ValueError("mask must be a contiguous bool tensor on q's device")
    out = torch.empty_like(q)
    nsplit, rows = decode_split_plan(q.device, b * hk, s, h // hk, d)
    stream = torch.cuda.current_stream(q.device)
    if nsplit > MAX_CLUSTER[d]:
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
        out.data_ptr(), *ws_ptrs, b, h, hk, d, s, nsplit, rows,
        float(scale if scale is not None else 1.0 / math.sqrt(d)),
        float(softcap or 0.0), stream.cuda_stream)
    _build.check(err, "decode_attn")
    decode_attention.launches += 1
    decode_attention.blocks += b * hk * nsplit
    return out


#: kernel launches since the last reset (CPU calls do not count), and the
#: split kernel's blocks they ran (B * Hk * nsplit each: the plan's grid)
decode_attention.launches = 0
decode_attention.blocks = 0
