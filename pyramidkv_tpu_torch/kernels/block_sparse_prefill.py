"""MInference's block-sparse prefill partials: wrappers of
``csrc/block_sparse_prefill.cu``.

Counterparts of ``pyramidkv_tpu/kernels/block_sparse_prefill.py``'s
``slash_tile_attention``, ``slash_tile_attention_db`` and
``vertical_attention_partials_kernel``.  On a CUDA tensor each launches its
hand-written sm_90a kernel; on a CPU tensor it runs the plain version
(``ops/sparse_prefill.py``).  All three return online-softmax partials
(acc [B,H,N,D] f32 unnormalised, m and l [B,H,N] f32, m in natural units);
a row with nothing visible has m = float32.min and l = 0.

The kernels trust the index arrays they are given: tile ids in
[0, N/k_tile) and vertical column ids in [0, N), as the estimation and tile
selection of ``ops/sparse_prefill.py`` produce them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.sparse_prefill import (slash_tile_attention_plain,
                                  vertical_attention_partials_plain)
from . import _build

#: q rows per block, keys per sub-tile (and vertical columns per chunk)
TILE = 64
HEAD_DIM = 128


def _check_operands(named, device) -> None:
    for name, t, dtype in named:
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{device}, got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_card(q: torch.Tensor, softcap) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if softcap is not None:
        raise NotImplementedError(
            "softcap (Gemma-2) is not ported to the block-sparse kernels yet "
            "(ROADMAP queue 1 #10)")


def _outputs(q: torch.Tensor):
    b, h, n, d = q.shape
    return (torch.empty((b, h, n, d), dtype=torch.float32, device=q.device),
            torch.empty((b, h, n), dtype=torch.float32, device=q.device),
            torch.empty((b, h, n), dtype=torch.float32, device=q.device))


def _slash(db: bool, q, k, v, tile_idx, tile_valid, vert, true_len, q_block,
           k_tile, scale, softcap):
    _check_card(q, softcap)
    b, h, n, d = q.shape
    hk = k.shape[1]
    if k.shape != (b, hk, n, d) or v.shape != k.shape or hk < 1 or h % hk:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if (d != HEAD_DIM or n % TILE or q_block % TILE or k_tile % TILE
            or n % q_block or n % k_tile):
        raise ValueError(
            f"kernel takes D == {HEAD_DIM}, N % {TILE} == 0 and q_block, "
            f"k_tile multiples of {TILE} dividing N; got D={d} N={n} "
            f"q_block={q_block} k_tile={k_tile}")
    nq = n // q_block
    t = tile_idx.shape[-1]
    if (tile_idx.shape != (b, h, nq, t) or tile_valid.shape != tile_idx.shape
            or vert.shape != (b, h, n) or t < 1):
        raise ValueError(f"bad shapes tile_idx {tuple(tile_idx.shape)} "
                         f"tile_valid {tuple(tile_valid.shape)} vert "
                         f"{tuple(vert.shape)} for q {tuple(q.shape)}, "
                         f"q_block {q_block}")
    tl = true_len.to(device=q.device, dtype=torch.int32).contiguous()
    if tl.shape != (b,):
        raise ValueError(f"true_len must be [{b}], got {tuple(tl.shape)}")
    bf = torch.bfloat16
    _check_operands((("q", q, bf), ("k", k, bf), ("v", v, bf),
                     ("tile_idx", tile_idx, torch.int32),
                     ("tile_valid", tile_valid, torch.bool),
                     ("vert", vert, torch.bool)), q.device)
    # db walks each list's valid prefix: its length per (b, h, q-block)
    flags = (tile_valid.sum(dim=-1, dtype=torch.int32) if db
             else tile_valid)
    acc, m, l = _outputs(q)
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _build.library("block_sparse_prefill")
    fn = lib.pkv_slash_tiles_db if db else lib.pkv_slash_tiles
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), tile_idx.data_ptr(),
             flags.data_ptr(), vert.data_ptr(), tl.data_ptr(), acc.data_ptr(),
             m.data_ptr(), l.data_ptr(), b, h, hk, n, q_block, k_tile, t,
             float(sc), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "slash_tiles_db" if db else "slash_tiles")
    return acc, m, l


def slash_tile_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tile_idx: torch.Tensor,
    tile_valid: torch.Tensor,
    vert: torch.Tensor,
    true_len: torch.Tensor,
    *,
    q_block: int = 128,
    k_tile: int = 128,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
):
    """Partials of each q-block against its T listed k-tiles (every entry
    visited, invalid ones skipped), causal, right of the pad, vertical
    columns left out.  q: [B, H, N, D]; k, v: [B, Hk, N, D] bf16;
    tile_idx int32 / tile_valid bool [B, H, N/q_block, T]; vert [B, H, N]
    bool; true_len [B]."""
    if q.device.type == "cpu":
        return slash_tile_attention_plain(
            q, k, v, tile_idx, tile_valid, vert, true_len, q_block=q_block,
            k_tile=k_tile, scale=scale, softcap=softcap)
    out = _slash(False, q, k, v, tile_idx, tile_valid, vert, true_len,
                 q_block, k_tile, scale, softcap)
    slash_tile_attention.launches += 1
    return out


def slash_tile_attention_db(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tile_idx: torch.Tensor,
    tile_valid: torch.Tensor,
    vert: torch.Tensor,
    true_len: torch.Tensor,
    *,
    q_block: int = 512,
    k_tile: int = 256,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
):
    """:func:`slash_tile_attention` over only the valid prefix of each list
    (valid-first order, as ``_slash_tile_selection``'s top-k gives it), the
    next sub-tile's K/V copy in flight while the current one is used."""
    if q.device.type == "cpu":
        return slash_tile_attention_plain(
            q, k, v, tile_idx, tile_valid, vert, true_len, q_block=q_block,
            k_tile=k_tile, scale=scale, softcap=softcap)
    out = _slash(True, q, k, v, tile_idx, tile_valid, vert, true_len,
                 q_block, k_tile, scale, softcap)
    slash_tile_attention_db.launches += 1
    return out


def vertical_attention_partials(
    q: torch.Tensor,
    k_vert: torch.Tensor,
    v_vert: torch.Tensor,
    vcol: torch.Tensor,
    vvalid: torch.Tensor,
    true_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
):
    """Partials of every query against its head's Vs gathered vertical
    columns, visible where ``vcol <= row & vvalid``.  q: [B, H, N, D];
    k_vert, v_vert: [B, H, Vs, D] bf16; vcol int32 / vvalid bool
    [B, H, Vs]."""
    if q.device.type == "cpu":
        return vertical_attention_partials_plain(
            q, k_vert, v_vert, vcol, vvalid, true_len, scale=scale,
            softcap=softcap)
    _check_card(q, softcap)
    b, h, n, d = q.shape
    vs = k_vert.shape[2]
    if (k_vert.shape != (b, h, vs, d) or v_vert.shape != k_vert.shape
            or vcol.shape != (b, h, vs) or vvalid.shape != vcol.shape):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_vert "
                         f"{tuple(k_vert.shape)} v_vert {tuple(v_vert.shape)}"
                         f" vcol {tuple(vcol.shape)} vvalid "
                         f"{tuple(vvalid.shape)}")
    if d != HEAD_DIM or n % TILE or vs % TILE or vs < 1:
        raise ValueError(f"kernel takes D == {HEAD_DIM}, N and Vs multiples "
                         f"of {TILE}; got D={d} N={n} Vs={vs}")
    bf = torch.bfloat16
    _check_operands((("q", q, bf), ("k_vert", k_vert, bf),
                     ("v_vert", v_vert, bf), ("vcol", vcol, torch.int32),
                     ("vvalid", vvalid, torch.bool)), q.device)
    acc, m, l = _outputs(q)
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _build.library("block_sparse_prefill")
    err = lib.pkv_vertical_partials(
        q.data_ptr(), k_vert.data_ptr(), v_vert.data_ptr(), vcol.data_ptr(),
        vvalid.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h,
        n, vs, float(sc), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vertical_partials")
    vertical_attention_partials.launches += 1
    return acc, m, l


#: kernel launches since the last reset (CPU calls do not count)
slash_tile_attention.launches = 0
slash_tile_attention_db.launches = 0
vertical_attention_partials.launches = 0
