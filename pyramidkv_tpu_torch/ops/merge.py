"""KV merging (counterpart of ``pyramidkv_tpu/ops/merge.py``): LOOK-M's
pivot merge and the banded solve behind CAM's value merging.

- :func:`pivot_merge` folds every evicted past row into its nearest (cosine)
  kept row, per head: each kept row becomes the mean of itself and the
  pairwise means (evicted + kept) / 2 assigned to it.  The JAX package
  builds the ``[B, H, N - W, width + W]`` similarity and its one-hot in one
  piece; at the 8k batch of Llama-3-8B widths each is ~8.6 GB a layer, so
  here the nearest pool row is taken for a block of evicted rows at a time
  and the pairwise means are added into the pool with ``index_add``-style
  scatters (exact up to the order of the f32 sums).
- :func:`cam_banded_solve` solves CAM's recurrence
  ``u[j] = v[j] + sum_{s=j-r}^{j-1} c[s] u[s]`` over chunks of r rows.
  Each chunk is ``u_i = T_i^-1 (v_i + P_i u_{i-1})`` with ``T_i`` unit
  lower triangular; the JAX package runs it as a sequential scan of
  triangular solves.  Here every ``T_i^-1`` comes from one batched
  triangular solve and the chain ``u_i = A_i u_{i-1} + b_i`` from a
  doubling scan (log2 of the chunk count batched products), so a long
  prompt costs a few dozen launches instead of one loop step per chunk.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .selection import Selection

#: f32 elements of one block of :func:`pivot_merge`'s similarity (256 MiB)
PIVOT_BLOCK_ELEMS = 1 << 26


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


def pivot_merge(
    k: torch.Tensor,
    v: torch.Tensor,
    sel: Selection,
    *,
    window_size: int,
    true_len: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold evicted entries into their most similar kept entry.

    k, v: [B, H, N, D] left-padded, per selection head; ``sel`` selects
    over the N - W past columns.  Returns (k, v) [B, H, N, D] in k's dtype
    with the kept past rows and the window rows replaced by their merge
    results (evicted rows are left as they were: compaction drops them).
    The nearest-row search takes as many past rows a block as keep its
    similarity within ``PIVOT_BLOCK_ELEMS``."""
    b, h, n, d = k.shape
    w = window_size
    npast = n - w
    width = sel.indices.shape[-1]
    dev = k.device
    col = torch.arange(npast, device=dev)
    pad = (n - true_len).to(torch.int64)
    # past columns neither padding nor validly kept
    kept = torch.zeros((b, h, npast), dtype=torch.int32, device=dev)
    kept.scatter_add_(2, sel.indices, sel.valid.to(torch.int32))
    evicted = (col[None, None, :] >= pad[:, None, None]) & (kept == 0)

    kf, vf = k.float(), v.float()
    idx = sel.indices[..., None].expand(b, h, width, d)
    pool_k = torch.cat([torch.gather(kf[:, :, :npast], 2, idx),
                        kf[:, :, npast:]], dim=2)  # [B, H, M, D]
    pool_v = torch.cat([torch.gather(vf[:, :, :npast], 2, idx),
                        vf[:, :, npast:]], dim=2)
    win_valid = (torch.arange(npast, n, device=dev)[None, :]
                 >= pad[:, None])[:, None, :].expand(b, h, w)
    pool_valid = torch.cat([sel.valid, win_valid], dim=2)
    m = pool_k.shape[2]
    pool_unit = _unit(pool_k).transpose(-1, -2)  # [B, H, D, M]

    sum_k = torch.zeros_like(pool_k)
    sum_v = torch.zeros_like(pool_v)
    cnt = torch.zeros((b, h, m), dtype=torch.float32, device=dev)
    rows = max(1, PIVOT_BLOCK_ELEMS // max(b * h * m, 1))
    for r0 in range(0, npast, rows):
        r1 = min(r0 + rows, npast)
        kp, vp = kf[:, :, r0:r1], vf[:, :, r0:r1]
        sim = torch.matmul(_unit(kp), pool_unit)  # [B, H, R, M]
        sim = sim.masked_fill(~pool_valid[:, :, None, :], float("-inf"))
        nearest = sim.argmax(dim=-1)  # the first maximum, as jnp.argmax
        tgt = nearest[..., None].expand(-1, -1, -1, d)
        wgt = evicted[:, :, r0:r1, None].float()
        mk = (kp + torch.gather(pool_k, 2, tgt)) / 2.0 * wgt
        mv = (vp + torch.gather(pool_v, 2, tgt)) / 2.0 * wgt
        sum_k.scatter_add_(2, tgt, mk)
        sum_v.scatter_add_(2, tgt, mv)
        cnt.scatter_add_(2, nearest, wgt[..., 0])
    denom = (cnt + 1.0)[..., None]
    new_k = (pool_k + sum_k) / denom
    new_v = (pool_v + sum_v) / denom

    # the merged kept rows back at their columns; the window rows after
    k_out = torch.cat([kf[:, :, :npast], new_k[:, :, width:]], dim=2)
    v_out = torch.cat([vf[:, :, :npast], new_v[:, :, width:]], dim=2)
    bi, hi, si = sel.valid.nonzero(as_tuple=True)
    ci = sel.indices[bi, hi, si]
    k_out[bi, hi, ci] = new_k[bi, hi, si]
    v_out[bi, hi, ci] = new_v[bi, hi, si]
    return k_out.to(k.dtype), v_out.to(v.dtype)


def cam_banded_solve(v: torch.Tensor, c: torch.Tensor, r: int,
                     u_prev: torch.Tensor, c_prev: torch.Tensor):
    """Solve ``u[j] = v[j] + sum_{s=j-r}^{j-1} c[s] u[s]`` over one region,
    given the carry of the r rows before it.

    v: [B, H, L, D] f32 (L a multiple of r); c: [B, H, L] f32; u_prev /
    c_prev: [B, H, r, D] / [B, H, r], the final values and coefficients of
    the r rows before the region.  Returns (u [B, H, L, D],
    (u_last [B, H, r, D], c_last [B, H, r]))."""
    b, h, L, d = v.shape
    nc = L // r
    dev = v.device
    vc = v.reshape(b, h, nc, r, d)
    cc = c.reshape(b, h, nc, r)
    rows = torch.arange(r, device=dev)
    lower = (rows[:, None] > rows[None, :]).float()
    upper_inc = (rows[:, None] <= rows[None, :]).float()
    eye = torch.eye(r, device=dev)
    # chunk i: T_i u_i = v_i + P_i u_{i-1}, with P_i from the previous
    # chunk's coefficients (c_prev for the first)
    c_before = torch.cat([c_prev[:, :, None], cc[:, :, :-1]], dim=2)
    t_mat = eye - lower * cc[..., None, :]             # [B, H, nc, r, r]
    p_mat = upper_inc * c_before[..., None, :]
    t_inv = torch.linalg.solve_triangular(
        t_mat, eye.expand_as(t_mat), upper=False, unitriangular=True)
    a = torch.matmul(t_inv, p_mat)                     # u_{i-1} -> u_i
    rhs = vc.clone()
    rhs[:, :, 0] += torch.matmul(p_mat[:, :, 0], u_prev)
    u = torch.matmul(t_inv, rhs)                       # b_i
    # inclusive doubling scan of u_i = a_i u_{i-1} + b_i (u_{-1} folded in)
    s = 1
    while s < nc:
        u = torch.cat([u[:, :, :s],
                       torch.matmul(a[:, :, s:], u[:, :, :-s]) + u[:, :, s:]],
                      dim=2)
        if 2 * s < nc:
            a = torch.cat([a[:, :, :s], torch.matmul(a[:, :, s:],
                                                     a[:, :, :-s])], dim=2)
        s *= 2
    return u.reshape(b, h, L, d), (u[:, :, -1], cc[:, :, -1])
