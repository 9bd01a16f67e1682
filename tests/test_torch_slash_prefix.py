"""The port's two slash functions on tile lists that are not valid-first,
against the JAX package, on the CPU.

JAX's ``slash_tile_attention`` visits every list entry and skips the
invalid ones; its ``slash_tile_attention_db`` (``_db_kernel``) visits the
first ``nval = tile_valid.sum(-1)`` entries, whatever their flags.  On the
engine's lists (valid-first, from ``_slash_tile_selection``'s top-k) the
two are one function; on other lists they differ.  The port's
``slash_tile_attention_db`` computes the slash function over
``valid_prefix(tile_valid)`` (``arange(T) < nval``) to stay JAX's db
function on every list; its plain version runs here.

Inputs are those of ``tests/test_torch_minference.py``'s slash test (B=1,
H=4, Hk=2, N=128, D=16, q_block = k_tile = 16, budget 3), made with numpy
from a seed, with each list's entries put in a seeded random order or
reversed (invalid entries among or before valid ones).  JAX's kernels run
in interpret mode.

Tolerances:
- against JAX, those of ``tests/test_torch_minference.py``: f32 partials
  within 2e-5 (the same f32 terms summed in other orders), bf16 within one
  bf16 ulp of the row (2^-7 of its largest element: p is rounded at the
  same running max on both sides);
- ``slash_tiled_plain`` (the CUDA kernel's schedule) runs at 64-key units,
  so at a shape of 64-row q-blocks of 64-key tiles, with the limits of
  ``tests/test_torch_sparse_tiles.py``: f32 within 2e-5; bf16 acc / l
  within 2^-6 |want| + 2^-5 rms(row), m within 2^-12 max(1, |m|), l within
  2^-10 l (P rounded at each 128-key tile's running max, not each k-tile's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramidkv_tpu.kernels import block_sparse_prefill as jk
from pyramidkv_tpu.ops import sparse_prefill as js
from pyramidkv_tpu_torch.kernels import block_sparse_prefill as tk
from pyramidkv_tpu_torch.ops import sparse_prefill as ts
from test_torch_minference import _assert_partials_close
from test_torch_sparse_tiles import _check_partials
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: the slash test's shape: GQA, 8 q-blocks of 8 k-tiles, budget 3
B, H, HK, N, D, QB, KT, BUDGET = 1, 4, 2, 128, 16, 16, 16, 3


def _reorder(ti, tv, order, seed):
    """Each list's entries in a seeded random order ("permuted") or
    reversed."""
    if order == "reversed":
        perm = np.broadcast_to(np.arange(ti.shape[-1])[::-1], ti.shape)
    else:
        perm = np.argsort(np.random.default_rng(seed).random(ti.shape),
                          axis=-1)
    return (np.ascontiguousarray(np.take_along_axis(ti, perm, -1)),
            np.ascontiguousarray(np.take_along_axis(tv, perm, -1)))


def _not_valid_first(tv) -> bool:
    """Some list holds an invalid entry before a valid one."""
    return bool((np.sort(tv, axis=-1)[..., ::-1] != tv).any())


def _inputs(true_len, order, *, b=B, h=H, hk=HK, n=N, d=D, q_block=QB,
            k_tile=KT, budget=BUDGET, seed=11):
    """(q, k, v) f32 numpy, the JAX pattern's vert, and reordered tile
    lists (numpy) of JAX's tile selection."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    tl = np.asarray(true_len if isinstance(true_len, tuple)
                    else (true_len,) * b, np.int32)
    pat = js.estimate_vertical_slash(jnp.asarray(q), jnp.asarray(k),
                                     true_len=jnp.asarray(tl),
                                     vertical_size=12, slash_size=8,
                                     last_q=8)
    ti, tv = js._slash_tile_selection(pat, n, q_block, k_tile, budget)
    ti, tv = _reorder(np.asarray(ti), np.asarray(tv), order, seed + n)
    assert _not_valid_first(tv)
    return (q, k, v), np.array(pat.vert), ti, tv, tl


def _both(qkv, vert, ti, tv, tl, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = (*(jnp.asarray(x, jdt) for x in qkv), jnp.asarray(ti),
             jnp.asarray(tv), jnp.asarray(vert), jnp.asarray(tl))
    targs = (*(torch.from_numpy(x).to(tdt) for x in qkv),
             torch.from_numpy(ti), torch.from_numpy(tv),
             torch.from_numpy(vert), torch.from_numpy(tl))
    return jargs, targs


def _out(part):
    acc, _, l = (x.double() for x in part)
    return acc / l.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("kind", ["grid", "db"])
@pytest.mark.parametrize("order", ["permuted", "reversed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("true_len", [128, 100])
def test_slash_matches_jax_on_lists_not_valid_first(kind, order, dtype,
                                                     true_len):
    """The port's slash_tile_attention / slash_tile_attention_db on the CPU
    against JAX's function of the same name."""
    qkv, vert, ti, tv, tl = _inputs(true_len, order)
    jargs, targs = _both(qkv, vert, ti, tv, tl, dtype)
    kw = dict(q_block=QB, k_tile=KT)
    port, jax_fn = ((tk.slash_tile_attention, jk.slash_tile_attention)
                    if kind == "grid" else
                    (tk.slash_tile_attention_db, jk.slash_tile_attention_db))
    got = port(*targs, **kw)
    want = jax_fn(*jargs, interpret=True, **kw)
    _assert_partials_close(got, want, dtype)
    if kind == "db":  # the plain version over the prefix, bit for bit
        plain = ts.slash_tile_attention_plain(
            *targs[:4], tk.valid_prefix(targs[4]), *targs[5:], **kw)
        for a, b_ in zip(got, plain):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("order", ["permuted", "reversed"])
def test_db_differs_from_grid_on_lists_not_valid_first(order):
    """The case bites: on these lists the two functions are apart (a db
    that read the flags entry by entry would pass the test above only if
    this one failed)."""
    qkv, vert, ti, tv, tl = _inputs(128, order)
    _, targs = _both(qkv, vert, ti, tv, tl, "float32")
    kw = dict(q_block=QB, k_tile=KT)
    grid = tk.slash_tile_attention(*targs, **kw)
    db = tk.slash_tile_attention_db(*targs, **kw)
    assert float((_out(db) - _out(grid)).abs().max()) > 0.1
    prefix = tk.valid_prefix(targs[4])
    assert not torch.equal(prefix, targs[4])
    assert torch.equal(prefix.sum(-1), targs[4].sum(-1))


#: (n, q_block, k_tile, budget, true_len, per-head budgets): the engine's
#: tile lists at several shapes
SELECT_CASES = [(128, 16, 16, 3, 128, False), (128, 16, 16, 3, 100, False),
                (256, 32, 16, 8, 200, True), (512, 128, 64, 4, 37, True),
                (384, 64, 64, 6, 384, False)]


@pytest.mark.parametrize("n,q_block,k_tile,budget,true_len,per_head",
                         SELECT_CASES)
def test_valid_prefix_is_the_flags_on_selected_lists(n, q_block, k_tile,
                                                     budget, true_len,
                                                     per_head):
    """On _slash_tile_selection's lists the prefix is tile_valid: the
    engine's slash call is unchanged."""
    rng = np.random.default_rng(n + budget)
    q = torch.from_numpy(rng.normal(size=(2, 4, n, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 2, n, 16)).astype(np.float32))
    bud = (dict(vertical_size=torch.tensor([8, 16, 4, 12], dtype=torch.int32),
                slash_size=torch.tensor([16, 8, 32, 24], dtype=torch.int32),
                max_vertical=16, max_slash=32)
           if per_head else dict(vertical_size=12, slash_size=16))
    pat = ts.estimate_vertical_slash(
        q, k, true_len=torch.tensor([n, true_len], dtype=torch.int32),
        last_q=8, **bud)
    ti, tv = ts._slash_tile_selection(pat, n, q_block, k_tile, budget)
    prefix = tk.valid_prefix(tv)
    assert prefix.dtype == torch.bool and prefix.is_contiguous()
    assert torch.equal(prefix, tv)
    assert not bool(tv.all())  # some lists are cut short


@pytest.mark.parametrize("order", ["permuted", "reversed"])
@pytest.mark.parametrize("bf16", [False, True])
def test_slash_tiled_over_prefix_matches_jax_db(order, bf16):
    """slash_tiled_plain (the CUDA kernel's schedule) over the prefix
    against JAX's db on reordered lists: 64-row q-blocks of 64-key tiles,
    a pad inside a unit, q tiles all padding."""
    b, h, hk, n, d = 2, 4, 2, 384, 32
    qkv, vert, ti, tv, tl = _inputs((n, 300), order, b=b, h=h, hk=hk, n=n,
                                    d=d, q_block=64, k_tile=64, budget=3)
    if bf16:  # round once, then hand both sides the same values
        qkv = tuple(torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                    for x in qkv)
    dtype = "bfloat16" if bf16 else "float32"
    jargs, targs = _both(qkv, vert, ti, tv, tl, dtype)
    kw = dict(q_block=64, k_tile=64)
    got = tk.slash_tiled_plain(*targs[:4], tk.valid_prefix(targs[4]),
                               *targs[5:], **kw)
    want = jk.slash_tile_attention_db(*jargs, interpret=True, **kw)
    _check_partials(got, want, bf16)
