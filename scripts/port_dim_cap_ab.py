#!/usr/bin/env python3
"""The H2O and block-sparse kernels at head dims 128 and 256 against the
parent commit's builds of ``csrc/h2o_scores.cu`` and
``csrc/block_sparse_prefill.cu``, on one CUDA card.

    python3 scripts/port_dim_cap_ab.py --parent DIR [--log FILE]

``DIR`` holds the parent commit's two sources (``git show
HEAD~1:pyramidkv_tpu_torch/csrc/h2o_scores.cu`` and
``.../block_sparse_prefill.cu``, written to a directory inside the
repository), and its ``hopper.cuh`` where it has one (else the package's
is used).  Their C entries are bound and called with the package's
signatures (``_build.ENTRY_POINTS``).  The script builds them with the
package's nvcc flags, then, on the inputs of ``chip_smoke.py``'s "8k" H2O
case (B=4, 32 / 8 heads of D = 128, true_len 8000/6000/3000/1000, W = 8),
its "gemma 8k" case (16 / 8 heads of D = 256, scale 1/16, cap 50) and its
"8k" and "32k" MInference cases (the pattern ``estimate_vertical_slash``
makes from seeded random q/k), calls each C entry of both builds on the
same prepared inputs (the kernels' query, the packed vertical bits, the
sorted columns: the wrappers' work, done once), compares the outputs bit
for bit, and times both builds in turns (parent, package, package, parent:
device ms a call, CUDA events over 3 calls for H2O and 10 for the
block-sparse kernels).

Prints the card's name and power limit, then one JSON line per kernel and
shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the libraries compared
LIBS = ("h2o_scores", "block_sparse_prefill")


def build_parent(src_dir: str, name: str, out_dir: str) -> ctypes.CDLL:
    from pyramidkv_tpu_torch.kernels import _build

    src = os.path.join(out_dir, f"{name}.cu")
    with open(os.path.join(src_dir, f"{name}.cu")) as f:
        text = f.read()
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"lib{name}_parent.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-I",
                    _build.CSRC, "-o", lib, src], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(lib)
    for symbol, argtypes in _build.ENTRY_POINTS[name]:
        fn = getattr(dll, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--log")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch import kernels
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.kernels import block_sparse_prefill as bsp
    from pyramidkv_tpu_torch.kernels.h2o_scores import kernel_query
    from pyramidkv_tpu_torch.ops import sparse_prefill as sp

    if not torch.cuda.is_available():
        print("port_dim_cap_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = [open(args.log, "a")] if args.log else []

    def log(rec):
        line = json.dumps({"card": smi, **rec})
        print(line, flush=True)
        for f in out:
            f.write(line + "\n")

    dev = torch.device("cuda", 0)
    _build.build_all(["h2o_scores", "block_sparse_prefill"])
    with tempfile.TemporaryDirectory() as tmp:
        par = {n: build_parent(args.parent, n, tmp) for n in LIBS}
    lib_n = {n: _build.library(n) for n in LIBS}

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def turns(fp, fn, reps_fn):
        """parent, package, package, parent: (parent ms, package ms)."""
        a = [reps_fn(fp)]
        b = [reps_fn(fn), reps_fn(fn)]
        a.append(reps_fn(fp))
        return sum(a) / 2, sum(b) / 2

    ev = lambda fn: cs.time_ms(torch, fn, reps=3)  # noqa: E731
    f32 = dict(dtype=torch.float32, device=dev)
    # H2O at the 8k batch: Llama-3-8B's D = 128, Gemma-2-9B's D = 256 capped
    for case, d, scale, cap, q_std in (
            ("8k", 128, None, None, 1.0),
            ("gemma 8k", cs.GEMMA_D, cs.GEMMA_SCALE, cs.GEMMA_CAP,
             cs.GEMMA_Q_STD)):
        b, h, hk, n, true_len, w, _, _ = {**cs.H2O_CASES,
                                          **cs.GEMMA_H2O_CASES}[case]
        g = torch.Generator(device=dev).manual_seed(0)
        q = (cs._rand_bf16(torch, g, dev, b, h, n, d).float() * q_std).to(
            torch.bfloat16)
        k = cs._rand_bf16(torch, g, dev, b, hk, n, d)
        tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
        qs, mult = kernel_query(q, scale, cap)
        tail = (b, h, hk, d, n, w, cap or 0.0, mult)

        def stats(new):
            m = torch.empty((b, h, n), **f32)
            l = torch.empty((b, h, n), **f32)
            lib = (lib_n if new else par)["h2o_scores"]
            assert lib.pkv_h2o_stats(
                qs.data_ptr(), k.data_ptr(), tl.data_ptr(), m.data_ptr(),
                l.data_ptr(), *tail, stream()) == 0
            return m, l

        m_p, l_p = stats(False)
        m_n, l_n = stats(True)

        def colsum(new):
            o = torch.empty((b, h, n - w), **f32)
            lib = (lib_n if new else par)["h2o_scores"]
            assert lib.pkv_h2o_colsum(
                qs.data_ptr(), k.data_ptr(), tl.data_ptr(), m_p.data_ptr(),
                l_p.data_ptr(), o.data_ptr(), *tail, stream()) == 0
            return o

        cs_p, cs_n = colsum(False), colsum(True)
        # the package's wrappers give the same bits
        kw = dict(window_size=w, true_len=tl, scale=scale, softcap=cap)
        wm, wl = kernels.h2o_row_stats(q, k, **kw)
        wrap_same = (torch.equal(wm, m_n) and torch.equal(wl, l_n) and
                     torch.equal(kernels.h2o_colsum(q, k, m_p, l_p, **kw),
                                 cs_n))
        torch.cuda.synchronize()
        for name, same, fp, fn in (
                ("h2o_row_stats",
                 torch.equal(m_p, m_n) and torch.equal(l_p, l_n),
                 lambda: stats(False), lambda: stats(True)),
                ("h2o_colsum", torch.equal(cs_p, cs_n),
                 lambda: colsum(False), lambda: colsum(True))):
            ms_p, ms_n = turns(fp, fn, ev)
            log({"kernel": name, "case": case, "D": d, "softcap": cap,
                 "bitwise_equal": same, "wrapper_bitwise_equal": wrap_same,
                 "parent_ms": ms_p, "ms": ms_n, "ratio": ms_n / ms_p})
        del q, k, qs, m_p, l_p, m_n, l_n, cs_p, cs_n, wm, wl
        torch.cuda.empty_cache()

    # the block-sparse kernels at the 8k and 32k MInference shapes, D = 128
    ev10 = lambda fn: cs.time_ms(torch, fn, reps=10)  # noqa: E731
    d = 128
    for seed, case in enumerate(("8k", "32k")):
        (b, h, hk, n, true_len, budgets, qb, kt, budget, _, _,
         _) = cs.SPARSE_CASES[case]
        g = torch.Generator(device=dev).manual_seed(100 + seed)
        q = torch.randn((b, h, n, d), generator=g, device=dev).to(
            torch.bfloat16)
        k = torch.randn((b, hk, n, d), generator=g, device=dev).to(
            torch.bfloat16)
        v = torch.randn((b, hk, n, d), generator=g, device=dev).to(
            torch.bfloat16)
        tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
        pat = sp.estimate_vertical_slash(
            q, k, true_len=tl, **cs.sparse_budgets(torch, dev, budgets))
        ti, tv = sp._slash_tile_selection(pat, n, qb, kt, budget)
        kv, vv = sp.gather_vertical_kv(k, v, pat.vert_idx)
        sc = d ** -0.5

        def outs():
            return (torch.empty((b, h, n, d), **f32),
                    torch.empty((b, h, n), **f32),
                    torch.empty((b, h, n), **f32))

        vbits = bsp.pack_vertical_bits(pat.vert)
        order, keys, counts = bsp.sort_vertical_columns(
            pat.vert_idx, pat.vert_valid, n)
        ks, vs_ = torch.empty_like(kv), torch.empty_like(vv)

        def slash(new):
            acc, m, l = outs()
            lib = (lib_n if new else par)["block_sparse_prefill"]
            assert lib.pkv_slash_tiles(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ti.data_ptr(),
                tv.data_ptr(), vbits.data_ptr(), tl.data_ptr(),
                acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, hk, d, n,
                qb, kt, ti.shape[-1], vbits.shape[-1], sc, 0.0,
                stream()) == 0
            return acc, m, l

        def vert(new):
            acc, m, l = outs()
            lib = (lib_n if new else par)["block_sparse_prefill"]
            assert lib.pkv_vertical_partials(
                q.data_ptr(), kv.data_ptr(), vv.data_ptr(), order.data_ptr(),
                keys.data_ptr(), counts.data_ptr(), ks.data_ptr(),
                vs_.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                b, h, d, n, kv.shape[2], keys.shape[-1], sc, 0.0,
                stream()) == 0
            return acc, m, l

        for name, fn in (("slash_tile_attention", slash),
                         ("vertical_attention_partials", vert)):
            got_p, got_n = fn(False), fn(True)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got_p, got_n))
            del got_p, got_n
            ms_p, ms_n = turns(lambda: fn(False), lambda: fn(True), ev10)
            log({"kernel": name, "case": case, "D": d,
                 "bitwise_equal": same, "parent_ms": ms_p, "ms": ms_n,
                 "ratio": ms_n / ms_p})
        del q, k, v, kv, vv, pat, ti, tv, ks, vs_
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
