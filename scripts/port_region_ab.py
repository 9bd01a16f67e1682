#!/usr/bin/env python3
"""The KIVI region kernels at head dims 128 and 256 against the parent
commit's builds of ``csrc/quant_decode.cu``, ``csrc/quant_group_fused.cu``
and ``csrc/quant_fused_decode.cu`` (with its ``quant_region.cuh``), on one
CUDA card.

    python3 scripts/port_region_ab.py --parent DIR [--log FILE]

``DIR`` holds the parent commit's four sources (``git show
HEAD~1:pyramidkv_tpu_torch/csrc/quant_region.cuh``, ``.../quant_decode.cu``,
``.../quant_group_fused.cu`` and ``.../quant_fused_decode.cu``, written to a
directory inside the repository), and its ``hopper.cuh`` where it has one
(else the package's is used).  Each library holds one mode (the f32 and
the folded group modes, the pa kernel), and the parent's entries are bound
and called with the package's signature (``_build._REGION``).  The script
builds them with the package's nvcc flags, then, on the region shapes of
``chip_smoke.py``'s KIVI runs (``KV_RUNS``: the 32k fullkv and snapkv
regions and the 8k batch's, group and pa, kivi4 and kivi2) plus the
chunked carry's 4 K groups, Qwen2.5-7B's G = 7 and Gemma-2-9B's capped
D = 256 group and pa regions (the 8k batch's snapkv kivi4 width, G = 1;
fullkv kivi4-pa, G = 2; scale 1/16, cap 50), calls each group mode and
the pa kernel of both builds with the step's bf16 tail on the same inputs
and plan, compares the outputs bit for bit, and times both builds in turns
(parent, package, package, parent: device ms a call from a CUDA graph of
50 calls).

Prints the card's name and power limit, then one JSON line per kernel and
shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: (library, symbol) of each mode, in the parent and the package alike
MODES = (("quant_decode", "pkv_quant_decode"),
         ("quant_group_fused", "pkv_quant_group_fused"),
         ("quant_fused_decode", "pkv_quant_fused_pa"))


def build_parent(src_dir: str, name: str, symbol: str,
                 out_dir: str) -> ctypes.CDLL:
    from pyramidkv_tpu_torch.kernels import _build

    for f in (f"{name}.cu", "quant_region.cuh"):
        with open(os.path.join(src_dir, f)) as src, \
                open(os.path.join(out_dir, f), "w") as dst:
            dst.write(src.read())
    lib = os.path.join(out_dir, f"lib{name}_parent.so")
    # the parent's namespace renamed: the launch templates' static flags
    # (the kernels' shared-memory attribute set once) are unique symbols
    # process-wide, so with one name the package's build would take the
    # parent's flag and never set its own kernels' attribute
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Dpkvq=pkvq_parent",
                    "-I", src_dir, "-I", _build.CSRC, "-o", lib,
                    os.path.join(out_dir, f"{name}.cu")],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(lib)
    fn = getattr(dll, symbol)
    fn.argtypes = _build._REGION
    fn.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--log")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.kernels import quant_decode as qd
    from pyramidkv_tpu_torch.kernels import quant_fused_decode as qfd
    from pyramidkv_tpu_torch.ops import quant

    if not torch.cuda.is_available():
        print("port_region_ab: no CUDA device", file=sys.stderr)
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
    _build.build_all(["quant_decode", "quant_group_fused",
                      "quant_fused_decode"])
    with tempfile.TemporaryDirectory() as tmp:
        par = {n: build_parent(args.parent, n, sym, tmp) for n, sym in MODES}
    f32 = dict(dtype=torch.float32, device=dev)

    def call(lib, symbol, new, q, reg, mask, nbits, plan, tail, cap=0.0,
             scale=None):
        """One region call with the tail: the layer's bf16 output."""
        b, h, d = q.shape
        kc, vc = reg.k.codes, reg.v.codes
        hk = kc.shape[1]
        w, s_pad, _, _ = quant.region_geometry(reg, nbits)
        ng, ngv, dp = reg.k.scale.shape[-2], reg.v.scale.shape[-2], \
            vc.shape[-1]
        nsplit, rows = plan
        g = h // hk
        ws = (torch.empty((b * hk * nsplit, g, d), **f32),
              torch.empty((b * hk * nsplit, g), **f32),
              torch.empty((b * hk * nsplit, g), **f32))
        tk, tv, tm = tail
        res = torch.empty_like(q)
        mid = [b * hk, d, g, nbits, w, s_pad, ng, dp, ngv, mask.stride(1),
               mask.shape[-1], nsplit, rows, scale or 1.0 / math.sqrt(d), cap]
        fn = getattr(_build.library(lib) if new else par[lib], symbol)
        err = fn(q.data_ptr(), kc.data_ptr(), reg.k.scale.data_ptr(),
                 reg.k.zero.data_ptr(), vc.data_ptr(), reg.v.scale.data_ptr(),
                 reg.v.zero.data_ptr(), mask.data_ptr(), None, None, None,
                 *(x.data_ptr() for x in ws), *mid, tk.data_ptr(),
                 tv.data_ptr(), tm.data_ptr(), tm.shape[-1], tm.stride(1),
                 res.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        assert err == 0, (symbol, new, err)
        return res

    def turns(fp, fn):
        """parent, package, package, parent: (parent ms, package ms)."""
        a = [cs.graph_ms(torch, fp, reps=50)]
        b = [cs.graph_ms(torch, fn, reps=50), cs.graph_ms(torch, fn,
                                                          reps=50)]
        a.append(cs.graph_ms(torch, fp, reps=50))
        return sum(a) / 2, sum(b) / 2

    # (label, layout, B, Hk, G, slots, nbits, tail, K chunk)
    shapes = []
    for run, (_, _, _, layout, size, _) in cs.KV_RUNS.items():
        _, b, hm, grp, sp, nbits, _ = cs.kv_shape(run)
        t_len = cs.QMAX_NEW if size == "32k" else cs.MAX_NEW
        shape = (layout, b, hm, grp, sp, nbits, t_len, None)
        if shape not in [s[1:] for s in shapes]:
            shapes.append((run, *shape))
    shapes += [("32k fullkv kivi4-pa chunk 8192", "pa", 1, cs.HK,
                cs.H // cs.HK, cs.QN, 4, cs.QMAX_NEW, 8192),
               ("qwen fullkv kivi4 8k width", "group", cs.B, 4, 7, cs.N, 4,
                cs.MAX_NEW, None)]
    shapes = [(*x, 128) for x in shapes]
    # Gemma-2-9B's capped D = 256 regions
    shapes += [("gemma snapkv kivi4 8k width, D=256", "group", cs.B, 16, 1,
                2048, 4, cs.MAX_NEW, None, 256),
               ("gemma fullkv kivi4-pa 8k width, D=256", "pa", cs.B, 8, 2,
                cs.N, 4, cs.MAX_NEW, None, 256)]
    for seed, (label, layout, b, hk, grp, s, nbits, t_len, k_chunk, d) in \
            enumerate(shapes, start=1):
        akw = dict(cap=50.0, scale=1.0 / 16) if d == 256 else {}
        q, reg, mask, tail = cs.region_inputs(
            torch, dev, b, hk, grp, s, nbits, 64, layout, t_len, seed,
            k_chunk=k_chunk, d=d, q_std=4.0 if d == 256 else 1.0)
        w, _, kg, _ = quant.region_geometry(reg, nbits)
        for lib, symbol in MODES:
            if (layout == "pa") != (lib == "quant_fused_decode"):
                continue
            if layout == "pa":
                plan = qfd.pa_split_plan(dev, b * hk, w,
                                         kg if kg <= w else 0, d)
            else:
                plan = qd.split_plan(dev, b * hk, w, nbits, kg, d)

            def fp(lib=lib, symbol=symbol, plan=plan):
                return call(lib, symbol, False, q, reg, mask, nbits, plan,
                            tail, **akw)

            def fn(lib=lib, symbol=symbol, plan=plan):
                return call(lib, symbol, True, q, reg, mask, nbits, plan,
                            tail, **akw)

            same = torch.equal(fp(), fn())
            ms_p, ms_n = turns(fp, fn)
            log({"kernel": symbol, "case": label, "layout": layout, "B": b,
                 "Hk": hk, "G": grp, "S": s, "D": d, "nbits": nbits,
                 "tail": t_len,
                 "plan": list(plan), "bitwise_equal": same,
                 "parent_ms": ms_p, "ms": ms_n, "ratio": ms_n / ms_p})
        del q, reg, mask, tail
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
