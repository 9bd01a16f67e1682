#!/usr/bin/env python3
"""Time the int4 decode matmul kernel (``csrc/int4_matmul.cu``) on
candidate plans and on edited copies of its source, on one CUDA card.

    python3 scripts/port_int4_plans.py [--edits FILE] [--plans FILE]
                                       [--shapes NAMES] [--rows 1,8]
                                       [--log FILE]

``--plans``: a JSON list of plan overrides ({"ncol": 2, "ks": 64, ...}; the
keys of ``Int4Plan``; ``cluster`` recomputes the slice), each timed beside
the default plan of ``int4_tile_plan``.  ``--edits``: a JSON object
{variant name: [[old text, new text], ...]}, each built from an edited copy
of the source and timed on the default plan (for example a copy whose
consumers skip the products, or whose producer copies nothing, to part the
time of the copies from that of the products).  Every call is held to the
plain version (``chip_smoke.MM_TOL``) unless its edit breaks the
arithmetic on purpose (a name starting with ``no``); times come from a CUDA
graph of 50 calls, the builds in turns (tree, variants..., tree).
``--shapes``: names of ``chip_smoke.LLAMA_MM`` (default: the five int4
shapes, lm_head4 with f32 x as the engine calls it) plus the g128 layer
shapes as ``NAME:g128``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_SHAPES = "wqkv,wo,w_gateup,w_down,lm_head4,w_down:g128,w_gateup:g128"


def build_variant(name: str, edits, out_dir: str):
    """An edited copy of csrc/int4_matmul.cu built with the package's nvcc
    flags, bound as the package binds its own."""
    from pyramidkv_tpu_torch.kernels import _build

    with open(os.path.join(_build.CSRC, "int4_matmul.cu")) as f:
        src = f.read()
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(out_dir, f"lib{name}.so")
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                             _build.CSRC, "-o", out, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def bind(path: str):
    from pyramidkv_tpu_torch.kernels import _build

    lib = ctypes.CDLL(path)
    for symbol, argtypes in _build.ENTRY_POINTS["int4_matmul"]:
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edits", help="JSON file of source variants")
    ap.add_argument("--plans", help="JSON file of plan overrides")
    ap.add_argument("--shapes", default=DEFAULT_SHAPES)
    ap.add_argument("--rows", default="1")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch.kernels import _build

    im = importlib.import_module("pyramidkv_tpu_torch.kernels.int4_matmul")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    edits = json.load(open(args.edits)) if args.edits else {}
    overrides = json.load(open(args.plans)) if args.plans else []
    tmp = tempfile.mkdtemp()
    procs = {n: build_variant(n, e, tmp) for n, e in edits.items()}
    tree = _build.library("int4_matmul")
    libs = {"tree": tree}
    for n, (p, out) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(log[-3000:], file=sys.stderr)
            return 1
        libs[n] = bind(out)
    turns = ["tree", *edits, "tree"]
    out_f = open(args.log, "a") if args.log else None

    def emit(rec):
        line = json.dumps({**rec, "device": smi})
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    ok = True
    seed = 800
    for item in args.shapes.split(","):
        shape, _, fmt = item.partition(":")
        gs = 128 if fmt == "g128" else 0
        i, o = cs.LLAMA_MM[shape]
        xdt = "f32" if shape.startswith("lm_head") else "bf16"
        for rows in map(int, args.rows.split(",")):
            g = torch.Generator(device=dev).manual_seed(seed)
            seed += 1
            codes = torch.randint(-128, 128, (i, o // 2), generator=g,
                                  device=dev, dtype=torch.int8)
            scale = (0.5 + torch.rand((i // gs, o) if gs else (o,),
                                      generator=g, device=dev)) / (
                7.0 * i ** 0.5)
            x = torch.randn((rows, i), generator=g, device=dev).to(
                torch.bfloat16 if xdt == "bf16" else torch.float32)
            want = im.int4_matmul_plain(x, codes, scale, group_size=gs)
            nbytes = (codes.numel() + scale.numel() * 4 + x.numel()
                      * x.element_size() + want.numel() * want.element_size())
            bound_ms, _ = cs.bound(2.0 * rows * i * o, nbytes,
                                   cs.PEAK_BF16_FLOPS if xdt == "bf16"
                                   else cs.PEAK_F32_FLOPS)
            base = im.int4_tile_plan(rows, i, o // 2, gs, sms, xdt == "f32")
            plans = [("default", base)]
            for ov in overrides:
                p = base._replace(**{k: v for k, v in ov.items()
                                     if k != "cluster"})
                if "ncol" in ov and "kw" not in ov:
                    p = p._replace(kw=max(1, 8 // p.ncol))
                if "cluster" in ov:
                    unit = p.ks * gs // math.gcd(p.ks, gs) if gs else p.ks
                    sl = -(-i // (ov["cluster"] * unit)) * unit
                    p = p._replace(slice=sl, cluster=-(-i // sl))
                if gs and p.ss_rows:
                    p = p._replace(ss_rows=p.slice // gs)
                p = p._replace(smem=im.int4_smem_bytes(
                    p.ncol, p.kw, p.ks, p.stages, p.cluster, p.slice, p.rp,
                    p.ss_rows, xdt == "f32", gs),
                    blocks=p.cluster * -(-(o // 2) // (64 * p.ncol)))
                plans.append((json.dumps(ov, sort_keys=True), p))
            for label, plan in plans:
                for build in (turns if label == "default" else ["tree"]):
                    _build._loaded["int4_matmul"] = libs[build]

                    def call():
                        return im._launch_int4(x, codes, scale.float(), plan,
                                               gs)
                    try:
                        got = call()
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        emit({"shape": item, "rows": rows, "plan": label,
                              "build": build, "error": str(e)})
                        continue
                    r = cs.err_over_tol(got, want, *cs.MM_TOL[xdt])
                    if not build.startswith("no"):
                        ok &= r <= 1
                    emit({"shape": item, "rows": rows, "x": xdt,
                          "plan": label, "build": build,
                          "plan_fields": plan._asdict(),
                          "err_over_tol": r, "bound_ms": bound_ms,
                          "ms": cs.graph_ms(torch, call, reps=50)})
            _build._loaded["int4_matmul"] = tree
            del codes, scale, x, want
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
