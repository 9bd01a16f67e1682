#!/usr/bin/env python3
"""Time the port's pa-layout KIVI decode kernel against another build of
it, on one CUDA card.

    python3 scripts/port_pa_ab.py [--other DIR] [--variant DIR ...]
                                  [--log FILE]

At the three region shapes the engine runs give the pa kernel (bench.py's
32k fullkv kivi4-pa: B = 1, Hk = 8, G = 4; the 8k batch's snapkv kivi4-pa:
B = 4, Hk = 32, G = 1; run (e)'s chunked 32k kivi4-pa carry: 4 K groups of
8192 slots) it calls ``pkv_quant_fused_pa`` with the step's bf16 tail (the
decode step's call: split kernel and finish pass), holds the output to the
plain version (``chip_smoke.TAIL_TOL``), checks two calls bitwise equal and
times it in a CUDA graph of 50 calls, with each build in turns: other,
tree, tree, other (variants after the tree's turns).

- ``--other DIR``: a directory holding another ``quant_fused_decode.cu``
  and ``quant_region.cuh`` with the same C entry point and the earlier
  split plan (32-row chunks a warp, 8 warps, about 4 blocks an SM, splits
  cut to divide a K group), for example the parent commit's sources from
  ``git show``;
- ``--variant DIR``: an edited copy of this tree's two sources, on this
  tree's plan; a ``plan.json`` there ({"warps": W, "per_sm": P}) sets the
  plan's warps a block and blocks an SM to match the edit.

Prints one JSON line per (shape, build): ms per call (each turn),
err_over_tol, bitwise repeat, plan, the card's name and power limit.
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

#: label -> (chip_smoke KIVI run whose region shape it is, or None for run
#: (e)'s carry: B = 1, Hk = 8, G = 4, 32768 slots, K groups of 8192)
SHAPES = {
    "32k fullkv kivi4-pa": "int4 fullkv kivi4-pa 32k",
    "8k snapkv kivi4-pa": "bf16 snapkv kivi4-pa 8k",
    "(e) 32k kivi4-pa, 4 K groups": None,
}


def earlier_plan(bhk: int, w: int, kg: int, gk: int, sms: int):
    """The split plan the earlier pa kernel took: 32-row chunks, at least
    one a warp of 8, about 4 blocks an SM; with K groups, splits cut to
    divide a group."""
    chunks = -(-w // 32)
    want = max(1, min(chunks // 8, -(-4 * sms // bhk)))
    rows = 32 * -(-chunks // want)
    if gk > 1:
        rows = math.gcd(rows, kg)
    return -(-w // rows), rows


def build_lib(src_dir: str, out_dir: str, name: str):
    """``src_dir``/quant_fused_decode.cu (with its quant_region.cuh) built
    with the package's nvcc flags, bound as the package binds its own."""
    from pyramidkv_tpu_torch.kernels import _build

    out = os.path.join(out_dir, f"libpa_{name}.so")
    # -fno-gnu-unique: the kernels' function-local attribute flags stay in
    # this library (see scripts/port_region_plans.py)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
                    "-fno-gnu-unique", "-I", src_dir, "-I", _build.CSRC,
                    "-o", out,
                    os.path.join(src_dir, "quant_fused_decode.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    fn = lib.pkv_quant_fused_pa
    fn.argtypes = _build._REGION
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="directory of another build's sources")
    ap.add_argument("--variant", action="append", default=[],
                    help="directory of an edited copy of the sources")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.kernels import quant_decode as qd
    from pyramidkv_tpu_torch.kernels import quant_fused_decode as qfd
    from pyramidkv_tpu_torch.ops import quant

    if not torch.cuda.is_available():
        print("port_pa_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    tree_lib = _build.library("quant_fused_decode")
    # build -> (library, plan of (bhk, w, kg, gk))
    builds = {"tree": (tree_lib, None)}
    if args.other:
        builds["other"] = (build_lib(args.other, tmp, "other"),
                           lambda bhk, w, kg, gk: earlier_plan(bhk, w, kg, gk,
                                                               sms))
    for i, path in enumerate(args.variant):
        knobs = {}
        if os.path.exists(os.path.join(path, "plan.json")):
            with open(os.path.join(path, "plan.json")) as f:
                knobs = json.load(f)
        builds[path] = (build_lib(path, tmp, f"variant{i}"), knobs)
    turns = (["other"] if args.other else []) + ["tree"] + args.variant + [
        "tree"] + (["other"] if args.other else [])

    def plan_of(build, bhk, w, kg, gk):
        spec = builds[build][1]
        if callable(spec):
            return spec(bhk, w, kg, gk)
        saved, orig = qfd.PA_WARPS, qfd._sm_count
        qfd.PA_WARPS = (spec or {}).get("warps", saved)
        per_sm = (spec or {}).get("per_sm", 2)
        # the plan fills one wave of `per_sm` blocks an SM
        qfd._sm_count = lambda d: orig(d) * per_sm // 2
        try:
            return qfd.pa_split_plan(dev, bhk, w, kg if gk > 1 else 0)
        finally:
            qfd.PA_WARPS, qfd._sm_count = saved, orig

    out_f = open(args.log, "a") if args.log else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    ok = True
    for seed, (label, run) in enumerate(SHAPES.items(), start=950):
        if run is None:
            b, hk, g, s, t_len, k_chunk = (1, cs.HK, cs.H // cs.HK, cs.QN,
                                           cs.QMAX_NEW, cs.C32K)
        else:
            _, b, hk, g, s, _, _ = cs.kv_shape(run)
            t_len = cs.QMAX_NEW if run.endswith("32k") else cs.MAX_NEW
            k_chunk = None
        q, reg, mask, tail = cs.region_inputs(torch, dev, b, hk, g, s, 4, 64,
                                              "pa", t_len, seed,
                                              k_chunk=k_chunk)
        w, s_pad, kg, _ = quant.region_geometry(reg, 4)
        gk = reg.k.scale.shape[-2]
        want = quant.merge_tail(quant.quant_region_attention_fused(
            q, reg, mask, nbits=4), q, tail).float()
        recs = {}
        for build in turns:
            lib = builds[build][0]
            plan = plan_of(build, b * hk, w, kg, gk)
            _build._loaded["quant_fused_decode"] = lib

            def call():
                return qd.launch_region("pkv_quant_fused_pa",
                                        "quant_fused_decode", q, reg, mask, 4,
                                        plan, tail=tail, workspace=True)

            rec = recs.setdefault(build, {
                "shape": label, "build": build, "B": b, "Hk": hk, "G": g,
                "S_pad": s_pad, "k_groups": gk, "tail": t_len,
                "nsplit": plan[0], "rows": plan[1], "device": smi,
                "ms": []})
            got = call()
            again = call()
            torch.cuda.synchronize()
            rec["err_over_tol"] = cs.err_over_tol(got.float(), want,
                                                  *cs.TAIL_TOL["folded"])
            rec["repeat_bitwise"] = bool(torch.equal(got, again))
            rec["ms"].append(cs.graph_ms(torch, call, reps=50))
        _build._loaded["quant_fused_decode"] = tree_lib
        for rec in recs.values():
            ok &= rec["err_over_tol"] <= 1 and rec["repeat_bitwise"]
            emit(rec)
        del q, reg, mask, tail
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
