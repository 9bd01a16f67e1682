#!/usr/bin/env python3
"""Where the int4 decode matmul kernel's time goes, from clock stamps inside
it, on one CUDA card.

    python3 scripts/port_int4_stamps.py [--shapes NAMES] [--log FILE]

Builds a copy of ``csrc/int4_matmul.cu`` whose first consumer thread of
every block writes ``%globaltimer`` (ns) at seven points of a pass into a
``__device__`` array: the block's start, its barriers initialised, x (and
group scales) staged, the first ring stage landed, the last stage's
products done, the cluster's barrier (every rank's partial at rank 0), rank
0's sum written.  Calls the
kernel once to warm up and once stamped, at rows 1, and prints per shape the
median over blocks of each phase's length, the spread of block starts and
ends, and the whole span (first start to last end), beside the plain
(unstamped) kernel's CUDA-graph time.  ``--shapes``: as
``scripts/port_int4_plans.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

#: stamp k is written after the anchor text (k, anchor)
STAMPS = [
    (0, "  const int psz = a.rp * 2 * sb;  // floats of a warp's (and a rank's) "
        "partial\n"),
    (1, "  int seq = 0;  // stages of earlier passes (the ring's running count)\n"),
    (2, "      asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
        "      named_bar_sync(1, nthr);\n"),
    (4, "      if (GROUPED && cur >= 0) flush(acc, frag, a, ss, cur, g_lo, sb, cb, "
        "j0);\n"),
    (5, "    cl.sync();  // every rank's partial has reached rank 0\n"),
]
PHASES = ["init", "stage x", "first stage", "products", "to cluster barrier",
          "rank 0 sum", "end"]


def stamped_source(src: str) -> str:
    head = ("__device__ unsigned long long pkv_stamp[8 * 65536];\n"
            "__device__ __forceinline__ void stamp(int k) {\n"
            "  if (threadIdx.x != 0) return;\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  pkv_stamp[8 * (blockIdx.y * gridDim.x + blockIdx.x) + k] = t;\n"
            "}\n")
    src = src.replace('#include "hopper.cuh"\n', '#include "hopper.cuh"\n\n'
                      + head, 1)
    for k, anchor in STAMPS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, anchor + f"  stamp({k});\n")
    anchor = "        mbar_wait(&full[s], (sq / a.stages) & 1);\n"
    assert src.count(anchor) == 1
    src = src.replace(anchor, anchor + "        if (i == 0) stamp(3);\n")
    anchor = "    if (r0 + a.rp < a.rows) {\n"
    assert src.count(anchor) == 1
    src = src.replace(anchor, "    stamp(6);\n    stamp(7);\n" + anchor)
    return src + ("\nextern \"C\" int pkv_stamps(void* out, int n) {\n"
                  "  return (int)cudaMemcpyFromSymbol(out, pkv_stamp, "
                  "(size_t)n * 8);\n}\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="wqkv,wo,w_gateup,w_down,lm_head4,"
                    "w_down:g128")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from port_int4_plans import bind
    from pyramidkv_tpu_torch.kernels import _build

    im = importlib.import_module("pyramidkv_tpu_torch.kernels.int4_matmul")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    with open(os.path.join(_build.CSRC, "int4_matmul.cu")) as f:
        src = stamped_source(f.read())
    path = os.path.join(tmp, "stamped.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(tmp, "libstamped.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", out, path], check=True, capture_output=True)
    lib = bind(out)
    lib.pkv_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pkv_stamps.restype = ctypes.c_int
    tree = _build.library("int4_matmul")
    out_f = open(args.log, "a") if args.log else None

    for item in args.shapes.split(","):
        shape, _, fmt = item.partition(":")
        gs = 128 if fmt == "g128" else 0
        i, o = cs.LLAMA_MM[shape]
        xdt = "f32" if shape.startswith("lm_head") else "bf16"
        g = torch.Generator(device=dev).manual_seed(5)
        codes = torch.randint(-128, 128, (i, o // 2), generator=g,
                              device=dev, dtype=torch.int8)
        scale = torch.rand((i // gs, o) if gs else (o,), generator=g,
                           device=dev)
        x = torch.randn((1, i), generator=g, device=dev).to(
            torch.bfloat16 if xdt == "bf16" else torch.float32)
        plan = im.int4_tile_plan(1, i, o // 2, gs, sms, xdt == "f32")

        def call():
            return im._launch_int4(x, codes, scale, plan, gs)
        graph_ms = cs.graph_ms(torch, call, reps=50)
        _build._loaded["int4_matmul"] = lib
        call()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
        _build._loaded["int4_matmul"] = tree
        st = np.zeros(8 * plan.blocks, dtype=np.uint64)
        _build.check(lib.pkv_stamps(st.ctypes.data, st.size), "pkv_stamps")
        st = st.reshape(plan.blocks, 8).astype(np.int64)
        t0 = st[:, 0].min()
        st = st - t0
        d = np.diff(st, axis=1)
        rec = {"shape": item, "x": xdt, "plan": plan._asdict(),
               "graph_us": graph_ms * 1e3,
               "span_us": float(st[:, 7].max()) / 1e3,
               "start_us": [float(np.percentile(st[:, 0], p)) / 1e3
                            for p in (0, 50, 100)],
               "end_us": [float(np.percentile(st[:, 7], p)) / 1e3
                          for p in (0, 50, 100)],
               "phase_median_us": {n: float(np.median(d[:, k])) / 1e3
                                   for k, n in enumerate(PHASES)},
               "phase_max_us": {n: float(d[:, k].max()) / 1e3
                                for k, n in enumerate(PHASES)},
               "device": smi}
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
        del codes, scale, x
    return 0


if __name__ == "__main__":
    sys.exit(main())
