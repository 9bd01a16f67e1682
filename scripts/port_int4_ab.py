#!/usr/bin/env python3
"""Time the port's int4 decode matmuls against another build of
``csrc/int4_matmul.cu``, on one CUDA card.

    python3 scripts/port_int4_ab.py --other FILE [--no-profile] [--log FILE]

``--other``: an ``int4_matmul.cu`` with the earlier C entries (the split-K
``pkv_int4_matmul`` and the windowed ``pkv_int4_matmul_dma``, each a kernel
and a finish pass over an f32 workspace) and their plans (``_plan_stream``,
kept in the package for int8, and the windowed kernel's plan, copied
below), for example the parent commit's source from ``git show``.

At every ``chip_smoke._INT4_SHAPES`` entry (int4 per-channel; g128 at the
four layer shapes; ``int4_matmul_dma``), at rows 1 and 8, each build is held
to the plain version (``chip_smoke.MM_TOL``), called twice (bitwise equal)
and timed in a CUDA graph of 50 calls, in turns: other, tree, tree, other.
Then, unless ``--no-profile``, the int4 snapkv decode of ``chip_smoke``'s
profile_quant phase (bench.py's 32k prompt, 8 steps) runs with each build's
kernels in turns, and its matmul kernels' device ms per step under
torch.profiler is printed beside the least time their codes take.

Prints one JSON line per (shape, rows, build) and per profile turn, each
with the card's name and power limit.
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


def plan_dma(rows: int, in_dim: int, out2: int, win: int, sms: int):
    """(rt, vb, win, wpb, splits) of the earlier windowed kernel: its 64-byte
    strips, windows shrunk to divide the in-dim, about 4 blocks an SM."""
    rt = 1 if rows == 1 else 2 if rows == 2 else 4 if rows <= 4 else 8
    vb = 16 if rt <= 2 else 4
    w = min(win, in_dim)
    while in_dim % w:
        w //= 2
    nw = in_dim // w
    tiles = (out2 // 64) * -(-rows // rt)
    splits_t = max(1, min(nw, -(-4 * sms // tiles)))
    wpb = -(-nw // splits_t)
    return rt, vb, w, wpb, -(-nw // wpb)


def other_kernels(path: str, out_dir: str, sms: int):
    """The earlier build's int4 wrappers {kernel name: fn(x, codes, scale,
    **kw)}, its source built with the package's nvcc flags."""
    import torch

    from pyramidkv_tpu_torch.kernels import _build
    # the module (the package's attribute of that name is the wrapper)
    im = importlib.import_module("pyramidkv_tpu_torch.kernels.int4_matmul")

    out = os.path.join(out_dir, "libint4_other.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", out, path], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    for name in ("pkv_int4_matmul", "pkv_int4_matmul_dma"):
        getattr(lib, name).argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 9
                                       + [ctypes.c_void_p])
        getattr(lib, name).restype = ctypes.c_int

    def call(fn, x, c, sc, flags, splits, *ints):
        rows = x.shape[0]
        out = 2 * c.shape[1]
        ws = torch.empty((splits, rows, out), dtype=torch.float32,
                         device=x.device)
        y = torch.empty((rows, out), dtype=x.dtype, device=x.device)
        err = getattr(lib, fn)(
            x.data_ptr(), c.data_ptr(), sc.data_ptr(), ws.data_ptr(),
            y.data_ptr(), *ints, flags,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, fn)
        return y

    def int4(x, codes, scale, *, layer=None, group_size=0):
        x, c, sc, flags = im._cuda_args("int4_matmul", x, codes, layer, scale)
        rows, in_dim = x.shape
        rt, vb, kc, splits = im._plan_stream(rows, in_dim, c.shape[1],
                                             group_size, sms)
        return call("pkv_int4_matmul", x, c, sc, flags, splits, rows, in_dim,
                    c.shape[1], group_size, rt, vb, kc, splits)

    def dma(x, codes, scale, *, layer=None, win=512):
        x, c, sc, flags = im._cuda_args("int4_matmul_dma", x, codes, layer,
                                        scale)
        rows, in_dim = x.shape
        rt, vb, w, wpb, splits = plan_dma(rows, in_dim, c.shape[1], win, sms)
        return call("pkv_int4_matmul_dma", x, c, sc, flags, splits, rows,
                    in_dim, c.shape[1], rt, vb, w, wpb, splits)

    return {"int4_matmul": int4, "int4_matmul_dma": dma}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="another build's int4_matmul.cu")
    ap.add_argument("--no-profile", action="store_true",
                    help="only the kernels at the decode shapes")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch.models import weights

    if not torch.cuda.is_available():
        print("port_int4_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    other = other_kernels(args.other, tempfile.mkdtemp(), sms)
    tree = {k: weights.KERNELS[k][0] for k in other}
    turns = ("other", "tree", "tree", "other")
    out_f = open(args.log, "a") if args.log else None

    def emit(rec):
        line = json.dumps({**rec, "device": smi})
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    ok = True
    seed = 700
    for kind, gs, shapes in cs.MM_CASES:
        if kind not in other:
            continue
        for shape, xdt in shapes:
            for rows in (1, 8):
                i, o = cs.LLAMA_MM[shape]
                g = torch.Generator(device=dev).manual_seed(seed)
                seed += 1
                codes = torch.randint(-128, 128, (i, o // 2), generator=g,
                                      device=dev, dtype=torch.int8)
                scale = (0.5 + torch.rand((i // gs, o) if gs else (o,),
                                          generator=g, device=dev)) / (
                    7.0 * i ** 0.5)
                x = torch.randn((rows, i), generator=g, device=dev).to(
                    torch.bfloat16 if xdt == "bf16" else torch.float32)
                kw = {"group_size": gs} if kind == "int4_matmul" else {}
                want = weights.KERNELS[kind][1](x, codes, scale, **kw)
                nbytes = (codes.numel() + scale.numel() * 4 + x.numel()
                          * x.element_size() + want.numel()
                          * want.element_size())
                bound_ms, _ = cs.bound(
                    2.0 * rows * i * o, nbytes,
                    cs.PEAK_BF16_FLOPS if xdt == "bf16"
                    else cs.PEAK_F32_FLOPS)
                recs = {}
                for build in turns:
                    fn = (other if build == "other" else tree)[kind]
                    rec = recs.setdefault(build, {
                        "kernel": kind, "group_size": gs, "shape": shape,
                        "x": xdt, "rows": rows, "build": build,
                        "bound_ms": bound_ms, "ms": []})
                    got = fn(x, codes, scale, **kw)
                    again = fn(x, codes, scale, **kw)
                    torch.cuda.synchronize()
                    rec["err_over_tol"] = cs.err_over_tol(got, want,
                                                          *cs.MM_TOL[xdt])
                    rec["repeat_bitwise"] = bool(torch.equal(got, again))
                    rec["ms"].append(cs.graph_ms(
                        torch, lambda: fn(x, codes, scale, **kw), reps=50))
                for build, rec in recs.items():
                    ok &= rec["err_over_tol"] <= 1
                    if build == "tree":
                        ok &= rec["repeat_bitwise"]
                    emit(rec)
                del codes, scale, x, want
    if args.no_profile:
        return 0 if ok else 1

    # profile_quant's int4 snapkv decode, each build's int4 kernels in turn
    from pyramidkv_tpu_torch.config import ModelSpec
    from pyramidkv_tpu_torch.models.convert import init_params

    spec = ModelSpec.preset("llama3-8b")
    params = init_params(spec, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    q4 = cs.quantized(params, "int4")
    del params
    torch.cuda.empty_cache()
    saved = dict(weights.KERNELS)
    got = []
    cs.log = got.append
    for build in turns:
        for k in other:
            weights.KERNELS[k] = ((other if build == "other" else tree)[k],
                                  saved[k][1])
        try:
            ok &= cs.phase_profile(torch, dev, q4, spec.vocab_size,
                                   weights="int4")
        finally:
            weights.KERNELS.update(saved)
        dec = [r for r in got if r.get("part") == "decode"][-1]
        emit({"profile": "int4 snapkv decode", "build": build,
              "steps": dec["steps"],
              "mm_device_ms_per_step": dec["mm_device_ms_per_step"],
              "mm_bound_ms_per_step": dec["mm_bound_ms_per_step"],
              "wall_s": dec["wall_s"], "device_busy_s": dec["device_busy_s"]})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
