#!/usr/bin/env python3
"""The D = 128 and D = 256 flash and decode kernels of two builds, in
turns, on one CUDA card: the package's sources against another
directory's.

    python3 scripts/port_dim_ab.py --other DIR [--log FILE]

``DIR`` holds another ``flash_prefill.cu``, ``decode_attn.cu`` and
``hopper.cuh`` (for example the parent commit's, from ``git show``).  Both
builds use the package's nvcc flags, and both are bound and called with
the package's C signatures (``_build.ENTRY_POINTS``).  The shapes are
``chip_smoke.py`` main-path shapes of Llama-3-8B (32 / 8 heads of D = 128,
no cap): the one-pass kernel on the 8k batch and on bench.py's 32k prompt,
at q_start on chunk 3 of the 8k batch (C=2048), partials on the 32k
carry's self tile (C=8192), pass A and pass B on the 8k batch, and the
decode kernel at the 8k batch's snapkv (G=1, S=2080) and fullkv (G=4,
S=8224) widths and at 32k fullkv (S=32896); and Gemma-2-9B's (16 / 8 heads
of D = 256, scale 1/16, cap 50): the one-pass kernel on the 8k batch, the
decode kernel at G = 1, S = 2080 and G = 2, S = 8224.  Inputs are random
bf16 from a seed; both builds get the same buffers and the outputs are
compared bitwise.  Each shape is timed other, new, new, other (device ms a
call: CUDA events over several calls for flash, a CUDA graph of 50 calls
for the decode).  Prints one JSON line per shape with the card's name and
power limit.
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

def build(src_dir: str, name: str, out_dir: str):
    """``src_dir/name.cu`` built with the package's flags, its entries bound
    with the package's signatures."""
    from pyramidkv_tpu_torch.kernels import _build

    path = os.path.join(out_dir, f"lib{name}_other.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-o",
                    path, os.path.join(src_dir, f"{name}.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(path)
    for symbol, argtypes in _build.ENTRY_POINTS[name]:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="directory of the other "
                    "flash_prefill.cu, decode_attn.cu and hopper.cuh")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.kernels.decode_attn import decode_split_plan

    if not torch.cuda.is_available():
        print("port_dim_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    other = {n: build(args.other, n, tmp)
             for n in ("flash_prefill", "decode_attn")}
    new = {n: _build.library(n) for n in ("flash_prefill", "decode_attn")}
    out_lines = []

    def stream():  # the current one: a CUDA graph captures on its own
        return torch.cuda.current_stream(dev).cuda_stream

    def emit(rec):
        rec = {"script": "port_dim_ab", "device": smi, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        out_lines.append(line)

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def flash_case(name, symbol, b, n, nq, q_start, tls, extra_in=(),
                   outs=(), d=cs.D, h=cs.H, hk=cs.HK, cap=0.0, scale=None):
        """One flash entry: (call(lib), outputs)."""
        q = rand(b, h, nq, d)
        k, v = rand(b, hk, n, d), rand(b, hk, n, d)
        tl = torch.tensor(tls, dtype=torch.int32, device=dev)
        ins = [q.data_ptr(), k.data_ptr()]
        if symbol != "pkv_flash_row_max":
            ins.append(v.data_ptr())
        ins.append(tl.data_ptr())
        ins += [x.data_ptr() for x in extra_in]
        ptrs = [o.data_ptr() for o in outs]
        sc = scale or 1.0 / math.sqrt(d)
        dims = [b, h, hk, d, n] + ([] if symbol == "pkv_flash_partials"
                                   else [n]) + [nq, q_start, 0]

        def call(lib):
            err = getattr(lib, symbol)(*ins, *ptrs, *dims, sc, cap, stream())
            assert err == 0, (name, err)
        return call, (q, k, v, tl, *extra_in, *outs)

    def decode_case(name, b, h, hk, s, seed, d=cs.D, cap=0.0, scale=None):
        gg = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((b, h, d), generator=gg, device=dev).to(
            torch.bfloat16)
        k = torch.randn((b, hk, s, d), generator=gg, device=dev).to(
            torch.bfloat16)
        v = torch.randn((b, hk, s, d), generator=gg, device=dev).to(
            torch.bfloat16)
        mask = torch.rand((b, hk, s), generator=gg, device=dev) < 0.9
        nsplit, rows = decode_split_plan(dev, b * hk, s, h // hk, d)
        out = torch.empty_like(q)
        f32 = dict(dtype=torch.float32, device=dev)
        ws = (torch.empty((b * hk * nsplit, h // hk, d), **f32),
              torch.empty((b * hk * nsplit, h // hk), **f32),
              torch.empty((b * hk * nsplit, h // hk), **f32))
        ptrs = [x.data_ptr() for x in (q, k, v, mask, out, *ws)]
        sc = scale or 1.0 / math.sqrt(d)

        def call(lib):
            err = lib.pkv_decode_attn(*ptrs, b, h, hk, d, s, nsplit, rows, sc,
                                      cap, stream())
            assert err == 0, (name, err)
        return call, (q, k, v, mask, out, *ws), out

    f32 = dict(dtype=torch.float32, device=dev)
    n, qn = cs.N, cs.QN
    c8, c32 = cs.C8K, cs.C32K
    cases = []
    o8 = torch.empty((cs.B, cs.H, n, cs.D), dtype=torch.bfloat16, device=dev)
    cases.append(("flash one-pass 8k batch", "flash_prefill",
                  *flash_case("flash", "pkv_flash_prefill", cs.B, n, n, 0,
                              cs.TRUE_LEN, outs=(o8,)), o8, 10))
    o32 = torch.empty((1, cs.H, qn, cs.D), dtype=torch.bfloat16, device=dev)
    cases.append(("flash one-pass 32k", "flash_prefill",
                  *flash_case("flash32", "pkv_flash_prefill", 1, qn, qn, 0,
                              (cs.QTRUE,), outs=(o32,)), o32, 3))
    oc = torch.empty((cs.B, cs.H, c8, cs.D), dtype=torch.bfloat16, device=dev)
    cases.append(("flash q_start chunk 3, 8k batch C=2048", "flash_prefill",
                  *flash_case("chunk", "pkv_flash_prefill", cs.B, n, c8,
                              3 * c8, cs.TRUE_LEN, outs=(oc,)), oc, 10))
    pa = (torch.empty((1, cs.H, c32, cs.D), **f32),
          torch.empty((1, cs.H, c32), **f32), torch.empty((1, cs.H, c32),
                                                          **f32))
    cases.append(("flash partials 32k self tile C=8192", "flash_prefill",
                  *flash_case("partials", "pkv_flash_partials", 1, c32, c32,
                              0, (c32,), outs=pa), pa[0], 5))
    m8 = torch.empty((cs.B, cs.H, n), **f32)
    cases.append(("flash pass A 8k batch", "flash_prefill",
                  *flash_case("row_max", "pkv_flash_row_max", cs.B, n, n, 0,
                              cs.TRUE_LEN, outs=(m8,)), m8, 10))
    ob = torch.empty((cs.B, cs.H, n, cs.D), dtype=torch.bfloat16, device=dev)
    mk = torch.zeros((cs.B, cs.H, n), **f32)
    cases.append(("flash pass B 8k batch", "flash_prefill",
                  *flash_case("pass_b", "pkv_flash_pass_b", cs.B, n, n, 0,
                              cs.TRUE_LEN, extra_in=(mk,), outs=(ob,)), ob,
                  10))
    for seed, (name, b, h, hk, s) in enumerate((
            ("decode snapkv 8k batch, G=1, S=2080", cs.B, cs.H, cs.H, 2080),
            ("decode fullkv 8k batch, G=4, S=8224", cs.B, cs.H, cs.HK,
             n + cs.MAX_NEW),
            ("decode fullkv 32k, G=4, S=32896", 1, cs.H, cs.HK,
             qn + cs.QMAX_NEW))):
        call, keep, out = decode_case(name, b, h, hk, s, seed)
        cases.append((name, "decode_attn", call, keep, out, 0))
    # Gemma-2-9B: D = 256 under the cap
    gkw = dict(d=256, cap=50.0, scale=1.0 / 16)
    og = torch.empty((cs.B, 16, n, 256), dtype=torch.bfloat16, device=dev)
    cases.append(("flash one-pass 8k batch, Gemma-2 D=256 cap 50",
                  "flash_prefill",
                  *flash_case("gemma flash", "pkv_flash_prefill", cs.B, n, n,
                              0, cs.TRUE_LEN, outs=(og,), h=16, hk=8, **gkw),
                  og, 5))
    for seed, (name, hk, s) in enumerate((
            ("decode Gemma-2 per-head cache, D=256, G=1, S=2080", 16, 2080),
            ("decode Gemma-2 fullkv, D=256, G=2, S=8224", 8,
             n + cs.MAX_NEW)), start=10):
        call, keep, out = decode_case(name, cs.B, 16, hk, s, seed, **gkw)
        cases.append((name, "decode_attn", call, keep, out, 0))

    for name, lib_name, call, keep, out, reps in cases:
        def run(which):
            lib = new[lib_name] if which == "new" else other[lib_name]
            fn = (lambda: call(lib))
            if reps:
                return cs.time_ms(torch, fn, reps=reps)
            return cs.graph_ms(torch, fn, reps=50)

        call(other[lib_name])
        torch.cuda.synchronize()
        want = out.clone()
        call(new[lib_name])
        torch.cuda.synchronize()
        same = bool(torch.equal(out, want))
        t = {w: [] for w in ("other", "new")}
        for which in ("other", "new", "new", "other"):
            t[which].append(run(which))
        emit({"case": name, "other_ms": t["other"], "new_ms": t["new"],
              "new_over_other": min(t["new"]) / min(t["other"]),
              "outputs_bitwise_equal": same})
        del keep
    if args.log:
        with open(args.log, "a") as f:
            f.write("\n".join(out_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
