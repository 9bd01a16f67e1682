#!/usr/bin/env python3
"""Time variants of the port's flash kernels side by side, on one CUDA card.

    python3 scripts/port_flash_variants.py EDITS.json [--sass] [--log FILE]

EDITS.json maps a variant's name to a list of [old, new] text edits of
``pyramidkv_tpu_torch/csrc/flash_prefill.cu`` (each ``old`` must occur once;
an empty list is the source as it is) or to the path of another source,
from the repository's root.  Each variant is built with the
package's nvcc flags in its own directory (all at once), and its ptxas
registers and spills are printed for the one-pass / partials kernel
(``flash_wgmma_kernel``); with ``--sass`` also its highest register and its
count of local-memory loads and stores (``cuobjdump -sass``).  Then
``pkv_flash_prefill`` at the 8k batch (B=4, 8000/6000/3000/1000 tokens)
and at 32k (B=1, 32767 tokens), and ``pkv_flash_partials`` on a 32k self
and history tile (C=8192), each timed with every variant in turns (all
variants, then all in reverse order; device ms a call, CUDA events over
10 calls), and its output compared bitwise with the first variant's.
Prints the card's name and power limit, then one JSON line per variant
(ptxas) and one with the times.  ``scripts/port_flash_variants.json``
holds the variants the kernel's design was chosen against: the source as
it is, the intra-warpgroup overlap (tile i's Q K^T started beside tile
i-1's P V), a warp-uniform role index, and 3 stages.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sass_stats(lib_path: str, kernel: str = "flash_wgmma_kernel") -> dict:
    """Highest register and local loads/stores of the SASS of each function
    whose name holds ``kernel``."""
    from pyramidkv_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        if kernel not in func.split("\n")[0]:
            continue
        out[func.split("\n")[0].strip()[:80]] = {
            "max_register": max(int(r) for r in re.findall(r"\bR(\d+)\b",
                                                           func)),
            "local_ld_st": len(re.findall(r"\b(?:STL|LDL)\b", func))}
    return out


def build_variants(variants: dict, name: str, kernels: tuple, sass: bool,
                   emit) -> dict:
    """Build each variant of ``csrc/<name>.cu`` (a list of [old, new] text
    edits, each ``old`` occurring once, or the path of another source from
    the repository's root) with the package's nvcc flags, all at once, each
    in its own copy of ``csrc``; emit its ptxas registers and spills (and,
    with ``sass``, SASS register and local-memory counts) for the functions
    whose names hold one of ``kernels``, and ptxas's notes; bind its entry
    points as the package does.  Returns {variant: library}."""
    import chip_smoke as cs
    from pyramidkv_tpu_torch.kernels import _build

    tmp = tempfile.mkdtemp()
    procs = {}
    for var, edits in variants.items():
        d = os.path.join(tmp, var)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, f"{name}.cu")
        if isinstance(edits, str):
            shutil.copy(os.path.join(ROOT, edits), path)
            edits = []
        with open(path) as f:
            src = f.read()
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"{var}: edit text occurs "
                                 f"{src.count(old)} times: {old[:60]!r}")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
        procs[var] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(d, "lib.so"), path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for var, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            emit({"variant": var, "build_failed": log[-3000:]})
            continue
        so = os.path.join(tmp, var, "lib.so")
        rec = {"variant": var, "ptxas": [
            r for r in cs.ptxas_report(log)
            if any(k in r.get("function", "") for k in kernels)
            or "(C751" in r.get("warning", "")]}
        if sass:
            rec["sass"] = {k: v for kern in kernels
                           for k, v in sass_stats(so, kern).items()}
        emit(rec)
        lib = ctypes.CDLL(so)
        for symbol, argtypes in _build.ENTRY_POINTS[name]:
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = ctypes.c_int
        libs[var] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("edits", help="JSON: {variant: [[old, new], ...]}")
    ap.add_argument("--sass", action="store_true",
                    help="also count registers and local memory in SASS")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("port_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_f = open(args.log, "a") if args.log else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    with open(args.edits) as f:
        variants = json.load(f)
    libs = build_variants(variants, "flash_prefill", ("flash_wgmma_kernel",),
                          args.sass, emit)

    stream = torch.cuda.current_stream().cuda_stream
    sc = 1.0 / cs.D ** 0.5
    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for label, b, n, tls in (("8k batch", cs.B, cs.N, cs.TRUE_LEN),
                             ("32k", 1, cs.QN, (cs.QTRUE,))):
        q = cs._rand_bf16(torch, g, dev, b, cs.H, n, cs.D)
        k, v = (cs._rand_bf16(torch, g, dev, b, cs.HK, n, cs.D)
                for _ in range(2))
        tl = torch.tensor(tls, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        cases.append((label, out, lambda lib, q=q, k=k, v=v, tl=tl, out=out,
                      b=b, n=n: lib.pkv_flash_prefill(
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          tl.data_ptr(), out.data_ptr(), b, cs.H, cs.HK, n,
                          n, n, 0, 0, sc, stream)))
    for label, q_start in (("partials 32k self tile", 0),
                           ("partials 32k history tile", cs.C32K)):
        n = cs.C32K
        q = cs._rand_bf16(torch, g, dev, 1, cs.H, n, cs.D)
        k, v = (cs._rand_bf16(torch, g, dev, 1, cs.HK, n, cs.D)
                for _ in range(2))
        tl = torch.tensor((n - 1,), dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        acc = torch.empty((1, cs.H, n, cs.D), **f32)
        m, l = (torch.empty((1, cs.H, n), **f32) for _ in range(2))
        cases.append((label, acc, lambda lib, q=q, k=k, v=v, tl=tl, acc=acc,
                      m=m, l=l, n=n, q_start=q_start: lib.pkv_flash_partials(
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          tl.data_ptr(), acc.data_ptr(), m.data_ptr(),
                          l.data_ptr(), 1, cs.H, cs.HK, n, n, q_start, 0,
                          sc, stream)))
    order = list(libs) + list(reversed(list(libs)))
    times = {}
    for label, out, call in cases:
        ref = None
        row = times.setdefault(label, {})
        for name in order:
            err = call(libs[name])
            torch.cuda.synchronize()
            if err:
                row[name] = f"CUDA error {err}"
                continue
            if ref is None:
                ref = out.clone()
            row.setdefault(name, []).append(
                cs.time_ms(torch, lambda: call(libs[name]), reps=10))
            row[name + " bitwise equal to the first"] = bool(
                torch.equal(out, ref))
    emit({"times_ms": times})
    return 0


if __name__ == "__main__":
    sys.exit(main())
