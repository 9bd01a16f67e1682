#!/usr/bin/env python3
"""Time variants of the port's two H2O kernels side by side, on one CUDA
card.

    python3 scripts/port_h2o_variants.py EDITS.json [--only A,B] [--sass]
        [--log FILE]

EDITS.json maps a variant's name to a list of [old, new] text edits of
``pyramidkv_tpu_torch/csrc/h2o_scores.cu`` (each ``old`` must occur once;
an empty list is the source as it is) or to the path of another source
with the same C entry points, from the repository's root (``--only``
keeps the named variants, in the file's order).  Each variant is built with the
package's nvcc flags in its own directory (all at once), and its ptxas
registers and spills are printed for both kernels; with ``--sass`` also
each kernel's highest register and its count of local-memory loads and
stores (``cuobjdump -sass``).  Then ``pkv_h2o_stats`` and
``pkv_h2o_colsum`` (fed the first variant's m and l) at the 8k batch (B=4,
8000/6000/3000/1000 tokens) and at 32k (B=1, 32767 tokens), W = 8, each
timed with every variant in turns (all variants, then all in reverse
order; device ms a call, CUDA events over 5 calls), and its output
compared bitwise with the first variant's.  Prints the card's name and
power limit, then one JSON line per variant (ptxas) and one with the
times.  ``scripts/port_h2o_variants.json`` holds the source as it is,
exp2f for the MUFU's flushing exp2, the products alone, the exponentials
alone (no products), a quarter of the exponentials on the FMA pipe (a
degree-5 polynomial) and a ring of 6 stages.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

KERNELS = ("h2o_stats_kernel", "h2o_colsum_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("edits", help="JSON: {variant: [[old, new], ...]}")
    ap.add_argument("--only", help="comma-separated variants to build")
    ap.add_argument("--sass", action="store_true",
                    help="also count registers and local memory in SASS")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from port_flash_variants import build_variants
    from pyramidkv_tpu_torch.kernels.h2o_scores import scaled_query

    if not torch.cuda.is_available():
        print("port_h2o_variants: no CUDA device", file=sys.stderr)
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
    if args.only:
        keep = args.only.split(",")
        variants = {k: v for k, v in variants.items() if k in keep}
    libs = build_variants(variants, "h2o_scores", KERNELS, args.sass, emit)
    if not libs:
        return 1

    stream = torch.cuda.current_stream().cuda_stream
    first = next(iter(libs.values()))
    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for label, b, n, tls in (("8k batch", cs.B, cs.N, cs.TRUE_LEN),
                             ("32k", 1, cs.QN, (cs.QTRUE,))):
        qs = scaled_query(cs._rand_bf16(torch, g, dev, b, cs.H, n, cs.D))
        k = cs._rand_bf16(torch, g, dev, b, cs.HK, n, cs.D)
        tl = torch.tensor(tls, dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        m, l = (torch.empty((b, cs.H, n), **f32) for _ in range(2))
        dims = (b, cs.H, cs.HK, n, 8, stream)
        first.pkv_h2o_stats(qs.data_ptr(), k.data_ptr(), tl.data_ptr(),
                            m.data_ptr(), l.data_ptr(), *dims)
        ms, ls = torch.empty_like(m), torch.empty_like(l)
        out = torch.empty((b, cs.H, n - 8), **f32)
        # the tensors stay referenced by the case (the calls take pointers)
        keep = (qs, k, tl, m, l, ms, ls)
        cases.append((f"stats {label}", (ms, ls), lambda lib, keep=keep, a=(
            qs.data_ptr(), k.data_ptr(), tl.data_ptr(), ms.data_ptr(),
            ls.data_ptr(), *dims): lib.pkv_h2o_stats(*a)))
        cases.append((f"colsum {label}", (out,), lambda lib, keep=keep, a=(
            qs.data_ptr(), k.data_ptr(), tl.data_ptr(), m.data_ptr(),
            l.data_ptr(), out.data_ptr(), *dims): lib.pkv_h2o_colsum(*a)))
    order = list(libs) + list(reversed(list(libs)))
    times = {}
    for label, outs, call in cases:
        ref = None
        row = times.setdefault(label, {})
        for name in order:
            err = call(libs[name])
            torch.cuda.synchronize()
            if err:
                row[name] = f"CUDA error {err}"
                continue
            if ref is None:
                ref = [o.clone() for o in outs]
            row.setdefault(name, []).append(
                cs.time_ms(torch, lambda: call(libs[name]), reps=5))
            row[name + " bitwise equal to the first"] = all(
                torch.equal(o, r) for o, r in zip(outs, ref))
    emit({"times_ms": times})
    return 0


if __name__ == "__main__":
    sys.exit(main())
