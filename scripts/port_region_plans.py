#!/usr/bin/env python3
"""Time the port's KIVI group-region kernel on candidate split plans, on a
CUDA card.

    python3 scripts/port_region_plans.py [--variant DIR ...] [--log FILE]

At each group-region shape of ``chip_smoke.py``'s KIVI runs (bench.py's
32k snapkv kivi4, the 8k batch's snapkv kivi4 and kivi2, 32k fullkv kivi4) and in both modes (f32
dequantization, ``pkv_quant_decode``; the factored one with bf16 folds,
``pkv_quant_group_fused``) it launches ``region_kernel`` with the step's
bf16 tail on each candidate plan (nsplit splits of whole 32-row items; up
to 4 merge in a cluster, more in the merge kernel), holds the output to
the plain version (``chip_smoke.TAIL_TOL``) and times it in a CUDA graph of
50 calls, beside SDPA over the dequantized region.
``--variant DIR``: a directory holding an edited copy of this tree's
``quant_decode.cu`` and ``quant_region.cuh``, built the same way and swept
over the same plans after the tree's own build.  Prints one JSON line per
(build, shape, mode, plan).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: label -> (B, Hk, G, slots, nbits, tail slots, candidate split counts)
SHAPES = {
    "32k snapkv kivi4": (1, 32, 1, 128, 4, 128, (1,)),
    "8k snapkv kivi4": (4, 32, 1, 2048, 4, 32, (2, 4, 8)),
    "8k snapkv kivi2": (4, 32, 1, 2048, 2, 32, (2, 4, 8)),
    "32k fullkv kivi4": (1, 8, 4, 32768, 4, 128, (4, 16, 32, 64)),
}
#: mode -> entry point
MODES = {"f32": "pkv_quant_decode", "fold": "pkv_quant_group_fused"}


def build_lib(path: str, symbols):
    """``path``/quant_decode.cu built with the tree's nvcc flags, its
    ``symbols`` bound with the region signature."""
    from pyramidkv_tpu_torch.kernels import _build

    out = os.path.join(path, "libquant_decode_ab.so")
    # -fno-gnu-unique: a template's function-local statics (the kernels'
    # shared-memory attribute flags) stay in this library; as GNU unique
    # symbols they would be shared with the tree's build, and a copy would
    # skip setting its own kernels' attribute
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
                    "-fno-gnu-unique", "-o", out,
                    os.path.join(path, "quant_decode.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    for symbol in symbols:
        fn = getattr(lib, symbol)
        fn.argtypes = _build._REGION
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="directory of an edited quant_decode.cu")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.kernels import quant_decode as qd
    from pyramidkv_tpu_torch.ops import quant

    if not torch.cuda.is_available():
        print("port_region_plans: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    builds = [("tree", _build.library("quant_decode"))] + [
        (path, build_lib(path, MODES.values()))
        for path in args.variant]
    lines = []

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        lines.append(line)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    ok = True
    for seed, (label, (b, hk, g, s, nbits, t_len, counts)) in enumerate(
            SHAPES.items(), start=900):
        q, reg, mask, tail = cs.region_inputs(torch, dev, b, hk, g, s, nbits,
                                              64, "group", t_len, seed)
        w, s_pad, kg, _ = quant.region_geometry(reg, nbits)
        kh, vh = quant.dequantize_kv_region(reg, num_slots=s, head_dim=cs.D,
                                            nbits=nbits, dtype=torch.bfloat16)
        tk, tv, tm = tail
        kr = torch.cat([kh, tk], dim=2).repeat_interleave(g, dim=1)
        vr = torch.cat([vh, tv], dim=2).repeat_interleave(g, dim=1)
        mr = torch.cat([mask, tm], dim=2).repeat_interleave(
            g, dim=1)[:, :, None, :]
        q4 = q[:, :, None, :]
        sdpa = cs.graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kr, vr, attn_mask=mr), reps=50)
        del kh, vh, kr, vr, mr
        for mode, symbol in MODES.items():
            fold = mode == "fold"
            region = (quant.quant_region_attention_fused if fold
                      else quant.quant_decode_attention_plain)
            want = quant.merge_tail(region(q, reg, mask, nbits=nbits), q,
                                    tail).float()
            tol = cs.TAIL_TOL["folded" if fold else "f32"]
            base = {"shape": label, "mode": mode, "B": b, "Hk": hk, "G": g,
                    "S_pad": s_pad, "nbits": nbits, "tail": t_len,
                    "sdpa_ms": sdpa,
                    "default_plan": list(qd.split_plan(dev, b * hk, w, nbits,
                                                       kg))}
            items = -(-w // qd.ITEM_ROWS)
            for (build, lib), n in ((x, n) for x in builds for n in counts):
                _build._loaded["quant_decode"] = lib
                rows = qd.ITEM_ROWS * -(-items // n) if n > 1 else w
                plan = (-(-w // rows), rows)
                win = qd.region_window(g, nbits, fold, rows, kg,
                                       s_pad // kg, cs.D, cs.D // 64, t_len)
                rec = dict(base, build=build, nsplit=plan[0], rows=rows,
                           windows=-(-rows // win),
                           smem=qd.region_smem_bytes(
                               g, nbits, fold, rows, kg, s_pad // kg, cs.D,
                               cs.D // 64, t_len, win),
                           kernels=qd.region_kernels(plan[0]))

                def call():
                    return qd.launch_group(symbol, q, reg, mask, nbits, plan,
                                           tail)[0]

                if build != "tree":
                    try:  # an edited build may refuse a plan: a finding
                        call()
                    except RuntimeError as e:
                        emit(dict(rec, error=str(e)))
                        continue
                got = call()
                again = call()
                torch.cuda.synchronize()
                rec["err_over_tol"] = cs.err_over_tol(got.float(), want, *tol)
                rec["repeat_bitwise"] = bool(torch.equal(got, again))
                rec["ms"] = cs.graph_ms(torch, call, reps=50)
                ok &= rec["err_over_tol"] <= 1 and rec["repeat_bitwise"]
                emit(rec)
            _build._loaded["quant_decode"] = builds[0][1]
        del q, reg, mask, tail
        torch.cuda.empty_cache()
    if args.log:
        with open(args.log, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
