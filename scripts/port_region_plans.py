#!/usr/bin/env python3
"""Time the port's KIVI group-region kernel on candidate split plans, on a
CUDA card.

    python3 scripts/port_region_plans.py [--variant DIR ...] [--only S,..]
        [--log FILE]

At each group-region shape of ``chip_smoke.py``'s KIVI runs (bench.py's
32k snapkv kivi4, the 8k batch's snapkv kivi4 and kivi2, 32k fullkv kivi4;
Gemma-2-9B's fullkv regions at D = 256 under its scale and cap, q at
``GEMMA_Q_STD``) and in each of its modes (f32 dequantization,
``pkv_quant_decode``; the factored one with bf16 folds,
``pkv_quant_group_fused``; mm_bf16, ``pkv_quant_decode_mm_bf16``) it
launches ``region_kernel`` with the step's bf16 tail on each candidate
plan (nsplit splits of whole 32-row items; up to 4 merge in a cluster,
more in the merge kernel), holds the output to the plain version
(``chip_smoke.TAIL_TOL``; under a cap the folded limit) and times it in a
CUDA graph of 50 calls, beside SDPA over the dequantized region (the
uncapped function).  ``--variant DIR``: a directory holding an edited copy
of this tree's ``quant_region.cuh`` and the mode's entry source
(``quant_decode.cu``, ``quant_group_fused.cu``,
``quant_decode_mm_bf16.cu``), built the same way and swept over the same
plans after the tree's own build.  ``--only``: shape labels.  Prints one
JSON line per (build, shape, mode, plan).
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

#: label -> (B, Hk, G, slots, nbits, tail slots, candidate split counts,
#: head dim, K / V group size, modes, Gemma-2's attention)
SHAPES = {
    "32k snapkv kivi4": (1, 32, 1, 128, 4, 128, (1,), 128, 64,
                         ("f32", "fold"), False),
    "8k snapkv kivi4": (4, 32, 1, 2048, 4, 32, (2, 4, 8), 128, 64,
                        ("f32", "fold"), False),
    "8k snapkv kivi2": (4, 32, 1, 2048, 2, 32, (2, 4, 8), 128, 64,
                        ("f32", "fold"), False),
    "32k fullkv kivi4": (1, 8, 4, 32768, 4, 128, (4, 16, 32, 64), 128, 64,
                         ("f32", "fold"), False),
    "gemma fullkv kivi4": (4, 8, 2, 8192, 4, 32, (4, 5, 8, 16), 256, 64,
                           ("fold", "f32"), True),
    "gemma fullkv kivi2": (4, 8, 2, 8192, 2, 32, (4, 6, 8, 16), 256, 64,
                           ("f32",), True),
    "gemma fullkv kivi4 K groups of 32": (4, 8, 2, 8192, 4, 32,
                                          (8, 10, 16), 256, 32,
                                          ("mm_bf16",), True),
    "gemma snapkv kivi4": (4, 16, 1, 2048, 4, 32, (1, 2, 4, 8), 256, 64,
                           ("fold",), True),
}


def build_lib(path: str, lib_name: str, symbol: str):
    """``path``/``lib_name``.cu built with the tree's nvcc flags, its
    ``symbol`` bound with the region signature."""
    from pyramidkv_tpu_torch.kernels import _build

    out = os.path.join(path, f"lib{lib_name}_ab.so")
    # -fno-gnu-unique: a template's function-local statics (the kernels'
    # shared-memory attribute flags) stay in this library; as GNU unique
    # symbols they would be shared with the tree's build, and a copy would
    # skip setting its own kernels' attribute
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
                    "-fno-gnu-unique", "-o", out,
                    os.path.join(path, f"{lib_name}.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    fn = getattr(lib, symbol)
    fn.argtypes = _build._REGION
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="directory of an edited quant_region.cuh and "
                    "entry sources")
    ap.add_argument("--only", help="comma-separated shape labels")
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
    _build.build_all([lib for lib, _ in qd.ENTRIES.values()])
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
    shapes = {k: v for k, v in SHAPES.items()
              if not args.only or k in args.only.split(",")}
    for seed, (label, (b, hk, g, s, nbits, t_len, counts, d, gs, modes,
                       gemma)) in enumerate(shapes.items(), start=900):
        akw = (dict(scale=cs.GEMMA_SCALE, softcap=cs.GEMMA_CAP) if gemma
               else dict(scale=None, softcap=None))
        q, reg, mask, tail = cs.region_inputs(
            torch, dev, b, hk, g, s, nbits, gs, "group", t_len, seed, d=d,
            q_std=cs.GEMMA_Q_STD if gemma else 1.0)
        w, s_pad, kg, _ = quant.region_geometry(reg, nbits)
        kh, vh = quant.dequantize_kv_region(reg, num_slots=s, head_dim=d,
                                            nbits=nbits, dtype=torch.bfloat16)
        tk, tv, tm = tail
        kr = torch.cat([kh, tk], dim=2).repeat_interleave(g, dim=1)
        vr = torch.cat([vh, tv], dim=2).repeat_interleave(g, dim=1)
        mr = torch.cat([mask, tm], dim=2).repeat_interleave(
            g, dim=1)[:, :, None, :]
        q4 = q[:, :, None, :]
        sdpa = cs.graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kr, vr, attn_mask=mr, scale=akw["scale"]), reps=50)
        del kh, vh, kr, vr, mr
        for mode in modes:
            fold = mode == "fold"
            lib_name, symbol = qd.ENTRIES[mode]
            builds = [("tree", _build.library(lib_name))] + [
                (path, build_lib(path, lib_name, symbol))
                for path in args.variant]
            part = (quant.quant_region_attention_fused(q, reg, mask,
                                                       nbits=nbits, **akw)
                    if fold else quant.quant_decode_attention_plain(
                        q, reg, mask, nbits=nbits, mm_bf16=mode == "mm_bf16",
                        **akw))
            want = quant.merge_tail(part, q, tail, **akw).float()
            tol = cs.TAIL_TOL["folded" if fold or gemma else "f32"]
            base = {"shape": label, "mode": mode, "B": b, "Hk": hk, "G": g,
                    "D": d, "S_pad": s_pad, "nbits": nbits, "tail": t_len,
                    "sdpa_ms": sdpa, "smi": smi,
                    "default_plan": list(qd.split_plan(dev, b * hk, w, nbits,
                                                       kg, d))}
            items = -(-w // qd.ITEM_ROWS)
            for (build, lib), n in ((x, n) for x in builds for n in counts):
                _build._loaded[lib_name] = lib
                rows = qd.ITEM_ROWS * -(-items // n) if n > 1 else w
                plan = (-(-w // rows), rows)
                win = qd.region_window(g, nbits, mode != "f32", rows, kg,
                                       s_pad // kg, d, d // gs, t_len, d)
                rec = dict(base, build=build, nsplit=plan[0], rows=rows,
                           windows=-(-rows // win),
                           smem=qd.region_smem_bytes(
                               g, nbits, mode != "f32", rows, kg,
                               s_pad // kg, d, d // gs, t_len, win, d),
                           kernels=qd.region_kernels(plan[0], d))

                def call():
                    return qd.launch_group(mode, q, reg, mask, nbits, plan,
                                           tail, **akw)[0]

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
            _build._loaded[lib_name] = builds[0][1]
        del q, reg, mask, tail
        torch.cuda.empty_cache()
    if args.log:
        with open(args.log, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
