#!/usr/bin/env python3
"""Where the time of MInference's vertical and grid slash kernels goes, on
one CUDA card.

    python3 scripts/port_minference_parts.py [--log FILE]

At ``chip_smoke.SPARSE_CASES``' "32k", "32k pcfg" and "8k" shapes, on the
pattern ``estimate_vertical_slash`` makes from seeded random q/k (the
inputs of ``scripts/port_minference_ab.py``), device ms a call (a CUDA
graph of 10 calls, ``chip_smoke.graph_ms``) of:

- the vertical wrapper, its sort (``sort_vertical_columns``), and the C
  entry alone on the sorted inputs: with the real walks, and with every
  walk empty (counts 0: what remains is writing acc, m and l);
- the slash wrapper, its bit packing (``pack_vertical_bits``), and the
  wrapper with every list entry invalid (again the writes and the fixed
  cost of the blocks);
- the slash walks' visited (row, key) pairs, from ``slash_unit_plan`` (64
  rows of a warpgroup per 64-key unit it takes), against the visible pairs
  the bound counts (``chip_smoke.slash_pairs``), and the share of units
  that take a mask.

Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def slash_visits(bsp, ti, tv, vert, tl, n, q_block, k_tile):
    """(visited pairs, masked units, units) of the slash walks."""
    visited = masked = units = 0
    b, h = ti.shape[:2]
    for bi in range(b):
        pad = n - int(tl[bi])
        for hi in range(h):
            plan = bsp.slash_unit_plan(ti[bi, hi], tv[bi, hi], vert[bi, hi],
                                       n, pad, q_block, k_tile)
            for tiles in plan:
                for wgs, pair, mask in tiles:
                    for w in (0, 1):
                        if wgs >> w & 1:
                            units += 2
                            visited += 2 * 64 * 64
                            masked += 2 * mask[w]
    return visited, masked, units


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.kernels import block_sparse_prefill as bsp

    if not torch.cuda.is_available():
        print("port_minference_parts: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    spec = importlib.util.spec_from_file_location(
        "port_minference_ab", os.path.join(ROOT, "scripts",
                                           "port_minference_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    lib = _build.library("block_sparse_prefill")
    out_f = open(args.log, "a") if args.log else None
    for seed, case in enumerate(ab.CASES, start=402):
        vargs, sargs, skw = ab.sparse_inputs(torch, cs, dev, case, seed)
        q, k_vert, v_vert, vcol, vvalid, tl = vargs
        b, h, n, d = q.shape
        vs = k_vert.shape[2]
        order, keys, counts = bsp.sort_vertical_columns(vcol, vvalid, n)
        ks, vsrt = torch.empty_like(k_vert), torch.empty_like(v_vert)
        acc, m, l = bsp._outputs(q)

        def entry(cnt):
            err = lib.pkv_vertical_partials(
                q.data_ptr(), k_vert.data_ptr(), v_vert.data_ptr(),
                order.data_ptr(), keys.data_ptr(), cnt.data_ptr(),
                ks.data_ptr(), vsrt.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), b, h, n, vs, keys.shape[-1],
                1.0 / math.sqrt(d),
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "vertical_partials")

        none = torch.zeros_like(counts)
        sq, sk, sv, ti, tv, vert, stl = sargs
        invalid = torch.zeros_like(tv)
        rec = {"case": case, "device": smi, "ms": {
            "vertical wrapper": cs.graph_ms(
                torch, lambda: bsp.vertical_attention_partials(*vargs),
                reps=10),
            "vertical sort": cs.graph_ms(
                torch, lambda: bsp.sort_vertical_columns(vcol, vvalid, n),
                reps=10),
            "vertical entry": cs.graph_ms(torch, lambda: entry(counts),
                                          reps=10),
            "vertical entry, empty walks": cs.graph_ms(
                torch, lambda: entry(none), reps=10),
            "slash wrapper": cs.graph_ms(
                torch, lambda: bsp.slash_tile_attention(*sargs, **skw),
                reps=10),
            "slash bit packing": cs.graph_ms(
                torch, lambda: bsp.pack_vertical_bits(vert), reps=10),
            "slash wrapper, no valid entry": cs.graph_ms(
                torch, lambda: bsp.slash_tile_attention(
                    sq, sk, sv, ti, invalid, vert, stl, **skw), reps=10)}}
        visited, masked, units = slash_visits(bsp, ti, tv, vert, stl, n,
                                              skw["q_block"], skw["k_tile"])
        pairs = cs.slash_pairs(torch, ti, tv, vert, stl, skw["q_block"],
                               skw["k_tile"])
        rec["slash"] = {"visited_pairs": visited, "visible_pairs": pairs,
                        "visited_over_visible": visited / pairs,
                        "masked_unit_share": masked / max(units, 1),
                        "vertical_column_share": float(
                            vert.float().mean())}
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
        del vargs, sargs, order, keys, counts, ks, vsrt, acc, m, l
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
