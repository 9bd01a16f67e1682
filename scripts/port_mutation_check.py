#!/usr/bin/env python3
"""Mutation check of the port's KIVI region kernels, on a CUDA card.

    python3 scripts/port_mutation_check.py [--log FILE]

Copies ``pyramidkv_tpu_torch`` and ``chip_smoke.py`` into a temporary
directory once per mutant, breaks ``csrc/quant_region.cuh`` there, and runs
``chip_smoke.phase_kv_quant_kernels`` against the broken kernels (each copy
builds its own libraries).  A mutant is caught when it fails the tolerance
at every main shape (the timed checks); the script prints, per mutant, the
smallest ``err_over_tol`` over those and over the short checks (where a
mutant may not bite: a region too short for warp 1), and exits non-zero if
a mutant was not caught.  Mutants:

- ``drop_plane``: the last bit-plane's V codes read as 0 (with 8-bit codes,
  the only plane);
- ``drop_chunk``: warp 1 skips its first 32-row chunk of every block's slot
  range (a slot tile never attended).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join("pyramidkv_tpu_torch", "csrc", "quant_region.cuh")
MUTANTS = {
    "drop_plane": (
        "const float c = (float)((vw >> (8 * k + p * NBITS)) & MASK);",
        "const float c = p == PER - 1 ? 0.f : (float)((vw >> (8 * k + p "
        "* NBITS)) & MASK);"),
    "drop_chunk": (
        "for (int j0 = row0 + warp * CHUNK; j0 < row1; j0 += NWARPS * CHUNK) {",
        "for (int j0 = row0 + warp * CHUNK + (warp == 1 ? NWARPS * CHUNK : 0);"
        " j0 < row1; j0 += NWARPS * CHUNK) {"),
}
_RUN = """
import json, sys, torch, torch.nn.functional as F
import chip_smoke as cs
recs = []
cs.log = recs.append
cs.phase_kv_quant_kernels(torch, F, torch.device("cuda", 0))
print(json.dumps([{k: r.get(k) for k in ("check", "case", "err_over_tol")}
                  for r in recs]))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", help="append the JSON result lines to this file")
    args = ap.parse_args()
    failed = False
    for name, (old, new) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(os.path.join(ROOT, "pyramidkv_tpu_torch"),
                            os.path.join(tmp, "pyramidkv_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
            path = os.path.join(tmp, HEADER)
            with open(path) as f:
                src = f.read()
            assert src.count(old) == 1, name
            with open(path, "w") as f:
                f.write(src.replace(old, new))
            res = subprocess.run([sys.executable, "-c", _RUN], cwd=tmp,
                                 capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        recs = json.loads(res.stdout.strip().splitlines()[-1])
        main_r = [r["err_over_tol"] for r in recs if r["case"] != "short"]
        short_r = [r["err_over_tol"] for r in recs if r["case"] == "short"]
        caught = min(main_r) > 1
        failed |= not caught
        line = json.dumps({"mutant": name, "caught": caught,
                           "min_err_over_tol_main": min(main_r),
                           "min_err_over_tol_short": min(short_r),
                           "checks": recs})
        print(line, flush=True)
        if args.log:
            with open(args.log, "a") as f:
                f.write(line + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
