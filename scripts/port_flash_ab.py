#!/usr/bin/env python3
"""Prefill walls of the port with two builds of its flash kernels, on one
CUDA card.

    python3 scripts/port_flash_ab.py --other PATH [--runs NAMES] [--log FILE]

``PATH`` is another ``flash_prefill.cu`` with the same C entry points (for
example the parent commit's, from ``git show``).  The script builds the
package's ``csrc/flash_prefill.cu`` ("new") and PATH ("other") with the
package's nvcc flags, then times the prefill of four engine runs of
``chip_smoke.py`` (Llama-3-8B geometry, 32 layers, seeded random weights):

- int4 fullkv, bench.py's 32k prompt (the one-pass flash kernel);
- bf16 snapkv, the 8k batch of 8000/6000/3000/1000 tokens (one-pass);
- run (c): bf16 snapkv, the 8k batch, ``prefill_chunk=2048`` (flash at
  ``q_start``);
- run (e): int4 fullkv kivi4-pa, the 32k prompt, ``prefill_chunk=8192``
  (``flash_attention_partials``);
- runs (g) and (h): ``prefill_two_pass=True`` on bf16 snapkv, the 8k
  batch, and int4 snapkv, the 32k prompt (pass A and pass B).

``--runs``: comma-separated prefixes of the run names to time (default:
every run).

Each prefill runs once to warm up, then in turns other, new, new, other
(host seconds around a prefill that ends in a synchronize).  Each run's
first-token logits from the two builds are compared (largest difference
over the largest logit).  Then the kernels alone, in the same turns: the
one-pass kernel, pass A and pass B of the two-pass schedule at the 8k
batch and at the 32k prompt (device ms a call, CUDA events over 5 calls,
random inputs from a seed).  Prints one JSON line per run and per
kernel shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_other(path: str, out_dir: str):
    """The flash library built from ``path``, bound as the package binds
    its own."""
    from pyramidkv_tpu_torch.kernels import _build

    lib_path = os.path.join(out_dir, "libflash_other.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", lib_path, path], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    for symbol, argtypes in _build.ENTRY_POINTS["flash_prefill"]:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="another flash_prefill.cu to time beside the "
                         "package's")
    ap.add_argument("--runs", help="comma-separated prefixes of the runs "
                    "to time (default: all)")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch.config import (CompressionSpec, EngineSpec,
                                            ModelSpec)
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.models.convert import init_params

    if not torch.cuda.is_available():
        print("port_flash_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = {"new": _build.library("flash_prefill")}
    tmp = tempfile.mkdtemp()
    libs["other"] = build_other(args.other, tmp)

    spec = ModelSpec.preset("llama3-8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(spec, gen, dev, torch.bfloat16)
    q4 = cs.quantized(params, "int4")
    vocab = spec.vocab_size
    p32 = [np.random.default_rng(0).integers(0, vocab, size=cs.QTRUE)
           .tolist()]
    rng = np.random.default_rng(0)
    p8 = [rng.integers(0, vocab, size=t).tolist() for t in cs.TRUE_LEN]
    # name -> (weights, compression, bucket, chunk, prompts, two-pass)
    runs = {
        "int4 fullkv 32k": (q4, CompressionSpec(method="fullkv", **cs.QCOMP),
                            cs.QN, None, p32, False),
        "bf16 snapkv 8k batch": (params, CompressionSpec(method="snapkv"),
                                 cs.N, None, p8, False),
    }
    for run in ("(c) bf16 snapkv 8k chunk 2048",
                "(e) int4 fullkv kivi4-pa 32k chunk 8192"):
        comp, bucket, _, chunk = cs.chunk_run_spec(run)
        runs[run] = (q4 if cs.CHUNK_RUNS[run][0] == "int4" else params, comp,
                     bucket, chunk, p32 if bucket == cs.QN else p8, False)
    runs["(g) bf16 snapkv 8k two-pass"] = (
        params, CompressionSpec(method="snapkv"), cs.N, None, p8, True)
    runs["(h) int4 snapkv 32k two-pass"] = (
        q4, CompressionSpec(method="snapkv", **cs.QCOMP), cs.QN, None, p32,
        True)
    if args.runs:
        runs = {k: v for k, v in runs.items()
                if k.startswith(tuple(args.runs.split(",")))}
    out_f = open(args.log, "a") if args.log else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    with torch.inference_mode():
        for run, (wts, comp, bucket, chunk, prompts,
                  two_pass) in runs.items():
            eng = Engine(spec, comp, EngineSpec(max_new_tokens=8,
                                                prefill_buckets=(bucket,),
                                                prefill_chunk=chunk),
                         wts, device=dev)
            tokens, tl = cs.bucket_tokens(torch, dev, prompts, bucket)
            walls = {"new": [], "other": []}
            logits = {}
            for turn in ("new", "other", "new", "new", "other"):
                _build._loaded["flash_prefill"] = libs[turn]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = (llama.prefill(wts, spec, eng.plan_for(bucket), tokens,
                                     tl, prefill_two_pass=True) if two_pass
                       else cs.prefill_with(eng, bucket, tokens, tl,
                                            "kernel"))
                torch.cuda.synchronize()
                walls[turn].append(time.perf_counter() - t0)
                logits[turn] = res[0].float()  # [B, vocab], the last position
                del res
            walls["new"].pop(0)  # the warm-up
            _build._loaded["flash_prefill"] = libs["new"]
            diff = float((logits["new"] - logits["other"]).abs().max()
                         / logits["other"].abs().max())
            emit({"run": run, "device": smi, "prefill_s_new": walls["new"],
                  "prefill_s_other": walls["other"],
                  "logits_max_diff_rel": diff})
            del eng
            torch.cuda.empty_cache()
        del params, q4
        torch.cuda.empty_cache()
        time_kernels(torch, cs, dev, libs, smi, emit)
    _build._loaded["flash_prefill"] = libs["new"]
    return 0


def time_kernels(torch, cs, dev, libs, smi, emit):
    """The one-pass kernel and both passes of the two-pass schedule with
    each library, in turns other, new, new, other."""
    from pyramidkv_tpu_torch.kernels import (_build, flash_causal_attention,
                                             flash_pass_b, flash_row_max)

    g = torch.Generator(device=dev).manual_seed(3)
    for case, b, n, tls in (("8k batch", cs.B, cs.N, cs.TRUE_LEN),
                            ("32k", 1, cs.QN, (cs.QTRUE,))):
        q = cs._rand_bf16(torch, g, dev, b, cs.H, n, cs.D)
        k, v = (cs._rand_bf16(torch, g, dev, b, cs.HK, n, cs.D)
                for _ in range(2))
        tl = torch.tensor(tls, dtype=torch.int32, device=dev)
        m = flash_row_max(q, k, tl)
        fns = {"one_pass": lambda: flash_causal_attention(q, k, v, tl),
               "pass_a": lambda: flash_row_max(q, k, tl),
               "pass_b": lambda: flash_pass_b(q, k, v, m, tl)}
        for name, fn in fns.items():
            ms = {"new": [], "other": []}
            for turn in ("other", "new", "new", "other"):
                _build._loaded["flash_prefill"] = libs[turn]
                ms[turn].append(cs.time_ms(torch, fn, reps=5))
            emit({"kernel": name, "case": case, "device": smi,
                  "ms_new": ms["new"], "ms_other": ms["other"]})
        del q, k, v, m
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
