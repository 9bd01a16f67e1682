#!/usr/bin/env python3
"""H2O prefill walls and kernel times of the port with two builds of its
H2O kernels, on one CUDA card.

    python3 scripts/port_h2o_ab.py --other PATH [--log FILE]

``PATH`` is another ``h2o_scores.cu`` with the C entry points of the
parent commit's (``pkv_h2o_stats`` / ``pkv_h2o_colsum`` taking the
unscaled query and the scale log2(e)/sqrt(D)), for example
``git show HEAD~1:pyramidkv_tpu_torch/csrc/h2o_scores.cu`` written to a
directory inside the repository.  The script builds the package's
``csrc/h2o_scores.cu`` ("new", which takes the pre-scaled query) and PATH
("other") with the package's nvcc flags, then times the prefill of runs
(a) and (b) of ``chip_smoke.py`` (Llama-3-8B geometry, 32 layers, seeded
random weights): (a) H2O on the bf16 8k batch of 8000/6000/3000/1000
tokens, (b) H2O on bench.py's 32k prompt with int4 weights.  The "other"
turns score through the other library (the engine's H2O scorer swapped
for one calling it); each prefill runs once to warm up, then in turns
other, new, new, other (host seconds around a prefill that ends in a
synchronize), and the runs' first-token logits from the two builds are
compared (largest difference over the largest logit; the scores select
the cache after the prefill's logits are formed, so these should not
move) with the positions each kept in the cache (the share of slots
equal: what the scores decide).  Then both kernels
alone at the 8k batch and at 32k, W = 8, in the same turns (device ms a
call, CUDA events over 5 calls, random inputs from a seed; "new" times
the kernel call without the wrapper's query scaling, which the parent's
kernels do inside).  Prints one JSON line per run and per kernel shape.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the parent's C signatures: the unscaled query and the scale
OTHER_ENTRY_POINTS = [("pkv_h2o_stats", [_P] * 5 + [_I] * 5 + [_F, _P]),
                      ("pkv_h2o_colsum", [_P] * 6 + [_I] * 5 + [_F, _P])]


def build_other(path: str, out_dir: str):
    """The H2O library built from ``path``, bound with the parent's C
    signatures."""
    from pyramidkv_tpu_torch.kernels import _build

    lib_path = os.path.join(out_dir, "libh2o_other.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", lib_path, path], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    for symbol, argtypes in OTHER_ENTRY_POINTS:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def other_calls(torch, lib):
    """(stats, colsum, scores) through the other library: the wrappers'
    signatures, the unscaled query and the scale passed as its kernels
    take them."""
    h2o = importlib.import_module("pyramidkv_tpu_torch.kernels.h2o_scores")

    def dims(q, k, w):
        b, h, n, d = q.shape
        return (b, h, k.shape[1], n, w, math.log2(math.e) / math.sqrt(d),
                torch.cuda.current_stream(q.device).cuda_stream)

    def stats(q, k, *, window_size, true_len):
        tl = h2o._check(q, k, window_size, true_len)
        m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        err = lib.pkv_h2o_stats(q.data_ptr(), k.data_ptr(), tl.data_ptr(),
                                m.data_ptr(), l.data_ptr(),
                                *dims(q, k, window_size))
        if err:
            raise RuntimeError(f"other h2o_stats: CUDA error {err}")
        return m, l

    def colsum(q, k, m, l, *, window_size, true_len):
        tl = h2o._check(q, k, window_size, true_len)
        b, h, n, _ = q.shape
        out = torch.empty((b, h, n - window_size), dtype=torch.float32,
                          device=q.device)
        err = lib.pkv_h2o_colsum(q.data_ptr(), k.data_ptr(), tl.data_ptr(),
                                 m.data_ptr(), l.data_ptr(), out.data_ptr(),
                                 *dims(q, k, window_size))
        if err:
            raise RuntimeError(f"other h2o_colsum: CUDA error {err}")
        return out

    def scores(q, k, *, window_size, true_len):
        m, l = stats(q, k, window_size=window_size, true_len=true_len)
        return colsum(q, k, m, l, window_size=window_size,
                      true_len=true_len)

    return stats, colsum, scores


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="another h2o_scores.cu (the parent's C entries) to "
                         "time beside the package's")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyramidkv_tpu_torch import policy
    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.models.convert import init_params

    if not torch.cuda.is_available():
        print("port_h2o_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.library("h2o_scores")
    other = other_calls(torch, build_other(args.other, tempfile.mkdtemp()))
    scorers = {"new": policy.h2o_kernel, "other": other[2]}
    out_f = open(args.log, "a") if args.log else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    spec = ModelSpec.preset("llama3-8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(spec, gen, dev, torch.bfloat16)
    q4 = cs.quantized(params, "int4")
    vocab = spec.vocab_size
    p32 = [np.random.default_rng(0).integers(0, vocab, size=cs.QTRUE)
           .tolist()]
    rng = np.random.default_rng(0)
    p8 = [rng.integers(0, vocab, size=t).tolist() for t in cs.TRUE_LEN]
    with torch.inference_mode():
        for run in ("(a) bf16 h2o 8k", "(b) int4 h2o 32k"):
            comp, bucket, _, chunk = cs.chunk_run_spec(run)
            wts = q4 if cs.CHUNK_RUNS[run][0] == "int4" else params
            eng = Engine(spec, comp, EngineSpec(max_new_tokens=8,
                                                prefill_buckets=(bucket,),
                                                prefill_chunk=chunk),
                         wts, device=dev)
            tokens, tl = cs.bucket_tokens(torch, dev,
                                          p32 if bucket == cs.QN else p8,
                                          bucket)
            walls = {"new": [], "other": []}
            logits, kept = {}, {}
            try:
                for turn in ("new", "other", "new", "new", "other"):
                    policy.h2o_kernel = scorers[turn]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = cs.prefill_with(eng, bucket, tokens, tl, "kernel")
                    torch.cuda.synchronize()
                    walls[turn].append(time.perf_counter() - t0)
                    logits[turn] = res[0].float()  # [B, vocab], the last
                    pos = res[1].positions
                    kept[turn] = torch.cat([
                        p.reshape(-1) for p in (
                            pos if isinstance(pos, (tuple, list))
                            else (pos,))])
                    del res, pos
            finally:
                policy.h2o_kernel = scorers["new"]
            walls["new"].pop(0)  # the warm-up
            diff = float((logits["new"] - logits["other"]).abs().max()
                         / logits["other"].abs().max())
            emit({"run": run, "device": smi, "prefill_s_new": walls["new"],
                  "prefill_s_other": walls["other"],
                  "logits_max_diff_rel": diff,
                  "kept_positions_equal": float(
                      (kept["new"] == kept["other"]).float().mean())})
            del eng
            torch.cuda.empty_cache()
        del params, q4
        torch.cuda.empty_cache()
        time_kernels(torch, cs, dev, other, smi, emit)
    return 0


def time_kernels(torch, cs, dev, other, smi, emit):
    """Both kernels with each library, in turns other, new, new, other."""
    h2o = importlib.import_module("pyramidkv_tpu_torch.kernels.h2o_scores")

    g = torch.Generator(device=dev).manual_seed(3)
    for case, b, n, tls in (("8k batch", cs.B, cs.N, cs.TRUE_LEN),
                            ("32k", 1, cs.QN, (cs.QTRUE,))):
        q = cs._rand_bf16(torch, g, dev, b, cs.H, n, cs.D)
        k = cs._rand_bf16(torch, g, dev, b, cs.HK, n, cs.D)
        tl = torch.tensor(tls, dtype=torch.int32, device=dev)
        kw = dict(window_size=8, true_len=tl)
        qs = h2o.scaled_query(q)
        m, l = h2o._stats(qs, k, tl, 8)
        fns = {"stats": {"new": lambda: h2o._stats(qs, k, tl, 8),
                         "other": lambda: other[0](q, k, **kw)},
               "colsum": {"new": lambda: h2o._colsum(qs, k, tl, m, l, 8),
                          "other": lambda: other[1](q, k, m, l, **kw)}}
        for name, fn in fns.items():
            ms = {"new": [], "other": []}
            for turn in ("other", "new", "new", "other"):
                ms[turn].append(cs.time_ms(torch, fn[turn], reps=5))
            emit({"kernel": name, "case": case, "device": smi,
                  "ms_new": ms["new"], "ms_other": ms["other"]})
        del q, k, qs, m, l
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
