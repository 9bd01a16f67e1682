#!/usr/bin/env python3
"""MInference's vertical and grid slash kernels of the port beside other
builds of ``csrc/block_sparse_prefill.cu``, on one CUDA card.

    python3 scripts/port_minference_ab.py --other PATH [--other PATH2 ...]
        [--no-prefill] [--log FILE]

Each ``PATH`` is another ``block_sparse_prefill.cu``: the parent commit's
(``git show HEAD~1:pyramidkv_tpu_torch/csrc/block_sparse_prefill.cu``
written to a directory inside the repository; its C entries take the
vertical columns unsorted and the slash flags as bytes) or an edited copy
of the package's source (the package's C entries, told apart by
``pkv_slash_tiles`` taking ``vbits``).  Each builds with the package's nvcc
flags (``-I csrc``).  The script times, in turns (each other build, the
package's twice, the others again in reverse), device ms a call (a CUDA
graph of 10 calls, ``chip_smoke.graph_ms``):

- both kernels at ``chip_smoke.SPARSE_CASES``' "32k", "32k pcfg" and "8k"
  shapes, on the pattern ``estimate_vertical_slash`` makes from seeded
  random q/k (the package's wrapper times include its sort and bit
  packing; the parent's wrappers had neither), with each build's largest
  partials error against the package's (``chip_smoke.partials_ratio``);
- unless ``--no-prefill``, the 32k int4 MInference prefill of
  ``chip_smoke.py``'s profile_minference (Llama-3-8B geometry, 32 layers,
  seeded random weights; host seconds around a prefill that ends in a
  synchronize, one warm-up a build), the other builds' kernels swapped in
  for the package's, and the largest difference of its last-position
  logits from the package's over the largest logit.

Prints the card's name and power limit, then one JSON line per shape and
per prefill.
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
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the parent's C signatures (unsorted vertical columns, slash flag bytes)
PARENT_ENTRY_POINTS = [
    ("pkv_slash_tiles", [_P] * 10 + [_I] * 7 + [_F, _P]),
    ("pkv_vertical_partials", [_P] * 8 + [_I] * 4 + [_F, _P])]
CASES = ("32k", "32k pcfg", "8k")


def build(path: str, out_dir: str, label: str):
    """(library, kind) of ``path``: kind "new" for the package's C entries,
    "parent" for the parent's."""
    from pyramidkv_tpu_torch.kernels import _build

    with open(path) as f:
        kind = "new" if "const void* vbits" in f.read() else "parent"
    lib_path = os.path.join(out_dir, f"libbsp_{label}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", lib_path, path], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    table = (dict(_build.ENTRY_POINTS["block_sparse_prefill"]) if kind ==
             "new" else dict(PARENT_ENTRY_POINTS))
    for symbol in ("pkv_slash_tiles", "pkv_vertical_partials"):
        fn = getattr(lib, symbol)
        fn.argtypes = table[symbol]
        fn.restype = ctypes.c_int
    return lib, kind


def calls(torch, lib, kind):
    """(vertical, slash) with the wrappers' signatures through ``lib``."""
    from pyramidkv_tpu_torch.kernels import block_sparse_prefill as bsp

    def vertical(q, k_vert, v_vert, vcol, vvalid, true_len, *, scale=None,
                 softcap=None):
        b, h, n, d = q.shape
        vs = k_vert.shape[2]
        acc, m, l = bsp._outputs(q)
        sc = float(scale if scale is not None else 1.0 / math.sqrt(d))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "new":
            order, keys, counts = bsp.sort_vertical_columns(vcol, vvalid, n)
            ks, vsrt = torch.empty_like(k_vert), torch.empty_like(v_vert)
            err = lib.pkv_vertical_partials(
                q.data_ptr(), k_vert.data_ptr(), v_vert.data_ptr(),
                order.data_ptr(), keys.data_ptr(), counts.data_ptr(),
                ks.data_ptr(), vsrt.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), b, h, n, vs, keys.shape[-1], sc, stream)
        else:
            err = lib.pkv_vertical_partials(
                q.data_ptr(), k_vert.data_ptr(), v_vert.data_ptr(),
                vcol.data_ptr(), vvalid.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), b, h, n, vs, sc, stream)
        bsp._build.check(err, "other vertical_partials")
        return acc, m, l

    def slash(q, k, v, tile_idx, tile_valid, vert, true_len, *, q_block,
              k_tile, scale=None, softcap=None):
        b, h, n, d = q.shape
        hk, t = k.shape[1], tile_idx.shape[-1]
        tl = true_len.to(device=q.device, dtype=torch.int32).contiguous()
        acc, m, l = bsp._outputs(q)
        sc = float(scale if scale is not None else 1.0 / math.sqrt(d))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                tile_idx.data_ptr(), tile_valid.data_ptr()]
        outs = [acc.data_ptr(), m.data_ptr(), l.data_ptr()]
        dims = [b, h, hk, n, q_block, k_tile, t]
        if kind == "new":
            vbits = bsp.pack_vertical_bits(vert)
            err = lib.pkv_slash_tiles(*ptrs, vbits.data_ptr(), tl.data_ptr(),
                                      *outs, *dims, vbits.shape[-1], sc,
                                      stream)
        else:
            err = lib.pkv_slash_tiles(*ptrs, vert.data_ptr(), tl.data_ptr(),
                                      *outs, *dims, sc, stream)
        bsp._build.check(err, "other slash_tiles")
        return acc, m, l

    return vertical, slash


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", required=True,
                    help="another block_sparse_prefill.cu (repeatable)")
    ap.add_argument("--no-prefill", action="store_true",
                    help="time the kernels only")
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from pyramidkv_tpu_torch import kernels
    from pyramidkv_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("port_minference_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.library("block_sparse_prefill")
    tmp = tempfile.mkdtemp()
    fns = {"new": (kernels.vertical_attention_partials,
                   kernels.slash_tile_attention)}
    kinds = {}
    for i, path in enumerate(args.other):
        label = f"other{i}:{os.path.basename(os.path.dirname(path))}"
        lib, kinds[label] = build(path, tmp, f"other{i}")
        fns[label] = calls(torch, lib, kinds[label])
    others = [k for k in fns if k != "new"]
    turns = others + ["new", "new"] + others[::-1]
    out_f = open(args.log, "a") if args.log else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    time_kernels(torch, F, cs, dev, fns, turns, kinds, smi, emit)
    if not args.no_prefill:
        time_prefill(torch, cs, dev, fns, turns, smi, emit)
    return 0


def sparse_inputs(torch, cs, dev, case, seed):
    """check_sparse's inputs of one SPARSE_CASES shape: (vertical args,
    slash args, slash keywords)."""
    from pyramidkv_tpu_torch.ops import sparse_prefill as sp

    b, h, hk, n, true_len, budgets, qb, kt, budget = (
        cs.SPARSE_CASES[case][:9])
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, hh, n, cs.D), generator=g, device=dev)
               .to(torch.bfloat16) for hh in (h, hk, hk))
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
    pat = sp.estimate_vertical_slash(q, k, true_len=tl,
                                     **cs.sparse_budgets(torch, dev,
                                                         budgets))
    ti, tv = sp._slash_tile_selection(pat, n, qb, kt, budget)
    kv = sp.gather_vertical_kv(k, v, pat.vert_idx)
    return ((q, *kv, pat.vert_idx, pat.vert_valid, tl),
            (q, k, v, ti, tv, pat.vert, tl), dict(q_block=qb, k_tile=kt))


def time_kernels(torch, F, cs, dev, fns, turns, kinds, smi, emit):
    for seed, case in enumerate(CASES, start=402):
        vargs, sargs, skw = sparse_inputs(torch, cs, dev, case, seed)
        for i, (kernel, args, kw) in enumerate((
                ("vertical_attention_partials", vargs, {}),
                ("slash_tile_attention", sargs, skw))):
            want = fns["new"][i](*args, **kw)
            err = {}
            for label in fns:
                if label != "new":
                    err[label] = cs.partials_ratio(fns[label][i](*args, **kw),
                                                   want)[0]
            ms = {label: [] for label in fns}
            for label in turns:
                fn = fns[label][i]
                ms[label].append(cs.graph_ms(torch, lambda: fn(*args, **kw),
                                             reps=10))
            emit({"kernel": kernel, "case": case, "device": smi,
                  "ms": ms, "kinds": kinds, "err_over_tol_vs_new": err})
            del want
            torch.cuda.empty_cache()
        del vargs, sargs
        torch.cuda.empty_cache()


def time_prefill(torch, cs, dev, fns, turns, smi, emit):
    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.models.convert import init_params
    from pyramidkv_tpu_torch.ops import sparse_prefill as sp
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(spec, gen, dev, torch.bfloat16)
    q4 = cs.quantized(params, "int4")
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(
        0, spec.vocab_size, size=(1, cs.QN)).astype(np.int64)).to(dev)
    tl = torch.tensor((cs.QTRUE,), dtype=torch.int32, device=dev)
    plan = make_plan(CompressionSpec(method="minference"), cs.LAYERS, cs.QN,
                     cs.QMAX_NEW)
    orig = sp._partials_fns
    walls = {label: [] for label in fns}
    logits = {}
    try:
        with torch.inference_mode():
            for label in dict.fromkeys(turns):  # one warm-up a build
                sp._partials_fns = (lambda impl, slash_impl, f=fns[label]:
                                    f)
                llama.prefill(q4, spec, plan, tokens, tl)
            for label in turns:
                sp._partials_fns = (lambda impl, slash_impl, f=fns[label]:
                                    f)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _ = llama.prefill(q4, spec, plan, tokens, tl)
                torch.cuda.synchronize()
                walls[label].append(time.perf_counter() - t0)
                logits[label] = out.float()
                del out
    finally:
        sp._partials_fns = orig
    top = float(logits["new"].abs().max())
    emit({"prefill": "int4 minference 32k", "device": smi,
          "wall_s": walls, "logits_max_diff_rel": {
              label: float((x - logits["new"]).abs().max()) / top
              for label, x in logits.items() if label != "new"}})


if __name__ == "__main__":
    sys.exit(main())
