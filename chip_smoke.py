#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyramidkv_tpu_torch``) on one H100.

    python3 chip_smoke.py            # every phase, needs one CUDA card

Phases (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the main path from ``csrc/``;
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at every shape the engine phase gives it (decode: each method's cache
     width, each pyramidkv segment's), with its time, the plain version's
     time, the time of one library call computing the same function (a
     yardstick the port never calls) and the least time the card could take;
  4. engine: ``Engine.generate`` on Llama-3-8B geometry (all 32 layers,
     seeded random bf16 weights made on the card), 4 requests of
     8000/6000/3000/1000 tokens, 32 new tokens, for fullkv, snapkv and
     pyramidkv, with the kernels' launch counts of each run;
  5. parity: last-position prefill logits through the kernels against the
     plain path, at depth 2 with the same widths;
  6. profile: where the time goes in one snapkv prefill and 8 decode steps
     (host wall time, device busy time and top kernels from torch.profiler).
The line before the last lists every kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (dense bf16 tensor-core rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: the main path's shapes: Llama-3-8B heads, bucket 8192, 4 requests
B, H, HK, D, N, LAYERS = 4, 32, 8, 128, 8192, 32
TRUE_LEN = (8000, 6000, 3000, 1000)
MAX_NEW = 32
#: bf16 keeps 8 significant bits.  A kernel and its plain version round at
#: different points: outputs (at most half an ulp, 2^-9 |x|, each side),
#: probabilities (each moves an output by ~2^-9 of its row's rms, at
#: random) and, in the flash kernel as on the TPU, q * scale * log2(e).
#: Over the ~10^8 elements of a main-path check the largest of that noise
#: reaches ~2^-6 of the row's rms.  So an element passes within two ulps
#: of itself plus twice that largest noise:
#:     |got - want| <= 2^-6 |want| + 2^-5 rms(want's row over D).
#: Attention over n visible unit-normal keys gives outputs of rms about
#: sqrt(e/n), 0.02-0.05 at the main path's n, where a typical element's
#: limit is 3 * 2^-6 * rms = 1e-3 to 2.3e-3; each check logs its rms.
KERNEL_RTOL, KERNEL_ROW_TOL = 2.0 ** -6, 2.0 ** -5
TOL_TEXT = "|err| <= 2^-6 |want| + 2^-5 rms(want's row)"


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def plan_for(method: str):
    """The engine phase's plan for ``method`` (Llama-3-8B, bucket N)."""
    from pyramidkv_tpu_torch.config import CompressionSpec
    from pyramidkv_tpu_torch.policy import make_plan

    return make_plan(CompressionSpec(method=method), LAYERS, N, MAX_NEW)


def err_over_tol(got, want) -> float:
    """Largest |got - want| / (its limit, TOL_TEXT): <= 1 passes."""
    g, w = got.float(), want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    lim = (KERNEL_RTOL * w.abs() + KERNEL_ROW_TOL * rms).clamp_min(1e-30)
    return float(((g - w).abs() / lim).max())


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms, what bounds it) at the H100's published peaks."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms per call over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def check_flash(torch, F, dev, b, h, hk, n, true_len, window, timed, seed):
    from pyramidkv_tpu_torch.kernels import flash_causal_attention
    from pyramidkv_tpu_torch.ops.attention import causal_prefill_attention

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, n, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, hk, n, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, hk, n, D), generator=g, device=dev).to(torch.bfloat16)
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
    got = flash_causal_attention(q, k, v, tl, sliding_window=window)
    want = causal_prefill_attention(q, k, v, true_len=tl,
                                    sliding_window=window)
    torch.cuda.synchronize()
    err = ratio = sq = 0.0
    for bi, t in enumerate(true_len):  # rows >= pad: JAX leaves pad rows open
        gb, wb = got[bi, :, n - t:], want[bi, :, n - t:]
        err = max(err, float((gb.float() - wb.float()).abs().max()))
        ratio = max(ratio, err_over_tol(gb, wb))
        sq += float(wb.float().square().sum())
    rms = (sq / (h * sum(true_len) * D)) ** 0.5
    pad_rows_zero = all(
        bool((got[bi, :, :n - t] == 0).all()) for bi, t in enumerate(true_len))
    rec = {"check": "flash_causal_attention", "B": b, "H": h, "Hk": hk,
           "N": n, "true_len": list(true_len), "window": window,
           "max_abs_err": err, "err_over_tol": ratio, "tol": TOL_TEXT,
           "rms": rms, "pad_rows_zero": pad_rows_zero}
    if timed:
        rec["ms"] = time_ms(torch, lambda: flash_causal_attention(
            q, k, v, tl, sliding_window=window), reps=10)
        rec["plain_ms"] = time_ms(torch, lambda: causal_prefill_attention(
            q, k, v, true_len=tl, sliding_window=window), reps=2)
        # library yardstick: SDPA with the equivalent boolean mask (K/V
        # repeated to the query heads outside the timed call)
        kr = k.repeat_interleave(h // hk, dim=1)
        vr = v.repeat_interleave(h // hk, dim=1)
        col = torch.arange(n, device=dev)
        pad = (n - tl.long())[:, None, None, None]
        m = (col[None, None, None, :] <= col[None, None, :, None]) \
            & (col[None, None, None, :] >= pad)
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=m), reps=3)
        del kr, vr, m
        tls = np.asarray(true_len, np.float64)
        pairs = float((tls * (tls + 1) / 2).sum())  # visible (row, col) pairs
        flops = 4.0 * D * h * pairs
        nbytes = (h * tls.sum() * D * 2 + 2 * hk * tls.sum() * D * 2
                  + b * h * n * D * 2 + b * 4)
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
    log(rec)
    ok = ratio <= 1 and pad_rows_zero and bool(torch.isfinite(got).all())
    return ok, rec


def check_decode(torch, F, dev, b, h, hk, s, timed, seed, label):
    from pyramidkv_tpu_torch.kernels import decode_attention
    from pyramidkv_tpu_torch.ops.attention import decode_attention as plain

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, hk, s, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, hk, s, D), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.rand((b, hk, s), generator=g, device=dev) < 0.7
    mask[0, 0] = False  # one all-masked row: uniform average, as on the TPU
    got = decode_attention(q, k, v, mask)
    want = plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ratio = err_over_tol(got, want)
    rec = {"check": "decode_attention", "case": label, "B": b, "H": h,
           "Hk": hk, "S": s, "max_abs_err": err, "err_over_tol": ratio,
           "tol": TOL_TEXT, "rms": float(want.float().square().mean().sqrt())}
    if timed:
        rec["ms"] = time_ms(torch, lambda: decode_attention(q, k, v, mask),
                            reps=50)
        rec["plain_ms"] = time_ms(torch, lambda: plain(q, k, v, mask), reps=10)
        kr = k.repeat_interleave(h // hk, dim=1)
        vr = v.repeat_interleave(h // hk, dim=1)
        mr = mask.repeat_interleave(h // hk, dim=1)[:, :, None, :]
        q4 = q[:, :, None, :]
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kr, vr, attn_mask=mr), reps=50)
        del kr, vr, mr
        valid = float(mask.sum())
        flops = 4.0 * D * (h // hk) * valid
        nbytes = valid * D * 2 * 2 + b * hk * s + 2 * b * h * D * 2
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
    log(rec)
    ok = ratio <= 1 and bool(torch.isfinite(got).all())
    return ok, rec


def phase_kernels(torch, F, dev):
    """Every kernel at every shape the engine phase gives it: flash at the
    bucket; decode at snapkv's cache width (per-head, G=1), at each of
    pyramidkv's segment widths (G=1) and at fullkv's (true GQA, G=4).
    Returns (ok, {"flash": rec, method: [rec per segment], ...})."""
    ok = True
    # short shapes first: ragged pads, a window, every group size
    for args in ((2, 4, 2, 256, (256, 77), None), (2, 4, 4, 192, (150, 3), 50),
                 (1, 8, 1, 128, (128,), None)):
        r, _ = check_flash(torch, F, dev, *args, timed=False, seed=1)
        ok &= r
    for i, (b, h, hk, s) in enumerate(((2, 4, 4, 37), (2, 8, 4, 300),
                                       (1, 16, 4, 1), (3, 16, 2, 4099))):
        r, _ = check_decode(torch, F, dev, b, h, hk, s, timed=False,
                            seed=2 + i, label="short")
        ok &= r
    # the main path's shapes, timed
    r, flash = check_flash(torch, F, dev, B, H, HK, N, TRUE_LEN, None,
                           timed=True, seed=3)
    ok &= r
    recs = {"flash": flash}
    seed = 4
    for method, hk in (("snapkv", H), ("pyramidkv", H), ("fullkv", HK)):
        recs[method] = []
        for start, stop, p in plan_for(method).segment_plans():
            r, rec = check_decode(
                torch, F, dev, B, H, hk, p.total_slots, timed=True, seed=seed,
                label=f"{method} layers {start}-{stop - 1}, G={H // hk}")
            rec["layers"] = stop - start
            recs[method].append(rec)
            ok &= r
            seed += 1
    return ok, recs


def reset_counts():
    from pyramidkv_tpu_torch.kernels import (decode_attention,
                                             flash_causal_attention)

    flash_causal_attention.launches = 0
    decode_attention.launches = 0


def read_counts() -> dict:
    from pyramidkv_tpu_torch.kernels import (decode_attention,
                                             flash_causal_attention)

    return {"flash_causal_attention": flash_causal_attention.launches,
            "decode_attention": decode_attention.launches}


def phase_engine(torch, dev, params, vocab):
    from pyramidkv_tpu_torch.config import (CompressionSpec, EngineSpec,
                                            ModelSpec)
    from pyramidkv_tpu_torch.engine import Engine

    spec = ModelSpec.preset("llama3-8b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=t).tolist() for t in TRUE_LEN]
    ok = True
    counts = {}
    for method in ("fullkv", "snapkv", "pyramidkv"):
        eng = Engine(spec, CompressionSpec(method=method),
                     EngineSpec(max_new_tokens=MAX_NEW,
                                prefill_buckets=(N,)),
                     params, device=dev)
        eng.generate([p[:64] for p in prompts])  # warm-up (bucket 8192)
        torch.cuda.synchronize()
        reset_counts()
        out = eng.generate(prompts)
        c = read_counts()
        counts[method] = c
        toks = [t for seq in out.tokens for t in seq]
        plan = eng.plan_for(N)
        good = (plan.segments == plan_for(method).segments  # shapes held
                and all(v > 0 for v in c.values())
                and all(0 <= t < vocab for t in toks)
                and all(len(seq) >= 1 for seq in out.tokens))
        log({"phase": "engine", "method": method,
             "prefill_s": out.prefill_seconds,
             "decode_s": out.decode_seconds,
             "decode_steps": out.decode_steps,
             "decode_tok_per_s": (out.decode_steps * len(prompts)
                                  / out.decode_seconds
                                  if out.decode_seconds else None),
             "kv_cache_bytes": out.kv_cache_bytes,
             "segments": [list(s) for s in plan.segments],
             "tokens_per_request": [len(s) for s in out.tokens],
             "launches": c, "ok": good})
        ok &= good
        del eng, out
        torch.cuda.empty_cache()
    return ok, counts


def phase_parity(torch, dev, params, vocab):
    """Depth-2 prefill logits: kernels vs the plain functions.  The logits
    do not depend on the compression method (compression reads q/k/v and
    feeds nothing back), so one method (fullkv) is run."""
    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b", num_hidden_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, size=(B, N)).astype(np.int64)).to(dev)
    tl = torch.tensor(TRUE_LEN, dtype=torch.int32, device=dev)
    plan = make_plan(CompressionSpec(method="fullkv"), 2, N, MAX_NEW)
    with torch.no_grad():
        lk, _ = llama.prefill(p2, spec, plan, tokens, tl,
                              attention_impl="kernel")
        lp, _ = llama.prefill(p2, spec, plan, tokens, tl,
                              attention_impl="plain")
    torch.cuda.synchronize()
    err = float((lk - lp).abs().max())
    # the two attention paths round to bf16 at different points
    # (KERNEL_RTOL); two layers carry that into the hidden state, and the
    # bf16 lm_head rounds the logits again (2^-8 relative): allow 2^-5 of
    # the largest logit, eight bf16 roundings' worth
    tol = 2.0 ** -5 * float(lp.abs().max())
    ok = (err <= tol and bool(torch.isfinite(lk).all())
          and tuple(lk.shape) == (B, vocab))
    log({"phase": "parity", "method": "fullkv", "depth": 2,
         "max_abs_err": err, "tol": tol,
         "same_argmax": bool((lk.argmax(-1) == lp.argmax(-1)).all()),
         "ok": ok})
    return ok


def phase_profile(torch, dev, params, vocab, method="snapkv", steps=8):
    """Where the time goes in one prefill and in ``steps`` decode steps:
    host wall time of an unprofiled run, device busy time and the top
    kernels from a torch.profiler trace of a second run (device-side events
    only, so an op and its kernels are not counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b")
    plan = make_plan(CompressionSpec(method=method), spec.num_hidden_layers,
                     N, MAX_NEW)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, size=(B, N)).astype(np.int64)).to(dev)
    tl = torch.tensor(TRUE_LEN, dtype=torch.int32, device=dev)

    def prefill():
        return llama.prefill(params, spec, plan, tokens, tl)

    def decode(cache, tok):
        for _ in range(steps):
            _, cache = llama.decode_step(params, spec, plan, cache, tok)
        return cache

    def wall(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def device_profile(fn, *a):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*a)
            torch.cuda.synchronize()
        ev = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        top = sorted(ev, key=lambda x: -x[1])[:10]
        return sum(t for _, t, _ in ev) / 1e6, [
            {"kernel": k[:90], "device_ms": t / 1e3, "calls": c}
            for k, t, c in top]

    with torch.inference_mode():
        prefill()  # warm-up
        (logits, cache), pre_wall = wall(prefill)
        tok = logits.argmax(-1)
        decode(cache, tok)  # warm-up (writes decode slots 0..steps-1)
        cache.step = 0
        _, dec_wall = wall(decode, cache, tok)
        cache.step = 0
        pre_busy, pre_top = device_profile(prefill)
        dec_busy, dec_top = device_profile(decode, cache, tok)
    for part, w, busy, top in (("prefill", pre_wall, pre_busy, pre_top),
                               ("decode", dec_wall, dec_busy, dec_top)):
        log({"phase": "profile", "method": method, "part": part,
             "steps": steps if part == "decode" else None,
             "wall_s": w, "device_busy_s": busy,
             "idle_share": max(0.0, 1 - busy / w), "top": top})
    return True


def kernel_entry(name, source, replaces, launches, recs):
    """One entry of the kernels line.  ``recs`` holds one timed check per
    shape the kernel runs at in these launches (pyramidkv: one per
    segment, each launched once per layer per decode step); times and
    bounds are means per launch, weighted by each shape's layers."""
    w = [r.get("layers", 1) for r in recs]

    def mean(key):
        return sum(wi * r[key] for wi, r in zip(w, recs)) / sum(w)

    ent = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in recs),
           "ms": mean("ms"), "plain_ms": mean("plain_ms"),
           "bound_ms": mean("bound_ms"),
           # what bounds the shape that contributes most to the bound
           "bound_by": max(zip(w, recs), key=lambda x: x[0] * x[1][
               "bound_ms"])[1]["bound_by"],
           "library_ms": mean("library_ms")}
    if len(recs) > 1:
        ent["shapes"] = [{k: r[k] for k in ("S", "layers", "max_abs_err",
                                            "ms", "plain_ms", "bound_ms",
                                            "library_ms")} for r in recs]
    return ent


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port itself: without it (a directory holding only this script)
    # the import fails here, before anything is printed
    from pyramidkv_tpu_torch.config import ModelSpec
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.models.convert import init_params

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log({"phase": "device", "torch": torch.__version__,
         "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    secs = _build.build_all()
    log({"phase": "build", "seconds": secs})
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"nvcc {name}: {line.strip()}", flush=True)

    ok, recs = phase_kernels(torch, F, dev)

    spec = ModelSpec.preset("llama3-8b")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(spec, gen, dev, torch.bfloat16)
    torch.cuda.synchronize()
    log({"phase": "init_params", "seconds": time.perf_counter() - t0,
         "gib": sum(t.numel() * t.element_size() for t in
                    [params["embed"], params["lm_head"],
                     *params["layers"].values()]) / 2 ** 30})
    r, counts = phase_engine(torch, dev, params, spec.vocab_size)
    ok &= r
    ok &= phase_parity(torch, dev, params, spec.vocab_size)
    ok &= phase_profile(torch, dev, params, spec.vocab_size)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    src = "pyramidkv_tpu_torch/csrc/"
    kernels = [
        kernel_entry(
            "flash_causal_attention", src + "flash_prefill.cu",
            "pyramidkv_tpu/kernels/flash_prefill.py:420",
            sum(c["flash_causal_attention"] for c in counts.values()),
            [recs["flash"]]),
    ]
    for method in ("snapkv", "pyramidkv", "fullkv"):
        shapes = "/".join(str(r["S"]) for r in recs[method])
        g = H // recs[method][0]["Hk"]
        kernels.append(kernel_entry(
            f"decode_attention ({method}, G={g}, S={shapes})",
            src + "decode_attn.cu", "pyramidkv_tpu/kernels/decode_attn.py:69",
            counts[method]["decode_attention"], recs[method]))
    for k in kernels:  # one line per kernel, with its tolerance
        log({"kernel": k["name"], "tol": TOL_TEXT, **k})
    log({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
