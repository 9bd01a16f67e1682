#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyramidkv_tpu_torch``) on one H100.

    python3 chip_smoke.py            # every phase, needs one CUDA card
    python3 chip_smoke.py --log FILE # also append every JSON line to FILE

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
     (host wall time, device busy time and top kernels from torch.profiler);
  7. mm_kernels: the weight-quantized matmul kernels (int4 per-channel and
     g128, int8, int4 windowed) against their plain versions at every
     Llama-3-8B decode shape, rows 1 and 8, plus flash prefill at 32k and
     decode attention at the quantized runs' cache widths;
  8. engine_quant: ``Engine.generate`` with quantized weights on bench.py's
     configuration (32 layers, one 32767-token prompt, 128 new tokens,
     snapkv cap 128): int4 fullkv and snapkv, int4-g128, int8 and
     int4 through the windowed kernel, each with its launch counts held to
     the counts its plan implies;
  9. parity_quant: depth-2 prefill logits, kernels against plain, for the
     int4 and int4-g128 weights;
 10. profile_quant: the int4 snapkv run's prefill and 8 decode steps, with
     the matmul kernels' device time per step beside their bound.
The line before the last lists every kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (dense bf16 tensor-core rate, f32 outside the
#: tensor cores, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
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
#: The matmul kernels and their plain versions form the same exact products
#: (nibble or int8 times a bf16 or f32 x) and sum them in f32 in other
#: orders: the f32 results differ by ~2^-18 of the row's rms.  A bf16 output
#: may then round one ulp apart (<= 2^-7 |want|); an f32 output may not.
MM_TOL = {"bf16": (2.0 ** -7, 2.0 ** -14), "f32": (0.0, 2.0 ** -14)}
MM_TOL_TEXT = {"bf16": "|err| <= 2^-7 |want| + 2^-14 rms(want's row)",
               "f32": "|err| <= 2^-14 rms(want's row)"}
#: the quantized path: bench.py's configuration (bench.py:97-159)
QN, QTRUE, QMAX_NEW = 32768, 32767, 128
QCOMP = dict(max_capacity_prompt=128, window_size=8, kernel_size=7,
             pooling="maxpool")
#: quantize_weights arguments of each weight format
QUANT = {
    "int4": dict(nbits=4, lm_head_nbits=4, lm_head_pad_to=4096),
    "int4-g128": dict(nbits=4, group_size=128),
    "int8": dict(nbits=8),
}
#: engine_quant runs: (weights, method, through the windowed int4 kernel)
QRUNS = (("int4", "fullkv", False), ("int4", "snapkv", False),
         ("int4", "snapkv", True), ("int4-g128", "snapkv", False),
         ("int8", "snapkv", False))
MM_KERNELS = ("int4_matmul", "int8_matmul", "int4_matmul_dma")
#: Llama-3-8B decode matmuls: name -> (in, out)
LLAMA_MM = {"wqkv": (4096, 6144), "wo": (4096, 4096),
            "w_gateup": (4096, 28672), "w_down": (14336, 4096),
            "lm_head4": (4096, 131072), "wq": (4096, 4096),
            "wkv": (4096, 1024), "w_gate": (4096, 14336),
            "lm_head8": (4096, 128256)}


#: a file that receives a copy of every JSON line (--log)
LOG_FILE = []


def log(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for f in LOG_FILE:
        f.write(line + "\n")
        f.flush()


def plan_for(method: str):
    """The engine phase's plan for ``method`` (Llama-3-8B, bucket N)."""
    from pyramidkv_tpu_torch.config import CompressionSpec
    from pyramidkv_tpu_torch.policy import make_plan

    return make_plan(CompressionSpec(method=method), LAYERS, N, MAX_NEW)


def err_over_tol(got, want, rtol=KERNEL_RTOL, row_tol=KERNEL_ROW_TOL
                 ) -> float:
    """Largest |got - want| / (its limit, TOL_TEXT by default): <= 1
    passes."""
    g, w = got.float(), want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    lim = (rtol * w.abs() + row_tol * rms).clamp_min(1e-30)
    return float(((g - w).abs() / lim).max())


def bound(flops: float, nbytes: float, peak=PEAK_BF16_FLOPS) -> tuple:
    """(least ms, what bounds it) at the H100's published peaks."""
    t_ops = flops / peak * 1e3
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


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call of ``reps`` calls captured in one CUDA graph
    and replayed: the card's time without the host's per-call overhead
    (Python, allocation, launch), which at the matmul kernels' few-us sizes
    is larger than the kernels themselves.  ``fn`` is called once first."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return time_ms(torch, g.replay, reps=3) / reps


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
        rec["ms"] = graph_ms(torch, lambda: decode_attention(q, k, v, mask),
                             reps=50)
        rec["host_ms"] = time_ms(torch, lambda: decode_attention(
            q, k, v, mask), reps=50)
        rec["plain_ms"] = graph_ms(torch, lambda: plain(q, k, v, mask),
                                   reps=10)
        kr = k.repeat_interleave(h // hk, dim=1)
        vr = v.repeat_interleave(h // hk, dim=1)
        mr = mask.repeat_interleave(h // hk, dim=1)[:, :, None, :]
        q4 = q[:, :, None, :]
        rec["library_ms"] = graph_ms(
            torch, lambda: F.scaled_dot_product_attention(
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


def check_mm(torch, dev, kind, in_dim, out, rows, xdt, timed, seed, label,
             gs=0):
    """One matmul kernel against its plain version on random codes (every
    byte value), scales and x.  ``kind``: int4_matmul, int4_matmul_dma or
    int8_matmul; ``xdt``: "bf16" or "f32"."""
    from pyramidkv_tpu_torch.kernels.int4_matmul import unpack_nibbles
    from pyramidkv_tpu_torch.models.weights import KERNELS

    kern, plain = KERNELS[kind]
    g = torch.Generator(device=dev).manual_seed(seed)
    int4 = kind != "int8_matmul"
    lo = -128 if int4 else -127
    codes = torch.randint(lo, 128, (in_dim, out // 2 if int4 else out),
                          generator=g, device=dev, dtype=torch.int8)
    sshape = (in_dim // gs, out) if gs else (out,)
    qmax = 7.0 if int4 else 127.0
    scale = (0.5 + torch.rand(sshape, generator=g, device=dev)) / (
        qmax * in_dim ** 0.5)
    dt = torch.bfloat16 if xdt == "bf16" else torch.float32
    x = torch.randn((rows, in_dim), generator=g, device=dev).to(dt)
    kw = {"group_size": gs} if kind == "int4_matmul" else {}
    got = kern(x, codes, scale, **kw)
    want = plain(x, codes, scale, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ratio = err_over_tol(got, want, *MM_TOL[xdt])
    rec = {"check": kind, "case": label, "in": in_dim, "out": out,
           "rows": rows, "x": xdt, "group_size": gs, "max_abs_err": err,
           "err_over_tol": ratio, "tol": MM_TOL_TEXT[xdt],
           "rms": float(want.float().square().mean().sqrt())}
    if timed:
        rec["ms"] = graph_ms(torch, lambda: kern(x, codes, scale, **kw),
                             reps=50)
        # back-to-back eager calls: bound by the host at these sizes
        rec["host_ms"] = time_ms(torch, lambda: kern(x, codes, scale, **kw),
                                 reps=50)
        rec["plain_ms"] = graph_ms(torch,
                                   lambda: plain(x, codes, scale, **kw),
                                   reps=3)
        # library yardstick: one bf16 matmul against the weight dequantized
        # to bf16 outside the timed call (it reads 4x / 2x the bytes)
        c = (unpack_nibbles(codes) if int4 else codes).to(torch.bfloat16)
        sc = scale.to(torch.bfloat16)
        deq = ((c.reshape(in_dim // gs, gs, out) * sc[:, None, :]).reshape(
            in_dim, out) if gs else c * sc)
        xb = x.to(torch.bfloat16)
        rec["library_ms"] = graph_ms(torch, lambda: torch.matmul(xb, deq),
                                     reps=20)
        del c, deq
        nbytes = (codes.numel() + scale.numel() * 4 + x.numel()
                  * x.element_size() + got.numel() * got.element_size())
        rec["bound_ms"], rec["bound_by"] = bound(
            2.0 * rows * in_dim * out, nbytes,
            PEAK_BF16_FLOPS if xdt == "bf16" else PEAK_F32_FLOPS)
    log(rec)
    ok = ratio <= 1 and bool(torch.isfinite(got).all()) \
        and got.dtype == x.dtype and tuple(got.shape) == (rows, out)
    return ok, rec


#: each weight format's decode matmuls at Llama-3-8B width (int4: the
#: fused leaves of fuse_packed_matmuls): (kernel, group size, [(shape, x
#: dtype)]); the engine's lm_head x is f32, its layers' x bf16
_INT4_SHAPES = [("wqkv", "bf16"), ("wo", "bf16"), ("w_gateup", "bf16"),
                ("w_down", "bf16"), ("lm_head4", "bf16"), ("lm_head4", "f32")]
MM_CASES = [
    ("int4_matmul", 0, _INT4_SHAPES),
    ("int4_matmul", 128, _INT4_SHAPES[:4]),
    ("int4_matmul_dma", 0, _INT4_SHAPES),
    ("int8_matmul", 0, [("wq", "bf16"), ("wkv", "bf16"), ("w_gate", "bf16"),
                        ("w_down", "bf16"), ("lm_head8", "bf16"),
                        ("lm_head8", "f32")]),
]
#: launches of each shape per decode step (wq/wo, wk/wv, w_gate/w_up: two)
PER_STEP = {"wqkv": LAYERS, "wo": LAYERS, "w_gateup": LAYERS,
            "w_down": LAYERS, "lm_head4": 1, "lm_head8": 1, "wq": 2 * LAYERS,
            "wkv": 2 * LAYERS, "w_gate": 2 * LAYERS}


def phase_mm_kernels(torch, F, dev):
    """The matmul kernels at every Llama-3-8B decode shape (rows 1 and 8),
    after short ragged shapes; flash prefill at the quantized runs' 32k
    bucket; decode attention at their cache widths.  Returns (ok, {entry
    name: [timed recs at rows 1, weighted by launches per step]}, flash
    rec, {method: decode rec})."""
    ok = True
    short = (("int4_matmul", 64, 6, 3, "bf16", 0),      # span 1, odd width
             ("int4_matmul", 96, 38, 5, "f32", 16),     # span 1, grouped
             ("int4_matmul", 4096, 128256, 1, "f32", 0),  # 64128 bytes
             ("int4_matmul", 4096, 4096, 40, "bf16", 0),  # rows 40
             ("int4_matmul", 4096, 4096, 40, "bf16", 128),
             ("int4_matmul_dma", 4096, 4096, 40, "bf16", 0),
             ("int4_matmul_dma", 512, 256, 3, "f32", 0),
             ("int8_matmul", 256, 384, 3, "f32", 0))
    seed = 100
    for kind, i, o, rows, xdt, gs in short:
        r, _ = check_mm(torch, dev, kind, i, o, rows, xdt, False, seed,
                        "short", gs)
        ok &= r
        seed += 1
    entries = {}
    for kind, gs, shapes in MM_CASES:
        name = f"{kind} (g{gs})" if gs else kind
        entries[name] = []
        for shape, xdt in shapes:
            for rows in (1, 8):
                i, o = LLAMA_MM[shape]
                r, rec = check_mm(torch, dev, kind, i, o, rows, xdt, True,
                                  seed, shape, gs)
                ok &= r
                seed += 1
                on_path = rows == 1 and (xdt == "f32") == shape.startswith(
                    "lm_head")
                if on_path:
                    rec["layers"] = PER_STEP[shape]  # launches per step
                    entries[name].append(rec)
    r, flash = check_flash(torch, F, dev, 1, H, HK, QN, (QTRUE,), None,
                           timed=True, seed=3)
    ok &= r
    decode = {}
    for method, hk in (("snapkv", H), ("fullkv", HK)):
        (_, _, p), = qplan(method).segment_plans()
        r, decode[method] = check_decode(
            torch, F, dev, 1, H, hk, p.total_slots, timed=True, seed=seed,
            label=f"{method} 32k, G={H // hk}")
        ok &= r
        seed += 1
    return ok, entries, flash, decode


def qplan(method: str):
    """The quantized runs' plan for ``method`` (Llama-3-8B, 32k bucket)."""
    from pyramidkv_tpu_torch.config import CompressionSpec
    from pyramidkv_tpu_torch.policy import make_plan

    return make_plan(CompressionSpec(method=method, **QCOMP), LAYERS, QN,
                     QMAX_NEW)


def _kernels():
    from pyramidkv_tpu_torch import kernels

    return {"flash_causal_attention": kernels.flash_causal_attention,
            "decode_attention": kernels.decode_attention,
            **{k: getattr(kernels, k) for k in MM_KERNELS}}


def reset_counts():
    for fn in _kernels().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in _kernels().items()}


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
                and c["flash_causal_attention"] > 0
                and c["decode_attention"] > 0
                and not any(c[k] for k in MM_KERNELS)  # bf16 weights
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


def quantized(params, weights: str):
    """``params`` (bf16, on the card) in a QUANT format, fused for int4 as
    the runners fuse it; quantize_weights works one layer at a time."""
    from pyramidkv_tpu_torch.models.weights import (fuse_packed_matmuls,
                                                    quantize_weights)

    q = quantize_weights(params, **QUANT[weights])
    return fuse_packed_matmuls(q) if QUANT[weights]["nbits"] == 4 else q


def expected_launches(qp, steps: int, b: int, n: int) -> dict:
    """Matmul kernel launches one generate implies, from the plan: the
    routing rule of each quantized leaf at the prefill's b*n rows (layers)
    and b rows (the last position's lm_head), then at b rows in each decode
    step."""
    from pyramidkv_tpu_torch.models.weights import QuantW, kernel_route

    counts = dict.fromkeys(MM_KERNELS, 0)

    def add(w, rows, times):
        route = kernel_route(w, rows)
        if route is not None:
            counts[route[0]] += times

    for w in qp["layers"].values():
        if isinstance(w, QuantW):
            w0 = QuantW(w.codes[0], w.scale[0])
            add(w0, b * n, LAYERS)
            add(w0, b, LAYERS * steps)
    add(qp["lm_head"], b, 1 + steps)
    return counts


def phase_engine_quant(torch, dev, params, vocab):
    """bench.py's configuration on quantized weights: one 32767-token
    prompt (numpy seed 0), bucket 32768, 128 new tokens, greedy; snapkv at
    cap 128 against fullkv (bf16 cache: KIVI is not ported)."""
    from pyramidkv_tpu_torch.config import (CompressionSpec, EngineSpec,
                                            ModelSpec)
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.models import weights

    spec = ModelSpec.preset("llama3-8b")
    prompt = np.random.default_rng(0).integers(0, vocab, size=QTRUE).tolist()
    ok, counts, qp, have = True, {}, None, None
    for wname, method, dma in QRUNS:
        if wname != have:
            qp = None
            torch.cuda.empty_cache()
            qp, have = quantized(params, wname), wname
        weights._INT4_KERNEL_DMA[0] = dma
        eng = Engine(spec, CompressionSpec(method=method, **QCOMP),
                     EngineSpec(max_new_tokens=QMAX_NEW,
                                prefill_buckets=(QN,)), qp, device=dev)
        eng.generate([prompt], max_new_tokens=2)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        out = eng.generate([prompt])
        c = read_counts()
        want = expected_launches(qp, out.decode_steps, 1, QN)
        weights._INT4_KERNEL_DMA[0] = False
        run = f"{wname}{'-dma' if dma else ''} {method}"
        counts[run] = c
        toks = out.tokens[0]
        good = (c["flash_causal_attention"] == LAYERS
                and c["decode_attention"] == LAYERS * out.decode_steps
                and all(c[k] == want[k] for k in MM_KERNELS)
                and out.decode_steps == QMAX_NEW - 1
                and len(toks) == QMAX_NEW and all(0 <= t < vocab for t in toks)
                and eng.plan_for(QN).segments == qplan(method).segments)
        log({"phase": "engine_quant", "run": run, "weights": wname,
             "method": method, "dma": dma,
             "prefill_s": out.prefill_seconds, "decode_s": out.decode_seconds,
             "decode_steps": out.decode_steps,
             "decode_tok_per_s": (out.decode_steps / out.decode_seconds
                                  if out.decode_seconds else None),
             "kv_cache_bytes": out.kv_cache_bytes,
             "weight_gib": tree_gib(qp), "launches": c,
             "expected_launches": want, "first_tokens": toks[:8],
             "ok": good})
        ok &= good
        del eng, out
    del qp
    torch.cuda.empty_cache()
    return ok, counts


def tree_gib(tree) -> float:
    if isinstance(tree, dict):
        return sum(tree_gib(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(tree_gib(v) for v in tree)
    return tree.numel() * tree.element_size() / 2 ** 30


def phase_parity(torch, dev, params, vocab, weights=None):
    """Depth-2 prefill logits: kernels vs the plain functions, with bf16
    weights or a QUANT format (the lm_head of 4 rows then runs through its
    matmul kernel; the layers' 32768-row products dequantize either way).
    The logits do not depend on the compression method (compression reads
    q/k/v and feeds nothing back), so one method (fullkv) is run."""
    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b", num_hidden_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    if weights:
        p2 = quantized(p2, weights)
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
         "weights": weights or "bf16",
         "max_abs_err": err, "tol": tol,
         "same_argmax": bool((lk.argmax(-1) == lp.argmax(-1)).all()),
         "ok": ok})
    return ok


def phase_profile(torch, dev, params, vocab, method="snapkv", steps=8,
                  weights="bf16"):
    """Where the time goes in one prefill and in ``steps`` decode steps:
    host wall time of an unprofiled run, device busy time and the top
    kernels from a torch.profiler trace of a second run (device-side events
    only, so an op and its kernels are not counted twice).  With quantized
    ``params`` (bench.py's shape: one 32767-token prompt) the decode part
    also reports the matmul kernels' device ms per step against the least
    time their code bytes take."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b")
    quant = weights != "bf16"
    if quant:
        plan, b, n, true_len = qplan(method), 1, QN, (QTRUE,)
    else:
        plan = make_plan(CompressionSpec(method=method),
                         spec.num_hidden_layers, N, MAX_NEW)
        b, n, true_len = B, N, TRUE_LEN
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, size=(b, n)).astype(np.int64)).to(dev)
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev)

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
        mm_us = sum(t for k, t, _ in ev
                    if "mm_kernel" in k or "finish_kernel" in k)
        return sum(t for _, t, _ in ev) / 1e6, [
            {"kernel": k[:90], "device_ms": t / 1e3, "calls": c}
            for k, t, c in top], mm_us / 1e3

    with torch.inference_mode():
        prefill()  # warm-up
        (logits, cache), pre_wall = wall(prefill)
        tok = logits.argmax(-1)
        decode(cache, tok)  # warm-up (writes decode slots 0..steps-1)
        cache.step = 0
        _, dec_wall = wall(decode, cache, tok)
        cache.step = 0
        pre_busy, pre_top, _ = device_profile(prefill)
        dec_busy, dec_top, dec_mm = device_profile(decode, cache, tok)
    for part, w, busy, top in (("prefill", pre_wall, pre_busy, pre_top),
                               ("decode", dec_wall, dec_busy, dec_top)):
        rec = {"phase": "profile", "method": method, "weights": weights,
               "part": part, "steps": steps if part == "decode" else None,
               "wall_s": w, "device_busy_s": busy,
               "idle_share": max(0.0, 1 - busy / w), "top": top}
        if quant and part == "decode":
            code_bytes = sum(
                v.codes[0].numel() for v in params["layers"].values()
                if isinstance(v, tuple)) * LAYERS + params["lm_head"][0].numel()
            rec["mm_device_ms_per_step"] = dec_mm / steps
            rec["mm_bound_ms_per_step"] = code_bytes / PEAK_BYTES * 1e3
        log(rec)
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
           "replaces": replaces, "launches": launches, "tol": recs[0]["tol"],
           "max_abs_err": max(r["max_abs_err"] for r in recs),
           "ms": mean("ms"), "plain_ms": mean("plain_ms"),
           "bound_ms": mean("bound_ms"),
           # what bounds the shape that contributes most to the bound
           "bound_by": max(zip(w, recs), key=lambda x: x[0] * x[1][
               "bound_ms"])[1]["bound_by"],
           "library_ms": mean("library_ms")}
    if len(recs) > 1:
        ent["shapes"] = [{k: r[k] for k in (
            "S", "case", "x", "layers", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "library_ms") if k in r} for r in recs]
    return ent


def main() -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", help="append every JSON line to this file too")
    args = ap.parse_args()
    if args.log:
        LOG_FILE.append(open(args.log, "a"))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port itself: without it (a directory holding only this script)
    # the import fails here, before anything is printed
    from pyramidkv_tpu_torch.config import ModelSpec
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.models.convert import init_params

    dev = torch.device("cuda", 0)
    # the plain matmuls are held as f32 products (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
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
    r, mm_recs, qflash, qdecode = phase_mm_kernels(torch, F, dev)
    ok &= r

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
    r, qcounts = phase_engine_quant(torch, dev, params, spec.vocab_size)
    ok &= r
    for weights in ("int4", "int4-g128"):
        ok &= phase_parity(torch, dev, params, spec.vocab_size, weights)
    q4 = quantized(params, "int4")
    ok &= phase_profile(torch, dev, q4, spec.vocab_size, weights="int4")
    del q4
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

    def qsum(kernel, runs=None):
        return sum(c[kernel] for run, c in qcounts.items()
                   if runs is None or run in runs)

    kernels.append(kernel_entry(
        f"flash_causal_attention (B=1, N={QN})", src + "flash_prefill.cu",
        "pyramidkv_tpu/kernels/flash_prefill.py:420",
        qsum("flash_causal_attention"), [qflash]))
    for method, rec in qdecode.items():
        runs = [run for run in qcounts if run.endswith(method)]
        kernels.append(kernel_entry(
            f"decode_attention (32k {method}, G={H // rec['Hk']}, "
            f"S={rec['S']})", src + "decode_attn.cu",
            "pyramidkv_tpu/kernels/decode_attn.py:69",
            qsum("decode_attention", runs), [rec]))
    tpu = "pyramidkv_tpu/kernels/int4_matmul.py:"
    for name, kernel, line, runs in (
            ("int4_matmul", "int4_matmul", 286,
             ("int4 fullkv", "int4 snapkv")),
            ("int4_matmul (g128)", "int4_matmul", 286, ("int4-g128 snapkv",)),
            ("int8_matmul", "int8_matmul", 523, None),
            ("int4_matmul_dma", "int4_matmul_dma", 672, None)):
        kernels.append(kernel_entry(
            name, src + "int4_matmul.cu", tpu + str(line),
            qsum(kernel, runs), mm_recs[name]))
    for k in kernels:  # one line per kernel
        log({"kernel": k["name"], **k})
    log({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
