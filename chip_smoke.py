#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyramidkv_tpu_torch``) on one H100.

    python3 chip_smoke.py            # every phase, needs one CUDA card
    python3 chip_smoke.py --log FILE # also append every JSON line to FILE

Phases (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the main path from ``csrc/``, and
     prints each kernel's registers and spills (``ptxas_report``);
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at every shape the engine phase gives it (decode: each method's cache
     width, each pyramidkv segment's, bench.py's 32k widths; first short
     shapes and shapes of several splits with a wholly masked split, a row
     masked in every split and S no multiple of the tile; the flash
     kernels at short ragged shapes first too; the decode and flash
     kernels' two calls bitwise equal), with its time, the plain version's
     time, the time of one library call computing the same function (a
     yardstick the port never calls) and the least time the card could take;
  4. engine: ``Engine.generate`` on Llama-3-8B geometry (all 32 layers,
     seeded random bf16 weights made on the card), 4 requests of
     8000/6000/3000/1000 tokens, 32 new tokens, for fullkv, snapkv and
     pyramidkv, with the kernels' launch counts of each run; then
     engine_methods: the rest of the compression stack on the same batch
     (streamingllm, l2norm with its segmented plan, random twice with one
     seed, adakv with each head's visible slots held to its allocation,
     headkv on seeded synthetic capacities, cam, snapkv with pivot
     merging, ThinK's narrow layout, snapkv and h2o with gqa_aggregate,
     snapkv with a 3072-to-1024 layer_capacity schedule), each with its
     launch counts, kv_cache_bytes and segments held to its plan, and the
     decode kernel at each new cache width; parity_methods: depth-2
     prefill and first-decode-step logits, kernels against plain, for
     adakv, cam, think and pivot; then decode_engine_masks: the decode
     kernel at the masks of a real fullkv cache after prefill and a decode
     step (8k batch, 32k), timed;
  5. parity: last-position prefill logits through the kernels against the
     plain path, at depth 2 with the same widths;
  6. profile: where the time goes in one snapkv prefill and 8 decode steps
     (host wall time, device busy time and top kernels from torch.profiler;
     device operations and host ms per decode step in each span; the decode
     kernel's device ms per step), then the same for fullkv;
  7. mm_kernels: the weight-quantized matmul kernels (int4 per-channel and
     g128, int8, int4 windowed) against their plain versions at every
     Llama-3-8B decode shape, rows 1 and 8, after short and edge shapes
     (odd widths, codes TMA cannot read, a stacked layer at an odd
     offset, 9 and 40 rows, group sizes 8-128, uneven slices); each int4
     kernel called twice and held bitwise equal; each format's matmul ms
     per decode step beside its bound; plus flash prefill at 32k;
  8. engine_quant: ``Engine.generate`` with quantized weights on bench.py's
     configuration (32 layers, one 32767-token prompt, 128 new tokens,
     snapkv cap 128): int4 fullkv and snapkv, int4-g128, int8 and
     int4 through the windowed kernel, each with its launch counts held to
     the counts its plan implies;
  9. parity_quant: depth-2 prefill logits, kernels against plain, for the
     int4 and int4-g128 weights;
 10. profile_quant: the int4 snapkv and fullkv runs' prefill and 8 decode
     steps, with the matmul kernels' device time per step beside their
     bound;
 11. kv_quant_kernels: the KIVI region kernels (group layout whole and
     tiled, pa layout) against their plain versions on short ragged regions
     (also with a wholly masked split, in a cluster and past one; the pa
     kernel at G = 8 kivi2 with 4 K groups and with V rows of 129 bytes and
     splits ending inside a unit, tails of 37 and 1 slots) and at every
     KIVI run's region shape, timed, each call repeated bit for bit;
     each group-layout shape also through the group kernel its route did
     not pick;
 12. engine_kv_quant: ``Engine.generate`` on a KIVI cache: bench.py's 32k
     fullkv with int4 weights and a kivi4-pa (its baseline) or kivi4 group
     cache (the default route and the f32 one), bench.py's 32k snapkv with
     a kivi4 group cache, and snapkv kivi4, kivi2 and kivi4-pa on the bf16
     8k batch, each with one region-kernel call per layer per decode step
     (the group kernel: one CUDA kernel up to 4 splits, two beyond; the pa
     kernel: two) and the kv_cache_bytes its layout implies;
 13. parity_kv_quant: depth-2 decode logits on a KIVI cache, kernels
     against plain (32k fullkv kivi4-pa, 8k snapkv kivi4);
 14. profile_kv_quant: two decode steps of the 32k fullkv kivi4-pa run,
     with the region kernels' device time; then bench_ratio, the port's
     counterpart of bench.py's snapkv / fullkv-kivi4-pa decode tok/s;
 15. minference_kernels, engine_minference, parity_minference,
     profile_minference: MInference's three block-sparse kernels against
     their plain versions (also at 64-row q-blocks of 64-key tiles, at
     N % 128 = 64 with 192-row q-blocks, with the vertical columns
     shuffled, and with a batch row that is all padding; the vertical and
     grid slash kernels' two calls bitwise equal), four sparse-prefill
     generate runs, depth-2 parity and CUDA-event stage times of a 32k
     sparse prefill (the vertical wrapper's sort a stage of its own);
 16. h2o_chunk_kernels: the two H2O kernels (stats, colsum) against their
     plain versions at the 8k batch and bench.py's 32k prompt and at short
     edge shapes (a pad inside a 128-row tile and on a tile boundary, a q
     tile made wholly of padding, N - W no multiple of 128, a W x W block
     across two tiles), each called twice and held bitwise equal; at the
     8k and 32k shapes over 8 seeds, the top-k picks of the kernels, of a
     plain version dividing by l and of one with the kernel's folded
     exponent that stray from an f64 reference's (count_h2o_picks); untimed
     short shapes of the flash kernels (q_start on a carry longer than the
     chunk's keys, a last q tile of 64 rows; partials on a self and a
     history tile of N = 192 with a pad inside a key tile); flash with
     q_start at every chunk of the 8k batch, flash_attention_partials on the
     self and history tiles of the 32k and 8k chunk carries, and the pa
     region kernel with one K group per chunk, timed;
 17. engine_h2o_chunked: ``Engine.generate`` for H2O (8k batch, bf16; 32k,
     int4) and with ``prefill_chunk`` (snapkv and H2O on the 8k batch; the
     quantized carry: fullkv kivi4-pa at 32k, kivi4 group on the 8k batch),
     each launch count and kv_cache_bytes held to the plan's, the chunked
     runs beside their monolithic ones (information);
 18. parity_h2o_chunked and profile_h2o_chunked: depth-2 logits, kernels
     against plain, for H2O, chunked snapkv and chunked kivi4-pa; CUDA-event
     stage times of the H2O 32k, chunked H2O 8k and chunked kivi4-pa 32k
     prefills;
 19. two_pass_kernels: the two-pass flash schedule's kernels (pass A's row
     maxes, pass B against them, each twice: bitwise equal) against their
     plain versions on short shapes (N = 192, q_start, rows that are all
     padding), on edge shapes of pass A's unit plan (sliding windows, a q
     tile all padding, Nq = 192 at q_start with N % 128 = 64, G = 8 and 1),
     at the 8k batch and bench.py's 32k prompt, timed beside the
     one-pass kernel and masked SDPA (KIVI group regions' factored kernel
     is checked in kv_quant_kernels, the route their runs take by
     default);
 20. engine_two_pass_prefix: ``Engine.generate`` with
     ``prefill_two_pass=True`` ((g) the 8k batch, snapkv, bf16; (h) bench.py's
     32k int4 snapkv) and with a prefix handle ((i) bf16 snapkv, chunk 2048,
     a 6144-token prefix shared by 4 requests; (j) bench.py's 32k fullkv
     kivi4-pa, int4, chunk 8192, a 24576-token quantized handle, on a
     misaligned (pad 1) and an aligned (pad 0) prompt), each with its launch
     counts held to the plan's and its first-token logits to its one-pass
     or no-prefix twin's;
 21. mistral_kernels (run with the kernel phases): the windowed modes
     Mistral-7B's runs launch (window 4096) against their plain versions
     at full width: flash over the 8k batch and the 32k prompt (timed
     beside SDPA with the windowed mask), at q_start on each 8k chunk and
     on a chunk whose pad and window edge share a key tile, the two-pass
     kernels, partials on a self tile and on a history tile at its true
     distance (rows wholly outside the window exact), the decode and pa
     kernels on window-shaped masks at the 8k and 32k widths;
 22. engine_mistral: ``Engine.generate`` on ``ModelSpec.preset(
     "mistral-7b")`` (its width, cut to 8 of its 32 layers, seeded random
     weights; Llama's are freed
     first): the 8k batch for fullkv, snapkv, pyramidkv and h2o, the 32k
     prompt with int4 weights for fullkv kivi4-pa and snapkv, chunked
     snapkv (8k, C=2048) and the quantized carry (32k kivi4-pa, C=8192)
     beside their monolithic twins, two-pass snapkv, a 6144-token prefix
     handle and minference at 32k; launch counts and cache bytes held to
     the plans;
 23. parity_mistral: depth-2 prefill and decode logits, kernels against
     plain, for fullkv (the window-masked decode), snapkv, the chunked
     kivi4-pa carry and two-pass;
 24. qwen_kernels (run with the kernel phases): Qwen2.5-7B's shapes, 28
     query heads on 4 KV heads (G = 7): the decode kernel's occupancy at
     each instantiated group against the residency its split plan assumes,
     the decode kernel at G = 7 on short shapes, several splits with a
     wholly masked split and S no multiple of the tile, the 8k batch's and
     32k fullkv widths (timed beside SDPA, and on the two-wave plan of two
     blocks an SM); the KIVI group (kFold; kF32 on short shapes) and pa
     kernels at G = 7 for 2-, 4- and 8-bit codes, and kivi4 at the 32k and
     8k fullkv widths (timed); untimed, flash (one-pass, q_start,
     two-pass), partials, H2O and the block-sparse kernels at 28 / 4 heads;
     the int4 / g128 / int8 matmuls at Qwen's five decode widths, rows 1
     and 8;
 25. engine_qwen: ``Engine.generate`` on ``ModelSpec.preset("qwen2.5-7b")``
     (its width, cut to 8 of its 28 layers, seeded random weights with QKV
     biases; Mistral's are freed
     first): the 8k batch for fullkv (G = 7 decode), snapkv, pyramidkv and
     h2o, fullkv kivi4 group and kivi4-pa, the 32k prompt with int4
     weights for fullkv kivi4-pa, fullkv kivi4 group, snapkv and
     minference, and the chunked kivi4-pa carry (C=8192); launch counts,
     the decode kernel's blocks (one wave of its
     split plan) and cache bytes held to the plans (the engine_mistral
     runs are held the same way);
 26. parity_qwen: depth-2 prefill and decode logits, kernels against
     plain, for fullkv, snapkv, fullkv kivi4 group and kivi4-pa (the 8k
     batch);
 27. gemma_kernels (after qwen_kernels): the flash and decode kernels at
     Gemma-2-9B's head dim 256 with its scale 1/16 and attention logit cap
     50 (q drawn large enough for the cap to bend the logits), against
     their plain versions: short ragged shapes, then flash over the 8k
     batch full and windowed (4096), at q_start on chunks 0-3 (C=2048),
     partials on a self and a history tile, pass A and pass B, the decode
     at G=1 (S=2080) and G=2 (fullkv, S=8224, full and window masks), each
     twice and bitwise equal, timed beside SDPA on the uncapped function;
     the decode kernel's residency at D = 256; the H2O and block-sparse
     kernels; the KIVI region kernels (the group kernel in its f32, folded
     and mm_bf16 modes on one split, a cluster and past MAX_CLUSTER splits
     with the merge kernel, the pa split and finish kernels with one and 4
     K groups; wholly masked splits, window masks, a scale that is no power
     of two; each Gemma-2 KIVI run's region shape timed) and mm_bf16 at
     Llama's D = 128; the int4 matmuls at Gemma-2's widths;
 28. engine_gemma: ``Engine.generate`` on ``ModelSpec.preset("gemma2-9b")``
     (42 layers alternating sliding and full attention, random bf16
     weights from seed 3, ~17.2 GiB; Qwen's are freed first) on the 8k
     batch: fullkv, snapkv, pyramidkv, snapkv two-pass, snapkv chunked at
     2048 (bf16 carry), snapkv with int4 weights, h2o (monolithic and
     chunked), minference, think, and the KIVI caches: fullkv kivi4-pa,
     snapkv kivi4 (group, the default route), fullkv kivi2 on the f32
     route, fullkv kivi4 on the tiled route with PKV_QUANT_MM_BF16=1 (K
     groups of 32) and fullkv kivi4 chunked at 2048 (the quantized carry,
     each layer's own window); launches (mm_bf16 calls too), decode
     blocks and cache bytes held to the plans;
 29. parity_gemma: depth-2 (one sliding, one full layer) prefill and
     decode logits, kernels against plain, for fullkv, snapkv, h2o,
     minference, kivi4-pa, snapkv kivi4 and the chunked kivi4 carry; and
     the kernel path's prefill logits, monolithic and through a kivi8
     quantized carry (chunk 2048), against the harness's own plain Gemma-2
     forward (``gemma_reference_logits``, HF semantics without the port's
     model code), within 2^-5 of the largest.
 30. trained (after gemma_kernels): the trained tiny retrieval checkpoint
     (``data/tiny_retrieval.npz``: 8 layers, 8 / 4 heads of D = 32, tied
     embeddings) loaded by the port's numpy loader in bf16: the D = 32
     flash (one pass), decode (G = 1, 2), H2O and folded KIVI group
     kernels against their plain versions at the needle grid's shapes (B = 1
     and the 30-prompt batch, N = 1024; all-masked KIVI rows exact) and the
     refusals of the modes not ported at D = 32; the 16 configurations
     pinned by ``tests/torch_trained_tokens.json`` (JAX's f32 CPU tokens)
     through the kernels and the plain path, each kernel call held to its
     plain version on the trained inputs, launches and cache bytes held,
     token differences only at logit near-ties or after the paths' keep
     sets differ; To check #1 (an f32 lm_head beside the port's) and #2
     (keep-set agreement); the grid batch's answers on both paths; the
     lm_head's f32 product timed at Llama-3-8B's and Gemma-2-9B's widths.
The 32k engine runs keep bench.py's 128 decode slots but generate 32
tokens each (``QGEN``).
The line before the last lists every kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (dense bf16 tensor-core rate, f32 outside the
#: tensor cores, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: exp2 results a second: 16 a clock per SM (the MUFU throughput of compute
#: capability 9.0 in the CUDA C Programming Guide's arithmetic-instruction
#: table) x 132 SMs x 1.98 GHz (the H100 SXM's boost clock)
PEAK_EXP2 = 16 * 132 * 1.98e9
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
#: tokens the 32k engine runs generate: their caches keep QMAX_NEW decode
#: slots (bench.py's 128, so cache bytes and kernel shapes are bench.py's),
#: but each generate stops after QGEN tokens (a quarter of the decode time
#: of the 17 such runs, which took ~110 s of the script before)
QGEN = 32


def gen_new(max_new: int) -> int:
    """Tokens a run's timed generate takes: QGEN for the 32k runs."""
    return QGEN if max_new == QMAX_NEW else max_new
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


#: the KIVI runs of phase_engine_kv_quant: name -> (weights, method, nbits,
#: layout, size, f32).  "32k": bench.py's configuration (one 32767-token
#: prompt, 128 new tokens, cap 128: snapkv keeps 128 slots per query head,
#: one split, so it takes a whole-region group kernel) with int4 weights;
#: "8k": the bf16 main path's batch (4 x 8000/6000/3000/1000 tokens, 32 new
#: tokens), snapkv's default cap 2048 (per-query-head storage, 32 heads;
#: group regions take a split kernel).  q_group_size 64.  Group regions
#: decode by default through quant_fused_attention_group (the factored
#: dequantization, JAX's default); ``f32`` runs set use_quant_kernel (JAX's
#: opt-in route: the f32 kernels, whole or tiled by the split plan).
KV_RUNS = {
    "int4 fullkv kivi4-pa 32k": ("int4", "fullkv", 4, "pa", "32k", False),
    "int4 fullkv kivi4 32k": ("int4", "fullkv", 4, "group", "32k", False),
    "int4 fullkv kivi4 32k f32": ("int4", "fullkv", 4, "group", "32k", True),
    "int4 snapkv kivi4 32k": ("int4", "snapkv", 4, "group", "32k", False),
    "int4 snapkv kivi4 32k f32": ("int4", "snapkv", 4, "group", "32k", True),
    "bf16 snapkv kivi4 8k": ("bf16", "snapkv", 4, "group", "8k", False),
    "bf16 snapkv kivi2 8k": ("bf16", "snapkv", 2, "group", "8k", False),
    "bf16 snapkv kivi4-pa 8k": ("bf16", "snapkv", 4, "pa", "8k", False),
}
#: kv_cache_bytes of the 32k fullkv runs, worked out by hand from the layout
#: (per layer: K and V codes 16,777,216 each, K scale/zero 8,192 (pa) or
#: 4,194,304, V scale/zero 2,097,152 (pa) or 4,194,304, 128 bf16 decode
#: slots 524,288; times 32 layers)
KV_BYTES_32K = {"pa": 1_157_890_048, "group": 1_358_954_496}
REGION_KERNELS = ("quant_decode_attention", "quant_decode_attention_tiled",
                  "quant_fused_attention_pa", "quant_fused_attention_group")
#: the kernels of each layout: group (f32 whole, f32 tiled, factored), pa
GROUP_KERNELS = ("quant_decode_attention", "quant_decode_attention_tiled",
                 "quant_fused_attention_group")
#: region kernels against their plain versions, on normalised outputs
#: acc / l.  The f32 group kernels are f32 end to end, like their plain
#: version (f32 dequantization, f32 attention): only the order of the f32
#: sums differs (~2^-20 relative), so they pass within 2^-10.  The folded
#: kernels (pa, and the group layout's factored route) round p * vs to bf16
#: at a running max where the plain version rounds at the row's final max
#: (2^-9 noise per probability, at random), the noise the decode kernel's
#: limit (TOL_TEXT) allows for.  m (f32 logits) is held within
#: 2^-12 max(1, |m|) and l within 2^-10 l for all four.
REGION_TOL = {"f32": (2.0 ** -10, 2.0 ** -10),
              "folded": (KERNEL_RTOL, KERNEL_ROW_TOL)}
#: the tail mode's bf16 outputs: the partials' limit on acc / l plus one
#: bf16 ulp (<= 2^-7 |want|), since kernel and plain version may round
#: their f32 results to neighbouring bf16 values
TAIL_TOL = {"f32": (2.0 ** -10 + 2.0 ** -7, 2.0 ** -10),
            "folded": (KERNEL_RTOL + 2.0 ** -7, KERNEL_ROW_TOL)}
REGION_TOL_TEXT = {
    "f32": "|err| <= 2^-10 |want| + 2^-10 rms(want's row) on acc/l; "
           "m within 2^-12 max(1,|m|), l within 2^-10 l",
    "folded": TOL_TEXT + " on acc/l; m within 2^-12 max(1,|m|), l within "
                         "2^-10 l"}
TAIL_TOL_TEXT = {
    "f32": "|err| <= (2^-10 + 2^-7) |want| + 2^-10 rms(want's row)",
    "folded": "|err| <= (2^-6 + 2^-7) |want| + 2^-5 rms(want's row)"}

#: MInference's block-sparse prefill kernels.  Their partials are held as
#: the pa region kernel's: acc / l within TOL_TEXT (kernel and plain version
#: round p to bf16 at different running maxima: 128-key tiles against the
#: plain version's k_tile-key tiles or one-shot row), m within
#: 2^-12 max(1, |m|) and l within 2^-10 l (f32 dots and sums in other
#: orders).  The db slash function is the grid kernel over each list's
#: valid prefix: bitwise equal to the grid kernel on valid-first lists.
SPARSE_KERNELS = ("vertical_attention_partials", "slash_tile_attention",
                  "slash_tile_attention_db")
SPARSE_TOL_TEXT = (TOL_TEXT + " on acc/l; m within 2^-12 max(1,|m|), l "
                   "within 2^-10 l")
#: the synthetic per-head pattern config (32 layers x 32 heads)
PCFG_PATH = "configs/minference/llama3_8b_synthetic.json"
#: kernel checks: case -> (B, H, Hk, N, true_len, budgets, q_block, k_tile,
#: tile_budget, shuffle, permute, timed).  budgets: "default"
#: (CompressionSpec's 1000 / 200), "pcfg" (layer 0 of PCFG_PATH, the
#: config-wide maxima 3500 / 6096 setting the top-k widths: Vs 3584) or
#: (vertical, slash).  shuffle: the vertical columns handed over in a seeded
#: random order (the invalid ones among the valid).  permute: each tile
#: list's entries in a seeded random order (lists not valid-first: the db
#: function's prefix differs from the flags).  The short cases come first: a
#: prompt shorter than last_q beside a full one, and G=1 with 128-row
#: q-blocks of 64-key tiles; then the vertical and slash kernels' edge
#: shapes: 64-row q-blocks of 64-key tiles (each consumer warpgroup walks
#: its own list), N % 128 = 64 with 192-row q-blocks (a 128-row q tile
#: across two lists), shuffled columns at G = 1, a batch row that is all
#: padding at G = 8, and lists not valid-first with a pad inside a unit.
SPARSE_CASES = {
    "short ragged": (2, 8, 2, 1024, (1024, 37), (100, 50), 512, 256, 2,
                     False, False, False),
    "short tiles": (1, 4, 4, 640, (600,), (60, 30), 128, 64, 3, False,
                    False, False),
    "tiles 64": (1, 8, 2, 2048, (2000,), (150, 60), 64, 64, 6, False, False,
                 False),
    "N % 128 = 64": (2, 8, 2, 1344, (1344, 1000), (100, 50), 192, 192, 3,
                     False, False, False),
    "shuffled vertical": (1, 8, 8, 2048, (1900,), (200, 60), 256, 128, 4,
                          True, False, False),
    "padded row": (2, 16, 2, 1024, (1024, 0), (100, 50), 512, 256, 2, False,
                   False, False),
    "lists not valid-first": (2, 8, 2, 1024, (1024, 700), (100, 50), 128,
                              64, 4, False, True, False),
    "32k": (1, H, HK, QN, (QTRUE,), "default", 512, 256, 8, False, False,
            True),
    "32k pcfg": (1, H, HK, QN, (QTRUE,), "pcfg", 512, 256, 8, False, False,
                 True),
    "8k": (B, H, HK, N, TRUE_LEN, "default", 512, 256, 8, False, False,
           True),
}
#: the minference engine runs: name -> (weights, CompressionSpec arguments
#: or "pcfg", the SPARSE_CASES shape its kernels run at).  32k: bench.py's
#: prompt (bucket 32768 = minference_dense_below: the sparse path); 8k: the
#: bf16 batch with minference_dense_below=0.
MINF_RUNS = {
    "int4 minference 32k": ("int4", {}, "32k"),
    "int4 minference-db 32k": ("int4", dict(minference_slash_impl="db"),
                               "32k"),
    "int4 minference-pcfg 32k": ("int4", "pcfg", "32k pcfg"),
    "bf16 minference 8k": ("bf16", dict(minference_dense_below=0), "8k"),
}
#: kv_cache_bytes of bench.py's 32k fullkv (and minference) cache: K and V,
#: 32 layers x 8 KV heads x 32896 slots x 128 x 2 bytes
KV_BYTES_FULLKV_32K = 4_311_744_512


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
    passes; a value that is not finite is infinitely far off (Python's max
    would drop a NaN)."""
    g, w = got.float(), want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    lim = (rtol * w.abs() + row_tol * rms).clamp_min(1e-30)
    r = float(((g - w).abs() / lim).max())
    return r if r == r else float("inf")


def bound(flops: float, nbytes: float, peak=PEAK_BF16_FLOPS) -> tuple:
    """(least ms, what bounds it) at the H100's published peaks."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_bound(pairs: float, d: int, nbytes: float, softcap=None,
               flops_per_pair=None) -> tuple:
    """(least ms, what bounds it, {unit: ms}) of attention over ``pairs``
    visible pairs at head dim ``d``: its products on the tensor cores
    (``flops_per_pair``, default 4 d), its bytes, and its MUFU work (an
    exp2 a pair, and a tanh under a logit cap: at D = 32 one exp2 takes
    longer than the pair's 4 d flops)."""
    t = {"tensor cores": (flops_per_pair or 4.0 * d) * pairs
         / PEAK_BF16_FLOPS * 1e3,
         ("MUFU exp2" if softcap is None else "MUFU exp2 + tanh"):
             (1.0 if softcap is None else 2.0) * pairs / PEAK_EXP2 * 1e3,
         "bytes": nbytes / PEAK_BYTES * 1e3}
    unit = max(t, key=t.get)
    return t[unit], ("bytes" if unit == "bytes" else "operations"), t


#: the library column under a logit cap: no single eager PyTorch call
#: computes the capped function, so SDPA's time on the uncapped one
UNCAPPED_NOTE = ("SDPA on the uncapped function at the same shapes (no "
                 "single eager PyTorch call computes the capped one)")


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


def check_flash(torch, F, dev, b, h, hk, n, true_len, window, timed, seed,
                case, d=D, scale=None, softcap=None, q_std=1.0):
    """The one-pass flash kernel against its plain version (rows past the
    pad; pad rows exactly 0; two calls bitwise equal) at head dim ``d``
    with ``scale`` and ``softcap``; q drawn at ``q_std`` (larger logits,
    where a cap bends them)."""
    from pyramidkv_tpu_torch.kernels import flash_causal_attention
    from pyramidkv_tpu_torch.ops.attention import causal_prefill_attention

    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((b, h, n, d), generator=g, device=dev)
         * q_std).to(torch.bfloat16)
    k = torch.randn((b, hk, n, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, hk, n, d), generator=g, device=dev).to(torch.bfloat16)
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
    kw = dict(sliding_window=window, scale=scale, softcap=softcap)
    got = flash_causal_attention(q, k, v, tl, **kw)
    again = flash_causal_attention(q, k, v, tl, **kw)
    want = causal_prefill_attention(q, k, v, true_len=tl, **kw)
    torch.cuda.synchronize()
    err = ratio = sq = 0.0
    for bi, t in enumerate(true_len):  # rows >= pad: JAX leaves pad rows open
        gb, wb = got[bi, :, n - t:], want[bi, :, n - t:]
        err = max(err, float((gb.float() - wb.float()).abs().max()))
        ratio = max(ratio, err_over_tol(gb, wb))
        sq += float(wb.float().square().sum())
    rms = (sq / (h * sum(true_len) * d)) ** 0.5
    pad_rows_zero = all(
        bool((got[bi, :, :n - t] == 0).all()) for bi, t in enumerate(true_len))
    rec = {"check": "flash_causal_attention", "case": case, "B": b, "H": h,
           "Hk": hk, "N": n, "D": d, "scale": scale, "softcap": softcap,
           "true_len": list(true_len), "window": window,
           "max_abs_err": err, "err_over_tol": ratio, "tol": TOL_TEXT,
           "rms": rms, "pad_rows_zero": pad_rows_zero,
           "bitwise_repeat": bool(torch.equal(got, again))}
    del again
    if timed:
        rec["ms"] = time_ms(torch, lambda: flash_causal_attention(
            q, k, v, tl, **kw), reps=10)
        rec["plain_ms"] = time_ms(torch, lambda: causal_prefill_attention(
            q, k, v, true_len=tl, **kw), reps=2)
        # library yardstick: SDPA with the equivalent boolean mask (K/V
        # repeated to the query heads outside the timed call)
        lib = masked_sdpa_inputs(torch, q, k, v, tl, 0, window)
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            *lib[:3], attn_mask=lib[3], scale=scale), reps=3)
        if softcap is not None:
            rec["library_note"] = UNCAPPED_NOTE
        del lib
        tls = np.asarray(true_len, np.float64)
        # visible (row, col) pairs
        rec["visible_pairs"] = pairs = visible_pairs(true_len, n, n, 0, 1,
                                                     window)
        nbytes = (h * tls.sum() * d * 2 + 2 * hk * tls.sum() * d * 2
                  + b * h * n * d * 2 + b * 4)
        rec["bound_ms"], rec["bound_by"], units = attn_bound(
            h * pairs, d, nbytes, softcap)
        if softcap is not None:
            rec["bound_units_ms"] = units
    log(rec)
    ok = (ratio <= 1 and pad_rows_zero and bool(torch.isfinite(got).all())
          and rec["bitwise_repeat"])
    return ok, rec


def check_decode(torch, F, dev, b, h, hk, s, timed, seed, label, mask=None,
                 masked_split=False, residency=None, d=D, scale=None,
                 softcap=None, q_std=1.0):
    """The decode kernel against its plain version (and two calls against
    each other, bitwise) on random q, K, V.  ``mask``: the visibility to use
    (an engine cache's), else random at 70% with row (0, 0) masked
    everywhere (uniform average, as on the TPU; across several splits where
    the plan makes several) and, with ``masked_split``, split 1 of row
    (0, 1) wholly masked.  ``residency`` (timed): also time the kernel on
    the plan made for that many blocks an SM (``residency_ms``), held to
    the plain version too.  ``d``, ``scale``, ``softcap``, ``q_std``: as
    check_flash's."""
    from pyramidkv_tpu_torch.kernels import decode_attn
    from pyramidkv_tpu_torch.kernels.decode_attn import decode_split_plan

    decode_attention = decode_attn.decode_attention
    from pyramidkv_tpu_torch.ops.attention import decode_attention as plain

    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((b, h, d), generator=g, device=dev)
         * q_std).to(torch.bfloat16)
    k = torch.randn((b, hk, s, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, hk, s, d), generator=g, device=dev).to(torch.bfloat16)
    nsplit, rows = decode_split_plan(dev, b * hk, s, h // hk, d)
    akw = dict(scale=scale, softcap=softcap)
    if mask is None:
        mask = torch.rand((b, hk, s), generator=g, device=dev) < 0.7
        mask[0, 0] = False  # one all-masked row: uniform average, as on the TPU
        if masked_split:
            assert nsplit > 2 and hk > 1, (nsplit, hk)
            mask[0, 1, rows:2 * rows] = False
    got = decode_attention(q, k, v, mask, **akw)
    want = plain(q, k, v, mask, **akw)
    again = decode_attention(q, k, v, mask, **akw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ratio = err_over_tol(got, want)
    rec = {"check": "decode_attention", "case": label, "B": b, "H": h,
           "Hk": hk, "S": s, "D": d, "scale": scale, "softcap": softcap,
           "nsplit": nsplit, "split_slots": rows,
           "visible": float(mask.float().mean()),
           "max_abs_err": err, "err_over_tol": ratio,
           "tol": TOL_TEXT, "rms": float(want.float().square().mean().sqrt()),
           "bitwise_repeat": bool(torch.equal(got, again))}
    if timed:
        rec["ms"] = graph_ms(torch, lambda: decode_attention(
            q, k, v, mask, **akw), reps=50)
        rec["host_ms"] = time_ms(torch, lambda: decode_attention(
            q, k, v, mask, **akw), reps=50)
        rec["plain_ms"] = graph_ms(torch, lambda: plain(q, k, v, mask,
                                                        **akw), reps=10)
        kr = k.repeat_interleave(h // hk, dim=1)
        vr = v.repeat_interleave(h // hk, dim=1)
        mr = mask.repeat_interleave(h // hk, dim=1)[:, :, None, :]
        q4 = q[:, :, None, :]
        rec["library_ms"] = graph_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q4, kr, vr, attn_mask=mr, scale=scale), reps=50)
        if softcap is not None:
            rec["library_note"] = UNCAPPED_NOTE
        del kr, vr, mr
        # bytes: each visible K and V row once (the work this mask needs),
        # the mask, q and the output
        valid = float(mask.sum())
        flops = 4.0 * d * (h // hk) * valid
        nbytes = valid * d * 2 * 2 + b * hk * s + 2 * b * h * d * 2
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
        if residency:
            own = decode_attn.blocks_per_sm
            decode_attn.blocks_per_sm = lambda g, d=D: residency
            try:
                alt = decode_attention(q, k, v, mask, **akw)
                rec["residency"] = residency
                rec["residency_plan"] = decode_split_plan(dev, b * hk, s,
                                                          h // hk, d)
                rec["residency_err_over_tol"] = err_over_tol(alt, want)
                rec["residency_ms"] = graph_ms(
                    torch, lambda: decode_attention(q, k, v, mask, **akw),
                    reps=50)
            finally:
                decode_attn.blocks_per_sm = own
            ratio = max(ratio, rec["residency_err_over_tol"])
    log(rec)
    ok = (ratio <= 1 and bool(torch.isfinite(got).all())
          and rec["bitwise_repeat"])
    return ok, rec


def phase_kernels(torch, F, dev):
    """Flash prefill at short ragged shapes and at the engine phase's
    bucket.  Returns (ok, {"flash": rec})."""
    ok = True
    # short shapes first: ragged pads, a window, every group size
    for args in ((2, 4, 2, 256, (256, 77), None), (2, 4, 4, 192, (150, 3), 50),
                 (1, 8, 1, 128, (128,), None)):
        r, _ = check_flash(torch, F, dev, *args, timed=False, seed=1,
                           case="short ragged")
        ok &= r
    r, flash = check_flash(torch, F, dev, B, H, HK, N, TRUE_LEN, None,
                           timed=True, seed=3, case="8k batch")
    return ok & r, {"flash": flash}


def phase_decode_kernels(torch, F, dev):
    """The decode kernel at every shape the engine runs it with: the 8k
    batch's snapkv cache width (per-head, G=1), each of pyramidkv's segment
    widths (G=1) and fullkv's (true GQA, G=4); bench.py's 32k snapkv and
    fullkv; after short shapes and shapes of several splits (a wholly
    masked split, a row masked in every split, S no multiple of the tile).
    Returns (ok, {method: [rec per segment], "32k " + method: rec})."""
    ok = True
    for i, (b, h, hk, s) in enumerate(((2, 4, 4, 37), (2, 8, 4, 300),
                                       (1, 16, 4, 1), (3, 16, 2, 4099))):
        r, _ = check_decode(torch, F, dev, b, h, hk, s, timed=False,
                            seed=2 + i, label="short")
        ok &= r
    # several splits: a wholly masked split beside visible ones, a row
    # masked in every split, S no multiple of the 64-slot tile (the last
    # split shorter), G = 4, 8, 2 and 1, merged by merge_kernel (more than
    # 4 splits) or in a cluster (3 splits)
    for i, (b, h, hk, s) in enumerate(((1, 8, 2, 20000), (2, 16, 2, 9001),
                                       (1, 8, 4, 70001), (2, 4, 4, 12345),
                                       (3, 24, 24, 1000), (2, 160, 40, 777))):
        r, _ = check_decode(torch, F, dev, b, h, hk, s, timed=False,
                            seed=20 + i, label="short splits",
                            masked_split=True)
        ok &= r
    recs = {}
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
    for method, hk in (("snapkv", H), ("fullkv", HK)):
        (_, _, p), = qplan(method).segment_plans()
        r, recs["32k " + method] = check_decode(
            torch, F, dev, 1, H, hk, p.total_slots, timed=True, seed=seed,
            label=f"{method} 32k, G={H // hk}")
        ok &= r
        seed += 1
    return ok, recs


def mm_plan(torch, dev, kind, in_dim, out2, rows, xdt, gs):
    """The int4 kernel's plan for a call of ``kind`` (None for int8)."""
    from pyramidkv_tpu_torch.kernels.int4_matmul import (dma_stage_rows,
                                                         int4_tile_plan)

    if kind == "int8_matmul":
        return None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ks = dma_stage_rows(in_dim) if kind == "int4_matmul_dma" else None
    return int4_tile_plan(rows, in_dim, out2, gs, sms, xdt == "f32", ks)


def check_mm(torch, dev, kind, in_dim, out, rows, xdt, timed, seed, label,
             gs=0, layers=0):
    """One matmul kernel against its plain version on random codes (every
    byte value), scales and x.  ``kind``: int4_matmul, int4_matmul_dma or
    int8_matmul; ``xdt``: "bf16" or "f32"; ``layers``: stacked codes
    [layers, in, out'] read at layer 1 (a view at an offset of in * out'
    bytes).  An int4 kernel is called twice and its two outputs must be
    bitwise equal."""
    from pyramidkv_tpu_torch.kernels.int4_matmul import unpack_nibbles
    from pyramidkv_tpu_torch.models.weights import KERNELS

    kern, plain = KERNELS[kind]
    g = torch.Generator(device=dev).manual_seed(seed)
    int4 = kind != "int8_matmul"
    lo = -128 if int4 else -127
    ncb = out // 2 if int4 else out
    codes = torch.randint(lo, 128, ((layers,) if layers else ()) + (
        in_dim, ncb), generator=g, device=dev, dtype=torch.int8)
    sshape = (in_dim // gs, out) if gs else (out,)
    qmax = 7.0 if int4 else 127.0
    scale = (0.5 + torch.rand(sshape, generator=g, device=dev)) / (
        qmax * in_dim ** 0.5)
    dt = torch.bfloat16 if xdt == "bf16" else torch.float32
    x = torch.randn((rows, in_dim), generator=g, device=dev).to(dt)
    kw = {"group_size": gs} if kind == "int4_matmul" else {}
    if layers:
        kw["layer"] = 1
    got = kern(x, codes, scale, **kw)
    again = kern(x, codes, scale, **kw) if int4 else got
    want = plain(x, codes, scale, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ratio = err_over_tol(got, want, *MM_TOL[xdt])
    rec = {"check": kind, "case": label, "in": in_dim, "out": out,
           "rows": rows, "x": xdt, "group_size": gs, "layers": layers,
           "max_abs_err": err, "err_over_tol": ratio, "tol": MM_TOL_TEXT[xdt],
           "rms": float(want.float().square().mean().sqrt())}
    plan = mm_plan(torch, dev, kind, in_dim, ncb, rows, xdt, gs)
    if plan is not None:
        c2 = codes[1] if layers else codes
        rec.update(plan=plan._asdict(), cluster=plan.cluster,
                   span=128 if ncb % 128 == 0 else 1,
                   tma=ncb % 16 == 0 and c2.data_ptr() % 16 == 0,
                   repeat_bitwise=bool(torch.equal(got, again)))
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
        and got.dtype == x.dtype and tuple(got.shape) == (rows, out) \
        and rec.get("repeat_bitwise", True)
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
#: matmul checks at short and edge shapes, untimed: (kernel, in, out, rows,
#: x dtype, group size, case, stacked layers).  "short": odd widths (span
#: 1), the unpadded 64128-byte lm_head row, 40 rows; "edge": codes whose
#: rows TMA cannot read (out2 % 16 != 0, and a stacked layer at an odd
#: byte offset), 9 rows, group sizes 32, 64, 8 and 24 (k-steps across
#: groups), an in-dim the cluster's slices do not divide evenly
MM_SHORT = (
    ("int4_matmul", 64, 6, 3, "bf16", 0, "short", 0),
    ("int4_matmul", 96, 38, 5, "f32", 16, "short", 0),
    ("int4_matmul", 4096, 128256, 1, "f32", 0, "short", 0),
    ("int4_matmul", 4096, 4096, 40, "bf16", 0, "short", 0),
    ("int4_matmul", 4096, 4096, 40, "bf16", 128, "short", 0),
    ("int4_matmul_dma", 4096, 4096, 40, "bf16", 0, "short", 0),
    ("int4_matmul_dma", 512, 256, 3, "f32", 0, "short", 0),
    ("int8_matmul", 256, 384, 3, "f32", 0, "short", 0),
    ("int4_matmul", 256, 74, 3, "bf16", 0, "edge: out2 % 16 != 0", 0),
    ("int4_matmul", 256, 74, 2, "f32", 32, "edge: out2 % 16 != 0, g32", 0),
    ("int4_matmul", 97, 38, 2, "bf16", 0, "edge: stacked, odd offset", 3),
    ("int4_matmul", 4096, 4096, 9, "bf16", 0, "edge: rows 9", 0),
    ("int4_matmul", 4096, 6144, 9, "bf16", 64, "edge: rows 9, g64", 0),
    ("int4_matmul", 4096, 4096, 1, "bf16", 32, "edge: g32", 0),
    ("int4_matmul", 14336, 4096, 8, "bf16", 64, "edge: g64", 0),
    ("int4_matmul", 256, 256, 2, "bf16", 8, "edge: g8", 0),
    ("int4_matmul", 192, 128, 3, "f32", 24, "edge: g24", 0),
    ("int4_matmul", 3000, 4096, 1, "f32", 0, "edge: uneven slices", 0),
    ("int4_matmul_dma", 1536, 2048, 2, "bf16", 0, "edge: uneven slices", 0),
)
#: launches of each shape per decode step (wq/wo, wk/wv, w_gate/w_up: two)
PER_STEP = {"wqkv": LAYERS, "wo": LAYERS, "w_gateup": LAYERS,
            "w_down": LAYERS, "lm_head4": 1, "lm_head8": 1, "wq": 2 * LAYERS,
            "wkv": 2 * LAYERS, "w_gate": 2 * LAYERS}


def phase_mm_kernels(torch, F, dev):
    """The matmul kernels at every Llama-3-8B decode shape (rows 1 and 8),
    after short ragged shapes; flash prefill at the quantized runs' 32k
    bucket.  Returns (ok, {entry name: [timed recs at rows 1, weighted by
    launches per step]}, flash rec)."""
    ok = True
    seed = 100
    for kind, i, o, rows, xdt, gs, case, layers in MM_SHORT:
        r, _ = check_mm(torch, dev, kind, i, o, rows, xdt, False, seed,
                        case, gs, layers)
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
        # the format's matmul time per decode step at rows 1 (each shape
        # times its launches a step) beside the least time its bytes take
        recs = entries[name]
        log({"phase": "mm_per_step", "format": name,
             "ms_per_step": sum(r["layers"] * r["ms"] for r in recs),
             "bound_ms_per_step": sum(r["layers"] * r["bound_ms"]
                                      for r in recs),
             "shapes": [r["case"] for r in recs]})
    r, flash = check_flash(torch, F, dev, 1, H, HK, QN, (QTRUE,), None,
                           timed=True, seed=3, case="32k")
    ok &= r
    return ok, entries, flash


def qplan(method: str, **kv):
    """The quantized runs' plan for ``method`` (Llama-3-8B, 32k bucket);
    ``kv``: KIVI arguments of CompressionSpec."""
    from pyramidkv_tpu_torch.config import CompressionSpec
    from pyramidkv_tpu_torch.policy import make_plan

    return make_plan(CompressionSpec(method=method, **QCOMP, **kv), LAYERS,
                     QN, QMAX_NEW)


def _kernels():
    from pyramidkv_tpu_torch import kernels

    return {"flash_causal_attention": kernels.flash_causal_attention,
            "decode_attention": kernels.decode_attention,
            **{k: getattr(kernels, k)
               for k in MM_KERNELS + REGION_KERNELS + SPARSE_KERNELS
               + CHUNK_KERNELS + TWO_PASS_KERNELS}}


def reset_counts():
    for fn in _kernels().values():
        fn.launches = 0
        for attr in ("kernels", "blocks", "mm_bf16"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: fn.launches for k, fn in _kernels().items()}


def read_mm_bf16() -> int:
    """Calls of the f32 group wrappers in their mm_bf16 mode."""
    from pyramidkv_tpu_torch import kernels

    return sum(getattr(kernels, k).mm_bf16 for k in (
        "quant_decode_attention", "quant_decode_attention_tiled"))


def read_region_kernels() -> dict:
    """The CUDA kernels the KIVI region wrappers' launches ran."""
    from pyramidkv_tpu_torch import kernels

    return {k: getattr(kernels, k).kernels for k in REGION_KERNELS}


def region_plan_of(kind, dev, b, hk, w, nbits, kg, d=D):
    """(nsplit, CUDA kernels a call launches) of region kernel ``kind`` on
    ``b * hk`` regions of ``w`` byte-rows at head dim ``d``: the group
    kernel's plan (one split for the whole-region wrapper; one launch up to
    MAX_CLUSTER splits, two beyond), the pa kernel's (split kernel and
    finish pass)."""
    from pyramidkv_tpu_torch.kernels import quant_decode, quant_fused_decode

    if kind == "quant_fused_attention_pa":
        # K groups of kg slots: a plane holds whole ones (or one group)
        return (quant_fused_decode.pa_split_plan(
            dev, b * hk, w, kg if kg <= w else 0, d)[0],
            quant_fused_decode.PA_KERNELS)
    nsplit = (1 if kind == "quant_decode_attention"
              else quant_decode.split_plan(dev, b * hk, w, nbits, kg, d)[0])
    return nsplit, quant_decode.region_kernels(nsplit, d)


def region_kernels_per_call(run) -> int:
    """CUDA kernels one region call of a KIVI run launches (see
    region_plan_of)."""
    import torch

    route, b, hm, _, _, nbits, s_pad = kv_shape(run)
    return region_plan_of(route, torch.device("cuda", 0), b, hm,
                          s_pad // (8 // nbits), nbits, 64)[1]


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


#: the compression-stack runs of phase_engine_methods (8k batch, bf16):
#: CompressionSpec arguments beyond the defaults (cap 2048, window 8,
#: kernel 7, maxpool)
METHOD_RUNS = {
    "streamingllm": dict(method="streamingllm"),
    "l2norm": dict(method="l2norm"),  # skip_layers (0, 1): segmented
    "random": dict(method="random"),
    "adakv": dict(method="adakv"),
    "headkv": dict(method="headkv"),  # head_capacity: method_spec
    "cam": dict(method="cam"),
    "snapkv pivot": dict(method="snapkv", merge="pivot"),
    "think": dict(method="think"),  # the narrow layout
    "snapkv gqa": dict(method="snapkv", gqa_aggregate=True),
    "h2o gqa": dict(method="h2o", gqa_aggregate=True),
    "snapkv layer_capacity": dict(method="snapkv"),  # 3072 down to 1024
}
#: the per-layer schedule of the layer_capacity run
LAYER_CAPS = tuple(int(round(3072 - 2048 * i / (LAYERS - 1)))
                   for i in range(LAYERS))
PARITY_METHODS = ("adakv", "cam", "think", "snapkv pivot")


def method_spec(run, layers=LAYERS):
    """The CompressionSpec of a METHOD_RUNS run; headkv's capacities come
    from seeded synthetic retrieval-head scores (the real priors are not in
    the repository) through ``headkv_capacity_from_scores``."""
    from pyramidkv_tpu_torch.config import (CompressionSpec,
                                            headkv_capacity_from_scores)

    kw = dict(METHOD_RUNS[run])
    if run == "headkv":
        scores = np.random.default_rng(15).random(layers * H).tolist()
        kw["head_capacity"] = headkv_capacity_from_scores(
            scores, layers, H, 2048)
    if run == "snapkv layer_capacity":
        kw["layer_capacity"] = LAYER_CAPS[:layers]
    return CompressionSpec(**kw)


def method_plan(run):
    from pyramidkv_tpu_torch.policy import make_plan

    return make_plan(method_spec(run), LAYERS, N, MAX_NEW)


def methods_kv_bytes(plan, b: int, h: int = H, hk: int = HK,
                     layers: int = LAYERS, d: int = D) -> int:
    """The cache bytes a plan implies (bf16 K and V over each segment's
    slots; ThinK's narrow layout: K without the pruned slots, which live
    at D_kept channels beside their int32 channel indices)."""
    from pyramidkv_tpu_torch.policy import stores_kv_heads

    cs = plan.spec
    hs = hk if stores_kv_heads(cs) else h
    sp = plan.think_pruned_slots if plan.think_narrow else 0
    total = sum((stop - start) * b * hs * (2 * sub.total_slots - sp) * d * 2
                for start, stop, sub in plan.segment_plans())
    if plan.think_narrow:
        dk = d - int(d * cs.pruning_ratio)
        total += layers * b * h * (sp * dk * 2 + dk * 4)
    return total


def methods_segments(run):
    """The slot segments each run's plan should have, from the method's
    definition: l2norm's skipped layers 0-1 keep the whole bucket, every
    other plan one width for all layers."""
    if run == "l2norm":
        return ((0, 2, N), (2, LAYERS, 2048))
    width = {"streamingllm": 4, "adakv": 4080,
             "snapkv layer_capacity": max(LAYER_CAPS) - 8}.get(run)
    if run == "headkv":
        caps = method_spec(run).head_capacity
        width = min(max(max(max(r) for r in caps), 2040), N - 8)
    return ((0, LAYERS, width or 2040),)


def phase_engine_methods(torch, F, dev, params, vocab):
    """The rest of the compression stack on the engine phase's 8k batch
    (Llama-3-8B, 32 layers, bf16, 32 new tokens): each METHOD_RUNS run's
    ``generate`` with its launch counts (32 flash; 32 decode launches per
    step, none for ThinK's narrow decode; 32 + 32 H2O launches for h2o
    gqa; no matmul kernel), kv_cache_bytes and segments held to its plan,
    the random run repeated with its seed (same tokens), and AdaKV's
    per-head budgets held to its allocation (each head's visible prefill
    slots = its count + the window); then the decode kernel against its
    plain version at each new cache width.  Returns (ok, {run: counts},
    [decode recs])."""
    from pyramidkv_tpu_torch import policy
    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine

    spec = ModelSpec.preset("llama3-8b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=t).tolist() for t in TRUE_LEN]
    ok, counts = True, {}
    for run in METHOD_RUNS:
        eng = Engine(spec, method_spec(run),
                     EngineSpec(max_new_tokens=MAX_NEW, prefill_buckets=(N,)),
                     params, device=dev)
        eng.generate([p[:64] for p in prompts], max_new_tokens=2)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        out = eng.generate(prompts)
        c = read_counts()
        counts[run] = c
        plan = eng.plan_for(N)
        toks = [t for seq in out.tokens for t in seq]
        h2o = 32 if run == "h2o gqa" else 0
        want_decode = 0 if plan.think_narrow else LAYERS * out.decode_steps
        rec = {"phase": "engine_methods", "run": run,
               "prefill_s": out.prefill_seconds,
               "decode_s": out.decode_seconds,
               "decode_steps": out.decode_steps,
               "decode_tok_per_s": (out.decode_steps * len(prompts)
                                    / out.decode_seconds
                                    if out.decode_seconds else None),
               "kv_cache_bytes": out.kv_cache_bytes,
               "expected_kv_cache_bytes": methods_kv_bytes(plan, B),
               "segments": [list(x) for x in plan.segments],
               "tokens_per_request": [len(x) for x in out.tokens],
               "launches": c}
        good = (c["flash_causal_attention"] == LAYERS
                and c["decode_attention"] == want_decode
                and c["h2o_row_stats"] == h2o and c["h2o_colsum"] == h2o
                and not any(c[k] for k in MM_KERNELS)
                and out.kv_cache_bytes == rec["expected_kv_cache_bytes"]
                and plan.segments == methods_segments(run)
                and out.decode_steps >= 1
                and all(0 <= t < vocab for t in toks)
                and all(len(x) >= 1 for x in out.tokens))
        if run == "random":
            again = eng.generate(prompts, rng_seed=0)
            rec["repeat_same_tokens"] = again.tokens == out.tokens
            good &= rec["repeat_same_tokens"]
        if run == "adakv":
            r, rec["adakv_heads"] = adakv_budgets(torch, dev, eng, prompts,
                                                  policy)
            good &= r
        rec["ok"] = bool(good)
        log(rec)
        ok &= bool(good)
        del eng, out
        torch.cuda.empty_cache()
    # the decode kernel at the new runs' cache widths (random masks)
    recs, seen, seed = [], {}, 90
    for run in METHOD_RUNS:
        plan = method_plan(run)
        if plan.think_narrow:
            continue
        hk = HK if plan.spec.gqa_aggregate else H
        for start, stop, sub in plan.segment_plans():
            key = (hk, sub.total_slots)
            if key not in seen:
                r, rec = check_decode(
                    torch, F, dev, B, H, hk, sub.total_slots, timed=True,
                    seed=seed, label=f"methods S={key[1]}, G={H // hk}")
                ok &= r
                seed += 1
                rec["layers"] = 0
                seen[key] = rec
                recs.append(rec)
            # this shape's launches: its layers in every decode step
            seen[key]["layers"] += (stop - start) * (
                counts[run]["decode_attention"] // LAYERS)
    return ok, counts, recs


def adakv_budgets(torch, dev, eng, prompts, policy):
    """AdaKV's per-head budgets in the cache: a kernel-path prefill of the
    8k batch with ``adakv_allocate`` recorded; each (layer, row, head)'s
    visible prefill slots must equal its allocated count plus the window,
    and the heads' counts must differ.  Returns (ok, summary)."""
    tokens, tl = bucket_tokens(torch, dev, prompts, N)
    seen, orig = [], policy.adakv_allocate

    def record(*a, **kw):
        alloc = orig(*a, **kw)
        seen.append(alloc.counts)
        return alloc

    policy.adakv_allocate = record
    try:
        with torch.inference_mode():
            _, cache = prefill_with(eng, N, tokens, tl, "kernel")
    finally:
        policy.adakv_allocate = orig
    plan = eng.plan_for(N)
    counts = torch.stack(seen)  # [L, B, H]
    vis = cache.mask[..., :plan.prefill_slots].sum(-1)  # [L, B, H]
    win = torch.clamp(tl, max=plan.window).to(vis.dtype)[None, :, None]
    same = bool(torch.equal(vis - win, counts.to(vis.dtype)))
    spread = [int(x) for x in (counts.amin(), counts.amax())]
    del cache
    return same and spread[0] < spread[1], {
        "layers": len(seen), "visible_equals_allocation": same,
        "min_max_head_count": spread}


def phase_parity_methods(torch, dev, params, vocab):
    """Depth-2 logits, kernels against plain, for AdaKV, CAM, ThinK
    (narrow) and pivot merging on the 8k batch: each path's prefill
    logits, then the first decode step of each path on its own copy of
    the kernel path's cache, fed the same tokens.  Limit: 2^-5 of the
    largest plain logit, as phase_parity."""
    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.models import llama

    spec = ModelSpec.preset("llama3-8b", num_hidden_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, size=(B, N)).astype(np.int64)).to(dev)
    tl = torch.tensor(TRUE_LEN, dtype=torch.int32, device=dev)
    ok = True
    for run in PARITY_METHODS:
        eng = Engine(spec, method_spec(run, layers=2),
                     EngineSpec(max_new_tokens=MAX_NEW, prefill_buckets=(N,)),
                     p2, device=dev)
        plan = eng.plan_for(N)
        with torch.inference_mode():
            lk, ck = prefill_with(eng, N, tokens, tl, "kernel")
            lp, cp_ = prefill_with(eng, N, tokens, tl, "plain")
            prefill_err = float((lk - lp).abs().max())
            same_slots = float((ck.positions == cp_.positions).float().mean())
            top = float(lp.abs().max())
            cp_ = clone_cache(torch, ck)
            tok = lp.argmax(-1)
            dk, ck = llama.decode_step(p2, spec, plan, ck, tok,
                                       attention_impl="kernel")
            dp, cp_ = llama.decode_step(p2, spec, plan, cp_, tok,
                                        attention_impl="plain")
        torch.cuda.synchronize()
        err = float((dk - dp).abs().max())
        tol = 2.0 ** -5 * max(top, float(dp.abs().max()))
        good = (max(err, prefill_err) <= tol
                and bool(torch.isfinite(dk).all())
                and tuple(dk.shape) == (B, vocab))
        log({"phase": "parity_methods", "run": run, "depth": 2,
             "prefill_max_abs_err": prefill_err, "decode_max_abs_err": err,
             "tol": tol, "same_argmax": bool(
                 (dk.argmax(-1) == dp.argmax(-1)).all()),
             "plain_prefill_same_slot_share": same_slots, "ok": good})
        ok &= good
        del eng, ck, cp_
        torch.cuda.empty_cache()
    return ok


def clone_cache(torch, cache):
    """A copy of a KVCache's buffers (the decode step writes in place)."""
    import dataclasses

    def cl(x):
        if x is None or isinstance(x, torch.Tensor):
            return x if x is None else x.clone()
        parts = [cl(t) for t in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)

    return dataclasses.replace(cache, **{
        f.name: cl(getattr(cache, f.name))
        for f in dataclasses.fields(cache) if f.name not in ("step",)})


def phase_decode_engine_masks(torch, F, dev, params, vocab):
    """The decode kernel at the engine's own visibility: the mask of a real
    fullkv cache (layer 0, depth 2) after prefill and one decode step, for
    the 8k batch (left pads of 192 to 7192 slots, 31 unwritten decode
    slots) and bench.py's 32k prompt (one pad slot, 127 unwritten), with
    random q, K and V; timed beside the random-mask shapes.  Returns
    (ok, [recs])."""
    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b", num_hidden_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    ok, recs = True, []
    for label, b, bucket, tls, max_new in (
            ("engine mask fullkv 8k", B, N, TRUE_LEN, MAX_NEW),
            ("engine mask fullkv 32k", 1, QN, (QTRUE,), QMAX_NEW)):
        plan = make_plan(CompressionSpec(method="fullkv"), 2, bucket, max_new)
        rng = np.random.default_rng(3)
        tokens = torch.from_numpy(rng.integers(
            0, vocab, size=(b, bucket)).astype(np.int64)).to(dev)
        tl = torch.tensor(tls, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            logits, cache = llama.prefill(p2, spec, plan, tokens, tl)
            _, cache = llama.decode_step(p2, spec, plan, cache,
                                         logits.argmax(-1))
            mask = cache.mask[0].contiguous()
        del cache
        s = mask.shape[-1]
        pads = [bucket - t for t in tls]
        good = (s == plan.total_slots and all(
            not bool(mask[i, :, :pads[i]].any())
            and bool(mask[i, :, pads[i]:bucket + 1].all())
            and not bool(mask[i, :, bucket + 1:].any()) for i in range(b)))
        r, rec = check_decode(torch, F, dev, b, H, HK, s, timed=True,
                              seed=60, label=label, mask=mask)
        rec["mask_layout_ok"] = good
        log({"phase": "decode_engine_masks", "case": label, "pads": pads,
             "ok": r and good})
        ok &= r and good
        recs.append(rec)
        torch.cuda.empty_cache()
    return ok, recs


def quantized(params, weights: str):
    """``params`` (bf16, on the card) in a QUANT format, fused for int4 as
    the runners fuse it; quantize_weights works one layer at a time."""
    from pyramidkv_tpu_torch.models.weights import (fuse_packed_matmuls,
                                                    quantize_weights)

    q = quantize_weights(params, **QUANT[weights])
    return fuse_packed_matmuls(q) if QUANT[weights]["nbits"] == 4 else q


def expected_launches(qp, steps: int, b: int, n: int, chunks: int = 1,
                      layers: int = LAYERS) -> dict:
    """Matmul kernel launches one generate implies, from the plan: the
    routing rule of each quantized leaf at the prefill's b*n rows (layers,
    once per prefill chunk of n tokens) and b rows (the last position's
    lm_head), then at b rows in each decode step."""
    from pyramidkv_tpu_torch.models.weights import QuantW, kernel_route

    counts = dict.fromkeys(MM_KERNELS, 0)

    def add(w, rows, times):
        route = kernel_route(w, rows)
        if route is not None:
            counts[route[0]] += times

    for w in qp["layers"].values():
        if isinstance(w, QuantW):
            w0 = QuantW(w.codes[0], w.scale[0])
            add(w0, b * n, layers * chunks)
            add(w0, b, layers * steps)
    if "lm_head" in qp:  # a tied embedding's logits dequantize
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
    ok, counts, tok_s, prefill_s, qp, have = True, {}, {}, {}, None, None
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
        out = eng.generate([prompt], max_new_tokens=QGEN)
        c = read_counts()
        want = expected_launches(qp, out.decode_steps, 1, QN)
        weights._INT4_KERNEL_DMA[0] = False
        run = f"{wname}{'-dma' if dma else ''} {method}"
        counts[run] = c
        tok_s[run] = out.decode_steps / out.decode_seconds
        prefill_s[run] = out.prefill_seconds
        toks = out.tokens[0]
        good = (c["flash_causal_attention"] == LAYERS
                and c["decode_attention"] == LAYERS * out.decode_steps
                and all(c[k] == want[k] for k in MM_KERNELS)
                and out.decode_steps == QGEN - 1
                and len(toks) == QGEN and all(0 <= t < vocab for t in toks)
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
    return ok, counts, tok_s, prefill_s


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
                  weights="bf16", kv=None):
    """Where the time goes in one prefill and in ``steps`` decode steps:
    host wall time of an unprofiled run, device busy time and the top
    kernels from a torch.profiler trace of a second run (device-side events
    only, so an op and its kernels are not counted twice).  With quantized
    ``params`` (bench.py's shape: one 32767-token prompt) the decode part
    also reports the matmul kernels' device ms per step against the least
    time their code bytes take.  ``kv``: KIVI arguments of CompressionSpec
    (the region kernels' device ms per step is reported too).  Each decode
    record also counts the device operations per step and the host ms per
    step spent inside the step's spans (matmuls, attention, and a KIVI
    layer's region kernel, bf16-tail partials and merge), from a third,
    unprofiled run with a timer around each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.ops import attention
    from pyramidkv_tpu_torch.policy import make_plan

    #: host spans of the decode step: label -> (module, attribute)
    HOST_SPANS = {
        "matmuls": (llama, "mm"),
        "bf16 decode kernel": (llama, "decode_attention"),
        "region_attention": (llama, "_region_attention"),
        "region kernel": (llama, "quant_fused_attention_pa"),
        "region kernel (group)": (llama, "quant_decode_attention"),
        "region kernel (group, tiled)": (llama,
                                         "quant_decode_attention_tiled"),
        "tail partials": (attention, "decode_attention_partials"),
        "merge": (attention, "merge_attention_partials"),
    }
    spec = ModelSpec.preset("llama3-8b")
    quant = weights != "bf16"
    if quant:
        plan, b, n, true_len = qplan(method, **(kv or {})), 1, QN, (QTRUE,)
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
        mm_us = sum(t for k, t, _ in ev if "pkvq::" not in k and (
            "mm_kernel" in k or "finish_kernel" in k))
        region_us = sum(t for k, t, _ in ev if "pkvq::" in k)
        # the bf16 decode kernel: its split and merge kernels
        attn_us = sum(t for k, t, _ in ev if "pkvq::" not in k and (
            "split_kernel" in k or "merge_kernel" in k))
        return sum(t for _, t, _ in ev) / 1e6, [
            {"kernel": k[:90], "device_ms": t / 1e3, "calls": c}
            for k, t, c in top], mm_us / 1e3, region_us / 1e3, sum(
                c for _, _, c in ev), attn_us / 1e3

    def host_spans(fn, *a):
        """Host ms spent inside each of HOST_SPANS while fn(*a) runs, with
        no synchronisation inside a span: the decode loop is host-bound, so
        a span's host time is its share of the step's wall time."""
        spent = {}
        saved = []
        for label, (mod, name) in HOST_SPANS.items():
            orig = getattr(mod, name)
            saved.append((mod, name, orig))

            def timed(*args, _f=orig, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _f(*args, **kw)
                finally:
                    spent[_label] = (spent.get(_label, 0.0)
                                     + time.perf_counter() - t0)
            setattr(mod, name, timed)
        try:
            wall(fn, *a)
        finally:
            for mod, name, orig in saved:
                setattr(mod, name, orig)
        return {k: v * 1e3 for k, v in spent.items()}

    with torch.inference_mode():
        prefill()  # warm-up
        (logits, cache), pre_wall = wall(prefill)
        tok = logits.argmax(-1)
        decode(cache, tok)  # warm-up (writes decode slots 0..steps-1)
        cache.step = 0
        _, dec_wall = wall(decode, cache, tok)
        cache.step = 0
        host = host_spans(decode, cache, tok)
        cache.step = 0
        pre_busy, pre_top, _, _, _, _ = device_profile(prefill)
        dec_busy, dec_top, dec_mm, dec_region, dec_ops, dec_attn = \
            device_profile(decode, cache, tok)
    for part, w, busy, top in (("prefill", pre_wall, pre_busy, pre_top),
                               ("decode", dec_wall, dec_busy, dec_top)):
        rec = {"phase": "profile", "method": method, "weights": weights,
               "kv": kv,
               "part": part, "steps": steps if part == "decode" else None,
               "wall_s": w, "device_busy_s": busy,
               "idle_share": max(0.0, 1 - busy / w), "top": top}
        if quant and part == "decode":
            code_bytes = sum(
                v.codes[0].numel() for v in params["layers"].values()
                if isinstance(v, tuple)) * LAYERS + params["lm_head"][0].numel()
            rec["mm_device_ms_per_step"] = dec_mm / steps
            rec["mm_bound_ms_per_step"] = code_bytes / PEAK_BYTES * 1e3
        if part == "decode":
            # device operations (kernels, copies, fills) per step, and the
            # host ms per step inside each span (spans nest: the region
            # kernel, tail partials and merge lie inside region_attention)
            rec["device_ops_per_step"] = dec_ops / steps
            rec["decode_attention_device_ms_per_step"] = dec_attn / steps
            rec["host_ms_per_step"] = {k: v / steps for k, v in host.items()}
        if kv and part == "decode":
            rec["region_device_ms_per_step"] = dec_region / steps
        log(rec)
    return True


def kv_spec(method, nbits, layout, size, *_):
    """CompressionSpec of a KIVI run (KV_RUNS) and its (bucket, max_new)."""
    from pyramidkv_tpu_torch.config import CompressionSpec

    comp = QCOMP if size == "32k" else {}
    return (CompressionSpec(method=method, quant_method="kivi", nbits=nbits,
                            q_layout=layout, **comp),
            (QN, QMAX_NEW) if size == "32k" else (N, MAX_NEW))


def kv_shape(run):
    """(kernel, B, stored heads, G, prefill slots, nbits, S_pad) of a KIVI
    run's region, from its plan."""
    import torch

    from pyramidkv_tpu_torch.models.llama import region_route
    from pyramidkv_tpu_torch.policy import make_plan, stores_kv_heads

    _, method, nbits, layout, size, f32 = KV_RUNS[run]
    cs, (bucket, max_new) = kv_spec(method, nbits, layout, size)
    plan = make_plan(cs, LAYERS, bucket, max_new)
    hm = HK if stores_kv_heads(cs) else H
    per = 8 // nbits
    s_pad = -(-plan.prefill_slots // (64 * per)) * 64 * per
    b = 1 if size == "32k" else B
    route = region_route(cs, b * hm, s_pad // per, torch.device("cuda", 0),
                         f32)
    return (route.__name__, b, hm, H // hm,
            plan.prefill_slots, nbits, s_pad)


def kv_cache_bytes(run) -> int:
    """kv_cache_bytes a KIVI run must report (see kivi_bytes)."""
    _, _, nbits, layout, size, _ = KV_RUNS[run]
    _, b, hm, _, _, _, s_pad = kv_shape(run)
    return kivi_bytes(b, hm, s_pad, nbits, layout,
                      QMAX_NEW if size == "32k" else MAX_NEW)


def kivi_bytes(b, hm, s_pad, nbits, layout, ds, layers=LAYERS, d=D,
               g=64) -> int:
    """kv_cache_bytes of a monolithic KIVI cache, from its layout (group
    size ``g`` dividing the head dim ``d``): each layer's region codes,
    scales and zeros over ``s_pad`` slots of ``hm`` stored heads, plus its
    ``ds`` bf16 decode slots."""
    per = 8 // nbits
    pa = layout == "pa"
    per_layer = (2 * b * hm * (s_pad // per) * d                      # codes
                 + 2 * b * hm * d * (1 if pa else s_pad // g) * 4     # K s/z
                 + 2 * b * hm * s_pad * (1 if pa else d // g) * 4     # V s/z
                 + 2 * b * hm * ds * d * 2)                           # bf16
    return layers * per_layer


def region_inputs(torch, dev, b, hk, grp, s, nbits, gs, layout, t_len, seed,
                  valid=0.9, k_chunk=None, masked_rows=None, window=None,
                  d=D, q_std=1.0):
    """(q, region, mask, tail) of a KIVI check: the region quantize_kv_region
    makes from random bf16 K (channel-scaled, as KIVI's keys are) and V,
    masks that are views of one longer array (as the engine passes them)
    with region row (0, 0) all masked and tail slot 0 always visible (the
    step's own slot).  ``masked_rows``: a byte-row range (r0, r1) masked on
    every bit-plane of every region (a wholly masked split).  ``window``:
    a fullkv cache's masks under a sliding window (window_mask) instead of
    random ones.  ``d``: the head dim; q drawn at ``q_std``."""
    from pyramidkv_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)
    h = hk * grp
    q = (torch.randn((b, h, d), generator=g, device=dev) * q_std).to(
        torch.bfloat16)
    chan = torch.randn((d,), generator=g, device=dev).exp()
    k = (torch.randn((b, hk, s, d), generator=g, device=dev) * chan).to(
        torch.bfloat16)
    v = torch.randn((b, hk, s, d), generator=g, device=dev).to(torch.bfloat16)
    reg = quant.quantize_kv_region(k, v, nbits=nbits, group_size=gs,
                                   layout=layout)
    if k_chunk:
        kq = quant.quantize(k.float().transpose(2, 3), nbits=nbits,
                            group_size=k_chunk)
        reg = reg._replace(k=kq._replace(
            codes=kq.codes.transpose(-1, -2).contiguous()))
    del k, v
    tk, tv = (torch.randn((b, hk, t_len, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    full = (torch.rand((b, hk, s + t_len + 40), generator=g, device=dev)
            < valid if window is None else
            window_mask(torch, dev, b, hk, s, t_len + 40, t_len // 2, window))
    mask, tmask = full[:, :, :s], full[:, :, s:s + t_len]
    mask[0, 0] = False
    tmask[:, :, 0] = True
    if masked_rows:
        w = reg.k.codes.shape[2]
        rows = torch.arange(s, device=dev) % w
        mask &= ~((rows >= masked_rows[0]) & (rows < masked_rows[1]))
    return q, reg, mask, (tk, tv, tmask)


def check_region(torch, F, dev, kind, b, hk, grp, s, nbits, gs, timed, seed,
                 label, t_len, valid=0.9, k_chunk=None, masked_rows=None,
                 window=None, d=D, scale=None, softcap=None, q_std=1.0,
                 mm_bf16=False):
    """One KIVI region kernel against its plain version on a region that
    the port's quantize_kv_region makes from random bf16 K (channel-scaled,
    as KIVI's keys are) and V, in both of its modes: the region's partials
    (the TPU kernel's function) and, with a bf16 tail of ``t_len`` decode
    slots, the layer's attention output (what the decode step launches).
    The masks are views of one longer array, as the engine passes them:
    region row (0, 0) all masked; tail slot 0 always visible, as the step's
    own slot is.  Times are the tail mode's; ``partials_ms`` the other.
    ``k_chunk`` (pa): K scale groups of that many slots, as the chunked
    prefill's carry quantizes them (one per chunk); ``masked_rows``: a
    byte-row range masked everywhere (region_inputs).  The tail mode runs
    twice and must repeat bit for bit.  ``d``, ``scale``, ``softcap``,
    ``q_std``: Gemma-2's head dim 256, scale and cap (q drawn large enough
    for the cap to bend the logits); ``mm_bf16``: the f32 kernels' mode of
    that name (its logits from the bf16-folded queries, as its plain
    version's).  Under a cap the f32 kernels are held as the folded ones:
    tanh.approx.f32 (relative error ~2^-11) against torch's tanh moves a
    logit of 20 by ~0.01."""
    from pyramidkv_tpu_torch import kernels
    from pyramidkv_tpu_torch.kernels import quant_decode
    from pyramidkv_tpu_torch.ops import quant

    layout = "pa" if kind == "quant_fused_attention_pa" else "group"
    fold = kind.startswith("quant_fused")
    tol = "folded" if fold or softcap is not None else "f32"
    kern = getattr(kernels, kind)
    akw = dict(scale=scale, softcap=softcap)
    kkw = dict(akw, mm_bf16=True) if mm_bf16 else akw

    def plain(q, reg, mask, nbits, tail=None):
        part = (quant.quant_region_attention_fused(q, reg, mask, nbits=nbits,
                                                   **akw) if fold else
                quant.quant_decode_attention_plain(q, reg, mask, nbits=nbits,
                                                   **kkw))
        return quant.merge_tail(part, q, tail, **akw)

    q, reg, mask, tail = region_inputs(torch, dev, b, hk, grp, s, nbits, gs,
                                       layout, t_len, seed, valid, k_chunk,
                                       masked_rows, window, d, q_std)
    tk, tv, tmask = tail
    h = hk * grp
    before = getattr(kern, "mm_bf16", 0)
    got = kern(q, reg, mask, nbits=nbits, **kkw)
    want = plain(q, reg, mask, nbits)
    got_raw = kern(q, reg, mask, nbits=nbits, tail=tail, **kkw)
    again = kern(q, reg, mask, nbits=nbits, tail=tail, **kkw)
    mode_ok = getattr(kern, "mm_bf16", 0) - before == (3 if mm_bf16 else 0)
    got_o = got_raw.float()
    want_o = plain(q, reg, mask, nbits, tail).float()
    torch.cuda.synchronize()
    repeat = bool(torch.equal(got_raw, again))

    def norm(p):
        return p[0] / p[2].clamp_min(1e-30)[..., None]

    og, ow = norm(got), norm(want)
    m_ratio = float(((got[1] - want[1]).abs()
                     / (2.0 ** -12 * want[1].abs().clamp_min(1.0))).max())
    l_ratio = float(((got[2] - want[2]).abs()
                     / (2.0 ** -10 * want[2]).clamp_min(1e-30)).max())
    tail_ratio = err_over_tol(got_o, want_o, *TAIL_TOL[tol])
    ratio = max(err_over_tol(og, ow, *REGION_TOL[tol]), m_ratio, l_ratio,
                tail_ratio)
    w, s_pad, kg, _ = quant.region_geometry(reg, nbits)
    nsplit, per_call = region_plan_of(kind, dev, b, hk, w, nbits, kg, d)
    windows = None  # stagings of the K tables a split takes (group layout)
    if layout == "group":
        rows = w if nsplit == 1 else quant_decode.split_plan(
            dev, b * hk, w, nbits, kg, d)[1]
        windows = -(-rows // quant_decode.region_window(
            grp, nbits, fold or mm_bf16, rows, kg, reg.k.scale.shape[-2],
            reg.v.codes.shape[-1], reg.v.scale.shape[-2], t_len, d))
    rec = {"check": kind, "case": label, "B": b, "Hk": hk, "G": grp, "S": s,
           "D": d, "scale": scale, "softcap": softcap, "mm_bf16": mm_bf16,
           "nsplit": nsplit, "kernels_per_call": per_call,
           "windows": windows,
           "S_pad": s_pad, "plane_width": w, "nbits": nbits,
           "group_size": gs, "layout": layout, "tail": t_len,
           "k_groups": reg.k.scale.shape[-2],
           "max_abs_err": float((og - ow).abs().max()),
           "m_err": float((got[1] - want[1]).abs().max()),
           "l_rel_err": float(((got[2] - want[2]).abs()
                               / want[2].clamp_min(1e-30)).max()),
           "tail_max_abs_err": float((got_o - want_o).abs().max()),
           "tail_err_over_tol": tail_ratio,
           "tail_tol": TAIL_TOL_TEXT[tol],
           "err_over_tol": ratio, "tol": REGION_TOL_TEXT[tol],
           "rms": float(ow.square().mean().sqrt()),
           "masked_rows": masked_rows, "window": window,
           "visible": float(mask.float().mean()), "repeat_bitwise": repeat,
           "mode_launches_ok": mode_ok,
           "all_masked_row": [float(got[1][0, 0]), float(got[2][0, 0])]}
    if timed:
        rec["ms"] = graph_ms(
            torch, lambda: kern(q, reg, mask, nbits=nbits, tail=tail, **kkw),
            reps=50)
        rec["host_ms"] = time_ms(
            torch, lambda: kern(q, reg, mask, nbits=nbits, tail=tail, **kkw),
            reps=50)
        rec["partials_ms"] = graph_ms(
            torch, lambda: kern(q, reg, mask, nbits=nbits, **kkw), reps=50)
        rec["plain_ms"] = graph_ms(
            torch, lambda: plain(q, reg, mask, nbits, tail), reps=3)
        # library yardstick: SDPA over the region dequantized to bf16
        # outside the timed call (it reads 4x-8x the code bytes), with the
        # tail appended (under a cap, on the uncapped function)
        kh, vh = quant.dequantize_kv_region(reg, num_slots=s, head_dim=d,
                                            nbits=nbits, dtype=torch.bfloat16)
        kr = torch.cat([kh, tk], dim=2).repeat_interleave(grp, dim=1)
        vr = torch.cat([vh, tv], dim=2).repeat_interleave(grp, dim=1)
        mr = torch.cat([mask, tmask], dim=2).repeat_interleave(
            grp, dim=1)[:, :, None, :]
        q4 = q[:, :, None, :]
        rec["library_ms"] = graph_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q4, kr, vr, attn_mask=mr, scale=scale), reps=50)
        if softcap is not None:
            rec["library_note"] = UNCAPPED_NOTE
        del kh, vh, kr, vr, mr
        nbytes = (sum(t.numel() * t.element_size()
                      for t in quant.region_leaves(reg))
                  + mask.numel() + q.numel() * 2
                  + 2 * tk.numel() * 2 + tmask.numel() + q.numel() * 2)
        # f32 FMAs per element of K and of V: G dot products, plus the
        # dequantization (group layout); the tail's dot products
        flops = (2.0 * b * hk * s_pad * d * (2 * grp + (0 if layout == "pa"
                                                        else 2))
                 + 2.0 * b * h * t_len * d * 2)
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes,
                                                 PEAK_F32_FLOPS)
    log(rec)
    ok = (ratio <= 1 and repeat and mode_ok and bool(torch.isfinite(og).all())
          and bool(torch.isfinite(got_o).all())
          and rec["all_masked_row"] == [float(torch.finfo(torch.float32).min),
                                        0.0])
    return ok, rec


def phase_kv_quant_kernels(torch, F, dev):
    """The four KIVI region kernels against their plain versions: short
    ragged regions first (a plane width that is no multiple of the 32-row
    chunk, K groups of 12 slots straddling chunks, a last split shorter than
    the others, an odd plane width with odd V rows), then each KIVI run's
    region shape, timed.  Returns (ok, {kernel: [timed recs]})."""
    ok = True
    # (kernel, B, Hk, G, slots, nbits, group size, tail slots): tails of 1
    # (the first decode step) to 37 slots, some not a multiple of 4 warps;
    # the group kernel on one split, in a cluster and past one; on one
    # split whose K tables take 7 stagings (K groups of 12 slots straddling
    # them)
    short = (("quant_decode_attention", 2, 3, 2, 1000, 4, 12, 1),
             ("quant_decode_attention", 1, 4, 8, 40, 2, 16, 37),
             ("quant_decode_attention", 1, 2, 8, 8800, 2, 12, 5),
             ("quant_decode_attention_tiled", 1, 8, 4, 4900, 4, 64, 6),
             ("quant_decode_attention_tiled", 2, 2, 1, 300, 8, 32, 2),
             ("quant_fused_attention_pa", 2, 2, 4, 1001, 8, 5, 13),
             ("quant_fused_attention_pa", 1, 3, 2, 777, 2, 64, 1),
             ("quant_fused_attention_group", 2, 3, 2, 1000, 4, 12, 1),
             ("quant_fused_attention_group", 1, 8, 8, 4900, 2, 16, 37),
             ("quant_fused_attention_group", 2, 2, 1, 300, 8, 32, 2))
    seed = 300
    for kind, b, hk, grp, s, nbits, gs, t_len in short:
        r, _ = check_region(torch, F, dev, kind, b, hk, grp, s, nbits, gs,
                            False, seed, "short", t_len)
        ok &= r
        seed += 1
    # edge shapes of the pa kernel (untimed): G = 8 with 2-bit codes and 4
    # K groups (the chunked carry; the earlier kernel refused it), a tail
    # of 37; V rows of 129 bytes (V group size 3: staged byte by byte) with
    # splits ending inside a 16-row unit, a tail of 1
    for label, b, hk, grp, s, nbits, gs, t_len, k_chunk in (
            ("edge: G=8 kivi2, 4 K groups", 1, 2, 8, 1024, 2, 64, 37, 256),
            ("edge: V rows of 129 bytes, splits ending mid-unit", 2, 3, 4,
             1001, 4, 3, 1, None)):
        r, _ = check_region(torch, F, dev, "quant_fused_attention_pa", b, hk,
                            grp, s, nbits, gs, False, seed, label, t_len,
                            k_chunk=k_chunk)
        ok &= r
        seed += 1
    # a wholly masked split: split 1 of the 8k batch's 2-split clusters,
    # and of an 8-split plan merged by the merge kernel (byte-row range
    # masked on every plane of every region)
    for kind, b, hk, grp, s, nbits, gs, t_len, rows in (
            ("quant_decode_attention_tiled", 4, 32, 1, 2048, 4, 64, 9,
             (512, 1024)),
            ("quant_fused_attention_group", 4, 32, 1, 2048, 2, 64, 32,
             (256, 512)),
            ("quant_fused_attention_group", 2, 4, 2, 2000, 4, 64, 5,
             (128, 256))):
        r, _ = check_region(torch, F, dev, kind, b, hk, grp, s, nbits, gs,
                            False, seed, "short, a split masked", t_len,
                            masked_rows=rows)
        ok &= r
        seed += 1
    recs = {k: [] for k in REGION_KERNELS}
    checked = {}  # (kernel, region shape) -> the run it was checked for
    for run, (_, _, _, layout, size, _) in KV_RUNS.items():
        kind, b, hm, grp, sp, nbits, _ = kv_shape(run)
        # the decode slots of the run: its tail at its last step
        t_len = QMAX_NEW if size == "32k" else MAX_NEW
        r, rec = check_region(torch, F, dev, kind, b, hm, grp, sp, nbits, 64,
                              True, seed, run, t_len)
        # launches per generate: one per layer per decode step
        rec["layers"] = LAYERS * (t_len - 1)
        recs[kind].append(rec)
        ok &= r
        shape = (b, hm, grp, sp, nbits)
        checked[(kind, shape)] = run
        for other in (GROUP_KERNELS if layout == "group" else ()):
            # a group kernel no run takes at this shape, timed there: the
            # evidence for the routes (kept out of the kernels line)
            if (other, shape) in checked or any(
                    kv_shape(r2)[0] == other and kv_shape(r2)[1:6] == shape
                    for r2 in KV_RUNS):
                continue
            checked[(other, shape)] = run
            r, _ = check_region(torch, F, dev, other, b, hm, grp, sp, nbits,
                                64, True, seed, run + " (other route)",
                                t_len)
            ok &= r
        seed += 1
        torch.cuda.empty_cache()
    return ok, recs


def phase_engine_kv_quant(torch, dev, params, q4, vocab):
    """``Engine.generate`` on a KIVI cache for each KV_RUNS configuration:
    every decode step sends each layer's region through exactly one region
    kernel (the route its layout, size and ``f32`` flag call for) and
    nothing through the bf16 decode kernel; kv_cache_bytes equals the
    layout's.  Returns (ok, {run: counts}, {run: decode tok/s})."""
    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine

    spec = ModelSpec.preset("llama3-8b")
    p32 = [np.random.default_rng(0).integers(0, vocab, size=QTRUE).tolist()]
    rng = np.random.default_rng(0)
    p8 = [rng.integers(0, vocab, size=t).tolist() for t in TRUE_LEN]
    ok, counts, tok_s = True, {}, {}
    for run, (wname, method, nbits, layout, size, f32) in KV_RUNS.items():
        cs, (bucket, max_new) = kv_spec(method, nbits, layout, size)
        prompts = p32 if size == "32k" else p8
        eng = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                          prefill_buckets=(bucket,),
                                          use_quant_kernel=f32),
                     q4 if wname == "int4" else params, device=dev)
        eng.generate(prompts, max_new_tokens=2)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        gen = gen_new(max_new)
        out = eng.generate(prompts, max_new_tokens=gen)
        c = read_counts()
        counts[run] = c
        tok_s[run] = out.decode_steps * len(prompts) / out.decode_seconds
        ck = read_region_kernels()
        route = kv_shape(run)[0]
        per_call = region_kernels_per_call(run)
        want_bytes = kv_cache_bytes(run)
        toks = [t for seq in out.tokens for t in seq]
        good = (c[route] == LAYERS * out.decode_steps
                and ck[route] == per_call * c[route]
                and not any(c[k] for k in REGION_KERNELS if k != route)
                and c["decode_attention"] == 0
                and c["flash_causal_attention"] == LAYERS
                and out.decode_steps == gen - 1
                and out.kv_cache_bytes == want_bytes
                and (size != "32k" or method != "fullkv"
                     or want_bytes == KV_BYTES_32K[layout])
                and eng.f32_quant == f32
                and eng.plan_for(bucket).segments == (
                    (0, LAYERS, eng.plan_for(bucket).width),)
                and all(0 <= t < vocab for t in toks)
                and all(len(seq) == gen for seq in out.tokens))
        log({"phase": "engine_kv_quant", "run": run, "weights": wname,
             "method": method, "nbits": nbits, "layout": layout,
             "route": route, "region_kernels_per_layer_step": per_call,
             "prefill_s": out.prefill_seconds,
             "decode_s": out.decode_seconds,
             "decode_steps": out.decode_steps,
             "decode_tok_per_s": tok_s[run],
             "kv_cache_bytes": out.kv_cache_bytes,
             "expected_kv_cache_bytes": want_bytes, "launches": c,
             "region_cuda_kernels": ck,
             "first_tokens": out.tokens[0][:8], "ok": good})
        ok &= good
        del eng, out
        torch.cuda.empty_cache()
    return ok, counts, tok_s


def phase_parity_kv_quant(torch, dev, params, vocab, steps=4):
    """Depth-2 decode logits on a KIVI cache, kernels against plain: one
    prefill through the kernels, then ``steps`` decode steps of each path
    on its own copy of the cache, fed the same tokens, for bench.py's
    fullkv kivi4-pa at 32k (int4 weights) and snapkv kivi4 on the 8k batch
    (bf16 weights).  Limit: 2^-5 of the largest logit, as phase_parity."""
    from pyramidkv_tpu_torch.cache import KVCache
    from pyramidkv_tpu_torch.config import ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b", num_hidden_layers=2)
    ok = True
    for run in ("int4 fullkv kivi4-pa 32k", "bf16 snapkv kivi4 8k"):
        wname, method, nbits, layout, size, _ = KV_RUNS[run]
        cs, (bucket, max_new) = kv_spec(method, nbits, layout, size)
        p2 = dict(params, layers={k: v[:2]
                                  for k, v in params["layers"].items()})
        if wname == "int4":
            p2 = quantized(p2, "int4")
        plan = make_plan(cs, 2, bucket, max_new)
        rng = np.random.default_rng(1)
        b, tl = (1, (QTRUE,)) if size == "32k" else (B, TRUE_LEN)
        tokens = torch.from_numpy(
            rng.integers(0, vocab, size=(b, bucket)).astype(np.int64)).to(dev)
        tl = torch.tensor(tl, dtype=torch.int32, device=dev)
        err = top = 0.0
        same = True
        with torch.inference_mode():
            logits, ck = llama.prefill(p2, spec, plan, tokens, tl)
            cp = KVCache(k=ck.k.clone(), v=ck.v.clone(), mask=ck.mask.clone(),
                         positions=ck.positions.clone(), true_len=ck.true_len,
                         quant=ck.quant)
            tok = logits.argmax(-1)
            for _ in range(steps):
                lk, ck = llama.decode_step(p2, spec, plan, ck, tok,
                                           attention_impl="kernel")
                lp, cp = llama.decode_step(p2, spec, plan, cp, tok,
                                           attention_impl="plain")
                err = max(err, float((lk - lp).abs().max()))
                top = max(top, float(lp.abs().max()))
                same &= bool((lk.argmax(-1) == lp.argmax(-1)).all())
                ok &= bool(torch.isfinite(lk).all())
                tok = lp.argmax(-1)
        torch.cuda.synchronize()
        tol = 2.0 ** -5 * top
        good = err <= tol
        log({"phase": "parity_kv_quant", "run": run, "depth": 2,
             "decode_steps": steps, "max_abs_err": err, "tol": tol,
             "same_argmax": same, "ok": good})
        ok &= good
        del p2, ck, cp
        torch.cuda.empty_cache()
    return ok


def load_pcfg():
    """PCFG_PATH as CompressionSpec.minference_pattern_config (32 x 32)."""
    import os

    from pyramidkv_tpu_torch.config import load_minference_pattern_config

    root = os.path.dirname(os.path.abspath(__file__))
    return load_minference_pattern_config(os.path.join(root, PCFG_PATH),
                                          LAYERS, H)


def sparse_budgets(torch, dev, budgets) -> dict:
    """estimate_vertical_slash's budget arguments of a SPARSE_CASES entry."""
    from pyramidkv_tpu_torch.config import CompressionSpec

    if budgets == "default":
        cs = CompressionSpec(method="minference")
        return dict(vertical_size=cs.minference_vertical_size,
                    slash_size=cs.minference_slash_size)
    if budgets == "pcfg":
        cfg = load_pcfg()
        return dict(
            vertical_size=torch.tensor([v for v, _ in cfg[0]],
                                       dtype=torch.int32, device=dev),
            slash_size=torch.tensor([s for _, s in cfg[0]],
                                    dtype=torch.int32, device=dev),
            max_vertical=max(v for layer in cfg for v, _ in layer),
            max_slash=max(s for layer in cfg for _, s in layer))
    return dict(vertical_size=budgets[0], slash_size=budgets[1])


def partials_ratio(got, want) -> tuple:
    """(largest error over its limit, max |acc/l error|, max |m error|, max
    l relative error) of a partials triple against another: acc / l within
    TOL_TEXT, m within 2^-12 max(1, |m|), l within 2^-10 l."""
    og = got[0] / got[2].clamp_min(1e-30)[..., None]
    ow = want[0] / want[2].clamp_min(1e-30)[..., None]
    dm = (got[1] - want[1]).abs()
    dl = (got[2] - want[2]).abs()
    ratio = max(err_over_tol(og, ow),
                float((dm / (2.0 ** -12 * want[1].abs().clamp_min(1.0))).max()),
                float((dl / (2.0 ** -10 * want[2]).clamp_min(1e-30)).max()))
    return (ratio, float((og - ow).abs().max()), float(dm.max()),
            float((dl / want[2].clamp_min(1e-30)).max()))


def slash_library_inputs(torch, q, k, v, ti, tv, vert, tl, qb, kt):
    """The slash partials' function as one masked SDPA call: q as
    [B*H*nq, 1, q_block, D] against its listed tiles gathered to
    [B*H*nq, 1, T*k_tile, D], with a [B*H*nq, 1, q_block, T*k_tile] mask."""
    b, h, n, d = q.shape
    g = h // k.shape[1]
    nq, t = n // qb, ti.shape[-1]
    dev = q.device
    cols = (ti.long()[..., None] * kt
            + torch.arange(kt, device=dev)).reshape(b, h, nq, t * kt)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(h, device=dev)[None, :, None]
    kh = k[bi, hi // g, cols.reshape(b, h, -1)].reshape(b * h * nq, 1,
                                                        t * kt, d)
    vh = v[bi, hi // g, cols.reshape(b, h, -1)].reshape(b * h * nq, 1,
                                                        t * kt, d)
    pad = (n - tl.long())[:, None, None, None]
    colv = ((cols >= pad)
            & ~vert[bi, hi, cols.reshape(b, h, -1)].reshape(cols.shape)
            & tv.repeat_interleave(kt, dim=-1))
    rows = torch.arange(n, device=dev).reshape(nq, qb)[None, None, :, :,
                                                       None]
    mask = (cols[..., None, :] <= rows) & colv[..., None, :]
    return (q.reshape(b * h * nq, 1, qb, d), kh, vh,
            mask.reshape(b * h * nq, 1, qb, t * kt))


def slash_pairs(torch, ti, tv, vert, tl, qb, kt) -> float:
    """Visible (row, column) pairs of the slash partials: per listed valid
    tile, the columns right of the pad and not vertical, each against the
    rows of the q-block at or below it."""
    b, h, nq, t = ti.shape
    dev = ti.device
    n = vert.shape[-1]
    cols = ti.long()[..., None] * kt + torch.arange(kt, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    hi = torch.arange(h, device=dev)[None, :, None, None, None]
    pad = (n - tl.long())[:, None, None, None, None]
    live = (tv[..., None] & (cols >= pad)
            & ~vert[bi, hi, cols])
    q0 = (torch.arange(nq, device=dev) * qb)[None, None, :, None, None]
    rows = (q0 + qb - torch.maximum(cols, q0)).clamp(0, qb)
    return float((rows * live).sum())


def list_prefix(torch, tv):
    """The db function's entries: the first tv.sum(-1) of each list
    (arange(T) < nval), written here apart from the wrapper's valid_prefix
    so that a fault there shows against this."""
    t = tv.shape[-1]
    return (torch.arange(t, device=tv.device)
            < tv.sum(-1, keepdim=True)).contiguous()


def check_sparse(torch, F, dev, case, seed, d=D, scale=None, softcap=None,
                 q_std=1.0):
    """The three block-sparse kernels against their plain versions on one
    SPARSE_CASES (or QWEN_ / GEMMA_SPARSE_CASES) shape at head dim ``d``
    with ``scale`` and ``softcap`` (q drawn at ``q_std``), on a pattern that
    the port's estimate_vertical_slash makes from seeded random bf16 q/k
    (the same pattern for both sides, estimated with the same scale and
    cap);
    db's plain version is the slash one over each list's valid prefix.
    Each kernel is called twice and held bitwise equal; db and grid are
    held bitwise equal to each other where the lists are valid-first (one
    kernel, the same flags), and their difference is logged where not.
    Timed cases add each kernel's time (a CUDA graph of repeated calls),
    its plain version's, one masked SDPA call's (the yardstick) and the
    bound.  Returns (ok, {kernel: rec})."""
    from pyramidkv_tpu_torch import kernels
    from pyramidkv_tpu_torch.ops import sparse_prefill as sp

    (b, h, hk, n, true_len, budgets, qb, kt, budget, shuffle, permute,
     timed) = {**SPARSE_CASES, **QWEN_SPARSE_CASES,
               **GEMMA_SPARSE_CASES}[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((b, h, n, d), generator=g, device=dev)
         * q_std).to(torch.bfloat16)
    k = torch.randn((b, hk, n, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, hk, n, d), generator=g, device=dev).to(torch.bfloat16)
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
    akw = dict(scale=scale, softcap=softcap)
    pat = sp.estimate_vertical_slash(q, k, true_len=tl, **akw,
                                     **sparse_budgets(torch, dev, budgets))
    ti, tv = sp._slash_tile_selection(pat, n, qb, kt, budget)
    if permute:
        perm = torch.argsort(torch.rand(ti.shape, generator=g, device=dev),
                             dim=-1)
        ti, tv = ti.gather(-1, perm).contiguous(), tv.gather(-1, perm)
        tv = tv.contiguous()
    prefix = list_prefix(torch, tv)
    vcol, vvalid = pat.vert_idx, pat.vert_valid
    if shuffle:
        perm = torch.randperm(vcol.shape[-1], generator=g, device=dev)
        vcol, vvalid = vcol[..., perm].contiguous(), vvalid[..., perm]
        vvalid = vvalid.contiguous()
    k_vert, v_vert = sp.gather_vertical_kv(k, v, vcol)
    vs, t = k_vert.shape[2], ti.shape[-1]
    vargs = (q, k_vert, v_vert, vcol, vvalid, tl)
    sargs = (q, k, v, ti, tv, pat.vert, tl)
    skw = dict(q_block=qb, k_tile=kt, **akw)

    def db_plain(*args, **kw):  # the slash function over the prefix
        return sp.slash_tile_attention_plain(*args[:4], prefix, *args[5:],
                                             **kw)

    # name -> (kernel, plain version, arguments, keywords, the flags that
    # count for its slash walk)
    calls = {"vertical_attention_partials": (
                 kernels.vertical_attention_partials,
                 sp.vertical_attention_partials_plain, vargs, akw, None),
             "slash_tile_attention": (
                 kernels.slash_tile_attention, sp.slash_tile_attention_plain,
                 sargs, skw, tv),
             "slash_tile_attention_db": (
                 kernels.slash_tile_attention_db, db_plain, sargs, skw,
                 prefix)}
    ok, recs, outs = True, {}, {}
    shape = {"case": case, "B": b, "H": h, "Hk": hk, "N": n, "D": d,
             "scale": scale, "softcap": softcap,
             "true_len": list(true_len), "Vs": vs, "T": t, "q_block": qb,
             "k_tile": kt, "shuffled": shuffle, "lists_permuted": permute,
             "valid_vertical": int(vvalid.sum()),
             "valid_tiles": int(tv.sum()),
             "lists_not_valid_first": int((prefix != tv).any(-1).sum())}
    for name, (kern, plain, args, kw, flags) in calls.items():
        want = plain(*args, **kw)
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        outs[name] = got
        ratio, err, m_err, l_err = partials_ratio(got, want)
        rec = {"check": name, **shape, "max_abs_err": err, "m_err": m_err,
               "l_rel_err": l_err, "err_over_tol": ratio,
               "tol": SPARSE_TOL_TEXT,
               "rms": float((want[0] / want[2].clamp_min(1e-30)[..., None])
                            .square().mean().sqrt())}
        del want
        again = kern(*args, **kw)
        rec["bitwise_repeat"] = all(torch.equal(x, y)
                                    for x, y in zip(got, again))
        del again
        if timed:
            rec["ms"] = graph_ms(torch, lambda: kern(*args, **kw), reps=10)
            rec["plain_ms"] = time_ms(torch, lambda: plain(*args, **kw),
                                      reps=1, warmup=0)
            if name.startswith("vertical"):
                rows = torch.arange(n, device=dev)[None, None, :, None]
                mask = ((vcol[:, :, None, :] <= rows)
                        & vvalid[:, :, None, :])
                lib = (q, k_vert, v_vert)
                pairs = float(((n - vcol.long()) * vvalid).sum())
                nbytes = (q.numel() * 2 + 2 * k_vert.numel() * 2
                          + vs * b * h * 5)
            else:
                *lib, mask = slash_library_inputs(torch, q, k, v, ti, flags,
                                                  pat.vert, tl, qb, kt)
                pairs = slash_pairs(torch, ti, flags, pat.vert, tl, qb, kt)
                nbytes = (q.numel() * 2 + 2 * k.numel() * 2 + ti.numel() * 5
                          + b * h * n + b * 4)
            rec["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *lib, attn_mask=mask, scale=scale), reps=3)
            if softcap is not None:
                rec["library_note"] = UNCAPPED_NOTE
            del lib, mask
            nbytes += b * h * n * (d + 2) * 4  # acc, m, l written
            rec["visible_pairs"] = pairs
            rec["bound_ms"], rec["bound_by"], units = attn_bound(
                pairs, d, nbytes, softcap)
            if softcap is not None:
                rec["bound_units_ms"] = units
        log(rec)
        ok &= (ratio <= 1 and all(bool(torch.isfinite(x).all()) for x in got)
               and tuple(got[0].shape) == (b, h, n, d)
               and rec["bitwise_repeat"])
        recs[name] = rec
        torch.cuda.empty_cache()
    # one kernel: on valid-first lists the prefix is the flags, so db is
    # grid bit for bit; elsewhere the two functions differ (logged only)
    ratio, err, _, _ = partials_ratio(outs["slash_tile_attention_db"],
                                      outs["slash_tile_attention"])
    same = all(torch.equal(a, b_) for a, b_ in zip(
        outs["slash_tile_attention_db"], outs["slash_tile_attention"]))
    log({"check": "slash_tile_attention_db vs slash_tile_attention",
         "case": case, "lists_permuted": permute, "max_abs_err": err,
         "err_over_tol": ratio, "bitwise_equal": same,
         "required": "nothing (lists not valid-first)" if permute
         else "bitwise equal"})
    ok &= permute or same
    return ok, recs


def phase_minference_kernels(torch, F, dev):
    """Every SPARSE_CASES shape, short ones first.  Returns (ok, {kernel:
    [timed rec per main shape]})."""
    ok, recs = True, {k: [] for k in SPARSE_KERNELS}
    for seed, case in enumerate(SPARSE_CASES, start=400):
        r, got = check_sparse(torch, F, dev, case, seed)
        ok &= r
        if SPARSE_CASES[case][-1]:
            for name, rec in got.items():
                recs[name].append(rec)
        torch.cuda.empty_cache()
    return ok, recs


def minf_spec(run):
    """CompressionSpec of a MINF_RUNS run and its (bucket, max_new)."""
    from pyramidkv_tpu_torch.config import CompressionSpec

    _, extra, case = MINF_RUNS[run]
    if extra == "pcfg":
        extra = dict(minference_pattern_config=load_pcfg())
    return (CompressionSpec(method="minference", **extra),
            (QN, QMAX_NEW) if case.startswith("32k") else (N, MAX_NEW))


def phase_engine_minference(torch, dev, params, q4, vocab, fullkv_prefill_s):
    """``Engine.generate`` with minference for each MINF_RUNS run: the
    prefill goes through exactly one vertical and one slash kernel a layer
    (the slash kernel minference_slash_impl names) and no flash kernel;
    decode runs fullkv's bf16 decode kernel (G=4) once a layer a step; the
    cache is fullkv's.  Returns (ok, {run: counts})."""
    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine

    spec = ModelSpec.preset("llama3-8b")
    p32 = [np.random.default_rng(0).integers(0, vocab, size=QTRUE).tolist()]
    rng = np.random.default_rng(0)
    p8 = [rng.integers(0, vocab, size=t).tolist() for t in TRUE_LEN]
    ok, counts = True, {}
    for run, (wname, _, case) in MINF_RUNS.items():
        cs, (bucket, max_new) = minf_spec(run)
        prompts = p32 if case.startswith("32k") else p8
        qp = q4 if wname == "int4" else params
        eng = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                          prefill_buckets=(bucket,)),
                     qp, device=dev)
        eng.generate(prompts, max_new_tokens=2)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        gen = gen_new(max_new)
        out = eng.generate(prompts, max_new_tokens=gen)
        c = read_counts()
        counts[run] = c
        slash = ("slash_tile_attention_db" if cs.minference_slash_impl == "db"
                 else "slash_tile_attention")
        b = len(prompts)
        want_bytes = LAYERS * 2 * b * HK * (bucket + max_new) * D * 2
        want_mm = (expected_launches(qp, out.decode_steps, b, bucket)
                   if wname == "int4" else dict.fromkeys(MM_KERNELS, 0))
        toks = [t for seq in out.tokens for t in seq]
        good = (c["vertical_attention_partials"] == LAYERS
                and c[slash] == LAYERS
                and all(c[k] == 0 for k in SPARSE_KERNELS[1:] if k != slash)
                and c["flash_causal_attention"] == 0
                and c["decode_attention"] == LAYERS * out.decode_steps
                and all(c[k] == want_mm[k] for k in MM_KERNELS)
                and not any(c[k] for k in REGION_KERNELS)
                and out.decode_steps == gen - 1
                and out.kv_cache_bytes == want_bytes
                and (b > 1 or want_bytes == KV_BYTES_FULLKV_32K)
                and all(0 <= t < vocab for t in toks)
                and all(len(seq) == gen for seq in out.tokens))
        log({"phase": "engine_minference", "run": run, "weights": wname,
             "slash_impl": cs.minference_slash_impl,
             "pattern_config": cs.minference_pattern_config is not None,
             "bucket": bucket, "G": H // HK,
             "prefill_s": out.prefill_seconds,
             "int4_fullkv_prefill_s": fullkv_prefill_s
             if case.startswith("32k") else None,
             "decode_s": out.decode_seconds,
             "decode_steps": out.decode_steps,
             "decode_tok_per_s": out.decode_steps * b / out.decode_seconds,
             "kv_cache_bytes": out.kv_cache_bytes,
             "expected_kv_cache_bytes": want_bytes, "launches": c,
             "first_tokens": out.tokens[0][:8], "ok": good})
        ok &= good
        del eng, out
        torch.cuda.empty_cache()
    return ok, counts


def phase_parity_minference(torch, dev, params, vocab):
    """Depth-2 last-position prefill logits at full width on bench.py's 32k
    prompt: the sparse path through the kernels against its plain versions
    (the limit of phase_parity: 2^-5 of the largest logit); beside it, for
    information, how far the sparse logits lie from dense fullkv's."""
    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b", num_hidden_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, size=(1, QN)).astype(np.int64)).to(dev)
    tl = torch.tensor((QTRUE,), dtype=torch.int32, device=dev)
    plan = make_plan(CompressionSpec(method="minference"), 2, QN, QMAX_NEW)
    fplan = make_plan(CompressionSpec(method="fullkv"), 2, QN, QMAX_NEW)
    with torch.inference_mode():
        reset_counts()
        lk, _ = llama.prefill(p2, spec, plan, tokens, tl,
                              attention_impl="kernel")
        c = read_counts()
        lp, _ = llama.prefill(p2, spec, plan, tokens, tl,
                              attention_impl="plain")
        ld, _ = llama.prefill(p2, spec, fplan, tokens, tl,
                              attention_impl="kernel")
    torch.cuda.synchronize()
    err = float((lk - lp).abs().max())
    tol = 2.0 ** -5 * float(lp.abs().max())
    ok = (err <= tol and bool(torch.isfinite(lk).all())
          and tuple(lk.shape) == (1, vocab)
          and c["vertical_attention_partials"] == 2
          and c["slash_tile_attention"] == 2
          and c["flash_causal_attention"] == 0)
    log({"phase": "parity_minference", "depth": 2, "N": QN,
         "max_abs_err": err, "tol": tol,
         "same_argmax": bool((lk.argmax(-1) == lp.argmax(-1)).all()),
         "launches": {k: c[k] for k in SPARSE_KERNELS},
         "vs_dense_fullkv_max_abs": float((lk - ld).abs().max()),
         "dense_max_abs_logit": float(ld.abs().max()),
         "same_argmax_as_dense": bool((lk.argmax(-1) == ld.argmax(-1)).all()),
         "ok": ok})
    del p2
    torch.cuda.empty_cache()
    return ok


def phase_profile_minference(torch, dev, q4, vocab):
    """Where the time goes in one 32k minference prefill (int4 weights,
    bench.py's prompt) beside int4 fullkv's: CUDA events recorded around
    each stage (estimation, tile selection, gather, each kernel, merge; for
    fullkv the flash kernel) give the stream time each takes, which is its
    device time while the device runs without gaps; "rest" is the prefill's
    stream time less those stages.  The vertical kernel's wrapper sorts its
    columns first: "vertical sort" (torch's sort by key and the per-tile
    counts; the copy of K and V in key order is a kernel of the vertical
    call) is taken out of "vertical kernel".  Wall times from unpatched
    runs."""
    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.kernels import block_sparse_prefill as bsp
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.ops import sparse_prefill as sp
    from pyramidkv_tpu_torch.policy import make_plan

    spec = ModelSpec.preset("llama3-8b")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, size=(1, QN)).astype(np.int64)).to(dev)
    tl = torch.tensor((QTRUE,), dtype=torch.int32, device=dev)
    spans = {}

    def timed(label, fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = fn(*a, **kw)
            e1.record()
            spans.setdefault(label, []).append((e0, e1))
            return res
        return run

    orig_fns = sp._partials_fns

    def partials_fns(impl, slash_impl):
        vert, slash = orig_fns(impl, slash_impl)
        return (timed("vertical kernel", vert),
                timed("slash kernel", slash))

    patches = [(sp, "estimate_vertical_slash", "estimation"),
               (sp, "_slash_tile_selection", "tile selection"),
               (sp, "gather_vertical_kv", "gather"),
               (sp, "merge_partials", "merge"),
               (bsp, "sort_vertical_columns", "vertical sort"),
               (llama, "flash_causal_attention", "flash kernel")]
    out = {}
    with torch.inference_mode():
        for method in ("minference", "fullkv"):
            plan = make_plan(CompressionSpec(method=method), LAYERS, QN,
                             QMAX_NEW)
            llama.prefill(q4, spec, plan, tokens, tl)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            llama.prefill(q4, spec, plan, tokens, tl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
            saved.append((sp, "_partials_fns", orig_fns))
            spans.clear()
            try:
                for m, a, label in patches:
                    setattr(m, a, timed(label, getattr(m, a)))
                sp._partials_fns = partials_fns
                total = timed("prefill", llama.prefill)
                total(q4, spec, plan, tokens, tl)
                torch.cuda.synchronize()
            finally:
                for m, a, fn in saved:
                    setattr(m, a, fn)
            ms = {k: sum(e0.elapsed_time(e1) for e0, e1 in v)
                  for k, v in spans.items()}
            stream_ms = ms.pop("prefill")
            if "vertical sort" in ms:  # inside the vertical kernel's span
                ms["vertical kernel"] -= ms["vertical sort"]
            out[method] = {"wall_s": wall, "stream_ms": stream_ms,
                           "stages_ms": ms,
                           "rest_ms": stream_ms - sum(ms.values()),
                           "stage_calls": {k: len(v) for k, v in
                                           spans.items() if k != "prefill"}}
            torch.cuda.empty_cache()
    log({"phase": "profile_minference", "weights": "int4", "N": QN,
         "minference": out["minference"], "int4_fullkv": out["fullkv"]})
    return (out["minference"]["stage_calls"].get("vertical kernel") == LAYERS
            and out["fullkv"]["stage_calls"].get("flash kernel") == LAYERS)


# ---------------------------------------------------------------------------
# H2O and chunked prefill
# ---------------------------------------------------------------------------

CHUNK_KERNELS = ("h2o_row_stats", "h2o_colsum", "flash_attention_partials")
#: prefill chunks: the 8k batch's, and bench.py's 32k prompt's (the JAX
#: scripts' ``--prefill_chunk 8192``)
C8K, C32K = 2048, 8192
#: H2O scores (sums of up to N probabilities, f32) against the plain
#: version: the attention limit over each (b, h) row of N - W columns.  The
#: kernel's logits use q * log2(e)/sqrt(D) rounded to bf16 (the TPU
#: kernel's fold), the plain version's the unrounded q: each probability
#: moves by up to ~2^-9 relative, at random over the rows summed.
H2O_TOL_TEXT = TOL_TEXT + " over each (b, h) row's N - W scores"
#: the colsum kernel against its plain version fed the same (m, l): both
#: exponentiate logits that are exact f32 products of the same bf16 values
#: (the scaled q rounded alike) and sum in f32 in other orders (~2^-20
#: relative, chip run 2), so they are held as the f32-output matmuls are
#: (MM_TOL), plus 2^-14 |want|
COLSUM_TOL = (2.0 ** -14, 2.0 ** -14)
COLSUM_TOL_TEXT = "|err| <= 2^-14 |want| + 2^-14 rms(want's row)"
STATS_TOL_TEXT = ("m within 2^-12 max(1,|m|), l within 2^-10 l (rows past "
                  "the pad)")
#: H2O kernel checks: case -> (B, H, Hk, N, true_len, W, the engine's top-k
#: width there, timed).  The edge cases: pads of 256 and 128 (on 128-row
#: tile boundaries); a pad of 240 (q tile 0 wholly padding, q tile 1
#: straddling the pad); N % 128 = 64 (N - W = 440, the last key and query
#: tiles cut short by N); W = 200 (the W x W block's rows 312-511 span two
#: tiles)
H2O_CASES = {
    "short ragged": (2, 8, 2, 384, (384, 150), 8, 100, False),
    "edge: pads on tile boundaries": (2, 8, 2, 512, (256, 384), 8, 100,
                                      False),
    "edge: a q tile of padding": (1, 8, 2, 640, (400,), 8, 100, False),
    "edge: N - W = 440": (2, 8, 2, 448, (448, 300), 8, 100, False),
    "edge: W x W across two tiles": (1, 8, 2, 512, (500,), 200, 100, False),
    "8k": (B, H, HK, N, TRUE_LEN, 8, 2040, True),
    "32k": (1, H, HK, QN, (QTRUE,), 8, 120, True),
}
#: the H2O / chunked-prefill engine runs: name -> (weights, CompressionSpec
#: arguments, size, prefill_chunk)
CHUNK_RUNS = {
    "(a) bf16 h2o 8k": ("bf16", dict(method="h2o"), "8k", None),
    "(b) int4 h2o 32k": ("int4", dict(method="h2o", **QCOMP), "32k", None),
    "(c) bf16 snapkv 8k chunk 2048": ("bf16", dict(method="snapkv"), "8k",
                                      C8K),
    "(d) bf16 h2o 8k chunk 2048": ("bf16", dict(method="h2o"), "8k", C8K),
    "(e) int4 fullkv kivi4-pa 32k chunk 8192": (
        "int4", dict(method="fullkv", quant_method="kivi", nbits=4,
                     q_layout="pa", **QCOMP), "32k", C32K),
    "(f) bf16 fullkv kivi4 8k chunk 2048": (
        "bf16", dict(method="fullkv", quant_method="kivi", nbits=4), "8k",
        C8K),
}
#: kv_cache_bytes of run (e), by hand from init_quant_state's shapes: per
#: layer K and V codes 16,777,216 each, K scale/zero 2 x 8 x 128 x 4 groups
#: x 4 bytes = 32,768, V scale/zero 2,097,152, 128 bf16 decode slots
#: 524,288; times 32 layers (PR 3's monolithic 1,157,890,048 plus 786,432
#: for three more K groups)
KV_BYTES_32K_CHUNKED_PA = 1_158_676_480
#: kv_cache_bytes of bench.py's 32k snapkv (cap 128): 32 layers x 32 heads x
#: 256 slots x 128 x 2 (K, V) x 2 bytes
KV_BYTES_SNAPKV_32K = 134_217_728


#: the two-pass flash schedule's kernels (pass A, pass B)
TWO_PASS_KERNELS = ("flash_row_max", "flash_pass_b")
#: pass A's row maxes against the plain version's: f32 dot products of the
#: same bf16 values summed in other orders (~2^-20 relative)
ROW_MAX_TOL_TEXT = ("m within 2^-12 max(1,|m|) (rows past the pad); rows "
                    "with no visible key exactly float32.min")
#: the 24576-token handle of run (j): three 8192-token chunks of bench.py's
#: prompt; run (i)'s 6144-token prefix: three 2048-token chunks
PREFIX_32K, PREFIX_8K = 3 * C32K, 3 * C8K
#: run (i)'s requests (each starts with the 6144-token prefix)
PREFIX_LENS = (8000, 7600, 7000, 6400)


def _rand_bf16(torch, g, dev, *shape):
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def h2o_pairs(n, true_len, h, w):
    """Visible (row, column) pairs of the H2O statistic: every valid row
    sees every valid column but the causal half of the W x W block."""
    return float(sum(h * (t * t - min(t, w) * (min(t, w) - 1) // 2)
                     for t in true_len))


def h2o_bound(pairs, nbytes, d=D, softcap=None):
    """(least ms, "operations" or "bytes", unit, {unit: ms}) of one H2O
    pass: its QK^T products on the tensor cores (2 d flops a pair), its one
    exp2 a pair on the MUFU (and a tanh under a cap), its bytes."""
    t = {"tensor cores": 2.0 * d * pairs / PEAK_BF16_FLOPS * 1e3,
         ("MUFU exp2" if softcap is None else "MUFU exp2 + tanh"):
             (1.0 if softcap is None else 2.0) * pairs / PEAK_EXP2 * 1e3,
         "bytes": nbytes / PEAK_BYTES * 1e3}
    unit = max(t, key=t.get)
    return t[unit], ("bytes" if unit == "bytes" else "operations"), unit, t


def check_h2o(torch, dev, case, seed, d=D, scale=None, softcap=None,
              q_std=1.0):
    """The two H2O kernels against their plain versions on one H2O_CASES
    (or QWEN_ / GEMMA_H2O_CASES) shape at head dim ``d`` with ``scale`` and
    ``softcap``, q drawn at ``q_std``: the stats kernel's (m, l) against
    ``ops.scoring.h2o_row_stats``, the colsum kernel (fed the kernel's m, l)
    against ``ops.scoring.h2o_colsum`` on the same m, l, and the two
    together (``kernels.h2o_scores``) against the plain score the engine's
    plain path takes (``ops.scoring.h2o_scores``), with the overlap of
    their top-k at the engine's width; each kernel called twice, bitwise
    equal.  Returns (ok, {"stats": rec, "colsum": rec})."""
    from pyramidkv_tpu_torch import kernels
    from pyramidkv_tpu_torch.ops import scoring

    b, h, hk, n, true_len, w, width, timed = {
        **H2O_CASES, **QWEN_H2O_CASES, **GEMMA_H2O_CASES}[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((b, h, n, d), generator=g, device=dev)
         * q_std).to(torch.bfloat16)
    k = _rand_bf16(torch, g, dev, b, hk, n, d)
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
    kw = dict(window_size=w, true_len=tl, scale=scale, softcap=softcap)
    m, l = kernels.h2o_row_stats(q, k, **kw)
    m2, l2 = kernels.h2o_row_stats(q, k, **kw)
    pm, pl = scoring.h2o_row_stats(q, k, **kw)
    cs = kernels.h2o_colsum(q, k, m, l, **kw)
    cs2 = kernels.h2o_colsum(q, k, m, l, **kw)
    pcs = scoring.h2o_colsum(q, k, m, l, **kw)
    got = kernels.h2o_scores(q, k, **kw)
    want = scoring.h2o_scores(q, k, **kw)
    torch.cuda.synchronize()
    rows = (torch.arange(n, device=dev)[None, :]
            >= (n - tl.long())[:, None])[:, None].expand(b, h, n)
    m_ratio = float(((m - pm).abs() / (2.0 ** -12 * pm.abs().clamp_min(1.0))
                     )[rows].max())
    l_ratio = float(((l - pl).abs() / (2.0 ** -10 * pl))[rows].max())

    def score_ratio(x, y, rtol, row_tol):
        fin = torch.isfinite(y)
        if not bool(fin.any()):
            return 0.0, 0.0
        y0, x0 = y.masked_fill(~fin, 0.0), x.masked_fill(~fin, 0.0)
        rms = (y0.square().sum(-1, keepdim=True)
               / fin.sum(-1, keepdim=True).clamp_min(1)).sqrt()
        lim = (rtol * y0.abs() + row_tol * rms).clamp_min(1e-30)
        return (float(((x0 - y0).abs() / lim).max()),
                float((x0 - y0).abs().max()))

    cs_ratio, cs_err = score_ratio(cs, pcs, *COLSUM_TOL)
    sc_ratio, sc_err = score_ratio(got, want, KERNEL_RTOL, KERNEL_ROW_TOL)
    same_inf = torch.equal(torch.isinf(got), torch.isinf(want)) and \
        torch.equal(torch.isinf(cs), torch.isinf(pcs))
    kk = min(width, n - w)
    top_g = torch.topk(got, kk, dim=-1).indices.sort(-1).values
    top_w = torch.topk(want, kk, dim=-1).indices.sort(-1).values
    overlap = float(sum(len(np.intersect1d(a, c)) for a, c in zip(
        top_g.reshape(-1, kk).cpu().numpy(),
        top_w.reshape(-1, kk).cpu().numpy())) / top_g.numel())
    shape = {"case": case, "B": b, "H": h, "Hk": hk, "N": n, "W": w,
             "D": d, "scale": scale, "softcap": softcap,
             "true_len": list(true_len)}
    stats = {"check": "h2o_row_stats", **shape,
             "max_abs_err": float((m - pm).abs()[rows].max()),
             "l_rel_err": float(((l - pl).abs() / pl)[rows].max()),
             "err_over_tol": max(m_ratio, l_ratio), "tol": STATS_TOL_TEXT,
             "bitwise_repeat": bool(torch.equal(m, m2)
                                    and torch.equal(l, l2))}
    colsum = {"check": "h2o_colsum", **shape, "max_abs_err": cs_err,
              "bitwise_repeat": bool(torch.equal(cs, cs2)),
              "err_over_tol": cs_ratio, "tol": COLSUM_TOL_TEXT,
              "scores_max_abs_err": sc_err, "scores_err_over_tol": sc_ratio,
              "scores_tol": H2O_TOL_TEXT,
              "topk_width": kk, "topk_overlap": overlap,
              "rms": float(want[torch.isfinite(want)].square().mean().sqrt())
              if bool(torch.isfinite(want).any()) else 0.0}
    if timed:
        pairs = h2o_pairs(n, true_len, h, w)
        qk_bytes = q.numel() * 2 + k.numel() * 2
        for rec, fn, pfn, extra in (
                (stats, lambda: kernels.h2o_row_stats(q, k, **kw),
                 lambda: scoring.h2o_row_stats(q, k, **kw), 2 * b * h * n * 4),
                (colsum, lambda: kernels.h2o_colsum(q, k, m, l, **kw),
                 lambda: scoring.h2o_colsum(q, k, m, l, **kw),
                 2 * b * h * n * 4 + b * h * (n - w) * 4)):
            rec["ms"] = time_ms(torch, fn, reps=3)
            rec["plain_ms"] = time_ms(torch, pfn, reps=1, warmup=0)
            # no single PyTorch call computes softmax column sums
            rec["library_ms"] = None
            rec["visible_pairs"] = pairs
            (rec["bound_ms"], rec["bound_by"], rec["bound_unit"],
             units) = h2o_bound(pairs, qk_bytes + extra, d, softcap)
            rec["bound_ms_tensor_cores"] = units["tensor cores"]
            rec["bound_ms_mufu"] = [v for u, v in units.items()
                                    if u.startswith("MUFU")][0]
        colsum["plain_scores_ms"] = time_ms(
            torch, lambda: scoring.h2o_scores(q, k, **kw), reps=1, warmup=0)
    log(stats)
    log(colsum)
    ok = (max(m_ratio, l_ratio, cs_ratio, sc_ratio) <= 1 and same_inf
          and tuple(got.shape) == (b, h, n - w) and stats["bitwise_repeat"]
          and colsum["bitwise_repeat"])
    return ok, {"stats": stats, "colsum": colsum}


def h2o_scores_f64(torch, q, k, w, tl, rows=64, scale=None, softcap=None):
    """H2O scores in f64 from the kernels' inputs (q times scale * log2(e),
    or scale alone under a cap, rounded to bf16, as both kernels and the
    plain versions take it; under a cap cap * tanh(s / cap) * log2(e)),
    each row's probabilities divided by its l: the reference the picks are
    counted against.  -> [B, H, N - W] f64, -inf at padding columns."""
    from pyramidkv_tpu_torch.kernels.h2o_scores import scaled_query
    from pyramidkv_tpu_torch.ops import scoring

    b, h, n, d = q.shape
    hk = k.shape[1]
    colv = scoring._column_valid(n, tl)
    acc = torch.zeros((b, h, n - w), dtype=torch.float64, device=q.device)
    kd = k.double().transpose(-1, -2)
    for r0 in range(0, n, rows):
        qs = scaled_query(q[:, :, r0:r0 + rows], scale, softcap).double(
            ).reshape(b, hk, h // hk * rows, d)
        s = torch.matmul(qs, kd).reshape(b, h, rows, n)
        if softcap is not None:
            s = torch.tanh(s / softcap) * (softcap * math.log2(math.e))
        s = s.masked_fill(
            scoring._h2o_hidden(r0, rows, n, w, colv)[:, None], -math.inf)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)  # padding rows: NaN, dropped below
        acc += torch.where(colv[:, None, r0:r0 + rows, None], p,
                           0.0)[..., :n - w].sum(2)
        del s, p
    return acc.masked_fill(~colv[:, None, :n - w], -math.inf)


def h2o_colsum_folded(torch, q, k, m, l, w, tl, rows=512, scale=None,
                      softcap=None):
    """The plain colsum with the kernel's folded exponent: sum over the
    valid rows of exp2(s - (max(m, float32.min / 2) + log2(max(l,
    1e-30)))), f32, instead of exp2(s - m) / l."""
    from pyramidkv_tpu_torch.ops import scoring

    b, h, n, _ = q.shape
    rows = scoring._row_block(rows, b * h * n, n)
    colv = scoring._column_valid(n, tl)
    acc = torch.zeros((b, h, n - w), dtype=torch.float32, device=q.device)
    off = (m.clamp_min(-3.4e38 / 2) + torch.log2(l.clamp_min(1e-30)))
    for r0 in range(0, n, rows):
        s = scoring._h2o_logits2(q, k, r0, rows, scale, softcap)[..., :n - w]
        p = torch.exp2(s - off[..., r0:r0 + rows, None])
        acc += p.masked_fill(~colv[:, None, r0:r0 + rows, None], 0.0).sum(2)
    return acc.masked_fill(~colv[:, None, :n - w], -math.inf)


def count_h2o_picks(torch, dev, case, seeds=8, d=D, scale=None, softcap=None,
                    q_std=1.0):
    """How far the H2O kernels' top-k picks stray from an f64 reference
    (``h2o_scores_f64``) at an engine shape (head dim ``d``, ``scale``,
    ``softcap``, q drawn at ``q_std``), over ``seeds`` random inputs,
    beside two plain f32 versions: one dividing by l (JAX's
    ``_colsum_kernel``, ``ops.scoring.h2o_scores``) and one with the
    kernel's folded exponent (``h2o_colsum_folded``).  For each: the picks
    not in the reference's top-k, and the largest gap of such a pick below
    the reference's k-th score, relative to it (a near-tie is a small
    gap).  Logs one record; returns it."""
    from pyramidkv_tpu_torch import kernels
    from pyramidkv_tpu_torch.ops import scoring

    b, h, hk, n, true_len, w, width, _ = {**H2O_CASES,
                                          **GEMMA_H2O_CASES}[case]
    kk = min(width, n - w)
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
    akw = dict(scale=scale, softcap=softcap)
    kw = dict(window_size=w, true_len=tl, **akw)
    out = {name: {"differing": 0, "max_rel_gap": 0.0}
           for name in ("kernels", "plain_divide", "plain_folded")}
    for seed in range(seeds):
        g = torch.Generator(device=dev).manual_seed(700 + seed)
        q = (torch.randn((b, h, n, d), generator=g, device=dev)
             * q_std).to(torch.bfloat16)
        k = _rand_bf16(torch, g, dev, b, hk, n, d)
        ref = h2o_scores_f64(torch, q, k, w, tl, **akw)
        top_r = torch.topk(ref, kk, dim=-1).values
        kth = top_r[..., -1:]
        pm, pl = scoring.h2o_row_stats(q, k, **kw)
        for name, sc in (
                ("kernels", kernels.h2o_scores(q, k, **kw)),
                ("plain_divide", scoring.h2o_scores(q, k, **kw)),
                ("plain_folded", h2o_colsum_folded(torch, q, k, pm, pl, w,
                                                   tl, **akw))):
            pick = torch.topk(sc, kk, dim=-1).indices
            in_ref = torch.zeros_like(ref, dtype=torch.bool).scatter_(
                -1, torch.topk(ref, kk, dim=-1).indices, True)
            stray = ~torch.gather(in_ref, -1, pick)
            gap = ((kth - torch.gather(ref, -1, pick)) / kth.abs()).float()
            out[name]["differing"] += int(stray.sum())
            if bool(stray.any()):
                out[name]["max_rel_gap"] = max(out[name]["max_rel_gap"],
                                               float(gap[stray].max()))
        del q, k, ref
        torch.cuda.empty_cache()
    rec = {"check": "h2o_topk_picks", "case": case, "seeds": seeds,
           "D": d, "scale": scale, "softcap": softcap,
           "picks": seeds * b * h * kk, "width": kk, **out}
    log(rec)
    return rec


def partials_ratio_exp2(torch, got, want):
    """(err_over_tol, max |acc/l| err, m err, l rel err, dead rows exact) of
    base-2 partials: acc / l within TOL_TEXT, m within 2^-12 max(1, |m|),
    l within 2^-10 l over the rows with a visible key; rows without one
    exactly m = float32.min, l = 0, acc = 0 on both sides."""
    ga, gm, gl = got
    wa, wm, wl = want
    live = wl > 0
    neg = torch.finfo(torch.float32).min
    dead_ok = (torch.equal(live, gl > 0)
               and bool((gm[~live] == neg).all() and (wm[~live] == neg).all())
               and bool((ga[~live] == 0).all()))
    if not bool(live.any()):
        return 0.0, 0.0, 0.0, 0.0, dead_ok
    og = (ga / gl.clamp_min(1e-30)[..., None])[live]
    ow = (wa / wl.clamp_min(1e-30)[..., None])[live]
    m_ratio = float(((gm - wm).abs() / (2.0 ** -12 * wm.abs().clamp_min(1.0))
                     )[live].max())
    l_ratio = float(((gl - wl).abs() / (2.0 ** -10 * wl))[live].max())
    return (max(err_over_tol(og, ow), m_ratio, l_ratio),
            float((og - ow).abs().max()), float((gm - wm)[live].abs().max()),
            float(((gl - wl).abs() / wl)[live].max()), dead_ok)


def masked_sdpa_inputs(torch, q, k, v, true_len, q_start, window=None):
    """SDPA's arguments for the same function (the yardstick): K/V
    repeated to the query heads and the boolean mask (with ``window``,
    also q_start + r - c < window), built outside the timed call."""
    b, h, nq, _ = q.shape
    hk, n = k.shape[1], k.shape[2]
    rows = q_start + torch.arange(nq, device=q.device)
    col = torch.arange(n, device=q.device)
    pad = (n - true_len.long())[:, None, None, None]
    mask = (col[None, None, None, :] <= rows[None, None, :, None]) \
        & (col[None, None, None, :] >= pad)
    if window:
        mask &= rows[None, None, :, None] - col[None, None, None, :] < window
    return (q, k.repeat_interleave(h // hk, dim=1),
            v.repeat_interleave(h // hk, dim=1), mask)


def visible_pairs(true_len, n, nq, q_start, h, window=None):
    """(query, key) pairs the attention reads: key c >= pad = n - t and
    c <= q_start + r (and, with ``window``, c > q_start + r - window),
    summed over rows and heads."""
    tot = 0
    rows = np.arange(q_start, q_start + nq)
    for t in true_len:
        lo = np.full(nq, n - int(t))
        if window:
            lo = np.maximum(lo, rows - window + 1)
        tot += int(np.clip(np.minimum(rows, n - 1) - lo + 1, 0, None).sum())
    return float(h * tot)


def check_flash_chunk(torch, F, dev, b, hk, n, true_len, chunk, i, seed,
                      buf, case=None, timed=True, window=None, h=H,
                      scale=None, softcap=None, q_std=1.0):
    """flash_causal_attention with q_start = i * chunk on chunk i of a
    prefill, its keys read in place from the bucket-long carry ``buf`` (k,
    v [B, Hk, n, D]), against the plain version (with ``window``, both
    windowed; ``scale``, ``softcap``, ``q_std`` as check_flash's); rows
    past the pad; two calls bitwise equal."""
    from pyramidkv_tpu_torch.kernels import flash_causal_attention
    from pyramidkv_tpu_torch.ops.attention import causal_prefill_attention

    d = buf[0].shape[-1]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (_rand_bf16(torch, g, dev, b, h, chunk, d).float()
         * q_std).to(torch.bfloat16)
    e = (i + 1) * chunk
    kh, vh = buf[0][:, :, :e], buf[1][:, :, :e]
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev) - (n - e)
    kw = dict(q_start=i * chunk, sliding_window=window, scale=scale,
              softcap=softcap)
    got = flash_causal_attention(q, kh, vh, tl, **kw)
    again = flash_causal_attention(q, kh, vh, tl, **kw)
    want = causal_prefill_attention(q, kh, vh, true_len=tl, **kw)
    torch.cuda.synchronize()
    ratio = err = 0.0
    for bi, t in enumerate(true_len):
        r0 = max(0, n - t - i * chunk)  # local rows past the pad
        if r0 >= chunk:
            continue
        gb, wb = got[bi, :, r0:], want[bi, :, r0:]
        err = max(err, float((gb.float() - wb.float()).abs().max()))
        ratio = max(ratio, err_over_tol(gb, wb))
    rec = {"check": "flash_causal_attention (q_start)",
           "case": case or f"8k batch chunk {i}", "B": b, "H": h, "Hk": hk,
           "N": e, "Nq": chunk, "q_start": i * chunk, "ldk": n,
           "window": window, "D": d, "scale": scale, "softcap": softcap,
           "true_len": list(true_len), "max_abs_err": err,
           "err_over_tol": ratio, "tol": TOL_TEXT,
           "bitwise_repeat": bool(torch.equal(got, again))}
    del again
    ok = (ratio <= 1 and bool(torch.isfinite(got).all())
          and rec["bitwise_repeat"])
    if not timed:
        log(rec)
        return ok, rec
    rec["ms"] = time_ms(torch, lambda: flash_causal_attention(
        q, kh, vh, tl, **kw), reps=5)
    rec["plain_ms"] = time_ms(torch, lambda: causal_prefill_attention(
        q, kh, vh, true_len=tl, **kw), reps=1, warmup=0)
    lib = masked_sdpa_inputs(torch, q, kh, vh, tl, i * chunk, window)
    rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        *lib[:3], attn_mask=lib[3], scale=scale), reps=3)
    if softcap is not None:
        rec["library_note"] = UNCAPPED_NOTE
    del lib
    pairs = visible_pairs(true_len, n, chunk, i * chunk, h, window)
    nbytes = (q.numel() * 2 * 2 + 2 * b * hk * e * d * 2 + b * 4)
    rec["visible_pairs"] = pairs
    rec["bound_ms"], rec["bound_by"], units = attn_bound(pairs, d, nbytes,
                                                         softcap)
    if softcap is not None:
        rec["bound_units_ms"] = units
    log(rec)
    return ok, rec


def check_partials(torch, F, dev, case, b, hk, c, tile_len, q_start, seed,
                   timed=True, window=None, h=H, d=D, scale=None,
                   softcap=None, q_std=1.0):
    """flash_attention_partials on one tile of a quantized-carry chunk:
    ``q_start == 0`` the causal self tile, ``q_start >= c`` a history tile
    q_start rows before its queries (every key visible, or with ``window``
    those within it: rows past it have none); ``tile_len`` [B] the tile's
    valid keys; two calls bitwise equal.  ``d``, ``scale``, ``softcap``,
    ``q_std`` as check_flash's."""
    from pyramidkv_tpu_torch.kernels import flash_attention_partials
    from pyramidkv_tpu_torch.ops.attention import flash_partials_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (_rand_bf16(torch, g, dev, b, n_h, c, d)
               for n_h in (h, hk, hk))
    q = (q.float() * q_std).to(torch.bfloat16)
    tl = torch.tensor(tile_len, dtype=torch.int32, device=dev)
    kw = dict(q_start=q_start, sliding_window=window, scale=scale,
              softcap=softcap)
    got = flash_attention_partials(q, k, v, tl, **kw)
    again = flash_attention_partials(q, k, v, tl, **kw)
    want = flash_partials_plain(q, k, v, tl, **kw)
    torch.cuda.synchronize()
    ratio, err, m_err, l_err, dead_ok = partials_ratio_exp2(torch, got, want)
    rec = {"check": "flash_attention_partials", "case": case, "B": b,
           "H": h, "Hk": hk, "C": c, "q_start": q_start, "window": window,
           "D": d, "scale": scale, "softcap": softcap,
           "tile_len": list(tile_len), "max_abs_err": err, "m_err": m_err,
           "l_rel_err": l_err, "err_over_tol": ratio,
           "dead_rows": int((want[2] == 0).sum()), "dead_rows_exact": dead_ok,
           "tol": SPARSE_TOL_TEXT + "; rows with no visible key exact",
           "bitwise_repeat": all(torch.equal(x, y)
                                 for x, y in zip(got, again))}
    del again
    ok = (ratio <= 1 and dead_ok and rec["bitwise_repeat"]
          and all(bool(torch.isfinite(x).all()) for x in got))
    if not timed:
        log(rec)
        return ok, rec
    rec["ms"] = time_ms(torch, lambda: flash_attention_partials(
        q, k, v, tl, **kw), reps=5)
    rec["plain_ms"] = time_ms(torch, lambda: flash_partials_plain(
        q, k, v, tl, **kw), reps=1, warmup=0)
    lib = masked_sdpa_inputs(torch, q, k, v, tl, q_start, window)
    rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        *lib[:3], attn_mask=lib[3], scale=scale), reps=3)
    if softcap is not None:
        rec["library_note"] = UNCAPPED_NOTE
    del lib
    pairs = visible_pairs(tile_len, c, c, q_start, h, window)
    nbytes = (q.numel() * 2 + 2 * k.numel() * 2 + b * h * c * (d + 2) * 4)
    rec["visible_pairs"] = pairs
    rec["bound_ms"], rec["bound_by"], units = attn_bound(pairs, d, nbytes,
                                                         softcap)
    if softcap is not None:
        rec["bound_units_ms"] = units
    log(rec)
    return ok, rec


def tile_len(true_len, n, c, start):
    """Valid keys of the c-key tile at column ``start`` of a bucket of n."""
    return tuple(c - min(max(n - t - start, 0), c) for t in true_len)


def phase_h2o_chunk_kernels(torch, F, dev):
    """The new kernels against their plain versions at the engine's shapes:
    H2O (H2O_CASES), flash with q_start at every chunk of the 8k batch
    (C=2048, keys read in place from the carry), flash_attention_partials
    on self and history tiles of the 32k carry (C=8192) and the 8k batch
    (C=2048: a pad crossing the tiles, rows with no visible key), and the
    pa region kernel with one K group per chunk at run (e)'s shape.
    Returns (ok, {kernel: [timed recs]})."""
    ok = True
    recs = {"h2o_row_stats": [], "h2o_colsum": [], "q_start": [],
            "flash_attention_partials": [], "pa_chunked": []}
    for seed, case in enumerate(H2O_CASES, start=500):
        r, got = check_h2o(torch, dev, case, seed)
        ok &= r
        if H2O_CASES[case][-1]:
            recs["h2o_row_stats"].append(got["stats"])
            recs["h2o_colsum"].append(got["colsum"])
        torch.cuda.empty_cache()
    # the top-k picks against an f64 reference, over 8 seeds (a measure,
    # not a gate: near-ties break either way in any f32 summation order)
    for case in ("8k", "32k"):
        count_h2o_picks(torch, dev, case)
    # short shapes first: the one-pass kernel at q_start on a carry longer
    # than the chunk's keys (ldk > N; a last q tile of 64 rows; N % 128 =
    # 64), partials on a self and a history tile of N = 192 with a pad
    # inside the second key tile; untimed
    g = torch.Generator(device=dev).manual_seed(509)
    buf = (_rand_bf16(torch, g, dev, 2, HK, 512, D),
           _rand_bf16(torch, g, dev, 2, HK, 512, D))
    for seed, (chunk, i) in enumerate(((192, 1), (64, 4)), start=511):
        r, _ = check_flash_chunk(torch, F, dev, 2, HK, 512, (512, 300), chunk,
                                 i, seed, buf, case=f"short chunk {chunk} "
                                 f"at {i * chunk}, ldk 512", timed=False)
        ok &= r
    for seed, (case, hk, q_start) in enumerate((
            ("short self tile N=192", HK, 0),
            ("short history tile N=192", H, 192)), start=515):
        r, _ = check_partials(torch, F, dev, case, 2, hk, 192, (192, 50),
                              q_start, seed, timed=False)
        ok &= r
    g = torch.Generator(device=dev).manual_seed(510)
    buf = (_rand_bf16(torch, g, dev, B, HK, N, D),
           _rand_bf16(torch, g, dev, B, HK, N, D))
    for i in range(N // C8K):
        r, rec = check_flash_chunk(torch, F, dev, B, HK, N, TRUE_LEN, C8K, i,
                                   520 + i, buf)
        ok &= r
        recs["q_start"].append(rec)
    del buf
    torch.cuda.empty_cache()
    for seed, (case, b, n, tls, c, start, q_start) in enumerate((
            ("32k self tile (chunk 0)", 1, QN, (QTRUE,), C32K, 0, 0),
            ("32k history tile 0", 1, QN, (QTRUE,), C32K, 0, C32K),
            ("8k self tile (chunk 2)", B, N, TRUE_LEN, C8K, 2 * C8K, 0),
            ("8k history tile 1", B, N, TRUE_LEN, C8K, C8K, C8K)), start=530):
        r, rec = check_partials(torch, F, dev, case, b, HK, c,
                                tile_len(tls, n, c, start), q_start, seed)
        ok &= r
        recs["flash_attention_partials"].append(rec)
        torch.cuda.empty_cache()
    # run (e)'s region: 32768 slots, kivi4-pa, K groups of 8192 (4)
    r, rec = check_region(torch, F, dev, "quant_fused_attention_pa", 1, HK,
                          H // HK, QN, 4, 64, True, 540,
                          "32k fullkv kivi4-pa chunk 8192", QMAX_NEW,
                          k_chunk=C32K)
    ok &= r and rec["k_groups"] == QN // C32K
    recs["pa_chunked"].append(rec)
    torch.cuda.empty_cache()
    return ok, recs


def check_two_pass(torch, F, dev, case, b, hk, n, true_len, seed,
                   q_start=0, window=None, timed=True, h=H, d=D, scale=None,
                   softcap=None, q_std=1.0):
    """The two-pass schedule's kernels against their plain versions on one
    shape (queries at global rows [q_start, n) of n keys, a sliding
    ``window`` if given): pass A's row maxes (called twice: bitwise equal);
    pass B fed the plain row maxes (checked alone, and called twice:
    bitwise equal); the composed ``flash_causal_attention(two_pass=True)``
    against the plain composition.  Rows past the pad within their limits,
    rows with no visible key exact (m = float32.min, output 0; pass B's
    err_over_tol is infinite otherwise).  ``timed``: timed beside the
    one-pass kernel and masked SDPA.  ``d``, ``scale``, ``softcap``,
    ``q_std`` as check_flash's.  Returns (ok, {kernel: rec})."""
    from pyramidkv_tpu_torch.kernels import (flash_causal_attention,
                                             flash_pass_b, flash_row_max)
    from pyramidkv_tpu_torch.ops.attention import (flash_pass_b_plain,
                                                   flash_row_max_plain)

    nq = n - q_start
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (_rand_bf16(torch, g, dev, b, h, nq, d).float()
         * q_std).to(torch.bfloat16)
    k, v = (_rand_bf16(torch, g, dev, b, hk, n, d) for _ in range(2))
    tl = torch.tensor(true_len, dtype=torch.int32, device=dev)
    kw = dict(q_start=q_start, sliding_window=window, scale=scale,
              softcap=softcap)
    m_got = flash_row_max(q, k, tl, **kw)
    m_again = flash_row_max(q, k, tl, **kw)
    m_want = flash_row_max_plain(q, k, tl, **kw)
    out_got = flash_pass_b(q, k, v, m_want, tl, **kw)
    again = flash_pass_b(q, k, v, m_want, tl, **kw)
    out_want = flash_pass_b_plain(q, k, v, m_want, tl, **kw)
    both = flash_causal_attention(q, k, v, tl, two_pass=True, **kw)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(out_got, again))
    repeat_a = bool(torch.equal(m_got, m_again))
    neg = torch.finfo(torch.float32).min
    m_ratio = out_ratio = both_ratio = m_err = out_err = 0.0
    dead_a = dead_b = True
    for bi, t in enumerate(true_len):
        dead = max(0, min(nq, n - t - q_start))  # local rows before the pad
        gm, wm = m_got[bi, :, dead:], m_want[bi, :, dead:]
        m_err = max(m_err, float((gm - wm).abs().max()))
        m_ratio = max(m_ratio, float(((gm - wm).abs() / (
            2.0 ** -12 * wm.abs().clamp_min(1.0))).max()))
        out_err = max(out_err, float((out_got[bi, :, dead:].float()
                                      - out_want[bi, :, dead:].float()
                                      ).abs().max()))
        out_ratio = max(out_ratio, err_over_tol(out_got[bi, :, dead:],
                                                out_want[bi, :, dead:]))
        both_ratio = max(both_ratio, err_over_tol(both[bi, :, dead:],
                                                  out_want[bi, :, dead:]))
        dead_a &= bool((m_got[bi, :, :dead] == neg).all()
                       and (m_want[bi, :, :dead] == neg).all())
        dead_b &= bool((out_got[bi, :, :dead] == 0).all()
                       and (both[bi, :, :dead] == 0).all())
    base = {"case": case, "B": b, "H": h, "Hk": hk, "G": h // hk, "N": n,
            "Nq": nq, "q_start": q_start, "window": window, "D": d,
            "scale": scale, "softcap": softcap,
            "true_len": list(true_len), "dead_rows_exact": dead_a and dead_b,
            "layers": LAYERS}
    ra = dict(base, check="flash_row_max", max_abs_err=m_err,
              err_over_tol=m_ratio if dead_a else math.inf,
              tol=ROW_MAX_TOL_TEXT, repeat_bitwise=repeat_a, library_ms=None,
              library_note="none: no single PyTorch call computes the "
                           "masked row maxes of Q K^T")
    rb = dict(base, check="flash_pass_b", max_abs_err=out_err,
              err_over_tol=(max(out_ratio, both_ratio) if dead_b
                            else math.inf),
              composed_err_over_tol=both_ratio, repeat_bitwise=repeat,
              tol=TOL_TEXT + "; rows with no visible key exactly 0")
    if timed:
        pairs = visible_pairs(true_len, n, nq, q_start, h, window)
        qb, kb = q.numel() * 2, k.numel() * 2
        mb, ob = b * h * nq * 4, q.numel() * 2
        # one-pass kernel and masked SDPA: the same function in one call
        one_ms = time_ms(torch, lambda: flash_causal_attention(
            q, k, v, tl, **kw), reps=5)
        lib = masked_sdpa_inputs(torch, q, k, v, tl, q_start, window)
        sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            *lib[:3], attn_mask=lib[3], scale=scale), reps=3)
        del lib
        for rec in (ra, rb):
            rec.update(visible_pairs=pairs, one_pass_ms=one_ms,
                       sdpa_ms=sdpa_ms, schedule_bound_ms=attn_bound(
                           pairs, d, qb + 2 * kb + mb + ob, softcap,
                           6.0 * d)[0])
        ra["ms"] = time_ms(torch, lambda: flash_row_max(q, k, tl, **kw),
                           reps=5)
        ra["plain_ms"] = time_ms(torch, lambda: flash_row_max_plain(
            q, k, tl, **kw), reps=1, warmup=0)
        # pass A caps each row's raw max once: no per-pair MUFU work
        ra["bound_ms"], ra["bound_by"] = bound(2.0 * d * pairs,
                                               qb + kb + mb)
        rb["library_ms"] = sdpa_ms
        if softcap is not None:
            rb["library_note"] = UNCAPPED_NOTE
        rb["ms"] = time_ms(torch, lambda: flash_pass_b(
            q, k, v, m_want, tl, **kw), reps=5)
        rb["pass_b_over_one_pass"] = rb["ms"] / one_ms
        rb["plain_ms"] = time_ms(torch, lambda: flash_pass_b_plain(
            q, k, v, m_want, tl, **kw), reps=1, warmup=0)
        rb["bound_ms"], rb["bound_by"], _ = attn_bound(
            pairs, d, qb + 2 * kb + mb + ob, softcap)
    log(ra)
    log(rb)
    ok = (m_ratio <= 1 and out_ratio <= 1 and both_ratio <= 1 and dead_a
          and dead_b and repeat and repeat_a
          and bool(torch.isfinite(out_got).all()))
    return ok, {"flash_row_max": ra, "flash_pass_b": rb}


def phase_two_pass_kernels(torch, F, dev):
    """The two-pass schedule's kernels on short ragged shapes (N = 192, a
    row shorter than a tile, rows that are all padding, G = 8, 1 and 8; a
    prefill chunk at q_start), on edge shapes of pass A's unit plan (a
    sliding window, with G = 8 and with a q tile all padding at G = 1; a
    chunk at q_start with N % 128 = 64, Nq cut short of a 128-row q tile
    and rows before the pad), untimed, and at the engine runs' shapes:
    the 8k batch (run (g)) and bench.py's 32k prompt (run (h)).  Returns
    (ok, {kernel: [timed recs]})."""
    ok = True
    recs = {k: [] for k in TWO_PASS_KERNELS}
    for seed, (case, b, hk, n, tls, q_start, window) in enumerate((
            ("short ragged", 2, 4, 512, (512, 37), 0, None),
            ("short N=192", 2, 32, 192, (192, 70), 0, None),
            ("short q_start", 2, 4, 448, (448, 300), 256, None),
            ("edge: window 256, G=8", 2, 4, 1024, (1024, 700), 0, 256),
            ("edge: window 64, a q tile all padding, G=1", 1, 32, 448,
             (100,), 0, 64),
            ("edge: q_start 512, Nq=192, N=704, G=1", 2, 32, 704, (704, 150),
             512, None),
            ("8k", B, HK, N, TRUE_LEN, 0, None),
            ("32k", 1, HK, QN, (QTRUE,), 0, None)), start=560):
        timed = case in ("8k", "32k")
        r, got = check_two_pass(torch, F, dev, case, b, hk, n, tls, seed,
                                q_start, window, timed)
        ok &= r
        if timed:
            for k in TWO_PASS_KERNELS:
                recs[k].append(got[k])
        torch.cuda.empty_cache()
    return ok, recs


def chunk_run_spec(run):
    """(CompressionSpec, bucket, max_new, chunk) of a CHUNK_RUNS,
    MISTRAL_RUNS, QWEN_RUNS or GEMMA_RUNS run."""
    from pyramidkv_tpu_torch.config import CompressionSpec

    _, comp, size, chunk, *_ = {**CHUNK_RUNS, **MISTRAL_RUNS, **QWEN_RUNS,
                                **GEMMA_RUNS}[run]
    bucket, max_new = (QN, QMAX_NEW) if size == "32k" else (N, MAX_NEW)
    return CompressionSpec(**comp), bucket, max_new, chunk


def run_engine_kw(run) -> tuple:
    """(EngineSpec arguments, environment) of a MODELS run: the fifth field
    of its entry, if any (``env``: variables set for the run alone)."""
    entry = {**CHUNK_RUNS, **MISTRAL_RUNS, **QWEN_RUNS, **GEMMA_RUNS}[run]
    kw = dict(entry[4]) if len(entry) > 4 else {}
    return kw, kw.pop("env", {})


def chunk_expected(run, plan, qp, steps, b, window=None, layers=LAYERS,
                   h=H, hk=HK, full_layers=None, layer_windows=None, d=D):
    """Kernel launches one generate of a CHUNK_RUNS, MISTRAL_RUNS, QWEN_RUNS
    or GEMMA_RUNS run implies (``layers`` layers of ``h`` query and ``hk``
    KV heads of dim ``d``).  With a sliding ``window`` (or each layer's own,
    ``layer_windows``: Gemma-2's full layers none) the quantized carry
    skips each history tile wholly outside the window of its chunk's first
    row.  ``full_layers``: the layers without a window of alternating ones
    (Gemma-2): MInference's sparse path runs there, the dense flash on the
    sliding ones.  ThinK's narrow decode launches no decode kernel.  A
    KIVI run's region calls take the route of its engine arguments (the
    f32 one for ``use_quant_kernel`` / ``use_quant_tiled``)."""
    import torch

    from pyramidkv_tpu_torch.models import chunked_prefill as cp
    from pyramidkv_tpu_torch.models.llama import region_route

    cs, bucket, _, chunk = chunk_run_spec(run)
    want = dict.fromkeys(_kernels(), 0)
    nc = bucket // chunk if chunk else 1
    quant_carry = bool(chunk) and cp.supports_chunked_quant(plan, chunk)
    h2o = cs.method == "h2o"
    if cs.method == "minference" and bucket >= cs.minference_dense_below:
        sparse = layers if full_layers is None else full_layers
        want["vertical_attention_partials"] = sparse
        want["slash_tile_attention"] = sparse
        want["flash_causal_attention"] = layers - sparse
    elif quant_carry:
        wins = [window] * layers if layer_windows is None else layer_windows
        hist = sum(1 for w in wins for j in range(nc) for hc in range(j)
                   if w is None or (j - hc - 1) * chunk + 1 < w)
        want["flash_attention_partials"] = layers * nc + hist
    else:
        want["flash_causal_attention"] = layers * nc * (2 if h2o and chunk
                                                        else 1)
    if h2o and not chunk:
        want["h2o_row_stats"] = want["h2o_colsum"] = layers
    if cs.quant_method is None:
        want["decode_attention"] = 0 if plan.think_narrow else layers * steps
    else:
        hm = hk if cs.method == "fullkv" else h
        per = 8 // cs.nbits
        unit = cs.q_group_size * per
        s_pad = -(-plan.prefill_slots // unit) * unit
        ekw = run_engine_kw(run)[0]
        f32 = bool(ekw.get("use_quant_kernel") or ekw.get("use_quant_tiled"))
        want[region_route(cs, b * hm, s_pad // per, torch.device("cuda", 0),
                          f32, d).__name__] = layers * steps
    if qp is not None:
        want.update(expected_launches(qp, steps, b, chunk or bucket, nc,
                                      layers))
    return want


def chunk_kv_bytes(run, b, layers=LAYERS, hk=HK, d=D):
    """kv_cache_bytes of a chunked fullkv KIVI run, from
    ``chunked_prefill.init_quant_state``'s shapes (K groups of the chunk
    under pa, of 64 slots under group; V per token under pa) plus the bf16
    decode slots, ``layers`` layers of ``hk`` KV heads of dim ``d``."""
    cs, n, max_new, chunk = chunk_run_spec(run)
    per = 8 // cs.nbits
    kg, vg = (chunk, d) if cs.q_layout == "pa" else (64, 64)
    return layers * (2 * b * hk * (n // per) * d
                     + 2 * b * hk * d * (n // kg) * 4
                     + 2 * b * hk * n * (d // vg) * 4
                     + 2 * b * hk * max_new * d * 2)


def bucket_tokens(torch, dev, prompts, bucket):
    toks = np.zeros((len(prompts), bucket), np.int64)
    for i, p in enumerate(prompts):
        toks[i, bucket - len(p):] = p
    return (torch.from_numpy(toks).to(dev),
            torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                         device=dev))


def prefill_with(eng, bucket, tokens, tl, impl):
    """The prefill ``generate`` takes (chunked where the engine supports
    it), through the kernels or the plain path: (logits, cache)."""
    from pyramidkv_tpu_torch.models import llama

    eng.attention_impl = impl
    try:
        if eng.chunked_prefill_supported(bucket):
            return eng._run_chunked_prefill(bucket, tokens, tl)
        return llama.prefill(
            eng.params, eng.model_spec, eng.plan_for(bucket), tokens, tl,
            attention_impl=impl,
            prefill_two_pass=eng.engine_spec.prefill_two_pass)
    finally:
        eng.attention_impl = "kernel"


def phase_engine_h2o_chunked(torch, dev, params, q4, vocab):
    """``Engine.generate`` for each CHUNK_RUNS run (32 layers), with the
    launches of every kernel held to what the plan implies and
    kv_cache_bytes to the layout's.  For the chunked runs the chunked
    prefill's first-token logits and the run's tokens are printed beside
    the monolithic run's of the same configuration (information only: on
    the card cuBLAS may sum [C, .] and [N, .] rows in other orders).
    Returns (ok, {run: counts}, {run: prefill s})."""
    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.models import llama

    spec = ModelSpec.preset("llama3-8b")
    p32 = [np.random.default_rng(0).integers(0, vocab, size=QTRUE).tolist()]
    rng = np.random.default_rng(0)
    p8 = [rng.integers(0, vocab, size=t).tolist() for t in TRUE_LEN]
    ok, counts, prefill_s = True, {}, {}
    for run, (wname, _, size, _) in CHUNK_RUNS.items():
        cs, bucket, max_new, chunk = chunk_run_spec(run)
        prompts = p32 if size == "32k" else p8
        qp = q4 if wname == "int4" else None
        wts = qp if qp is not None else params
        eng = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                          prefill_buckets=(bucket,),
                                          prefill_chunk=chunk),
                     wts, device=dev)
        # every kernel and cuBLAS shape already ran in earlier phases: no
        # warm-up generate
        torch.cuda.synchronize()
        reset_counts()
        out = eng.generate(prompts, max_new_tokens=gen_new(max_new))
        c = read_counts()
        counts[run] = c
        prefill_s[run] = out.prefill_seconds
        plan = eng.plan_for(bucket)
        want = chunk_expected(run, plan, qp, out.decode_steps, len(prompts))
        want_bytes = (chunk_kv_bytes(run, len(prompts))
                      if cs.quant_method else None)
        toks = [t for seq in out.tokens for t in seq]
        good = (c == want and out.decode_steps == gen_new(max_new) - 1
                and eng.chunked_prefill_supported(bucket) == bool(chunk)
                and all(0 <= t < vocab for t in toks)
                and all(len(seq) >= 1 for seq in out.tokens))
        if want_bytes is not None:
            good &= out.kv_cache_bytes == want_bytes
        if run.startswith("(e)"):
            good &= out.kv_cache_bytes == KV_BYTES_32K_CHUNKED_PA
        if run.startswith("(b)"):
            good &= out.kv_cache_bytes == KV_BYTES_SNAPKV_32K
        rec = {"phase": "engine_h2o_chunked", "run": run, "weights": wname,
               "method": cs.method, "prefill_chunk": chunk,
               "prefill_s": out.prefill_seconds,
               "decode_s": out.decode_seconds,
               "decode_steps": out.decode_steps,
               "decode_tok_per_s": (out.decode_steps * len(prompts)
                                    / out.decode_seconds),
               "kv_cache_bytes": out.kv_cache_bytes,
               "expected_kv_cache_bytes": want_bytes,
               "launches": {k: v for k, v in c.items() if v},
               "expected_launches": {k: v for k, v in want.items() if v},
               "first_tokens": out.tokens[0][:8]}
        if chunk:
            # information: the monolithic run of the same configuration
            tokens, tl = bucket_tokens(torch, dev, prompts, bucket)
            with torch.inference_mode():
                lc, _ = prefill_with(eng, bucket, tokens, tl, "kernel")
                lm, _ = llama.prefill(wts, spec, plan, tokens, tl)
            mono = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                               prefill_buckets=(bucket,)),
                          wts, device=dev).generate(prompts)
            same = [sum(a == b_ for a, b_ in zip(x, y)) for x, y in
                    zip(out.tokens, mono.tokens)]
            rec["vs_monolithic"] = {
                "first_logits_max_abs_diff": float((lc - lm).abs().max()),
                "largest_logit": float(lm.abs().max()),
                "same_first_token": bool((lc.argmax(-1)
                                          == lm.argmax(-1)).all()),
                "tokens_equal_per_request": same,
                "tokens_per_request": [len(t) for t in out.tokens],
                "monolithic_prefill_s": mono.prefill_seconds,
                "monolithic_first_tokens": mono.tokens[0][:8]}
            del lc, lm, mono
        rec["ok"] = good
        log(rec)
        ok &= good
        del eng, out
        torch.cuda.empty_cache()
    return ok, counts, prefill_s


def phase_parity_h2o_chunked(torch, dev, params, vocab, steps=4):
    """Depth-2 logits, kernels against plain, for h2o on the 8k batch
    (monolithic), chunked snapkv on the 8k batch and chunked fullkv
    kivi4-pa at 32k (int4 weights): the last-position logits of each
    path's prefill, then ``steps`` decode steps of each path on its own
    copy of the kernel path's cache, fed the same tokens (as
    phase_parity_kv_quant).  Limit: 2^-5 of the largest logit, as
    phase_parity.  Printed beside it: the share of cache slots whose
    positions the plain path's own prefill kept alike (the two paths'
    H2O scores differ by bf16 noise, which flips near-ties at the top-k
    boundary)."""
    from pyramidkv_tpu_torch.cache import KVCache
    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.models import llama

    spec = ModelSpec.preset("llama3-8b", num_hidden_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    ok = True
    for run in ("(a) bf16 h2o 8k", "(c) bf16 snapkv 8k chunk 2048",
                "(e) int4 fullkv kivi4-pa 32k chunk 8192"):
        wname, _, size, _ = CHUNK_RUNS[run]
        cs, bucket, max_new, chunk = chunk_run_spec(run)
        wts = quantized(p2, "int4") if wname == "int4" else p2
        eng = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                          prefill_buckets=(bucket,),
                                          prefill_chunk=chunk),
                     wts, device=dev)
        rng = np.random.default_rng(1)
        b, tls = (1, (QTRUE,)) if size == "32k" else (B, TRUE_LEN)
        tokens = torch.from_numpy(
            rng.integers(0, vocab, size=(b, bucket)).astype(np.int64)).to(dev)
        tl = torch.tensor(tls, dtype=torch.int32, device=dev)
        plan = eng.plan_for(bucket)
        with torch.inference_mode():
            lk, ck = prefill_with(eng, bucket, tokens, tl, "kernel")
            lp, cp_ = prefill_with(eng, bucket, tokens, tl, "plain")
            prefill_err = float((lk - lp).abs().max())
            same_slots = float((ck.positions == cp_.positions).float().mean())
            err, top = prefill_err, float(lp.abs().max())
            same = bool((lk.argmax(-1) == lp.argmax(-1)).all())
            cp_ = KVCache(k=ck.k.clone(), v=ck.v.clone(),
                          mask=ck.mask.clone(),
                          positions=ck.positions.clone(),
                          true_len=ck.true_len, quant=ck.quant)
            tok = lp.argmax(-1)
            for _ in range(steps):
                lk, ck = llama.decode_step(wts, spec, plan, ck, tok,
                                           attention_impl="kernel")
                lp, cp_ = llama.decode_step(wts, spec, plan, cp_, tok,
                                            attention_impl="plain")
                err = max(err, float((lk - lp).abs().max()))
                top = max(top, float(lp.abs().max()))
                same &= bool((lk.argmax(-1) == lp.argmax(-1)).all())
                ok &= bool(torch.isfinite(lk).all())
                tok = lp.argmax(-1)
        torch.cuda.synchronize()
        tol = 2.0 ** -5 * top
        good = err <= tol
        log({"phase": "parity_h2o_chunked", "run": run, "depth": 2,
             "decode_steps": steps, "prefill_max_abs_err": prefill_err,
             "max_abs_err": err, "tol": tol, "same_argmax": same,
             "plain_prefill_same_slot_share": same_slots, "ok": good})
        ok &= good
        del eng, ck, cp_, wts
        torch.cuda.empty_cache()
    return ok


def phase_profile_h2o_chunked(torch, dev, params, q4, vocab):
    """Where the time goes in three prefills: run (b)'s monolithic H2O at
    32k, run (d)'s chunked H2O on the 8k batch and run (e)'s chunked
    kivi4-pa at 32k.  CUDA events recorded around each stage give its
    stream time (its device time while the device runs without gaps);
    "rest" is the prefill's stream time less the stages.  Wall times from
    unpatched runs."""
    import importlib

    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.models import chunked_prefill as cp
    from pyramidkv_tpu_torch.models import llama

    h2o_mod = importlib.import_module("pyramidkv_tpu_torch.kernels.h2o_scores")
    spec = ModelSpec.preset("llama3-8b")
    spans = {}

    def timed(label, fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = fn(*a, **kw)
            e1.record()
            spans.setdefault(label, []).append((e0, e1))
            return res
        # a kernel wrapper counts its launches on the name it is called
        # by, which the patch rebinds to this function
        run.launches = getattr(fn, "launches", 0)
        return run

    stages = {
        # kernels.h2o_scores launches both kernels through _stats and
        # _colsum (the query scaled once for both)
        "(b) int4 h2o 32k": [(h2o_mod, "_stats", "h2o stats kernel"),
                             (h2o_mod, "_colsum", "h2o colsum kernel"),
                             (llama, "flash_causal_attention",
                              "flash kernel")],
        "(d) bf16 h2o 8k chunk 2048": [
            (cp, "flash_causal_attention", "flash kernel (q_start)"),
            (cp, "h2o_partial_scores", "h2o pass-2 scores (plain torch)"),
            (cp, "prefill_finish", "finish (compression)")],
        "(e) int4 fullkv kivi4-pa 32k chunk 8192": [
            (cp, "flash_attention_partials", "partials kernel"),
            (cp, "_history_tile", "history tile dequantization"),
            (cp, "merge_exp2", "merge"),
            (cp, "quantize", "chunk quantization"),
            (cp, "prefill_finish_quant", "finish (repack)")],
    }
    out, ok = {}, True
    with torch.inference_mode():
        for run, patches in stages.items():
            wname, _, size, _ = CHUNK_RUNS[run]
            cs, bucket, max_new, chunk = chunk_run_spec(run)
            eng = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                              prefill_buckets=(bucket,),
                                              prefill_chunk=chunk),
                         q4 if wname == "int4" else params, device=dev)
            rng = np.random.default_rng(2)
            b, tls = (1, (QTRUE,)) if size == "32k" else (B, TRUE_LEN)
            tokens = torch.from_numpy(rng.integers(
                0, vocab, size=(b, bucket)).astype(np.int64)).to(dev)
            tl = torch.tensor(tls, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill_with(eng, bucket, tokens, tl, "kernel")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
            spans.clear()
            try:
                for m, a, label in patches:
                    setattr(m, a, timed(label, getattr(m, a)))
                timed("prefill", prefill_with)(eng, bucket, tokens, tl,
                                               "kernel")
                torch.cuda.synchronize()
            finally:
                for m, a, fn in saved:
                    setattr(m, a, fn)
            ms = {k: sum(e0.elapsed_time(e1) for e0, e1 in v)
                  for k, v in spans.items()}
            stream_ms = ms.pop("prefill")
            # the finish contains the compression's own h2o kernels (none
            # in these runs) and the lm_head: it is one stage
            out[run] = {"wall_s": wall, "stream_ms": stream_ms,
                        "stages_ms": ms,
                        "rest_ms": stream_ms - sum(ms.values()),
                        "stage_calls": {k: len(v) for k, v in spans.items()
                                        if k != "prefill"}}
            # every stage ran (a patch the prefill never calls would time
            # nothing)
            ok &= all(spans.get(label) for _, _, label in patches)
            del eng
            torch.cuda.empty_cache()
    log({"phase": "profile_h2o_chunked", **out})
    return ok


def _timed(torch, fn, *a, **kw):
    """(result, host seconds) of a call ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*a, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _logits_close(torch, got, want) -> dict:
    """First-token logits held to their twin's: within 2^-5 of the largest
    (as the parity phases); the same argmax and bit equality reported."""
    diff = float((got - want).abs().max())
    top = float(want.abs().max())
    return {"first_logits_max_abs_diff": diff, "largest_logit": top,
            "tol": 2.0 ** -5 * top, "ok": diff <= 2.0 ** -5 * top,
            "same_first_token": bool((got.argmax(-1)
                                      == want.argmax(-1)).all()),
            "bitwise_equal": torch.equal(got, want)}


def aligned_carry(eng, handle, tokens, tl, k0) -> dict:
    """The carry resumed from ``handle`` against the no-handle run's over
    chunks [0, k0) of a prompt whose pad is a multiple of the chunk:
    differing elements and the largest relative difference per leaf."""
    import torch

    from pyramidkv_tpu_torch.models import chunked_prefill as cp

    c, n = eng.engine_spec.prefill_chunk, tokens.shape[1]
    plan = eng.plan_for(n)
    with torch.inference_mode():
        res = eng._apply_prefix(n, 1, handle, [int(tl[0])])[0]
        st = cp.init_quant_state(eng.model_spec, plan, 1, c, eng.device)
        for i in range(k0):
            cp.prefill_chunk_quant(eng.params, eng.model_spec, plan, st,
                                   tokens[:, i * c:(i + 1) * c], tl, i * c)
    out, ok = {}, True
    for name in cp.QuantChunkState._fields:
        a, b = getattr(res, name), getattr(st, name)
        axis = 4 if name in ("k_scale", "k_zero") else 3
        a, b = (x.narrow(axis, 0, x.shape[axis] * k0 // (n // c))
                for x in (a, b))
        rel = float(((a.float() - b.float()).abs()
                     / b.float().abs().clamp_min(1e-30)).max())
        out[name] = {"differing": int((a != b).sum()), "of": a.numel(),
                     "max_rel_diff": rel}
        ok &= (rel <= 2.0 ** -22 if name.endswith("scale")
               else torch.equal(a, b))
    out["ok"] = ok
    del res, st
    return out


def phase_engine_two_pass_prefix(torch, dev, params, q4, vocab):
    """Runs (g)-(j) at full width (32 layers): ``Engine.generate`` with
    ``prefill_two_pass=True`` on (g) the 8k batch, snapkv, bf16 and (h)
    bench.py's 32k int4 snapkv; with a prefix handle on (i) bf16 snapkv,
    chunk 2048, bucket 8192: a 6144-token prefix precomputed once, then 4
    requests of 8000/7600/7000/6400 ids starting with it (k0 = 3), and (j)
    bench.py's 32k fullkv kivi4-pa, int4, chunk 8192: a 24576-token
    quantized handle, resumed on bench.py's 32767-id prompt (pad 1:
    misaligned requantization) and on a 32768-id one (pad 0: aligned).
    Every launch count is held to the plan's (the precompute's too); the
    first-token logits to the twin's (the one-pass prefill, or the chunked
    prefill without the handle), whose prefill wall is timed beside.  The
    misaligned resume of (j) requantizes 24576 of its slots on a shifted
    4-bit grid, a second quantization error of the size of the carry's own:
    its logits are held, as tests/test_prefix_cache.py holds the carry's
    squared error to 2.5x the plain carry's, within (1 + sqrt(2.5)) times
    the distance quantization itself puts between the no-handle chunked
    prefill and the monolithic one (bf16 attention, the region quantized
    after), measured on the same prompt.  The aligned resume's carry is
    held to the no-handle run's over the covered chunks: codes and zeros
    bit for bit, scales within 2^-22 (requantizing grid values rounds the
    span in f32).  Returns (ok, {run: counts})."""
    from pyramidkv_tpu_torch.config import (CompressionSpec, EngineSpec,
                                            ModelSpec)
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.models.weights import kernel_route

    spec = ModelSpec.preset("llama3-8b")
    rng = np.random.default_rng(0)
    p8 = [rng.integers(0, vocab, size=t).tolist() for t in TRUE_LEN]
    p32 = np.random.default_rng(0).integers(0, vocab, size=QTRUE).tolist()
    ok, counts = True, {}

    def want_counts(**kw):
        w = dict.fromkeys(_kernels(), 0)
        w.update(kw)
        return w

    def check(run, c, want, rec):
        good = c == want and rec.pop("_ok", True)
        rec.update(run=run, phase="engine_two_pass_prefix",
                   launches={k: v for k, v in c.items() if v},
                   expected_launches={k: v for k, v in want.items() if v},
                   ok=good)
        log(rec)
        return good

    # (g), (h): the two-pass flash schedule, against the one-pass prefill
    for run, wts, prompts, bucket, max_new, comp in (
            ("(g) bf16 snapkv 8k two-pass", params, p8, N, MAX_NEW,
             dict(method="snapkv")),
            ("(h) int4 snapkv 32k two-pass", q4, [p32], QN, QMAX_NEW,
             dict(method="snapkv", **QCOMP))):
        eng = Engine(spec, CompressionSpec(**comp),
                     EngineSpec(max_new_tokens=max_new,
                                prefill_buckets=(bucket,),
                                prefill_two_pass=True), wts, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        out = eng.generate(prompts, max_new_tokens=gen_new(max_new))
        c = read_counts()
        counts[run] = c
        want = want_counts(flash_row_max=LAYERS, flash_pass_b=LAYERS,
                           decode_attention=LAYERS * out.decode_steps)
        if wts is q4:
            want.update(expected_launches(q4, out.decode_steps, 1, QN))
        tokens, tl = bucket_tokens(torch, dev, prompts, bucket)
        plan = eng.plan_for(bucket)
        with torch.inference_mode():
            (l2, _), _ = _timed(torch, llama.prefill, wts, spec, plan,
                                tokens, tl, prefill_two_pass=True)
            (l1, _), one_s = _timed(torch, llama.prefill, wts, spec, plan,
                                    tokens, tl)
        twin = _logits_close(torch, l2, l1)
        toks = [t for seq in out.tokens for t in seq]
        rec = {"prefill_s": out.prefill_seconds, "one_pass_prefill_s": one_s,
               "decode_s": out.decode_seconds,
               "decode_steps": out.decode_steps,
               "kv_cache_bytes": out.kv_cache_bytes, "vs_one_pass": twin,
               "first_tokens": out.tokens[0][:8],
               "_ok": (twin["ok"] and out.decode_steps == gen_new(max_new) - 1
                       and all(0 <= t < vocab for t in toks))}
        ok &= check(run, c, want, rec)
        del eng, out, l1, l2
        torch.cuda.empty_cache()

    # (i): the bf16 carry resumed from a 6144-token prefix
    run = "(i) bf16 snapkv 8k chunk 2048 prefix 6144"
    eng = Engine(spec, CompressionSpec(method="snapkv"),
                 EngineSpec(max_new_tokens=MAX_NEW, prefill_buckets=(N,),
                            prefill_chunk=C8K), params, device=dev)
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, vocab, size=PREFIX_8K).tolist()
    prompts = [prefix + rng.integers(0, vocab, size=t - PREFIX_8K).tolist()
               for t in PREFIX_LENS]
    lens = [len(p) for p in prompts]
    reset_counts()
    handle, pre_s = _timed(torch, eng.precompute_prefix, prefix)
    good = read_counts() == want_counts(
        flash_causal_attention=LAYERS * (PREFIX_8K // C8K))
    reset_counts()
    out = eng.generate(prompts, prefix=handle)
    c = read_counts()
    counts[run] = c
    k0 = eng._apply_prefix(N, len(prompts), handle, lens)[1]
    want = want_counts(flash_causal_attention=LAYERS * (N // C8K - k0),
                       decode_attention=LAYERS * out.decode_steps)
    tokens, tl = bucket_tokens(torch, dev, prompts, N)
    with torch.inference_mode():
        (lp, _), _ = _timed(torch, eng._run_chunked_prefill, N, tokens, tl,
                            prefix=handle, lens=lens)
        (l0, _), plain_s = _timed(torch, eng._run_chunked_prefill, N,
                                  tokens, tl)
    twin = _logits_close(torch, lp, l0)
    rec = {"precompute_s": pre_s, "handle_bytes": handle.kv_bytes, "k0": k0,
           "prefill_s": out.prefill_seconds, "no_prefix_prefill_s": plain_s,
           "decode_s": out.decode_seconds, "decode_steps": out.decode_steps,
           "kv_cache_bytes": out.kv_cache_bytes, "vs_no_prefix": twin,
           "first_tokens": out.tokens[0][:8],
           "_ok": good and k0 == 3 and twin["ok"]
           and out.decode_steps == MAX_NEW - 1}
    ok &= check(run, c, want, rec)
    del eng, handle, out, lp, l0
    torch.cuda.empty_cache()

    # (j): the quantized carry resumed from a 24576-token int4-weight handle
    cs = CompressionSpec(method="fullkv", quant_method="kivi", nbits=4,
                         q_layout="pa", **QCOMP)
    eng = Engine(spec, cs, EngineSpec(max_new_tokens=QMAX_NEW,
                                      prefill_buckets=(QN,),
                                      prefill_chunk=C32K), q4, device=dev)
    nh = PREFIX_32K // C32K
    reset_counts()
    handle, pre_s = _timed(torch, eng.precompute_prefix, p32[:PREFIX_32K])
    # the chunks' partials (self tiles and history tiles); no lm_head
    pre_want = want_counts(flash_attention_partials=LAYERS * (
        nh + nh * (nh - 1) // 2), **expected_launches(q4, 0, 1, C32K, nh))
    lm = kernel_route(q4["lm_head"], 1)
    if lm is not None:
        pre_want[lm[0]] -= 1
    pre_c = read_counts()
    pre_ok = pre_c == pre_want
    nc = QN // C32K
    for label, prompt in (("pad 1, misaligned", p32),
                          ("pad 0, aligned", p32 + [int(p32[-1])])):
        run = f"(j) int4 fullkv kivi4-pa 32k chunk 8192 prefix 24576, {label}"
        reset_counts()
        out = eng.generate([prompt], prefix=handle, max_new_tokens=QGEN)
        c = read_counts()
        counts[run] = c
        k0 = eng._apply_prefix(QN, 1, handle, [len(prompt)])[1]
        want = want_counts(
            flash_attention_partials=LAYERS * sum(
                1 + i for i in range(k0, nc)),
            quant_fused_attention_pa=LAYERS * out.decode_steps,
            **expected_launches(q4, out.decode_steps, 1, C32K, nc - k0))
        tokens, tl = bucket_tokens(torch, dev, [prompt], QN)
        with torch.inference_mode():
            (lp, _), _ = _timed(torch, eng._run_chunked_prefill, QN, tokens,
                                tl, prefix=handle, lens=[len(prompt)])
            (l0, _), plain_s = _timed(torch, eng._run_chunked_prefill, QN,
                                      tokens, tl)
        twin = _logits_close(torch, lp, l0)
        if (QN - len(prompt)) % C32K == 0:
            twin["carry"] = aligned_carry(eng, handle, tokens, tl, k0)
            twin["ok"] &= twin["carry"]["ok"]
        else:
            with torch.inference_mode():
                lm, _ = llama.prefill(q4, spec, eng.plan_for(QN), tokens,
                                      tl)
            d_q = float((l0 - lm).abs().max())
            twin.update(quantization_distance=d_q,
                        tol=(1 + 2.5 ** 0.5) * d_q,
                        ok=twin["first_logits_max_abs_diff"]
                        <= (1 + 2.5 ** 0.5) * d_q)
            del lm
        rec = {"precompute_s": pre_s, "precompute_launches": {
                   k: v for k, v in pre_c.items() if v},
               "precompute_ok": pre_ok, "handle_bytes": handle.kv_bytes,
               "k0": k0, "pad": QN - len(prompt),
               "prefill_s": out.prefill_seconds,
               "no_prefix_prefill_s": plain_s,
               "decode_s": out.decode_seconds,
               "decode_steps": out.decode_steps,
               "kv_cache_bytes": out.kv_cache_bytes, "vs_no_prefix": twin,
               "first_tokens": out.tokens[0][:8],
               "_ok": pre_ok and k0 == nh and twin["ok"]
               and out.decode_steps == QGEN - 1}
        ok &= check(run, c, want, rec)
        del out, lp, l0
        torch.cuda.empty_cache()
    del eng, handle
    torch.cuda.empty_cache()
    return ok, counts


# ---------------------------------------------------------------------------
# Mistral-7B: the uniform sliding window at full width
# ---------------------------------------------------------------------------

#: Mistral-7B's window (ModelSpec.preset("mistral-7b"): 32 layers, 32/8
#: heads, D = 128, vocabulary 32000); its geometry is Llama-3-8B's, so
#: plans, cache widths and kernel shapes are those of the Llama runs
MISTRAL_W = 4096
#: the depth Mistral-7B's and Qwen2.5-7B's engine runs are cut to, so that
#: the script with Gemma-2-9B's phases stays within the time it met before
#: (their widths, shapes and checks are the full model's; every layer of a
#: run is one more of the same launches)
MISTRAL_DEPTH, QWEN_DEPTH = 8, 8
#: the Mistral runs, as CHUNK_RUNS: name -> (weights, CompressionSpec
#: arguments, size, prefill_chunk).  engine_mistral runs the monolithic
#: ones; engine_mistral_paths the chunked ones, beside two-pass, a prefix
#: handle and MInference
MISTRAL_KIVI4PA = dict(method="fullkv", quant_method="kivi", nbits=4,
                       q_layout="pa", **QCOMP)
MISTRAL_RUNS = {
    "mistral bf16 fullkv 8k": ("bf16", dict(method="fullkv"), "8k", None),
    "mistral bf16 snapkv 8k": ("bf16", dict(method="snapkv"), "8k", None),
    "mistral bf16 pyramidkv 8k": ("bf16", dict(method="pyramidkv"), "8k",
                                  None),
    "mistral bf16 h2o 8k": ("bf16", dict(method="h2o"), "8k", None),
    "mistral int4 fullkv kivi4-pa 32k": ("int4", MISTRAL_KIVI4PA, "32k",
                                         None),
    "mistral int4 snapkv 32k": ("int4", dict(method="snapkv", **QCOMP),
                                "32k", None),
    "mistral bf16 snapkv 8k chunk 2048": ("bf16", dict(method="snapkv"),
                                          "8k", C8K),
    "mistral int4 fullkv kivi4-pa 32k chunk 8192": ("int4", MISTRAL_KIVI4PA,
                                                    "32k", C32K),
}
#: each chunked run's monolithic twin
MISTRAL_TWINS = {
    "mistral bf16 snapkv 8k chunk 2048": "mistral bf16 snapkv 8k",
    "mistral int4 fullkv kivi4-pa 32k chunk 8192":
        "mistral int4 fullkv kivi4-pa 32k"}
MISTRAL_PARITY = ("mistral bf16 fullkv 8k", "mistral bf16 snapkv 8k",
                  "mistral int4 fullkv kivi4-pa 32k chunk 8192",
                  "mistral bf16 snapkv 8k two-pass")


def window_mask(torch, dev, b, hk, s, t_len, written, window):
    """A fullkv cache's visible slots under a sliding window, [B, Hk, s +
    t_len] bool: the prefill region's s slots at positions 0.. (slot 0 the
    left pad of a 32767-token prompt, hidden anyway), ``written`` of the
    t_len decode slots filled, the step's token the last of them; the last
    ``window`` positions visible.  Most leading slots are hidden, as the
    decode step's mask is (models/llama.py::decode_step)."""
    pos = s + written - 1
    slots = torch.arange(s + t_len, device=dev)
    vis = (slots > pos - window) & (slots <= pos)
    return vis.expand(b, hk, -1).contiguous()


def phase_mistral_kernels(torch, F, dev):
    """The windowed modes Mistral's runs launch, each against its plain
    version at full width (window 4096): flash over the 8k batch and
    bench.py's 32k prompt (timed, with the window's visible pairs as the
    bound and SDPA with the windowed bool mask); flash at q_start on each
    chunk of the 8k batch's carry (C=2048) and on a chunk whose pad and
    window edge fall in one 128-key tile; the two-pass kernels at 8k and
    32k; flash_attention_partials on the 32k carry's self tile and on a
    history tile at its true distance (q_start 8192: rows 4095.. see none
    of its keys, exact), timed; the decode kernel on window-shaped masks
    at the 8k batch's (S=8224) and the 32k (S=32896, timed) widths, and
    the pa region kernel on them (the 8k batch, and the 32k chunked
    carry's 4 K groups).  Every kernel called twice and held bitwise
    equal.  Returns (ok, {row: [timed recs]})."""
    ok, recs = True, {}
    w = MISTRAL_W
    r, recs["flash 8k"] = check_flash(torch, F, dev, B, H, HK, N, TRUE_LEN,
                                      w, timed=True, seed=700,
                                      case="8k batch, window 4096")
    ok &= r
    r, recs["flash 32k"] = check_flash(torch, F, dev, 1, H, HK, QN, (QTRUE,),
                                       w, timed=True, seed=701,
                                       case="32k, window 4096")
    ok &= r
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(702)
    buf = (_rand_bf16(torch, g, dev, B, HK, N, D),
           _rand_bf16(torch, g, dev, B, HK, N, D))
    for i in range(N // C8K):
        r, _ = check_flash_chunk(torch, F, dev, B, HK, N, TRUE_LEN, C8K, i,
                                 703 + i, buf, timed=False, window=w,
                                 case=f"8k batch chunk {i}, window 4096")
        ok &= r
    # chunk 3 (q_start 6144): row 0's pad 2100 and its first row's window
    # edge 2049 both in key tile 16 ([2048, 2176))
    r, _ = check_flash_chunk(torch, F, dev, 2, HK, N, (N - 2100, N), C8K, 3,
                             708, tuple(x[:2] for x in buf), timed=False,
                             window=w, case="pad and window edge in one "
                             "tile, chunk 3, window 4096")
    ok &= r
    del buf
    torch.cuda.empty_cache()
    for seed, (case, b, n, tls) in enumerate((
            ("8k, window 4096", B, N, TRUE_LEN),
            ("32k, window 4096", 1, QN, (QTRUE,))), start=710):
        r, _ = check_two_pass(torch, F, dev, case, b, HK, n, tls, seed,
                              window=w, timed=False)
        ok &= r
        torch.cuda.empty_cache()
    recs["partials 32k"] = []
    for seed, (case, q_start, tls) in enumerate((
            ("32k self tile (chunk 1), window 4096", 0, (C32K,)),
            ("32k history tile 0 at q_start 8192, window 4096", C32K,
             tile_len((QTRUE,), QN, C32K, 0))), start=712):
        r, rec = check_partials(torch, F, dev, case, 1, HK, C32K, tls,
                                q_start, seed, window=w)
        ok &= r and (q_start == 0 or rec["dead_rows"] > 0)
        recs["partials 32k"].append(rec)
        torch.cuda.empty_cache()
    recs["decode"] = []
    for seed, (case, b, s, t_len) in enumerate((
            ("8k batch fullkv, window mask", B, N, MAX_NEW),
            ("32k fullkv, window mask", 1, QN, QMAX_NEW)), start=714):
        mask = window_mask(torch, dev, b, HK, s, t_len, t_len // 2, w)
        r, rec = check_decode(torch, F, dev, b, H, HK, s + t_len, True, seed,
                              case, mask=mask)
        ok &= r
        recs["decode"].append(rec)
    for seed, (case, b, s, t_len, k_chunk) in enumerate((
            ("8k batch fullkv kivi4-pa, window mask", B, N, MAX_NEW, None),
            ("32k fullkv kivi4-pa chunk 8192, window mask", 1, QN, QMAX_NEW,
             C32K)), start=716):
        r, _ = check_region(torch, F, dev, "quant_fused_attention_pa", b, HK,
                            H // HK, s, 4, 64, False, seed, case, t_len,
                            k_chunk=k_chunk, window=w)
        ok &= r
        torch.cuda.empty_cache()
    return ok, recs


def model_kv_bytes(run, plan, b, m) -> int:
    """kv_cache_bytes a MODELS[...] run's plan implies: its bf16 K and V,
    the chunked KIVI carry's layout, or the monolithic region's over the
    plan's prefill slots (fullkv: the bucket) of the stored heads."""
    from pyramidkv_tpu_torch.policy import stores_kv_heads

    cs, bucket, max_new, chunk = chunk_run_spec(run)
    if cs.quant_method is None:
        return methods_kv_bytes(plan, b, m["h"], m["hk"], m["layers"],
                                m["d"])
    if chunk:
        return chunk_kv_bytes(run, b, m["layers"], m["hk"], m["d"])
    unit = cs.q_group_size * (8 // cs.nbits)
    return kivi_bytes(b, m["hk"] if stores_kv_heads(cs) else m["h"],
                      -(-plan.prefill_slots // unit) * unit, cs.nbits,
                      cs.q_layout, max_new, m["layers"], m["d"],
                      cs.q_group_size)


def decode_blocks(torch, dev, plan, b, m) -> tuple:
    """(split-kernel blocks one decode step launches, the most blocks one
    launch asks of a wave) under the decode kernel's split plan: per layer
    B x stored heads x nsplit at the layer's cache width and group; a wave
    is the card's SMs times the kernel's residency at that group."""
    from pyramidkv_tpu_torch.kernels.decode_attn import (blocks_per_sm,
                                                         decode_split_plan)
    from pyramidkv_tpu_torch.policy import stores_kv_heads

    hs = m["hk"] if stores_kv_heads(plan.spec) else m["h"]
    g = m["h"] // hs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    total, waves = 0, 0.0
    for start, stop, sub in plan.segment_plans():
        nsplit, _ = decode_split_plan(dev, b * hs, sub.total_slots, g,
                                      m["d"])
        total += (stop - start) * b * hs * nsplit
        waves = max(waves, b * hs * nsplit
                    / (sms * blocks_per_sm(g, m["d"])))
    return total, waves


def phase_engine_model(torch, dev, model, params, q4, vocab, runs=None):
    """``Engine.generate`` on MODELS[model] (all its layers, seeded random
    weights) for each of ``runs`` (default: all of the model's): the 8k
    batch with bf16 weights, bench.py's 32k prompt with int4 weights;
    every kernel's launches held to what the plan implies (the quantized
    carry skipping the history tiles wholly outside a window), the decode
    kernel's blocks to its split plan's (one wave at the cache's group),
    kv_cache_bytes to the layout's, prefill s and decode tok/s printed; a
    chunked run's prefill logits printed beside its monolithic twin's
    (information, as engine_h2o_chunked).  Returns (ok, {run: counts},
    {run: rec})."""
    from pyramidkv_tpu_torch.config import EngineSpec, ModelSpec
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.kernels import decode_attention
    from pyramidkv_tpu_torch.models import llama

    m = MODELS[model]
    spec = ModelSpec.preset(m["preset"], num_hidden_layers=m["layers"])
    p32 = [np.random.default_rng(0).integers(0, vocab, size=QTRUE).tolist()]
    rng = np.random.default_rng(0)
    p8 = [rng.integers(0, vocab, size=t).tolist() for t in TRUE_LEN]
    ok, counts, out_recs = True, {}, {}
    warm = set()
    for run in runs or list(m["runs"]):
        t_run = time.perf_counter()
        wname, _, size = m["runs"][run][:3]
        cs, bucket, max_new, chunk = chunk_run_spec(run)
        ekw, env = run_engine_kw(run)
        two_pass = run.endswith("two-pass")
        prompts = p32 if size == "32k" else p8
        qp = q4 if wname == "int4" else None
        wts = qp if qp is not None else params
        eng = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                          prefill_buckets=(bucket,),
                                          prefill_chunk=chunk,
                                          prefill_two_pass=two_pass, **ekw),
                     wts, device=dev)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            if (wname, size) not in warm:  # the model's lm_head shapes
                eng.generate([p[:64] for p in prompts], max_new_tokens=2)
                warm.add((wname, size))
            torch.cuda.synchronize()
            reset_counts()
            out = eng.generate(prompts, max_new_tokens=gen_new(max_new))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        c = read_counts()
        blocks = decode_attention.blocks
        mm_calls = read_mm_bf16()
        counts[run] = c
        plan = eng.plan_for(bucket)
        want = chunk_expected(run, plan, qp, out.decode_steps, len(prompts),
                              window=m["window"], layers=m["layers"],
                              h=m["h"], hk=m["hk"], full_layers=(
                                  sum(spec.layer_window(li) is None
                                      for li in range(m["layers"]))
                                  if spec.mixed_sliding else None),
                              layer_windows=[spec.layer_window(li) for li in
                                             range(m["layers"])],
                              d=m["d"])
        # the f32 route's mm_bf16 mode: every region call of the run where
        # the switch is set (its regions qualify), none elsewhere
        want_mm = (sum(want[k] for k in ("quant_decode_attention",
                                         "quant_decode_attention_tiled"))
                   if env.get("PKV_QUANT_MM_BF16") == "1" else 0)
        if two_pass:  # pass A and pass B in place of the one-pass kernel
            want["flash_row_max"] = want["flash_pass_b"] = want[
                "flash_causal_attention"]
            want["flash_causal_attention"] = 0
        want_bytes = model_kv_bytes(run, plan, len(prompts), m)
        per_step, waves = ((0, 0.0) if cs.quant_method or plan.think_narrow
                           else decode_blocks(torch, dev, plan, len(prompts),
                                              m))
        toks = [t for seq in out.tokens for t in seq]
        good = (c == want and out.kv_cache_bytes == want_bytes
                and want_bytes == m.get("bytes", {}).get(run, want_bytes)
                and mm_calls == want_mm
                and blocks == per_step * out.decode_steps and waves <= 1
                and out.decode_steps == gen_new(max_new) - 1
                and eng.chunked_prefill_supported(bucket) == bool(chunk)
                and all(0 <= t < vocab for t in toks)
                and all(len(seq) >= 1 for seq in out.tokens))
        rec = {"phase": f"engine_{model}", "run": run, "weights": wname,
               "method": cs.method, "window": m["window"],
               "prefill_chunk": chunk, "two_pass": two_pass,
               "engine": ekw, "env": env, "mm_bf16_calls": mm_calls,
               "expected_mm_bf16_calls": want_mm,
               "prefill_s": out.prefill_seconds,
               "decode_s": out.decode_seconds,
               "decode_steps": out.decode_steps,
               "decode_tok_per_s": (out.decode_steps * len(prompts)
                                    / out.decode_seconds),
               "kv_cache_bytes": out.kv_cache_bytes,
               "expected_kv_cache_bytes": want_bytes,
               "decode_blocks": blocks,
               "expected_decode_blocks": per_step * out.decode_steps,
               "decode_waves": waves,
               "launches": {k: v for k, v in c.items() if v},
               "expected_launches": {k: v for k, v in want.items() if v},
               "first_tokens": out.tokens[0][:8]}
        if chunk:
            tokens, tl = bucket_tokens(torch, dev, prompts, bucket)
            with torch.inference_mode():
                lc, _ = prefill_with(eng, bucket, tokens, tl, "kernel")
                lm, _ = llama.prefill(wts, spec, plan, tokens, tl)
            twin = out_recs.get(m["twins"][run], {})
            rec["vs_monolithic"] = {
                **_logits_close(torch, lc, lm),
                "monolithic_prefill_s": twin.get("prefill_s"),
                "monolithic_first_tokens": twin.get("first_tokens")}
            rec["vs_monolithic"].pop("ok")  # information, not a gate
            del lc, lm
        rec["ok"] = good
        rec["run_wall_s"] = time.perf_counter() - t_run
        log(rec)
        out_recs[run] = rec
        ok &= good
        del eng, out
        torch.cuda.empty_cache()
    return ok, counts, out_recs


def phase_engine_mistral_more(torch, dev, params, q4, vocab, recs):
    """The rest of Mistral's paths at full width (MISTRAL_DEPTH layers):
    ``prefill_two_pass`` on
    the 8k batch (snapkv; first-token logits held to the one-pass
    prefill's, 2^-5 of the largest), a 6144-token prefix handle (longer
    than the window) shared by 4 requests of 8000/7600/7000/6400 ids
    (bf16 snapkv, chunk 2048; k0 = 3; logits held to the no-handle
    chunked prefill's), and MInference on bench.py's 32k prompt with int4
    weights (the sparse path, which ignores the window as JAX's does; the
    decode masks fullkv's cache by the window).  Launch counts held to
    the plan's.  Returns (ok, {run: counts})."""
    from pyramidkv_tpu_torch.config import (CompressionSpec, EngineSpec,
                                            ModelSpec)
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.models import llama

    ml = MISTRAL_DEPTH
    spec = ModelSpec.preset("mistral-7b", num_hidden_layers=ml)
    rng = np.random.default_rng(0)
    p8 = [rng.integers(0, vocab, size=t).tolist() for t in TRUE_LEN]
    p32 = [np.random.default_rng(0).integers(0, vocab, size=QTRUE).tolist()]
    ok, counts = True, {}

    def finish(run, eng, out, c, want, rec, good):
        counts[run] = c
        toks = [t for seq in out.tokens for t in seq]
        good = (good and c == want and out.decode_steps > 0
                and all(0 <= t < vocab for t in toks))
        rec.update(phase="engine_mistral", run=run, window=MISTRAL_W,
                   prefill_s=out.prefill_seconds,
                   decode_s=out.decode_seconds,
                   decode_steps=out.decode_steps,
                   decode_tok_per_s=(out.decode_steps * len(out.tokens)
                                     / out.decode_seconds),
                   kv_cache_bytes=out.kv_cache_bytes,
                   launches={k: v for k, v in c.items() if v},
                   expected_launches={k: v for k, v in want.items() if v},
                   first_tokens=out.tokens[0][:8], ok=good)
        log(rec)
        return good

    def want_counts(**kw):
        w = dict.fromkeys(_kernels(), 0)
        w.update(kw)
        return w

    run = "mistral bf16 snapkv 8k two-pass"
    eng = Engine(spec, CompressionSpec(method="snapkv"),
                 EngineSpec(max_new_tokens=MAX_NEW, prefill_buckets=(N,),
                            prefill_two_pass=True), params, device=dev)
    reset_counts()
    out = eng.generate(p8)
    c = read_counts()
    want = want_counts(flash_row_max=ml, flash_pass_b=ml,
                       decode_attention=ml * out.decode_steps)
    tokens, tl = bucket_tokens(torch, dev, p8, N)
    plan = eng.plan_for(N)
    with torch.inference_mode():
        l2, _ = llama.prefill(params, spec, plan, tokens, tl,
                              prefill_two_pass=True)
        l1, _ = llama.prefill(params, spec, plan, tokens, tl)
    twin = _logits_close(torch, l2, l1)
    want_bytes = methods_kv_bytes(plan, B, layers=ml)
    ok &= finish(run, eng, out, c, want, {
        "vs_one_pass": twin, "one_pass_prefill_s": recs[
            "mistral bf16 snapkv 8k"]["prefill_s"],
        "expected_kv_cache_bytes": want_bytes},
        twin["ok"] and out.kv_cache_bytes == want_bytes)
    del eng, out, l1, l2

    run = "mistral bf16 snapkv 8k chunk 2048 prefix 6144"
    eng = Engine(spec, CompressionSpec(method="snapkv"),
                 EngineSpec(max_new_tokens=MAX_NEW, prefill_buckets=(N,),
                            prefill_chunk=C8K), params, device=dev)
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, vocab, size=PREFIX_8K).tolist()
    prompts = [prefix + rng.integers(0, vocab, size=t - PREFIX_8K).tolist()
               for t in PREFIX_LENS]
    lens = [len(p) for p in prompts]
    reset_counts()
    handle, pre_s = _timed(torch, eng.precompute_prefix, prefix)
    good = read_counts() == want_counts(
        flash_causal_attention=ml * (PREFIX_8K // C8K))
    reset_counts()
    out = eng.generate(prompts, prefix=handle)
    c = read_counts()
    k0 = eng._apply_prefix(N, len(prompts), handle, lens)[1]
    want = want_counts(flash_causal_attention=ml * (N // C8K - k0),
                       decode_attention=ml * out.decode_steps)
    tokens, tl = bucket_tokens(torch, dev, prompts, N)
    with torch.inference_mode():
        (lp, _), _ = _timed(torch, eng._run_chunked_prefill, N, tokens, tl,
                            prefix=handle, lens=lens)
        (l0, _), plain_s = _timed(torch, eng._run_chunked_prefill, N,
                                  tokens, tl)
    twin = _logits_close(torch, lp, l0)
    want_bytes = methods_kv_bytes(eng.plan_for(N), len(prompts), layers=ml)
    ok &= finish(run, eng, out, c, want, {
        "precompute_s": pre_s, "handle_bytes": handle.kv_bytes, "k0": k0,
        "no_prefix_prefill_s": plain_s, "vs_no_prefix": twin,
        "expected_kv_cache_bytes": want_bytes},
        good and k0 == 3 and twin["ok"] and PREFIX_8K > MISTRAL_W
        and out.kv_cache_bytes == want_bytes)
    del eng, handle, out, lp, l0
    torch.cuda.empty_cache()

    run = "mistral int4 minference 32k"
    cs, (bucket, max_new) = minf_spec("int4 minference 32k")
    eng = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                      prefill_buckets=(bucket,)),
                 q4, device=dev)
    reset_counts()
    out = eng.generate(p32, max_new_tokens=QGEN)
    c = read_counts()
    want = want_counts(vertical_attention_partials=ml,
                       slash_tile_attention=ml,
                       decode_attention=ml * out.decode_steps,
                       **expected_launches(q4, out.decode_steps, 1, bucket,
                                           layers=ml))
    ok &= finish(run, eng, out, c, want, {
        "kivi4pa_fullkv_prefill_s": recs[
            "mistral int4 fullkv kivi4-pa 32k"]["prefill_s"],
        "expected_kv_cache_bytes": KV_BYTES_FULLKV_32K * ml // LAYERS},
        out.kv_cache_bytes == KV_BYTES_FULLKV_32K * ml // LAYERS
        and out.decode_steps == QGEN - 1)
    del eng, out
    torch.cuda.empty_cache()
    return ok, counts


def phase_parity_model(torch, dev, model, params, vocab, steps=4):
    """Depth-2 logits of MODELS[model], kernels against plain, on the same
    card: the last-position prefill logits and ``steps`` decode steps (each
    path on its own copy of the kernel path's cache, fed the same tokens, as
    phase_parity_h2o_chunked) for each of the model's parity runs
    (Mistral: fullkv with the decode masked by the window, snapkv, the
    chunked kivi4-pa carry and two-pass; Qwen2.5-7B, with its QKV biases:
    fullkv and snapkv at G = 7 and 1, fullkv kivi4 group and kivi4-pa).
    Limit: 2^-5 of the largest logit."""
    from pyramidkv_tpu_torch.cache import KVCache
    from pyramidkv_tpu_torch.config import (CompressionSpec, EngineSpec,
                                            ModelSpec)
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.models import llama

    m = MODELS[model]
    window = m["window"]
    spec = ModelSpec.preset(m["preset"], num_hidden_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    ok = True
    for run in m["parity"]:
        t_run = time.perf_counter()
        two_pass = run.endswith("two-pass")
        if two_pass:
            wname, size, chunk = "bf16", "8k", None
            cs, bucket, max_new = CompressionSpec(method="snapkv"), N, MAX_NEW
        else:
            wname, _, size = m["runs"][run][:3]
            cs, bucket, max_new, chunk = chunk_run_spec(run)
        wts = quantized(p2, "int4") if wname == "int4" else p2
        eng = Engine(spec, cs, EngineSpec(max_new_tokens=max_new,
                                          prefill_buckets=(bucket,),
                                          prefill_chunk=chunk,
                                          prefill_two_pass=two_pass),
                     wts, device=dev)
        rng = np.random.default_rng(1)
        b, tls = (1, (QTRUE,)) if size == "32k" else (B, TRUE_LEN)
        tokens = torch.from_numpy(
            rng.integers(0, vocab, size=(b, bucket)).astype(np.int64)).to(dev)
        tl = torch.tensor(tls, dtype=torch.int32, device=dev)
        plan = eng.plan_for(bucket)
        with torch.inference_mode():
            lk, ck = prefill_with(eng, bucket, tokens, tl, "kernel")
            lp, _ = prefill_with(eng, bucket, tokens, tl, "plain")
            prefill_err = err = float((lk - lp).abs().max())
            top = float(lp.abs().max())
            same = bool((lk.argmax(-1) == lp.argmax(-1)).all())
            cp_ = KVCache(k=ck.k.clone(), v=ck.v.clone(),
                          mask=ck.mask.clone(),
                          positions=ck.positions.clone(),
                          true_len=ck.true_len, quant=ck.quant)
            tok = lp.argmax(-1)
            for _ in range(steps):
                lk, ck = llama.decode_step(wts, spec, plan, ck, tok,
                                           attention_impl="kernel")
                lp, cp_ = llama.decode_step(wts, spec, plan, cp_, tok,
                                            attention_impl="plain")
                err = max(err, float((lk - lp).abs().max()))
                top = max(top, float(lp.abs().max()))
                same &= bool((lk.argmax(-1) == lp.argmax(-1)).all())
                ok &= bool(torch.isfinite(lk).all())
                tok = lp.argmax(-1)
            # the decode window in force: valid slots the last step hid
            pos = ck.current_position()[:, None, None] - 1
            hidden = (int((ck.mask & (ck.positions <= pos - window)).sum())
                      if window and cs.method == "fullkv" else None)
        torch.cuda.synchronize()
        tol = 2.0 ** -5 * top
        good = err <= tol and (hidden is None or hidden > 0)
        log({"phase": f"parity_{model}", "run": run, "depth": 2,
             "decode_steps": steps, "prefill_max_abs_err": prefill_err,
             "max_abs_err": err, "tol": tol, "same_argmax": same,
             "slots_hidden_by_window": hidden,
             "run_wall_s": time.perf_counter() - t_run, "ok": good})
        ok &= good
        del eng, ck, cp_, wts
        torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# Qwen2.5-7B: QKV biases and GQA group 7
# ---------------------------------------------------------------------------

#: Qwen2.5-7B (JAX config.py:239-245): 28 layers, 28 query heads on 4 KV
#: heads (G = 7), hidden 3584, intermediate 18944, vocabulary 152064
QWEN_H, QWEN_HK = 28, 4
QWEN_G = QWEN_H // QWEN_HK
#: its decode matmuls: name -> (in, out); int4 fuses wqkv (3584 + 2 x 512)
#: and w_gateup, and pads the lm_head to a multiple of 4096 (155648)
QWEN_MM = {"wqkv": (3584, 4608), "wo": (3584, 3584),
           "w_gateup": (3584, 37888), "w_down": (18944, 3584),
           "lm_head4": (3584, 155648), "lm_head8": (3584, 152064)}
#: (kernel, group size, [(shape, x dtype)]) at Qwen's five widths: the
#: engine's int4 runs take the first; g128 and int8 (no Qwen run) are
#: checked at the same widths
QWEN_MM_CASES = [
    ("int4_matmul", 0, [("wqkv", "bf16"), ("wo", "bf16"),
                        ("w_gateup", "bf16"), ("w_down", "bf16"),
                        ("lm_head4", "f32")]),
    ("int4_matmul", 128, [("wqkv", "bf16"), ("wo", "bf16"),
                          ("w_gateup", "bf16"), ("w_down", "bf16")]),
    ("int8_matmul", 0, [("wqkv", "bf16"), ("wo", "bf16"),
                        ("w_gateup", "bf16"), ("w_down", "bf16"),
                        ("lm_head8", "f32")]),
]
#: H2O checks at G = 7 (H2O_CASES' tuple), untimed: a short 7 / 1 shape,
#: the h2o run's 8k batch at 28 / 4 heads
QWEN_H2O_CASES = {
    "short qwen 7/1": (2, 7, 1, 384, (384, 150), 8, 100, False),
    "qwen 8k": (B, QWEN_H, QWEN_HK, N, TRUE_LEN, 8, 2040, False),
}
#: block-sparse checks at G = 7 (SPARSE_CASES' tuple), untimed: a short
#: 7 / 1 shape, the 32k minference run's at 28 / 4 heads (Qwen has no
#: per-head pattern config: JAX's defaults 1000 / 200 apply)
QWEN_SPARSE_CASES = {
    "short qwen 7/1": (2, 7, 1, 1024, (1024, 300), (100, 50), 512, 256, 2,
                       False, False, False),
    "qwen 32k": (1, QWEN_H, QWEN_HK, QN, (QTRUE,), "default", 512, 256, 8,
                 False, False, False),
}
QWEN_KIVI4PA = dict(method="fullkv", quant_method="kivi", nbits=4,
                    q_layout="pa", **QCOMP)
#: the Qwen runs, as MISTRAL_RUNS: name -> (weights, CompressionSpec
#: arguments, size, prefill_chunk)
QWEN_RUNS = {
    "qwen bf16 fullkv 8k": ("bf16", dict(method="fullkv"), "8k", None),
    "qwen bf16 snapkv 8k": ("bf16", dict(method="snapkv"), "8k", None),
    "qwen bf16 pyramidkv 8k": ("bf16", dict(method="pyramidkv"), "8k", None),
    "qwen bf16 h2o 8k": ("bf16", dict(method="h2o"), "8k", None),
    "qwen int4 fullkv kivi4-pa 32k": ("int4", QWEN_KIVI4PA, "32k", None),
    "qwen int4 fullkv kivi4 32k": ("int4", dict(QWEN_KIVI4PA,
                                                q_layout="group"),
                                   "32k", None),
    "qwen int4 snapkv 32k": ("int4", dict(method="snapkv", **QCOMP), "32k",
                             None),
    "qwen int4 fullkv kivi4-pa 32k chunk 8192": ("int4", QWEN_KIVI4PA,
                                                 "32k", C32K),
    "qwen int4 minference 32k": ("int4", dict(method="minference"), "32k",
                                 None),
    "qwen bf16 fullkv kivi4 8k": ("bf16", dict(QWEN_KIVI4PA, q_layout="group"),
                                  "8k", None),
    "qwen bf16 fullkv kivi4-pa 8k": ("bf16", QWEN_KIVI4PA, "8k", None),
}
QWEN_TWINS = {"qwen int4 fullkv kivi4-pa 32k chunk 8192":
              "qwen int4 fullkv kivi4-pa 32k"}
#: depth 2 at the 8k batch: the plain path's 32k prefill at 28 / 4 heads
#: takes ~75 s a run on an H100
QWEN_PARITY = ("qwen bf16 fullkv 8k", "qwen bf16 snapkv 8k",
               "qwen bf16 fullkv kivi4 8k", "qwen bf16 fullkv kivi4-pa 8k")
#: the full-width models after Llama-3-8B: preset, runs, each chunked
#: run's monolithic twin, the parity runs, the sliding window and the
#: geometry (layers the engine runs take, query heads, KV heads, head dim)
MODELS = {
    "mistral": dict(preset="mistral-7b", runs=MISTRAL_RUNS,
                    twins=MISTRAL_TWINS, parity=MISTRAL_PARITY,
                    window=MISTRAL_W, layers=MISTRAL_DEPTH, h=H, hk=HK,
                    d=D),
    "qwen": dict(preset="qwen2.5-7b", runs=QWEN_RUNS, twins=QWEN_TWINS,
                 parity=QWEN_PARITY, window=None, layers=QWEN_DEPTH,
                 h=QWEN_H, hk=QWEN_HK, d=D),
}


def phase_qwen_kernels(torch, F, dev):
    """Every kernel Qwen2.5-7B's runs launch, at its shapes (28 / 4 heads,
    G = 7), against its plain version: the decode kernel's residency at
    each instantiated group against the card's occupancy (the split plan's
    one wave), then the kernel at G = 7 on short shapes, shapes of several
    splits with a wholly masked split and S no multiple of the tile, and
    the 8k batch's and 32k fullkv widths (timed, also on the two-wave plan
    of two blocks an SM); the KIVI group kernel (kFold, and kF32 on short
    shapes) and pa kernel at G = 7 for 2-, 4- and 8-bit codes on short
    shapes, then kivi4 at the engine's 32k (monolithic and chunked) and 8k
    fullkv widths, timed; untimed, the kernels with no new case at 28 / 4 heads:
    flash one-pass at the 8k batch and 32k, at q_start and two-pass,
    partials on the 32k carry's tiles, H2O and the block-sparse kernels;
    the int4 / g128 / int8 matmuls at Qwen's five widths, rows 1 (int4
    timed: the int4 runs' shapes) and 8.  Every kernel is called twice and
    held bitwise equal where its check does so.  Returns (ok, {row: [timed
    recs]})."""
    from pyramidkv_tpu_torch.kernels import _build, decode_attn

    ok, recs = True, {}
    lib = _build.library("decode_attn")
    for g in decode_attn.GROUPS:
        occ = lib.pkv_decode_occupancy(g, D)
        good = occ == decode_attn.blocks_per_sm(g)
        log({"check": "decode_occupancy", "G": g, "blocks_per_sm": occ,
             "plan_blocks_per_sm": decode_attn.blocks_per_sm(g),
             "ok": good})
        ok &= good
    for i, (b, h, hk, s) in enumerate(((2, 7, 1, 37), (1, 14, 2, 300),
                                       (2, QWEN_H, QWEN_HK, 4099),
                                       (3, 7, 1, 1))):
        r, _ = check_decode(torch, F, dev, b, h, hk, s, timed=False,
                            seed=800 + i, label="short, G=7")
        ok &= r
    for i, (b, h, hk, s) in enumerate(((1, QWEN_H, QWEN_HK, 20000),
                                       (2, 14, 2, 9001),
                                       (1, QWEN_H, QWEN_HK, 70001),
                                       (2, 14, 2, 2500))):
        r, _ = check_decode(torch, F, dev, b, h, hk, s, timed=False,
                            seed=810 + i, label="short splits, G=7",
                            masked_split=True)
        ok &= r
    # the per-head methods' caches at 28 heads (G = 1), untimed
    r, _ = check_decode(torch, F, dev, B, QWEN_H, QWEN_H, 2080, timed=False,
                        seed=819, label="qwen snapkv 8k, G=1")
    ok &= r
    recs["decode"] = []
    for seed, (case, b, s) in enumerate((
            ("qwen fullkv 8k batch, G=7", B, N + MAX_NEW),
            ("qwen fullkv 32k, G=7", 1, QN + QMAX_NEW)), start=820):
        r, rec = check_decode(torch, F, dev, b, QWEN_H, QWEN_HK, s, True,
                              seed, case, residency=2)
        ok &= r
        recs["decode"].append(rec)
    # KIVI at G = 7: short shapes for each code width (kFold, kF32 whole
    # and split, pa with one and with 4 K groups, a wholly masked split)
    seed = 830
    for nbits in (2, 4, 8):
        for kind, b, hk, s, gs, t_len in (
                ("quant_fused_attention_group", 2, 2, 1000, 64, 5),
                ("quant_decode_attention", 1, 2, 600, 32, 37),
                ("quant_decode_attention_tiled", 1, 4, 4900, 64, 6),
                ("quant_fused_attention_pa", 2, 2, 1001, 64, 13)):
            r, _ = check_region(torch, F, dev, kind, b, hk, QWEN_G, s, nbits,
                                gs, False, seed, "short, G=7", t_len)
            ok &= r
            seed += 1
    for kind, label, kw in (
            ("quant_fused_attention_pa", "short, G=7, 4 K groups",
             dict(k_chunk=256)),
            ("quant_fused_attention_group", "short, G=7, a split masked",
             dict(masked_rows=(128, 256)))):
        r, _ = check_region(torch, F, dev, kind, 2, 4, QWEN_G, 2048, 4, 64,
                            False, seed, label, 5, **kw)
        ok &= r
        seed += 1
    for key, kind, b, s, t_len, k_chunk in (
            ("group 32k", "quant_fused_attention_group", 1, QN, QMAX_NEW,
             None),
            ("pa 32k", "quant_fused_attention_pa", 1, QN, QMAX_NEW, None),
            ("pa 32k chunk", "quant_fused_attention_pa", 1, QN, QMAX_NEW,
             C32K),
            ("group 8k", "quant_fused_attention_group", B, N, MAX_NEW, None),
            ("pa 8k", "quant_fused_attention_pa", B, N, MAX_NEW, None)):
        r, recs[key] = check_region(
            torch, F, dev, kind, b, QWEN_HK, QWEN_G, s, 4, 64, True, seed,
            f"qwen fullkv kivi4 {key}, G=7", t_len, k_chunk=k_chunk)
        ok &= r
        seed += 1
        torch.cuda.empty_cache()
    # flash, partials, H2O and the sparse kernels at 28 / 4 heads
    for seed, (b, n, tls, case) in enumerate((
            (B, N, TRUE_LEN, "qwen 8k batch"), (1, QN, (QTRUE,), "qwen 32k")),
            start=850):
        r, _ = check_flash(torch, F, dev, b, QWEN_H, QWEN_HK, n, tls, None,
                           False, seed, case)
        ok &= r
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(852)
    buf = (_rand_bf16(torch, g, dev, B, QWEN_HK, N, D),
           _rand_bf16(torch, g, dev, B, QWEN_HK, N, D))
    r, _ = check_flash_chunk(torch, F, dev, B, QWEN_HK, N, TRUE_LEN, C8K, 3,
                             853, buf, case="qwen 8k batch chunk 3",
                             timed=False, h=QWEN_H)
    ok &= r
    del buf
    r, _ = check_two_pass(torch, F, dev, "qwen 8k", B, QWEN_HK, N, TRUE_LEN,
                          854, timed=False, h=QWEN_H)
    ok &= r
    torch.cuda.empty_cache()
    for seed, (case, q_start) in enumerate((
            ("qwen 32k self tile (chunk 0)", 0),
            ("qwen 32k history tile 0", C32K)), start=855):
        r, _ = check_partials(torch, F, dev, case, 1, QWEN_HK, C32K,
                              tile_len((QTRUE,), QN, C32K, 0), q_start,
                              seed, timed=False, h=QWEN_H)
        ok &= r
        torch.cuda.empty_cache()
    for seed, case in enumerate(QWEN_H2O_CASES, start=860):
        ok &= check_h2o(torch, dev, case, seed)[0]
        torch.cuda.empty_cache()
    for seed, case in enumerate(QWEN_SPARSE_CASES, start=865):
        ok &= check_sparse(torch, F, dev, case, seed)[0]
        torch.cuda.empty_cache()
    # the matmuls at Qwen's five widths
    recs["int4_matmul"] = []
    seed = 870
    for kind, gs, shapes in QWEN_MM_CASES:
        for shape, xdt in shapes:
            i, o = QWEN_MM[shape]
            on_path = kind == "int4_matmul" and not gs
            for rows in (1, 8):
                r, rec = check_mm(torch, dev, kind, i, o, rows, xdt,
                                  on_path and rows == 1, seed,
                                  "qwen " + shape, gs)
                ok &= r
                seed += 1
                if on_path and rows == 1:
                    rec["layers"] = 1 if shape.startswith("lm_head") \
                        else QWEN_DEPTH
                    recs["int4_matmul"].append(rec)
    return ok, recs

# ---------------------------------------------------------------------------
# Gemma-2-9B: the attention logit cap and head dim 256
# ---------------------------------------------------------------------------

#: Gemma-2-9B (JAX config.py:246-259): 42 layers alternating sliding (window
#: 4096) and full attention, 16 query heads on 8 KV heads of D = 256, hidden
#: 3584, vocabulary 256000, tied embeddings; attention scale 256^-0.5 and
#: logit cap 50
GEMMA_H, GEMMA_HK, GEMMA_D, GEMMA_LAYERS = 16, 8, 256, 42
GEMMA_W = 4096
GEMMA_SCALE, GEMMA_CAP = 256.0 ** -0.5, 50.0
#: q drawn at this std in the kernel checks: logits of std 4 (scale 1/16,
#: unit keys over 256 channels) reaching ~20, where the cap bends them
#: (50 tanh(20 / 50) = 19.0), as it bends a real model's largest logits
GEMMA_Q_STD = 4.0
GEMMA_ATTN = dict(scale=GEMMA_SCALE, softcap=GEMMA_CAP, q_std=GEMMA_Q_STD)
GEMMA_KIVI4 = dict(method="fullkv", quant_method="kivi", nbits=4)
#: its decode matmuls (in, out): int4 fuses wqkv (16 + 2 x 8 heads of 256)
#: and w_gateup; the tied embedding's int8 codes [256000, 3584] dequantize
#: for the logits, and int8_matmul is held at that width too
GEMMA_MM = {"wqkv": (3584, 8192), "wo": (4096, 3584),
            "w_gateup": (3584, 28672), "w_down": (14336, 3584),
            "head8": (3584, 256000)}
#: the Gemma-2 runs, as MISTRAL_RUNS (a name ending in "two-pass" runs
#: prefill_two_pass): the 8k batch, cap 2048 / window 8 / kernel 7
GEMMA_RUNS = {
    "gemma bf16 fullkv 8k": ("bf16", dict(method="fullkv"), "8k", None),
    "gemma bf16 snapkv 8k": ("bf16", dict(method="snapkv"), "8k", None),
    "gemma bf16 pyramidkv 8k": ("bf16", dict(method="pyramidkv"), "8k",
                                None),
    "gemma bf16 snapkv 8k two-pass": ("bf16", dict(method="snapkv"), "8k",
                                      None),
    "gemma bf16 snapkv 8k chunk 2048": ("bf16", dict(method="snapkv"), "8k",
                                        C8K),
    "gemma int4 snapkv 8k": ("int4", dict(method="snapkv"), "8k", None),
    # H2O, MInference (the sparse path on the full layers: Gemma-2's 8k
    # context is below minference_dense_below's default) and ThinK
    "gemma bf16 h2o 8k": ("bf16", dict(method="h2o"), "8k", None),
    "gemma bf16 minference 8k": ("bf16", dict(method="minference",
                                              minference_dense_below=0),
                                 "8k", None),
    "gemma bf16 think 8k": ("bf16", dict(method="think"), "8k", None),
    "gemma bf16 h2o 8k chunk 2048": ("bf16", dict(method="h2o"), "8k", C8K),
    # KIVI caches: pa, the default group route (per-head caches,
    # G = 1), the f32 route (use_quant_kernel; kivi2), its mm_bf16 mode
    # (use_quant_tiled with PKV_QUANT_MM_BF16=1; K groups of 32 slots, so
    # that the TPU tiled kernel's tile, 128 groups a plane = 8192 slots,
    # divides the region, as the JAX engine needs before it takes the
    # mode) and the quantized carry (chunk 2048, group layout); the fifth
    # field: EngineSpec arguments and the environment of the run
    "gemma bf16 fullkv 8k kivi4-pa": ("bf16", dict(GEMMA_KIVI4,
                                                   q_layout="pa"), "8k",
                                      None),
    "gemma bf16 snapkv 8k kivi4": ("bf16", dict(GEMMA_KIVI4,
                                                method="snapkv"), "8k",
                                   None),
    "gemma bf16 fullkv 8k kivi2 f32": ("bf16", dict(GEMMA_KIVI4, nbits=2),
                                       "8k", None,
                                       dict(use_quant_kernel=True)),
    "gemma bf16 fullkv 8k kivi4 mm_bf16": (
        "bf16", dict(GEMMA_KIVI4, q_group_size=32), "8k", None,
        dict(use_quant_tiled=True, env={"PKV_QUANT_MM_BF16": "1"})),
    "gemma bf16 fullkv 8k kivi4 chunk 2048": ("bf16", GEMMA_KIVI4, "8k",
                                              C8K),
}
GEMMA_TWINS = {"gemma bf16 snapkv 8k chunk 2048": "gemma bf16 snapkv 8k",
               "gemma bf16 h2o 8k chunk 2048": "gemma bf16 h2o 8k",
               "gemma bf16 fullkv 8k kivi4 chunk 2048":
                   "gemma bf16 fullkv 8k"}
#: kv_cache_bytes of the chunked fullkv kivi4 group run, reckoned by hand
#: from the layout: a region (B x Hk = 32 of them a layer) holds K and V
#: codes 2 x 4096 x 256 bytes, K scales and zeros 2 x 256 x 128 f32 (a
#: group of 64 slots) and V scales and zeros 2 x 8192 x 4 f32 (a group of
#: 64 channels): 2,621,440 bytes; plus 2 x 32 decode slots of 256 bf16 a
#: region; 42 layers
GEMMA_KIVI4_BYTES = GEMMA_LAYERS * 32 * (2_621_440 + 2 * MAX_NEW * 256 * 2)
#: the H2O kernel checks at Gemma-2's shapes (16 / 8 heads of D = 256,
#: scale 1/16, cap 50, q at GEMMA_Q_STD), as H2O_CASES: short ragged, a q
#: tile of padding, N - W = 440 (tiles cut short by N), the W x W block
#: across two tiles, then the 8k batch (timed)
GEMMA_H2O_CASES = {
    "short ragged, D=256": (2, GEMMA_H, GEMMA_HK, 384, (384, 150), 8, 100,
                            False),
    "edge: a q tile of padding, D=256": (1, GEMMA_H, GEMMA_HK, 640, (400,),
                                         8, 100, False),
    "edge: N - W = 440, D=256": (2, GEMMA_H, GEMMA_HK, 448, (448, 300), 8,
                                 100, False),
    "edge: W x W across two tiles, D=256": (1, GEMMA_H, GEMMA_HK, 512,
                                            (500,), 200, 100, False),
    "gemma 8k": (B, GEMMA_H, GEMMA_HK, N, TRUE_LEN, 8, 2040, True),
}
#: the block-sparse kernel checks at Gemma-2's shapes, as SPARSE_CASES:
#: short ragged, 64-row q-blocks of 64-key tiles, N % 128 = 64 with 192-row
#: q-blocks, shuffled vertical columns, a batch row of padding, lists not
#: valid-first; then the 8k batch (timed; the engine's budgets)
GEMMA_SPARSE_CASES = {
    "short ragged, D=256": (2, GEMMA_H, GEMMA_HK, 1024, (1024, 37),
                            (100, 50), 512, 256, 2, False, False, False),
    "tiles 64, D=256": (1, 8, 2, 2048, (2000,), (150, 60), 64, 64, 6, False,
                        False, False),
    "N % 128 = 64, D=256": (2, 8, 2, 1344, (1344, 1000), (100, 50), 192,
                            192, 3, False, False, False),
    "shuffled vertical, D=256": (1, 8, 8, 2048, (1900,), (200, 60), 256,
                                 128, 4, True, False, False),
    "padded row, D=256": (2, GEMMA_H, GEMMA_HK, 1024, (1024, 0), (100, 50),
                          512, 256, 2, False, False, False),
    "lists not valid-first, D=256": (2, 8, 2, 1024, (1024, 700), (100, 50),
                                     128, 64, 4, False, True, False),
    "gemma 8k": (B, GEMMA_H, GEMMA_HK, N, TRUE_LEN, "default", 512, 256, 8,
                 False, False, True),
}
#: the KIVI region kernels at Gemma-2's shapes (D = 256, scale 1/16, cap
#: 50, q at GEMMA_Q_STD), untimed edge shapes: (kind, B, Hk, G, slots,
#: nbits, group size, tail, check_region arguments): ragged regions for
#: each group mode (the f32 ones also in mm_bf16), a wholly masked split
#: (in a cluster, and past one with the merge kernel), the whole-region
#: kernel's K tables staged in windows (K groups of 24 slots straddling
#: items), the pa kernel's odd V rows, splits ending inside a unit, its
#: 4 K groups (the chunked carry) and a wholly masked split at the 8k
#: width (``masked_split``: that split of the kernel's plan masked on every
#: plane)
GEMMA_REGION_SHORT = [
    *[(kind, b, hk, g, s, nb, gs, t, dict(mm_bf16=mm))
      for kind, mms in (("quant_decode_attention", (False, True)),
                        ("quant_decode_attention_tiled", (False, True)),
                        ("quant_fused_attention_group", (False,)))
      for mm in mms
      for b, hk, g, s, nb, gs, t in ((2, 3, 2, 1000, 4, 64, 5),
                                     (1, 4, 1, 40, 2, 16, 37),
                                     (2, 2, 2, 300, 8, 32, 2))],
    ("quant_fused_attention_group", B, GEMMA_HK, 2, N, 2, 64, MAX_NEW,
     dict(masked_split=1)),
    ("quant_decode_attention_tiled", B, GEMMA_HK, 2, N, 4, 32, MAX_NEW,
     dict(masked_split=1, mm_bf16=True)),
    ("quant_fused_attention_group", B, 16, 1, 2048, 4, 64, MAX_NEW,
     dict(masked_split=1)),
    ("quant_decode_attention", 1, 2, 2, 8800, 2, 24, 5, {}),
    ("quant_fused_attention_pa", 2, 2, 2, 1001, 8, 5, 13, {}),
    ("quant_fused_attention_pa", 1, 3, 2, 777, 2, 64, 1, {}),
    ("quant_fused_attention_pa", 1, 2, 2, 1024, 2, 64, 37,
     dict(k_chunk=256)),
    ("quant_fused_attention_pa", 2, 3, 1, 1001, 4, 3, 1, {}),
    ("quant_fused_attention_pa", B, GEMMA_HK, 2, N, 4, 64, MAX_NEW,
     dict(k_chunk=C8K)),
    ("quant_fused_attention_pa", B, GEMMA_HK, 2, N, 4, 64, MAX_NEW,
     dict(masked_split=1)),
    # a scale that is no power of two (the tiny Gemma-2's 32^-0.5; Gemma-2-
    # 9B's 1/16 commutes with the bf16 rounding): the fold's order shows
    *[("quant_fused_attention_group", 2, 3, 2, 1000, nb, 64, 5,
       dict(scale=32.0 ** -0.5)) for nb in (4, 8)],
]
#: the region shapes Gemma-2's KIVI runs decode, timed: key -> (kind, B,
#: Hk, G, slots, nbits, group size, check_region arguments); fullkv on the
#: full layers' masks and on the sliding layers' (window 4096)
GEMMA_REGION_CASES = {
    **{f"{name} {mask}": (kind, B, GEMMA_HK, 2, N, nb, gs,
                          dict(window=N + MAX_NEW if mask == "full"
                               else GEMMA_W, mm_bf16=name == "mm_bf16"))
       for name, kind, nb, gs in (
           ("pa", "quant_fused_attention_pa", 4, 64),
           ("group fullkv", "quant_fused_attention_group", 4, 64),
           ("f32 kivi2", "quant_decode_attention_tiled", 2, 64),
           ("mm_bf16", "quant_decode_attention_tiled", 4, 32))
       for mask in ("full", "window")},
    "group snapkv": ("quant_fused_attention_group", B, GEMMA_H, 1, 2048, 4,
                     64, {}),
    "whole snapkv": ("quant_decode_attention", B, GEMMA_H, 1, 2048, 4, 64,
                     {}),
}
GEMMA_PARITY = ("gemma bf16 fullkv 8k", "gemma bf16 snapkv 8k",
                "gemma bf16 h2o 8k", "gemma bf16 minference 8k",
                "gemma bf16 fullkv 8k kivi4-pa", "gemma bf16 snapkv 8k kivi4",
                "gemma bf16 fullkv 8k kivi4 chunk 2048")
MODELS["gemma"] = dict(preset="gemma2-9b", runs=GEMMA_RUNS,
                       twins=GEMMA_TWINS, parity=GEMMA_PARITY,
                       window=GEMMA_W, layers=GEMMA_LAYERS, h=GEMMA_H,
                       hk=GEMMA_HK, d=GEMMA_D,
                       bytes={"gemma bf16 fullkv 8k kivi4 chunk 2048":
                              GEMMA_KIVI4_BYTES})


def phase_gemma_kernels(torch, F, dev):
    """Every kernel Gemma-2's runs launch, at its shapes (16 / 8 heads of
    D = 256) with its scale 1/16 and cap 50, q at GEMMA_Q_STD, against its
    plain version (the H2O and block-sparse kernels at GEMMA_H2O_CASES and
    GEMMA_SPARSE_CASES, with a count of H2O's top-k picks at the 8k batch,
    2 seeds): the decode kernel's residency at D = 256 against the
    card's occupancy; short ragged shapes first (flash one-pass and
    two-pass, decode with several splits, a wholly masked split and a row
    masked everywhere); then, timed, flash over the 8k batch full and with
    the 4096 window, at q_start on chunks 0-3 (C=2048, the carry read in
    place; chunk 3 also windowed, untimed), partials on a self tile and a
    history tile, pass A and pass B over the 8k batch (windowed untimed),
    the decode at G=1 (B=4, 16 heads, S=2080) and G=2 (fullkv, S=8224,
    full and window masks); the int4 matmuls at Gemma-2's widths (rows 4,
    the 8k batch's decode, timed; rows 1) and int8 at the tied head's.
    Every kernel is called twice and held bitwise equal.  Returns (ok,
    {row: rec or [recs]})."""
    from pyramidkv_tpu_torch.kernels import _build, decode_attn
    from pyramidkv_tpu_torch.kernels.int4_matmul import int8_tiles

    ok, recs = True, {}
    kw = dict(GEMMA_ATTN, d=GEMMA_D)
    lib = _build.library("decode_attn")
    for g in decode_attn.GROUPS_BY_DIM[GEMMA_D]:
        occ = lib.pkv_decode_occupancy(g, GEMMA_D)
        want = decode_attn.blocks_per_sm(g, GEMMA_D)
        log({"check": "decode_occupancy", "G": g, "D": GEMMA_D,
             "blocks_per_sm": occ, "plan_blocks_per_sm": want,
             "ok": occ == want})
        ok &= occ == want
    # short, ragged shapes first
    for i, args in enumerate(((2, 4, 2, 256, (256, 77), None),
                              (2, 4, 4, 192, (150, 3), 50),
                              (1, 16, 8, 128, (128,), None),
                              (2, 16, 8, 448, (448, 200), 100))):
        r, _ = check_flash(torch, F, dev, *args, timed=False, seed=900 + i,
                           case="short ragged, D=256, cap 50", **kw)
        ok &= r
    for seed, (case, b, hk, n, tls, q_start, window) in enumerate((
            ("short N=192, D=256", 2, 8, 192, (192, 70), 0, None),
            ("short q_start 256, window 64, D=256", 2, 4, 448, (448, 300),
             256, 64)), start=905):
        r, _ = check_two_pass(torch, F, dev, case, b, hk, n, tls, seed,
                              q_start, window, timed=False, h=2 * hk, **kw)
        ok &= r
    for i, (b, h, hk, s, split) in enumerate((
            (2, 4, 4, 37, False), (2, 8, 4, 300, False),
            (1, 16, 8, 4099, False), (3, 16, 16, 1, False),
            (1, 4, 2, 20000, True), (2, 16, 16, 9001, True))):
        r, _ = check_decode(torch, F, dev, b, h, hk, s, timed=False,
                            seed=910 + i, label="short, D=256, cap 50",
                            masked_split=split, **kw)
        ok &= r
    # the 8k batch
    for key, window, seed in (("flash 8k", None, 920),
                              ("flash 8k window", GEMMA_W, 921)):
        r, recs[key] = check_flash(
            torch, F, dev, B, GEMMA_H, GEMMA_HK, N, TRUE_LEN, window, True,
            seed, f"gemma 8k batch{', window 4096' if window else ''}", **kw)
        ok &= r
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(922)
    buf = (_rand_bf16(torch, g, dev, B, GEMMA_HK, N, GEMMA_D),
           _rand_bf16(torch, g, dev, B, GEMMA_HK, N, GEMMA_D))
    recs["q_start"] = []
    for i in range(N // C8K):
        r, rec = check_flash_chunk(torch, F, dev, B, GEMMA_HK, N, TRUE_LEN,
                                   C8K, i, 923 + i, buf, h=GEMMA_H,
                                   case=f"gemma 8k batch chunk {i}",
                                   **GEMMA_ATTN)
        ok &= r
        recs["q_start"].append(rec)
    r, _ = check_flash_chunk(torch, F, dev, B, GEMMA_HK, N, TRUE_LEN, C8K, 3,
                             927, buf, timed=False, window=GEMMA_W,
                             h=GEMMA_H, case="gemma 8k batch chunk 3, "
                             "window 4096", **GEMMA_ATTN)
    ok &= r
    del buf
    torch.cuda.empty_cache()
    recs["partials"] = []
    for seed, (case, q_start, tls) in enumerate((
            ("gemma 8k self tile (chunk 3)", 0,
             tile_len(TRUE_LEN, N, C8K, 3 * C8K)),
            ("gemma 8k history tile 2 at q_start 2048", C8K,
             tile_len(TRUE_LEN, N, C8K, 2 * C8K))), start=928):
        r, rec = check_partials(torch, F, dev, case, B, GEMMA_HK, C8K, tls,
                                q_start, seed, h=GEMMA_H, **kw)
        ok &= r
        recs["partials"].append(rec)
        torch.cuda.empty_cache()
    for seed, (case, window, timed) in enumerate((
            ("gemma 8k", None, True), ("gemma 8k, window 4096", GEMMA_W,
                                       False)), start=930):
        r, got = check_two_pass(torch, F, dev, case, B, GEMMA_HK, N,
                                TRUE_LEN, seed, window=window, timed=timed,
                                h=GEMMA_H, **kw)
        ok &= r
        if timed:
            recs["row_max"], recs["pass_b"] = (got["flash_row_max"],
                                               got["flash_pass_b"])
        torch.cuda.empty_cache()
    r, recs["decode g1"] = check_decode(
        torch, F, dev, B, GEMMA_H, GEMMA_H, 2080, True, 932,
        "gemma snapkv 8k batch, G=1", **kw)
    ok &= r
    recs["decode g2"] = []
    s, t_len = N, MAX_NEW
    for seed, (case, window) in enumerate((
            ("gemma fullkv 8k batch, G=2, full mask", s + t_len),
            ("gemma fullkv 8k batch, G=2, window mask", GEMMA_W)),
            start=933):
        mask = window_mask(torch, dev, B, GEMMA_HK, s, t_len, t_len // 2,
                           window)
        r, rec = check_decode(torch, F, dev, B, GEMMA_H, GEMMA_HK,
                              s + t_len, True, seed, case, mask=mask, **kw)
        ok &= r
        rec["layers"] = GEMMA_LAYERS // 2
        recs["decode g2"].append(rec)
    r, recs["region"] = phase_gemma_region_kernels(torch, F, dev)
    ok &= r
    # H2O's two kernels and the three block-sparse kernels at D = 256
    # under the cap: the edge shapes, then the 8k batch (timed)
    for seed, case in enumerate(GEMMA_H2O_CASES, start=950):
        r, got = check_h2o(torch, dev, case, seed, **kw)
        ok &= r
        if GEMMA_H2O_CASES[case][-1]:
            recs["h2o_row_stats"], recs["h2o_colsum"] = (got["stats"],
                                                         got["colsum"])
        torch.cuda.empty_cache()
    recs["h2o picks"] = count_h2o_picks(torch, dev, "gemma 8k", seeds=2,
                                        **kw)
    for seed, case in enumerate(GEMMA_SPARSE_CASES, start=960):
        r, got = check_sparse(torch, F, dev, case, seed, **kw)
        ok &= r
        if GEMMA_SPARSE_CASES[case][-1]:
            recs.update(got)
        torch.cuda.empty_cache()
    recs["int4_matmul"] = []
    seed = 940
    for shape in ("wqkv", "wo", "w_gateup", "w_down"):
        i, o = GEMMA_MM[shape]
        for rows in (B, 1):
            r, rec = check_mm(torch, dev, "int4_matmul", i, o, rows, "bf16",
                              rows == B, seed, "gemma " + shape)
            ok &= r
            seed += 1
            if rows == B:
                rec["layers"] = GEMMA_LAYERS
                recs["int4_matmul"].append(rec)
    i, o = GEMMA_MM["head8"]
    if int8_tiles(i, o)[0]:
        r, _ = check_mm(torch, dev, "int8_matmul", i, o, 1, "f32", False,
                        seed, "gemma tied head")
        ok &= r
    else:
        log({"check": "int8_matmul", "case": "gemma tied head",
             "note": "not tiled by int8_tiles: the tied head dequantizes"})
    return ok, recs


def split_rows(kind, dev, b, hk, s, nbits, gs, d, i):
    """Byte-rows [r0, r1) of split ``i`` of region kernel ``kind``'s plan
    for ``b * hk`` regions of ``s`` slots (K groups of ``gs`` slots)."""
    from pyramidkv_tpu_torch.kernels import quant_decode, quant_fused_decode

    per = 8 // nbits
    w = -(-s // (gs * per)) * gs
    if kind == "quant_fused_attention_pa":
        _, rows = quant_fused_decode.pa_split_plan(dev, b * hk, w, 0, d)
    else:
        _, rows = quant_decode.split_plan(dev, b * hk, w, nbits, gs, d)
    return i * rows, min(w, (i + 1) * rows)


def phase_gemma_region_kernels(torch, F, dev):
    """The KIVI region kernels at D = 256 under the cap (part of
    gemma_kernels; the Gemma-2 KIVI mutants of
    scripts/port_mutation_check.py run it alone): GEMMA_REGION_SHORT, then
    GEMMA_REGION_CASES (timed); mm_bf16 at Llama's D = 128 too (its fullkv
    kivi4 8k region, K groups of 32).  Returns (ok, {key: rec}); the D =
    128 record under "mm_bf16 d128"."""
    from pyramidkv_tpu_torch.kernels import _build

    _build.build_all(["quant_decode", "quant_group_fused",
                      "quant_decode_mm_bf16", "quant_fused_decode"])
    ok, recs = True, {}
    kw = dict(GEMMA_ATTN, d=GEMMA_D)
    for seed, (kind, b, hk, grp, s, nbits, gs, t_len, extra) in enumerate(
            GEMMA_REGION_SHORT, start=1000):
        label = "gemma short, D=256, cap 50" + (
            ", scale 32^-0.5" if "scale" in extra else "")
        extra = dict(extra)
        if "masked_split" in extra:
            extra["masked_rows"] = split_rows(
                kind, dev, b, hk, s, nbits, gs, GEMMA_D,
                extra.pop("masked_split"))
        r, _ = check_region(torch, F, dev, kind, b, hk, grp, s, nbits, gs,
                            False, seed, label, t_len, **dict(kw, **extra))
        ok &= r
    for seed, (key, (kind, b, hk, grp, s, nbits, gs, extra)) in enumerate(
            GEMMA_REGION_CASES.items(), start=1100):
        r, recs[key] = check_region(torch, F, dev, kind, b, hk, grp, s,
                                    nbits, gs, True, seed, "gemma " + key,
                                    MAX_NEW, **extra, **kw)
        ok &= r
        torch.cuda.empty_cache()
    r, recs["mm_bf16 d128"] = check_region(
        torch, F, dev, "quant_decode_attention_tiled", B, HK, H // HK, N, 4,
        32, True, 1150, "llama fullkv 8k kivi4, K groups of 32, mm_bf16",
        MAX_NEW, mm_bf16=True)
    ok &= r
    return ok, recs


def gemma_reference_logits(torch, params, spec, tokens, true_len):
    """The harness's plain reference of a Gemma-2 prefill's last-position
    logits, written from HF's modeling_gemma2 without the port's model
    code: embeddings times sqrt(hidden) in the activation dtype; per layer
    (1 + w) RMSNorms in f32, RoPE, attention over the visible keys (causal,
    past the left pad, and within the window on sliding layers) with logits
    cap * tanh(scale q.k / cap) and an f32 softmax, the post-attention
    norm, GeGLU and the post-MLP norm; the final norm, the tied embedding
    and the final cap.  The last layer attends for the last row only."""
    dt = params["final_norm"].dtype
    dev = tokens.device
    b, n = tokens.shape
    h, hk, d = (spec.num_attention_heads, spec.num_key_value_heads,
                spec.head_dim)
    eps, cap = spec.rms_norm_eps, spec.attn_logit_softcapping

    def norm(x, w):
        xf = x.float()
        return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
                * (1.0 + w.float())).to(dt)

    pad = n - true_len.long()
    col = torch.arange(n, device=dev)
    pos = (col[None] - pad[:, None]).clamp(min=0).float()  # [B, N]
    inv = 1.0 / spec.rope_theta ** (
        torch.arange(0, d, 2, device=dev).float() / d)

    def rope(x, p):  # x [B, heads, T, d], p [B, T]
        ang = p[:, None, :, None] * inv
        x1, x2 = x[..., :d // 2].float(), x[..., d // 2:].float()
        return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                          x2 * ang.cos() + x1 * ang.sin()], -1).to(dt)

    x = params["embed"][tokens] * torch.tensor(spec.hidden_size ** 0.5,
                                               dtype=dt, device=dev)
    L = spec.num_hidden_layers
    for li in range(L):
        w = {k: v[li] for k, v in params["layers"].items()}
        hn = norm(x, w["attn_norm"])
        rows = torch.arange(n - 1 if li == L - 1 else 0, n, device=dev)
        q = rope((hn[:, rows] @ w["wq"]).view(b, -1, h, d).transpose(1, 2),
                 pos[:, rows])
        k = rope((hn @ w["wk"]).view(b, n, hk, d).transpose(1, 2), pos)
        v = (hn @ w["wv"]).view(b, n, hk, d).transpose(1, 2)
        k = k.repeat_interleave(h // hk, 1).float()
        v = v.repeat_interleave(h // hk, 1).float()
        win = spec.sliding_window if spec.layer_is_sliding(li) else None
        out = torch.empty((b, h, len(rows), d), dtype=dt, device=dev)
        for r0 in range(0, len(rows), 512):
            rr = rows[r0:r0 + 512]
            s = torch.matmul(q[:, :, r0:r0 + 512].float(),
                             k.transpose(-1, -2)) * spec.attn_scale
            s = torch.tanh(s / cap) * cap
            vis = ((col[None, None] <= rr[None, :, None])
                   & (col[None, None] >= pad[:, None, None]))
            if win:
                vis &= rr[None, :, None] - col[None, None] < win
            s = s.masked_fill(~vis[:, None], torch.finfo(torch.float32).min)
            p = torch.softmax(s, -1).to(dt).float()
            out[:, :, r0:r0 + 512] = torch.matmul(p, v).to(dt)
            del s, p
        a = out.transpose(1, 2).reshape(b, len(rows), h * d) @ w["wo"]
        x = x[:, rows] + norm(a, w["attn_post_norm"])
        hm = norm(x, w["mlp_norm"])
        gate = torch.nn.functional.gelu((hm @ w["w_gate"]).float(),
                                        approximate="tanh").to(dt)
        x = x + norm((gate * (hm @ w["w_up"])) @ w["w_down"],
                     w["mlp_post_norm"])
    hn = norm(x[:, -1], params["final_norm"])
    logits = (hn @ params["embed"].T).float()
    fc = spec.final_logit_softcapping
    return torch.tanh(logits / fc) * fc


def phase_gemma_reference(torch, F, dev, params=None):
    """Depth-2 Gemma-2 (one sliding and one full layer) at full width: the
    port's prefill through the kernels against gemma_reference_logits on
    the 8k batch (random ids, seed 1), the last-position logits within 2^-5
    of the largest; then the chunked prefill's quantized carry (fullkv
    kivi8, chunk 2048: 8-bit codes keep it near the bf16 reference) against
    the same reference and limit.  ``params``: Gemma-2 params whose first
    two layers are used; None draws two layers from seed 3."""
    from pyramidkv_tpu_torch.config import CompressionSpec, ModelSpec
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.models.convert import init_params
    from pyramidkv_tpu_torch.policy import make_plan

    t0 = time.perf_counter()
    spec = ModelSpec.preset("gemma2-9b", num_hidden_layers=2)
    if params is None:
        params = init_params(spec, torch.Generator(device=dev).manual_seed(3),
                             dev, torch.bfloat16)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, spec.vocab_size, size=(B, N)).astype(np.int64)).to(dev)
    tl = torch.tensor(TRUE_LEN, dtype=torch.int32, device=dev)
    plan = make_plan(CompressionSpec(method="fullkv"), 2, N, MAX_NEW,
                     **{"attn_" + k: v
                        for k, v in llama.attn_args(spec).items()})
    with torch.inference_mode():
        got, _ = llama.prefill(p2, spec, plan, tokens, tl)
        want = gemma_reference_logits(torch, p2, spec, tokens, tl)
    err = float((got - want).abs().max())
    tol = 2.0 ** -5 * float(want.abs().max())
    rec = {"check": "gemma_reference", "case": "depth-2 8k batch prefill",
           "max_abs_err": err, "tol": tol, "err_over_tol": err / tol,
           "same_argmax": bool((got.argmax(-1) == want.argmax(-1)).all()),
           "seconds": time.perf_counter() - t0}
    rec["ok"] = bool(torch.isfinite(got).all()) and err <= tol
    log({"phase": "parity_gemma", **rec})
    # the quantized carry (fullkv kivi8, chunk 2048) through the kernels
    # against the same reference: its full layer attends every earlier
    # chunk, its sliding one the chunks inside the window
    from pyramidkv_tpu_torch.config import EngineSpec
    from pyramidkv_tpu_torch.engine import Engine

    eng = Engine(spec, CompressionSpec(method="fullkv", quant_method="kivi",
                                       nbits=8),
                 EngineSpec(max_new_tokens=MAX_NEW, prefill_buckets=(N,),
                            prefill_chunk=C8K), p2, device=dev)
    with torch.inference_mode():
        got_c, _ = prefill_with(eng, N, tokens, tl, "kernel")
    err_c = float((got_c - want).abs().max())
    rec_c = {"check": "gemma_reference_carry",
             "case": "depth-2 8k batch, quantized carry kivi8 chunk 2048",
             "max_abs_err": err_c, "tol": tol, "err_over_tol": err_c / tol,
             "same_argmax": bool((got_c.argmax(-1) == want.argmax(-1)).all()),
             "ok": bool(torch.isfinite(got_c).all()) and err_c <= tol}
    log({"phase": "parity_gemma", **rec_c})
    del eng, got_c
    return rec["ok"] and rec_c["ok"], rec


#: the trained tiny retrieval checkpoint (data/tiny_retrieval.npz: 8
#: layers, 8 query heads on 4 KV heads of D = 32, hidden 256, tied
#: embeddings): JAX's greedy tokens and kv_cache_bytes of ACCURACY.md's 16
#: needle-grid configurations on one prompt (the CPU tests hold the pin to
#: live JAX engines)
TRAINED_PIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "torch_trained_tokens.json")
TRAINED_BUCKET, TRAINED_NEW, TRAINED_LAYERS, TRAINED_D = 1024, 16, 8, 32
#: the grid batch: needle contexts x depths (ACCURACY.md's grid), B = 30
TRAINED_CTX = (400, 650, 950)
TRAINED_DEPTHS = 10
#: the kernels the grid's paths launch at D = 32
TRAINED_KERNELS = ("flash_causal_attention", "decode_attention",
                   "h2o_row_stats", "h2o_colsum",
                   "quant_fused_attention_group")
#: the refusal the D = 32 modes not ported yet raise
TRAINED_QUEUED = "ROADMAP queue 2A #4"
#: a selection near-tie: a slot the two paths' prefill top-k keep
#: differently lies within this share of the cut's plain score (2^-8: the
#: least relative step between bf16 values, the precision of the q and k
#: the scores come from)
TRAINED_SELECT_TIE = 2.0 ** -8


def trained_pin() -> dict:
    with open(TRAINED_PIN) as f:
        return json.load(f)


def trained_batch(tok):
    """The grid batch: one needle prompt per (context, depth), laid out as
    the CPU tests' prompt (filler before, the needle, filler after, the
    question), each from its own seed.  Returns (prompts, code words)."""
    from pyramidkv_tpu_torch.train import data as tdata

    prompts, codes = [], []
    for ci, ctx in enumerate(TRAINED_CTX):
        for di in range(TRAINED_DEPTHS):
            depth = di / (TRAINED_DEPTHS - 1)
            before = int(round(ctx * depth))
            ids, cw = tdata.needle_prompt(tok, seed=1000 + 10 * ci + di,
                                          before=before, after=ctx - before)
            assert len(ids) <= TRAINED_BUCKET, len(ids)
            prompts.append(ids)
            codes.append(cw)
    return prompts, codes


def trained_comp(entry):
    from pyramidkv_tpu_torch.config import CompressionSpec

    return CompressionSpec(**entry["comp"])


def trained_expected(comp, steps: int) -> dict:
    """Launches of one B = 1 generate of the trained model: one flash a
    layer; a decode (bf16 cache) or a region call (KIVI) a layer a decode
    step; one H2O stats and one colsum a layer for h2o; nothing else."""
    want = {k: 0 for k in _kernels()}
    want["flash_causal_attention"] = TRAINED_LAYERS
    step_kernel = ("quant_fused_attention_group"
                   if comp.quant_method is not None else "decode_attention")
    want[step_kernel] = TRAINED_LAYERS * steps
    if comp.method == "h2o":
        want["h2o_row_stats"] = want["h2o_colsum"] = TRAINED_LAYERS
    return want


def trained_decode_shapes(pin) -> list:
    """(G, slots) of every decode-kernel call of the grid's bf16 caches,
    from their plans: per-head caches (G = 1) of each segment's width,
    fullkv's true-GQA cache (G = 2)."""
    from pyramidkv_tpu_torch.policy import make_plan, stores_kv_heads

    shapes = set()
    for e in pin["configs"].values():
        cs = trained_comp(e)
        if cs.quant_method is not None:
            continue
        g = 2 if stores_kv_heads(cs) else 1
        plan = make_plan(cs, TRAINED_LAYERS, TRAINED_BUCKET, TRAINED_NEW)
        for _, _, sub in plan.segment_plans():
            shapes.add((g, sub.total_slots))
    return sorted(shapes)


def phase_trained_kernels(torch, F, dev, pin, batch_lens):
    """The D = 32 kernels against their plain versions at the needle grid's
    shapes: flash over the pin prompt (B = 1) and the grid batch (B = 30,
    N = 1024, left pads) and at short shapes (a window, a cap); the decode
    kernel at every bf16 cache's (G, slots) at B = 1 and B = 30 and on a
    plan of several splits with a wholly masked split; its residency at
    D = 32; H2O stats and colsum at N = 1024 (window 8); the folded KIVI
    group kernel at 8, 4 and 2 bits over 1024 slots and a 16-slot tail at
    B = 1 and 30 and with a masked byte-row range (a row masked everywhere,
    exact: m = float32.min, l = 0, in every check); and the refusals of the
    modes not ported at D = 32.  Returns (ok, {name: [records]})."""
    from pyramidkv_tpu_torch import kernels
    from pyramidkv_tpu_torch.kernels import _build, decode_attn

    d = TRAINED_D
    ok = True
    recs = {k: [] for k in ("flash", "decode", "h2o_row_stats", "h2o_colsum",
                            "region")}
    pin_len = (len(pin["prompt"]["ids"]),)
    for args in ((2, 8, 4, 256, (256, 77), None), (2, 8, 4, 192, (150, 3), 50),
                 (1, 8, 8, 128, (128,), None)):
        r, _ = check_flash(torch, F, dev, *args, timed=False, seed=1,
                           case="trained short", d=d)
        ok &= r
    r, _ = check_flash(torch, F, dev, 1, 8, 8, 128, (128,), None, timed=False,
                       seed=2, case="trained short cap", d=d, softcap=5.0,
                       q_std=4.0)
    ok &= r
    for b, tl, case in ((1, pin_len, "pin B=1"), (30, batch_lens, "grid B=30")):
        r, rec = check_flash(torch, F, dev, b, 8, 4, TRAINED_BUCKET, tl, None,
                             timed=True, seed=3 + b, case=case, d=d)
        recs["flash"].append(rec)
        ok &= r
    seed = 40
    for g, s in trained_decode_shapes(pin):
        for b in (1, 30):
            r, rec = check_decode(torch, F, dev, b, 8, 8 // g, s, timed=True,
                                  seed=seed, label=f"G={g} S={s} B={b}", d=d)
            rec["G"] = g
            recs["decode"].append(rec)
            ok &= r
            seed += 1
    r, _ = check_decode(torch, F, dev, 2, 8, 4, 9001, timed=False, seed=seed,
                        label="short splits", masked_split=True, d=d)
    ok &= r
    lib = _build.library("decode_attn")
    for g in (1, 2):
        occ = lib.pkv_decode_occupancy(g, d)
        good = occ == decode_attn.blocks_per_sm(g, d)
        log({"check": "decode_occupancy", "D": d, "G": g,
             "blocks_per_sm": occ,
             "plan_blocks_per_sm": decode_attn.blocks_per_sm(g, d),
             "ok": good})
        ok &= good
    H2O_CASES["trained pin B=1"] = (1, 8, 4, TRAINED_BUCKET, pin_len, 8, 56,
                                    True)
    H2O_CASES["trained grid B=30"] = (30, 8, 4, TRAINED_BUCKET, batch_lens, 8,
                                      56, True)
    H2O_CASES["trained short"] = (2, 8, 4, 320, (320, 100), 8, 56, False)
    for i, case in enumerate(("trained short", "trained pin B=1",
                              "trained grid B=30")):
        r, rec = check_h2o(torch, dev, case, seed=60 + i, d=d)
        ok &= r
        if "ms" in rec["stats"]:
            recs["h2o_row_stats"].append(rec["stats"])
            recs["h2o_colsum"].append(rec["colsum"])
    kind = "quant_fused_attention_group"
    for nbits in (8, 4, 2):
        for b in (1, 30):
            r, rec = check_region(
                torch, F, dev, kind, b, 4, 2, TRAINED_BUCKET, nbits, 64,
                timed=True, seed=70 + nbits + b,
                label=f"fullkv kivi{nbits} B={b}", t_len=TRAINED_NEW, d=d)
            recs["region"].append(rec)
            ok &= r
        r, _ = check_region(torch, F, dev, kind, 1, 4, 2, TRAINED_BUCKET,
                            nbits, 64, timed=False, seed=80 + nbits,
                            label=f"kivi{nbits} masked rows", t_len=37,
                            masked_rows=(32, 96), d=d)
        ok &= r
    # the modes not ported at D = 32 refuse it, naming the ROADMAP item
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (_rand_bf16(torch, g, dev, 1, n, 128, d) for n in (8, 4, 4))
    tl = torch.tensor([128], dtype=torch.int32, device=dev)
    refusals = {}
    for name, fn in (
            ("flash_attention_partials",
             lambda: kernels.flash_attention_partials(q, k, v, tl)),
            ("flash two-pass", lambda: kernels.flash_causal_attention(
                q, k, v, tl, two_pass=True))):
        try:
            fn()
            refusals[name] = "launched"
        except ValueError as e:
            refusals[name] = TRAINED_QUEUED in str(e)
    from pyramidkv_tpu_torch.kernels import quant_decode

    rq, reg, mask, tail = region_inputs(torch, dev, 1, 4, 2, 256, 4, 64,
                                        "group", 16, 9, d=d)
    try:
        kernels.quant_decode_attention(rq, reg, mask, nbits=4, tail=tail)
        refusals["quant_decode_attention (f32)"] = "launched"
    except ValueError as e:
        refusals["quant_decode_attention (f32)"] = TRAINED_QUEUED in str(e)
    good = all(x is True for x in refusals.values()) and \
        quant_decode.D32_QUEUED.endswith(f"({TRAINED_QUEUED})")
    log({"check": "trained_refusals", "D": d, "refused": refusals,
         "ok": good})
    return ok & good, recs


def phase_trained_kernel_checks(torch, F, dev):
    """phase_trained_kernels alone (the D = 32 kernels against their plain
    versions), with the pin's prompt and the grid batch's lengths, its four
    libraries built together first: what ``scripts/port_mutation_check.py``
    runs for its D = 32 mutants."""
    from pyramidkv_tpu_torch.kernels import _build
    from pyramidkv_tpu_torch.train import ToyTokenizer

    _build.build_all(["flash_prefill", "decode_attn", "h2o_scores",
                      "quant_group_fused"])
    prompts = trained_batch(ToyTokenizer())[0]
    return phase_trained_kernels(torch, F, dev, trained_pin(),
                                 tuple(len(p) for p in prompts))


def _keep_share(pk, pp) -> list:
    """Per layer: the share of the plain path's kept prefill positions that
    the kernel path kept too (sets per batch row and head)."""
    segs_k = pk if isinstance(pk, tuple) else (pk,)
    segs_p = pp if isinstance(pp, tuple) else (pp,)
    out = []
    for a, b in zip(segs_k, segs_p):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        for li in range(a.shape[0]):
            hit = tot = 0
            for bi in range(a.shape[1]):
                for h in range(a.shape[2]):
                    want = set(b[li, bi, h][b[li, bi, h] >= 0].tolist())
                    got = set(a[li, bi, h][a[li, bi, h] >= 0].tolist())
                    hit += len(want & got)
                    tot += len(want)
            out.append(hit / max(tot, 1))
    return out


def trained_steps(torch, dev, eng, prompt, impl, w32):
    """Greedy decode of one prompt as ``generate`` runs it, through the
    kernels or the plain path, capturing each step's logits: (tokens,
    [top-2 gap], [f32-head argmax flips], [logits], prefill positions, the
    bf16 K / V elements, [(scores, selection)] of each prefill top-k).
    The f32 head: the final-normed hidden state times the tied embedding,
    both in f32, beside the port's product (To check #1)."""
    from pyramidkv_tpu_torch import policy, prng
    from pyramidkv_tpu_torch.models import llama

    spec, params = eng.model_spec, eng.params
    plan = eng.plan_for(TRAINED_BUCKET)
    seen = []
    orig = llama._logits

    def hooked(hidden, p_, s_, impl_="kernel"):
        out = orig(hidden, p_, s_, impl_)
        h = llama._norm(hidden, p_["final_norm"], s_)
        seen.append((out, h.float() @ w32.T))
        return out

    picks = []
    orig_topk = policy.topk_select

    def topk(scores, width, keep_counts):
        sel = orig_topk(scores, width, keep_counts)
        picks.append((scores.float().clone(), sel))
        return sel

    tokens, tl = bucket_tokens(torch, dev, [prompt], TRAINED_BUCKET)
    llama._logits = hooked
    policy.topk_select = topk
    try:
        with torch.inference_mode():
            logits, cache = llama.prefill(params, spec, plan, tokens, tl,
                                          attention_impl=impl,
                                          rng=prng.PRNGKey(0, device=dev))
            pos = (tuple(x.clone() for x in cache.positions)
                   if isinstance(cache.positions, tuple)
                   else cache.positions.clone())
            # the bf16 K / V buffers' elements (4 bytes each in the f32 pin)
            kv_elems = sum(t.numel() for part in (cache.k, cache.v)
                           for t in (part if isinstance(part, tuple)
                                     else (part,)))
            toks = []
            for step in range(TRAINED_NEW):
                tok = logits.argmax(-1)
                toks.append(int(tok[0]))
                if step == TRAINED_NEW - 1:
                    break
                logits, cache = llama.decode_step(
                    params, spec, plan, cache, tok, attention_impl=impl,
                    f32_quant=eng.f32_quant)
    finally:
        llama._logits = orig
        policy.topk_select = orig_topk
    gaps, flips, steps = [], 0, []
    for out, wide in seen:
        top = torch.topk(out[0].float(), 2).values
        gaps.append(float(top[0] - top[1]))
        flips += int(out[0].argmax() != wide[0].argmax())
        steps.append(out[0].float())
    return toks, gaps, flips, steps, pos, kv_elems, picks


def selection_ties(picks_k, picks_p) -> dict:
    """The slots the two paths' prefill top-k keep differently (To check
    #2), and the largest distance of their plain scores from the plain
    path's cut (the lowest kept plain score of that row), over
    max(|cut|, 1e-30)."""
    swapped, worst = 0, 0.0
    for (_, sk), (sp_scores, sp) in zip(picks_k, picks_p):
        ik, vk = sk.indices.cpu(), sk.valid.cpu()
        ip, vp = sp.indices.cpu(), sp.valid.cpu()
        sc = sp_scores.cpu()
        for b in range(ip.shape[0]):
            for h in range(ip.shape[1]):
                kept_p = ip[b, h][vp[b, h]]
                kept_k = set(ik[b, h][vk[b, h]].tolist())
                if set(kept_p.tolist()) == kept_k or kept_p.numel() == 0:
                    continue
                cut = float(sc[b, h][kept_p].min())
                for j in kept_k.symmetric_difference(kept_p.tolist()):
                    swapped += 1
                    worst = max(worst, abs(float(sc[b, h, j]) - cut)
                                / max(abs(cut), 1e-30))
    return {"swapped_slots": swapped, "worst_distance_from_cut": worst}


def trained_teacher_forced(torch, dev, eng, prompt) -> dict:
    """The kernels inside the trained model, each call held to its plain
    version on the same inputs: a kernel prefill (each layer's flash output
    against ``causal_prefill_attention``, rows past the pad; H2O's scores
    against the plain path's scorer ``ops.scoring.h2o_scores``) and 15
    kernel decode steps (each decode-kernel call against the plain decode,
    each KIVI region call against its plain version and the plain tail),
    err / limit (TOL_TEXT; the region's TAIL_TOL "folded"; H2O's scores
    2^-6 |want| + 2^-14 rms(want's row)); beside them,
    the prefill logits against a plain prefill's and 15 decode steps on two
    copies of the kernel prefill's cache, one through the kernels and one
    plain, fed the same tokens: each step's max |kernel - plain| logit over
    2^-5 of the largest plain logit (information: the trained model's
    attention logits of up to 3000 nats carry a last-bit difference far)."""
    from pyramidkv_tpu_torch import policy, prng
    from pyramidkv_tpu_torch.models import llama
    from pyramidkv_tpu_torch.ops import attention as plain_attn
    from pyramidkv_tpu_torch.ops import quant, scoring

    spec, params = eng.model_spec, eng.params
    plan = eng.plan_for(TRAINED_BUCKET)
    tokens, tl = bucket_tokens(torch, dev, [prompt], TRAINED_BUCKET)
    pad = TRAINED_BUCKET - len(prompt)
    errs = {"flash": [], "decode": [], "region": [], "h2o": []}
    saved = {n: getattr(llama, n) for n in (
        "flash_causal_attention", "decode_attention",
        "quant_fused_attention_group")}
    saved_h2o = policy.h2o_kernel

    def flash(q, k, v, true_len, **kw):
        out = saved["flash_causal_attention"](q, k, v, true_len, **kw)
        want = plain_attn.causal_prefill_attention(
            q, k, v, true_len=true_len, **{
                x: kw[x] for x in ("sliding_window", "scale", "softcap")})
        errs["flash"].append(err_over_tol(out[:, :, pad:], want[:, :, pad:]))
        return out

    def decode(q, k, v, mask, **kw):
        out = saved["decode_attention"](q, k, v, mask, **kw)
        errs["decode"].append(err_over_tol(
            out, plain_attn.decode_attention(q, k, v, mask, **kw)))
        return out

    def region(q, reg, mask, *, nbits, tail=None, **kw):
        out = saved["quant_fused_attention_group"](q, reg, mask, nbits=nbits,
                                                   tail=tail, **kw)
        want = quant.merge_tail(quant.quant_region_attention_fused(
            q, reg, mask, nbits=nbits, **kw), q, tail, **kw)
        errs["region"].append(err_over_tol(out, want, *TAIL_TOL["folded"]))
        return out

    def h2o(q, k, **kw):
        out = saved_h2o(q, k, **kw)
        want = scoring.h2o_scores(q, k, **kw)
        fin = torch.isfinite(want)
        same = torch.equal(fin, torch.isfinite(out))
        w0, o0 = want.masked_fill(~fin, 0.0), out.masked_fill(~fin, 0.0)
        rms = (w0.square().sum(-1, keepdim=True)
               / fin.sum(-1, keepdim=True).clamp_min(1)).sqrt()
        # each column within 2^-6 of itself: the row term of TOL_TEXT would
        # hide the small columns the top-k cut falls among
        lim = (KERNEL_RTOL * w0.abs() + 2.0 ** -14 * rms).clamp_min(1e-30)
        errs["h2o"].append(float(((o0 - w0).abs() / lim).max())
                           if same else float("inf"))
        return out

    def over(x, y):
        return float((x - y).abs().max()) / (2.0 ** -5 * float(
            y.abs().max()))

    llama.flash_causal_attention = flash
    llama.decode_attention = decode
    llama.quant_fused_attention_group = region
    policy.h2o_kernel = h2o
    try:
        with torch.inference_mode():
            lk, ck = llama.prefill(params, spec, plan, tokens, tl,
                                   attention_impl="kernel",
                                   rng=prng.PRNGKey(0, device=dev))
            lp, _ = llama.prefill(params, spec, plan, tokens, tl,
                                  attention_impl="plain",
                                  rng=prng.PRNGKey(0, device=dev))
            steps = [over(lk, lp)]
            a, b = clone_cache(torch, ck), clone_cache(torch, ck)
            tok = lp.argmax(-1)
            for _ in range(TRAINED_NEW - 1):
                la, a = llama.decode_step(params, spec, plan, a, tok,
                                          attention_impl="kernel",
                                          f32_quant=eng.f32_quant)
                lb, b = llama.decode_step(params, spec, plan, b, tok,
                                          attention_impl="plain",
                                          f32_quant=eng.f32_quant)
                steps.append(over(la, lb))
                tok = lb.argmax(-1)
    finally:
        for n, fn in saved.items():
            setattr(llama, n, fn)
        policy.h2o_kernel = saved_h2o
    return {"kernel_err_over_tol": {k: max(v) if v else None
                                    for k, v in errs.items()},
            "kernel_calls": {k: len(v) for k, v in errs.items()},
            "logits_err_over_limit_by_step": steps}


def _answer_scores(tok, outs, codes) -> tuple:
    """(answers holding the needle's five code words in order, the mean
    share of the five code words each answer holds)."""
    from collections import Counter

    hold, recall = 0, 0.0
    for ids, cw in zip(outs, codes):
        text = tok.decode(ids)
        hold += " ".join(cw) in text
        recall += sum((Counter(text.split()) & Counter(cw)).values()) / len(cw)
    return hold, recall / len(outs)


def logits_f32_timing(torch, dev) -> dict:
    """The lm_head product at Llama-3-8B's and Gemma-2-9B's widths (random
    bf16, rows 1 and 4): f32 output (``models.llama._mm_f32``, the port's)
    against the bf16-rounded product cast to f32 (its earlier product),
    device ms from a CUDA graph of 50 calls, and the largest difference."""
    from pyramidkv_tpu_torch.models import llama

    g = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for name, dm, v, tied in (("llama3-8b", 4096, 128256, False),
                              ("gemma2-9b", 3584, 256000, True)):
        w = (torch.randn((v, dm) if tied else (dm, v), generator=g,
                         device=dev) * 0.02).to(torch.bfloat16)
        wm = w.T if tied else w
        for rows in (1, 4):
            h = torch.randn((rows, dm), generator=g, device=dev).to(
                torch.bfloat16)
            new = llama._mm_f32(h, wm)
            old = (h @ wm).float()
            out[f"{name} rows {rows}"] = {
                "f32_ms": graph_ms(torch, lambda: llama._mm_f32(h, wm), 50),
                "bf16_rounded_ms": graph_ms(torch, lambda: (h @ wm).float(),
                                            50),
                "max_abs_diff": float((new - old).abs().max()),
                "max_abs_logit": float(new.abs().max())}
        del w, wm
        torch.cuda.empty_cache()
    log({"phase": "logits_f32", **out})
    return out


def phase_trained(torch, F, dev):
    """The trained tiny retrieval checkpoint on the card (bf16 weights
    from the port's own numpy loader): the D = 32 kernels at the grid's
    shapes (phase_trained_kernels); for each of the 16 pinned grid
    configurations a B = 1 ``generate`` through the kernels and one through
    the plain path on the pin prompt, with the kernels' launches held to
    trained_expected, kv_cache_bytes to the pin's at bf16, every kernel
    call of a kernel prefill and 15 decode steps held to its plain version
    on the same trained inputs (trained_teacher_forced), and the kernel
    path's tokens to the plain path's: their first difference must come at
    a step whose plain top-2 logit gap is within 2^-5 of the step's
    largest logit (a logit near-tie), or after the two paths' prefill top-k
    kept other slots that all lie within TRAINED_SELECT_TIE of the cut (a
    selection near-tie, selection_ties: a last-bit difference of q or k
    moves such a slot; logged for To check #2); agreement with JAX's f32
    CPU tokens is logged; the greedy loop of each path again with each
    step's logits:
    the f32-head argmax flips (To check #1) and the per-layer keep-set
    agreement of the two paths (To check #2); then the grid batch (3
    contexts x 10 depths, B = 30) on both paths: answers holding the
    needle's code words, prefill s and decode tok/s; last the lm_head's f32
    product at 8B widths (logits_f32_timing).  Returns (ok, kernel records,
    launches per kernel over the phase's kernel-path runs)."""
    from pyramidkv_tpu_torch.config import EngineSpec
    from pyramidkv_tpu_torch.engine import Engine
    from pyramidkv_tpu_torch.train import ToyTokenizer, load_checkpoint
    from pyramidkv_tpu_torch.train import data as tdata

    t0 = time.perf_counter()
    pin = trained_pin()
    tok = ToyTokenizer()
    prompt = pin["prompt"]["ids"]
    own, _ = tdata.needle_prompt(tok, seed=pin["prompt"]["seed"])
    prompts, codes = trained_batch(tok)
    batch_lens = tuple(len(p) for p in prompts)
    ok, krecs = phase_trained_kernels(torch, F, dev, pin, batch_lens)
    spec, params = load_checkpoint(device=dev, dtype=torch.bfloat16)
    w32 = params["embed"].float()
    log({"phase": "trained_load", "spec": spec.name,
         "layers": spec.num_hidden_layers, "heads": [
             spec.num_attention_heads, spec.num_key_value_heads],
         "head_dim": spec.head_dim, "tied": spec.tie_word_embeddings,
         "pin_prompt_is_port_prompt": own == prompt,
         "prompt_tokens": len(prompt)})
    ok &= own == prompt and spec.head_dim == TRAINED_D
    es = dict(max_new_tokens=TRAINED_NEW, prefill_buckets=(TRAINED_BUCKET,))
    launches = {k: 0 for k in TRAINED_KERNELS}
    flips = steps_seen = 0
    summary = {}
    for name, entry in pin["configs"].items():
        cs = trained_comp(entry)
        eng_k = Engine(spec, cs, EngineSpec(**es), params, device=dev)
        eng_p = Engine(spec, cs, EngineSpec(use_pallas=False, **es), params,
                       device=dev)
        reset_counts()
        out_k = eng_k.generate([prompt])
        counts = read_counts()
        out_p = eng_p.generate([prompt])
        want_counts = trained_expected(cs, out_k.decode_steps)
        a, b = out_k.tokens[0], out_p.tokens[0]
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        for k in TRAINED_KERNELS:
            launches[k] += counts[k]
        tk, gk, fk, lk, pk, kv_elems, sk = trained_steps(
            torch, dev, eng_k, prompt, "kernel", w32)
        tp, gp, fp, lp, pp, _, sp = trained_steps(torch, dev, eng_p, prompt,
                                                  "plain", w32)
        ties = selection_ties(sk, sp)
        # the pin's bytes with the K / V buffers in bf16 (the pin's f32
        # run holds them at 4 bytes; codes, scales and zeros are the same)
        want_bytes = entry["kv_cache_bytes"] - 2 * kv_elems
        # kernel against plain logits while the two histories agree
        same_until = TRAINED_NEW if first is None else first + 1
        flips += fk + fp
        steps_seen += len(gk) + len(gp)
        gap = lim = None
        if first is not None:
            gap = gp[first]
            lim = 2.0 ** -5 * float(lp[first].abs().max())
        tf = trained_teacher_forced(torch, dev, eng_k, prompt)
        prefill_err = float((lk[0] - lp[0]).abs().max())
        step_err = [float((x - y).abs().max()) / (2.0 ** -5 * float(
            y.abs().max())) for x, y in zip(lk[:same_until],
                                           lp[:same_until])]
        keep = (None if cs.method == "fullkv" else _keep_share(pk, pp))
        good = (counts == want_counts
                and out_k.kv_cache_bytes == want_bytes
                and out_p.kv_cache_bytes == want_bytes
                and tk == a and tp == b
                and (first is None or gap <= lim
                     or (ties["swapped_slots"] > 0
                         and ties["worst_distance_from_cut"]
                         <= TRAINED_SELECT_TIE))
                and all(x is None or x <= 1
                        for x in tf["kernel_err_over_tol"].values())
                and len(a) == TRAINED_NEW
                and all(bool(torch.isfinite(x).all()) for x in lk))
        rec = {"phase": "trained_pin", "run": name,
               "kernel_tokens": a, "plain_tokens": b,
               "jax_tokens": entry["tokens"],
               "kernel_equals_plain": a == b,
               "kernel_equals_jax": a == entry["tokens"],
               "plain_equals_jax": b == entry["tokens"],
               "first_kernel_plain_difference": first,
               "plain_top2_gap_there": gap, "near_tie_limit": lim,
               "first_kernel_jax_difference": next(
                   (i for i, (x, y) in enumerate(zip(a, entry["tokens"]))
                    if x != y), None),
               "kv_cache_bytes": out_k.kv_cache_bytes,
               "pin_kv_cache_bytes": entry["kv_cache_bytes"],
               "pin_kv_cache_bytes_at_bf16": want_bytes,
               "free_logits_err_over_limit_by_step": step_err,
               "teacher_forced": tf,
               "launches": {k: counts[k] for k in TRAINED_KERNELS},
               "launches_ok": counts == want_counts,
               "prefill_logits_max_abs_err": prefill_err,
               "f32_head_flips": [fk, fp],
               "min_plain_top2_gap": min(gp),
               "keep_share_by_layer": keep,
               "selection": ties,
               "prefill_s": out_k.prefill_seconds,
               "decode_tok_per_s": out_k.decode_steps
               / max(out_k.decode_seconds, 1e-9),
               "ok": good}
        log(rec)
        summary[name] = rec
        ok &= good
        del eng_k, eng_p
    log({"phase": "trained_to_check", "f32_head_flips": flips,
         "steps": steps_seen,
         "kernel_equals_plain": sum(r["kernel_equals_plain"]
                                    for r in summary.values()),
         "kernel_equals_jax": sum(r["kernel_equals_jax"]
                                  for r in summary.values()),
         "plain_equals_jax": sum(r["plain_equals_jax"]
                                 for r in summary.values()),
         "configs": len(summary),
         "min_keep_share": min((min(r["keep_share_by_layer"])
                                for r in summary.values()
                                if r["keep_share_by_layer"]), default=None)})
    # the grid batch on both paths
    for name, entry in pin["configs"].items():
        cs = trained_comp(entry)
        res = {}
        for impl in ("kernel", "plain"):
            eng = Engine(spec, cs, EngineSpec(use_pallas=impl == "kernel",
                                              batch_size=len(prompts), **es),
                         params, device=dev)
            if impl == "kernel":
                reset_counts()
            out = eng.generate(prompts)
            if impl == "kernel":
                counts = read_counts()
                for k in TRAINED_KERNELS:
                    launches[k] += counts[k]
            hold, recall = _answer_scores(tok, out.tokens, codes)
            res[impl] = {"answers_holding_code": hold,
                         "code_word_recall": recall,
                         "prefill_s": out.prefill_seconds,
                         "decode_tok_per_s": len(prompts) * out.decode_steps
                         / max(out.decode_seconds, 1e-9),
                         "tokens": out.tokens}
            del eng
        same = sum(x == y for x, y in zip(res["kernel"]["tokens"],
                                          res["plain"]["tokens"]))
        for impl in res:
            del res[impl]["tokens"]
        log({"phase": "trained_grid", "run": name, "B": len(prompts),
             "contexts": list(TRAINED_CTX), "depths": TRAINED_DEPTHS,
             "answers_equal_kernel_plain": same, **res})
    logits_f32_timing(torch, dev)
    log({"phase": "trained_done", "seconds": time.perf_counter() - t0,
         "launches": launches})
    return ok, krecs, launches


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
           # None where no single PyTorch call computes the function
           "library_ms": (None if any(r["library_ms"] is None for r in recs)
                          else mean("library_ms"))}
    if "bound_unit" in recs[0]:
        ent["bound_unit"] = recs[0]["bound_unit"]
    if "residency_ms" in recs[0]:  # the decode kernel on another plan
        ent["residency"] = recs[0]["residency"]
        ent["residency_ms"] = mean("residency_ms")
    if len(recs) > 1:
        ent["shapes"] = [{k: r[k] for k in (
            "S", "case", "x", "layers", "tail", "Vs", "T", "max_abs_err",
            "visible_pairs", "ms", "bound_unit", "bound_ms_tensor_cores",
            "bound_ms_mufu",
            "partials_ms", "plain_ms", "bound_ms", "library_ms") if k in r}
            for r in recs]
    return ent


def clocks() -> dict:
    """The card's SM clock, its maximum, power draw, temperature and active
    clock-throttle reasons (nvidia-smi): a run whose kernels all read slow
    shows here whether the card was held below its clocks."""
    keys = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu",
            "clocks_throttle_reasons.active")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(keys)}",
         "--format=csv,noheader"], capture_output=True, text=True)
    vals = out.stdout.strip().splitlines()[0].split(", ") if (
        out.returncode == 0 and out.stdout.strip()) else []
    return dict(zip(keys, vals))


def ptxas_report(text: str) -> list:
    """Per entry function of an ``nvcc -Xptxas -v`` log, its registers and
    spill bytes ({"phase": "ptxas", ...}); and each warning line, with
    ptxas's notes that it serialized wgmma products or injected a wait for
    them (C7515, C7517: the products no longer overlap other work)."""
    out, fn = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = {"phase": "ptxas", "function": line.split("'")[1]}
            out.append(fn)
        elif fn is not None and "spill stores" in line:
            fn["spill_stores"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
            fn["spill_loads"] = int(
                line.split("bytes spill loads")[0].split(",")[-1])
        elif fn is not None and "Used" in line and "registers" in line:
            fn["registers"] = int(line.split("Used")[1].split()[0])
        elif "warning" in line.lower() or "(C751" in line:
            out.append({"phase": "ptxas", "warning": line.strip()})
    return out


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
    name_limit = smi.stdout.strip().splitlines()[0]
    print(name_limit, flush=True)
    # the log keeps the power limit too (the output's head may be cut)
    log({"phase": "device", "torch": torch.__version__,
         "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
         "name_power_limit": name_limit, "clocks": clocks()})

    t_last = [time.perf_counter()]

    def stamp(after):
        """Where the run's time goes: seconds since the previous stamp."""
        now = time.perf_counter()
        log({"phase": "elapsed", "after": after,
             "seconds": now - t_last[0]})
        t_last[0] = now

    secs = _build.build_all()
    log({"phase": "build", "seconds": secs})
    # registers and spills of every kernel, and the compilers' warnings
    for name, text in _build.build_log.items():
        for rec in ptxas_report(text):
            log({"library": name, **rec})

    ok, recs = phase_kernels(torch, F, dev)
    stamp("build, flash kernels")
    r, drecs = phase_decode_kernels(torch, F, dev)
    ok &= r
    recs.update(drecs)
    qdecode = {m: drecs["32k " + m] for m in ("snapkv", "fullkv")}
    r, mm_recs, qflash = phase_mm_kernels(torch, F, dev)
    ok &= r
    stamp("decode and matmul kernels")
    r, kv_recs = phase_kv_quant_kernels(torch, F, dev)
    ok &= r
    r, sparse_recs = phase_minference_kernels(torch, F, dev)
    ok &= r
    r, chunk_recs = phase_h2o_chunk_kernels(torch, F, dev)
    ok &= r
    r, tp_recs = phase_two_pass_kernels(torch, F, dev)
    ok &= r
    r, mis_recs = phase_mistral_kernels(torch, F, dev)
    ok &= r
    stamp("kv_quant, minference, h2o_chunk, two_pass, mistral kernels")
    r, qwen_recs = phase_qwen_kernels(torch, F, dev)
    ok &= r
    stamp("qwen kernels")
    r, gemma_recs = phase_gemma_kernels(torch, F, dev)
    ok &= r
    stamp("gemma kernels")
    r, trained_recs, trained_launches = phase_trained(torch, F, dev)
    ok &= r
    stamp("trained checkpoint: D = 32 kernels, pin, grid batch")

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
    r, meth_counts, meth_decode = phase_engine_methods(torch, F, dev, params,
                                                       spec.vocab_size)
    ok &= r
    ok &= phase_parity_methods(torch, dev, params, spec.vocab_size)
    r, _ = phase_decode_engine_masks(torch, F, dev, params, spec.vocab_size)
    ok &= r
    ok &= phase_parity(torch, dev, params, spec.vocab_size)
    ok &= phase_profile(torch, dev, params, spec.vocab_size)
    ok &= phase_profile(torch, dev, params, spec.vocab_size, method="fullkv")
    stamp("llama bf16 engine, methods, parity, profiles")
    r, qcounts, qtok_s, qprefill_s = phase_engine_quant(torch, dev, params,
                                                        spec.vocab_size)
    ok &= r
    for weights in ("int4", "int4-g128"):
        ok &= phase_parity(torch, dev, params, spec.vocab_size, weights)
    q4 = quantized(params, "int4")
    ok &= phase_profile(torch, dev, q4, spec.vocab_size, weights="int4")
    ok &= phase_profile(torch, dev, q4, spec.vocab_size, method="fullkv",
                        weights="int4")
    stamp("llama quantized engine, parity, profiles")
    r, kvcounts, kvtok_s = phase_engine_kv_quant(torch, dev, params, q4,
                                                 spec.vocab_size)
    ok &= r
    ok &= phase_parity_kv_quant(torch, dev, params, spec.vocab_size)
    ok &= phase_profile(torch, dev, q4, spec.vocab_size, method="fullkv",
                        steps=2, weights="int4",
                        kv=dict(quant_method="kivi", nbits=4, q_layout="pa"))
    stamp("llama kivi engine, parity, profile")
    r, mcounts = phase_engine_minference(torch, dev, params, q4,
                                         spec.vocab_size,
                                         qprefill_s["int4 fullkv"])
    ok &= r
    ok &= phase_parity_minference(torch, dev, params, spec.vocab_size)
    ok &= phase_profile_minference(torch, dev, q4, spec.vocab_size)
    stamp("llama minference engine, parity, profile")
    r, ccounts, _ = phase_engine_h2o_chunked(torch, dev, params, q4,
                                             spec.vocab_size)
    ok &= r
    ok &= phase_parity_h2o_chunked(torch, dev, params, spec.vocab_size)
    ok &= phase_profile_h2o_chunked(torch, dev, params, q4, spec.vocab_size)
    r, tcounts = phase_engine_two_pass_prefix(torch, dev, params, q4,
                                              spec.vocab_size)
    ok &= r
    del q4
    stamp("llama h2o, chunked, two-pass and prefix engines")
    # the port's counterpart of bench.py's number (information only: decode
    # is host-bound, see the profile phases)
    base = kvtok_s["int4 fullkv kivi4-pa 32k"]
    log({"phase": "bench_ratio", "snapkv_int4_tok_per_s":
         qtok_s["int4 snapkv"], "fullkv_int4_kivi4pa_tok_per_s": base,
         "ratio": qtok_s["int4 snapkv"] / base})

    # Mistral-7B: the same geometry with a 4096-token sliding window
    del params
    torch.cuda.empty_cache()
    mspec = ModelSpec.preset("mistral-7b", num_hidden_layers=MISTRAL_DEPTH)
    t0 = time.perf_counter()
    params = init_params(mspec, torch.Generator(device=dev).manual_seed(1),
                         dev, torch.bfloat16)
    q4 = quantized(params, "int4")
    torch.cuda.synchronize()
    log({"phase": "init_params_mistral",
         "seconds": time.perf_counter() - t0,
         "gib": tree_gib(params), "int4_gib": tree_gib(q4)})
    r, mis_counts, mrecs = phase_engine_model(
        torch, dev, "mistral", params, q4, mspec.vocab_size)
    ok &= r
    r, more_counts = phase_engine_mistral_more(torch, dev, params, q4,
                                               mspec.vocab_size, mrecs)
    ok &= r
    ok &= phase_parity_model(torch, dev, "mistral", params, mspec.vocab_size)
    mis_counts.update(more_counts)
    del params, q4
    torch.cuda.empty_cache()
    stamp("mistral engine and parity")

    # Qwen2.5-7B: QKV biases, 28 query heads on 4 KV heads (G = 7)
    qspec = ModelSpec.preset("qwen2.5-7b", num_hidden_layers=QWEN_DEPTH)
    t0 = time.perf_counter()
    params = init_params(qspec, torch.Generator(device=dev).manual_seed(2),
                         dev, torch.bfloat16)
    q4 = quantized(params, "int4")
    torch.cuda.synchronize()
    log({"phase": "init_params_qwen", "seconds": time.perf_counter() - t0,
         "gib": tree_gib(params), "int4_gib": tree_gib(q4),
         "bias_leaves": sorted(k for k in q4["layers"] if k.startswith("b"))})
    r, qwen_counts, _ = phase_engine_model(torch, dev, "qwen", params, q4,
                                           qspec.vocab_size)
    ok &= r
    ok &= phase_parity_model(torch, dev, "qwen", params, qspec.vocab_size)
    del params, q4
    torch.cuda.empty_cache()
    stamp("qwen engine and parity")

    # Gemma-2-9B: the logit caps, head dim 256, alternating windows
    gspec = ModelSpec.preset("gemma2-9b")
    t0 = time.perf_counter()
    params = init_params(gspec, torch.Generator(device=dev).manual_seed(3),
                         dev, torch.bfloat16)
    q4 = quantized(params, "int4")
    torch.cuda.synchronize()
    log({"phase": "init_params_gemma", "seconds": time.perf_counter() - t0,
         "gib": tree_gib(params), "int4_gib": tree_gib(q4),
         "leaves": sorted(params["layers"])})
    r, gemma_counts, _ = phase_engine_model(torch, dev, "gemma", params, q4,
                                            gspec.vocab_size)
    ok &= r
    del q4
    torch.cuda.empty_cache()
    ok &= phase_parity_model(torch, dev, "gemma", params, gspec.vocab_size)
    ok &= phase_gemma_reference(torch, F, dev, params)[0]
    del params
    torch.cuda.empty_cache()
    stamp("gemma engine and parity")
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    src = "pyramidkv_tpu_torch/csrc/"
    kernels = [
        kernel_entry(
            "flash_causal_attention", src + "flash_prefill.cu",
            "pyramidkv_tpu/kernels/flash_prefill.py:420",
            sum(c["flash_causal_attention"]
                for c in [*counts.values(), *meth_counts.values()]),
            [recs["flash"]]),
    ]
    for method in ("snapkv", "pyramidkv", "fullkv"):
        shapes = "/".join(str(r["S"]) for r in recs[method])
        g = H // recs[method][0]["Hk"]
        kernels.append(kernel_entry(
            f"decode_attention ({method}, G={g}, S={shapes})",
            src + "decode_attn.cu", "pyramidkv_tpu/kernels/decode_attn.py:69",
            counts[method]["decode_attention"], recs[method]))

    kernels.append(kernel_entry(
        "decode_attention (compression-stack runs, "
        + ", ".join(f"G={r['H'] // r['Hk']} S={r['S']}"
                    for r in meth_decode) + ")",
        src + "decode_attn.cu", "pyramidkv_tpu/kernels/decode_attn.py:69",
        sum(c["decode_attention"] for c in meth_counts.values()),
        meth_decode))

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
    # the factored group kernel replaces the XLA function the TPU engine
    # decodes group regions with by default (no Pallas kernel there)
    kv_tpu = {"quant_decode_attention": "kernels/quant_decode.py:158",
              "quant_decode_attention_tiled": "kernels/quant_decode.py:437",
              "quant_fused_attention_pa": "kernels/quant_fused_decode.py:145",
              "quant_fused_attention_group": "ops/quant.py:408"}
    kv_src = {"quant_fused_attention_pa": "quant_fused_decode.cu",
              "quant_fused_attention_group": "quant_group_fused.cu"}
    for kind in REGION_KERNELS:
        src_file = kv_src.get(kind, "quant_decode.cu")
        kernels.append(kernel_entry(
            f"{kind} ({', '.join(r['case'] for r in kv_recs[kind])})",
            src + src_file, "pyramidkv_tpu/" + kv_tpu[kind],
            sum(c[kind] for c in kvcounts.values()), kv_recs[kind]))
    # launches of each block-sparse kernel per generate at each checked
    # shape: the shapes' weights in the kernels line
    for kind in SPARSE_KERNELS:
        for rec in sparse_recs[kind]:
            rec["layers"] = sum(c[kind] for run, c in mcounts.items()
                                if MINF_RUNS[run][2] == rec["case"])
    bsp_tpu = "pyramidkv_tpu/kernels/block_sparse_prefill.py:"
    for kind, line in (("slash_tile_attention", 120),
                       ("slash_tile_attention_db", 376),
                       ("vertical_attention_partials", 527)):
        kernels.append(kernel_entry(
            kind, src + "block_sparse_prefill.cu", bsp_tpu + str(line),
            sum(c[kind] for c in mcounts.values()), sparse_recs[kind]))
    # H2O and the chunked prefill: each checked shape weighted by the
    # launches the engine runs made there
    def csum(kernel, runs):
        return sum(ccounts[r][kernel] for r in runs)

    h2o_runs = {"8k": ["(a) bf16 h2o 8k"], "32k": ["(b) int4 h2o 32k"]}
    # the h2o gqa run of engine_methods: the 8k batch's shape
    h2o_gqa = {kind: meth_counts["h2o gqa"][kind]
               for kind in ("h2o_row_stats", "h2o_colsum")}
    for kind in ("h2o_row_stats", "h2o_colsum"):
        for rec in chunk_recs[kind]:
            rec["layers"] = csum(kind, h2o_runs[rec["case"]]) + (
                h2o_gqa[kind] if rec["case"] == "8k" else 0)
    q_runs = ["(c) bf16 snapkv 8k chunk 2048", "(d) bf16 h2o 8k chunk 2048"]
    for rec in chunk_recs["q_start"]:  # each chunk index equally often
        rec["layers"] = csum("flash_causal_attention", q_runs) // (N // C8K)
    part_runs = {"32k": "(e) int4 fullkv kivi4-pa 32k chunk 8192",
                 "8k": "(f) bf16 fullkv kivi4 8k chunk 2048"}
    for rec in chunk_recs["flash_attention_partials"]:
        size = rec["case"].split()[0]
        n_self = LAYERS * (QN // C32K if size == "32k" else N // C8K)
        total = ccounts[part_runs[size]]["flash_attention_partials"]
        rec["layers"] = (n_self if "self" in rec["case"]
                         else total - n_self)
    h2o_tpu = "pyramidkv_tpu/kernels/h2o_scores.py:"
    kernels += [
        kernel_entry("h2o_scores (stats)", src + "h2o_scores.cu",
                     h2o_tpu + "35", csum("h2o_row_stats", sum(
                         h2o_runs.values(), [])) + h2o_gqa["h2o_row_stats"],
                     chunk_recs["h2o_row_stats"]),
        kernel_entry("h2o_scores (colsum)", src + "h2o_scores.cu",
                     h2o_tpu + "96", csum("h2o_colsum", sum(
                         h2o_runs.values(), [])) + h2o_gqa["h2o_colsum"],
                     chunk_recs["h2o_colsum"]),
        kernel_entry("flash_attention_partials", src + "flash_prefill.cu",
                     "pyramidkv_tpu/kernels/flash_prefill.py:601",
                     csum("flash_attention_partials", list(ccounts)),
                     chunk_recs["flash_attention_partials"]),
        kernel_entry("flash_causal_attention (q_start, 8k batch, C=2048)",
                     src + "flash_prefill.cu",
                     "pyramidkv_tpu/kernels/flash_prefill.py:420",
                     csum("flash_causal_attention", q_runs),
                     chunk_recs["q_start"]),
        kernel_entry("quant_fused_attention_pa (Gk=4, 32k kivi4-pa chunk "
                     "8192)", src + "quant_fused_decode.cu",
                     "pyramidkv_tpu/kernels/quant_fused_decode.py:145",
                     ccounts["(e) int4 fullkv kivi4-pa 32k chunk 8192"][
                         "quant_fused_attention_pa"],
                     chunk_recs["pa_chunked"])]
    for ent in kernels[-5:-3]:
        ent["library_note"] = ("none: no single PyTorch call computes the "
                               "column sums of a softmax")
    # the two-pass schedule: each shape launched once per layer by its run
    # ((g) at 8k, (h) at 32k)
    tp_runs = [r for r in tcounts if "two-pass" in r]
    for kind, line in (("flash_row_max", 209), ("flash_pass_b", 258)):
        kernels.append(kernel_entry(
            f"{kind} (two_pass=True; 8k batch, 32k)",
            src + "flash_prefill.cu",
            f"pyramidkv_tpu/kernels/flash_prefill.py:{line}",
            sum(tcounts[r][kind] for r in tp_runs), tp_recs[kind]))
    kernels[-2]["library_note"] = tp_recs["flash_row_max"][0][
        "library_note"]
    # Mistral-7B's windowed launches (window 4096), each row's launches
    # summed over the runs at its shape
    def msum(kernel, runs):
        return sum(mis_counts[r][kernel] for r in runs)

    mono = [r for r, x in MISTRAL_RUNS.items() if not x[3]]
    m8 = [r for r in mono if MISTRAL_RUNS[r][2] == "8k"]
    m32 = [r for r in mono if MISTRAL_RUNS[r][2] == "32k"]
    mpart = "mistral int4 fullkv kivi4-pa 32k chunk 8192"
    self_tiles = MISTRAL_DEPTH * (QN // C32K)
    for rec in mis_recs["partials 32k"]:
        rec["layers"] = (self_tiles if rec["q_start"] == 0 else
                         mis_counts[mpart]["flash_attention_partials"]
                         - self_tiles)
    kernels += [
        kernel_entry("flash_causal_attention (Mistral window 4096, 8k batch)",
                     src + "flash_prefill.cu",
                     "pyramidkv_tpu/kernels/flash_prefill.py:420",
                     msum("flash_causal_attention", m8),
                     [mis_recs["flash 8k"]]),
        kernel_entry("flash_causal_attention (Mistral window 4096, B=1, "
                     f"N={QN})", src + "flash_prefill.cu",
                     "pyramidkv_tpu/kernels/flash_prefill.py:420",
                     msum("flash_causal_attention", m32),
                     [mis_recs["flash 32k"]]),
        kernel_entry("flash_attention_partials (Mistral window 4096, 32k "
                     "C=8192: self tiles, history tiles at q_start 8192)",
                     src + "flash_prefill.cu",
                     "pyramidkv_tpu/kernels/flash_prefill.py:601",
                     mis_counts[mpart]["flash_attention_partials"],
                     mis_recs["partials 32k"]),
        kernel_entry("decode_attention (Mistral fullkv window masks, 8k "
                     f"batch S={N + MAX_NEW})", src + "decode_attn.cu",
                     "pyramidkv_tpu/kernels/decode_attn.py:69",
                     mis_counts["mistral bf16 fullkv 8k"][
                         "decode_attention"],
                     mis_recs["decode"][:1]),
        kernel_entry("decode_attention (Mistral minference window masks, "
                     f"32k S={QN + QMAX_NEW})", src + "decode_attn.cu",
                     "pyramidkv_tpu/kernels/decode_attn.py:69",
                     mis_counts["mistral int4 minference 32k"][
                         "decode_attention"],
                     mis_recs["decode"][1:])]
    # Qwen2.5-7B's launches (28 / 4 heads, G = 7), each row's launches
    # summed over the runs at its shape
    def qsum_runs(kernel, size=None):
        return sum(c[kernel] for run, c in qwen_counts.items()
                   if size in (None, QWEN_RUNS[run][2]))

    qpart = "qwen int4 fullkv kivi4-pa 32k chunk 8192"
    for key, run in (("pa 32k", "qwen int4 fullkv kivi4-pa 32k"),
                     ("pa 32k chunk", qpart),
                     ("pa 8k", "qwen bf16 fullkv kivi4-pa 8k")):
        qwen_recs[key]["layers"] = qwen_counts[run][
            "quant_fused_attention_pa"]
    for key, run in (("group 32k", "qwen int4 fullkv kivi4 32k"),
                     ("group 8k", "qwen bf16 fullkv kivi4 8k")):
        qwen_recs[key]["layers"] = qwen_counts[run][
            "quant_fused_attention_group"]
    qline = "pyramidkv_tpu/kernels/"
    kernels += [
        kernel_entry("decode_attention (Qwen2.5-7B fullkv, G=7, 8k batch "
                     f"S={N + MAX_NEW})", src + "decode_attn.cu",
                     qline + "decode_attn.py:69",
                     qwen_counts["qwen bf16 fullkv 8k"]["decode_attention"],
                     qwen_recs["decode"][:1]),
        kernel_entry("decode_attention (Qwen2.5-7B minference's fullkv cache, "
                     f"G=7, 32k S={QN + QMAX_NEW})", src + "decode_attn.cu",
                     qline + "decode_attn.py:69",
                     qwen_counts["qwen int4 minference 32k"][
                         "decode_attention"],
                     qwen_recs["decode"][1:]),
        kernel_entry("quant_fused_attention_group (Qwen2.5-7B fullkv kivi4, "
                     "G=7, 32k and 8k batch)", src + "quant_group_fused.cu",
                     "pyramidkv_tpu/ops/quant.py:408",
                     qsum_runs("quant_fused_attention_group"),
                     [qwen_recs["group 32k"], qwen_recs["group 8k"]]),
        kernel_entry("quant_fused_attention_pa (Qwen2.5-7B fullkv kivi4-pa, "
                     "G=7, 32k; chunk 8192, Gk=4; 8k batch)",
                     src + "quant_fused_decode.cu",
                     qline + "quant_fused_decode.py:145",
                     qsum_runs("quant_fused_attention_pa"),
                     [qwen_recs["pa 32k"], qwen_recs["pa 32k chunk"],
                      qwen_recs["pa 8k"]]),
        kernel_entry("int4_matmul (Qwen2.5-7B widths, 1 row)",
                     src + "int4_matmul.cu", qline + "int4_matmul.py:286",
                     qsum_runs("int4_matmul", "32k"),
                     qwen_recs["int4_matmul"])]
    # Gemma-2-9B's launches (16 / 8 heads of D = 256, scale 1/16, cap 50),
    # each row's launches summed over the runs at its shape
    def gsum(kernel, runs=None):
        return sum(c[kernel] for run, c in gemma_counts.items()
                   if runs is None or run in runs)

    gmono = [r for r, x in GEMMA_RUNS.items()
             if not x[3] and not r.endswith("two-pass")]
    gchunk = [r for r, x in GEMMA_RUNS.items() if x[3]]
    g1 = [r for r in GEMMA_RUNS if "fullkv" not in r]
    for rec in (gemma_recs["flash 8k"], gemma_recs["flash 8k window"]):
        rec["layers"] = GEMMA_LAYERS // 2  # full and sliding layers
    fp = "pyramidkv_tpu/kernels/flash_prefill.py:"
    gemma_rows = [
        kernel_entry("flash_causal_attention (Gemma-2-9B, D=256, cap 50, "
                     "8k batch: full and window 4096 layers)",
                     src + "flash_prefill.cu", fp + "420",
                     gsum("flash_causal_attention", gmono),
                     [gemma_recs["flash 8k"], gemma_recs["flash 8k window"]]),
        kernel_entry("flash_causal_attention (q_start, Gemma-2-9B, D=256, "
                     "cap 50, 8k batch C=2048)", src + "flash_prefill.cu",
                     fp + "420", gsum("flash_causal_attention", gchunk),
                     gemma_recs["q_start"]),
        kernel_entry("flash_row_max (two_pass=True; Gemma-2-9B, D=256, cap "
                     "50, 8k batch)", src + "flash_prefill.cu", fp + "209",
                     gsum("flash_row_max"), [gemma_recs["row_max"]]),
        kernel_entry("flash_pass_b (two_pass=True; Gemma-2-9B, D=256, cap "
                     "50, 8k batch)", src + "flash_prefill.cu", fp + "258",
                     gsum("flash_pass_b"), [gemma_recs["pass_b"]]),
        kernel_entry("decode_attention (Gemma-2-9B per-head caches, D=256, "
                     "cap 50, G=1, 8k batch S=2080)", src + "decode_attn.cu",
                     qline + "decode_attn.py:69",
                     gsum("decode_attention", g1), [gemma_recs["decode g1"]]),
        kernel_entry("decode_attention (Gemma-2-9B fullkv, D=256, cap 50, "
                     f"G=2, 8k batch S={N + MAX_NEW}: full and window masks)",
                     src + "decode_attn.cu", qline + "decode_attn.py:69",
                     gemma_counts["gemma bf16 fullkv 8k"]["decode_attention"],
                     gemma_recs["decode g2"])]
    # H2O and MInference on Gemma-2 (D = 256, cap 50): the H2O kernels on
    # the monolithic h2o run, the block-sparse kernels on the minference
    # run's full layers (db: no Gemma-2 run takes it; its row holds the
    # kernel at the 8k batch all the same)
    gmin = ["gemma bf16 minference 8k"]
    h2o_tpu = "pyramidkv_tpu/kernels/h2o_scores.py:"
    gemma_rows += [
        kernel_entry("h2o_scores (stats; Gemma-2-9B, D=256, scale 1/16, cap "
                     "50, 8k batch)", src + "h2o_scores.cu", h2o_tpu + "36",
                     gsum("h2o_row_stats"), [gemma_recs["h2o_row_stats"]]),
        kernel_entry("h2o_scores (colsum; Gemma-2-9B, D=256, scale 1/16, cap "
                     "50, 8k batch)", src + "h2o_scores.cu", h2o_tpu + "95",
                     gsum("h2o_colsum"), [gemma_recs["h2o_colsum"]])]
    for ent in gemma_rows[-2:]:
        ent["library_note"] = ("none: no single PyTorch call computes the "
                               "column sums of a softmax")
    for kind, line in (("slash_tile_attention", 120),
                       ("slash_tile_attention_db", 376),
                       ("vertical_attention_partials", 527)):
        gemma_rows.append(kernel_entry(
            f"{kind} (Gemma-2-9B, D=256, scale 1/16, cap 50, 8k batch)",
            src + "block_sparse_prefill.cu", bsp_tpu + str(line),
            gsum(kind, gmin), [gemma_recs[kind]]))
    # the KIVI runs (D = 256, cap 50): each shape's launches a step as its
    # weight (fullkv: 21 full and 21 sliding layers)
    gr = gemma_recs["region"]
    for key, rec in gr.items():
        rec["layers"] = GEMMA_LAYERS if "snapkv" in key else GEMMA_LAYERS // 2
    gkv = "gemma bf16 fullkv 8k kivi"
    gpart = gkv + "4 chunk 2048"
    g_self = GEMMA_LAYERS * (N // C8K)
    for rec in gemma_recs["partials"]:
        rec["layers"] = (g_self if rec["q_start"] == 0 else
                         gemma_counts[gpart]["flash_attention_partials"]
                         - g_self)
    gemma_rows += [
        kernel_entry("quant_fused_attention_pa (Gemma-2-9B fullkv kivi4-pa, "
                     "D=256, cap 50, 8k batch: full and window masks; the "
                     "TPU engine's XLA route under a cap)",
                     src + "quant_fused_decode.cu",
                     qline + "quant_fused_decode.py:145",
                     gsum("quant_fused_attention_pa"),
                     [gr["pa full"], gr["pa window"]]),
        kernel_entry("quant_fused_attention_group (Gemma-2-9B snapkv kivi4 "
                     "G=1; fullkv kivi4 chunk 2048, G=2: full and window "
                     "masks; D=256, cap 50)",
                     src + "quant_group_fused.cu",
                     "pyramidkv_tpu/ops/quant.py:408",
                     gsum("quant_fused_attention_group"),
                     [gr["group snapkv"], gr["group fullkv full"],
                      gr["group fullkv window"]]),
        kernel_entry("quant_decode_attention_tiled (Gemma-2-9B fullkv kivi2, "
                     "f32 route, D=256, cap 50: full and window masks)",
                     src + "quant_decode.cu", qline + "quant_decode.py:437",
                     gemma_counts[gkv + "2 f32"][
                         "quant_decode_attention_tiled"],
                     [gr["f32 kivi2 full"], gr["f32 kivi2 window"]]),
        kernel_entry("quant_decode_attention_tiled mm_bf16 (Gemma-2-9B "
                     "fullkv kivi4, K groups of 32, D=256, cap 50: full and "
                     "window masks)", src + "quant_decode_mm_bf16.cu",
                     qline + "quant_decode.py:437",
                     gemma_counts[gkv + "4 mm_bf16"][
                         "quant_decode_attention_tiled"],
                     [gr["mm_bf16 full"], gr["mm_bf16 window"]]),
        kernel_entry("flash_attention_partials (Gemma-2-9B quantized carry, "
                     "D=256, cap 50, 8k batch C=2048: self tiles, history "
                     "tiles; full layers see every earlier chunk)",
                     src + "flash_prefill.cu", fp + "601",
                     gemma_counts[gpart]["flash_attention_partials"],
                     gemma_recs["partials"])]
    for ent in gemma_rows:
        if ent["library_ms"] is not None:
            ent["library_note"] = UNCAPPED_NOTE
    kernels += gemma_rows + [
        kernel_entry("int4_matmul (Gemma-2-9B widths, 4 rows)",
                     src + "int4_matmul.cu", qline + "int4_matmul.py:286",
                     gsum("int4_matmul"), gemma_recs["int4_matmul"])]
    # the trained tiny retrieval checkpoint (D = 32): launches over the
    # phase's kernel-path runs (16 pin generates and 16 grid batches)
    tr = trained_recs
    kernels += [
        kernel_entry("flash_causal_attention (trained tiny retrieval, D=32, "
                     "8 / 4 heads, N=1024: pin B=1, grid B=30)",
                     src + "flash_prefill.cu", fp + "420",
                     trained_launches["flash_causal_attention"], tr["flash"]),
        kernel_entry("decode_attention (trained tiny retrieval, D=32: "
                     + ", ".join(r["case"] for r in tr["decode"]) + ")",
                     src + "decode_attn.cu", qline + "decode_attn.py:69",
                     trained_launches["decode_attention"], tr["decode"]),
        kernel_entry("h2o_scores (stats; trained tiny retrieval, D=32, "
                     "N=1024, W=8: pin B=1, grid B=30)",
                     src + "h2o_scores.cu", h2o_tpu + "36",
                     trained_launches["h2o_row_stats"], tr["h2o_row_stats"]),
        kernel_entry("h2o_scores (colsum; trained tiny retrieval, D=32, "
                     "N=1024, W=8: pin B=1, grid B=30)",
                     src + "h2o_scores.cu", h2o_tpu + "95",
                     trained_launches["h2o_colsum"], tr["h2o_colsum"]),
        kernel_entry("quant_fused_attention_group (trained tiny retrieval "
                     "fullkv kivi8/4/2, D=32, G=2, V rows padded to 64: "
                     "B=1 and B=30)", src + "quant_group_fused.cu",
                     "pyramidkv_tpu/ops/quant.py:408",
                     trained_launches["quant_fused_attention_group"],
                     tr["region"])]
    for ent in kernels[-3:-1]:
        ent["library_note"] = ("none: no single PyTorch call computes the "
                               "column sums of a softmax")
    for k in kernels:  # one line per kernel
        log({"kernel": k["name"], **k})
    log({"phase": "device_end", "clocks": clocks()})
    log({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
