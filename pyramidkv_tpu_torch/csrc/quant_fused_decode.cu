// Factored-dequantization decode attention over a pa-layout KIVI region
// (sm_90a).  The body is in quant_region.cuh (mode kPA).
//
// Replaces: pyramidkv_tpu/kernels/quant_fused_decode.py::
// quant_fused_attention_pa (Pallas TPU, body `_kernel`) with its adapter
// `region_attention_fused_kernel`.  Under Gemma-2's logit cap the TPU
// engine does not run that kernel (`supports_fused_kernel` refuses a cap)
// but pyramidkv_tpu/ops/quant.py::quant_region_attention_fused in XLA, with
// the scale and the cap: at D = 256 capped this kernel is the CUDA
// counterpart of that XLA route.
//
// What it computes: the (acc, m, l) partials of one-token attention over a
// per-axis region (one K scale/zero per channel, or per channel and chunk
// after a chunked prefill; one V scale/zero per slot)
// without dequantizing it: the K scale folds into the query (q * scale * ks,
// rounded to bf16, as the TPU kernel's bf16 dot operand), the K zero into
// a logit bias scale * (q . kz); the V scale folds into the probabilities
// (p * vs, rounded to bf16), and the V zero becomes a per-row scalar
// sum_t p_t vz_t, rescaled with the online softmax and added to every
// channel at the end.  The folds run inside the kernel (the TPU adapter ran
// them in XLA before its call).  Given the step's bf16 decode tail, the
// finish pass attends over it too and writes the layer's normalised bf16
// output (the TPU path merged the tail in XLA).
//
// What bounds it on the H100: bytes.  The region is codes + one f32
// scale/zero pair per slot: 35.9 MB per layer at bench.py's 32k fullkv
// kivi4-pa, 10.7 us at 3.35 TB/s.
//
// What the design does about it (quant_region.cuh, pa_split_kernel):
// - the slot-major K codes are read as they lie (no entry transpose); one
//   block covers the G query heads of its KV head; the slots are split
//   across blocks in whole 64-row quanta, 16 rows to each of 4 warps
//   in turn (the TPU carried its online softmax over a sequential (tile,
//   plane) grid on one core), so a split's warps get equal rows, and a
//   split never crosses a K group;
// - each warp streams its units' K codes, V codes, V scales and
//   zeros through its own 3-stage cp.async ring (16-byte copies with
//   constant trip counts; the next unit's mask bytes loaded a unit ahead),
//   so a split's bytes are in flight together;
// - both dots run on the tensor cores (mma.sync m16n8k16, the G heads on
//   the M side): the codes are exact in bf16 after a few bit operations a
//   pair, the folded query and the V-scaled probabilities are already bf16
//   (exact products, f32 sums), so a code costs ~1.5 instructions instead
//   of a conversion and G FMAs;
// - the folded queries (one per <= 4-bit field of a code byte) sit in
//   dynamic shared memory as ready A fragments, so any G, nbits and K
//   groups fit (the earlier kernel refused G * 8 / nbits > 16 with K
//   groups);
// - the finish pass (pa_finish_kernel), launched as a programmatic
//   dependent, attends over the bf16 tail while the splits run, then merges
//   them in split order: no atomics, two calls bitwise equal.

#include "quant_region.cuh"

// C signature: PKVQ_PARAMS (quant_region.cuh), with NGV = 1 and NG = 1 or
// K groups tiling each plane; the nsplit splits of rows_per_split byte-rows
// tile each K group's byte-rows (the whole plane with one group).
extern "C" int pkv_quant_fused_pa(PKVQ_PARAMS) {
  const int seg = NG > 1 ? S_pad / NG : W;  // byte-rows of a K group
  // the K code rows go by 16-byte copies: 16-byte aligned
  if (NGV != 1 || rows_per_split < 1 || seg < 1 || W % seg ||
      reinterpret_cast<uintptr_t>(kc) % 16 ||
      nsplit != W / seg * ((seg + rows_per_split - 1) / rows_per_split))
    return (int)cudaErrorInvalidValue;
  const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask, acc,
                                       m, l, W, S_pad, NG, Dp, NGV, mstride,
                                       n_valid, rows_per_split, scale,
                                       softcap);
  PKVQ_DISPATCH(D, softcap > 0.f, G, nbits, return PKVQ_LAUNCH_PA(a));
  return 0;
}
