// Decode kernels over a group-layout KIVI region (sm_90a).  The body is in
// quant_region.cuh.
//
// Replaces:
//   pkv_quant_decode       pyramidkv_tpu/kernels/quant_decode.py::
//                          quant_decode_attention (whole region; Pallas
//                          TPU, body `_kernel`);
//   pkv_quant_decode_tiled pyramidkv_tpu/kernels/quant_decode.py::
//                          quant_decode_attention_tiled (body
//                          `_tiled_kernel`);
//   pkv_quant_group_fused, pkv_quant_group_fused_tiled
//                          the grouped branch of
//                          pyramidkv_tpu/ops/quant.py::
//                          quant_region_attention_fused (:495-515,
//                          :549-569), which the TPU engine leaves to XLA:
//                          its DEFAULT decode of a group-layout region
//                          (models/llama.py:957-971).
// The engine sends a region to a whole-region kernel when the split plan
// (kernels/quant_decode.py::split_plan, ~4 blocks per SM) gives it a single
// split, and to the split one otherwise; not by the TPU's 8192-slot VMEM cap.
//
// What they compute: the (acc, m, l) partials of one-token attention over
// the region for the G query heads of each KV head (K groups along slots, V
// groups along channels).  pkv_quant_decode[_tiled] (mode kF32, the TPU
// engine's opt-in use_quant_kernel / use_quant_tiled route) dequantize
// every K/V element in f32 (code * scale + zero), f32 end to end.
// pkv_quant_group_fused[_tiled] (mode kFold, the default) round as the XLA
// function does: the query folded with each slot's K group scale and
// rounded to bf16, the K zero term in f32; the probability folded with each
// channel group's V scale and rounded to bf16, the V zero term in f32.
// Given the step's bf16 decode tail, the call attends over it too and
// writes the layer's normalised bf16 output: one call per layer per decode
// step, one launch on the whole-region plan (whole_kernel), two on the
// split plan (split_kernel, then finish_kernel).
//
// What bounds them on the H100: bytes.  Each packed code byte is read once
// and feeds PER slots x G queries; ~1 flop per code bit (kFold: ~2, the
// folds cost a multiply and a rounding per code and query).  At bench.py's
// 32k fullkv kivi4 the region is 42.2 MB per layer: 12.6 us at 3.35 TB/s.
//
// What the design does about it:
// - the slot-major K codes are read as they lie (the TPU wrapper transposes
//   them at entry, a 16.8 MB copy per layer per step at 32k);
// - one block covers all G query heads of its KV head (the TPU's whole-region
//   kernel runs one grid step per query head and reads the region G times);
// - the split kernels split the slots across blocks, where the TPU carried
//   its softmax state across the sequential grid of one core: B * Hk = 8
//   blocks at 32k would leave 124 of 132 SMs idle.  A finish pass merges the
//   splits in a fixed order;
// - kFold folds in registers, per slot, what the XLA function materialises
//   as [G, D, groups] folded queries and [G, W, groups] folded
//   probabilities.
// - whole_kernel (the whole-region plan) gives each 64-row region all 8
//   warps (8 lanes a row) and stages the K scale / zero columns in shared
//   memory; bench.py's 32k snapkv kivi4 decodes in one launch at SDPA's
//   time.
// Left for later: the split kernels' lane-per-row body (K scales through
// L1), and tensor-core dots.

#include "quant_region.cuh"

// C signature: PKVQ_PARAMS (quant_region.cuh).  Returns a CUDA error code;
// cudaErrorInvalidValue for an unsupported (G, nbits).
extern "C" int pkv_quant_decode(PKVQ_PARAMS) {
  const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask, acc, m, l,
                                       W, S_pad, NG, Dp, NGV, mstride, n_valid, W,
                                       scale);
  PKVQ_DISPATCH(G, nbits, return PKVQ_LAUNCH(pkvq::kF32, true, a));
  return 0;
}

extern "C" int pkv_quant_decode_tiled(PKVQ_PARAMS) {
  const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask, acc, m, l,
                                       W, S_pad, NG, Dp, NGV, mstride, n_valid,
                                       rows_per_split, scale);
  PKVQ_DISPATCH(G, nbits, return PKVQ_LAUNCH(pkvq::kF32, false, a));
  return 0;
}

extern "C" int pkv_quant_group_fused(PKVQ_PARAMS) {
  const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask, acc, m, l,
                                       W, S_pad, NG, Dp, NGV, mstride, n_valid, W,
                                       scale);
  PKVQ_DISPATCH(G, nbits, return PKVQ_LAUNCH(pkvq::kFold, true, a));
  return 0;
}

extern "C" int pkv_quant_group_fused_tiled(PKVQ_PARAMS) {
  const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask, acc, m, l,
                                       W, S_pad, NG, Dp, NGV, mstride, n_valid,
                                       rows_per_split, scale);
  PKVQ_DISPATCH(G, nbits, return PKVQ_LAUNCH(pkvq::kFold, false, a));
  return 0;
}
