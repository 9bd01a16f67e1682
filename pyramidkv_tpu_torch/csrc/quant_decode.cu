// Dequantize-and-attend decode kernels over a group-layout KIVI region
// (sm_90a).  The body is in quant_region.cuh.
//
// Replaces:
//   pkv_quant_decode       pyramidkv_tpu/kernels/quant_decode.py::
//                          quant_decode_attention (whole region; Pallas
//                          TPU, body `_kernel`);
//   pkv_quant_decode_tiled pyramidkv_tpu/kernels/quant_decode.py::
//                          quant_decode_attention_tiled (body
//                          `_tiled_kernel`).
// The engine sends a region to the whole-region kernel when the split plan
// (kernels/quant_decode.py::split_plan, ~4 blocks per SM) gives it a single
// split, and to the tiled one otherwise; not by the TPU's 8192-slot VMEM cap.
//
// What they compute: f32 dequantization of every K/V element of the
// region (code * scale + zero, K groups along slots, V groups along
// channels), then the (acc, m, l) partials of one-token attention for the
// G query heads of each KV head, f32 end to end.  Given the step's bf16
// decode tail, the finish pass attends over it too and writes the layer's
// normalised bf16 output: one call per layer per decode step.
//
// What bounds them on the H100: bytes.  Each packed code byte is read once
// and feeds PER slots x G queries; ~1 flop per code bit.  At bench.py's
// 32k fullkv kivi4 the region is 42.2 MB per layer: 12.6 us at 3.35 TB/s.
//
// What the design does about it:
// - the slot-major K codes are read as they lie (the TPU wrapper transposes
//   them at entry, a 16.8 MB copy per layer per step at 32k);
// - one block covers all G query heads of its KV head (the TPU's whole-region
//   kernel runs one grid step per query head and reads the region G times);
// - the tiled kernel splits the slots across blocks, where the TPU carried
//   its softmax state across the sequential grid of one core: B * Hk = 8
//   blocks at 32k would leave 124 of 132 SMs idle.  A finish pass merges the
//   splits in a fixed order.
// Left for later: staging K scales in shared memory (each lane reads its
// group's 2 x 128 f32 scale/zero values through L1), and tensor-core dots.

#include "quant_region.cuh"

// C signature: PKVQ_PARAMS (quant_region.cuh).  Returns a CUDA error code;
// cudaErrorInvalidValue for an unsupported (G, nbits).
extern "C" int pkv_quant_decode(PKVQ_PARAMS) {
  const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask, acc, m, l,
                                       W, S_pad, NG, Dp, NGV, mstride, n_valid, W,
                                       scale);
  PKVQ_DISPATCH(G, nbits, return PKVQ_LAUNCH(false, true, a));
  return 0;
}

extern "C" int pkv_quant_decode_tiled(PKVQ_PARAMS) {
  const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask, acc, m, l,
                                       W, S_pad, NG, Dp, NGV, mstride, n_valid,
                                       rows_per_split, scale);
  PKVQ_DISPATCH(G, nbits, return PKVQ_LAUNCH(false, false, a));
  return 0;
}
