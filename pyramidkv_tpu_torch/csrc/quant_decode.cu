// Decode kernels over a group-layout KIVI region (sm_90a).  The body is
// quant_region.cuh's region_kernel; this file builds its kF32 mode,
// quant_group_fused.cu its kFold mode and quant_decode_mm_bf16.cu its kMix
// mode (three libraries, built in parallel).
//
// Replaces:
//   pkv_quant_decode       pyramidkv_tpu/kernels/quant_decode.py::
//                          quant_decode_attention (whole region; Pallas
//                          TPU, body `_kernel`) on the one-split plan, and
//                          quant_decode_attention_tiled (body
//                          `_tiled_kernel`) on the split plan;
//   pkv_quant_decode_mm_bf16  the same tiled kernel with mm_bf16
//                          (`_tiled_kernel` :378-384: the folded query and
//                          the codes in bf16 dots);
//   pkv_quant_group_fused  the grouped branch of
//                          pyramidkv_tpu/ops/quant.py::
//                          quant_region_attention_fused (:495-515,
//                          :549-569), which the TPU engine leaves to XLA:
//                          its DEFAULT decode of a group-layout region
//                          (models/llama.py:957-971).
// At D = 256 under Gemma-2's logit cap the TPU engine runs the XLA
// function (the default) or the tiled kernel (opt-in; its whole-region
// kernel refuses a cap, models/llama.py:972-980), each with the scale and
// the cap: the port runs every route here on the card.
// The plan (kernels/quant_decode.py::split_plan: ~4 blocks per SM, from the
// shapes alone) cuts each region's byte-rows into nsplit splits; not the
// TPU's 8192-slot VMEM cap.
//
// What they compute: the (acc, m, l) partials of one-token attention over
// the region for the G query heads of each KV head (K groups along slots, V
// groups along channels).  pkv_quant_decode (mode kF32, the TPU engine's
// opt-in use_quant_kernel / use_quant_tiled route) dequantizes every K/V
// element in f32 (code * scale + zero), f32 end to end;
// pkv_quant_decode_mm_bf16 takes kFold's logits and kF32's P.V.
// pkv_quant_group_fused (mode kFold, the default) rounds as the XLA
// function does: the query folded with each slot's K group scale and
// rounded to bf16, the K zero term in f32; the probability folded with each
// channel group's V scale and rounded to bf16, the V zero term in f32.
// Given the step's bf16 decode tail, the call attends over it too and
// writes the layer's normalised bf16 output: one call per layer per decode
// step, one launch up to MAX_CLUSTER splits (a thread-block cluster merges
// them), two beyond (a merge kernel).
//
// What bounds them on the H100: bytes.  Each packed code byte is read once
// and feeds PER slots x G queries; ~1 flop per code bit (kFold: ~2).  At
// bench.py's 32k fullkv kivi4 the region is 42.2 MB per layer: 12.6 us at
// 3.35 TB/s.
//
// What the design does about it:
// - the slot-major K codes are read as they lie (the TPU wrapper transposes
//   them at entry, a 16.8 MB copy per layer per step at 32k);
// - one block covers all G query heads of its KV head (the TPU's whole-region
//   kernel runs one grid step per query head and reads the region G times);
// - the slots are split across blocks, where the TPU carried its softmax
//   state across the sequential grid of one core: B * Hk = 8 blocks at 32k
//   would leave 124 of 132 SMs idle; the splits merge in a fixed order;
// - a cp.async ring streams each split's code rows and V scales; 8 lanes
//   take a byte-row (16 channels each), so a code costs one or two FMAs per
//   query and no scale load from global memory: the K scale / zero columns
//   (kF32) or the query folded with them (kFold) of the K groups a split
//   touches are staged in shared memory first (a long region on one split,
//   whose tables exceed shared memory, stages them a window of rows at a
//   time).
// Left for later: tensor-core dots.

#include "quant_region.cuh"

// C signature: PKVQ_PARAMS (quant_region.cuh); nsplit and rows_per_split
// are the plan (one split: rows_per_split = W).  Returns a CUDA error code;
// cudaErrorInvalidValue for an unsupported (D, cap, G, nbits) or plan.
PKVQ_REGION_ENTRY(pkv_quant_decode, pkvq::kF32)
