// The factored-dequantization decode kernel over a group-layout KIVI
// region (sm_90a): mode kFold of quant_region.cuh's region_kernel, the
// counterpart of the grouped branch of pyramidkv_tpu/ops/quant.py::
// quant_region_attention_fused (XLA; the TPU engine's default group route).
// What it computes, what bounds it and the design: quant_decode.cu.

#include "quant_region.cuh"

// C signature: PKVQ_PARAMS (quant_region.cuh), as pkv_quant_decode.
PKVQ_REGION_ENTRY(pkv_quant_group_fused, pkvq::kFold)
