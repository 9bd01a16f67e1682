// The group-layout KIVI decode kernel in the TPU tiled kernel's mm_bf16
// mode (sm_90a): mode kMix of quant_region.cuh's region_kernel, the
// counterpart of pyramidkv_tpu/kernels/quant_decode.py::
// quant_decode_attention_tiled(mm_bf16=True) (:378-384): the logits from
// the query folded with each K group's scale and rounded to bf16 (the TPU
// kernel's bf16 dot operand; codes are exact in bf16), summed in f32, plus
// the K zero term in f32; P.V over the f32 dequantized V.  What bounds it
// and the design: quant_decode.cu.

#include "quant_region.cuh"

// C signature: PKVQ_PARAMS (quant_region.cuh), as pkv_quant_decode.
PKVQ_REGION_ENTRY(pkv_quant_decode_mm_bf16, pkvq::kMix)
