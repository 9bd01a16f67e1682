// Factored-dequantization decode attention over a pa-layout KIVI region
// (sm_90a).  The body is in quant_region.cuh (mode kPA).
//
// Replaces: pyramidkv_tpu/kernels/quant_fused_decode.py::
// quant_fused_attention_pa (Pallas TPU, body `_kernel`) with its adapter
// `region_attention_fused_kernel`.
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
// What the design does about it: the slot-major K codes are read as they lie
// (no entry transpose), one block covers the G query heads of its KV head,
// and the slots are split across blocks (the TPU carried its online softmax
// over a sequential (tile, plane) grid on one core), merged by a finish pass
// in a fixed order.  The per-element work is one FMA per code and query,
// with no scale loads.  Left for later: tensor-core dots (the codes are
// exact in bf16) and a TMA ring.

#include "quant_region.cuh"

// C signature: PKVQ_PARAMS (quant_region.cuh), with NGV = 1 and NG = 1 or
// K groups tiling each plane, each split inside one group.
extern "C" int pkv_quant_fused_pa(PKVQ_PARAMS) {
  if (NGV != 1) return (int)cudaErrorInvalidValue;
  if (NG > 1 && (W % (S_pad / NG) || (S_pad / NG) % rows_per_split ||
                 G * (8 / nbits) > 16))
    return (int)cudaErrorInvalidValue;
  const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask, acc,
                                       m, l, W, S_pad, NG, Dp, NGV, mstride,
                                       n_valid, rows_per_split, scale);
  PKVQ_DISPATCH(G, nbits, return PKVQ_LAUNCH_PA(a));
  return 0;
}
