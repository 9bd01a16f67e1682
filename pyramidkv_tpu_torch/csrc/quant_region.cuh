// Shared body of the KIVI region decode kernels (sm_90a):
// quant_decode.cu, quant_group_fused.cu and quant_decode_mm_bf16.cu (group
// layout, any plan: f32 dequantization, the factored dequantization with
// bf16 folds, or the folded logits with the f32 dequantized P.V) and
// quant_fused_decode.cu (pa layout, split over slots).
//
// Every kernel is a template on the head dim D and a logit cap CAP
// (Gemma-2's cap * tanh(s / cap) on each logit after the K zero term, the
// masks after it; tanh.approx.f32): D = 128 uncapped (Llama, Mistral,
// Qwen2) for G in {1, 2, 4, 7, 8}, D = 256 capped (Gemma-2-9B) for G in
// {1, 2}.  The attention scale is an argument.
//
// The region of one (batch row, KV head), as ops/quant.py::quantize_kv_region
// lays it out (W = plane width in slots, PER = 8 / NBITS planes, S_pad = W *
// PER, slot s = j + p * W lives in byte-row j, bit-plane p):
//   kc [W, D]        int8 (uint8 meaning), slot-major, read as it lies;
//   ks, kz [D, NG]   f32, K slot-group scale/zero (group of slot s: s / kg);
//   vc [W, Dp]       int8, V codes packed along slots;
//   vs, vz [S_pad, NGV] f32, V channel-group scale/zero (channel e: e / vg);
//   mask             bool, slot s visible iff s < n_valid and mask[s].
// The pa layout is NGV = 1 (vg = Dp) and NG = 1 (kg = S_pad), or NG > 1 K
// slot groups that tile each bit-plane (W % kg == 0: the chunked prefill's
// carry, one group per chunk); a split then lies inside one group's
// byte-rows (rows_per_split divides kg), and plane p's slots fold the
// query of group p * W / kg + row0 / kg.
//
// Output: e-domain online-softmax partials (acc [G, D], m [G], l [G]) of the
// G query heads of the KV head, out = acc / l after merging with other
// partials.  m is the true max logit (float32.min when every slot is masked,
// and then l = 0 and acc = 0), so the caller merges it with the bf16 decode
// tail in one domain; or, given the step's bf16 decode tail, the layer's
// normalised bf16 output over region and tail.
//
// Two kernels:
// - the pa layout (mode kPA): pa_split_kernel splits the byte-rows across
//   blocks (4 warps, each streaming its 16-row units through its own
//   cp.async ring; both products on the tensor cores, codes turned into
//   bf16 by bit operations) and pa_finish_kernel, a programmatic dependent
//   launch, attends over the tail, merges the splits in a fixed order and
//   writes the output;
// - the group layout (modes kF32 and kFold): region_kernel, on any plan
//   (below).

#pragma once

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pkvq {

constexpr int NWARPS = 8;
constexpr int CHUNK = 32;  // byte-rows per warp iteration (one per lane)
constexpr float NEG = -FLT_MAX;
constexpr unsigned FULL = 0xffffffffu;

// How a region's affine dequantization enters the attention:
// kF32   every K/V element dequantized in f32 (code * scale + zero), as
//        ops/quant.py::quant_decode_attention_plain;
// kPA    the pa layout's factored form, as
//        ops/quant.py::quant_region_attention_fused with one V group: the
//        K scale folded into bf16 queries held in shared memory (one per
//        bit-plane, with the K group of the split's rows), the K zero a
//        logit bias,
//        the V scale folded into bf16 probabilities, the V zero a
//        separately rescaled scalar;
// kFold  the group layout's factored form, the same function's grouped
//        branch: per slot, the query folded with the slot's K group scale
//        and rounded to bf16 (q * scale * ks[d, group]), the K zero term
//        q * scale . kz[:, group] in f32; per slot and lane, the
//        probability folded with the V scale of the lane's channel group
//        and rounded to bf16, the V zero term p * vz in f32;
// kMix   mm_bf16 (the TPU tiled kernel's bf16 dots): kFold's logits,
//        kF32's P.V.
enum Mode { kF32 = 0, kPA = 1, kFold = 2, kMix = 3 };

struct Args {
  const __nv_bfloat16* q;  // [B, Hk * G, D]
  const int8_t* kc;        // [B * Hk, W, D]
  const float* ks;         // [B * Hk, D, NG]
  const float* kz;
  const int8_t* vc;        // [B * Hk, W, Dp]
  const float* vs;         // [B * Hk, S_pad, NGV]
  const float* vz;
  const uint8_t* mask;     // row b * Hk + kvh at (b * Hk + kvh) * mstride
  float* acc;              // [B * Hk * nsplit, G, D]
  float* m;                // [B * Hk * nsplit, G]
  float* l;
  int W, NG, kg, Dp, NGV, vg, mstride, n_valid, rows_per_split;
  int win_rows;  // region_kernel: byte-rows a staging of the K tables covers
  float scale;
  float softcap;  // the logit cap (read where the kernel's CAP is set)
};

// The bf16 decode-slot tail of one decode step (T = 0: none): K and V
// [B * Hk, T, D] bf16; slot t of region bk visible iff mask[bk * mstride + t].
struct Tail {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* mask;
  int T, mstride;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The logit cap, cap * tanh(s / cap) (inv = 1 / cap), tanh on the MUFU
// (one instruction; relative error about 2^-11), as the flash, decode and
// H2O kernels cap.
__device__ __forceinline__ float cap_logit(float s, float cap, float inv) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(s * inv));
  return cap * y;
}

// ---------------------------------------------------------------------------
// Asynchronous copies (both layouts' rings)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// The pa layout: pa_split_kernel + pa_finish_kernel.
//
// pa_split_kernel runs both products on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate), the G query heads on the M side (rows
// G..15 zero), as the TPU kernel's MXU dots:
// - S = Qf Kc^T: A the folded query (bf16, a copy per bit-plane in dynamic
//   shared memory), B the K codes of 8 byte-rows (n) along 16 channels (k);
// - O += P Vc: A = P straight from S's accumulator layout (rows = heads,
//   k = 16 byte-rows: two n-tiles of S), B the V codes of the 16 byte-rows
//   along 8 channels a tile (D / 8 tiles).
// Heads on M waste rows (3/4 at G = 4), but P never moves between lanes;
// with slots on M the accumulator of S is the transpose of P V's B operand.
// A code becomes bf16 by bit operations alone: its bits under 0x43 (bf16
// 128 + code, codes of at most 4 bits), for the logits less 128 (one bf16x2
// subtraction for two codes), for P V as it is, 128 times the sum of P
// taken off at the end; an 8-bit code is two 4-bit fields, the high one
// against the query (or P) times 16 (exact in bf16).  Products of bf16
// values and codes are exact; only the f32 sums run in another order than
// the plain version's.
// ---------------------------------------------------------------------------

constexpr int PA_WARPS = 4;     // warps a block
constexpr int PA_UNIT = 16;     // byte-rows a warp takes at a time
constexpr int PA_STAGES = 3;    // units in flight a warp

// Blocks an SM (the plan's one wave): two at D = 128; one at D = 256,
// whose rings take ~116 KB a block.
template <int D>
__host__ __device__ constexpr int pa_blocks() {
  return D == 128 ? 2 : 1;
}

// Padded bytes of a staged code row.
template <int D>
__host__ __device__ constexpr int pa_row() {
  return D + 16;
}

// 16-byte A fragments of a folded query row (D / 4 and a pad).
template <int D>
__host__ __device__ constexpr int fq_quads() {
  return D / 4 + 1;
}

// The <= 4-bit fields of a code byte: nbits 2 and 4 one per bit-plane; 8
// the low and the high nibble of its one plane.
template <int NBITS>
__host__ __device__ constexpr int pa_fields() {
  return NBITS == 8 ? 2 : 8 / NBITS;
}

// One ring stage: K and V codes [PA_UNIT][pa_row], then the unit's V
// scales and zeros [PER][PA_UNIT] f32 each.
template <int NBITS, int D>
__host__ __device__ constexpr int pa_stage_bytes() {
  return 2 * PA_UNIT * pa_row<D>() + 2 * (8 / NBITS) * PA_UNIT * 4;
}

// Dynamic shared memory of a block: the warps' rings (their merge states
// afterwards), the folded queries [fields][G][fq_quads] A fragments and
// the warps' sums of the K zero terms [PA_WARPS][PER][G] f32.
template <int G, int NBITS, int D>
__host__ __device__ constexpr int pa_smem_bytes() {
  return PA_WARPS * PA_STAGES * pa_stage_bytes<NBITS, D>() +
         pa_fields<NBITS>() * G * fq_quads<D>() * 16 +
         PA_WARPS * (8 / NBITS) * G * 4;
}

// Two codes (bytes of `y` picked by `sel`, the other bytes 0x43) as bf16x2.
__device__ __forceinline__ uint32_t code2(uint32_t y, uint32_t sel) {
  uint32_t x;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(x) : "r"(y), "r"(0x43434343u), "r"(sel));
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  v = __hsub2(v, __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// The same two codes as bf16 128 + code: P V takes them so (one
// instruction less a pair) and takes 128 times the sum of P off its rows at
// the end.  The offset is exact in every product; in the f32 sums it costs
// a few low bits of the accumulator, far inside the output's limit (the
// logits keep code2: their limit is tighter).
__device__ __forceinline__ uint32_t code2_128(uint32_t y, uint32_t sel) {
  uint32_t x;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(x) : "r"(y), "r"(0x43434343u), "r"(sel));
  return x;
}

// The sum of a bf16x2's two values.
__device__ __forceinline__ float sum2(uint32_t x) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return f.x + f.y;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t x;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(x) : "r"(a), "r"(b), "r"(sel));
  return x;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += A B, m16n8k16; A = {a0, a1, a2, a3} as the fragment registers hold
// it (here a1 = a3 = 0: rows 8-15 are no head), kept whole so no register
// moves assemble it for each product
__device__ __forceinline__ void mma_g(float (&c)[4], const uint4& a,
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The same product keeping rows 0-7 (the heads) alone: rows 8-15 of A are
// zero, so their sums are scratch registers, not held across products (at
// D = 256 the P V accumulators would otherwise take 128 registers)
__device__ __forceinline__ void mma_g(float (&c)[2], const uint4& a,
                                      uint32_t b0, uint32_t b1) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%10};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1),
        "f"(0.f));
  (void)d2;
  (void)d3;
}

// The byte-rows of split `sp` of a region: the splits tile each K group's
// byte-rows (`seg` of them; the whole plane with one group), `rows` a split
// (the last of each group shorter).
__device__ __forceinline__ int2 pa_split_rows(int sp, int rows, int seg,
                                              int W) {
  const int sps = (seg + rows - 1) / rows;  // splits a group
  const int r0 = (sp / sps) * seg + (sp % sps) * rows;
  return make_int2(r0, min(min(r0 + rows, (sp / sps + 1) * seg), W));
}

// grid (B * Hk, nsplit), PA_WARPS warps, pa_smem_bytes<G, NBITS, D>() of
// dynamic shared memory.  Block (bk, sp) attends over its split's byte-rows
// (all PER planes) and writes its partials to workspace slot
// bk * nsplit + sp.  The split's 16-row units go to the warps in turn (unit
// u to warp u % PA_WARPS); each warp streams its own units through its own
// ring of PA_STAGES stages (cp.async, no block barrier) and keeps its own
// online softmax (e-domain; p = exp(s - m) at the warp's running max); the
// warps merge in order at the end.  A lane of an S tile covers D / 4
// channels of its byte-row (D / 16 k steps of 4 channels each), a lane of
// the P V tiles D / 8.
template <int G, int NBITS, int D, bool CAP>
__global__ void __launch_bounds__(PA_WARPS * 32, pa_blocks<D>())
pa_split_kernel(Args a) {
  constexpr int PER = 8 / NBITS;
  constexpr int NF = pa_fields<NBITS>();
  constexpr int FB = NBITS < 4 ? NBITS : 4;  // bits of a field
  constexpr uint32_t M8 = ((1u << FB) - 1u) * 0x01010101u;
  constexpr int STAGE = pa_stage_bytes<NBITS, D>();
  constexpr int ROW = pa_row<D>();
  constexpr int FQ = fq_quads<D>();
  constexpr int CPT = D / (PA_WARPS * 32);  // channels a thread folds
  constexpr int NT = D / 8;                 // P V n-tiles
  extern __shared__ __align__(16) uint8_t smem[];

  const int bk = blockIdx.x, sp = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int W = a.W, Dp = a.Dp;
  const int2 rr = pa_split_rows(sp, a.rows_per_split, a.NG > 1 ? a.kg : W, W);
  const int row0 = rr.x, row1 = rr.y;
  const int nunits = (row1 - row0 + PA_UNIT - 1) / PA_UNIT;
  const int nu = nunits > warp ? (nunits - warp + PA_WARPS - 1) / PA_WARPS : 0;
  uint8_t* ring = smem + warp * PA_STAGES * STAGE;
  // the folded queries as A fragments {a0, 0, a2, 0}: quad (f G + g) FQ +
  // (D / 16) tig + kk holds channels (D / 4) tig + 4 kk + {0, 1} and {2, 3}
  uint4* fq = reinterpret_cast<uint4*>(smem + PA_WARPS * PA_STAGES * STAGE);
  // the K zero terms' partial sums [PA_WARPS][PER][G]
  float* zb = reinterpret_cast<float*>(fq + NF * G * FQ);

  const char* kcb = reinterpret_cast<const char*>(a.kc) + (size_t)bk * W * D;
  const char* vcb = reinterpret_cast<const char*>(a.vc) + (size_t)bk * W * Dp;
  const float* vsb = a.vs + (size_t)bk * W * PER;
  const float* vzb = a.vz + (size_t)bk * W * PER;
  // V rows copy 16 bytes at a time where they lie 16-byte aligned, 4 where
  // 4-byte aligned, else byte by byte (an odd V row: plain loads)
  const int vstep = (Dp % 16 == 0 && reinterpret_cast<uintptr_t>(vcb) % 16 == 0)
                        ? 16
                        : (Dp % 4 == 0 && reinterpret_cast<uintptr_t>(vcb) % 4 == 0)
                              ? 4
                              : 1;
  // this warp's unit i into stage i % PA_STAGES (one commit group a unit;
  // empty past the warp's units); rows past the split are not copied
  auto issue = [&](int i) {
    if (i < nu) {
      uint8_t* st = ring + (i % PA_STAGES) * STAGE;
      const int ur0 = row0 + (warp + i * PA_WARPS) * PA_UNIT;
      const int nr = min(PA_UNIT, row1 - ur0);
      uint8_t* vd = st + PA_UNIT * ROW;
#pragma unroll
      for (int j = 0; j < PA_UNIT * (D / 16) / 32; ++j) {
        const int c = lane + 32 * j, r = c / (D / 16), o = (c % (D / 16)) * 16;
        if (r < nr) {
          cp_async16(st + r * ROW + o, kcb + (size_t)(ur0 + r) * D + o);
          if (vstep == 16)
            cp_async16(vd + r * ROW + o, vcb + (size_t)(ur0 + r) * Dp + o);
        }
      }
      if (vstep == 4) {
        for (int c = lane; c < nr * (D / 4); c += 32)
          cp_async4(vd + (c / (D / 4)) * ROW + (c % (D / 4)) * 4,
                    vcb + (size_t)(ur0 + c / (D / 4)) * Dp + (c % (D / 4)) * 4);
      } else if (vstep == 1) {
        for (int c = lane; c < nr * (D / 4); c += 32) {
          const uint8_t* s = reinterpret_cast<const uint8_t*>(vcb) +
                             (size_t)(ur0 + c / (D / 4)) * Dp + (c % (D / 4)) * 4;
          *reinterpret_cast<uint32_t*>(vd + (c / (D / 4)) * ROW + (c % (D / 4)) * 4) =
              (uint32_t)s[0] | (uint32_t)s[1] << 8 | (uint32_t)s[2] << 16 |
              (uint32_t)s[3] << 24;
        }
      }
      // V scales, then zeros: [PER][PA_UNIT] each, slot r + p * W; piece
      // c = (z PER + p) PA_UNIT + r
      float* sc = reinterpret_cast<float*>(st + 2 * PA_UNIT * ROW);
#pragma unroll
      for (int j = 0; j < (2 * PER * PA_UNIT + 31) / 32; ++j) {
        const int c = lane + 32 * j;
        const int z = c / (PER * PA_UNIT), p = (c / PA_UNIT) % PER;
        const int r = c % PA_UNIT;
        if (c < 2 * PER * PA_UNIT && r < nr)
          cp_async4(sc + c, (z ? vzb : vsb) + ur0 + r + p * W);
      }
    }
    cp_async_commit();
  };
  // the folded queries: field f of head g, channel d, bf16(q * scale *
  // ks[d, group of plane p]) (times 16 for 8-bit codes' high nibble), the
  // group of plane p's slots in this split's byte-rows p * W / kg +
  // row0 / kg; and the K zero terms scale * (q . kz[:, group]), f32.  A
  // thread takes CPT channels (tid + 128 i): its loads (G query values, PER
  // scales and zeros each) go out first, ahead of the ring's first copies in
  // the memory system, and land while those are issued
  const int gpl = W / a.kg, gsp = row0 / a.kg;
  __nv_bfloat16 qraw[CPT][G];
  float ksd[CPT][PER], kzd[CPT][PER];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int ch = tid + PA_WARPS * 32 * i;
#pragma unroll
    for (int g = 0; g < G; ++g) qraw[i][g] = a.q[((size_t)bk * G + g) * D + ch];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const size_t o = ((size_t)bk * D + ch) * a.NG + p * gpl + gsp;
      ksd[i][p] = a.ks[o];
      kzd[i][p] = a.kz[o];
    }
  }
  for (int i = 0; i < PA_STAGES - 1; ++i) issue(i);
  float qd[CPT][G];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) qd[i][g] = __bfloat162float(qraw[i][g]) * a.scale;
  __nv_bfloat16* fqh = reinterpret_cast<__nv_bfloat16*>(fq);
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    // this channel's place in its quad (the zero beside it too)
    const int ch = tid + PA_WARPS * 32 * i;
    const int fpos = ((ch / (D / 4)) * (D / 16) + (ch % (D / 4)) / 4) * 8 +
                     (ch & 1) + ((ch >> 1) & 1) * 4;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float x = bf16_round(qd[i][g] * ksd[i][NBITS == 8 ? 0 : f]);
        __nv_bfloat16* q8 = fqh + (f * G + g) * FQ * 8 + fpos;
        q8[0] = __float2bfloat16(NBITS == 8 && f == 1 ? 16.f * x : x);
        q8[2] = __float2bfloat16(0.f);
      }
  }
  // the zero terms' sums: over each warp's channels, then the warps in
  // order (after the barrier)
#pragma unroll
  for (int p = 0; p < PER; ++p)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float z = qd[0][g] * kzd[0][p];
#pragma unroll
      for (int i = 1; i < CPT; ++i) z = fmaf(qd[i][g], kzd[i][p], z);
      z = warp_sum(z);
      if (lane == 0) zb[(warp * PER + p) * G + g] = z;
    }
  __syncthreads();
  // the finish pass may launch now: its tail work overlaps this grid, and it
  // waits for this grid's partials before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // this lane: head gid (real where gid < G), byte-rows 8t + 2 tig + e of
  // a unit's two 8-row n-tiles; its P V accumulators hold head gid,
  // channels (D / 4) tig + nt and (D / 4) tig + D / 8 + nt of tile nt
  const bool hv = gid < G;
  const uint8_t* mb = a.mask + (size_t)bk * a.mstride;
  const float inv_cap = CAP ? 1.f / a.softcap : 0.f;
  float o[NT][D == 128 ? 4 : 2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int x = 0; x < (D == 128 ? 4 : 2); ++x) o[nt][x] = 0.f;
  // ps: the bf16 P this lane fed P V (times the field weights), for the
  // 128 offset of code2_128
  float m = -INFINITY, l = 0.f, zv = 0.f, ps = 0.f;
  float zl[PER];  // the lane's head's K zero terms
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    zl[p] = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w)
      zl[p] += hv ? zb[(w * PER + p) * G + gid] : 0.f;
  }

  // visibility of unit i's PER x 16 slots (byte-row ur0 + r, plane p: bit
  // 16 p + r of the unit's vbits), one mask byte a lane (0 where the slot
  // is past the split, n_valid or the warp's units), loaded a unit ahead
  constexpr int VW = (PER * PA_UNIT + 31) / 32;
  auto load_vis = [&](int i, uint8_t (&mv)[VW]) {
    const int ur0 = row0 + (warp + i * PA_WARPS) * PA_UNIT;
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const int x = 32 * j + lane, r = ur0 + (x & 15),
                slot = r + (x >> 4) * W;
      mv[j] = i < nu && x < PER * PA_UNIT && r < row1 && slot < a.n_valid
                  ? mb[slot]
                  : 0;
    }
  };
  uint8_t vcur[VW];
  load_vis(0, vcur);

  for (int i = 0; i < nu; ++i) {
    // unit i has landed: this lane's copies, then every lane's; stage i - 1
    // is free
    cp_async_wait<PA_STAGES - 2>();
    __syncwarp();
    issue(i + PA_STAGES - 1);
    const uint8_t* st = ring + (i % PA_STAGES) * STAGE;
    const int ur0 = row0 + (warp + i * PA_WARPS) * PA_UNIT;
    // the next unit's mask bytes go out now: their latency hides behind
    // this unit
    uint8_t vnext[VW];
    load_vis(i + 1, vnext);

    // ---- S = Qf Kc^T, per plane: 16 heads x (2 n-tiles of 8 byte-rows);
    // k step kk takes channels (D / 4) tig + 4 kk + {0..3} of the lane's row
    float s[PER][2][4];
#pragma unroll
    for (int p = 0; p < PER; ++p)
#pragma unroll
      for (int t = 0; t < 2; ++t) s[p][t][0] = s[p][t][1] = s[p][t][2] = s[p][t][3] = 0.f;
    uint4 kw[2][D / 64];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        kw[t][h] = *reinterpret_cast<const uint4*>(
            st + (8 * t + gid) * ROW + (D / 4) * tig + 16 * h);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint4 qa[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f)
        qa[f] = hv ? fq[(f * G + gid) * FQ + (D / 16) * tig + kk]
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint4 w4 = kw[t][kk >> 2];
        const uint32_t word = (kk & 3) == 0 ? w4.x : (kk & 3) == 1 ? w4.y
                              : (kk & 3) == 2 ? w4.z : w4.w;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const uint32_t y = (word >> (f * FB)) & M8;
          mma_g(s[NBITS == 8 ? 0 : f][t], qa[f], code2(y, 0x4140),
                code2(y, 0x4342));
        }
      }
    }

    // ---- online softmax of the unit for head gid (e-domain)
    uint32_t vbits[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      vbits[j] = __ballot_sync(FULL, vcur[j] != 0);
      vcur[j] = vnext[j];
    }
    float sv[PER][2][2];
    float mx = -INFINITY;
#pragma unroll
    for (int p = 0; p < PER; ++p)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = ur0 + 8 * t + 2 * tig + e;
          // past the split: not a slot; masked: float32.min (the cap, after
          // the zero term, before the mask)
          const int x = 16 * p + 8 * t + 2 * tig + e;  // the slot's bit
          float y = s[p][t][e] + zl[p];
          if constexpr (CAP) y = cap_logit(y, a.softcap, inv_cap);
          sv[p][t][e] = r >= row1 ? -INFINITY
                        : (vbits[x >> 5] >> (x & 31)) & 1u ? y
                                                       : NEG;
          mx = fmaxf(mx, sv[p][t][e]);
        }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    // the unit has a byte-row in the split: m_new >= float32.min is finite
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);  // 0 while m = -inf
    l *= alpha;
    zv *= alpha;
    ps *= alpha;
    if (__any_sync(FULL, alpha != 1.f)) {  // a max moved: rescale
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= alpha;
        o[nt][1] *= alpha;
      }
    }
    m = m_new;
    // p times the V scale (rounded to bf16 when packed), p times the V zero
    const float* vsc = reinterpret_cast<const float*>(st + 2 * PA_UNIT * ROW);
    float pv[PER][2][2];
#pragma unroll
    for (int p = 0; p < PER; ++p)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float2 vs2 = *reinterpret_cast<const float2*>(
            vsc + p * PA_UNIT + 8 * t + 2 * tig);
        const float2 vz2 = *reinterpret_cast<const float2*>(
            vsc + (PER + p) * PA_UNIT + 8 * t + 2 * tig);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ev = sv[p][t][e] > NEG ? __expf(sv[p][t][e] - m_new) : 0.f;
          l += ev;
          pv[p][t][e] = 0.f;
          if (ev != 0.f) {  // rows past the split hold no scales
            zv = fmaf(ev, e ? vz2.y : vz2.x, zv);
            pv[p][t][e] = ev * (e ? vs2.y : vs2.x);
          }
        }
      }

    // ---- O += P Vc: B the V codes of byte-rows {2 tig, 2 tig + 1} (b0)
    // and {8 + 2 tig, 9 + 2 tig} (b1), channel (D / 8) gid + 4 u + e of
    // tile nt = 4 u + e
    uint4 vw[4][D / 128];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < D / 128; ++h)
        vw[j][h] = *reinterpret_cast<const uint4*>(
            st + PA_UNIT * ROW + ((j >> 1) * 8 + 2 * tig + (j & 1)) * ROW +
            (D / 8) * gid + 16 * h);
    uint4 pa[NF];  // A fragments of P, field f
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int p = NBITS == 8 ? 0 : f;
      const float w = NBITS == 8 && f == 1 ? 16.f : 1.f;
      pa[f] = make_uint4(pack2(pv[p][0][0] * w, pv[p][0][1] * w), 0u,
                         pack2(pv[p][1][0] * w, pv[p][1][1] * w), 0u);
      ps += sum2(pa[f].x) + sum2(pa[f].z);
    }
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      const int h = u >> 2, k = u & 3;
      const uint32_t w0 = k == 0 ? vw[0][h].x : k == 1 ? vw[0][h].y : k == 2 ? vw[0][h].z : vw[0][h].w;
      const uint32_t w1 = k == 0 ? vw[1][h].x : k == 1 ? vw[1][h].y : k == 2 ? vw[1][h].z : vw[1][h].w;
      const uint32_t w2 = k == 0 ? vw[2][h].x : k == 1 ? vw[2][h].y : k == 2 ? vw[2][h].z : vw[2][h].w;
      const uint32_t w3 = k == 0 ? vw[3][h].x : k == 1 ? vw[3][h].y : k == 2 ? vw[3][h].z : vw[3][h].w;
      // rows 2 tig and 2 tig + 1 interleaved: channel bytes 0, 1 | 2, 3
      const uint32_t x00 = prmt(w0, w1, 0x5140), x01 = prmt(w0, w1, 0x7362);
      const uint32_t x10 = prmt(w2, w3, 0x5140), x11 = prmt(w2, w3, 0x7362);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const uint32_t y00 = (x00 >> (f * FB)) & M8, y01 = (x01 >> (f * FB)) & M8;
        const uint32_t y10 = (x10 >> (f * FB)) & M8, y11 = (x11 >> (f * FB)) & M8;
        mma_g(o[4 * u + 0], pa[f], code2_128(y00, 0x4140), code2_128(y10, 0x4140));
        mma_g(o[4 * u + 1], pa[f], code2_128(y00, 0x4342), code2_128(y10, 0x4342));
        mma_g(o[4 * u + 2], pa[f], code2_128(y01, 0x4140), code2_128(y11, 0x4140));
        mma_g(o[4 * u + 3], pa[f], code2_128(y01, 0x4342), code2_128(y11, 0x4342));
      }
    }
  }

  // the warp's sums over the 4 lanes of a head, then the warps' states
  // merged in warp order (the rings are free: they hold the states now)
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  zv += __shfl_xor_sync(FULL, zv, 1);
  zv += __shfl_xor_sync(FULL, zv, 2);
  ps += __shfl_xor_sync(FULL, ps, 1);
  ps += __shfl_xor_sync(FULL, ps, 2);
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [PA_WARPS][G]
  float* wl = wm + PA_WARPS * G;
  float* wz = wl + PA_WARPS * G;
  float* wacc = wz + PA_WARPS * G;             // [PA_WARPS][G][D]
  if (hv) {
    if (tig == 0) {
      wm[warp * G + gid] = m;
      wl[warp * G + gid] = l;
      wz[warp * G + gid] = zv;
    }
    float* wa = wacc + (warp * G + gid) * D + (D / 4) * tig;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      wa[nt] = o[nt][0] - 128.f * ps;
      wa[NT + nt] = o[nt][1] - 128.f * ps;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += PA_WARPS * 32) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lt = 0.f, o2 = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) {
      // idle warps (m = -inf) and all-masked ones (l = 0) add nothing
      const float f = wm[w * G + g] <= NEG / 2 ? 0.f : expf(wm[w * G + g] - mx);
      lt = fmaf(wl[w * G + g], f, lt);
      o2 = fmaf(wacc[(w * G + g) * D + d] + wz[w * G + g], f, o2);
    }
    const size_t row = ((size_t)bk * gridDim.y + sp) * G + g;
    a.acc[row * D + d] = o2;
    if (d == 0) {
      a.m[row] = mx;
      a.l[row] = lt;
    }
  }
}

// Merge the nsplit partials of each (bk, g) in split order into (acc, m, l);
// with a tail, attend over it too (f32 logits of the bf16 q and K, scaled,
// then capped under CAP, as ops/attention.py::decode_attention_partials),
// merge it after the splits and write the normalised output out[bk * G + g]
// in bf16 instead.  Block (bk, g), thread d: D / 32 warps.  Launched as a
// programmatic dependent of pa_split_kernel: the tail (which reads nothing
// the split kernel writes) runs first, then the block waits for the split
// kernel's partials.  In the tail a warp takes 32-slot chunks (chunk c of
// warp w starts at slot 32 (w + TW c)), a lane one slot's logit, then D / 32
// channels of P.V, the loads of a chunk in flight together (at D = 256 in
// halves of K rows and of V rows).
template <int G, int D, bool CAP>
__global__ void __launch_bounds__(D) pa_finish_kernel(
    const float* __restrict__ wacc, const float* __restrict__ wm,
    const float* __restrict__ wl, int nsplit, const __nv_bfloat16* q, Tail t,
    float scale, float softcap, float* __restrict__ acc, float* __restrict__ m,
    float* __restrict__ l, __nv_bfloat16* __restrict__ out) {
  constexpr int TW = D / 32;  // warps
  constexpr int VL = D / 32;  // tail P.V channels a lane
  constexpr int KB = 16;      // K row pieces (16 bytes) loaded together
  constexpr int RB = 32 * 128 / D;  // V rows loaded together
  __shared__ __align__(16) float qs[D];
  __shared__ float tm[TW], tl[TW];
  __shared__ __align__(16) float ta[TW][D];
  const int bk = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const size_t row = (size_t)bk * G + g;
  const int warp = d >> 5, lane = d & 31;
  if (t.T > 0) {
    qs[d] = __bfloat162float(q[row * D + d]);
    __syncthreads();
    const __nv_bfloat16* kb = t.k + (size_t)bk * t.T * D;
    const __nv_bfloat16* vb = t.v + (size_t)bk * t.T * D + lane * VL;
    const uint8_t* tmb = t.mask + (size_t)bk * t.mstride;
    const float inv_cap = CAP ? 1.f / softcap : 0.f;
    float wmx = -INFINITY, wls = 0.f, wa[VL];
#pragma unroll
    for (int k = 0; k < VL; ++k) wa[k] = 0.f;
    for (int c0 = warp * 32; c0 < t.T; c0 += TW * 32) {
      const int s = c0 + lane;
      float x = -INFINITY;  // not a visible slot
      if (s < t.T && tmb[s]) {
        const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)s * D);
        float dot = 0.f;
#pragma unroll
        for (int i0 = 0; i0 < D / 8; i0 += KB) {
          uint4 kw[KB];
#pragma unroll
          for (int i = 0; i < KB; ++i) kw[i] = kr[i0 + i];
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            const uint32_t words[4] = {kw[i].x, kw[i].y, kw[i].z, kw[i].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 kf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&words[k]));
              dot = fmaf(qs[(i0 + i) * 8 + 2 * k], kf.x, dot);
              dot = fmaf(qs[(i0 + i) * 8 + 2 * k + 1], kf.y, dot);
            }
          }
        }
        x = dot * scale;
        if constexpr (CAP) x = cap_logit(x, softcap, inv_cap);
      }
      const float cm = warp_max(x);
      if (cm == -INFINITY) continue;  // no visible slot in the chunk
      const float mn = fmaxf(wmx, cm);
      const float alpha = expf(wmx - mn);  // 0 while wmx = -inf
      const float p = x == -INFINITY ? 0.f : expf(x - mn);
      wls = fmaf(wls, alpha, warp_sum(p));
#pragma unroll
      for (int k = 0; k < VL; ++k) wa[k] *= alpha;
      const int nrows = min(32, t.T - c0);
#pragma unroll
      for (int r0 = 0; r0 < 32; r0 += RB) {
        uint2 vw[RB][VL / 4];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int h = 0; h < VL / 4; ++h)
            vw[r][h] = r0 + r < nrows
                           ? *reinterpret_cast<const uint2*>(
                                 vb + (size_t)(c0 + r0 + r) * D + 4 * h)
                           : make_uint2(0u, 0u);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float pr = __shfl_sync(FULL, p, r0 + r);  // 0 past the tail
#pragma unroll
          for (int h = 0; h < VL / 4; ++h) {
            const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw[r][h].x));
            const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw[r][h].y));
            wa[4 * h + 0] = fmaf(pr, v01.x, wa[4 * h + 0]);
            wa[4 * h + 1] = fmaf(pr, v01.y, wa[4 * h + 1]);
            wa[4 * h + 2] = fmaf(pr, v23.x, wa[4 * h + 2]);
            wa[4 * h + 3] = fmaf(pr, v23.y, wa[4 * h + 3]);
          }
        }
      }
      wmx = mn;
    }
    if (lane == 0) {
      tm[warp] = wmx;
      tl[warp] = wls;
    }
#pragma unroll
    for (int h = 0; h < VL / 4; ++h)
      *reinterpret_cast<float4*>(&ta[warp][lane * VL + 4 * h]) =
          make_float4(wa[4 * h], wa[4 * h + 1], wa[4 * h + 2], wa[4 * h + 3]);
  }
  // the split kernel's partials are complete and visible from here on
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t base = (size_t)bk * nsplit;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, wm[(base + s) * G + g]);
  float ls = 0.f, o = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const size_t r = (base + s) * G + g;
    const float f = wm[r] <= NEG / 2 ? 0.f : expf(wm[r] - mx);
    ls = fmaf(wl[r], f, ls);
    o = fmaf(wacc[r * D + d], f, o);
  }
  if (t.T == 0) {
    acc[row * D + d] = o;
    if (d == 0) {
      m[row] = mx;
      l[row] = ls;
    }
    return;
  }
  __syncthreads();
  float mall = mx;
#pragma unroll
  for (int w = 0; w < TW; ++w) mall = fmaxf(mall, tm[w]);
  // an all-masked region (m = float32.min) and a warp that saw no visible
  // slot (m = -inf) add nothing
  const float fr = mx <= NEG / 2 ? 0.f : expf(mx - mall);
  float lt = ls * fr, ot = o * fr;
#pragma unroll
  for (int w = 0; w < TW; ++w) {
    const float f = tm[w] == -INFINITY ? 0.f : expf(tm[w] - mall);
    lt = fmaf(tl[w], f, lt);
    ot = fmaf(ta[w][d], f, ot);
  }
  out[row * D + d] = __float2bfloat16(ot / fmaxf(lt, 1e-30f));
}

// The pa layout's launches: pa_split_kernel over grid (B * Hk, nsplit)
// writes the partials to the workspace, pa_finish_kernel (a programmatic
// dependent launch) merges them (and the tail).
template <int G, int NBITS, int D, bool CAP>
int launch_pa(const Args& a, float* ws_acc, float* ws_m, float* ws_l, int BHk,
              int nsplit, const Tail& t, __nv_bfloat16* out, cudaStream_t st) {
  constexpr int smem = pa_smem_bytes<G, NBITS, D>();
  static bool attr = false;  // per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        pa_split_kernel<G, NBITS, D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  Args w = a;
  w.acc = ws_acc;
  w.m = ws_m;
  w.l = ws_l;
  pa_split_kernel<G, NBITS, D, CAP>
      <<<dim3(BHk, nsplit), PA_WARPS * 32, smem, st>>>(w);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BHk, G);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr2[1];
  attr2[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr2[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr2;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, pa_finish_kernel<G, D, CAP>, (const float*)ws_acc,
      (const float*)ws_m, (const float*)ws_l, nsplit, a.q, t, a.scale,
      a.softcap, a.acc, a.m, a.l, out);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The group layout (modes kF32, kFold and kMix) on any plan: region_kernel.
//
// grid (B * Hk, nsplit): block (bk, sp) attends over byte-rows
// [sp * rows, min(W, (sp + 1) * rows)) of region bk (all PER planes) and
// over its share of the step's bf16 decode tail (the tail's 32-slot items
// with a visible slot, item i of them to split i % nsplit), in one
// online softmax per warp (natural-log domain: the tail's f32 logits of
// the bf16 q and K, as finish_kernel's).  The plan comes from shapes alone
// (kernels/quant_decode.py::split_plan); the splits merge in split order,
// with no atomics (two calls are bitwise equal):
// - one split: the block writes the output (or the partials) itself;
// - 2 to max_cluster(D) splits: the region's blocks run as one thread-block
//   cluster, block 0 reads the others' partials from their shared memory
//   and writes the output: one launch;
// - more: each block writes its partial to the workspace and
//   region_merge_kernel combines them: two launches.
// What the work layout does for bytes in flight and instructions a code:
// - a ring of RSTAGES stages in shared memory, filled with 16-byte cp.async
//   copies, streams items: the split's region rows (32 K code rows, 32 V
//   code rows and the rows' V scales and zeros on every plane), then its
//   tail items (32 K and V rows each);
// - a warp takes 4 rows of an item, 8 lanes a row (D / 8 channels each:
//   16 at D = 128, 32 at D = 256, 4 at D = 32, one 4-byte code load);
//   logits summed over the lanes by shuffles, then capped under CAP; P.V
//   with D / 32 channels a lane (one at D = 32, where the port's cache pads
//   V's channels to the quantization group: the V code rows are Dp >= D
//   bytes and a lane reads its channel's byte, the pad never);
// - for the K groups a window of the split's byte-rows touches in each
//   bit-plane (slot j + p * W: staged_groups per plane, ceil(rows / kg) + 1
//   at most), the block stages in shared memory, channel-minor and padded
//   by 4 floats every 16 channels (8 lanes of a row read 8 bank groups with
//   one 16-byte load): kF32 the K scale and zero columns, kFold the query
//   folded with each group's scale, rounded to bf16, and each group's K zero
//   term q * scale . kz (f32).  No scale is read from global memory per
//   code.  The window is the whole split where its tables fit shared
//   memory (every split plan), and else (a long region on one split) the
//   longest run of whole items whose tables fit (region_window): the block
//   stages the next window's tables when its first item comes up.  The
//   region's visibility (mask and n_valid) is staged as bits.
// Numbers as the plain versions: kF32 dequantizes each element in f32;
// kFold folds bf16(q * scale * ks) per code and q * scale * kz in f32 per
// K group, bf16(p * vs) and p * vz per V row and channel group (p at the
// warp's running max); kMix takes kFold's logits and kF32's P.V.
constexpr int RROWS = 32;       // byte-rows a region item
constexpr int TROWS = 32;       // slots a tail item
constexpr int RSTAGES = 4;      // ring depth
constexpr int MAX_CLUSTER = 4;  // splits merged in a cluster at D = 128
                                // (as the wrapper's MAX_CLUSTER)

// Splits merged in a cluster at head dim D: two at D = 256, where a block
// fills an SM and clusters of 4 ran slower than the merge kernel (as the
// wrapper's max_cluster); MAX_CLUSTER at D = 128 and 32.
__host__ __device__ constexpr int max_cluster(int D) {
  return D == 256 ? 2 : MAX_CLUSTER;
}
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have

// Padded floats of one channel row.
__host__ __device__ constexpr int qrow(int D) { return D + 4 * (D / 16); }

__host__ __device__ __forceinline__ int pad_d(int d) { return d + 4 * (d >> 4); }

// K groups staged per bit-plane for splits of `rows` byte-rows: a run of
// `rows` consecutive slots touches at most (rows + 2 kg - 2) / kg groups
// of kg slots (ceil(rows / kg) + 1), and a plane no more than NG.
__host__ __device__ inline int staged_groups(int rows, int kg, int NG) {
  const int n = (rows + 2 * kg - 2) / kg;
  return n < NG ? n : NG;
}

// Byte offsets of region_kernel's dynamic shared memory.
struct Layout {
  int stage;  // one ring stage
  int ring;   // the ring (it holds the warps' states afterwards)
  int qs;     // the query [G][qrow] f32 (kFold, kMix: times the scale)
  int kt;     // staged K tables: kF32 ks, kz [cols][qrow]; kFold and kMix
              // the folded query [cols][G][qrow] and zero terms [cols][G]
  int vis;    // region visibility words [PER][ceil(rows / 32)]
  int tw;     // tail visibility words [ntail], one per 32-slot item
  int tl;     // tail items with a visible slot, in order [ntail]
  int total;
};

// cols: the staged K columns (per * staged_groups of a window); rows: the
// split's byte-rows; fold: the tables of the folded logits (kFold, kMix).
__host__ __device__ inline Layout region_layout(int D, int G, int per,
                                                bool fold, int cols, int Dp,
                                                int NGV, int rows, int T) {
  const int QROW = qrow(D);
  Layout L;
  const int region = RROWS * D + RROWS * Dp + 2 * per * RROWS * NGV * 4;
  const int tail = 2 * TROWS * D * 2;
  L.stage = ((region > tail ? region : tail) + 15) / 16 * 16;
  // warps' m, l [NWARPS][8], acc [NWARPS][G][D]; the block's partial
  // acc [G][D], m [8], l [8]
  const int states = (2 * NWARPS * 8 + (NWARPS + 1) * G * D + 16) * 4;
  L.ring = RSTAGES * L.stage > states ? RSTAGES * L.stage : states;
  L.qs = L.ring;
  L.kt = L.qs + G * QROW * 4;
  const int ktab = fold ? cols * G * (QROW + 1) * 4 : 2 * cols * QROW * 4;
  L.vis = L.kt + (ktab + 15) / 16 * 16;
  const int ntail = (T + TROWS - 1) / TROWS;
  L.tw = L.vis + per * ((rows + 31) / 32) * 4;
  L.tl = L.tw + ntail * 4;
  L.total = L.tl + ntail * 4;
  return L;
}

// Byte-rows a staging of the K tables covers for splits of `rows`: all of
// them where their tables fit MAX_SMEM, else the most whole items that fit
// (0 where not one item fits).
inline int region_window(int D, int G, int per, bool fold, int rows, int kg,
                         int NG, int Dp, int NGV, int T) {
  auto fits = [&](int win) {
    return region_layout(D, G, per, fold, per * staged_groups(win, kg, NG),
                         Dp, NGV, rows, T).total <= MAX_SMEM;
  };
  if (fits(rows)) return rows;
  int win = (rows - 1) / RROWS * RROWS;
  while (win > 0 && !fits(win)) win -= RROWS;
  return win;
}

// A code (0..255) as a float: 2^23 + code, less 2^23.
__device__ __forceinline__ float code_f(uint32_t c) {
  return __uint_as_float(0x4B000000u | c) - 8388608.f;
}

__device__ __forceinline__ float f4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int G, int NBITS, int MODE, int D, bool CAP>
__global__ void __launch_bounds__(NWARPS * 32)
region_kernel(Args a, Tail t, __nv_bfloat16* __restrict__ out,
              float* __restrict__ ws_acc, float* __restrict__ ws_m,
              float* __restrict__ ws_l) {
  static_assert(MODE != kPA, "the pa layout takes pa_split_kernel");
  constexpr bool FOLD = MODE == kFold;   // P.V folded with the V scales
  constexpr bool QFOLD = MODE != kF32;   // logits from the folded queries
  constexpr int PER = 8 / NBITS;
  constexpr uint32_t MASK = (1u << NBITS) - 1u;
  constexpr int QROW = qrow(D);
  constexpr int KW = D / 128;   // 16-byte K code loads a lane a row
  constexpr int VPL = D / 32;   // P.V channels a lane
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int n_tail;

  const int bk = blockIdx.x, sp = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.W, NG = a.NG, Dp = a.Dp, NGV = a.NGV, kg = a.kg;
  const int rows = a.rows_per_split;
  const int row0 = sp * rows, row1 = min(W, row0 + rows);
  // items a window of K tables covers (all the split's where it is one)
  const int ipw = (a.win_rows + RROWS - 1) / RROWS;
  const int gpp = staged_groups(a.win_rows, kg, NG);  // staged groups a plane
  const int cols = PER * gpp;
  const Layout L = region_layout(D, G, PER, QFOLD, cols, Dp, NGV, rows, t.T);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* kt = reinterpret_cast<float*>(smem + L.kt);
  float* zt = kt + cols * G * QROW;  // kFold, kMix: the zero terms [cols][G]
  uint32_t* vwords = reinterpret_cast<uint32_t*>(smem + L.vis);
  uint32_t* twords = reinterpret_cast<uint32_t*>(smem + L.tw);
  int* tlist = reinterpret_cast<int*>(smem + L.tl);
  const int nw = (rows + 31) / 32;
  const int ntail = (t.T + TROWS - 1) / TROWS;
  const int nreg = (row1 - row0 + RROWS - 1) / RROWS;
  const float inv_cap = CAP ? 1.f / a.softcap : 0.f;

  // the ring: item i goes to stage i % RSTAGES, one commit group an item
  const char* kcb = reinterpret_cast<const char*>(a.kc) + (size_t)bk * W * D;
  const char* vcb = reinterpret_cast<const char*>(a.vc) + (size_t)bk * W * Dp;
  const float* vsb = a.vs + (size_t)bk * W * PER * NGV;
  const float* vzb = a.vz + (size_t)bk * W * PER * NGV;
  const char* tkb = reinterpret_cast<const char*>(t.k) + (size_t)bk * t.T * D * 2;
  const char* tvb = reinterpret_cast<const char*>(t.v) + (size_t)bk * t.T * D * 2;
  const int vsoff = RROWS * D + RROWS * Dp;  // V scales [PER][RROWS][NGV],
                                             // then the zeros
  auto copy = [&](uint8_t* dst, const void* src, int bytes) {
    const char* s = reinterpret_cast<const char*>(src);
    for (int o = tid * 16; o < bytes; o += NWARPS * 32 * 16) cp_async16(dst + o, s + o);
  };
  int n = nreg;  // items: the split's region rows, then its tail share
  auto issue = [&](int i) {
    if (i < n) {
      uint8_t* st = smem + (i % RSTAGES) * L.stage;
      if (i < nreg) {
        const int r0 = row0 + i * RROWS, nr = min(RROWS, row1 - r0);
        copy(st, kcb + (size_t)r0 * D, nr * D);
        copy(st + RROWS * D, vcb + (size_t)r0 * Dp, nr * Dp);
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const size_t o = (size_t)(r0 + p * W) * NGV;
          copy(st + vsoff + p * RROWS * NGV * 4, vsb + o, nr * NGV * 4);
          copy(st + vsoff + (PER + p) * RROWS * NGV * 4, vzb + o, nr * NGV * 4);
        }
      } else {
        const int r0 = tlist[sp + (i - nreg) * nsplit] * TROWS;
        const int nr = min(TROWS, t.T - r0);
        copy(st, tkb + (size_t)r0 * D * 2, nr * D * 2);
        copy(st + TROWS * D * 2, tvb + (size_t)r0 * D * 2, nr * D * 2);
      }
    }
    cp_async_commit();  // empty past the list
  };
  // the region's first items go out first: their copies overlap the rest
  // of the prologue
  const int pre = min(nreg, RSTAGES - 1);
  for (int i = 0; i < pre; ++i) issue(i);

  // the query (kF32: as it is; kFold, kMix: times the scale, as the plain
  // qg)
  const __nv_bfloat16* qg = a.q + (size_t)bk * G * D;
  for (int i = tid; i < G * D; i += NWARPS * 32) {
    const float x = __bfloat162float(qg[i]);
    qs[(i / D) * QROW + pad_d(i % D)] = QFOLD ? x * a.scale : x;
  }
  // the staged K tables of the window from byte-row wrow0: column
  // c = p * gpp + u holds K group (wrow0 + p * W) / kg + u (groups past NG
  // are never read)
  const float* ksb = a.ks + (size_t)bk * D * NG;
  const float* kzb = a.kz + (size_t)bk * D * NG;
  auto stage_tables = [&](int wrow0) {
    auto col_group = [&](int c) { return (wrow0 + (c / gpp) * W) / kg + c % gpp; };
#pragma unroll 4
    for (int i = tid; i < cols * D; i += NWARPS * 32) {
      const int c = i % cols, d = i / cols;
      const int grp = col_group(c);
      const size_t o = (size_t)d * NG + grp;
      if constexpr (QFOLD) {
        const float ksv = grp < NG ? ksb[o] : 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g)
          kt[(c * G + g) * QROW + pad_d(d)] =
              bf16_round(__bfloat162float(qg[g * D + d]) * a.scale * ksv);
      } else {
        kt[c * QROW + pad_d(d)] = grp < NG ? ksb[o] : 0.f;
        kt[(cols + c) * QROW + pad_d(d)] = grp < NG ? kzb[o] : 0.f;
      }
    }
    if constexpr (QFOLD) {
      // the K zero term of each staged group: scale * (q . kz), f32
      for (int c = warp; c < cols; c += NWARPS) {
        const int grp = col_group(c);
        float z[G], kzv[D / 32];
#pragma unroll
        for (int g = 0; g < G; ++g) z[g] = 0.f;
#pragma unroll
        for (int u = 0; u < D / 32; ++u)  // the loads in flight together
          kzv[u] = grp < NG ? kzb[(size_t)(lane + 32 * u) * NG + grp] : 0.f;
#pragma unroll
        for (int u = 0; u < D / 32; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g)
            z[g] = fmaf(__bfloat162float(qg[g * D + lane + 32 * u]) * a.scale,
                        kzv[u], z[g]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float zs = warp_sum(z[g]);
          if (lane == 0) zt[c * G + g] = zs;
        }
      }
    }
  };
  int wrow0 = row0;  // the staged window's first byte-row
  stage_tables(wrow0);
  // the region's visibility bits: word u of plane p covers byte-rows
  // row0 + 32 u + [0, 32)
  const uint8_t* mb = a.mask + (size_t)bk * a.mstride;
#pragma unroll 4
  for (int u = warp; u < PER * nw; u += NWARPS) {
    const int p = u / nw, j = row0 + (u % nw) * 32 + lane;
    const bool vis = j < row1 && j + p * W < a.n_valid && mb[j + p * W] != 0;
    const uint32_t bits = __ballot_sync(FULL, vis);
    if (lane == 0) vwords[u] = bits;
  }
  // the tail's visibility bits, a word an item
  const uint8_t* tmb = t.mask + (size_t)bk * t.mstride;
#pragma unroll 4
  for (int h = warp; h < ntail; h += NWARPS) {
    const int s = h * TROWS + lane;
    const uint32_t bits = __ballot_sync(FULL, s < t.T && tmb[s] != 0);
    if (lane == 0) twords[h] = bits;
  }
  __syncthreads();
  if (warp == 0) {  // the tail items with a visible slot, in order
    int cnt = 0;
    for (int h0 = 0; h0 < ntail; h0 += 32) {
      const bool vis = h0 + lane < ntail && twords[h0 + lane] != 0;
      const uint32_t b = __ballot_sync(FULL, vis);
      if (vis) tlist[cnt + __popc(b & ((1u << lane) - 1u))] = h0 + lane;
      cnt += __popc(b);
    }
    if (lane == 0) n_tail = cnt;
  }
  __syncthreads();
  n = nreg + (n_tail > sp ? (n_tail - sp + nsplit - 1) / nsplit : 0);
  for (int i = pre; i < RSTAGES - 1; ++i) issue(i);

  const int j = lane >> 3, c = lane & 7;  // region: row 4 warp + j, channels
                                          // [c D / 8, (c + 1) D / 8)
  const int vgrp = (lane * VPL) / a.vg;   // this lane's V channel group
  float m[G], lp[G], acc[G][VPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lp[g] = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) acc[g][k] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    cp_async_wait<RSTAGES - 2>();  // item i has landed (this thread's part)
    __syncthreads();               // everyone's part; stage (i-1) is free
    issue(i + RSTAGES - 1);
    const uint8_t* st = smem + (i % RSTAGES) * L.stage;
    if (i < nreg && i > 0 && i % ipw == 0) {
      // the next window's K tables: every read of the last window's ended
      // before the barrier above
      wrow0 = row0 + i * RROWS;
      stage_tables(wrow0);
      __syncthreads();
    }

    if (i < nreg) {
      // ---- region rows: logits of byte-row jr, all PER planes ----------
      const int r = warp * 4 + j;  // this lane's row of the item
      const int r0 = row0 + i * RROWS, jr = r0 + r;
      const bool in = jr < row1;
      int col[PER];  // the staged column of the row's K group, per plane
#pragma unroll
      for (int p = 0; p < PER; ++p)
        col[p] = p * gpp + (in ? (jr + p * W) / kg - (wrow0 + p * W) / kg : 0);
      float s[PER][G];
      {
        float dot[PER][G];
#pragma unroll
        for (int p = 0; p < PER; ++p)
#pragma unroll
          for (int g = 0; g < G; ++g) dot[p][g] = 0.f;
        // D = 32: one 4-byte word of channels [4c, 4c + 4)
        constexpr int KWN = D == 32 ? 1 : 4;  // 4-byte code words a load
#pragma unroll
        for (int hh = 0; hh < (D == 32 ? 1 : KW); ++hh) {
          uint32_t words[4];
          if constexpr (D == 32) {
            words[0] = *reinterpret_cast<const uint32_t*>(st + r * D + c * 4);
          } else {
            const uint4 kw = *reinterpret_cast<const uint4*>(
                st + r * D + c * 16 * KW + hh * 16);
            words[0] = kw.x;
            words[1] = kw.y;
            words[2] = kw.z;
            words[3] = kw.w;
          }
#pragma unroll
          for (int w = 0; w < KWN; ++w) {
            const int d0 = pad_d(D == 32 ? c * 4 : c * 16 * KW + hh * 16 + w * 4);
            if constexpr (QFOLD) {
              // bf16(q * scale * ks) . code (the zero term after the sum)
#pragma unroll
              for (int p = 0; p < PER; ++p) {
#pragma unroll
                for (int g = 0; g < G; ++g) {
                  const float4 qf = *reinterpret_cast<const float4*>(
                      &kt[(col[p] * G + g) * QROW + d0]);
#pragma unroll
                  for (int k = 0; k < 4; ++k)
                    dot[p][g] = fmaf(f4(qf, k),
                                     code_f((words[w] >> (8 * k + p * NBITS)) & MASK),
                                     dot[p][g]);
                }
              }
            } else {
              float4 q4[G];
#pragma unroll
              for (int g = 0; g < G; ++g)
                q4[g] = *reinterpret_cast<const float4*>(&qs[g * QROW + d0]);
#pragma unroll
              for (int p = 0; p < PER; ++p) {
                const float4 ks4 = *reinterpret_cast<const float4*>(&kt[col[p] * QROW + d0]);
                const float4 kz4 =
                    *reinterpret_cast<const float4*>(&kt[(cols + col[p]) * QROW + d0]);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  // code * scale + zero, f32
                  const float kv = fmaf(code_f((words[w] >> (8 * k + p * NBITS)) & MASK),
                                        f4(ks4, k), f4(kz4, k));
#pragma unroll
                  for (int g = 0; g < G; ++g) dot[p][g] = fmaf(f4(q4[g], k), kv, dot[p][g]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const bool valid = in && ((vwords[p * nw + i] >> r) & 1u);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float x = dot[p][g];
            x += __shfl_xor_sync(FULL, x, 1);
            x += __shfl_xor_sync(FULL, x, 2);
            x += __shfl_xor_sync(FULL, x, 4);
            if constexpr (QFOLD) x += zt[col[p] * G + g];
            else x *= a.scale;
            // the cap after the zero term, the masks after the cap
            if constexpr (CAP) x = cap_logit(x, a.softcap, inv_cap);
            s[p][g] = !in ? -INFINITY : !valid ? NEG : x;
          }
        }
      }
      // online softmax over the warp's 4 rows x PER planes
      float e[PER][G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = s[0][g];
#pragma unroll
        for (int p = 1; p < PER; ++p) mx = fmaxf(mx, s[p][g]);
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
        const float mn = fmaxf(m[g], mx);
        if (mn == -INFINITY) {  // the warp's rows all lie past the split
#pragma unroll
          for (int p = 0; p < PER; ++p) e[p][g] = 0.f;
          continue;
        }
        const float alpha = expf(m[g] - mn);
        float lsum = 0.f;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          e[p][g] = s[p][g] > NEG ? expf(s[p][g] - mn) : 0.f;
          lsum += e[p][g];
        }
        lp[g] = fmaf(lp[g], alpha, lsum);
#pragma unroll
        for (int k = 0; k < VPL; ++k) acc[g][k] *= alpha;
        m[g] = mn;
      }
      // P.V: this lane owns channels [VPL lane, VPL lane + VPL)
      const uint8_t* vst = st + RROWS * D;
      const float* vsc = reinterpret_cast<const float*>(st + vsoff);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int rv = warp * 4 + rr;
        if (r0 + rv >= row1) continue;  // the same for the whole warp
        // code words a lane, codes a word: one code (byte) at D = 32
        constexpr int VW = VPL < 4 ? 1 : VPL / 4, VK = VPL < 4 ? VPL : 4;
        uint32_t vw[VW];
        if constexpr (VPL < 4) {
          vw[0] = vst[rv * Dp + lane];
        } else {
#pragma unroll
          for (int h = 0; h < VW; ++h)
            vw[h] = *reinterpret_cast<const uint32_t*>(vst + rv * Dp + lane * VPL + 4 * h);
        }
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const float sc = vsc[(p * RROWS + rv) * NGV + vgrp];
          const float zr = vsc[((PER + p) * RROWS + rv) * NGV + vgrp];
          float vv[VPL];  // kF32, kMix: code * scale + zero; kFold: the code
#pragma unroll
          for (int h = 0; h < VW; ++h)
#pragma unroll
            for (int k = 0; k < VK; ++k) {
              const float cv = code_f((vw[h] >> (8 * k + p * NBITS)) & MASK);
              vv[4 * h + k] = FOLD ? cv : fmaf(cv, sc, zr);
            }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pj = __shfl_sync(FULL, e[p][g], rr * 8);
            if constexpr (FOLD) {
              // bf16(p * vs) . code + p * vz (the group's zero term, f32)
              const float pf = bf16_round(pj * sc), pz = pj * zr;
#pragma unroll
              for (int k = 0; k < VPL; ++k) acc[g][k] = fmaf(pf, vv[k], acc[g][k] + pz);
            } else {
#pragma unroll
              for (int k = 0; k < VPL; ++k) acc[g][k] = fmaf(pj, vv[k], acc[g][k]);
            }
          }
        }
      }
    } else {
      // ---- tail slots: f32 logits of the bf16 q and K ----------------------
      const int h = tlist[sp + (i - nreg) * nsplit];
      const int r = warp * 4 + j;  // this lane's slot of the item
      // channels [8 c + 64 u, 8 c + 64 u + 8) for u < D / 64 (at D = 32
      // channels [4 c, 4 c + 4))
      constexpr int KU = D == 32 ? 1 : D / 64;
      uint4 kr[KU];
      if constexpr (D == 32) {
        const uint2 k2 = *reinterpret_cast<const uint2*>(st + r * D * 2 + c * 8);
        kr[0] = make_uint4(k2.x, k2.y, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < D / 64; ++u)
        kr[u] = *reinterpret_cast<const uint4*>(st + r * D * 2 + (c + 8 * u) * 16);
      const bool vis = (twords[h] >> r) & 1u;  // 0 past T
      float e[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float qv[KU][8];
#pragma unroll
        for (int u = 0; u < D / 64; ++u) {
          const float4 q0 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_d(64 * u + 8 * c)]);
          const float4 q1 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_d(64 * u + 8 * c + 4)]);
          qv[u][0] = q0.x; qv[u][1] = q0.y; qv[u][2] = q0.z; qv[u][3] = q0.w;
          qv[u][4] = q1.x; qv[u][5] = q1.y; qv[u][6] = q1.z; qv[u][7] = q1.w;
        }
        float x = 0.f;
        if constexpr (D == 32) {
          const float4 q0 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_d(4 * c)]);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float2 f = __bfloat1622float2(
                reinterpret_cast<const __nv_bfloat162*>(&kr[0])[k]);
            x = fmaf(f4(q0, 2 * k), f.x, x);
            x = fmaf(f4(q0, 2 * k + 1), f.y, x);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int u = 0; u < D / 64; ++u) {
            const float2 f = __bfloat1622float2(
                reinterpret_cast<const __nv_bfloat162*>(&kr[u])[k]);
            x = fmaf(qv[u][2 * k], f.x, x);
            x = fmaf(qv[u][2 * k + 1], f.y, x);
          }
        }
        x += __shfl_xor_sync(FULL, x, 1);
        x += __shfl_xor_sync(FULL, x, 2);
        x += __shfl_xor_sync(FULL, x, 4);
        if constexpr (!QFOLD) x *= a.scale;
        if constexpr (CAP) x = cap_logit(x, a.softcap, inv_cap);
        e[g] = vis ? x : -INFINITY;  // logit for now
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = e[g];
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
        if (mx == -INFINITY) {  // no visible slot among the warp's 4
          e[g] = 0.f;
          continue;
        }
        const float mn = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - mn);  // 0 while m = -inf or float32.min
        e[g] = e[g] == -INFINITY ? 0.f : expf(e[g] - mn);
        lp[g] = fmaf(lp[g], alpha, e[g]);
#pragma unroll
        for (int k = 0; k < VPL; ++k) acc[g][k] *= alpha;
        m[g] = mn;
      }
      const uint8_t* vst = st + TROWS * D * 2;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        if (!((twords[h] >> (warp * 4 + rr)) & 1u)) continue;  // warp-uniform
        float vf[VPL];
        if constexpr (VPL == 1)  // D = 32: this lane's channel
          vf[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              vst + (warp * 4 + rr) * D * 2 + lane * 2));
#pragma unroll
        for (int q = 0; q < VPL / 4; ++q) {
          const uint2 vw = *reinterpret_cast<const uint2*>(
              vst + (warp * 4 + rr) * D * 2 + lane * VPL * 2 + 8 * q);
          const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.x));
          const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.y));
          vf[4 * q] = v01.x;
          vf[4 * q + 1] = v01.y;
          vf[4 * q + 2] = v23.x;
          vf[4 * q + 3] = v23.y;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(FULL, e[g], rr * 8);
#pragma unroll
          for (int k = 0; k < VPL; ++k) acc[g][k] = fmaf(pj, vf[k], acc[g][k]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  float* wm = reinterpret_cast<float*>(smem);  // [NWARPS][G]
  float* wl = wm + NWARPS * G;                 // [NWARPS][G]
  float* wacc = wm + 2 * NWARPS * 8;           // [NWARPS][G][D]
  float* part = wacc + NWARPS * G * D;         // the block's acc [G][D],
  float* pm = part + G * D;                    // m [G] and l [G]
  float* pl = pm + 8;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lw = lp[g];  // the 4 row groups' sums
    lw += __shfl_xor_sync(FULL, lw, 8);
    lw += __shfl_xor_sync(FULL, lw, 16);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = lw;
    }
    if constexpr (VPL == 1) wacc[(warp * G + g) * D + lane] = acc[g][0];
#pragma unroll
    for (int h = 0; h < VPL / 4; ++h)
      *reinterpret_cast<float4*>(&wacc[(warp * G + g) * D + lane * VPL + 4 * h]) =
          make_float4(acc[g][4 * h], acc[g][4 * h + 1], acc[g][4 * h + 2],
                      acc[g][4 * h + 3]);
  }
  __syncthreads();

  // the layer's output, or the region's partials
  auto emit = [&](int g, int d, float o, float mx, float lt) {
    const size_t row = (size_t)bk * G + g;
    if (t.T > 0) {
      out[row * D + d] = __float2bfloat16(o / fmaxf(lt, 1e-30f));
    } else {
      a.acc[row * D + d] = o;
      if (d == 0) {
        a.m[row] = mx;
        a.l[row] = lt;
      }
    }
  };
  const bool cluster = nsplit > 1 && nsplit <= max_cluster(D);
  for (int i = tid; i < G * D; i += NWARPS * 32) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      // idle warps (m = -inf) and all-masked ones (l = 0) add nothing
      const float f = wm[w * G + g] <= NEG / 2 ? 0.f : expf(wm[w * G + g] - mx);
      lt = fmaf(wl[w * G + g], f, lt);
      o = fmaf(wacc[(w * G + g) * D + d], f, o);
    }
    // the split has a byte-row, so mx >= float32.min
    if (nsplit == 1) {
      emit(g, d, o, mx, lt);
    } else if (cluster) {
      part[i] = o;
      if (d == 0) {
        pm[g] = mx;
        pl[g] = lt;
      }
    } else {
      const size_t wr = ((size_t)bk * nsplit + sp) * G + g;
      ws_acc[wr * D + d] = o;
      if (d == 0) {
        ws_m[wr] = mx;
        ws_l[wr] = lt;
      }
    }
  }
  if (!cluster) return;

  // the cluster's merge: block 0 reads each split's partial from that
  // block's shared memory, in split order; every block stays until it has
  // been read.  A split with no visible slot (m = float32.min) adds nothing.
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  if (cl.block_rank() == 0) {
    for (int i = tid; i < G * D; i += NWARPS * 32) {
      const int g = i / D, d = i % D;
      float mx = -INFINITY;
      for (int r = 0; r < nsplit; ++r) mx = fmaxf(mx, cl.map_shared_rank(pm, r)[g]);
      float lt = 0.f, o = 0.f;
      for (int r = 0; r < nsplit; ++r) {
        const float mr = cl.map_shared_rank(pm, r)[g];
        const float f = mr <= NEG / 2 ? 0.f : expf(mr - mx);
        lt = fmaf(cl.map_shared_rank(pl, r)[g], f, lt);
        o = fmaf(cl.map_shared_rank(part, r)[i], f, o);
      }
      emit(g, d, o, mx, lt);
    }
  }
  cl.sync();
}

// Combine the nsplit workspace partials of (bk, g) in split order: block
// (bk, g), thread d.  With a tail (its share already in the partials), the
// normalised bf16 output; else the merged partials.
template <int G, int D>
__global__ void __launch_bounds__(D)
region_merge_kernel(const float* __restrict__ ws_acc,
                    const float* __restrict__ ws_m,
                    const float* __restrict__ ws_l, int nsplit, int tail,
                    float* __restrict__ acc, float* __restrict__ m,
                    float* __restrict__ l, __nv_bfloat16* __restrict__ out) {
  const int bk = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const size_t base = (size_t)bk * nsplit;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ws_m[(base + s) * G + g]);
  float ls = 0.f, o = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const size_t row = (base + s) * G + g;
    const float f = ws_m[row] <= NEG / 2 ? 0.f : expf(ws_m[row] - mx);
    ls = fmaf(ws_l[row], f, ls);
    o = fmaf(ws_acc[row * D + d], f, o);
  }
  const size_t row = (size_t)bk * G + g;
  if (tail) {
    out[row * D + d] = __float2bfloat16(o / fmaxf(ls, 1e-30f));
  } else {
    acc[row * D + d] = o;
    if (d == 0) {
      m[row] = mx;
      l[row] = ls;
    }
  }
}

// One group-layout region call: region_kernel over grid (B * Hk, nsplit)
// with a.rows_per_split byte-rows a split, in clusters of the nsplit blocks
// of a region when 1 < nsplit <= max_cluster(D), else followed by
// region_merge_kernel when nsplit > max_cluster(D).
template <int G, int NBITS, int MODE, int D, bool CAP>
int launch_region(const Args& a, int BHk, int nsplit, const Tail& t,
                  __nv_bfloat16* out, float* ws_acc, float* ws_m, float* ws_l,
                  cudaStream_t st) {
  constexpr int PER = 8 / NBITS;
  const int rows = a.rows_per_split;
  // the 16-byte copies: 4-byte V rows, channel groups of whole lanes
  // (D / 32 channels each), byte-row counts and split starts of a multiple
  // of 4
  if (a.Dp % 4 || a.W % 4 || a.vg % (D / 32) || a.vg % 4 || rows < 4 ||
      rows % 4 || nsplit < 1 || (long long)(nsplit - 1) * rows >= a.W ||
      (long long)nsplit * rows < a.W)
    return (int)cudaErrorInvalidValue;
  Args w = a;
  w.win_rows = region_window(D, G, PER, MODE != kF32, rows, a.kg, a.NG, a.Dp,
                             a.NGV, t.T);
  if (w.win_rows == 0) return (int)cudaErrorInvalidValue;
  const int cols = PER * staged_groups(w.win_rows, a.kg, a.NG);
  const int smem = region_layout(D, G, PER, MODE != kF32, cols, a.Dp, a.NGV,
                                 rows, t.T).total;
  static int smem_set = 48 * 1024;  // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        region_kernel<G, NBITS, MODE, D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const bool cluster = nsplit > 1 && nsplit <= max_cluster(D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BHk, nsplit);
  cfg.blockDim = dim3(NWARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster ? nsplit : 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, region_kernel<G, NBITS, MODE, D, CAP>, w, t, out, ws_acc, ws_m,
      ws_l);
  if (le != cudaSuccess) return (int)le;
  const int err = (int)cudaGetLastError();
  if (err != 0 || nsplit <= max_cluster(D)) return err;
  region_merge_kernel<G, D><<<dim3(BHk, G), D, 0, st>>>(
      ws_acc, ws_m, ws_l, nsplit, t.T > 0, a.acc, a.m, a.l, out);
  return (int)cudaGetLastError();
}

// The group kernel at head dim 32 (the trained tiny retrieval checkpoint's
// fullkv KIVI cache: 8 / 4 heads, G = 2, no cap), instantiated in the
// factored mode kFold alone for NBITS in {2, 4, 8}; the kF32 and kMix modes
// at D = 32 are not ported yet (ROADMAP queue 2A #4) and return
// cudaErrorInvalidValue, as any other G or a cap does.
template <int MODE>
int launch_region_d32(const Args& a, int G, int nbits, float softcap, int BHk,
                      int nsplit, const Tail& t, __nv_bfloat16* out,
                      float* ws_acc, float* ws_m, float* ws_l,
                      cudaStream_t st) {
  if constexpr (MODE == kFold) {
    if (G == 2 && !(softcap > 0.f)) {
      switch (nbits) {
        case 2: return launch_region<2, 2, kFold, 32, false>(a, BHk, nsplit, t, out, ws_acc, ws_m, ws_l, st);
        case 4: return launch_region<2, 4, kFold, 32, false>(a, BHk, nsplit, t, out, ws_acc, ws_m, ws_l, st);
        case 8: return launch_region<2, 8, kFold, 32, false>(a, BHk, nsplit, t, out, ws_acc, ws_m, ws_l, st);
        default: break;
      }
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Run the trailing statement with DD = D, CC = CAP, GG = G and NB = NBITS as
// constants, for the instantiated ones: D = 128 uncapped with G in
// {1, 2, 4, 7, 8}, D = 256 capped with G in {1, 2}, NBITS in {2, 4, 8};
// other values return cudaErrorInvalidValue.
#define PKVQ_KEY(D_, CAP_, G_, NB_)                                         \
  ((((D_) == 128 ? 1 : (D_) == 256 ? 2 : 0) * 2 + (CAP_)) * 16 + (G_)) * 16 + (NB_)
#define PKVQ_CASE(D_, CAP_, G_, NB_, ...)                                   \
  case PKVQ_KEY(D_, CAP_, G_, NB_): {                                       \
    constexpr int DD = D_, GG = G_, NB = NB_;                               \
    constexpr bool CC = CAP_;                                               \
    __VA_ARGS__;                                                            \
  } break;
#define PKVQ_CASES_G(D_, CAP_, G_, ...)                                     \
  PKVQ_CASE(D_, CAP_, G_, 2, __VA_ARGS__)                                   \
  PKVQ_CASE(D_, CAP_, G_, 4, __VA_ARGS__)                                   \
  PKVQ_CASE(D_, CAP_, G_, 8, __VA_ARGS__)
#define PKVQ_DISPATCH(D_, CAP_, G_, NBITS_, ...)                            \
  switch (PKVQ_KEY(D_, (CAP_) ? 1 : 0, G_, NBITS_)) {                       \
    PKVQ_CASES_G(128, false, 1, __VA_ARGS__)                                \
    PKVQ_CASES_G(128, false, 2, __VA_ARGS__)                                \
    PKVQ_CASES_G(128, false, 4, __VA_ARGS__)                                \
    PKVQ_CASES_G(128, false, 7, __VA_ARGS__)                                \
    PKVQ_CASES_G(128, false, 8, __VA_ARGS__)                                \
    PKVQ_CASES_G(256, true, 1, __VA_ARGS__)                                 \
    PKVQ_CASES_G(256, true, 2, __VA_ARGS__)                                 \
    default: return (int)cudaErrorInvalidValue;                             \
  }

// The C parameter list of the region entry points (quant_decode.cu,
// quant_group_fused.cu, quant_decode_mm_bf16.cu, quant_fused_decode.cu):
// q [B, Hk*G, D] bf16; kc, ks, kz, vc, vs, vz, mask as above; acc
// [B, Hk*G, D], m, l [B, Hk*G] f32; ws_*: the workspace ([B*Hk*nsplit, G, D]
// and [B*Hk*nsplit, G] f32; read only by the pa kernel and by a group plan
// of more than MAX_CLUSTER splits); scale: the attention scale; softcap:
// the logit cap, 0 for none; tk, tv, tmask, T, tmstride: the bf16 decode
// tail (Tail; T = 0 for none); out [B, Hk*G, D] bf16, written instead of
// (acc, m, l) when there is a tail.
#define PKVQ_PARAMS                                                          \
  const void *q, const void *kc, const void *ks, const void *kz,             \
      const void *vc, const void *vs, const void *vz, const void *mask,      \
      void *acc, void *m, void *l, void *ws_acc, void *ws_m, void *ws_l,     \
      int BHk, int D, int G, int nbits, int W, int S_pad, int NG, int Dp,    \
      int NGV, int mstride, int n_valid, int nsplit, int rows_per_split,     \
      float scale, float softcap, const void *tk, const void *tv,            \
      const void *tmask, int T, int tmstride, void *out, void *stream

#define PKVQ_TAIL                                                             \
  pkvq::Tail{(const __nv_bfloat16*)tk, (const __nv_bfloat16*)tv,              \
             (const uint8_t*)tmask, T, tmstride}

// launch_pa<GG, NB, DD, CC> / launch_region<GG, NB, MODE_, DD, CC> of the
// entry's arguments (inside PKVQ_DISPATCH).
#define PKVQ_LAUNCH_PA(a_)                                                    \
  pkvq::launch_pa<GG, NB, DD, CC>(a_, (float*)ws_acc, (float*)ws_m,           \
                                  (float*)ws_l, BHk, nsplit, PKVQ_TAIL,       \
                                  (__nv_bfloat16*)out, (cudaStream_t)stream)
#define PKVQ_LAUNCH_REGION(MODE_, a_)                                         \
  pkvq::launch_region<GG, NB, MODE_, DD, CC>(                                 \
      a_, BHk, nsplit, PKVQ_TAIL, (__nv_bfloat16*)out, (float*)ws_acc,        \
      (float*)ws_m, (float*)ws_l, (cudaStream_t)stream)

// A group-layout entry point running MODE_ (the body of quant_decode.cu,
// quant_group_fused.cu and quant_decode_mm_bf16.cu); D = 32 through
// launch_region_d32.
#define PKVQ_REGION_ENTRY(NAME_, MODE_)                                       \
  extern "C" int NAME_(PKVQ_PARAMS) {                                         \
    const pkvq::Args a = pkvq::make_args(q, kc, ks, kz, vc, vs, vz, mask,     \
                                         acc, m, l, W, S_pad, NG, Dp, NGV,    \
                                         mstride, n_valid, rows_per_split,    \
                                         scale, softcap);                     \
    if (D == 32)                                                              \
      return pkvq::launch_region_d32<MODE_>(                                  \
          a, G, nbits, softcap, BHk, nsplit, PKVQ_TAIL, (__nv_bfloat16*)out,  \
          (float*)ws_acc, (float*)ws_m, (float*)ws_l, (cudaStream_t)stream);  \
    PKVQ_DISPATCH(D, softcap > 0.f, G, nbits,                                 \
                  return PKVQ_LAUNCH_REGION(MODE_, a));                       \
    return 0;                                                                 \
  }

inline Args make_args(const void* q, const void* kc, const void* ks,
                      const void* kz, const void* vc, const void* vs,
                      const void* vz, const void* mask, void* acc, void* m,
                      void* l, int W, int S_pad, int NG, int Dp, int NGV,
                      int mstride, int n_valid, int rows_per_split,
                      float scale, float softcap) {
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.kc = (const int8_t*)kc;
  a.ks = (const float*)ks;
  a.kz = (const float*)kz;
  a.vc = (const int8_t*)vc;
  a.vs = (const float*)vs;
  a.vz = (const float*)vz;
  a.mask = (const uint8_t*)mask;
  a.acc = (float*)acc;
  a.m = (float*)m;
  a.l = (float*)l;
  a.W = W;
  a.NG = NG;
  a.kg = S_pad / NG;
  a.Dp = Dp;
  a.NGV = NGV;
  a.vg = Dp / NGV;
  a.mstride = mstride;
  a.n_valid = n_valid;
  a.rows_per_split = a.win_rows = rows_per_split;
  a.scale = scale;
  a.softcap = softcap;
  return a;
}

}  // namespace pkvq
