// Shared body of the KIVI region decode kernels (sm_90a):
// quant_decode.cu (group layout, any plan: f32 dequantization, or the
// factored dequantization with bf16 folds) and quant_fused_decode.cu (pa
// layout, split over slots).
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
// - the pa layout (mode kPA): split_kernel splits the byte-rows across
//   blocks (8 warps; a warp takes 32 byte-rows at a time, one per lane, and
//   all PER planes of them; logits lane-per-slot against the query folded
//   with the K scale in shared memory; P.V lane-per-4-channels) and
//   finish_kernel merges the splits in a fixed order, attends over the tail
//   and writes the output;
// - the group layout (modes kF32 and kFold): region_kernel, on any plan
//   (below).

#pragma once

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pkvq {

constexpr int D = 128;
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
//        bit-plane, or per K group of the plane), the K zero a logit bias,
//        the V scale folded into bf16 probabilities, the V zero a
//        separately rescaled scalar;
// kFold  the group layout's factored form, the same function's grouped
//        branch: per slot, the query folded with the slot's K group scale
//        and rounded to bf16 (q * scale * ks[d, group]), the K zero term
//        q * scale . kz[:, group] in f32; per slot and lane, the
//        probability folded with the V scale of the lane's channel group
//        and rounded to bf16, the V zero term p * vz in f32.
enum Mode { kF32 = 0, kPA = 1, kFold = 2 };

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

// ---------------------------------------------------------------------------
// The pa layout: split_kernel + finish_kernel.
// ---------------------------------------------------------------------------

// Folded query copies of the pa kernel: one per bit-plane, where they fit
// the 48 KB of static shared memory beside wacc (every shape but G = 8 with
// 2-bit codes); else one, and the wrappers refuse NG > 1.
template <int G, int NBITS>
__host__ __device__ constexpr int q_copies() {
  return G * (8 / NBITS) <= 16 ? 8 / NBITS : 1;
}

// Partials of byte-rows [row0, row1) of region `bk` (all PER planes), written
// to slot `out` of a.acc / a.m / a.l.
template <int G, int NBITS>
__device__ void pa_partials(const Args& a, int bk, int row0, int row1,
                            int out) {
  constexpr int PER = 8 / NBITS;
  constexpr int QP = q_copies<G, NBITS>();
  constexpr uint32_t MASK = (1u << NBITS) - 1u;
  __shared__ __align__(16) float qs[QP][G][D];
  __shared__ float zb[QP][G];
  __shared__ float wm[NWARPS][G];
  __shared__ float wl[NWARPS][G];
  __shared__ float wz[NWARPS][G];
  __shared__ __align__(16) float wacc[NWARPS][G][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = a.W;
  const __nv_bfloat16* qg = a.q + (size_t)bk * G * D;
  const float* ksb = a.ks + (size_t)bk * D * a.NG;
  const float* kzb = a.kz + (size_t)bk * D * a.NG;
  // the K group of plane p's slots in this block's byte-rows
  const int gpl = a.W / a.kg, grow = row0 / a.kg;
  for (int i = tid; i < QP * G * D; i += NWARPS * 32) {
    const int p = i / (G * D), g = (i / D) % G, d = i % D;
    const float x = __bfloat162float(qg[g * D + d]);
    // q * scale * ks rounded to bf16, as the plain version's bf16 dot
    qs[p][g][d] = bf16_round(x * a.scale * ksb[(size_t)d * a.NG + p * gpl + grow]);
  }
  for (int t = warp; t < QP * G; t += NWARPS) {
    // K zero term of (plane copy t / G, head t % G): scale * (q . kz), f32
    const int p = t / G, g = t % G;
    float z = 0.f;
    for (int d = lane; d < D; d += 32) {
      z = fmaf(__bfloat162float(qg[g * D + d]) * a.scale,
               kzb[(size_t)d * a.NG + p * gpl + grow], z);
    }
    z = warp_sum(z);
    if (lane == 0) zb[p][g] = z;
  }
  __syncthreads();

  const int8_t* kcb = a.kc + (size_t)bk * W * D;
  const int8_t* vcb = a.vc + (size_t)bk * W * a.Dp;
  const float* vsb = a.vs + (size_t)bk * W * PER * a.NGV;
  const float* vzb = a.vz + (size_t)bk * W * PER * a.NGV;
  const uint8_t* mb = a.mask + (size_t)bk * a.mstride;

  float m[G], lp[G], zv[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lp[g] = zv[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }

  for (int j0 = row0 + warp * CHUNK; j0 < row1; j0 += NWARPS * CHUNK) {
    const int j = j0 + lane;
    float s[PER][G];
    if (j < row1) {
      float dot[PER][G];
#pragma unroll
      for (int p = 0; p < PER; ++p)
#pragma unroll
        for (int g = 0; g < G; ++g) dot[p][g] = 0.f;
      const uint4* kr = reinterpret_cast<const uint4*>(kcb + (size_t)j * D);
#pragma unroll 1
      for (int i = 0; i < D / 16; ++i) {
        const uint4 kw = kr[i];
        const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int d = i * 16 + w * 4 + k;
            const uint32_t byte = (words[w] >> (8 * k)) & 0xffu;
#pragma unroll
            for (int p = 0; p < PER; ++p) {
              const float kv = (float)((byte >> (p * NBITS)) & MASK);
#pragma unroll
              for (int g = 0; g < G; ++g)
                dot[p][g] = fmaf(qs[QP == 1 ? 0 : p][g][d], kv, dot[p][g]);
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int slot = j + p * W;
        const bool valid = slot < a.n_valid && mb[slot] != 0;
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[p][g] = valid ? dot[p][g] + zb[QP == 1 ? 0 : p][g] : NEG;
      }
    } else {
#pragma unroll
      for (int p = 0; p < PER; ++p)
#pragma unroll
        for (int g = 0; g < G; ++g) s[p][g] = -INFINITY;  // not a slot
    }

    // online softmax over the chunk's 32 * PER slots; pr: the lane's row's
    // probability times the V scale, rounded to bf16
    float pr[PER][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int p = 1; p < PER; ++p) mx = fmaxf(mx, s[p][g]);
      // byte-row j0 < row1 exists, so m_new >= float32.min is finite
      const float m_new = fmaxf(m[g], warp_max(mx));
      const float alpha = expf(m[g] - m_new);
      float lsum = 0.f, zsum = 0.f;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const float e = s[p][g] > NEG ? expf(s[p][g] - m_new) : 0.f;
        lsum += e;
        pr[p][g] = e;
        if (e != 0.f) {
          const int slot = j + p * W;
          zsum = fmaf(e, vzb[slot], zsum);
          pr[p][g] = bf16_round(e * vsb[slot]);
        }
      }
      lp[g] = lp[g] * alpha + lsum;
      zv[g] = zv[g] * alpha + zsum;
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
      acc[g][2] *= alpha;
      acc[g][3] *= alpha;
      m[g] = m_new;
    }

    // P.V: this lane owns channels [4 * lane, 4 * lane + 4)
    const int nrows = min(CHUNK, row1 - j0);
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
      const int jr = j0 + r;
      // channels 4 * lane + k; Dp may be odd (an odd group size)
      const int8_t* vp = vcb + (size_t)jr * a.Dp + lane * 4;
      const uint32_t vw =
          (a.Dp & 3) == 0
              ? *reinterpret_cast<const uint32_t*>(vp)
              : (uint32_t)(uint8_t)vp[0] | (uint32_t)(uint8_t)vp[1] << 8 |
                    (uint32_t)(uint8_t)vp[2] << 16 | (uint32_t)(uint8_t)vp[3] << 24;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(FULL, pr[p][g], r);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float c = (float)((vw >> (8 * k + p * NBITS)) & MASK);
            acc[g][k] = fmaf(pj, c, acc[g][k]);
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lw = warp_sum(lp[g]);
    const float zw = warp_sum(zv[g]);
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = lw;
      wz[warp][g] = zw;
    }
    *reinterpret_cast<float4*>(&wacc[warp][g][lane * 4]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += NWARPS * 32) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, wm[w][g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      // idle warps (m = -inf) and all-masked ones (l = 0) add nothing
      const float f = wm[w][g] <= NEG / 2 ? 0.f : expf(wm[w][g] - mx);
      l = fmaf(wl[w][g], f, l);
      o = fmaf(wacc[w][g][d] + wz[w][g], f, o);
    }
    const size_t row = (size_t)out * G + g;
    a.acc[row * D + d] = o;
    if (d == 0) {
      a.m[row] = mx;
      a.l[row] = l;
    }
  }
}

// grid (B * Hk, nsplit): block (bk, s) takes byte-rows
// [s * rows_per_split, (s + 1) * rows_per_split) into workspace slot
// bk * nsplit + s.
template <int G, int NBITS>
__global__ void __launch_bounds__(NWARPS * 32) split_kernel(Args a) {
  const int r0 = blockIdx.y * a.rows_per_split;
  pa_partials<G, NBITS>(a, blockIdx.x, r0, min(a.W, r0 + a.rows_per_split),
                        blockIdx.x * gridDim.y + blockIdx.y);
}

// Merge the nsplit partials of each (bk, g) in split order into (acc, m, l).
// With a tail, attend over it too (f32 logits of the bf16 q and K, as
// ops/attention.py::decode_attention_partials), merge it after the splits
// and write the normalised output out[bk * G + g] in bf16 instead.  Block
// (bk, g), thread d: 4 warps; in the tail a warp takes 32-slot chunks
// (chunk c of warp w starts at slot 32 * (w + 4c)), a lane one slot's
// logit, then 4 channels of P.V.
template <int G>
__global__ void __launch_bounds__(D) finish_kernel(
    const float* __restrict__ wacc, const float* __restrict__ wm,
    const float* __restrict__ wl, int nsplit, const __nv_bfloat16* q, Tail t,
    float scale, float* __restrict__ acc, float* __restrict__ m,
    float* __restrict__ l, __nv_bfloat16* __restrict__ out) {
  constexpr int TW = D / 32;  // warps
  __shared__ __align__(16) float qs[D];
  __shared__ float tm[TW], tl[TW];
  __shared__ __align__(16) float ta[TW][D];
  const int bk = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const size_t base = (size_t)bk * nsplit;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, wm[(base + s) * G + g]);
  float ls = 0.f, o = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const size_t row = (base + s) * G + g;
    const float f = wm[row] <= NEG / 2 ? 0.f : expf(wm[row] - mx);
    ls = fmaf(wl[row], f, ls);
    o = fmaf(wacc[row * D + d], f, o);
  }
  const size_t row = (size_t)bk * G + g;
  if (t.T == 0) {
    acc[row * D + d] = o;
    if (d == 0) {
      m[row] = mx;
      l[row] = ls;
    }
    return;
  }

  qs[d] = __bfloat162float(q[row * D + d]);
  __syncthreads();
  const int warp = d >> 5, lane = d & 31;
  const __nv_bfloat16* kb = t.k + (size_t)bk * t.T * D;
  const __nv_bfloat16* vb = t.v + (size_t)bk * t.T * D + lane * 4;
  const uint8_t* mb = t.mask + (size_t)bk * t.mstride;
  float wmx = -INFINITY, wls = 0.f, wa[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = warp * 32; c0 < t.T; c0 += TW * 32) {
    const int s = c0 + lane;
    float x = -INFINITY;  // not a visible slot
    if (s < t.T && mb[s]) {
      const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)s * D);
      float dot = 0.f;
#pragma unroll 4
      for (int i = 0; i < D / 8; ++i) {
        const uint4 kw = kr[i];
        const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&words[k]));
          dot = fmaf(qs[i * 8 + 2 * k], kf.x, dot);
          dot = fmaf(qs[i * 8 + 2 * k + 1], kf.y, dot);
        }
      }
      x = dot * scale;
    }
    const float cm = warp_max(x);
    if (cm == -INFINITY) continue;  // no visible slot in the chunk
    const float mn = fmaxf(wmx, cm);
    const float alpha = expf(wmx - mn);  // 0 while wmx = -inf
    const float p = x == -INFINITY ? 0.f : expf(x - mn);
    wls = fmaf(wls, alpha, warp_sum(p));
#pragma unroll
    for (int k = 0; k < 4; ++k) wa[k] *= alpha;
    const int nrows = min(32, t.T - c0);
    for (int r = 0; r < nrows; ++r) {
      const float pr = __shfl_sync(FULL, p, r);
      if (pr == 0.f) continue;  // the same row for the whole warp
      const uint2 vw = *reinterpret_cast<const uint2*>(vb + (size_t)(c0 + r) * D);
      const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.x));
      const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.y));
      wa[0] = fmaf(pr, v01.x, wa[0]);
      wa[1] = fmaf(pr, v01.y, wa[1]);
      wa[2] = fmaf(pr, v23.x, wa[2]);
      wa[3] = fmaf(pr, v23.y, wa[3]);
    }
    wmx = mn;
  }
  if (lane == 0) {
    tm[warp] = wmx;
    tl[warp] = wls;
  }
  *reinterpret_cast<float4*>(&ta[warp][lane * 4]) = make_float4(wa[0], wa[1], wa[2], wa[3]);
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

// The pa layout's launches: split_kernel over grid (B * Hk, nsplit) writes
// the partials to the workspace and finish_kernel merges them (and the
// tail).
template <int G, int NBITS>
int launch_pa(const Args& a, float* ws_acc, float* ws_m, float* ws_l, int BHk,
              int nsplit, const Tail& t, __nv_bfloat16* out, cudaStream_t st) {
  Args w = a;
  w.acc = ws_acc;
  w.m = ws_m;
  w.l = ws_l;
  split_kernel<G, NBITS><<<dim3(BHk, nsplit), NWARPS * 32, 0, st>>>(w);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  finish_kernel<G><<<dim3(BHk, G), D, 0, st>>>(ws_acc, ws_m, ws_l, nsplit, a.q, t,
                                                a.scale, a.acc, a.m, a.l, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The group layout (modes kF32 and kFold) on any plan: region_kernel.
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
// - 2 to MAX_CLUSTER splits: the region's blocks run as one thread-block
//   cluster, block 0 reads the others' partials from their shared memory
//   and writes the output: one launch;
// - more: each block writes its partial to the workspace and
//   region_merge_kernel combines them: two launches.
// What the work layout does for bytes in flight and instructions a code:
// - a ring of RSTAGES stages in shared memory, filled with 16-byte cp.async
//   copies, streams items: the split's region rows (32 K code rows, 32 V
//   code rows and the rows' V scales and zeros on every plane), then its
//   tail items (32 K and V rows each);
// - a warp takes 4 rows of an item, 8 lanes a row (16 of the 128
//   channels each); logits summed over the lanes by shuffles; P.V with 4
//   channels a lane;
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
// warp's running max).
constexpr int RROWS = 32;       // byte-rows a region item
constexpr int TROWS = 32;       // slots a tail item
constexpr int RSTAGES = 4;      // ring depth
constexpr int MAX_CLUSTER = 4;  // splits merged in a cluster (as the
                                // wrapper's MAX_CLUSTER)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have
constexpr int QROW = D + 4 * (D / 16);  // padded floats of one channel row

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
  int qs;     // the query [G][QROW] f32 (kFold: times the scale)
  int kt;     // staged K tables: kF32 ks, kz [cols][QROW]; kFold the folded
              // query [cols][G][QROW] and zero terms [cols][G]
  int vis;    // region visibility words [PER][ceil(rows / 32)]
  int tw;     // tail visibility words [ntail], one per 32-slot item
  int tl;     // tail items with a visible slot, in order [ntail]
  int total;
};

// cols: the staged K columns (per * staged_groups of a window); rows: the
// split's byte-rows.
__host__ __device__ inline Layout region_layout(int G, int per, bool fold,
                                                int cols, int Dp, int NGV,
                                                int rows, int T) {
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
inline int region_window(int G, int per, bool fold, int rows, int kg, int NG,
                         int Dp, int NGV, int T) {
  auto fits = [&](int win) {
    return region_layout(G, per, fold, per * staged_groups(win, kg, NG), Dp,
                         NGV, rows, T).total <= MAX_SMEM;
  };
  if (fits(rows)) return rows;
  int win = (rows - 1) / RROWS * RROWS;
  while (win > 0 && !fits(win)) win -= RROWS;
  return win;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A code (0..255) as a float: 2^23 + code, less 2^23.
__device__ __forceinline__ float code_f(uint32_t c) {
  return __uint_as_float(0x4B000000u | c) - 8388608.f;
}

__device__ __forceinline__ float f4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int G, int NBITS, int MODE>
__global__ void __launch_bounds__(NWARPS * 32)
region_kernel(Args a, Tail t, __nv_bfloat16* __restrict__ out,
              float* __restrict__ ws_acc, float* __restrict__ ws_m,
              float* __restrict__ ws_l) {
  static_assert(MODE != kPA, "the pa layout takes split_kernel");
  constexpr bool FOLD = MODE == kFold;
  constexpr int PER = 8 / NBITS;
  constexpr uint32_t MASK = (1u << NBITS) - 1u;
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
  const Layout L = region_layout(G, PER, FOLD, cols, Dp, NGV, rows, t.T);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* kt = reinterpret_cast<float*>(smem + L.kt);
  float* zt = kt + cols * G * QROW;  // kFold: the zero terms [cols][G]
  uint32_t* vwords = reinterpret_cast<uint32_t*>(smem + L.vis);
  uint32_t* twords = reinterpret_cast<uint32_t*>(smem + L.tw);
  int* tlist = reinterpret_cast<int*>(smem + L.tl);
  const int nw = (rows + 31) / 32;
  const int ntail = (t.T + TROWS - 1) / TROWS;
  const int nreg = (row1 - row0 + RROWS - 1) / RROWS;

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

  // the query (kF32: as it is; kFold: times the scale, as the plain qg)
  const __nv_bfloat16* qg = a.q + (size_t)bk * G * D;
  for (int i = tid; i < G * D; i += NWARPS * 32) {
    const float x = __bfloat162float(qg[i]);
    qs[(i / D) * QROW + pad_d(i % D)] = FOLD ? x * a.scale : x;
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
      if constexpr (FOLD) {
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
    if constexpr (FOLD) {
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
                                          // [16 c, 16 c + 16)
  const int vgrp = (lane * 4) / a.vg;     // this lane's V channel group
  float m[G], lp[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lp[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
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
        const uint4 kw = *reinterpret_cast<const uint4*>(st + r * D + c * 16);
        const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int d0 = pad_d(c * 16 + w * 4);
          if constexpr (FOLD) {
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
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const bool valid = in && ((vwords[p * nw + i] >> r) & 1u);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float x = dot[p][g];
            x += __shfl_xor_sync(FULL, x, 1);
            x += __shfl_xor_sync(FULL, x, 2);
            x += __shfl_xor_sync(FULL, x, 4);
            if constexpr (FOLD) x += zt[col[p] * G + g];
            else x *= a.scale;
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
        acc[g][0] *= alpha;
        acc[g][1] *= alpha;
        acc[g][2] *= alpha;
        acc[g][3] *= alpha;
        m[g] = mn;
      }
      // P.V: this lane owns channels [4 lane, 4 lane + 4)
      const uint8_t* vst = st + RROWS * D;
      const float* vsc = reinterpret_cast<const float*>(st + vsoff);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int rv = warp * 4 + rr;
        if (r0 + rv >= row1) continue;  // the same for the whole warp
        const uint32_t vw = *reinterpret_cast<const uint32_t*>(vst + rv * Dp + lane * 4);
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const float sc = vsc[(p * RROWS + rv) * NGV + vgrp];
          const float zr = vsc[((PER + p) * RROWS + rv) * NGV + vgrp];
          float vv[4];  // kF32: code * scale + zero; kFold: the code
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float cv = code_f((vw >> (8 * k + p * NBITS)) & MASK);
            vv[k] = FOLD ? cv : fmaf(cv, sc, zr);
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pj = __shfl_sync(FULL, e[p][g], rr * 8);
            if constexpr (FOLD) {
              // bf16(p * vs) . code + p * vz (the group's zero term, f32)
              const float pf = bf16_round(pj * sc), pz = pj * zr;
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[g][k] = fmaf(pf, vv[k], acc[g][k] + pz);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[g][k] = fmaf(pj, vv[k], acc[g][k]);
            }
          }
        }
      }
    } else {
      // ---- tail slots: f32 logits of the bf16 q and K ----------------------
      const int h = tlist[sp + (i - nreg) * nsplit];
      const int r = warp * 4 + j;  // this lane's slot of the item
      const uint4 k0 = *reinterpret_cast<const uint4*>(st + r * D * 2 + c * 16);
      const uint4 k1 = *reinterpret_cast<const uint4*>(st + r * D * 2 + (c + 8) * 16);
      const __nv_bfloat162* ka = reinterpret_cast<const __nv_bfloat162*>(&k0);
      const __nv_bfloat162* kb2 = reinterpret_cast<const __nv_bfloat162*>(&k1);
      const bool vis = (twords[h] >> r) & 1u;  // 0 past T
      float e[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // channels [8 c, 8 c + 8) and [64 + 8 c, 64 + 8 c + 8)
        const float4 qa0 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_d(8 * c)]);
        const float4 qa1 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_d(8 * c + 4)]);
        const float4 qc0 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_d(64 + 8 * c)]);
        const float4 qc1 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_d(68 + 8 * c)]);
        const float qa[8] = {qa0.x, qa0.y, qa0.z, qa0.w, qa1.x, qa1.y, qa1.z, qa1.w};
        const float qc[8] = {qc0.x, qc0.y, qc0.z, qc0.w, qc1.x, qc1.y, qc1.z, qc1.w};
        float x = 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 fa = __bfloat1622float2(ka[u]);
          const float2 fc = __bfloat1622float2(kb2[u]);
          x = fmaf(qa[2 * u], fa.x, x);
          x = fmaf(qa[2 * u + 1], fa.y, x);
          x = fmaf(qc[2 * u], fc.x, x);
          x = fmaf(qc[2 * u + 1], fc.y, x);
        }
        x += __shfl_xor_sync(FULL, x, 1);
        x += __shfl_xor_sync(FULL, x, 2);
        x += __shfl_xor_sync(FULL, x, 4);
        e[g] = vis ? (FOLD ? x : x * a.scale) : -INFINITY;  // logit for now
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
        acc[g][0] *= alpha;
        acc[g][1] *= alpha;
        acc[g][2] *= alpha;
        acc[g][3] *= alpha;
        m[g] = mn;
      }
      const uint8_t* vst = st + TROWS * D * 2;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        if (!((twords[h] >> (warp * 4 + rr)) & 1u)) continue;  // warp-uniform
        const uint2 vw = *reinterpret_cast<const uint2*>(vst + (warp * 4 + rr) * D * 2 + lane * 8);
        const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.x));
        const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.y));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(FULL, e[g], rr * 8);
          acc[g][0] = fmaf(pj, v01.x, acc[g][0]);
          acc[g][1] = fmaf(pj, v01.y, acc[g][1]);
          acc[g][2] = fmaf(pj, v23.x, acc[g][2]);
          acc[g][3] = fmaf(pj, v23.y, acc[g][3]);
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
    *reinterpret_cast<float4*>(&wacc[(warp * G + g) * D + lane * 4]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
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
  const bool cluster = nsplit > 1 && nsplit <= MAX_CLUSTER;
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
template <int G>
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
// of a region when 1 < nsplit <= MAX_CLUSTER, else followed by
// region_merge_kernel when nsplit > MAX_CLUSTER.
template <int G, int NBITS, int MODE>
int launch_region(const Args& a, int BHk, int nsplit, const Tail& t,
                  __nv_bfloat16* out, float* ws_acc, float* ws_m, float* ws_l,
                  cudaStream_t st) {
  constexpr int PER = 8 / NBITS;
  const int rows = a.rows_per_split;
  // the 16-byte copies: 4-byte V rows and channel groups, byte-row counts
  // and split starts of a multiple of 4
  if (a.Dp % 4 || a.W % 4 || a.vg % 4 || rows < 4 || rows % 4 || nsplit < 1 ||
      (long long)(nsplit - 1) * rows >= a.W || (long long)nsplit * rows < a.W)
    return (int)cudaErrorInvalidValue;
  Args w = a;
  w.win_rows = region_window(G, PER, MODE == kFold, rows, a.kg, a.NG, a.Dp,
                             a.NGV, t.T);
  if (w.win_rows == 0) return (int)cudaErrorInvalidValue;
  const int cols = PER * staged_groups(w.win_rows, a.kg, a.NG);
  const int smem = region_layout(G, PER, MODE == kFold, cols, a.Dp, a.NGV,
                                 rows, t.T).total;
  static int smem_set = 48 * 1024;  // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        region_kernel<G, NBITS, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const bool cluster = nsplit > 1 && nsplit <= MAX_CLUSTER;
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
  const cudaError_t le = cudaLaunchKernelEx(&cfg, region_kernel<G, NBITS, MODE>,
                                            w, t, out, ws_acc, ws_m, ws_l);
  if (le != cudaSuccess) return (int)le;
  const int err = (int)cudaGetLastError();
  if (err != 0 || nsplit <= MAX_CLUSTER) return err;
  region_merge_kernel<G><<<dim3(BHk, G), D, 0, st>>>(
      ws_acc, ws_m, ws_l, nsplit, t.T > 0, a.acc, a.m, a.l, out);
  return (int)cudaGetLastError();
}

// Run the trailing statement with GG = G in {1, 2, 4, 8} and NB = NBITS in
// {2, 4, 8} as constants; other values return cudaErrorInvalidValue.
#define PKVQ_DISPATCH(G_, NBITS_, ...)                                     \
  switch (G_ * 16 + NBITS_) {                                               \
    case 1 * 16 + 2: { constexpr int GG = 1, NB = 2; __VA_ARGS__; } break;         \
    case 1 * 16 + 4: { constexpr int GG = 1, NB = 4; __VA_ARGS__; } break;         \
    case 1 * 16 + 8: { constexpr int GG = 1, NB = 8; __VA_ARGS__; } break;         \
    case 2 * 16 + 2: { constexpr int GG = 2, NB = 2; __VA_ARGS__; } break;         \
    case 2 * 16 + 4: { constexpr int GG = 2, NB = 4; __VA_ARGS__; } break;         \
    case 2 * 16 + 8: { constexpr int GG = 2, NB = 8; __VA_ARGS__; } break;         \
    case 4 * 16 + 2: { constexpr int GG = 4, NB = 2; __VA_ARGS__; } break;         \
    case 4 * 16 + 4: { constexpr int GG = 4, NB = 4; __VA_ARGS__; } break;         \
    case 4 * 16 + 8: { constexpr int GG = 4, NB = 8; __VA_ARGS__; } break;         \
    case 8 * 16 + 2: { constexpr int GG = 8, NB = 2; __VA_ARGS__; } break;         \
    case 8 * 16 + 4: { constexpr int GG = 8, NB = 4; __VA_ARGS__; } break;         \
    case 8 * 16 + 8: { constexpr int GG = 8, NB = 8; __VA_ARGS__; } break;         \
    default: return (int)cudaErrorInvalidValue;                             \
  }

// The C parameter list of the region entry points (quant_decode.cu,
// quant_fused_decode.cu): q [B, Hk*G, D] bf16; kc, ks, kz, vc, vs, vz, mask
// as above; acc [B, Hk*G, D], m, l [B, Hk*G] f32; ws_*: the workspace
// ([B*Hk*nsplit, G, D] and [B*Hk*nsplit, G] f32; read only by the pa
// kernel and by a group plan of more than MAX_CLUSTER splits); tk, tv,
// tmask, T, tmstride: the bf16 decode tail (Tail; T = 0 for none); out
// [B, Hk*G, D] bf16, written instead of (acc, m, l) when there is a tail.
#define PKVQ_PARAMS                                                          \
  const void *q, const void *kc, const void *ks, const void *kz,             \
      const void *vc, const void *vs, const void *vz, const void *mask,      \
      void *acc, void *m, void *l, void *ws_acc, void *ws_m, void *ws_l,     \
      int BHk, int G, int nbits, int W, int S_pad, int NG, int Dp, int NGV,  \
      int mstride, int n_valid, int nsplit, int rows_per_split, float scale, \
      const void *tk, const void *tv, const void *tmask, int T, int tmstride, \
      void *out, void *stream

#define PKVQ_TAIL                                                             \
  pkvq::Tail{(const __nv_bfloat16*)tk, (const __nv_bfloat16*)tv,              \
             (const uint8_t*)tmask, T, tmstride}

// launch_pa<GG, NB> / launch_region<GG, NB, MODE_> of the entry's arguments
// (inside PKVQ_DISPATCH).
#define PKVQ_LAUNCH_PA(a_)                                                    \
  pkvq::launch_pa<GG, NB>(a_, (float*)ws_acc, (float*)ws_m, (float*)ws_l,     \
                          BHk, nsplit, PKVQ_TAIL, (__nv_bfloat16*)out,        \
                          (cudaStream_t)stream)
#define PKVQ_LAUNCH_REGION(MODE_, a_)                                         \
  pkvq::launch_region<GG, NB, MODE_>(                                         \
      a_, BHk, nsplit, PKVQ_TAIL, (__nv_bfloat16*)out, (float*)ws_acc,        \
      (float*)ws_m, (float*)ws_l, (cudaStream_t)stream)

inline Args make_args(const void* q, const void* kc, const void* ks,
                      const void* kz, const void* vc, const void* vs,
                      const void* vz, const void* mask, void* acc, void* m,
                      void* l, int W, int S_pad, int NG, int Dp, int NGV,
                      int mstride, int n_valid, int rows_per_split,
                      float scale) {
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
  return a;
}

}  // namespace pkvq
