// Shared body of the KIVI region decode kernels (sm_90a):
// quant_decode.cu (group layout, whole region or split over slots: f32
// dequantization, or the factored dequantization with bf16 folds) and
// quant_fused_decode.cu (pa layout, split over slots).
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
// tail in one domain.
//
// Work split: 8 warps; a warp takes 32 byte-rows at a time (one per lane) and
// all PER planes of them.  Logits are lane-per-slot (the lane reads its
// row's 128 code bytes with 16-byte loads and the per-channel K scale/zero of
// its slot's group, cached in L1 and shared by the lanes of one group).  P.V
// is lane-per-4-channels: each row's 4 V code bytes per lane are one
// coalesced 4-byte load, the row's probability comes by shuffle.  Each warp
// keeps its own online softmax; the warps merge in shared memory at the end.
// split_kernel splits the byte-rows across blocks and finish_kernel merges
// the splits in a fixed order (deterministic); whole_kernel gives one block
// the whole region.  finish_kernel can also attend over the step's bf16
// decode tail and write the layer's normalised bf16 output.

#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pkvq {

constexpr int D = 128;
constexpr int NWARPS = 8;
constexpr int CHUNK = 32;  // byte-rows per warp iteration (one per lane)
constexpr float NEG = -FLT_MAX;

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
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Partials of byte-rows [row0, row1) of region `bk` (all PER planes), written
// to slot `out` of a.acc / a.m / a.l, dequantizing as MODE says.
// Folded query copies of the pa kernel: one per bit-plane, where they fit
// the 48 KB of static shared memory beside wacc (every shape but G = 8 with
// 2-bit codes); else one, and the wrappers refuse NG > 1.
template <int G, int NBITS, int MODE>
__host__ __device__ constexpr int q_copies() {
  return MODE == kPA && G * (8 / NBITS) <= 16 ? 8 / NBITS : 1;
}

template <int G, int NBITS, int MODE>
__device__ void region_partials(const Args& a, int bk, int row0, int row1,
                                int out) {
  constexpr bool PA = MODE == kPA;
  constexpr bool FOLD = MODE == kFold;
  constexpr int PER = 8 / NBITS;
  constexpr int QP = q_copies<G, NBITS, MODE>();
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
  // pa: the K group of plane p's slots in this block's byte-rows
  const int gpl = a.W / a.kg, grow = row0 / a.kg;
  for (int i = tid; i < QP * G * D; i += NWARPS * 32) {
    const int p = i / (G * D), g = (i / D) % G, d = i % D;
    const float x = __bfloat162float(qg[g * D + d]);
    // f32: the raw query (logits = (q . k) * scale, as the plain version);
    // pa: q * scale * ks rounded to bf16, as the plain version's bf16 dot;
    // fold: q * scale in f32 (the plain version's qg), folded per slot
    qs[p][g][d] =
        PA ? bf16_round(x * a.scale * ksb[(size_t)d * a.NG + p * gpl + grow])
           : (FOLD ? x * a.scale : x);
  }
  for (int t = warp; PA && t < QP * G; t += NWARPS) {
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
  const int vgrp = (lane * 4) / a.vg;  // this lane's V channel group

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
      int grp[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        grp[p] = (j + p * W) / a.kg;
#pragma unroll
        for (int g = 0; g < G; ++g) dot[p][g] = 0.f;
      }
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
              float kv = (float)((byte >> (p * NBITS)) & MASK);
              if (FOLD) {
                // bf16(q * scale * ks) . code + (q * scale) . kz
                const size_t o = (size_t)d * a.NG + grp[p];
                const float ksv = __ldg(ksb + o), kzv = __ldg(kzb + o);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                  const float qv = qs[0][g][d];
                  dot[p][g] = fmaf(bf16_round(qv * ksv), kv,
                                   fmaf(qv, kzv, dot[p][g]));
                }
                continue;
              }
              if (!PA) {
                const size_t o = (size_t)d * a.NG + grp[p];
                kv = fmaf(kv, __ldg(ksb + o), __ldg(kzb + o));
              }
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
        for (int g = 0; g < G; ++g) {
          s[p][g] = !valid ? NEG
                           : (PA ? dot[p][g] + zb[QP == 1 ? 0 : p][g]
                                 : (FOLD ? dot[p][g] : dot[p][g] * a.scale));
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < PER; ++p)
#pragma unroll
        for (int g = 0; g < G; ++g) s[p][g] = -INFINITY;  // not a slot
    }

    // online softmax over the chunk's 32 * PER slots; pr: the lane's row's
    // probability (pa: times the V scale, rounded to bf16; fold: as it is,
    // each lane folds its own channel group's V scale in P.V)
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
        if (PA && e != 0.f) {
          const int slot = j + p * W;
          zsum = fmaf(e, vzb[slot], zsum);
          pr[p][g] = bf16_round(e * vsb[slot]);
        }
      }
      lp[g] = lp[g] * alpha + lsum;
      if (PA) zv[g] = zv[g] * alpha + zsum;
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
      // channels 4 * lane + k; Dp may be odd (pa with an odd group size)
      const int8_t* vp = vcb + (size_t)jr * a.Dp + lane * 4;
      const uint32_t vw =
          (a.Dp & 3) == 0
              ? *reinterpret_cast<const uint32_t*>(vp)
              : (uint32_t)(uint8_t)vp[0] | (uint32_t)(uint8_t)vp[1] << 8 |
                    (uint32_t)(uint8_t)vp[2] << 16 | (uint32_t)(uint8_t)vp[3] << 24;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        float vv[4];
        float sc = 1.f, zr = 0.f;
        if (!PA) {
          const size_t o = (size_t)(jr + p * W) * a.NGV + vgrp;
          sc = __ldg(vsb + o);
          zr = __ldg(vzb + o);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float c = (float)((vw >> (8 * k + p * NBITS)) & MASK);
          vv[k] = MODE == kF32 ? fmaf(c, sc, zr) : c;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(0xffffffffu, pr[p][g], r);
          if (FOLD) {
            // bf16(p * vs) . code + p * vz (the group's zero term, f32)
            const float pf = bf16_round(pj * sc), pz = pj * zr;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[g][k] = fmaf(pf, vv[k], acc[g][k] + pz);
            continue;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[g][k] = fmaf(pj, vv[k], acc[g][k]);
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lw = warp_sum(lp[g]);
    const float zw = PA ? warp_sum(zv[g]) : 0.f;
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

// One block per (batch row, KV head): the whole region.
template <int G, int NBITS, int MODE>
__global__ void __launch_bounds__(NWARPS * 32) whole_kernel(Args a) {
  region_partials<G, NBITS, MODE>(a, blockIdx.x, 0, a.W, blockIdx.x);
}

// grid (B * Hk, nsplit): block (bk, s) takes byte-rows
// [s * rows_per_split, (s + 1) * rows_per_split) into workspace slot
// bk * nsplit + s.
template <int G, int NBITS, int MODE>
__global__ void __launch_bounds__(NWARPS * 32) split_kernel(Args a) {
  const int r0 = blockIdx.y * a.rows_per_split;
  region_partials<G, NBITS, MODE>(a, blockIdx.x, r0,
                                  min(a.W, r0 + a.rows_per_split),
                                  blockIdx.x * gridDim.y + blockIdx.y);
}

// The bf16 decode-slot tail of one decode step (T = 0: none): K and V
// [B * Hk, T, D] bf16; slot t of region bk visible iff mask[bk * mstride + t].
struct Tail {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* mask;
  int T, mstride;
};

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
      const float pr = __shfl_sync(0xffffffffu, p, r);
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

// One KIVI layer's launches.  whole: whole_kernel (grid B * Hk) writes the
// partials straight to a's outputs when there is no tail; else the region
// kernel (whole_kernel, or split_kernel over grid (B * Hk, nsplit)) writes
// them to the workspace and finish_kernel merges them (and the tail).
template <int G, int NBITS, int MODE>
int launch(const Args& a, bool whole, float* ws_acc, float* ws_m, float* ws_l,
           int BHk, int nsplit, const Tail& t, __nv_bfloat16* out,
           cudaStream_t st) {
  if (whole && t.T == 0) {
    whole_kernel<G, NBITS, MODE><<<BHk, NWARPS * 32, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  Args w = a;
  w.acc = ws_acc;
  w.m = ws_m;
  w.l = ws_l;
  if (whole) {
    nsplit = 1;
    whole_kernel<G, NBITS, MODE><<<BHk, NWARPS * 32, 0, st>>>(w);
  } else {
    split_kernel<G, NBITS, MODE><<<dim3(BHk, nsplit), NWARPS * 32, 0, st>>>(w);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  finish_kernel<G><<<dim3(BHk, G), D, 0, st>>>(ws_acc, ws_m, ws_l, nsplit, a.q, t,
                                                a.scale, a.acc, a.m, a.l, out);
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
// ([B*Hk*nsplit, G, D] and [B*Hk*nsplit, G] f32; unused by the whole-region
// kernel without a tail); tk, tv, tmask, T, tmstride: the bf16 decode tail
// (Tail; T = 0 for none); out [B, Hk*G, D] bf16, written instead of
// (acc, m, l) when there is a tail.
#define PKVQ_PARAMS                                                          \
  const void *q, const void *kc, const void *ks, const void *kz,             \
      const void *vc, const void *vs, const void *vz, const void *mask,      \
      void *acc, void *m, void *l, void *ws_acc, void *ws_m, void *ws_l,     \
      int BHk, int G, int nbits, int W, int S_pad, int NG, int Dp, int NGV,  \
      int mstride, int n_valid, int nsplit, int rows_per_split, float scale, \
      const void *tk, const void *tv, const void *tmask, int T, int tmstride, \
      void *out, void *stream

// launch<GG, NB, MODE_> of the entry's arguments (inside PKVQ_DISPATCH).
#define PKVQ_LAUNCH(MODE_, WHOLE_, a_)                                        \
  pkvq::launch<GG, NB, MODE_>(                                                \
      a_, WHOLE_, (float*)ws_acc, (float*)ws_m, (float*)ws_l, BHk, nsplit,    \
      pkvq::Tail{(const __nv_bfloat16*)tk, (const __nv_bfloat16*)tv,          \
                 (const uint8_t*)tmask, T, tmstride},                         \
      (__nv_bfloat16*)out, (cudaStream_t)stream)

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
  a.rows_per_split = rows_per_split;
  a.scale = scale;
  return a;
}

}  // namespace pkvq
