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
// the splits in a fixed order (deterministic); finish_kernel can also attend
// over the step's bf16 decode tail and write the layer's normalised bf16
// output.  whole_kernel (below) gives one block the whole region and the
// tail in one launch, with its own work split.

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

// ---------------------------------------------------------------------------
// The whole-region plan in one launch: whole_kernel, one block per (batch
// row, KV head), attends over the whole region (modes kF32 and kFold) and,
// given one, the step's bf16 decode tail, merges the two and writes the
// layer's bf16 output (or, without a tail, the region's partials).  It is
// latency-bound (bench.py's 32k snapkv kivi4: 32 blocks, 20 KB of region and
// 64 KB of tail each), so it keeps every warp busy and every load in flight:
// - a ring of WSTAGES stages in shared memory, filled with 16-byte cp.async
//   copies, streams items of 32 rows: the region's K and V code rows, then
//   the tail's K and V rows (tail items with no visible slot are skipped).
//   (1-D bulk copies into a deeper ring were slower here: 0.0131 against
//   0.0123 ms at bench.py's 32k snapkv kivi4);
// - a warp takes 4 rows of an item, 8 lanes a row (16 of the 128 channels
//   each), so a 64-byte-row region keeps all 8 warps busy; the logits are
//   summed over the 8 lanes by shuffles; P.V with 4 channels a lane;
// - the query (kFold: times the scale) and the K scale / zero columns (for up
//   to WNG_STAGED K groups) are staged in shared memory first, padded by 4
//   floats every 16 channels so the 8 lanes of a row hit 8 banks;
// - region and tail share each warp's online softmax (natural-log domain:
//   the tail's f32 logits of the bf16 q and K, as finish_kernel's); the
//   warps merge in shared memory.
// Numbers as region_partials: kF32 dequantizes each element in f32; kFold
// folds bf16(q * scale * ks) per code and q * scale * kz in f32 per channel,
// bf16(p * vs) and p * vz per V row and channel group.
constexpr int WROWS = 32;        // rows (byte-rows or tail slots) an item
constexpr int WSTAGES = 4;       // ring depth
constexpr int WNG_STAGED = 64;   // K groups staged in shared memory at most

// Padded index of channel d of a [D, n] column-major table (q: n = 1 per
// query; K scale / zero: n = NG): 4 floats of pad every 16 channels.
__host__ __device__ __forceinline__ int pad_idx(int d, int n, int col) {
  return d * n + col + 4 * (d >> 4);
}

// Bytes of one ring stage: an item's K rows (region: 32 x 128 code bytes;
// tail: 32 x 256) and V rows (32 x Dp code bytes, or 32 x 256).
__host__ __device__ inline int whole_stage_bytes(int Dp) {
  const int region = WROWS * D + WROWS * Dp;
  return ((region > 2 * WROWS * D * 2 ? region : 2 * WROWS * D * 2) + 15) / 16 * 16;
}

// Dynamic shared memory of whole_kernel: ring (at least 64 KB, which holds
// the warps' states afterwards: at most 33 KB), query, staged K scale /
// zero, tail visibility words and tail item list.
__host__ __device__ inline int whole_smem_bytes(int G, int NG, int Dp, int T) {
  const int staged = NG <= WNG_STAGED ? 2 * (D * NG + 4 * (D / 16)) * 4 : 0;
  const int ntail = (T + WROWS - 1) / WROWS;
  return WSTAGES * whole_stage_bytes(Dp) + G * (D + 4 * (D / 16)) * 4 + staged +
         8 * ntail;
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

template <int G, int NBITS, int MODE>
__global__ void __launch_bounds__(NWARPS * 32)
whole_kernel(Args a, Tail t, __nv_bfloat16* __restrict__ out) {
  static_assert(MODE != kPA, "the pa layout takes the split plan");
  constexpr bool FOLD = MODE == kFold;
  constexpr int PER = 8 / NBITS;
  constexpr uint32_t MASK = (1u << NBITS) - 1u;
  constexpr int QROW = D + 4 * (D / 16);  // padded floats of one query
  extern __shared__ __align__(16) uint8_t smem[];

  const int bk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.W, NG = a.NG, Dp = a.Dp;
  const int stage = whole_stage_bytes(Dp);
  const bool staged = NG <= WNG_STAGED;
  const int ntail = (t.T + WROWS - 1) / WROWS;
  float* qs = reinterpret_cast<float*>(smem + WSTAGES * stage);  // [G][QROW]
  float* kss = qs + G * QROW;                                     // staged ks
  float* kzs = kss + (staged ? D * NG + 4 * (D / 16) : 0);
  uint32_t* twords = reinterpret_cast<uint32_t*>(
      kzs + (staged ? D * NG + 4 * (D / 16) : 0));
  int* tlist = reinterpret_cast<int*>(twords + ntail);
  __shared__ int n_tail;
  const int nreg = (W + WROWS - 1) / WROWS;

  // the ring: item i goes to stage i % WSTAGES
  const char* kcb = reinterpret_cast<const char*>(a.kc) + (size_t)bk * W * D;
  const char* vcb = reinterpret_cast<const char*>(a.vc) + (size_t)bk * W * Dp;
  const char* tkb = reinterpret_cast<const char*>(t.k) + (size_t)bk * t.T * D * 2;
  const char* tvb = reinterpret_cast<const char*>(t.v) + (size_t)bk * t.T * D * 2;
  int n = nreg;  // items: the region's, then the visible tail's
  auto issue = [&](int i) {
    if (i >= n) {
      cp_async_commit();  // one group an item, empty past the list
      return;
    }
    uint8_t* st = smem + (i % WSTAGES) * stage;
    const char *ksrc, *vsrc;
    int kbytes, vbytes, voff;
    if (i < nreg) {
      const int r0 = i * WROWS, nr = min(WROWS, W - r0);
      ksrc = kcb + (size_t)r0 * D;
      vsrc = vcb + (size_t)r0 * Dp;
      kbytes = nr * D;
      vbytes = nr * Dp;
      voff = WROWS * D;
    } else {
      const int r0 = tlist[i - nreg] * WROWS, nr = min(WROWS, t.T - r0);
      ksrc = tkb + (size_t)r0 * D * 2;
      vsrc = tvb + (size_t)r0 * D * 2;
      kbytes = vbytes = nr * D * 2;
      voff = WROWS * D * 2;
    }
    for (int o = tid * 16; o < kbytes; o += NWARPS * 32 * 16) cp_async16(st + o, ksrc + o);
    for (int o = tid * 16; o < vbytes; o += NWARPS * 32 * 16) cp_async16(st + voff + o, vsrc + o);
    cp_async_commit();
  };

  // query (kF32: as it is; kFold: times the scale, as the plain qg), K
  // scale / zero copies (they land with item 0's group), tail words
  const __nv_bfloat16* qg = a.q + (size_t)bk * G * D;
  for (int i = tid; i < G * D; i += NWARPS * 32) {
    const float x = __bfloat162float(qg[i]);
    qs[(i / D) * QROW + pad_idx(i % D, 1, 0)] = FOLD ? x * a.scale : x;
  }
  const float* ksb = a.ks + (size_t)bk * D * NG;
  const float* kzb = a.kz + (size_t)bk * D * NG;
  if (staged) {
    // raw [D, NG] floats in 16-byte chunks; a chunk never straddles 16 dims
    for (int c4 = tid; c4 < D * NG / 4; c4 += NWARPS * 32) {
      const int o = 4 * c4, dst = o + 4 * ((o / NG) >> 4);
      cp_async16(kss + dst, ksb + o);
      cp_async16(kzs + dst, kzb + o);
    }
  }
  const float* ksp = staged ? kss : ksb;
  const float* kzp = staged ? kzs : kzb;
  const int kpad = staged ? 4 : 0;
  const uint8_t* tmb = t.mask + (size_t)bk * t.mstride;
  for (int h = warp; h < ntail; h += NWARPS) {
    const int s = h * WROWS + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, s < t.T && tmb[s] != 0);
    if (lane == 0) twords[h] = bits;
  }
  __syncthreads();
  if (warp == 0) {  // the tail items with a visible slot, in order
    int cnt = 0;
    for (int h0 = 0; h0 < ntail; h0 += 32) {
      const bool vis = h0 + lane < ntail && twords[h0 + lane] != 0;
      const uint32_t b = __ballot_sync(0xffffffffu, vis);
      if (vis) tlist[cnt + __popc(b & ((1u << lane) - 1u))] = h0 + lane;
      cnt += __popc(b);
    }
    if (lane == 0) n_tail = cnt;
  }
  __syncthreads();
  n = nreg + n_tail;
#pragma unroll
  for (int i = 0; i < WSTAGES - 1; ++i) issue(i);

  const int j = lane >> 3, c = lane & 7;
  const uint8_t* mb = a.mask + (size_t)bk * a.mstride;
  const float* vsb = a.vs + (size_t)bk * W * PER * a.NGV;
  const float* vzb = a.vz + (size_t)bk * W * PER * a.NGV;
  const int vgrp = (lane * 4) / a.vg;  // this lane's V channel group
  float m[G], lp[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lp[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    cp_async_wait<WSTAGES - 2>();  // item i has landed (this thread's part)
    __syncthreads();               // everyone's part; stage (i-1) is free
    issue(i + WSTAGES - 1);
    const uint8_t* st = smem + (i % WSTAGES) * stage;
    const int r = warp * 4 + j;  // this lane's row of the item

    if (i < nreg) {
      // ---- region rows: logits of byte-row jr, all PER planes ----------
      const int r0 = i * WROWS, jr = r0 + r;
      float s[PER][G];
      {
        int grp[PER];
        float dot[PER][G];
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          grp[p] = jr < W ? (jr + p * W) / a.kg : 0;
#pragma unroll
          for (int g = 0; g < G; ++g) dot[p][g] = 0.f;
        }
        const uint4 kw = *reinterpret_cast<const uint4*>(st + r * D + c * 16);
        const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int d0 = c * 16 + w * 4;
          float4 q4[G];
#pragma unroll
          for (int g = 0; g < G; ++g)
            q4[g] = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_idx(d0, 1, 0)]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int d = d0 + k;
#pragma unroll
            for (int p = 0; p < PER; ++p) {
              const float kv = code_f((words[w] >> (8 * k + p * NBITS)) & MASK);
              const int o = d * NG + grp[p] + kpad * (d >> 4);
              const float ksv = ksp[o], kzv = kzp[o];
#pragma unroll
              for (int g = 0; g < G; ++g) {
                const float qv = k == 0 ? q4[g].x : k == 1 ? q4[g].y : k == 2 ? q4[g].z : q4[g].w;
                if (FOLD)  // bf16(q * scale * ks) . code + (q * scale) . kz
                  dot[p][g] = fmaf(bf16_round(qv * ksv), kv, fmaf(qv, kzv, dot[p][g]));
                else
                  dot[p][g] = fmaf(qv, fmaf(kv, ksv, kzv), dot[p][g]);
              }
            }
          }
        }
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int slot = jr + p * W;
          const bool valid = jr < W && slot < a.n_valid && mb[slot] != 0;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float x = dot[p][g];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            x += __shfl_xor_sync(0xffffffffu, x, 4);
            s[p][g] = jr >= W ? -INFINITY : !valid ? NEG : (FOLD ? x : x * a.scale);
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
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[g], mx);
        if (mn == -INFINITY) {  // the warp's rows all lie past W
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
      const uint8_t* vst = st + WROWS * D;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int jv = r0 + warp * 4 + rr;
        if (jv >= W) continue;  // the same for the whole warp
        const uint32_t vw = *reinterpret_cast<const uint32_t*>(vst + (warp * 4 + rr) * Dp + lane * 4);
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const size_t o = (size_t)(jv + p * W) * a.NGV + vgrp;
          const float sc = __ldg(vsb + o), zr = __ldg(vzb + o);
          float vv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float cv = code_f((vw >> (8 * k + p * NBITS)) & MASK);
            vv[k] = FOLD ? cv : fmaf(cv, sc, zr);
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pj = __shfl_sync(0xffffffffu, e[p][g], rr * 8);
            if (FOLD) {
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
      const int h = tlist[i - nreg];
      const uint4 k0 = *reinterpret_cast<const uint4*>(st + r * D * 2 + c * 16);
      const uint4 k1 = *reinterpret_cast<const uint4*>(st + r * D * 2 + (c + 8) * 16);
      const __nv_bfloat162* ka = reinterpret_cast<const __nv_bfloat162*>(&k0);
      const __nv_bfloat162* kb2 = reinterpret_cast<const __nv_bfloat162*>(&k1);
      const bool vis = (twords[h] >> r) & 1u;  // 0 past T
      float e[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 qa0 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_idx(8 * c, 1, 0)]);
        const float4 qa1 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_idx(8 * c + 4, 1, 0)]);
        const float4 qc0 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_idx(64 + 8 * c, 1, 0)]);
        const float4 qc1 = *reinterpret_cast<const float4*>(&qs[g * QROW + pad_idx(68 + 8 * c, 1, 0)]);
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
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        e[g] = vis ? (FOLD ? x : x * a.scale) : -INFINITY;  // logit for now
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = e[g];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[g], mx);
        if (mx == -INFINITY) {  // no visible slot among the warp's 4
          e[g] = 0.f;
          continue;
        }
        const float alpha = expf(m[g] - mn);  // 0 while m = -inf or float32.min
        e[g] = e[g] == -INFINITY ? 0.f : expf(e[g] - mn);
        lp[g] = fmaf(lp[g], alpha, e[g]);
        acc[g][0] *= alpha;
        acc[g][1] *= alpha;
        acc[g][2] *= alpha;
        acc[g][3] *= alpha;
        m[g] = mn;
      }
      const uint8_t* vst = st + WROWS * D * 2;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        if (!((twords[h] >> (warp * 4 + rr)) & 1u)) continue;  // warp-uniform
        const uint2 vw = *reinterpret_cast<const uint2*>(vst + (warp * 4 + rr) * D * 2 + lane * 8);
        const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.x));
        const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.y));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(0xffffffffu, e[g], rr * 8);
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
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lw = lp[g];  // the 4 row groups' sums
    lw += __shfl_xor_sync(0xffffffffu, lw, 8);
    lw += __shfl_xor_sync(0xffffffffu, lw, 16);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = lw;
    }
    *reinterpret_cast<float4*>(&wacc[(warp * G + g) * D + lane * 4]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();

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
  }
}

// One KIVI layer's launches.  whole: whole_kernel (grid B * Hk) in one
// launch, writing the partials to a's outputs, or with a tail the layer's
// output; else split_kernel over grid (B * Hk, nsplit) writes the partials
// to the workspace and finish_kernel merges them (and the tail).
template <int G, int NBITS, int MODE>
int launch(const Args& a, bool whole, float* ws_acc, float* ws_m, float* ws_l,
           int BHk, int nsplit, const Tail& t, __nv_bfloat16* out,
           cudaStream_t st) {
  if (whole) {
    if constexpr (MODE == kPA) {
      return (int)cudaErrorInvalidValue;
    } else {
      // the 16-byte copies: 4-byte V rows, items of a multiple of 4 rows
      if (a.Dp % 4 || a.W % 4) return (int)cudaErrorInvalidValue;
      const int smem = whole_smem_bytes(G, a.NG, a.Dp, t.T);
      static int smem_set = 48 * 1024;  // per instantiation
      if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            whole_kernel<G, NBITS, MODE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
      }
      whole_kernel<G, NBITS, MODE><<<BHk, NWARPS * 32, smem, st>>>(a, t, out);
      return (int)cudaGetLastError();
    }
  }
  Args w = a;
  w.acc = ws_acc;
  w.m = ws_m;
  w.l = ws_l;
  split_kernel<G, NBITS, MODE><<<dim3(BHk, nsplit), NWARPS * 32, 0, st>>>(w);
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
