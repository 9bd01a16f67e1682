// One-token masked decode attention over the slot cache (sm_90a).
//
// Replaces: pyramidkv_tpu/kernels/decode_attn.py::decode_attention_pallas
// (Pallas TPU, body `_kernel`).
//
// What it computes, for each batch row b and query head h = kvh * G + g:
//   logits[s] = (q[b,h] . k[b,kvh,s]) / sqrt(D)   (f32), float32.min where
//   mask[b,kvh,s] is false; out[b,h] = softmax(logits) @ v[b,kvh].
// G = H / Hk is 1 for the per-query-head caches of snapkv/pyramidkv and 4
// for fullkv's true-GQA cache on Llama-3-8B.  A row whose slots are all
// masked averages every slot uniformly, exactly like the float32.min
// convention of the TPU kernel.  S is unbounded: the TPU's 4096-slot cap was
// a VMEM limit, and fullkv decodes over 8192 + decode slots.
//
// What bounds it on the H100: bytes.  Every K and V row is read once and
// used for G <= 8 dot products, ~G/2 flop per byte, far below the ridge.
//
// What the design does about it: one block per (b, kv head) streams the
// whole [S, D] K/V strip once for the group's G queries (grouped compute, no
// repeat_kv copy).  Its 8 warps split S into 32-slot chunks and keep their
// own online softmax, so each warp has 16 independent 16-byte K loads and 32
// V loads in flight per chunk; the partial (m, l, acc) of the warps merge in
// shared memory at the end.  Differences from the TPU kernel: the softmax is
// online (not single-pass), and the probabilities stay f32 in the PV product
// instead of being rounded to V's dtype first.
// Left for later: a split over S across blocks (flash-decoding) for the
// B * Hk = 32 blocks of the fullkv case, which occupy only part of the card.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int NWARPS = 8;
constexpr int CHUNK = 32;  // slots per warp iteration (one per lane)

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

template <int G>
__global__ void __launch_bounds__(NWARPS * 32)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hk*G, D]
                   const __nv_bfloat16* __restrict__ k,   // [B, Hk, S, D]
                   const __nv_bfloat16* __restrict__ v,   // [B, Hk, S, D]
                   const uint8_t* __restrict__ mask,      // [B, Hk, S]
                   __nv_bfloat16* __restrict__ out,       // [B, Hk*G, D]
                   int S, float scale) {
  __shared__ __align__(16) float qs[G][D];
  __shared__ float wm[NWARPS][G];
  __shared__ float wl[NWARPS][G];
  __shared__ __align__(16) float wacc[NWARPS][G][D];

  const int bk = blockIdx.x;  // b * Hk + kvh
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the group's G query rows are consecutive in [B, H, D]
  const __nv_bfloat16* qg = q + (size_t)bk * G * D;
  for (int i = tid; i < G * D; i += NWARPS * 32) {
    qs[i / D][i % D] = __bfloat162float(qg[i]);
  }
  __syncthreads();

  const __nv_bfloat16* kb = k + (size_t)bk * S * D;
  const __nv_bfloat16* vb = v + (size_t)bk * S * D;
  const uint8_t* mb = mask + (size_t)bk * S;

  float m[G], lpart[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lpart[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }

  for (int c0 = warp * CHUNK; c0 < S; c0 += NWARPS * CHUNK) {
    const int slot = c0 + lane;
    float s[G];
    if (slot < S) {
      // lane-per-slot logits: the lane reads its whole 256-byte K row
      const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)slot * D);
      uint4 kv[D / 8];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) kv[i] = kr[i];
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&kv[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(p2[j]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float2 qq = *reinterpret_cast<const float2*>(&qs[g][i * 8 + 2 * j]);
            dot[g] = fmaf(qq.x, f.x, dot[g]);
            dot[g] = fmaf(qq.y, f.y, dot[g]);
          }
        }
      }
      const bool valid = mb[slot] != 0;
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = valid ? dot[g] * scale : -FLT_MAX;
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = -INFINITY;  // beyond S: not a slot
    }

    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // slot c0 < S always exists, so m_new is finite
      const float m_new = fmaxf(m[g], warp_max(s[g]));
      const float alpha = expf(m[g] - m_new);
      p[g] = expf(s[g] - m_new);
      lpart[g] = lpart[g] * alpha + p[g];
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
      acc[g][2] *= alpha;
      acc[g][3] *= alpha;
      m[g] = m_new;
    }

    // PV: lane owns head-dim columns [4 * lane, 4 * lane + 4)
    const int nrows = min(CHUNK, S - c0);
    uint2 vr[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j < nrows) {
        vr[j] = *reinterpret_cast<const uint2*>(vb + (size_t)(c0 + j) * D + lane * 4);
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j < nrows) {
        const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vr[j].x));
        const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vr[j].y));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(0xffffffffu, p[g], j);
          acc[g][0] = fmaf(pj, f0.x, acc[g][0]);
          acc[g][1] = fmaf(pj, f0.y, acc[g][1]);
          acc[g][2] = fmaf(pj, f1.x, acc[g][2]);
          acc[g][3] = fmaf(pj, f1.y, acc[g][3]);
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lw = warp_sum(lpart[g]);
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = lw;
    }
    *reinterpret_cast<float4*>(&wacc[warp][g][lane * 4]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();

  __nv_bfloat16* ob = out + (size_t)bk * G * D;
  for (int i = tid; i < G * D; i += NWARPS * 32) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, wm[w][g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(wm[w][g] - mx);  // idle warps: exp(-inf) = 0
      l += wl[w][g] * f;
      o += wacc[w][g][d] * f;
    }
    ob[i] = __float2bfloat16(o / l);
  }
}

template <int G>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int B, int Hk, int S, float scale, cudaStream_t stream) {
  decode_attn_kernel<G><<<B * Hk, NWARPS * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const uint8_t*)mask, (__nv_bfloat16*)out, S,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code; cudaErrorInvalidValue for an unsupported G.
extern "C" int pkv_decode_attn(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int B, int H,
                               int Hk, int S, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (H / Hk) {
    case 1: return launch<1>(q, k, v, mask, out, B, Hk, S, scale, st);
    case 2: return launch<2>(q, k, v, mask, out, B, Hk, S, scale, st);
    case 4: return launch<4>(q, k, v, mask, out, B, Hk, S, scale, st);
    case 8: return launch<8>(q, k, v, mask, out, B, Hk, S, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
