// H2O heavy-hitter scores in two passes (sm_90a).
//
// Replaces: pyramidkv_tpu/kernels/h2o_scores.py::h2o_scores_pallas (Pallas
// TPU): pass 1 `_stats_kernel`, pass 2 `_colsum_kernel`.
//
// What it computes, per (batch row b, query head h) with pad = N -
// true_len[b] and the log2(e)/sqrt(D)-scaled query rounded to bf16 (the TPU
// wrapper's fold), logits s[r, c] = qs[r] . k[c] in f32:
//   visible(r, c) = c >= pad and not (r >= N-W and c >= N-W and c > r)
// (causal ONLY inside the trailing W x W block: the reference's quirk);
//   pass 1 (h2o_stats_kernel): m[r] = max_c s[r, c], l[r] = sum_c exp2(s -
//     m[r]) over the visible c, every row;
//   pass 2 (h2o_colsum_kernel): score[c] = sum_{r >= pad} exp2(s[r, c] -
//     m[r]) / max(l[r], 1e-30) for c < N - W, and -inf at c < pad.
// Columns c < N - W never lie in the W x W block, so pass 2 masks only the
// padding rows.
//
// What bounds it on the H100: operations.  Each pass computes every
// visible logit (B * H * true_len^2 of them, 2 * D flops each, on the
// tensor cores) and takes one exp2 of each (the MUFU unit, 16 a clock per
// SM), against only ~2 bytes of q or k per logit row and column.
//
// What the design does about it:
// - mma.sync m16n8k16 (bf16 operands, f32 accumulation) as in
//   flash_prefill.cu.  Pass 1 keeps a q tile's fragments in registers and
//   walks ALL key tiles past the pad (no triangular cut: the statistic is
//   non-causal outside the W x W block).  Pass 2 computes S transposed
//   (K Q^T): a block owns 64 keys, keeps their fragments in registers and
//   walks the query tiles past the pad in a fixed order, so each column sum
//   is a row sum of its own fragments, reduced over the 4 lanes of a group
//   at the end: no atomics, the same bits every run.
// - GQA without repeat_kv: query head h reads KV head h / (H / Hk).
// Left for later: TMA/wgmma, a copy pipeline, and the mask on interior
// tiles (every tile is masked here).

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 64;  // rows (pass 1: queries, pass 2: keys) per block
constexpr int BT = 64;  // tile of the walked axis (pass 1: keys, 2: queries)
constexpr int NTHREADS = 128;
constexpr int LDS = D + 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_scaled2(const __nv_bfloat16* p,
                                                 float scale) {
  float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16(f.x * scale, f.y * scale);
}

__device__ __forceinline__ uint32_t load_raw2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A-operand fragments of 16 rows (r, r + 8) of a [*, D] bf16 matrix, times
// `scale` and rounded to bf16 when SCALED.
template <bool SCALED>
__device__ __forceinline__ void load_a(uint32_t f[D / 16][4],
                                       const __nv_bfloat16* base, int r,
                                       int tig, float scale) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    const __nv_bfloat16* p0 = base + (size_t)r * D + c;
    const __nv_bfloat16* p1 = base + (size_t)(r + 8) * D + c;
    if (SCALED) {
      f[kk][0] = load_scaled2(p0, scale);
      f[kk][1] = load_scaled2(p1, scale);
      f[kk][2] = load_scaled2(p0 + 8, scale);
      f[kk][3] = load_scaled2(p1 + 8, scale);
    } else {
      f[kk][0] = load_raw2(p0);
      f[kk][1] = load_raw2(p1);
      f[kk][2] = load_raw2(p0 + 8);
      f[kk][3] = load_raw2(p1 + 8);
    }
  }
}

// S[16 rows x 64] = A (fragments) . T^T, T a [64, D] tile in shared memory.
__device__ __forceinline__ void tile_dot(float s[BT / 8][4],
                                         const uint32_t a[D / 16][4],
                                         const __nv_bfloat16* ts, int gid,
                                         int tig) {
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      const __nv_bfloat16* tp = &ts[(nt * 8 + gid) * LDS + kk * 16 + tig * 2];
      mma_bf16(s[nt], a[kk], *reinterpret_cast<const uint32_t*>(tp),
               *reinterpret_cast<const uint32_t*>(tp + 8));
    }
  }
}

// Pass 1: grid (N / BQ, B * H); row statistics m, l [B*H, N].
__global__ void __launch_bounds__(NTHREADS)
h2o_stats_kernel(const __nv_bfloat16* __restrict__ q,  // [B*H, N, D]
                 const __nv_bfloat16* __restrict__ k,  // [B*Hk, N, D]
                 const int* __restrict__ true_len, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int Hk, int N, int W,
                 float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[BT * LDS];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv_row = b * Hk + h / (H / Hk);
  const int pad = N - true_len[b];
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* mb = m_out + (size_t)bh * N;
  float* lb = l_out + (size_t)bh * N;
  if (q0 + BQ - 1 < pad) {  // padding rows only: pass 2 skips them
    if (tid < BQ) {
      mb[q0 + tid] = -FLT_MAX;
      lb[q0 + tid] = 0.f;
    }
    return;
  }
  const __nv_bfloat16* kb = k + (size_t)kv_row * N * D;
  const int r0 = q0 + warp * 16 + gid;  // fragment rows r0, r0 + 8
  uint32_t qf[D / 16][4];
  load_a<true>(qf, q + (size_t)bh * N * D, r0, tig, scale_log2);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int kt = pad / BT; kt < N / BT; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BT * D / 8 / NTHREADS; ++i) {
      const int idx = tid + i * NTHREADS;
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&ks[r * LDS + c]) =
          *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
    }
    __syncthreads();
    float s[BT / 8][4];
    tile_dot(s, qf, ks, gid, tig);
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + ((e >> 1) << 3);
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        const bool hid = col < pad || (row >= N - W && col >= N - W && col > row);
        if (hid) s[nt][e] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt)
        rs += exp2f(s[nt][2 * i] - m_use) + exp2f(s[nt][2 * i + 1] - m_use);
      l[i] = l[i] * exp2f(m[i] - m_use) + rs;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (tig == 0) {
      mb[r0 + 8 * i] = m[i] == -INFINITY ? -FLT_MAX : m[i];
      lb[r0 + 8 * i] = l[i];
    }
  }
}

// Pass 2: grid (ceil((N - W) / BQ), B * H); scores [B*H, N - W].
__global__ void __launch_bounds__(NTHREADS)
h2o_colsum_kernel(const __nv_bfloat16* __restrict__ q,  // [B*H, N, D]
                  const __nv_bfloat16* __restrict__ k,  // [B*Hk, N, D]
                  const int* __restrict__ true_len,
                  const float* __restrict__ m_in,       // [B*H, N]
                  const float* __restrict__ l_in,
                  float* __restrict__ out,              // [B*H, N - W]
                  int H, int Hk, int N, int W, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[BT * LDS];
  __shared__ float ms[BT], il[BT];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv_row = b * Hk + h / (H / Hk);
  const int pad = N - true_len[b];
  const int c0 = blockIdx.x * BQ;  // first key (column) of the block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nout = N - W;
  float* ob = out + (size_t)bh * nout;
  if (c0 + BQ - 1 < pad) {  // padding columns only
    if (tid < BQ && c0 + tid < nout) ob[c0 + tid] = -INFINITY;
    return;
  }
  const __nv_bfloat16* qb = q + (size_t)bh * N * D;
  const float* mb = m_in + (size_t)bh * N;
  const float* lb = l_in + (size_t)bh * N;
  const int r0 = c0 + warp * 16 + gid;  // this thread's keys r0, r0 + 8
  uint32_t kf[D / 16][4];
  load_a<false>(kf, k + (size_t)kv_row * N * D, r0, tig, 0.f);
  float cs[2] = {0.f, 0.f};

  for (int qt = pad / BT; qt < N / BT; ++qt) {
    const int t0 = qt * BT;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BT * D / 2 / NTHREADS; ++i) {
      const int idx = tid + i * NTHREADS;
      const int r = idx / (D / 2), c = (idx % (D / 2)) * 2;
      *reinterpret_cast<uint32_t*>(&qs[r * LDS + c]) =
          load_scaled2(qb + (size_t)(t0 + r) * D + c, scale_log2);
    }
    if (tid < BT) {
      const int row = t0 + tid;
      // padding rows add nothing: exp2(s - FLT_MAX) = 0, times 0
      ms[tid] = row >= pad ? fmaxf(mb[row], -FLT_MAX / 2) : FLT_MAX;
      il[tid] = row >= pad ? 1.f / fmaxf(lb[row], 1e-30f) : 0.f;
    }
    __syncthreads();
    float s[BT / 8][4];
    tile_dot(s, kf, qs, gid, tig);
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + tig * 2 + (e & 1);  // query in the tile
        cs[e >> 1] += exp2f(s[nt][e] - ms[j]) * il[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 1);
    cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 2);
    const int col = r0 + 8 * i;
    if (tig == 0 && col < nout) ob[col] = col >= pad ? cs[i] : -INFINITY;
  }
}

}  // namespace

// scale_log2: log2(e) / sqrt(D), folded into q (rounded to bf16) by both.
extern "C" int pkv_h2o_stats(const void* q, const void* k, const void* true_len,
                             void* m, void* l, int B, int H, int Hk, int N,
                             int W, float scale_log2, void* stream) {
  h2o_stats_kernel<<<dim3(N / BQ, B * H), NTHREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const int*)true_len,
      (float*)m, (float*)l, H, Hk, N, W, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" int pkv_h2o_colsum(const void* q, const void* k,
                              const void* true_len, const void* m,
                              const void* l, void* out, int B, int H, int Hk,
                              int N, int W, float scale_log2, void* stream) {
  dim3 grid((N - W + BQ - 1) / BQ, B * H);
  h2o_colsum_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const int*)true_len,
      (const float*)m, (const float*)l, (float*)out, H, Hk, N, W, scale_log2);
  return (int)cudaGetLastError();
}
