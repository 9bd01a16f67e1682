// Causal GQA flash-attention prefill over a left-padded buffer (sm_90a),
// normalised (one pass, or the two-pass schedule) or as online-softmax
// partials.
//
// Replaces: pyramidkv_tpu/kernels/flash_prefill.py::flash_causal_attention
// (Pallas TPU) in its default schedule (two_pass=False, body `_kernel`) and
// its two-pass schedule (two_pass=True: pass A `_max_kernel`, pass B
// `_kernel_pass_b`), sub_k=1, no softcap, with any `q_start`; and
// flash_prefill.py::flash_attention_partials (body `_kernel_partials`).
//
// What it computes, per batch row b with pad = N - true_len[b]: the Nq
// queries sit at global columns [q_start, q_start + Nq) of the N keys, and
//   out[b,h,r] = softmax_c(scale * q[b,h,r] . k[b,h/G,c]) @ v[b,h/G,c]
// over the visible keys c <= q_start + r, c >= pad (and q_start + r - c <
// window when a sliding window is set).  `flash_prefill_kernel` with
// q_start = 0 is the monolithic prefill, with q_start = N - Nq a prefill
// chunk; a row with no visible key writes 0, as the TPU kernel's `l == 0`
// guard does.  The partials entry writes instead the unnormalised f32
// accumulator and the base-2 statistics (m = max of the log2(e)-scaled
// logits, l = sum of exp2(s - m)); a row with no visible key gets m =
// float32.min, l = 0, acc = 0.  Its q_start is 0 (the causal self tile) or
// >= N (every key precedes every query: no causal edge).  The two-pass
// schedule splits the one-pass kernel's work in two launches: pass A
// (`pkv_flash_row_max`) writes each row's max m of the base-2 logits over
// its visible keys (float32.min for none); pass B (`pkv_flash_pass_b`)
// accumulates p = exp2(s - max(m, float32.min / 2)), l = sum p and
// acc = sum bf16(p) v against that known max, with no running max, no
// alpha exponential and no accumulator rescale, and writes acc / l (0
// where l = 0).
//
// What bounds it on the H100: operations.  At the prefill shapes of the main
// path (N = 8192, D = 128) attention does ~N/2 multiply-adds per byte of
// q/k/v, far above the card's ~295 flop/byte bf16 ridge, so the bound is the
// tensor-core rate, not HBM.
//
// What the design does about it:
// - The products run on the tensor cores with warp-level mma.sync
//   (m16n8k16, bf16 operands, f32 accumulation); q fragments stay in
//   registers for the whole key loop and the S -> P fragments are reused as
//   the A operand of P @ V without a trip through shared memory.
// - The triangular walk of the TPU kernel becomes the key-tile loop bounds:
//   a block only visits k-tiles between the pad/window edge and its causal
//   edge (global row q_start + r), so causally dead tiles are never loaded
//   or multiplied.
// - The heaviest q-tiles (last rows, longest key range) are scheduled first.
// - Online softmax in the exp2 domain with log2(e) folded into the q scaling,
//   q rounded to bf16 after scaling exactly as the TPU wrapper does.
// - The two-pass schedule uses the same tiling and walk in both passes; pass
//   A loads only K and does only the Q K^T products and a max per row, pass
//   B drops the online softmax's per-tile bookkeeping (the TPU schedule's
//   aim) at the price of a second Q K^T and a second read of K.
// Left for later: TMA/wgmma, a multi-stage copy pipeline and warp
// specialisation (tiles are loaded synchronously here).

#include <cuda_bf16.h>
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head dim (the only one the kernel takes)
constexpr int BQ = 64;        // q rows per block: 4 warps x 16 rows
constexpr int BK = 64;        // keys per k-tile
constexpr int NTHREADS = 128;
constexpr int LDS = D + 8;    // padded smem row (bf16): conflict-free fragments
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two consecutive bf16 of q, times `scale`, rounded back to bf16
__device__ __forceinline__ uint32_t load_q2(const __nv_bfloat16* p,
                                            float scale) {
  __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
  float2 f = __bfloat1622float2(x);
  return pack_bf16(f.x * scale, f.y * scale);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What a launch writes: kOut the normalised bf16 output (online softmax);
// kPartials (acc, m, l) f32; kRowMax pass A's row maxes m; kPassB pass B's
// normalised bf16 output, against the row maxes m_in of pass A.
enum Mode { kOut = 0, kPartials = 1, kRowMax = 2, kPassB = 3 };

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,   // [B*H, Nq, D]
                     const __nv_bfloat16* __restrict__ k,   // [B*Hk, ldk, D]
                     const __nv_bfloat16* __restrict__ v,   // [B*Hk, ldk, D]
                     const int* __restrict__ true_len,      // [B]
                     __nv_bfloat16* __restrict__ out,       // [B*H, Nq, D]
                     float* __restrict__ acc_out,           // [B*H, Nq, D]
                     float* __restrict__ m_out,             // [B*H, Nq]
                     float* __restrict__ l_out,             // [B*H, Nq]
                     const float* __restrict__ m_in,        // [B*H, Nq]
                     int H, int Hk, int N, int ldk, int Nq, int q_start,
                     int window, float scale_log2) {
  constexpr bool PARTIALS = MODE == kPartials;
  constexpr bool ROW_MAX = MODE == kRowMax;
  constexpr bool PASS_B = MODE == kPassB;
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[ROW_MAX ? 8 : BK * LDS];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q-tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv_row = b * Hk + h / (H / Hk);
  const int pad = N - true_len[b];
  const int q0 = qt * BQ;                  // local row of the tile's first
  const int g0 = q_start + q0;             // its global row
  const int last_row = g0 + BQ - 1;        // global
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group

  const __nv_bfloat16* qb = q + (size_t)bh * Nq * D;
  // keys [0, N) of a buffer of ldk rows per head (a prefill chunk reads the
  // first N rows of the bucket-long carry in place)
  const __nv_bfloat16* kb = k + (size_t)kv_row * ldk * D;
  const __nv_bfloat16* vb = v + (size_t)kv_row * ldk * D;

  if (last_row < pad) {  // every row is padding: no visible key
    if (ROW_MAX) {
      if (tid < BQ) m_out[(size_t)bh * Nq + q0 + tid] = -FLT_MAX;
    } else if (PARTIALS) {
      float* ab = acc_out + ((size_t)bh * Nq + q0) * D;
      for (int i = tid; i < BQ * D; i += NTHREADS) ab[i] = 0.f;
      if (tid < BQ) {
        m_out[(size_t)bh * Nq + q0 + tid] = -FLT_MAX;
        l_out[(size_t)bh * Nq + q0 + tid] = 0.f;
      }
    } else {
      const uint4 z = make_uint4(0, 0, 0, 0);
      __nv_bfloat16* ob = out + ((size_t)bh * Nq + q0) * D;
      for (int i = tid; i < BQ * D / 8; i += NTHREADS) {
        int r = i / (D / 8), c = (i % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(ob + (size_t)r * D + c) = z;
      }
    }
    return;
  }

  // local rows of this thread's accumulator fragments: r0 and r0 + 8
  const int r0 = q0 + warp * 16 + gid;
  const int gr0 = q_start + r0;  // global

  // q fragments (A operand, row-major 16x16 per k-step), scaled once
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = load_q2(qb + (size_t)r0 * D + c, scale_log2);
    qf[kk][1] = load_q2(qb + (size_t)(r0 + 8) * D + c, scale_log2);
    qf[kk][2] = load_q2(qb + (size_t)r0 * D + c + 8, scale_log2);
    qf[kk][3] = load_q2(qb + (size_t)(r0 + 8) * D + c + 8, scale_log2);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  if (PASS_B) {
    // pass A's maxes, clamped as the TPU's pass B clamps them: a row with
    // no visible key keeps p = exp2(-inf) = 0 and l = 0
#pragma unroll
    for (int i = 0; i < 2; ++i)
      m[i] = fmaxf(m_in[(size_t)bh * Nq + r0 + 8 * i], -FLT_MAX / 2);
  }

  int lo = pad;
  if (window > 0) lo = max(lo, g0 - window + 1);
  const int kt_begin = lo / BK;
  const int kt_end = min(last_row, N - 1) / BK;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < BK * D / 8 / NTHREADS; ++i) {
      const int idx = tid + i * NTHREADS;
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&ks[r * LDS + c]) =
          *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
      if (!ROW_MAX)
        *reinterpret_cast<uint4*>(&vs[r * LDS + c]) =
            *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
    }
    __syncthreads();

    // S = (q * scale * log2 e) K^T : 16 rows x 64 keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kp = &ks[(nt * 8 + gid) * LDS + kk * 16 + tig * 2];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }

    // mask: causal, left padding, sliding window
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gr0 + ((e >> 1) << 3);
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        bool ok = col <= row && col >= pad;
        if (window > 0) ok = ok && (row - col < window);
        if (!ok) s[nt][e] = -INFINITY;
      }
    }

    if (ROW_MAX) {  // pass A: this thread's share of each row's max
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
          m[i] = fmaxf(m[i], fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      continue;
    }

    if (PASS_B) {  // p = exp2(s - m) against the known max: no rescale
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const float p0 = exp2f(s[nt][2 * i] - m[i]);
          const float p1 = exp2f(s[nt][2 * i + 1] - m[i]);
          s[nt][2 * i] = p0;
          s[nt][2 * i + 1] = p1;
          rs += p0 + p1;
        }
        l[i] += rs;
      }
    }

    // online softmax, one update per fragment row (i = 0: r0, i = 1: r0+8)
#pragma unroll
    for (int i = 0; i < 2 && !PASS_B; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing visible yet keeps p == 0 and alpha == 0
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const float p0 = exp2f(s[nt][2 * i] - m_use);
        const float p1 = exp2f(s[nt][2 * i + 1] - m_use);
        s[nt][2 * i] = p0;
        s[nt][2 * i + 1] = p1;
        rs += p0 + p1;
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 (the TPU kernel's p.astype(v.dtype))
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = &vs[(kk * 16 + tig * 2) * LDS + dt * 8 + gid];
        const uint32_t b0 = pack_raw(vp[0], vp[LDS]);
        const uint32_t b1 = pack_raw(vp[8 * LDS], vp[9 * LDS]);
        mma_bf16(o[dt], a, b0, b1);
      }
    }
  }

  if (ROW_MAX) {  // the row's max over its row group's 4 threads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      if (tig == 0)
        m_out[(size_t)bh * Nq + r0 + 8 * i] = m[i] == -INFINITY ? -FLT_MAX : m[i];
    }
    return;
  }

  // finalize: full row sums across the 4 threads of a row group
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (PARTIALS) {
    float* ab = acc_out + (size_t)bh * Nq * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int c = dt * 8 + tig * 2;
      *reinterpret_cast<float2*>(ab + (size_t)r0 * D + c) =
          make_float2(o[dt][0], o[dt][1]);
      *reinterpret_cast<float2*>(ab + (size_t)(r0 + 8) * D + c) =
          make_float2(o[dt][2], o[dt][3]);
    }
    if (tig == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t row = (size_t)bh * Nq + r0 + 8 * i;
        m_out[row] = m[i] == -INFINITY ? -FLT_MAX : m[i];
        l_out[row] = l[i];
      }
    }
    return;
  }
  __nv_bfloat16* ob = out + (size_t)bh * Nq * D;
  const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + c) =
        pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + 8) * D + c) =
        pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int pkv_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* true_len, void* out, int B, int H,
                                 int Hk, int N, int ldk, int Nq, int q_start,
                                 int window, float scale, void* stream) {
  dim3 grid(Nq / BQ, B * H);
  flash_prefill_kernel<kOut><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)true_len, (__nv_bfloat16*)out,
      nullptr, nullptr, nullptr, nullptr, H, Hk, N, ldk, Nq, q_start, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// Pass A of the two-pass schedule: m [B*H, Nq] f32, the row maxes of the
// base-2 logits (float32.min for a row with no visible key).  Arguments as
// pkv_flash_prefill's.
extern "C" int pkv_flash_row_max(const void* q, const void* k,
                                 const void* true_len, void* m, int B, int H,
                                 int Hk, int N, int ldk, int Nq, int q_start,
                                 int window, float scale, void* stream) {
  dim3 grid(Nq / BQ, B * H);
  flash_prefill_kernel<kRowMax><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, nullptr,
      (const int*)true_len, nullptr, nullptr, (float*)m, nullptr, nullptr, H,
      Hk, N, ldk, Nq, q_start, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

// Pass B: out [B*H, Nq, D] bf16 from pass A's m [B*H, Nq].
extern "C" int pkv_flash_pass_b(const void* q, const void* k, const void* v,
                                const void* true_len, const void* m, void* out,
                                int B, int H, int Hk, int N, int ldk, int Nq,
                                int q_start, int window, float scale,
                                void* stream) {
  dim3 grid(Nq / BQ, B * H);
  flash_prefill_kernel<kPassB><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)true_len, (__nv_bfloat16*)out,
      nullptr, nullptr, nullptr, (const float*)m, H, Hk, N, ldk, Nq, q_start,
      window, scale * LOG2E);
  return (int)cudaGetLastError();
}

// acc [B*H, Nq, D], m, l [B*H, Nq] f32; q_start 0 (causal self tile,
// Nq == N) or >= N (all keys visible).
extern "C" int pkv_flash_partials(const void* q, const void* k, const void* v,
                                  const void* true_len, void* acc, void* m,
                                  void* l, int B, int H, int Hk, int N, int Nq,
                                  int q_start, float scale, void* stream) {
  dim3 grid(Nq / BQ, B * H);
  flash_prefill_kernel<kPartials><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)true_len, nullptr, (float*)acc,
      (float*)m, (float*)l, nullptr, H, Hk, N, N, Nq, q_start, 0,
      scale * LOG2E);
  return (int)cudaGetLastError();
}
