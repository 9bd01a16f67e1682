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
// window when a sliding window is set).  `pkv_flash_prefill` with
// q_start = 0 is the monolithic prefill, with q_start = N - Nq a prefill
// chunk; a row with no visible key writes 0, as the TPU kernel's `l == 0`
// guard does.  `pkv_flash_partials` writes instead the unnormalised f32
// accumulator and the base-2 statistics (m = max of the log2(e)-scaled
// logits, l = sum of exp2(s - m)); a row with no visible key gets m =
// float32.min, l = 0, acc = 0.  Its q_start is 0 (the causal self tile) or
// >= N (every key precedes every query: no causal edge).  The two-pass
// schedule splits the one-pass work in two launches: pass A
// (`pkv_flash_row_max`) writes each row's max m of the base-2 logits over
// its visible keys (float32.min for none); pass B (`pkv_flash_pass_b`)
// accumulates p = exp2(s - max(m, float32.min / 2)), l = sum p and
// acc = sum bf16(p) v against that known max, with no running max, no
// alpha exponential and no accumulator rescale, and writes acc / l (0
// where l = 0).
//
// What bounds it on the H100: operations.  At the prefill shapes of the main
// path (N = 8192-32768, D = 128) attention does ~N/2 multiply-adds per byte
// of q/k/v, far above the card's ~295 flop/byte bf16 ridge, so the bound is
// the tensor-core rate (4 D flops a visible pair), not HBM; next comes the
// MUFU's exp2 rate (one a visible pair, about half the tensor-core time).
//
// The one-pass, partials and pass-B entries (`flash_wgmma_kernel`) are
// built for that bound:
// - a block takes 128 query rows of one (b, h): two consumer warpgroups of
//   64 rows and a producer warpgroup whose one thread starts every copy.
//   Q, K and V are copied by the copy engine through tensor maps with
//   128-byte swizzle (a 128-wide row is two 64-wide boxes; K and V are
//   {D, N, B*Hk} with a row stride of ldk, so a chunk reads the carry in
//   place, and rows >= N arrive as zeros and are masked) into a ring of
//   STAGES 128-key tiles, each K and V tile completing on its own mbarrier
//   and released on its own once the products that read it are done;
// - both products run on wgmma: S = Q K^T (m64n128k16, Q and K read from
//   shared memory through K-major descriptors) and O += P V (P from
//   registers, where the S accumulator's layout is already the A operand's
//   after rounding to bf16; V read MN-major, the transpose bit);
// - a warpgroup waits for each product before the next step, so S, P and O
//   fit the 168 registers a thread of the 384 has (ptxas allocates the
//   consumers within them whatever setmaxnreg grants: issuing tile i's
//   Q K^T beside tile i-1's P V needs all three live and spilled, 1.2x
//   slower on the card); the two consumer warpgroups' softmax and products
//   interleave on the SM instead;
// - Q is scaled by scale * log2(e) and rounded to bf16 in shared memory once
//   a block (the TPU wrapper's fold), then fenced for the async proxy;
// - each block walks only the key tiles from its pad or window edge to its
//   causal edge (a history tile, q_start >= N, has none), and masks only
//   the tiles that are not interior (the TPU kernel's `interior` flag): the
//   diagonal, the pad edge, the window edge and a tile cut short by N;
//   kernels/flash_prefill.py::flash_tile_plan mirrors the plan;
// - q tiles are launched heaviest first across all heads;
// - online softmax in base 2, P rounded to bf16 before P V (the TPU's
//   p.astype(v.dtype)), no atomics and a fixed order (bitwise repeatable);
// - pass B runs the same pipeline against pass A's known row maxes: P =
//   exp2(S - m) with no running max, no alpha and no accumulator rescale
//   (m clamped at float32.min / 2 and edge tiles masked to float32.min, as
//   the TPU's pass B, so a row with no visible key gets l = 0 and writes 0).
// Pass A (`row_max_kernel`) keeps the first port's warp-level mma.sync
// design: 64-row q tiles, key tiles loaded synchronously by all threads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int D = 128;        // head dim (the only one the kernels take)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What a launch of flash_wgmma_kernel writes: kOut the normalised bf16
// output (online softmax); kPartials (acc, m, l) f32; kPassB pass B's
// normalised bf16 output, against the row maxes m_in of pass A.
enum Mode { kOut = 0, kPartials = 1, kPassB = 2 };

// ---------------------------------------------------------------------------
// Pass A of the two-pass schedule: warp-level mma.sync, 64-row q tiles,
// 64-key tiles.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // q rows per block: 4 warps x 16 rows
constexpr int BK = 64;        // keys per k-tile
constexpr int NTHREADS = 128;
constexpr int LDS = D + 8;    // padded smem row (bf16): conflict-free fragments

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

// grid (Nq / BQ, B*H): m_out [B*H, Nq], each row's max base-2 logit over
// its visible keys (float32.min for none).
__global__ void __launch_bounds__(NTHREADS)
row_max_kernel(const __nv_bfloat16* __restrict__ q,   // [B*H, Nq, D]
               const __nv_bfloat16* __restrict__ k,   // [B*Hk, ldk, D]
               const int* __restrict__ true_len,      // [B]
               float* __restrict__ m_out,             // [B*H, Nq]
               int H, int Hk, int N, int ldk, int Nq, int q_start,
               int window, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDS];

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

  if (last_row < pad) {  // every row is padding: no visible key
    if (tid < BQ) m_out[(size_t)bh * Nq + q0 + tid] = -FLT_MAX;
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

  float m[2] = {-INFINITY, -INFINITY};
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

    // mask (causal, left padding, sliding window), then this thread's
    // share of each row's max
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gr0 + ((e >> 1) << 3);
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        bool ok = col <= row && col >= pad;
        if (window > 0) ok = ok && (row - col < window);
        if (ok) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
      }
    }
  }

  // the row's max over its row group's 4 threads
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    if (tig == 0)
      m_out[(size_t)bh * Nq + r0 + 8 * i] = m[i] == -INFINITY ? -FLT_MAX : m[i];
  }
}

// ---------------------------------------------------------------------------
// One pass and partials: TMA ring, wgmma, warp-specialised.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;       // q rows a block: 2 consumer warpgroups x 64
constexpr int BK = 128;       // keys a tile
constexpr int STAGES = 2;     // K and V tiles in flight
constexpr int NTHREADS = 384; // producer warpgroup + 2 consumer warpgroups
constexpr int BOX = 64;       // bf16 columns of one 128-byte swizzled box
constexpr int Q_HALF = BQ * 128;         // bytes of one box column of Q
constexpr int KV_HALF = BK * 128;        // of K or V
constexpr int TILE_BYTES = 2 * KV_HALF;  // one K or V tile (both boxes)
constexpr int WG_Q_BYTES = 64 * 128;     // a warpgroup's rows of one box
constexpr int SMEM_BYTES = 1024 + 2 * Q_HALF + 2 * STAGES * TILE_BYTES;

// D[64 x 128] += A B, A from registers (4 x bf16x2 a thread), B MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// S = Q K^T for one warpgroup: 64 rows x 128 keys, 8 steps of 16 along D
// (four 32-byte steps within each 64-column box).
__device__ __forceinline__ void qk_product(float (&s)[64], uint32_t q_addr,
                                           uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t dq = (kk >> 2) * Q_HALF + (kk & 3) * 32;
    const uint32_t dk = (kk >> 2) * KV_HALF + (kk & 3) * 32;
    wgmma_ss(s, sw128_desc(q_addr + dq, 16, 1024),
             sw128_desc(k_addr + dk, 16, 1024), kk > 0);
  }
}

// O += P V for one warpgroup: 8 steps of 16 keys (2048 bytes of V each).
__device__ __forceinline__ void pv_product(float (&o)[64],
                                           const uint32_t (&p)[32],
                                           uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             sw128_desc(v_addr + kk * 16 * 128, KV_HALF, 1024));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Two bf16 times `scale`, rounded back to bf16.
__device__ __forceinline__ uint32_t scale2(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// The online softmax of one tile for this thread's two rows (i = 0: the
// accumulator entries 4j, 4j+1, row `grow`; i = 1: 4j+2, 4j+3, row grow+8),
// masked elementwise only on an edge tile: s becomes p = exp2(s - m_new).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int c0, int grow,
                                             int tig, int pad, int N,
                                             int window) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = grow + ((e >> 1) << 3);
        const int col = c0 + j * 8 + tig * 2 + (e & 1);
        bool ok = col >= pad && col <= row && col < N;
        if (window > 0) ok = ok && row - col < window;
        if (!ok) s[4 * j + e] = -INFINITY;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    // a row with nothing visible yet keeps p == 0 and alpha == 0
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[i] = exp2f(m[i] - m_use);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = exp2f(s[4 * j + 2 * i] - m_use);
      const float p1 = exp2f(s[4 * j + 2 * i + 1] - m_use);
      s[4 * j + 2 * i] = p0;
      s[4 * j + 2 * i + 1] = p1;
      rs += p0 + p1;
    }
    l[i] = l[i] * alpha[i] + rs;
    m[i] = m_new;
  }
}

// Pass B's tile for this thread's two rows: s becomes p = exp2(s - m)
// against the rows' known maxes m (pass A's, at least float32.min / 2), and
// l gains sum p; no running max, no alpha, no rescale.  An edge tile masks
// elementwise to float32.min, as the TPU's pass B: p = 0 there, and a row
// with no visible key (m clamped to float32.min / 2) keeps l = 0.
__device__ __forceinline__ void known_max_tile(float (&s)[64],
                                               const float (&m)[2],
                                               float (&l)[2], bool edge,
                                               int c0, int grow, int tig,
                                               int pad, int N, int window) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = grow + ((e >> 1) << 3);
        const int col = c0 + j * 8 + tig * 2 + (e & 1);
        bool ok = col >= pad && col <= row && col < N;
        if (window > 0) ok = ok && row - col < window;
        if (!ok) s[4 * j + e] = -FLT_MAX;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = exp2f(s[4 * j + 2 * i] - m[i]);
      const float p1 = exp2f(s[4 * j + 2 * i + 1] - m[i]);
      s[4 * j + 2 * i] = p0;
      s[4 * j + 2 * i + 1] = p1;
      rs += p0 + p1;
    }
    l[i] += rs;
  }
}

// P rounded to bf16 in the A-operand layout of P V: for keys [16kk, 16kk+16)
// (accumulator chunks 2kk and 2kk+1), a0/a2 row grow, a1/a3 row grow + 8.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[32]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&a)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    o[4 * j + 0] *= a[0];
    o[4 * j + 1] *= a[0];
    o[4 * j + 2] *= a[1];
    o[4 * j + 3] *= a[1];
  }
}

// grid (B*H, ceil(Nq / BQ)), NTHREADS threads, SMEM_BYTES of dynamic shared
// memory.  Maps: q {D, Nq, B*H}, k and v {D, N, B*Hk} (row stride ldk), all
// bf16, boxes {64, 128, 1}, 128-byte swizzle.  kOut and kPassB write out
// [B*H, Nq, D] bf16 (kPassB against m_in [B*H, Nq], pass A's row maxes);
// kPartials acc [B*H, Nq, D], m, l [B*H, Nq] f32.
template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const int* __restrict__ true_len,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out,
                   const float* __restrict__ m_in, int H, int Hk, int N,
                   int Nq, int q_start, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[STAGES], v_full[STAGES],
      k_empty[STAGES], v_empty[STAGES];
  // 128-byte swizzle repeats every 1024 bytes: boxes start 1024-aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                            // [2 boxes][BQ][128 B]
  uint8_t* kring = qs + 2 * Q_HALF;              // [STAGES][2][BK][128 B]
  uint8_t* vring = kring + STAGES * TILE_BYTES;  // the same

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest q tiles first
  const int b = bh / H;
  const int kv_row = b * Hk + (bh % H) / (H / Hk);
  const int pad = N - true_len[b];
  // The block's key-tile plan (kernels/flash_prefill.py::flash_tile_plan):
  // from the pad or window edge of its first row to the causal edge of its
  // last (no causal edge past N: a history tile sees every key).
  const int g0 = q_start + qt * BQ;               // first global row
  const int g1 = min(g0 + BQ, q_start + Nq) - 1;  // last real global row
  const int lo = window > 0 ? max(pad, g0 - window + 1) : pad;
  const int hi = min(g1, N - 1);
  const int kt_first = lo / BK;
  const int kt_last = hi / BK;                     // the causal edge's tile
  const int ntiles = lo > hi ? 0 : kt_last - kt_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], 256);
      mbar_init(&v_empty[i], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && ntiles > 0) {
      mbar_expect(&q_full, 2 * Q_HALF);
      tma_load_3d(qs, &qmap, 0, qt * BQ, bh, &q_full);
      tma_load_3d(qs + Q_HALF, &qmap, BOX, qt * BQ, bh, &q_full);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        const int row = (kt_first + i) * BK;
        if (i >= STAGES) mbar_wait(&k_empty[st], ((i / STAGES) - 1) & 1);
        uint8_t* kd = kring + st * TILE_BYTES;
        mbar_expect(&k_full[st], TILE_BYTES);
        tma_load_3d(kd, &kmap, 0, row, kv_row, &k_full[st]);
        tma_load_3d(kd + KV_HALF, &kmap, BOX, row, kv_row, &k_full[st]);
        if (i >= STAGES) mbar_wait(&v_empty[st], ((i / STAGES) - 1) & 1);
        uint8_t* vd = vring + st * TILE_BYTES;
        mbar_expect(&v_full[st], TILE_BYTES);
        tma_load_3d(vd, &vmap, 0, row, kv_row, &v_full[st]);
        tma_load_3d(vd + KV_HALF, &vmap, BOX, row, kv_row, &v_full[st]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wgi - 1;                  // consumer warpgroup: 64 rows
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31, tig = lane & 3;
    const int r0 = qt * BQ + cw * 64 + warp * 16 + (lane >> 2);  // local
    const int grow = q_start + r0;           // global; row r0 + 8 likewise

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // per-thread partial row sums
    if constexpr (MODE == kPassB) {
      // pass A's maxes, clamped as the TPU's pass B clamps them (rows past
      // Nq, in a q tile cut short, are never written)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        m[i] = r0 + 8 * i < Nq
                   ? fmaxf(m_in[(size_t)bh * Nq + r0 + 8 * i], -FLT_MAX / 2)
                   : 0.f;
    }

    if (ntiles > 0) {
      // q * scale * log2(e), rounded to bf16, in place (this warpgroup's 64
      // rows of both boxes), then fenced for wgmma's async-proxy reads
      mbar_wait(&q_full, 0);
#pragma unroll
      for (int i = 0; i < 2 * WG_Q_BYTES / 16 / 128; ++i) {
        const int c = tid + 128 * i;  // 16-byte chunk
        uint4* p = reinterpret_cast<uint4*>(
            qs + (c / (WG_Q_BYTES / 16)) * Q_HALF + cw * WG_Q_BYTES +
            (c % (WG_Q_BYTES / 16)) * 16);
        uint4 x = *p;
        x.x = scale2(x.x, scale_log2);
        x.y = scale2(x.y, scale_log2);
        x.z = scale2(x.z, scale_log2);
        x.w = scale2(x.w, scale_log2);
        *p = x;
      }
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);

      const uint32_t q_addr = smem_addr(qs) + cw * WG_Q_BYTES;
      const uint32_t kring_a = smem_addr(kring);
      const uint32_t vring_a = smem_addr(vring);
      float s[64];
      uint32_t p[32];
      // per tile: S = Q K^T, the softmax, O += P V, each product waited
      // before the next step (the other warpgroup's products fill the
      // tensor cores meanwhile); a tile's K is released as soon as S is in
      // registers
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        const int c0 = (kt_first + i) * BK;
        // interior: every pair of the block's rows and the tile's keys is
        // visible (past the pad, causal, inside N and the window)
        const bool interior = c0 >= pad && c0 + BK - 1 <= g0 &&
                              c0 + BK <= N &&
                              (window <= 0 || g1 - c0 < window);
        mbar_wait(&k_full[st], (i / STAGES) & 1);
        const uint32_t k_addr = kring_a + st * TILE_BYTES;
        wgmma_fence();
        qk_product(s, q_addr, k_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        mbar_arrive(&k_empty[st]);
        if constexpr (MODE == kPassB) {
          known_max_tile(s, m, l, !interior, c0, grow, tig, pad, N, window);
        } else {
          float alpha[2];
          softmax_tile(s, m, l, alpha, !interior, c0, grow, tig, pad, N,
                       window);
          rescale(o, alpha);
        }
        pack_p(s, p);
        mbar_wait(&v_full[st], (i / STAGES) & 1);
        wgmma_fence();
        pv_product(o, p, vring_a + st * TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&v_empty[st]);
      }
    }

    // full row sums across the 4 threads of a row group, then the rows
    // that exist (a block's last q tile may be cut short by Nq)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= Nq) continue;
      const size_t row = (size_t)bh * Nq + r;
      if (MODE == kPartials) {
        float* ab = acc_out + row * D;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(ab + j * 8 + tig * 2) =
              make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
        if (tig == 0) {
          m_out[row] = m[i] == -INFINITY ? -FLT_MAX : m[i];
          l_out[row] = l[i];
        }
      } else {
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
        __nv_bfloat16* ob = out + row * D;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(ob + j * 8 + tig * 2) = pack_bf16(
              o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

template <int MODE>
int launch(const void* q, const void* k, const void* v, const void* true_len,
           void* out, void* acc, void* m, void* l, const void* m_in, int B,
           int H, int Hk, int N, int ldk, int Nq, int q_start, int window,
           float scale, void* stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, Nq, B * H, Nq, BQ) ||
      !make_map(&km, k, N, B * Hk, ldk, BK) ||
      !make_map(&vm, v, N, B * Hk, ldk, BK))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid(B * H, (Nq + BQ - 1) / BQ);
  flash_wgmma_kernel<MODE><<<grid, NTHREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      qm, km, vm, (const int*)true_len, (__nv_bfloat16*)out, (float*)acc,
      (float*)m, (float*)l, (const float*)m_in, H, Hk, N, Nq, q_start, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" int pkv_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* true_len, void* out, int B, int H,
                                 int Hk, int N, int ldk, int Nq, int q_start,
                                 int window, float scale, void* stream) {
  return wg::launch<kOut>(q, k, v, true_len, out, nullptr, nullptr, nullptr,
                          nullptr, B, H, Hk, N, ldk, Nq, q_start, window,
                          scale, stream);
}

// Pass A of the two-pass schedule: m [B*H, Nq] f32, the row maxes of the
// base-2 logits (float32.min for a row with no visible key).  Arguments as
// pkv_flash_prefill's.
extern "C" int pkv_flash_row_max(const void* q, const void* k,
                                 const void* true_len, void* m, int B, int H,
                                 int Hk, int N, int ldk, int Nq, int q_start,
                                 int window, float scale, void* stream) {
  dim3 grid(Nq / BQ, B * H);
  row_max_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const int*)true_len,
      (float*)m, H, Hk, N, ldk, Nq, q_start, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

// Pass B: out [B*H, Nq, D] bf16 from pass A's m [B*H, Nq].
extern "C" int pkv_flash_pass_b(const void* q, const void* k, const void* v,
                                const void* true_len, const void* m, void* out,
                                int B, int H, int Hk, int N, int ldk, int Nq,
                                int q_start, int window, float scale,
                                void* stream) {
  return wg::launch<kPassB>(q, k, v, true_len, out, nullptr, nullptr, nullptr,
                            m, B, H, Hk, N, ldk, Nq, q_start, window, scale,
                            stream);
}

// acc [B*H, Nq, D], m, l [B*H, Nq] f32; q_start 0 (causal self tile,
// Nq == N) or >= N (all keys visible).
extern "C" int pkv_flash_partials(const void* q, const void* k, const void* v,
                                  const void* true_len, void* acc, void* m,
                                  void* l, int B, int H, int Hk, int N, int Nq,
                                  int q_start, float scale, void* stream) {
  return wg::launch<kPartials>(q, k, v, true_len, nullptr, acc, m, l,
                               nullptr, B, H, Hk, N, N, Nq, q_start, 0, scale,
                               stream);
}
