// Causal GQA flash-attention prefill over a left-padded buffer (sm_90a),
// normalised (one pass, or the two-pass schedule) or as online-softmax
// partials.
//
// Replaces: pyramidkv_tpu/kernels/flash_prefill.py::flash_causal_attention
// (Pallas TPU) in its default schedule (two_pass=False, body `_kernel`) and
// its two-pass schedule (two_pass=True: pass A `_max_kernel`, pass B
// `_kernel_pass_b`), sub_k=1, with any `q_start`, `scale` and `softcap`; and
// flash_prefill.py::flash_attention_partials (body `_kernel_partials`).
// Head dims 128 and 256 (Gemma-2), each instantiated with and without the
// attention logit cap; the one-pass entry also at head dim 32 (the trained
// tiny retrieval checkpoint: namespace d32, on mma.sync).
//
// What it computes, per batch row b with pad = N - true_len[b]: the Nq
// queries sit at global columns [q_start, q_start + Nq) of the N keys, and
//   out[b,h,r] = softmax_c(scale * q[b,h,r] . k[b,h/G,c]) @ v[b,h/G,c]
// over the visible keys c <= q_start + r, c >= pad (and q_start + r - c <
// window when a sliding window is set).  With a cap (Gemma-2's
// attn_logit_softcapping) each logit s = scale * q . k becomes
// cap * tanh(s / cap) before the softmax, as the TPU kernel computes it: q
// is scaled by `scale` alone and log2(e) multiplies after the tanh (folding
// it into q, as the uncapped kernels do, would move the cap).  The tanh is
// the MUFU's tanh.approx.f32 (relative error about 2^-11: at a cap of 50 a
// logit near the cap moves by up to ~0.02, most by far less).  `pkv_flash_prefill` with
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
// path (N = 8192-32768, D = 128 or 256) attention does ~N/2 multiply-adds
// per byte of q/k/v, far above the card's ~295 flop/byte bf16 ridge, so the
// bound is the tensor-core rate (4 D flops a visible pair), not HBM; next
// comes the MUFU's rate (one exp2 a visible pair, and one tanh under a cap:
// about half the tensor-core time at D = 128, a quarter at D = 256 with the
// cap).
//
// The one-pass, partials and pass-B entries (`flash_wgmma_kernel`) are
// built for that bound:
// - a block takes 128 query rows of one (b, h): two consumer warpgroups of
//   64 rows and, at D = 128, a producer warpgroup whose one thread starts
//   every copy (at D = 256 consumer thread 0 starts them, each tile's a
//   step before it is needed).  Q, K and V are copied by the copy
//   engine through tensor maps with 128-byte swizzle (a row is D / 64
//   boxes of 64 columns; K and V are {D, N, B*Hk} with a row stride of
//   ldk, so a chunk reads the carry in place, and rows >= N arrive as
//   zeros and are masked) into a ring of STAGES key tiles (128 keys at
//   D = 128, 64 at D = 256: Q 64 KB and two stages of K and V 128 KB, where
//   128-key tiles would need 321 KB), each K and V tile completing on its
//   own mbarrier and released on its own once the products that read it
//   are done;
// - both products run on wgmma: S = Q K^T (m64n128k16, or m64n64k16 at
//   D = 256, Q and K read from shared memory through K-major descriptors)
//   and O += P V (m64n128k16 for each 128 channels of O; P from registers,
//   where the S accumulator's layout is already the A operand's after
//   rounding to bf16; V read MN-major, the transpose bit);
// - a warpgroup waits for each product before the next step, so S, P and O
//   fit the 168 registers a thread of the 384 has at D = 128 (ptxas
//   allocates the consumers within them whatever setmaxnreg grants:
//   issuing tile i's Q K^T beside tile i-1's P V needs all three live and
//   spilled, 1.2x slower on the card); at D = 256 O alone is 128 f32 a
//   thread: a block of 288 threads gets 168 registers a thread too (ptxas
//   rounds the threads up to a multiple of 128) and spilled 264-648 bytes,
//   so the block is the two consumer warpgroups alone, with up to 255
//   registers for O, S (32) and P (16); the two consumer warpgroups'
//   softmax and products interleave on the SM instead;
// - Q is scaled by scale * log2(e) (by scale alone under a cap) and rounded
//   to bf16 in shared memory once a block (the TPU wrapper's fold), then
//   fenced for the async proxy; a cap applies to S once it lands;
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
// Pass A (`row_max_kernel`, namespace rm) needs only S = Q K^T and a max:
// no P, no V, no O.  Its work is the one-pass kernel's first product with
// the walk of h2o_scores.cu's stats kernel, not a mode of
// flash_wgmma_kernel, whose consumers hold S, P and O for one tile at a
// time and leave no registers for a second S:
// - a block takes 128 query rows of one (b, h), the key-tile plan of
//   flash_wgmma_kernel at D = 128 (heaviest q tiles first); a producer
//   warp's lane 0 copies 128-key tiles into a ring of 4 stages (3 at
//   D = 256) through the k tensor map;
// - each of two consumer warpgroups holds its 64 rows of bf16(q * scale *
//   log2 e) (of q * scale under a cap) in D / 4 registers a thread as
//   wgmma's A operand, and walks a tile as two 64-key units on m64n64k16
//   into two accumulators: unit u+1's product runs while unit u's max is
//   taken (151 registers at D = 128, no spill in the H2O kernel of the same
//   shape);
// - a unit is masked only where it is not interior to the warpgroup's 64
//   rows (the diagonal, the pad edge, the window edge, a tile cut short by
//   N), reading a copy of S so ptxas keeps the products in flight; each
//   thread keeps a running max of its two rows over its columns, reduced
//   over the 4 lanes of a row at the end: no shared-memory round trip.
//   Under a cap the max is taken over the raw logits and capped once at the
//   end (the cap is monotonic), so no instruction writes an accumulator
//   between two products.
// kernels/flash_prefill.py::row_max_unit_plan mirrors the unit plan.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What a launch of flash_wgmma_kernel writes: kOut the normalised bf16
// output (online softmax); kPartials (acc, m, l) f32; kPassB pass B's
// normalised bf16 output, against the row maxes m_in of pass A.
enum Mode { kOut = 0, kPartials = 1, kPassB = 2 };

// Two bf16 times `scale`, rounded back to bf16.
__device__ __forceinline__ uint32_t scale2(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// A capped logit in the base-2 domain: cap * tanh(s / cap) * log2(e), with
// inv_cap = 1 / cap and cap2 = cap * log2(e); s is the natural logit (q
// scaled by `scale` alone).
__device__ __forceinline__ float cap_logit(float s, float inv_cap, float cap2) {
  return tanh_approx(s * inv_cap) * cap2;
}

// ---------------------------------------------------------------------------
// Pass A of the two-pass schedule: row maxes on wgmma, Q in registers.
// ---------------------------------------------------------------------------

namespace rm {

constexpr int BQ = 128;           // q rows a block: 2 consumer warpgroups x 64
constexpr int BK = 128;           // keys a tile (two units of 64)
constexpr int NCONS = 256;        // two consumer warpgroups
constexpr int NTHREADS = NCONS + 32;  // and one producer warp
constexpr int BOX = 64;           // bf16 columns of one 128-byte swizzled box
constexpr int HALF = BK * 128;    // bytes of one box column of a tile
constexpr int UNIT_BYTES = 64 * 128;  // a unit's 64 keys of one box

// The K ring at head dim D: 4 stages of 128-key tiles at D = 128 (128 KB),
// 3 at D = 256 (192 KB; 4 would need 256 KB).
template <int D>
struct Ring {
  static constexpr int STAGES = D == 128 ? 4 : 3;
  static constexpr int TILE_BYTES = (D / BOX) * HALF;
  static constexpr int SMEM_BYTES = 1024 + STAGES * TILE_BYTES;
};
static_assert(Ring<256>::SMEM_BYTES <= 232448, "pass A's ring at D = 256");

// This thread's A fragments of its warpgroup's 64 q rows: local rows `row`
// and row + 8 (zeros from Nq on), for each of the D / 16 steps of 16 along D
// columns 16 kk + 2 tig + {0, 1} and + 8, times `scale` and rounded to bf16
// (the TPU wrapper's fold; wgmma's register layout of A).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&f)[D / 4],
                                       const __nv_bfloat16* qb, int row,
                                       int Nq, int tig, float scale) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e & 1) * 8;
      const int c = kk * 16 + tig * 2 + (e >> 1) * 8;
      f[4 * kk + e] =
          r < Nq ? scale2(*reinterpret_cast<const uint32_t*>(
                              qb + (size_t)r * D + c), scale)
                 : 0u;
    }
  }
}

// Unit u's S = Q K^T (64 rows x 64 keys: tile u / 2, keys 64 (u % 2) on),
// issued into `s` (wgmma is asynchronous); the tile's stage is waited for
// at its first unit.
template <int D>
__device__ __forceinline__ void issue(uint32_t ring, uint64_t* full,
                                      const uint32_t (&a)[D / 4],
                                      float (&s)[32], int u) {
  constexpr int STAGES = Ring<D>::STAGES;
  const int i = u >> 1, st = i % STAGES;
  if (!(u & 1)) mbar_wait(&full[st], (i / STAGES) & 1);
  const uint32_t b = ring + st * Ring<D>::TILE_BYTES + (u & 1) * UNIT_BYTES;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // D / 16 steps of 16 along D, four 32-byte steps within each box
    const uint32_t off = (kk >> 2) * HALF + (kk & 3) * 32;
    wgmma_rs64(s, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
               sw128_desc(b + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void land(float (&s)[32]) {
  wgmma_wait<N>();
  fence_regs(s);
}

// This thread's running maxes of its rows `grow` and grow + 8 (global)
// over the unit's keys [cu, cu + 64): entries 4j + {0, 1} row grow,
// 4j + {2, 3} row grow + 8, keys cu + 8j + 2 tig + {0, 1}; on an edge unit
// (EDGE) a key that the row does not see (before the pad, after the causal
// edge, at or past N, outside the window) is skipped.  The accumulator is
// only read: an instruction writing it between two products makes ptxas
// serialize them.
template <bool EDGE>
__device__ __forceinline__ void max_unit(const float (&s)[32], float (&m)[2],
                                         int cu, int grow, int tig, int pad,
                                         int N, int window) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = grow + 8 * i;
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cu + 8 * j + 2 * tig + e;
        bool ok = true;
        if (EDGE) {
          ok = c >= pad && c <= r && c < N;
          if (window > 0) ok = ok && r - c < window;
        }
        mx = fmaxf(mx, ok ? s[4 * j + 2 * i + e] : -INFINITY);
      }
    }
    m[i] = mx;
  }
}

// grid (B*H, ceil(Nq / BQ)), NTHREADS threads, Ring<D>::SMEM_BYTES of
// dynamic shared memory.  q [B*H, Nq, D] bf16; map k {D, N, B*Hk} (row
// stride ldk), boxes {64, 128, 1}, 128-byte swizzle; m_out [B*H, Nq] f32.
// scale_q: q's fold (scale * log2(e), or scale under a cap); cap: the logit
// cap, 0 for none.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
row_max_kernel(const __nv_bfloat16* __restrict__ q,
               const __grid_constant__ CUtensorMap kmap,
               const int* __restrict__ true_len, float* __restrict__ m_out,
               int H, int Hk, int N, int Nq, int q_start, int window,
               float scale_q, float cap) {
  constexpr int STAGES = Ring<D>::STAGES;
  constexpr int TILE_BYTES = Ring<D>::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  // 128-byte swizzle repeats every 1024 bytes: boxes start 1024-aligned
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest q tiles first
  const int b = bh / H;
  const int kv_row = b * Hk + (bh % H) / (H / Hk);
  const int pad = N - true_len[b];
  // the block's key tiles, as flash_wgmma_kernel's plan: from the pad or
  // window edge of its first row to the causal edge of its last
  const int g0 = q_start + qt * BQ;
  const int g1 = min(g0 + BQ, q_start + Nq) - 1;
  const int lo = window > 0 ? max(pad, g0 - window + 1) : pad;
  const int hi = min(g1, N - 1);
  const int kt_first = lo / BK;
  const int ntiles = lo > hi ? 0 : hi / BK - kt_first + 1;
  float* mb = m_out + (size_t)bh * Nq;
  if (ntiles == 0) {  // no row of the block sees a key
    const int r = qt * BQ + threadIdx.x;
    if (threadIdx.x < BQ && r < Nq) mb[r] = -FLT_MAX;
    return;
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {  // the producer warp: lane 0 fills the ring
    if (threadIdx.x == NCONS) {
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
        uint8_t* kd = ring + st * TILE_BYTES;
        const int row = (kt_first + i) * BK;
        mbar_expect(&full[st], TILE_BYTES);
        for (int x = 0; x < D / BOX; ++x)
          tma_load_3d(kd + x * HALF, &kmap, x * BOX, row, kv_row, &full[st]);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128;  // consumer warpgroup: 64 rows
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const int row = qt * BQ + cw * 64 + warp * 16 + (lane >> 2);  // local
  const int grow = q_start + row;     // global; row + 8 likewise
  const int r_lo = g0 + cw * 64;      // the warpgroup's first global row
  float m[2] = {-INFINITY, -INFINITY};
  // an interior unit: every pair of the warpgroup's 64 rows and the unit's
  // 64 keys is visible (past the pad, causal, inside N and the window)
  auto process = [&](const float (&s)[32], int u) {
    const int cu = (kt_first + (u >> 1)) * BK + (u & 1) * 64;
    const bool interior = cu >= pad && cu + 63 <= r_lo && cu + 64 <= N &&
                          (window <= 0 || r_lo + 63 - cu < window);
    if (interior)
      max_unit<false>(s, m, cu, grow, tig, pad, N, window);
    else
      max_unit<true>(s, m, cu, grow, tig, pad, N, window);
  };
  uint32_t a[D / 4];
  load_q<D>(a, q + (size_t)bh * Nq * D, row, Nq, tig, scale_q);
  // every unit in order, two in flight: unit u is processed (then its
  // tile's stage released after its second unit) while unit u+1's product
  // runs, and unit u+2 is issued into u's accumulator; the last two units
  // are peeled, so every wait is straight-line (h2o_scores.cu's walk)
  const uint32_t ra = smem_addr(ring);
  const int nu = 2 * ntiles;
  float s0[32], s1[32];
  issue<D>(ra, full, a, s0, 0);
  issue<D>(ra, full, a, s1, 1);
  for (int u = 0; u < nu - 2; u += 2) {
    land<1>(s0);
    process(s0, u);
    issue<D>(ra, full, a, s0, u + 2);
    land<1>(s1);
    process(s1, u + 1);
    mbar_arrive(&empty[(u >> 1) % STAGES]);  // the tile is read
    issue<D>(ra, full, a, s1, u + 3);
  }
  land<1>(s0);
  process(s0, nu - 2);
  land<0>(s1);
  process(s1, nu - 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    const int r = row + 8 * i;
    // a last q tile may be cut short by Nq; under a cap the row's raw max
    // is capped (tanh is monotonic: the max of the capped logits)
    if (tig == 0 && r < Nq)
      mb[r] = m[i] == -INFINITY ? -FLT_MAX
              : cap > 0.f ? cap_logit(m[i], 1.f / cap, cap * LOG2E)
                          : m[i];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* true_len, void* m,
           int B, int H, int Hk, int N, int ldk, int Nq, int q_start,
           int window, float scale_q, float cap, void* stream) {
  CUtensorMap km;
  if (!make_map(&km, k, N, B * Hk, ldk, BK, D))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // once a process, per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_max_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ring<D>::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid(B * H, (Nq + BQ - 1) / BQ);
  row_max_kernel<D><<<grid, NTHREADS, Ring<D>::SMEM_BYTES,
                      (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, km, (const int*)true_len, (float*)m, H, Hk, N,
      Nq, q_start, window, scale_q, cap);
  return (int)cudaGetLastError();
}

}  // namespace rm

// ---------------------------------------------------------------------------
// One pass and partials: TMA ring, wgmma, warp-specialised.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;       // q rows a block: 2 consumer warpgroups x 64
constexpr int STAGES = 2;     // K and V tiles in flight
constexpr int BOX = 64;       // bf16 columns of one 128-byte swizzled box
constexpr int Q_BOX = BQ * 128;          // bytes of one box column of Q
constexpr int WG_Q_BYTES = 64 * 128;     // a warpgroup's rows of one box

// The layout at head dim D.  D = 128: 128-key tiles and a producer
// warpgroup (384 threads).  D = 256: 64-key tiles (two stages of K and V
// beside Q in 193 KB) and no producer (256 threads, up to 255 registers a
// thread: O is 128 f32 a consumer thread).
template <int D>
struct Cfg {
  static constexpr int BK = D == 128 ? 128 : 64;  // keys a tile
  static constexpr int NTHREADS = D == 128 ? 384 : 256;
  static constexpr bool WG_PRODUCER = D == 128;
  static constexpr int NBOX = D / BOX;            // boxes a row
  static constexpr int KV_BOX = BK * 128;         // one box column of a tile
  static constexpr int TILE_BYTES = NBOX * KV_BOX;  // one K or V tile
  static constexpr int NS = BK / 2;               // S entries a thread
  static constexpr int OH = D / 128;              // 128-channel blocks of O
  static constexpr int SMEM_BYTES =
      1024 + NBOX * Q_BOX + 2 * STAGES * TILE_BYTES;
};
static_assert(Cfg<256>::SMEM_BYTES <= 232448, "flash's ring at D = 256");

// S = Q K^T for one warpgroup: 64 rows x BK keys, D / 16 steps of 16 along
// D (four 32-byte steps within each 64-column box).
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[Cfg<D>::NS],
                                           uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t dq = (kk >> 2) * Q_BOX + (kk & 3) * 32;
    const uint32_t dk = (kk >> 2) * Cfg<D>::KV_BOX + (kk & 3) * 32;
    if constexpr (Cfg<D>::BK == 128)
      wgmma_ss(s, sw128_desc(q_addr + dq, 16, 1024),
               sw128_desc(k_addr + dk, 16, 1024), kk > 0);
    else
      wgmma_ss64(s, sw128_desc(q_addr + dq, 16, 1024),
                 sw128_desc(k_addr + dk, 16, 1024), kk > 0);
  }
}

// O += P V for one warpgroup: BK / 16 steps of 16 keys (2048 bytes of each
// box of V), one m64n128k16 product for each 128 channels of O (boxes 2h
// and 2h + 1 of V).
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[Cfg<D>::OH][64],
                                           const uint32_t (&p)[Cfg<D>::BK / 4],
                                           uint32_t v_addr) {
  constexpr int KV_BOX = Cfg<D>::KV_BOX;
#pragma unroll
  for (int kk = 0; kk < Cfg<D>::BK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < Cfg<D>::OH; ++h)
      wgmma_rs(o[h], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               sw128_desc(v_addr + h * 2 * KV_BOX + kk * 16 * 128, KV_BOX,
                          1024));
}

// Under a cap (CAP), S's natural logits become base-2 capped ones in place
// (cap_logit); nothing otherwise (q carries log2(e) already).
template <bool CAP, int NS>
__device__ __forceinline__ void cap_tile(float (&s)[NS], float inv_cap,
                                         float cap2) {
  if constexpr (CAP) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = cap_logit(s[i], inv_cap, cap2);
  }
}

// The online softmax of one tile for this thread's two rows (i = 0: the
// accumulator entries 4j, 4j+1, row `grow`; i = 1: 4j+2, 4j+3, row grow+8),
// masked elementwise only on an edge tile: s becomes p = exp2(s - m_new).
template <int NJ>
__device__ __forceinline__ void softmax_tile(float (&s)[4 * NJ], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int c0, int grow,
                                             int tig, int pad, int N,
                                             int window) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
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
    for (int j = 0; j < NJ; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    // a row with nothing visible yet keeps p == 0 and alpha == 0
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[i] = exp2f(m[i] - m_use);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
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
template <int NJ>
__device__ __forceinline__ void known_max_tile(float (&s)[4 * NJ],
                                               const float (&m)[2],
                                               float (&l)[2], bool edge,
                                               int c0, int grow, int tig,
                                               int pad, int N, int window) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
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
    for (int j = 0; j < NJ; ++j) {
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
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&p)[BK / 4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int OH>
__device__ __forceinline__ void rescale(float (&o)[OH][64],
                                        const float (&a)[2]) {
#pragma unroll
  for (int h = 0; h < OH; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[h][4 * j + 0] *= a[0];
      o[h][4 * j + 1] *= a[0];
      o[h][4 * j + 2] *= a[1];
      o[h][4 * j + 3] *= a[1];
    }
}

// grid (B*H, ceil(Nq / BQ)), Cfg<D>::NTHREADS threads, Cfg<D>::SMEM_BYTES of
// dynamic shared memory.  Maps: q {D, Nq, B*H}, k and v {D, N, B*Hk} (row
// stride ldk), all bf16, boxes {64, 128, 1} for q and {64, BK, 1} for k and
// v, 128-byte swizzle.  kOut and kPassB write out [B*H, Nq, D] bf16 (kPassB
// against m_in [B*H, Nq], pass A's row maxes); kPartials acc [B*H, Nq, D],
// m, l [B*H, Nq] f32.  scale_q: q's fold (scale * log2(e); scale under a
// cap); CAP: cap the logits at `cap`.
template <int MODE, int D, bool CAP>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const int* __restrict__ true_len,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out,
                   const float* __restrict__ m_in, int H, int Hk, int N,
                   int Nq, int q_start, int window, float scale_q,
                   float cap) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, NBOX = C::NBOX, KV_BOX = C::KV_BOX;
  constexpr int TILE_BYTES = C::TILE_BYTES, OH = C::OH;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[STAGES], v_full[STAGES],
      k_empty[STAGES], v_empty[STAGES];
  // 128-byte swizzle repeats every 1024 bytes: boxes start 1024-aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                            // [NBOX][BQ][128 B]
  uint8_t* kring = qs + NBOX * Q_BOX;            // [STAGES][NBOX][BK][128 B]
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

  // Q's copy, and key tile i's K and V copies into stage i % STAGES once
  // both consumer warpgroups have released the tile before it there
  auto copy_q = [&]() {
    mbar_expect(&q_full, NBOX * Q_BOX);
    for (int x = 0; x < NBOX; ++x)
      tma_load_3d(qs + x * Q_BOX, &qmap, x * BOX, qt * BQ, bh, &q_full);
  };
  auto copy_tile = [&](int i) {
    const int st = i % STAGES;
    const int row = (kt_first + i) * BK;
    if (i >= STAGES) mbar_wait(&k_empty[st], ((i / STAGES) - 1) & 1);
    uint8_t* kd = kring + st * TILE_BYTES;
    mbar_expect(&k_full[st], TILE_BYTES);
    for (int x = 0; x < NBOX; ++x)
      tma_load_3d(kd + x * KV_BOX, &kmap, x * BOX, row, kv_row, &k_full[st]);
    if (i >= STAGES) mbar_wait(&v_empty[st], ((i / STAGES) - 1) & 1);
    uint8_t* vd = vring + st * TILE_BYTES;
    mbar_expect(&v_full[st], TILE_BYTES);
    for (int x = 0; x < NBOX; ++x)
      tma_load_3d(vd + x * KV_BOX, &vmap, x * BOX, row, kv_row, &v_full[st]);
  };
  if (C::WG_PRODUCER && threadIdx.x < 128) {
    // D = 128: warpgroup 0 produces; one thread keeps the ring full
    if constexpr (C::WG_PRODUCER) setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && ntiles > 0) {
      copy_q();
      for (int i = 0; i < ntiles; ++i) copy_tile(i);
    }
  } else {
    if constexpr (C::WG_PRODUCER) setmaxnreg_inc<232>();
    // D = 256 has no producer warp: ptxas rounds a block's threads up to a
    // multiple of 128 when it sizes registers, so 288 threads get 168 a
    // thread, as 384 do (O alone is 128 at D = 256: spills); 256 get 255.
    // Thread 0 copies Q and the first STAGES tiles here, each later tile
    // at the step before it is needed (below).
    if (!C::WG_PRODUCER && threadIdx.x == 0 && ntiles > 0) {
      copy_q();
      for (int i = 0; i < min(STAGES, ntiles); ++i) copy_tile(i);
    }
    // consumer warpgroup: 64 rows
    const int cw = threadIdx.x / 128 - (C::WG_PRODUCER ? 1 : 0);
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, tig = lane & 3;
    const int r0 = qt * BQ + cw * 64 + warp * 16 + (lane >> 2);  // local
    const int grow = q_start + r0;           // global; row r0 + 8 likewise

    float o[OH][64];
#pragma unroll
    for (int h = 0; h < OH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
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
      // q times its fold, rounded to bf16, in place (this warpgroup's 64
      // rows of every box), then fenced for wgmma's async-proxy reads
      mbar_wait(&q_full, 0);
#pragma unroll
      for (int i = 0; i < NBOX * WG_Q_BYTES / 16 / 128; ++i) {
        const int c = tid + 128 * i;  // 16-byte chunk
        uint4* p = reinterpret_cast<uint4*>(
            qs + (c / (WG_Q_BYTES / 16)) * Q_BOX + cw * WG_Q_BYTES +
            (c % (WG_Q_BYTES / 16)) * 16);
        uint4 x = *p;
        x.x = scale2(x.x, scale_q);
        x.y = scale2(x.y, scale_q);
        x.z = scale2(x.z, scale_q);
        x.w = scale2(x.w, scale_q);
        *p = x;
      }
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);

      const uint32_t q_addr = smem_addr(qs) + cw * WG_Q_BYTES;
      const uint32_t kring_a = smem_addr(kring);
      const uint32_t vring_a = smem_addr(vring);
      // the cap in the base-2 domain (unused without one)
      const float inv_cap = CAP ? 1.f / cap : 0.f;
      const float cap2 = cap * LOG2E;
      float s[C::NS];
      uint32_t p[BK / 4];
      // per tile: S = Q K^T, the softmax, O += P V, each product waited
      // before the next step (the other warpgroup's products fill the
      // tensor cores meanwhile); a tile's K is released as soon as S is in
      // registers
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        const int c0 = (kt_first + i) * BK;
        // D = 256: tile i + STAGES - 1 into the stage tile i - 1 held
        if (!C::WG_PRODUCER && threadIdx.x == 0 && i >= 1 &&
            i + STAGES - 1 < ntiles)
          copy_tile(i + STAGES - 1);
        // interior: every pair of the block's rows and the tile's keys is
        // visible (past the pad, causal, inside N and the window)
        const bool interior = c0 >= pad && c0 + BK - 1 <= g0 &&
                              c0 + BK <= N &&
                              (window <= 0 || g1 - c0 < window);
        mbar_wait(&k_full[st], (i / STAGES) & 1);
        const uint32_t k_addr = kring_a + st * TILE_BYTES;
        wgmma_fence();
        qk_product<D>(s, q_addr, k_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        mbar_arrive(&k_empty[st]);
        cap_tile<CAP>(s, inv_cap, cap2);
        if constexpr (MODE == kPassB) {
          known_max_tile<BK / 8>(s, m, l, !interior, c0, grow, tig, pad, N,
                                 window);
        } else {
          float alpha[2];
          softmax_tile<BK / 8>(s, m, l, alpha, !interior, c0, grow, tig, pad,
                               N, window);
          rescale(o, alpha);
        }
        pack_p<BK>(s, p);
        mbar_wait(&v_full[st], (i / STAGES) & 1);
        wgmma_fence();
        pv_product<D>(o, p, vring_a + st * TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < OH; ++h) fence_regs(o[h]);
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
        for (int h = 0; h < OH; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(ab + h * 128 + j * 8 + tig * 2) =
                make_float2(o[h][4 * j + 2 * i], o[h][4 * j + 2 * i + 1]);
        if (tig == 0) {
          m_out[row] = m[i] == -INFINITY ? -FLT_MAX : m[i];
          l_out[row] = l[i];
        }
      } else {
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
        __nv_bfloat16* ob = out + row * D;
#pragma unroll
        for (int h = 0; h < OH; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<uint32_t*>(ob + h * 128 + j * 8 + tig * 2) =
                pack_bf16(o[h][4 * j + 2 * i] * inv,
                          o[h][4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

template <int MODE, int D, bool CAP>
int launch(const void* q, const void* k, const void* v, const void* true_len,
           void* out, void* acc, void* m, void* l, const void* m_in, int B,
           int H, int Hk, int N, int ldk, int Nq, int q_start, int window,
           float scale_q, float cap, void* stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, Nq, B * H, Nq, BQ, D) ||
      !make_map(&km, k, N, B * Hk, ldk, C::BK, D) ||
      !make_map(&vm, v, N, B * Hk, ldk, C::BK, D))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // once a process, per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<MODE, D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid(B * H, (Nq + BQ - 1) / BQ);
  flash_wgmma_kernel<MODE, D, CAP><<<grid, C::NTHREADS, C::SMEM_BYTES,
                                     (cudaStream_t)stream>>>(
      qm, km, vm, (const int*)true_len, (__nv_bfloat16*)out, (float*)acc,
      (float*)m, (float*)l, (const float*)m_in, H, Hk, N, Nq, q_start, window,
      scale_q, cap);
  return (int)cudaGetLastError();
}

// The instantiation for head dim D (128 or 256) and the cap (cap > 0:
// Gemma-2's attention logit cap; 0: none).  q's fold: scale * log2(e)
// without a cap; scale alone under one, log2(e) applying after the tanh.
template <int MODE>
int dispatch(const void* q, const void* k, const void* v,
             const void* true_len, void* out, void* acc, void* m, void* l,
             const void* m_in, int B, int H, int Hk, int D, int N, int ldk,
             int Nq, int q_start, int window, float scale, float cap,
             void* stream) {
  const float scale_q = cap > 0.f ? scale : scale * LOG2E;
#define PKV_FLASH_ARGS \
  q, k, v, true_len, out, acc, m, l, m_in, B, H, Hk, N, ldk, Nq, q_start, \
      window, scale_q, cap, stream
  if (D == 128)
    return cap > 0.f ? launch<MODE, 128, true>(PKV_FLASH_ARGS)
                     : launch<MODE, 128, false>(PKV_FLASH_ARGS);
  if (D == 256)
    return cap > 0.f ? launch<MODE, 256, true>(PKV_FLASH_ARGS)
                     : launch<MODE, 256, false>(PKV_FLASH_ARGS);
#undef PKV_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Head dim 32 (the trained tiny retrieval checkpoint): the one-pass kOut
// entry on mma.sync.
// ---------------------------------------------------------------------------
//
// A 32-channel row is 64 bytes, half a 128-byte swizzled box, so the wgmma
// kernels' tensor maps and descriptors do not take it; this kernel is the
// one-pass schedule on warp-wide mma.sync m16n8k16 instead:
// - a block takes 128 query rows of one (b, h), 16 a warp (8 warps); the
//   warp's Q fragments (q as it is: 2 k steps of 16 channels) stay in
//   registers for the whole walk, and each f32 product is multiplied by
//   scale * log2 e (scale alone under a cap) in f32.  The wgmma kernels'
//   fold (q * scale * log2 e rounded to bf16, the TPU wrapper's) moves a
//   logit by ~2^-9 of its size: the trained checkpoint's logits reach
//   900-3000 nats, and the fold moved its attention outputs 8-29x past
//   the limit against the plain version (PERF.md §6);
// - the block walks the key tiles of 64 keys from its pad or window edge to
//   its causal edge (flash_tile_plan with 64-key tiles); each tile's K rows
//   (padded to 40 bf16 a row: the fragment loads hit 32 banks) and V
//   transposed to [channel][key] (72 bf16 a row) are staged in shared
//   memory by every thread, the next tile's 16 bytes of K and of V held in
//   registers while the current tile is computed;
// - S = Q K^T is 8 n-tiles x 2 k steps, P (rounded to bf16 at the running
//   max, the C fragments of two n-tiles being one A fragment) times V is
//   4 k steps x 4 n-tiles of 8 channels; a warp skips a tile wholly past
//   its rows' causal edge or before the pad; every other pair is masked
//   elementwise (the mask is the same function as the wgmma kernel's);
// - online softmax in base 2 with l summed over the unrounded p, as the
//   plain schedule (flash_tiled_plain at D = 32), reduced over the 4 lanes
//   of a row at the end; a row with no visible key writes 0.
namespace d32 {

constexpr int D = 32;
constexpr int NW = 8;            // warps a block, 16 q rows each
constexpr int BQ = NW * 16;      // q rows a block
constexpr int BK = 64;           // keys a tile
constexpr int KROW = 40;         // bf16 a staged K row (32 + 8 pad)
constexpr int VROW = 72;         // bf16 a staged V^T row (64 keys + 8 pad)

template <bool CAP>
__global__ void __launch_bounds__(NW * 32)
flash32_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ true_len,
               __nv_bfloat16* __restrict__ out, int H, int Hk, int N, int ldk,
               int Nq, int q_start, int window, float scale_q, float cap) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK * KROW];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VROW];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nqt = (Nq + BQ - 1) / BQ;
  const int t = nqt - 1 - blockIdx.y;  // the heaviest q tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int pad = N - true_len[b];
  const int plane = b * Hk + h / (H / Hk);
  const __nv_bfloat16* kb = k + (size_t)plane * ldk * D;
  const __nv_bfloat16* vb = v + (size_t)plane * ldk * D;
  const float inv_cap = CAP ? 1.f / cap : 0.f, cap2 = cap * LOG2E;

  // the block's rows (global columns) and the key tiles it walks
  const int g0 = q_start + t * BQ;
  const int g1 = min(g0 + BQ, q_start + Nq) - 1;
  const int lo_key = window > 0 ? max(pad, g0 - window + 1) : pad;
  const int hi_key = min(g1, N - 1);
  const int t_lo = lo_key / BK, t_hi = lo_key <= hi_key ? hi_key / BK : -1;

  // this warp's 16 rows: r0 (local) and global R0; rows past Nq are idle
  const int r0 = t * BQ + warp * 16;
  const bool active = r0 < Nq;
  const int R0 = q_start + r0;
  const int rowA = R0 + gq, rowB = R0 + gq + 8;  // this thread's two rows

  // Q fragments: ks-th 16 channels; a0/a1 rows gq / gq + 8, channels
  // 16 kk + 2 tq + {0, 1}; a2/a3 the same 8 channels on
  uint32_t qa[2][4];
  {
    const __nv_bfloat16* qr = q + ((size_t)bh * Nq + (active ? r0 : 0)) * D;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int rr = gq + (x & 1) * 8, cc = 16 * kk + 2 * tq + (x >> 1) * 8;
        qa[kk][x] = active ? *reinterpret_cast<const uint32_t*>(
                                 qr + (size_t)rr * D + cc)
                           : 0u;
      }
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[nt][x] = 0.f;

  // the staging map: thread tid copies 16 bytes of K and of V, key tid / 4,
  // channels 8 (tid % 4) + [0, 8)
  const int sk = tid >> 2, sc = (tid & 3) * 8;
  uint4 kreg = make_uint4(0, 0, 0, 0), vreg = make_uint4(0, 0, 0, 0);
  auto fetch = [&](int kt) {
    const size_t o_ = (size_t)(kt * BK + sk) * D + sc;
    kreg = *reinterpret_cast<const uint4*>(kb + o_);
    vreg = *reinterpret_cast<const uint4*>(vb + o_);
  };
  if (t_lo <= t_hi) fetch(t_lo);

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    __syncthreads();  // every warp is done with the previous tile
    *reinterpret_cast<uint4*>(&ks[sk * KROW + sc]) = kreg;
    {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&vreg);
#pragma unroll
      for (int x = 0; x < 8; ++x) vt[(sc + x) * VROW + sk] = e[x];
    }
    __syncthreads();
    if (kt < t_hi) fetch(kt + 1);  // in flight while this tile is computed
    const int c0 = kt * BK;
    if (!active || c0 > R0 + 15 || c0 + BK <= pad) continue;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const __nv_bfloat16* kr = &ks[(8 * j + gq) * KROW + 16 * kk + 2 * tq];
        mma_bf16_16816(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // cap, mask, running max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = c0 + 8 * j + 2 * tq + (x & 1);
        const int R = x < 2 ? rowA : rowB;
        float y = s[j][x] * scale_q;
        if constexpr (CAP) y = tanh_approx(y * inv_cap) * cap2;
        const bool vis = c >= pad && c <= R && R < q_start + Nq &&
                         (window <= 0 || R - c < window);
        y = vis ? y : -INFINITY;
        s[j][x] = y;
        mx[x >> 1] = fmaxf(mx[x >> 1], y);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      mu[i] = mn == -INFINITY ? 0.f : mn;
      alpha[i] = exp2f(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    // P (bf16) as A fragments: k step kk takes n-tiles 2 kk and 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        p[x] = exp2f(s[j][x] - mu[x >> 1]);
        l[x >> 1] += p[x];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* vr = &vt[(8 * nt + gq) * VROW + 16 * kk + 2 * tq];
        mma_bf16_16816(o[nt], pa[kk], *reinterpret_cast<const uint32_t*>(vr),
                       *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  __nv_bfloat16* orow = out + ((size_t)bh * Nq + r0) * D;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = 8 * nt + 2 * tq;
    *reinterpret_cast<uint32_t*>(orow + (size_t)gq * D + c) =
        pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(orow + (size_t)(gq + 8) * D + c) =
        pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

int launch(const void* q, const void* k, const void* v, const void* true_len,
           void* out, int B, int H, int Hk, int N, int ldk, int Nq,
           int q_start, int window, float scale_q, float cap, void* stream) {
  if (N % 64 || Nq % 64 || H % Hk || Nq < 1 || q_start < 0 || ldk < N)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (Nq + BQ - 1) / BQ);
  const auto st = (cudaStream_t)stream;
  const auto* qp = (const __nv_bfloat16*)q;
  const auto* kp = (const __nv_bfloat16*)k;
  const auto* vp = (const __nv_bfloat16*)v;
  if (cap > 0.f)
    flash32_kernel<true><<<grid, NW * 32, 0, st>>>(
        qp, kp, vp, (const int*)true_len, (__nv_bfloat16*)out, H, Hk, N, ldk,
        Nq, q_start, window, scale_q, cap);
  else
    flash32_kernel<false><<<grid, NW * 32, 0, st>>>(
        qp, kp, vp, (const int*)true_len, (__nv_bfloat16*)out, H, Hk, N, ldk,
        Nq, q_start, window, scale_q, cap);
  return (int)cudaGetLastError();
}

}  // namespace d32

}  // namespace

// Every entry takes D = 128 or 256, a softmax scale and a logit cap (0 for
// none); pkv_flash_prefill also D = 32 (namespace d32); cudaErrorInvalidValue
// for another D.
extern "C" int pkv_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* true_len, void* out, int B, int H,
                                 int Hk, int D, int N, int ldk, int Nq,
                                 int q_start, int window, float scale,
                                 float softcap, void* stream) {
  if (D == 32)
    return d32::launch(q, k, v, true_len, out, B, H, Hk, N, ldk, Nq, q_start,
                       window, softcap > 0.f ? scale : scale * LOG2E, softcap,
                       stream);
  return wg::dispatch<kOut>(q, k, v, true_len, out, nullptr, nullptr, nullptr,
                            nullptr, B, H, Hk, D, N, ldk, Nq, q_start, window,
                            scale, softcap, stream);
}

// Pass A of the two-pass schedule: m [B*H, Nq] f32, the row maxes of the
// base-2 logits, capped under a cap (float32.min for a row with no visible
// key).  Arguments as pkv_flash_prefill's.
extern "C" int pkv_flash_row_max(const void* q, const void* k,
                                 const void* true_len, void* m, int B, int H,
                                 int Hk, int D, int N, int ldk, int Nq,
                                 int q_start, int window, float scale,
                                 float softcap, void* stream) {
  const float scale_q = softcap > 0.f ? scale : scale * LOG2E;
  if (D == 128)
    return rm::launch<128>(q, k, true_len, m, B, H, Hk, N, ldk, Nq, q_start,
                           window, scale_q, softcap, stream);
  if (D == 256)
    return rm::launch<256>(q, k, true_len, m, B, H, Hk, N, ldk, Nq, q_start,
                           window, scale_q, softcap, stream);
  return (int)cudaErrorInvalidValue;
}

// Pass B: out [B*H, Nq, D] bf16 from pass A's m [B*H, Nq].
extern "C" int pkv_flash_pass_b(const void* q, const void* k, const void* v,
                                const void* true_len, const void* m, void* out,
                                int B, int H, int Hk, int D, int N, int ldk,
                                int Nq, int q_start, int window, float scale,
                                float softcap, void* stream) {
  return wg::dispatch<kPassB>(q, k, v, true_len, out, nullptr, nullptr,
                              nullptr, m, B, H, Hk, D, N, ldk, Nq, q_start,
                              window, scale, softcap, stream);
}

// acc [B*H, Nq, D], m, l [B*H, Nq] f32; q_start 0 (causal self tile,
// Nq == N) or >= N (every key precedes every query: a history tile q_start
// rows before the queries, so a window > 0 hides the keys q_start + r - c
// >= window; a tile outside the window of every row walks no key).
extern "C" int pkv_flash_partials(const void* q, const void* k, const void* v,
                                  const void* true_len, void* acc, void* m,
                                  void* l, int B, int H, int Hk, int D, int N,
                                  int Nq, int q_start, int window, float scale,
                                  float softcap, void* stream) {
  return wg::dispatch<kPartials>(q, k, v, true_len, nullptr, acc, m, l,
                                 nullptr, B, H, Hk, D, N, N, Nq, q_start,
                                 window, scale, softcap, stream);
}
