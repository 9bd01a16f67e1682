// H2O heavy-hitter scores in two passes (sm_90a).
//
// Replaces: pyramidkv_tpu/kernels/h2o_scores.py::h2o_scores_pallas (Pallas
// TPU): pass 1 `_stats_kernel`, pass 2 `_colsum_kernel`; and, with a scale
// and an attention logit cap (Gemma-2), the XLA scorer the TPU engine takes
// there (pyramidkv_tpu/ops/scoring.py::h2o_scores).  Head dims 128 and 256,
// each instantiated with and without the cap; and head dim 32 (the trained
// tiny retrieval checkpoint) on mma.sync, namespace d32 below.
//
// What it computes, per (batch row b, query head h) with pad = N -
// true_len[b] and the pre-scaled query qs = bf16(q * scale * log2(e)) (the
// TPU wrapper's `qr` at scale 1/sqrt(D), computed once a layer by the
// wrapper), logits s[r, c] = qs[r] . k[c] in f32 (under a cap qs =
// bf16(q * scale) and s = cap * tanh(qs[r] . k[c] / cap) * log2(e), the
// tanh the MUFU's tanh.approx.f32, taken before any mask: a masked pair is
// skipped, never pushed through the tanh, which would make it -cap and
// count it) and
//   visible(r, c) = r >= pad and c >= pad and
//                   not (r >= N - W and c >= N - W and c > r)
// (causal ONLY inside the trailing W x W block: the reference's quirk):
//   pass 1 (h2o_stats_kernel): m[r] = max_c s[r, c], l[r] = sum_c exp2(s -
//     m[r]) over the visible c; a padding row (r < pad) sees nothing and
//     writes m = float32.min, l = 0;
//   pass 2 (h2o_colsum_kernel): score[c] = sum_{r >= pad} exp2(s[r, c] -
//     m[r]) / max(l[r], 1e-30) for c < N - W, and -inf at c < pad.
// Columns c < N - W never lie in the W x W block, so pass 2 masks only the
// padding rows.
//
// What bounds it on the H100: operations, two kinds nearly equal.  Each
// pass computes every visible logit (B * H * true_len^2 of them) at 2 * D
// flops on the tensor cores (1/16 of an SM clock a logit at D = 128 and
// 4096 bf16 flops a clock, 1/8 at D = 256) and takes one exp2 of it on the
// MUFU (16 a clock per SM: 1/16 of a clock too; a second, the tanh, under a
// cap), against ~2 bytes of q or k per logit row and column.  A
// design that runs the products and the exponentials one after the other
// cannot come within 2x of the bound.
//
// What the design does about it (the machinery of flash_prefill.cu's
// flash_wgmma_kernel, csrc/hopper.cuh):
// - a block owns 128 rows of one (b, h): stats 128 queries, colsum 128 keys;
//   two consumer warpgroups of 64 rows each and one producer warp (288
//   threads).  A consumer holds its 64 rows (the A operand: stats the
//   pre-scaled Q, colsum K) in D / 4 registers a thread for the whole walk
//   (64 at D = 256, as pass A of flash_prefill.cu holds its Q),
//   so the products read only B from shared memory (both operands from
//   shared memory ran slower: 96 of the SM's 128 bytes a clock at the
//   tensor cores' rate).  The producer's lane 0 copies 128-row tiles of
//   the walked axis (stats: keys, colsum: pre-scaled queries) into a ring
//   of STAGES (4 at D = 128, 3 at D = 256: 192 KB) through tensor maps
//   {D, N, planes} with 128-byte swizzle, a row D / 64 boxes (GQA: KV plane
//   b * Hk + h / (H / Hk), no repeat_kv);
// - a tile is walked as two units of 64 rows: S = A B^T of a unit is
//   64 x 64 on wgmma m64n64k16 (A from registers, B K-major; stats: A = Q,
//   B = K; colsum: A = K, B = Q, so S^T = K Q^T and a column sum of P is a
//   row sum of the accumulator), 32 f32 a thread;
// - each consumer keeps TWO accumulators: unit u+1's product runs (wgmma is
//   asynchronous) while unit u's max, exp2 and sums are taken, then unit
//   u+2 is issued into u's accumulator, so the tensor cores and the MUFU
//   work at once.  Two 64 x 128 accumulators and A do not fit the 168
//   registers a thread of a 288-thread block gets (ptxas counts whole
//   warpgroups) without spilling; two 64 x 64 ones and A take 151 at
//   D = 128 (A is 64 more at D = 256).  ptxas
//   keeps products in flight only through straight-line waits and while
//   nothing but wgmma writes an accumulator: the walk peels its last two
//   units, and stats masks a copy of S, never S itself (else ptxas
//   serializes the products, C7515, or injects a full wait, C7517); under
//   a cap stats takes each unit's row max over the raw logits and caps it
//   once (tanh is monotonic), then caps each visible logit once for its
//   exp2, so the cap adds one tanh a pair;
// - stats walks every key tile from floor(pad / 128) to the end (no
//   triangular cut: the statistic is non-causal outside the W x W block)
//   and masks only edge tiles: the one holding the pad edge, one cut short
//   by N, one that meets the W x W block's causal part, and every tile of
//   a q tile that straddles the pad (its padding rows see nothing); a q
//   tile made wholly of padding writes (float32.min, 0) and returns;
//   kernels/h2o_scores.py::h2o_tile_plan mirrors the plan;
// - colsum walks the query tiles from floor(pad / 128) to the end.  The
//   producer warp reads each tile's m and l from device memory a tile
//   ahead and writes beside the tile in the ring the exponent offset m +
//   log2(max(l, 1e-30)) (m clamped at float32.min / 2 as the TPU's), so a
//   pair costs a subtraction and an exp2 and no multiply; only the tile
//   that holds the pad edge or is cut short by N masks rows (their offset
//   is float32.max: exp2 gives 0).  The last column block is cut at N - W
//   on writing;
// - colsum's sums: two partial sums a thread (its two keys), over its 32
//   queries of each tile in a fixed order, across every tile, then over
//   the 4 lanes of a row: no atomics, the same bits every run;
// - exp2 is the MUFU's, subnormal results flushed (exp2f's range handling
//   costs three instructions a pair);
// - blocks are launched longest batch row first (the 8k batch is ragged).
// What holds it at ~2x: the products alone run at ~1.4x the tensor bound
// (each block streams its (b, h)'s whole K or Q through L2: ~5.6 TB/s at
// 32k) and the exponentials alone at ~1.5x the MUFU bound (two consumer
// warps an SM sub-partition hide little latency); taking a quarter of the
// exponentials on the FMA pipe instead ran slower
// (scripts/port_h2o_variants.py, PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BR = 128;           // a block's rows: stats queries, colsum keys
constexpr int BT = 128;           // rows of a tile of the walked axis
constexpr int NCONS = 256;        // two consumer warpgroups
constexpr int NTHREADS = NCONS + 32;  // and one producer warp
constexpr int BOX = 64;           // bf16 columns of one 128-byte swizzled box
constexpr int HALF = 128 * 128;   // bytes of one box column of 128 rows
constexpr int WG_BYTES = 64 * 128;    // a warpgroup's 64 rows of one box

// The ring at head dim D: 4 stages of 128-row tiles at D = 128 (128 KB),
// 3 at D = 256 (192 KB; 4 would need 256 KB).  1024 to align the swizzled
// boxes, the ring, and colsum's exponent offsets (a float per row of each
// stage).
template <int D>
struct Ring {
  static constexpr int STAGES = D == 128 ? 4 : 3;
  static constexpr int TILE_BYTES = (D / BOX) * HALF;  // 128 rows x D bf16
  static constexpr int SMEM_BYTES =
      1024 + STAGES * TILE_BYTES + STAGES * BT * 4;
};
static_assert(Ring<256>::SMEM_BYTES <= 232448, "the ring at D = 256");

// A capped logit in the base-2 domain: cap * tanh(s / cap) * log2(e), with
// inv_cap = 1 / cap and cap2 = cap * log2(e); s is the natural logit (q
// scaled by `scale` alone).
__device__ __forceinline__ float cap_logit(float s, float inv_cap,
                                           float cap2) {
  return tanh_approx(s * inv_cap) * cap2;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// 2^x on the MUFU, subnormal results flushed to 0 (exp2f adds three
// instructions a call to keep them): a term below 2^-126 changes no sum of
// a row's (at least one term of 1) or a column's probabilities that the
// checks can see, and an instruction a pair matters here.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// This thread's A fragments of a warpgroup's 64 rows of a [*, D] bf16
// matrix: rows `row` and row + 8 (zeros from row `rows` on), for each of the
// D / 16 steps of 16 along D columns 16 kk + 2 tig + {0, 1} and + 8
// (wgmma's register layout of A, the same as the warp-level MMA's).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 4],
                                       const __nv_bfloat16* p, int row,
                                       int rows, int tig) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e & 1) * 8;
      const int c = kk * 16 + tig * 2 + (e >> 1) * 8;
      f[4 * kk + e] =
          r < rows ? *reinterpret_cast<const uint32_t*>(p + (size_t)r * D + c)
                   : 0u;
    }
  }
}

// The consumer warpgroup's walk over the ring: `ntiles` tiles, each as two
// units of 64 of its rows (unit u: tile u / 2, rows 64 (u % 2) on), so a
// unit's S = A B^T is 64 x 64 (32 f32 a thread: entries 4j + {0, 1} row
// `row`, 4j + {2, 3} row + 8, columns 8j + 2 tig + {0, 1}), A the
// warpgroup's 64 rows of the block in registers.  Two accumulators: unit
// u+1's product is in flight (wgmma is asynchronous) while unit u is
// processed, then u+2's is issued into u's accumulator.
struct Walk {
  uint32_t ring;     // the ring's stages (B, K-major)
  uint64_t* full;
  uint64_t* empty;
  int nu;            // units: 2 ntiles
};

template <int D>
__device__ __forceinline__ void issue(const Walk& w,
                                      const uint32_t (&a)[D / 4],
                                      float (&s)[32], int u) {
  constexpr int STAGES = Ring<D>::STAGES;
  const int i = u >> 1, st = i % STAGES;
  if (!(u & 1)) mbar_wait(&w.full[st], (i / STAGES) & 1);
  const uint32_t b = w.ring + st * Ring<D>::TILE_BYTES + (u & 1) * WG_BYTES;
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

// Wait until at most N products are in flight (the most recent), then keep
// the compiler from reading `s` above the wait.
template <int N>
__device__ __forceinline__ void land(float (&s)[32]) {
  wgmma_wait<N>();
  fence_regs(s);
}

// Every unit in order, two in flight: unit u is processed (then its tile's
// stage released after its second unit) while unit u+1's product runs, and
// unit u+2 is issued into u's accumulator.  The waits do not depend on the
// data (the last two units are peeled off): ptxas follows which product an
// accumulator waits for only through straight-line waits, and injects a
// full wait where it cannot.
template <int D, typename F>
__device__ __forceinline__ void walk(const Walk& w,
                                     const uint32_t (&a)[D / 4],
                                     F& process) {
  constexpr int STAGES = Ring<D>::STAGES;
  float s0[32], s1[32];
  issue<D>(w, a, s0, 0);
  issue<D>(w, a, s1, 1);
  for (int u = 0; u < w.nu - 2; u += 2) {
    land<1>(s0);
    process(s0, u);
    issue<D>(w, a, s0, u + 2);
    land<1>(s1);
    process(s1, u + 1);
    mbar_arrive(&w.empty[(u >> 1) % STAGES]);  // the tile is read
    issue<D>(w, a, s1, u + 3);
  }
  land<1>(s0);
  process(s0, w.nu - 2);
  land<0>(s1);
  process(s1, w.nu - 1);
}

// The batch row of rank r when the rows are ordered by true length, longest
// first (ties by index): blocks are launched heaviest first.
__device__ __forceinline__ int batch_of_rank(const int* tl, int B, int r) {
  for (int b = 0; b < B; ++b) {
    const int t = tl[b];
    int rank = 0;
    for (int o = 0; o < B; ++o) {
      const int u = tl[o];
      rank += u > t || (u == t && o < b);
    }
    if (rank == r) return b;
  }
  return 0;
}

// (b, h, t) of this block: grid B * H * nblk, batch rows longest first,
// then heads, then the block's 128 rows from the last (real rows before a
// short row's padding).
struct Place {
  int b, h, t;
};
__device__ __forceinline__ Place place(const int* tl, int B, int H,
                                       int nblk) {
  const int per_b = H * nblk;
  const int x = blockIdx.x % per_b;
  return {batch_of_rank(tl, B, blockIdx.x / per_b), x / nblk,
          nblk - 1 - x % nblk};
}

// ---------------------------------------------------------------------------
// Pass 1: row statistics
// ---------------------------------------------------------------------------

// 64 keys from c0 for this thread's two rows (i = 0: entries 4j, 4j+1, row
// `row`; i = 1: 4j+2, 4j+3, row + 8), masked elementwise (to -inf) only on
// an edge tile (EDGE): the online max and exp2-sum, base 2.  Under a cap
// (CAP) the unit's max is taken over the raw logits and capped once, and
// each visible logit is capped for its exp2; a masked one is -inf, never
// capped.  The accumulator is only read: an instruction writing it between
// two products makes ptxas serialize them.
template <bool EDGE, bool CAP>
__device__ __forceinline__ void stats_unit(const float (&s)[32], float (&m)[2],
                                           float (&l)[2], int c0, int row,
                                           int tig, int pad, int N, int W,
                                           float inv_cap, float cap2) {
  auto hidden = [&](int j, int e) {
    const int r = row + ((e >> 1) << 3);
    const int c = c0 + j * 8 + tig * 2 + (e & 1);
    // c > r >= N - W puts the pair in the W x W block's causal part
    return EDGE && (min(r, c) < pad || c >= N || (r >= N - W && c > r));
  };
  // the raw logit, -inf where hidden
  auto raw = [&](int j, int e) {
    return hidden(j, e) ? -INFINITY : s[4 * j + e];
  };
  // the base-2 logit (capped under CAP), -inf where hidden
  auto at = [&](int j, int e) {
    if constexpr (CAP)
      return hidden(j, e) ? -INFINITY
                          : cap_logit(s[4 * j + e], inv_cap, cap2);
    else
      return raw(j, e);
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(raw(j, 2 * i), raw(j, 2 * i + 1)));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if constexpr (CAP) {  // tanh is monotonic: the max of the capped logits
      if (mx != -INFINITY) mx = cap_logit(mx, inv_cap, cap2);
    }
    const float m_new = fmaxf(m[i], mx);
    // a row with nothing visible yet keeps l == 0
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      rs += ex2(at(j, 2 * i) - m_use) + ex2(at(j, 2 * i + 1) - m_use);
    l[i] = l[i] * ex2(m[i] - m_use) + rs;
    m[i] = m_new;
  }
}

// Whether key tile `c0` of the block's rows [r0, r1] holds a masked pair:
// the pad edge (and a q tile straddling it), a tile cut short by N, or the
// W x W block's causal part (a column c > r for a row r >= N - W).
__device__ __forceinline__ bool stats_edge(int c0, int r0, int r1, int pad,
                                           int N, int W) {
  const int c1 = min(c0 + BT, N) - 1;
  const int rb = max(r0, N - W);  // the first row in the block
  return r0 < pad || c0 < pad || c0 + BT > N || (rb <= r1 && c1 > rb);
}

// grid B * H * ceil(N / BR), NTHREADS threads, Ring<D>::SMEM_BYTES of
// dynamic shared memory.  Maps: qs {D, N, B*H}, k {D, N, B*Hk}, bf16, boxes
// {64, 128, 1}; m, l [B*H, N] f32.  CAP: cap the logits at `cap`.
template <int D, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
h2o_stats_kernel(const __nv_bfloat16* __restrict__ qs,
                 const __grid_constant__ CUtensorMap kmap,
                 const int* __restrict__ true_len, float* __restrict__ m_out,
                 float* __restrict__ l_out, int B, int H, int Hk, int N,
                 int W, float cap) {
  constexpr int STAGES = Ring<D>::STAGES;
  constexpr int TILE_BYTES = Ring<D>::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t k_full[STAGES], k_empty[STAGES];
  uint8_t* ring = align1024(smem_raw);  // [STAGES][2][BT][128 B]

  const int nqt = (N + BR - 1) / BR;
  const Place p = place(true_len, B, H, nqt);
  const int bh = p.b * H + p.h;
  const int kv_row = p.b * Hk + p.h / (H / Hk);
  const int pad = N - true_len[p.b];
  const int r0 = p.t * BR;
  const int r1 = min(r0 + BR, N) - 1;
  float* mb = m_out + (size_t)bh * N;
  float* lb = l_out + (size_t)bh * N;
  if (r1 < pad) {  // padding rows only: nothing visible
    if (threadIdx.x < BR && r0 + threadIdx.x < N) {
      mb[r0 + threadIdx.x] = -FLT_MAX;
      lb[r0 + threadIdx.x] = 0.f;
    }
    return;
  }
  const int kt_first = pad / BT;
  const int ntiles = nqt - kt_first;  // every key tile to the end

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {  // the producer warp: lane 0 fills the ring
    if (threadIdx.x == NCONS) {
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&k_empty[st], ((i / STAGES) - 1) & 1);
        uint8_t* kd = ring + st * TILE_BYTES;
        const int row = (kt_first + i) * BT;
        mbar_expect(&k_full[st], TILE_BYTES);
        for (int x = 0; x < D / BOX; ++x)
          tma_load_3d(kd + x * HALF, &kmap, x * BOX, row, kv_row,
                      &k_full[st]);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128;  // consumer warpgroup: 64 rows
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = r0 + cw * 64 + warp * 16 + (lane >> 2);
  const int tig = lane & 3;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  // the cap in the base-2 domain (unused without one)
  const float inv_cap = CAP ? 1.f / cap : 0.f;
  const float cap2 = cap * LOG2E;
  auto process = [&](const float (&s)[32], int u) {
    const int c0 = (kt_first + (u >> 1)) * BT;
    const int cu = c0 + (u & 1) * 64;
    if (stats_edge(c0, r0, r1, pad, N, W))
      stats_unit<true, CAP>(s, m, l, cu, row, tig, pad, N, W, inv_cap, cap2);
    else
      stats_unit<false, CAP>(s, m, l, cu, row, tig, pad, N, W, inv_cap,
                             cap2);
  };
  uint32_t a[D / 4];
  load_a<D>(a, qs + (size_t)bh * N * D, row, N, tig);
  walk<D>(Walk{smem_addr(ring), k_full, k_empty, 2 * ntiles}, a, process);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = row + 8 * i;
    if (tig == 0 && r < N) {  // a last q tile may be cut short by N
      mb[r] = m[i] == -INFINITY ? -FLT_MAX : m[i];
      lb[r] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: column sums
// ---------------------------------------------------------------------------

// The exponent offset of query row r: m + log2(max(l, 1e-30)), m clamped at
// float32.min / 2; float32.max (exp2 gives 0) where `hide`.
__device__ __forceinline__ float exp_offset(float m, float l, bool hide) {
  float lg;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(fmaxf(l, 1e-30f)));
  return hide ? FLT_MAX : fmaxf(m, -FLT_MAX / 2) + lg;
}

// m and l of the 4 query rows from r (N % 64 == 0: all 4 below N or none;
// rows past N read nothing and are hidden).
__device__ __forceinline__ void load_rows(const float* mb, const float* lb,
                                          int r, int N, float4& mv,
                                          float4& lv) {
  if (r < N) {
    mv = *reinterpret_cast<const float4*>(mb + r);
    lv = *reinterpret_cast<const float4*>(lb + r);
  } else {
    mv = lv = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Expect `bytes` more on the mbarrier's current phase, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

// grid B * H * ceil((N - W) / BR), NTHREADS threads, Ring<D>::SMEM_BYTES
// of dynamic shared memory.  Maps as the stats kernel's; m, l [B*H, N] f32
// from it; out [B*H, N - W] f32.  CAP: cap the logits at `cap` (a hidden
// row's offset float32.max still gives exp2 = 0).
template <int D, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
h2o_colsum_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __nv_bfloat16* __restrict__ k,
                  const int* __restrict__ true_len,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, float* __restrict__ out,
                  int B, int H, int Hk, int N, int W, float cap) {
  constexpr int STAGES = Ring<D>::STAGES;
  constexpr int TILE_BYTES = Ring<D>::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full[STAGES], q_empty[STAGES];
  uint8_t* ring = align1024(smem_raw);  // [STAGES][2][BT][128 B]
  float* offs = reinterpret_cast<float*>(ring + STAGES * TILE_BYTES);

  const int nout = N - W;
  const Place p = place(true_len, B, H, (nout + BR - 1) / BR);
  const int bh = p.b * H + p.h;
  const int kv_row = p.b * Hk + p.h / (H / Hk);
  const int pad = N - true_len[p.b];
  const int c0 = p.t * BR;  // the block's first key (column)
  float* ob = out + (size_t)bh * nout;
  if (min(c0 + BR, nout) <= pad) {  // padding columns only
    if (threadIdx.x < BR && c0 + threadIdx.x < nout)
      ob[c0 + threadIdx.x] = -INFINITY;
    return;
  }
  const int qt_first = pad / BT;
  const int ntiles = (N + BT - 1) / BT - qt_first;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&q_full[i], 32);  // the producer warp's lanes
      mbar_init(&q_empty[i], NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // the producer warp: lane 0 copies the block's keys once and each
    // query tile; every lane writes 4 of the tile's exponent offsets, from
    // m and l loaded a tile ahead (their latency hides behind the wait for
    // a free stage)
    const int lane = threadIdx.x - NCONS;
    const float* mb = m_in + (size_t)bh * N;
    const float* lb = l_in + (size_t)bh * N;
    float4 mv, lv;
    load_rows(mb, lb, qt_first * BT + lane * 4, N, mv, lv);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % STAGES;
      const int t0 = (qt_first + i) * BT;
      float4 mn, ln;
      load_rows(mb, lb, t0 + BT + lane * 4, N, mn, ln);
      if (i >= STAGES) mbar_wait(&q_empty[st], ((i / STAGES) - 1) & 1);
      if (lane == 0) {
        uint8_t* qd = ring + st * TILE_BYTES;
        mbar_expect_tx(&q_full[st], TILE_BYTES);
        for (int x = 0; x < D / BOX; ++x)
          tma_load_3d(qd + x * HALF, &qmap, x * BOX, t0, bh, &q_full[st]);
      }
      // only the tile holding the pad edge or cut short by N masks rows
      const bool edge = t0 < pad || t0 + BT > N;
      const int r = t0 + lane * 4;
      *reinterpret_cast<float4*>(offs + st * BT + lane * 4) = make_float4(
          exp_offset(mv.x, lv.x, edge && (r < pad || r >= N)),
          exp_offset(mv.y, lv.y, edge && (r + 1 < pad || r + 1 >= N)),
          exp_offset(mv.z, lv.z, edge && (r + 2 < pad || r + 2 >= N)),
          exp_offset(mv.w, lv.w, edge && (r + 3 < pad || r + 3 >= N)));
      mbar_arrive(&q_full[st]);
      mv = mn;
      lv = ln;
    }
    return;
  }

  const int cw = threadIdx.x / 128;  // consumer warpgroup: 64 keys
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3;
  float cs[2] = {0.f, 0.f};
  // the cap in the base-2 domain (unused without one)
  const float inv_cap = CAP ? 1.f / cap : 0.f;
  const float cap2 = cap * LOG2E;
  // the base-2 logit: capped under CAP (the accumulator is only read)
  auto lg = [&](float x) {
    if constexpr (CAP)
      return cap_logit(x, inv_cap, cap2);
    else
      return x;
  };
  // this thread's two keys gain exp2(s - offset) over its 16 queries of the
  // unit (8j + 2 tig + {0, 1} from 64 (u % 2)), in a fixed order
  auto process = [&](const float (&s)[32], int u) {
    const float* off =
        offs + ((u >> 1) % STAGES) * BT + (u & 1) * 64 + tig * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 o = *reinterpret_cast<const float2*>(off + j * 8);
      cs[0] += ex2(lg(s[4 * j]) - o.x) + ex2(lg(s[4 * j + 1]) - o.y);
      cs[1] += ex2(lg(s[4 * j + 2]) - o.x) + ex2(lg(s[4 * j + 3]) - o.y);
    }
  };
  const int key = c0 + cw * 64 + warp * 16 + (lane >> 2);
  uint32_t a[D / 4];
  load_a<D>(a, k + (size_t)kv_row * N * D, key, N, tig);
  walk<D>(Walk{smem_addr(ring), q_full, q_empty, 2 * ntiles}, a, process);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 1);
    cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 2);
    const int c = key + 8 * i;
    if (tig == 0 && c < nout) ob[c] = c >= pad ? cs[i] : -INFINITY;
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return (int)e;
}

template <int D, bool CAP>
int stats(const void* qs, const void* k, const void* true_len, void* m,
          void* l, int B, int H, int Hk, int N, int W, float cap,
          void* stream) {
  CUtensorMap km;
  if (!make_map(&km, k, N, B * Hk, N, BT, D))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // once a process, per instantiation
  if (const int e = set_smem(h2o_stats_kernel<D, CAP>, Ring<D>::SMEM_BYTES,
                             attr))
    return e;
  h2o_stats_kernel<D, CAP><<<B * H * ((N + BR - 1) / BR), NTHREADS,
                             Ring<D>::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qs, km, (const int*)true_len, (float*)m,
      (float*)l, B, H, Hk, N, W, cap);
  return (int)cudaGetLastError();
}

template <int D, bool CAP>
int colsum(const void* qs, const void* k, const void* true_len,
           const void* m, const void* l, void* out, int B, int H, int Hk,
           int N, int W, float cap, void* stream) {
  CUtensorMap qm;
  if (!make_map(&qm, qs, N, B * H, N, BT, D))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (const int e = set_smem(h2o_colsum_kernel<D, CAP>, Ring<D>::SMEM_BYTES,
                             attr))
    return e;
  h2o_colsum_kernel<D, CAP><<<B * H * ((N - W + BR - 1) / BR), NTHREADS,
                              Ring<D>::SMEM_BYTES, (cudaStream_t)stream>>>(
      qm, (const __nv_bfloat16*)k, (const int*)true_len, (const float*)m,
      (const float*)l, (float*)out, B, H, Hk, N, W, cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dim 32 (the trained tiny retrieval checkpoint): both passes on
// mma.sync.
// ---------------------------------------------------------------------------
//
// A 32-channel row is 64 bytes, half a 128-byte swizzled box: the wgmma
// walk above does not take it.  These two kernels compute the same
// functions with warp-wide mma.sync m16n8k16:
// - the query is read as it is (not folded with the scale into bf16, as
//   the wgmma kernels read it): each f32 product is multiplied by `qscale`
//   (scale * log2 e, or scale under a cap) in f32; the trained checkpoint's
//   logits reach 900-3000 nats, where the fold's rounding moves them by
//   several;
// - a block owns 128 rows of one (b, h), 16 a warp (stats: queries,
//   colsum: keys), the warp's A fragments (2 k steps of 16 channels) in
//   registers for the whole walk; the walked axis (stats: keys from the
//   pad's 64-row tile on, colsum: queries likewise) comes in 64-row tiles
//   staged by every thread in shared memory (rows padded to 40 bf16), the
//   next tile's 16 bytes a thread held in registers meanwhile; an 8 x 64
//   S tile a warp is 8 n-tiles x 2 k steps;
// - stats: each 64-key tile one online step (the wgmma kernel's units),
//   every pair masked elementwise (padding, and the causal part of the
//   trailing W x W block), the cap first; m and l reduced over a row's 4
//   lanes;
// - colsum: the exponent offsets m + log2(max(l, 1e-30)) of the tile's
//   queries staged beside it (float32.max for padding rows); a thread sums
//   exp2(s - offset) pairs first over its queries 8 j + 2 lane + {0, 1},
//   in order across every tile, then over the 4 lanes of a key: the order
//   h2o_tiled_plain mirrors.
namespace d32 {

constexpr int D = 32;
constexpr int NW = 8;        // warps a block, 16 rows each
constexpr int BR = NW * 16;  // a block's rows
constexpr int BT = 64;       // rows of a tile of the walked axis
constexpr int KROW = 40;     // bf16 a staged row (32 + 8 pad)

// This thread's A fragments of 16 rows from `row0` of a [*, D] bf16 plane:
// k step kk, a0/a1 rows lane/4 (+ 8), channels 16 kk + 2 (lane % 4) +
// {0, 1}; a2/a3 those + 8; rows >= n read as zeros.
__device__ __forceinline__ void load_a32(uint32_t (&a)[2][4],
                                         const __nv_bfloat16* base, int row0,
                                         int n, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = row0 + gq + (x & 1) * 8, c = 16 * kk + 2 * tq + (x >> 1) * 8;
      a[kk][x] = r < n ? *reinterpret_cast<const uint32_t*>(base + (size_t)r * D + c)
                       : 0u;
    }
}

// S = A B^T of the warp's 16 rows and the staged tile's 64 rows: s[j] the
// C fragment of tile rows 8 j + [0, 8).
__device__ __forceinline__ void tile_product(float (&s)[8][4],
                                             const uint32_t (&a)[2][4],
                                             const __nv_bfloat16* st,
                                             int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const __nv_bfloat16* r = st + (8 * j + gq) * KROW + 16 * kk + 2 * tq;
      mma_bf16_16816(s[j], a[kk], *reinterpret_cast<const uint32_t*>(r),
                     *reinterpret_cast<const uint32_t*>(r + 8));
    }
  }
}

// grid (B * H, ceil(N / 128)): block (bh, t) writes m, l of rows
// [128 t, 128 t + 128).
template <bool CAP>
__global__ void __launch_bounds__(NW * 32)
stats32_kernel(const __nv_bfloat16* __restrict__ qs,
               const __nv_bfloat16* __restrict__ k,
               const int* __restrict__ true_len, float* __restrict__ m_out,
               float* __restrict__ l_out, int H, int Hk, int N, int W,
               float cap, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 st[BT * KROW];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int pad = N - true_len[b];
  const __nv_bfloat16* kb = k + (size_t)(b * Hk + h / (H / Hk)) * N * D;
  const float inv_cap = CAP ? 1.f / cap : 0.f, cap2 = cap * LOG2E;
  const int r0 = blockIdx.y * BR + warp * 16;
  const int rows[2] = {r0 + gq, r0 + gq + 8};
  const int b0 = blockIdx.y * BR;
  // a q tile made wholly of padding visits nothing
  const int t_lo = pad / BT, t_hi = min(b0 + BR, N) - 1 >= pad ? (N - 1) / BT : -1;
  uint32_t a[2][4];
  load_a32(a, qs + (size_t)bh * N * D, r0, N, lane);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int sk = tid >> 2, sc = (tid & 3) * 8;
  uint4 reg = make_uint4(0, 0, 0, 0);
  if (t_lo <= t_hi) reg = *reinterpret_cast<const uint4*>(kb + (size_t)(t_lo * BT + sk) * D + sc);
  const bool active = r0 < N && r0 + 15 >= pad;
  for (int kt = t_lo; kt <= t_hi; ++kt) {
    __syncthreads();
    *reinterpret_cast<uint4*>(&st[sk * KROW + sc]) = reg;
    __syncthreads();
    if (kt < t_hi)
      reg = *reinterpret_cast<const uint4*>(kb + (size_t)((kt + 1) * BT + sk) * D + sc);
    if (!active) continue;
    float s[8][4];
    tile_product(s, a, st, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = kt * BT + 8 * j + 2 * tq + (x & 1), r = rows[x >> 1];
        float y = s[j][x] * qscale;
        if constexpr (CAP) y = cap_logit(y, inv_cap, cap2);
        const bool hid = min(r, c) < pad || (r >= N - W && c > r);
        y = hid ? -INFINITY : y;
        s[j][x] = y;
        mx[x >> 1] = fmaxf(mx[x >> 1], y);
      }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      mu[i] = mn == -INFINITY ? 0.f : mn;
      l[i] *= exp2f(m[i] - mu[i]);
      m[i] = mn;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) l[x >> 1] += exp2f(s[j][x] - mu[x >> 1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (tq == 0 && rows[i] < N) {
      const size_t o = (size_t)bh * N + rows[i];
      m_out[o] = m[i] == -INFINITY ? -FLT_MAX : m[i];
      l_out[o] = m[i] == -INFINITY ? 0.f : l[i];
    }
  }
}

// grid (B * H, ceil((N - W) / 128)): block (bh, c) writes the scores of
// keys [128 c, min(128 c + 128, N - W)).
template <bool CAP>
__global__ void __launch_bounds__(NW * 32)
colsum32_kernel(const __nv_bfloat16* __restrict__ qs,
                const __nv_bfloat16* __restrict__ k,
                const int* __restrict__ true_len,
                const float* __restrict__ m_in,
                const float* __restrict__ l_in, float* __restrict__ out,
                int H, int Hk, int N, int W, float cap, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 st[BT * KROW];
  __shared__ float offs[BT];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int pad = N - true_len[b];
  const int nout = N - W;
  const __nv_bfloat16* qb = qs + (size_t)bh * N * D;
  const float* mb = m_in + (size_t)bh * N;
  const float* lb = l_in + (size_t)bh * N;
  float* ob = out + (size_t)bh * nout;
  const float inv_cap = CAP ? 1.f / cap : 0.f, cap2 = cap * LOG2E;
  const int c0 = blockIdx.y * BR;
  const int key0 = c0 + warp * 16;
  // a block of padding columns only visits nothing
  const bool any = min(c0 + BR, nout) > pad;
  const int t_lo = pad / BT, t_hi = any ? (N - 1) / BT : -1;
  uint32_t a[2][4];
  load_a32(a, k + (size_t)(b * Hk + h / (H / Hk)) * N * D, key0, N, lane);
  float cs[2] = {0.f, 0.f};
  const int sk = tid >> 2, sc = (tid & 3) * 8;
  uint4 reg = make_uint4(0, 0, 0, 0);
  float off = 0.f;
  auto fetch = [&](int qt) {
    reg = *reinterpret_cast<const uint4*>(qb + (size_t)(qt * BT + sk) * D + sc);
    if (tid < BT) {
      const int r = qt * BT + tid;
      off = exp_offset(mb[r], lb[r], r < pad);
    }
  };
  if (t_lo <= t_hi) fetch(t_lo);
  const bool active = key0 < nout;
  for (int qt = t_lo; qt <= t_hi; ++qt) {
    __syncthreads();
    *reinterpret_cast<uint4*>(&st[sk * KROW + sc]) = reg;
    if (tid < BT) offs[tid] = off;
    __syncthreads();
    if (qt < t_hi) fetch(qt + 1);
    if (!active) continue;
    float s[8][4];
    tile_product(s, a, st, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 o = *reinterpret_cast<const float2*>(&offs[8 * j + 2 * tq]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float y0 = s[j][2 * i] * qscale, y1 = s[j][2 * i + 1] * qscale;
        if constexpr (CAP) {
          y0 = cap_logit(y0, inv_cap, cap2);
          y1 = cap_logit(y1, inv_cap, cap2);
        }
        cs[i] += ex2(y0 - o.x) + ex2(y1 - o.y);
      }
    }
  }
  if (c0 >= nout) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 1);
    cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 2);
    const int c = key0 + gq + 8 * i;
    if (tq == 0 && c < nout) ob[c] = c >= pad ? cs[i] : -INFINITY;
  }
}

template <bool CAP>
int stats(const void* qs, const void* k, const void* true_len, void* m,
          void* l, int B, int H, int Hk, int N, int W, float cap,
          float qscale, void* stream) {
  stats32_kernel<CAP><<<dim3(B * H, (N + BR - 1) / BR), NW * 32, 0,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qs, (const __nv_bfloat16*)k,
      (const int*)true_len, (float*)m, (float*)l, H, Hk, N, W, cap, qscale);
  return (int)cudaGetLastError();
}

template <bool CAP>
int colsum(const void* qs, const void* k, const void* true_len,
           const void* m, const void* l, void* out, int B, int H, int Hk,
           int N, int W, float cap, float qscale, void* stream) {
  colsum32_kernel<CAP><<<dim3(B * H, (N - W + BR - 1) / BR), NW * 32, 0,
                         (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qs, (const __nv_bfloat16*)k,
      (const int*)true_len, (const float*)m, (const float*)l, (float*)out, H,
      Hk, N, W, cap, qscale);
  return (int)cudaGetLastError();
}

}  // namespace d32

}  // namespace

// The instantiation for head dim D (128 or 256) and the cap (cap > 0:
// Gemma-2's attention logit cap; 0: none); cudaErrorInvalidValue for
// another D (D = 32: namespace d32, in the entries).
#define PKV_H2O_DISPATCH(fn, ...)                                        \
  if (D == 128)                                                          \
    return cap > 0.f ? fn<128, true>(__VA_ARGS__)                        \
                     : fn<128, false>(__VA_ARGS__);                      \
  if (D == 256)                                                          \
    return cap > 0.f ? fn<256, true>(__VA_ARGS__)                        \
                     : fn<256, false>(__VA_ARGS__);                      \
  return (int)cudaErrorInvalidValue;

// qs: the query times scale * log2(e) (scale alone under a cap), rounded to
// bf16 [B*H, N, D] (at D = 32 the query as it is, each product multiplied
// by qscale = scale * log2(e), or scale under a cap; qscale is not read at
// D = 128 and 256); k [B*Hk, N, D] bf16; true_len [B] int32; m, l [B*H, N]
// f32 out.
extern "C" int pkv_h2o_stats(const void* qs, const void* k,
                             const void* true_len, void* m, void* l, int B,
                             int H, int Hk, int D, int N, int W, float cap,
                             float qscale, void* stream) {
  if (D == 32)
    return cap > 0.f ? d32::stats<true>(qs, k, true_len, m, l, B, H, Hk, N,
                                        W, cap, qscale, stream)
                     : d32::stats<false>(qs, k, true_len, m, l, B, H, Hk, N,
                                         W, cap, qscale, stream);
  PKV_H2O_DISPATCH(stats, qs, k, true_len, m, l, B, H, Hk, N, W, cap, stream)
}

// Arguments as pkv_h2o_stats's, m and l its output; out [B*H, N - W] f32.
extern "C" int pkv_h2o_colsum(const void* qs, const void* k,
                              const void* true_len, const void* m,
                              const void* l, void* out, int B, int H, int Hk,
                              int D, int N, int W, float cap, float qscale,
                              void* stream) {
  if (D == 32)
    return cap > 0.f ? d32::colsum<true>(qs, k, true_len, m, l, out, B, H, Hk,
                                         N, W, cap, qscale, stream)
                     : d32::colsum<false>(qs, k, true_len, m, l, out, B, H,
                                          Hk, N, W, cap, qscale, stream);
  PKV_H2O_DISPATCH(colsum, qs, k, true_len, m, l, out, B, H, Hk, N, W, cap,
                   stream)
}
