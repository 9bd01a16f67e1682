// MInference's block-sparse prefill partials on sm_90a: the vertical
// columns and the slash tiles, one kernel (`sp::sparse_wgmma_kernel`) in
// two modes.
//
// Replaces: pyramidkv_tpu/kernels/block_sparse_prefill.py
//   vertical_attention_partials_kernel (body `_vert_kernel`) -> pkv_vertical_partials
//   slash_tile_attention               (body `_kernel`)      -> pkv_slash_tiles
//   slash_tile_attention_db            (body `_db_kernel`)   -> pkv_slash_tiles
// The two TPU slash functions compute the slash partials over different
// entries of each list: the grid one over the entries flagged valid, the
// db one over the first nval = sum(tile_valid) entries (its loop bound),
// whatever their flags.  Both are served by the slash mode of
// sp::sparse_wgmma_kernel: the db wrapper (kernels/block_sparse_prefill.py)
// hands it its lists' valid prefix, `arange(T) < nval`, in tile_valid's
// place.  On a valid-first list, as the tile selection makes them, the
// prefix is tile_valid and the two results are the same bits.  What the
// TPU db kernel was after (no grid step an entry, invalid entries never
// visited, the next tile's copy in flight) the slash walk already does: a
// producer thread walks the list with one scalar test an entry and keeps a
// TMA ring full.
//
// What they compute: online-softmax partials of causal attention over part
// of the keys, for the caller to flash-merge.  For query row r of head h
// (batch b, pad = N - true_len[b], q pre-scaled: bf16(q * scale)):
//   acc[r] = sum_c exp(s[r,c] - m[r]) v[c]   (f32, unnormalised)
//   m[r]   = max_c s[r,c]                     (natural units)
//   l[r]   = sum_c exp(s[r,c] - m[r])
// over the visible columns c; a row with none has acc = 0, l = 0 and
// m = float32.min.  exp(.) is rounded to bf16 before the product with v, as
// the TPU kernels' p.astype(v.dtype).
// - slash: the columns of the k-tiles listed for the row's q-block
//   (tile_idx [B,H,N/q_block,T], tile_valid), with c <= r, c >= pad and
//   vert[b,h,c] == 0 (the vertical partials hold those columns);
// - vertical: the Vs columns gathered per query head (k_vert, v_vert
//   [B,H,Vs,D]) whose id vcol <= r and vvalid.
//
// What bounds them on the H100: operations.  At 32k a 128-row q tile
// multiplies against up to T*k_tile = 2048 slash keys and up to Vs =
// 1024-3584 vertical columns, ~4*128*2048*128 flops per 2*2048*128*2 bytes
// of K/V: far above the card's ~295 flop/byte bf16 ridge.
//
// The kernel takes the design of csrc/flash_prefill.cu's flash_wgmma_kernel:
// - a 128-row q tile of one (b, h) is walked by a producer warpgroup whose
//   one thread starts every copy and two consumer warpgroups of 64 rows; Q
//   and 128-key tiles of K and V arrive by TMA (128-byte swizzle) in a ring
//   of STAGES stages; S = Q K^T and O += P V run on wgmma, P in registers,
//   each product waited before the next step (the register budget of
//   flash_wgmma_kernel: S, P and O of one tile);
// - a block walks two q tiles of its (b, h), t and nqt-1-t (a heavy and a
//   light one: blocks of even work), through one ring, each with its own Q
//   buffer: the second's copies and first products overlap the first's
//   last tile and stores (a walk is short: ~4 tiles of the vertical at
//   32k, so a block's fill and drain would otherwise count once a tile);
// - a tile is two 64-key units, each its own pair of TMA boxes, so the
//   slash walk can pair any two live units; a missing unit is read past
//   the end of the tensor (zeros) and masked;
// - it is a kernel of its own, not a mode of flash_wgmma_kernel: its
//   producer walks a list the consumers do not know in advance (each stage
//   carries its units' first keys, the warpgroups it is for and the words
//   its masks read; a stage for no warpgroup ends the walk), its masks
//   compare per-column keys or test bits, and its m is in natural units of
//   logits of bf16(q * scale) (log2 e is not folded into the rounded q, as
//   the TPU's block-sparse kernels do not fold it; exp(s - m) is taken as
//   exp2(s * log2e - m * log2e) in f32);
// - vertical: the wrapper sorts each (b, h)'s columns by key (vcol where
//   valid, int max otherwise) and counts, per q tile, the columns with key
//   <= its first row (a prefix every row sees: unmasked tiles) and <= its
//   last row (where the walk ends); the tiles between are masked by
//   comparing each column's key (copied beside the tile) with the row;
//   later columns are never read.  `gather_sorted_kernel` first copies the
//   K and V rows in key order, as far as a walk can read (the valid
//   columns, rounded up to a tile), for the TMA's contiguous boxes (a
//   gather by cp.async in the producer warpgroup measured 1.6x slower);
// - slash: the producer walks the tile list of each warpgroup's q-block in
//   order (one walk for both where they share it), skips invalid entries
//   and 64-key units above the last row or left of the pad (exact: such a
//   unit gives p = 0, alpha = 1) and copies K and V at KV row h / G (no
//   repeat_kv); the wrapper packs vert into 64-bit words, copied beside
//   the tile; a warpgroup masks a unit only where it crosses the
//   warpgroup's diagonal or the pad (every test), is missing (all), or
//   holds a vertical column (a bit test of the thread's own columns and a
//   select);
// - no atomics and a fixed order: bitwise repeatable.
// kernels/block_sparse_prefill.py's vertical_tile_plan and slash_unit_plan
// mirror the two walks.
//
// Head dim 256 and the attention logit cap (Gemma-2): under a cap each
// logit s of bf16(q * scale) . k becomes cap * tanh(s / cap) (the MUFU's
// tanh.approx.f32) once it lands, before any mask: a masked pair is -inf,
// never pushed through the tanh (which would make it -cap and count it, as
// the TPU kernel's comment warns); m stays in natural units of the capped
// logits.  At D = 256 the layout above does not fit (Q 64 KB and two stages
// of 128-key K and V tiles 256 KB; with a producer warpgroup a thread gets
// 168 registers and O alone is 128), so `s2::sparse256_kernel` takes the
// layout of flash_prefill.cu's D = 256 kernel:
// - 64-key tiles (one unit each: a 64 x 64 S on m64n64k16, O two
//   m64n128k16 accumulators), two stages of K and V beside one Q buffer
//   (193 KB), one q tile a block (heaviest first);
// - the two consumer warpgroups alone (256 threads, up to 255 registers);
//   consumer thread 0 is the producer too: it walks the block's list a
//   step ahead (an iterator over the slash list's live units, or the
//   vertical tiles of the sorted columns) and copies each tile into the
//   stage the tile two steps back held, once both warpgroups released it;
// - the masks, the walk's skips and the metadata beside each stage are the
//   D = 128 kernel's, per 64-key unit;
// - `gather_sorted_kernel` copies rows of 512 bytes (32 threads a row).
// kernels/block_sparse_prefill.py's plans mirror the D = 128 walks; at
// D = 256 a tile is one of their units.
//
// Dropped TPU-only limits: the scalar-memory chunking over b*h and the
// 8-row broadcast of m / l.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_MAX = -3.4028234663852886e38f;  // float32.min

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

namespace sp {

constexpr int D = 128;          // head dim of this layout (D = 256: s2)
constexpr int BQ = 128;         // q rows a block: 2 consumer warpgroups x 64
constexpr int UNIT = 64;        // keys a unit (its own TMA boxes)
constexpr int BK = 2 * UNIT;    // keys a tile
constexpr int STAGES = 2;       // K and V tiles in flight
constexpr int NTHREADS = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int BOX = 64;         // bf16 columns of one 128-byte swizzled box
constexpr int Q_HALF = BQ * 128;         // bytes of one box column of Q
constexpr int KV_HALF = BK * 128;        // of K or V
constexpr int UNIT_BYTES = UNIT * 128;   // a unit's rows of one box
constexpr int TILE_BYTES = 2 * KV_HALF;  // one K or V tile (both boxes)
constexpr int WG_Q_BYTES = 64 * 128;     // a warpgroup's rows of one box
// beside each K tile: its 128 column keys (vertical) or, per unit, the 16
// bytes of vert words holding the unit's word (slash)
constexpr int META_BYTES = BK * 4;
// a block's q tiles: a heavy one and a light one (q tiles t and nqt-1-t),
// each with its own Q buffer, so the second's copies and first products
// overlap the first's last tile and stores
constexpr int QTILES = 2;
constexpr int SMEM_BYTES = 1024 + QTILES * 2 * Q_HALF + 2 * STAGES * TILE_BYTES +
                           STAGES * META_BYTES;

enum Mode { kVertical = 0, kSlash = 1 };

struct Args {
  const int* true_len;             // slash: [B]
  const int* keys;                 // vertical: [B*H, vs_pad] sorted keys
  const int* counts;               // vertical: [B*H, nqt, 2]
  const int* tile_idx;             // slash: [B*H, N/q_block, T]
  const uint8_t* tile_valid;       // slash: [B*H, N/q_block, T]
  const unsigned long long* vbits; // slash: [B*H, nwords], bit c of word w:
                                   // column 64 w + c is vertical
  float* acc;                      // [B*H, N, D]
  float* m;                        // [B*H, N]
  float* l;                        // [B*H, N]
  int H, Hk, N;
  int nqt;      // q tiles a row: ceil(N / BQ)
  int rows;     // rows of a K / V plane: Vs (vertical) or N (slash)
  int vs_pad;   // vertical: keys a row (Vs rounded up to BK)
  int nwords;   // slash: vert words a row (even)
  int q_block, k_tile, T;
  float scale;
  float cap;    // the logit cap, 0 for none
};

// Two bf16 times `scale`, rounded back to bf16.
__device__ __forceinline__ uint32_t scale2(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// 2^x on the MUFU unit (a subnormal result flushed to 0; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Under a cap (CAP) S's logits become cap * tanh(s / cap) in place, natural
// units (inv_cap = 1 / cap), before any mask; nothing otherwise.
template <bool CAP, int NS>
__device__ __forceinline__ void cap_tile(float (&s)[NS], float inv_cap,
                                         float cap) {
  if constexpr (CAP) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = tanh_approx(s[i] * inv_cap) * cap;
  }
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

// This thread's accumulator entries: 4j + {0, 1} row r0, 4j + {2, 3} row
// r0 + 8, tile columns 8j + 2 tig + {0, 1}.
//
// A vertical edge tile: column c is visible from row r iff keys[c] <= r
// (invalid columns and those past Vs hold int max).
template <int NS>
__device__ __forceinline__ void mask_keys(float (&s)[NS], const int* keys,
                                          int r0, int tig) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const int2 kk = *reinterpret_cast<const int2*>(keys + j * 8 + tig * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + ((e >> 1) << 3);
      if (((e & 1) ? kk.y : kk.x) > row) s[4 * j + e] = -INFINITY;
    }
  }
}

// Unit u of a slash tile (entries 4j + e, j = 8u .. 8u + 7): column k0 + c
// is visible from row r iff k0 + c <= r, k0 + c >= pad and bit c of the
// unit's vert word w is clear; a missing unit (k0 = -1) has none.
template <int NS>
__device__ __forceinline__ void mask_unit(float (&s)[NS], int u, int k0,
                                          unsigned long long w, int r0,
                                          int tig, int pad) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = jj * 8 + tig * 2;  // column within the unit
    const uint32_t bits = (uint32_t)(w >> c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + ((e >> 1) << 3);
      const int col = k0 + c + (e & 1);
      const bool ok = k0 >= 0 && col >= pad && col <= row &&
                      !((bits >> (e & 1)) & 1u);
      if (!ok) s[4 * (8 * u + jj) + e] = -INFINITY;
    }
  }
}

// Unit u of a slash tile that every row of the warpgroup sees but for its
// vertical columns: only the bit test of the thread's own columns.
template <int NS>
__device__ __forceinline__ void mask_unit_bits(float (&s)[NS], int u,
                                               unsigned long long w,
                                               int tig) {
  const uint32_t lo = (uint32_t)(w >> (2 * tig));
  const uint32_t hi = (uint32_t)(w >> (32 + 2 * tig));
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const uint32_t x = (jj < 4 ? lo : hi) >> (8 * (jj & 3));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((x >> (e & 1)) & 1u) s[4 * (8 * u + jj) + e] = -INFINITY;
  }
}

// The online softmax of one tile for this thread's two rows (i = 0: entries
// 4j, 4j+1; i = 1: 4j+2, 4j+3), natural-unit maxes: s becomes p =
// exp2(s log2e - m_new log2e).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    // a row with nothing visible yet keeps p == 0 and alpha == 0
    const float ml = (m_new == -INFINITY) ? 0.f : m_new * LOG2E;
    alpha[i] = ex2(m[i] * LOG2E - ml);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float p0 = ex2(fmaf(s[4 * j + 2 * i], LOG2E, -ml));
      const float p1 = ex2(fmaf(s[4 * j + 2 * i + 1], LOG2E, -ml));
      s[4 * j + 2 * i] = p0;
      s[4 * j + 2 * i + 1] = p1;
      rs += p0 + p1;
    }
    l[i] = l[i] * alpha[i] + rs;
    m[i] = m_new;
  }
}

// P rounded to bf16 in the A-operand layout of P V: for keys [16kk, 16kk+16)
// (accumulator chunks 2kk and 2kk+1), a0/a2 row r0, a1/a3 row r0 + 8.
template <int NS>
__device__ __forceinline__ void pack_p(const float (&s)[NS],
                                       uint32_t (&p)[NS / 2]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
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

// grid (B*H, ceil(nqt / 2)), NTHREADS threads, SMEM_BYTES of dynamic shared
// memory: block (bh, p) takes q tiles nqt-1-p and p (one where they meet).
// Maps, all bf16 with 128-byte swizzle: q {D, N, B*H} in boxes
// {64, 128, 1}; k and v {D, rows, planes} in boxes {64, 64, 1}: the sorted
// gathered columns [B*H, Vs, D] (kVertical) or the grouped keys
// [B*Hk, N, D] (kSlash).  CAP: cap the logits at a.cap.
template <int MODE, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
sparse_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full[QTILES], k_full[STAGES], v_full[STAGES],
      k_empty[STAGES], v_empty[STAGES];
  // per stage: its units' first keys (-1: none) and the warpgroups it is
  // for (bit w: warpgroup w; 0: the walk of a q tile has ended)
  __shared__ int tile_k0[STAGES][2], tile_wg[STAGES];
  // 128-byte swizzle repeats every 1024 bytes: boxes start 1024-aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qbuf = smem;                          // [QTILES][2][BQ][128 B]
  uint8_t* kring = qbuf + QTILES * 2 * Q_HALF;   // [STAGES][2][BK][128 B]
  uint8_t* vring = kring + STAGES * TILE_BYTES;  // the same
  uint8_t* meta = vring + STAGES * TILE_BYTES;   // [STAGES][META_BYTES]

  const int bh = blockIdx.x;
  const int qts[QTILES] = {a.nqt - 1 - (int)blockIdx.y, (int)blockIdx.y};
  const int nq_here = qts[0] == qts[1] ? 1 : 2;
  const int b = bh / a.H;
  const int plane =
      MODE == kVertical ? bh : b * a.Hk + (bh % a.H) / (a.H / a.Hk);
  const int pad = MODE == kSlash ? a.N - a.true_len[b] : 0;

  if (threadIdx.x == 0) {
    for (int j = 0; j < QTILES; ++j) mbar_init(&q_full[j], 1);
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
    // producer: one thread walks the block's tiles and keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int i = 0;          // stages filled
    int j = 0, q0 = 0;  // the q tile walked
    bool q_sent = false;
    // the next stage, once the warpgroups have released its last use
    auto claim = [&]() {
      const int st = i % STAGES;
      if (i >= STAGES) mbar_wait(&k_empty[st], ((i / STAGES) - 1) & 1);
      return st;
    };
    auto claim_v = [&](int st) {
      if (i >= STAGES) mbar_wait(&v_empty[st], ((i / STAGES) - 1) & 1);
    };
    // one tile: units k0a and k0b (-1: none, read as zeros past the rows)
    // for the warpgroups in `wgs`
    auto emit = [&](int k0a, int k0b, int wgs) {
      if (!q_sent) {
        uint8_t* qd = qbuf + j * 2 * Q_HALF;
        mbar_expect(&q_full[j], 2 * Q_HALF);
        tma_load_3d(qd, &qmap, 0, q0, bh, &q_full[j]);
        tma_load_3d(qd + Q_HALF, &qmap, BOX, q0, bh, &q_full[j]);
        q_sent = true;
      }
      const int k0[2] = {k0a, k0b};
      const int st = claim();
      tile_k0[st][0] = k0a;
      tile_k0[st][1] = k0b;
      tile_wg[st] = wgs;
      uint8_t* md = meta + st * META_BYTES;
      const int mbytes = MODE == kVertical
                             ? META_BYTES
                             : 16 * ((k0a >= 0) + (k0b >= 0));
      mbar_expect(&k_full[st], TILE_BYTES + mbytes);
      uint8_t* kd = kring + st * TILE_BYTES;
      for (int u = 0; u < 2; ++u) {
        const int row = k0[u] >= 0 ? k0[u] : a.rows;
        tma_load_3d(kd + u * UNIT_BYTES, &kmap, 0, row, plane, &k_full[st]);
        tma_load_3d(kd + KV_HALF + u * UNIT_BYTES, &kmap, BOX, row, plane,
                    &k_full[st]);
        if (MODE == kSlash && k0[u] >= 0)
          bulk_g2s(md + 16 * u,
                   a.vbits + (size_t)bh * a.nwords + ((k0[u] / UNIT) & ~1),
                   16, &k_full[st]);
      }
      if (MODE == kVertical)
        bulk_g2s(md, a.keys + (size_t)bh * a.vs_pad + k0a, META_BYTES,
                 &k_full[st]);
      claim_v(st);
      uint8_t* vd = vring + st * TILE_BYTES;
      mbar_expect(&v_full[st], TILE_BYTES);
      for (int u = 0; u < 2; ++u) {
        const int row = k0[u] >= 0 ? k0[u] : a.rows;
        tma_load_3d(vd + u * UNIT_BYTES, &vmap, 0, row, plane, &v_full[st]);
        tma_load_3d(vd + KV_HALF + u * UNIT_BYTES, &vmap, BOX, row, plane,
                    &v_full[st]);
      }
      ++i;
    };

    for (; j < nq_here; ++j) {
      q0 = qts[j] * BQ;
      q_sent = false;
      // warpgroup 1 has rows unless N % 128 = 64 cuts the q tile short
      const int row_wgs = q0 + 64 < a.N ? 3 : 1;
      if (MODE == kVertical) {
        // the sorted columns up to the last with key <= the tile's last row
        const int n_last = a.counts[((size_t)bh * a.nqt + qts[j]) * 2 + 1];
        for (int c0 = 0; c0 < n_last; c0 += BK) emit(c0, c0 + UNIT, row_wgs);
      } else {
        const int nq = a.N / a.q_block;
        // the live 64-key units of q-block qb's list, in list order, paired
        // into tiles for the warpgroups in `wgs`, whose last row is
        // last_row
        auto walk = [&](int qb, int wgs, int last_row) {
          const size_t base = ((size_t)bh * nq + qb) * a.T;
          int pending = -1;  // a unit waiting for its pair
          int idx = a.tile_idx[base], val = a.tile_valid[base];
          for (int t = 0; t < a.T; ++t) {
            const int cur = idx, ok = val;
            if (t + 1 < a.T) {  // the next entry's loads in flight
              idx = a.tile_idx[base + t + 1];
              val = a.tile_valid[base + t + 1];
            }
            if (!ok) continue;
            for (int k0 = cur * a.k_tile; k0 < (cur + 1) * a.k_tile;
                 k0 += UNIT) {
              if (k0 > last_row || k0 + UNIT - 1 < pad) continue;
              if (pending < 0) {
                pending = k0;
              } else {
                emit(pending, k0, wgs);
                pending = -1;
              }
            }
          }
          if (pending >= 0) emit(pending, -1, wgs);
        };
        // a warpgroup walks if it has a row past the pad; both share one
        // walk where their 64-row halves lie in one q-block
        const int last0 = min(q0 + 63, a.N - 1);
        const int last1 = min(q0 + 127, a.N - 1);
        const bool live0 = last0 >= pad;
        const bool live1 = row_wgs == 3 && last1 >= pad;
        const int qb0 = q0 / a.q_block, qb1 = (q0 + 64) / a.q_block;
        if (live0 && live1 && qb0 == qb1) {
          walk(qb0, 3, last1);
        } else {
          if (live0) walk(qb0, 1, last0);
          if (live1) walk(qb1, 2, last1);
        }
      }
      // the end of the q tile's walk: a stage for no warpgroup, no copy
      const int st = claim();
      tile_wg[st] = 0;
      mbar_arrive(&k_full[st]);
      claim_v(st);
      mbar_arrive(&v_full[st]);
      ++i;
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int cw = wgi - 1;  // consumer warpgroup: 64 rows of each q tile
  const int tid = threadIdx.x - 128 * wgi;
  const int warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const uint32_t kring_a = smem_addr(kring);
  const uint32_t vring_a = smem_addr(vring);
  float o[64], s[64];
  uint32_t p[32];
  int i = 0;  // stages consumed
  for (int j = 0; j < nq_here; ++j) {
    const int q0 = qts[j] * BQ;
    const int r_lo = q0 + cw * 64;                  // the warpgroup's first row
    const int r0 = r_lo + warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
    // vertical: the sorted columns every row of the q tile sees
    const int n_first =
        MODE == kVertical ? a.counts[((size_t)bh * a.nqt + qts[j]) * 2] : 0;
    uint8_t* qs = qbuf + j * 2 * Q_HALF;
    const uint32_t q_addr = smem_addr(qs) + cw * WG_Q_BYTES;
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // per-thread partial row sums
    bool q_ready = false;
    for (;; ++i) {
      const int st = i % STAGES, ph = (i / STAGES) & 1;
      mbar_wait(&k_full[st], ph);
      const int wgs = tile_wg[st];
      if (!((wgs >> cw) & 1)) {  // the other warpgroup's tile, or the end
        mbar_arrive(&k_empty[st]);
        mbar_wait(&v_full[st], ph);
        mbar_arrive(&v_empty[st]);
        if (wgs == 0) {
          ++i;
          break;
        }
        continue;
      }
      if (!q_ready) {
        // q * scale, rounded to bf16, in place (this warpgroup's 64 rows
        // of both boxes), then fenced for wgmma's async-proxy reads
        mbar_wait(&q_full[j], 0);
#pragma unroll
        for (int it = 0; it < 2 * WG_Q_BYTES / 16 / 128; ++it) {
          const int c = tid + 128 * it;  // 16-byte chunk
          uint4* qp = reinterpret_cast<uint4*>(
              qs + (c / (WG_Q_BYTES / 16)) * Q_HALF + cw * WG_Q_BYTES +
              (c % (WG_Q_BYTES / 16)) * 16);
          uint4 x = *qp;
          x.x = scale2(x.x, a.scale);
          x.y = scale2(x.y, a.scale);
          x.z = scale2(x.z, a.scale);
          x.w = scale2(x.w, a.scale);
          *qp = x;
        }
        fence_proxy_async();
        named_bar_sync(1 + cw, 128);
        q_ready = true;
      }
      wgmma_fence();
      qk_product(s, q_addr, kring_a + st * TILE_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      cap_tile<CAP>(s, CAP ? 1.f / a.cap : 0.f, a.cap);
      const uint8_t* md = meta + st * META_BYTES;
      if constexpr (MODE == kVertical) {
        // interior: every column's key <= the q tile's first row
        if (tile_k0[st][0] + BK > n_first)
          mask_keys(s, reinterpret_cast<const int*>(md), r0, tig);
      } else {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k0 = tile_k0[st][u];
          const unsigned long long w =
              k0 >= 0 ? reinterpret_cast<const unsigned long long*>(
                            md + 16 * u)[(k0 / UNIT) & 1]
                      : 0ull;
          // every test unless every row of the warpgroup lies past the pad
          // and at or below every column (never a missing unit: pad >= 0)
          if (!(k0 >= pad && k0 + UNIT - 1 <= r_lo))
            mask_unit(s, u, k0, w, r0, tig, pad);
          else if (w != 0ull)
            mask_unit_bits(s, u, w, tig);
        }
      }
      mbar_arrive(&k_empty[st]);
      float alpha[2];
      softmax_tile(s, m, l, alpha);
      rescale(o, alpha);
      pack_p(s, p);
      mbar_wait(&v_full[st], ph);
      wgmma_fence();
      pv_product(o, p, vring_a + st * TILE_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&v_empty[st]);
    }

    // full row sums across the 4 threads of a row group, then the rows
    // that exist (a last q tile may hold 64)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= a.N) continue;
      const size_t row = (size_t)bh * a.N + r;
      float* ab = a.acc + row * D;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        *reinterpret_cast<float2*>(ab + c * 8 + tig * 2) =
            make_float2(o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
      if (tig == 0) {
        a.m[row] = m[h] == -INFINITY ? NEG_MAX : m[h];
        a.l[row] = l[h];
      }
    }
  }
}

// The vertical kernel's K and V in key order: row r of (b, h) is row
// order[r] of k_vert / v_vert, for the rows the walk can read (the valid
// columns, counts' last n_last, rounded up to a tile; later rows are never
// read).  CH = D / 8 threads a row (16 at D = 128, 32 at D = 256), 16 bytes
// a thread: whole 128-byte lines.
constexpr int GATHER_ROWS = 16;  // rows a block

template <int CH>
__global__ void __launch_bounds__(GATHER_ROWS * CH)
gather_sorted_kernel(const uint4* __restrict__ k_vert,
                     const uint4* __restrict__ v_vert,
                     const long long* __restrict__ order,
                     const int* __restrict__ counts, uint4* __restrict__ ks,
                     uint4* __restrict__ vs, int Vs, int nqt) {
  const int bh = blockIdx.y;
  const int n_valid = counts[((size_t)bh * nqt + nqt - 1) * 2 + 1];
  const int limit = min(Vs, (n_valid + BK - 1) / BK * BK);
  const int r = blockIdx.x * GATHER_ROWS + threadIdx.x / CH;
  if (r >= limit) return;
  const int c = threadIdx.x % CH;  // 16-byte chunk of the row
  const size_t row = (size_t)bh * Vs;
  const size_t src = (row + order[row + r]) * CH + c;
  const size_t dst = (row + r) * CH + c;
  ks[dst] = k_vert[src];
  vs[dst] = v_vert[src];
}

// Encode the maps and launch: q [B*H, N, D]; k and v `planes` planes of
// a.rows rows.
template <int MODE, bool CAP>
int launch(const void* q, const void* k, const void* v, const Args& a,
           int B, int planes, void* stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, a.N, B * a.H, a.N, BQ) ||
      !make_map(&km, k, a.rows, planes, a.rows, UNIT) ||
      !make_map(&vm, v, a.rows, planes, a.rows, UNIT))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_wgmma_kernel<MODE, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid(B * a.H, (a.nqt + 1) / 2);
  sparse_wgmma_kernel<MODE, CAP><<<grid, NTHREADS, SMEM_BYTES,
                                   (cudaStream_t)stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

Args base_args(void* acc, void* m, void* l, int H, int N, float scale,
               float cap) {
  Args a = {};
  a.acc = (float*)acc;
  a.m = (float*)m;
  a.l = (float*)l;
  a.H = H;
  a.Hk = H;
  a.N = N;
  a.nqt = (N + BQ - 1) / BQ;
  a.scale = scale;
  a.cap = cap;
  return a;
}

}  // namespace sp

// ---------------------------------------------------------------------------
// Head dim 256: 64-key tiles, no producer warp
// ---------------------------------------------------------------------------

namespace s2 {

using sp::Args;
using sp::BQ;
using sp::kSlash;
using sp::kVertical;
using sp::UNIT;
constexpr int D = 256;
constexpr int BK = UNIT;          // keys a tile: one 64-key unit
constexpr int STAGES = 2;         // K and V tiles in flight
constexpr int NTHREADS = 256;     // two consumer warpgroups
constexpr int NBOX = D / sp::BOX;              // boxes a row
constexpr int Q_BOX = BQ * 128;                // one box column of Q
constexpr int KV_BOX = BK * 128;               // one box column of a tile
constexpr int TILE_BYTES = NBOX * KV_BOX;      // one K or V tile
constexpr int WG_Q_BYTES = 64 * 128;           // a warpgroup's rows of a box
constexpr int NS = BK / 2;                     // S entries a thread
// beside each K tile: its 64 column keys (vertical) or the 16 bytes of vert
// words holding the unit's word (slash)
constexpr int META_BYTES = BK * 4;
constexpr int SMEM_BYTES =
    1024 + NBOX * Q_BOX + 2 * STAGES * TILE_BYTES + STAGES * META_BYTES;
static_assert(SMEM_BYTES <= 232448, "the D = 256 layout");

// S = Q K^T for one warpgroup: 64 rows x 64 keys, 16 steps of 16 along D
// (four 32-byte steps within each 64-column box).
__device__ __forceinline__ void qk_product(float (&s)[NS], uint32_t q_addr,
                                           uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t dq = (kk >> 2) * Q_BOX + (kk & 3) * 32;
    const uint32_t dk = (kk >> 2) * KV_BOX + (kk & 3) * 32;
    wgmma_ss64(s, sw128_desc(q_addr + dq, 16, 1024),
               sw128_desc(k_addr + dk, 16, 1024), kk > 0);
  }
}

// O += P V for one warpgroup: 4 steps of 16 keys, one m64n128k16 product
// for each 128 channels of O (boxes 2h and 2h + 1 of V).
__device__ __forceinline__ void pv_product(float (&o)[2][64],
                                           const uint32_t (&p)[NS / 2],
                                           uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wgmma_rs(o[h], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               sw128_desc(v_addr + h * 2 * KV_BOX + kk * 16 * 128, KV_BOX,
                          1024));
}

__device__ __forceinline__ void rescale(float (&o)[2][64],
                                        const float (&a)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[h][4 * j + 0] *= a[0];
      o[h][4 * j + 1] *= a[0];
      o[h][4 * j + 2] *= a[1];
      o[h][4 * j + 3] *= a[1];
    }
}

// The block's walk, one 64-key unit at a time, for its producer thread:
// the vertical tiles of the sorted columns up to the q tile's last row, or
// the live units of the slash list of each warpgroup's q-block (one walk
// for both where they share it), in list order, as the D = 128 producer
// walks them.  next() gives each unit's first key and the warpgroups it is
// for, false at the end.
struct Walker {
  int nw;          // walks: 0, 1 or 2
  int qb[2], wgs[2], last[2];
  int w, t;        // the current walk and its next list entry
  int k, kend;     // the next unit's key in the current entry, its end
  int n_last;      // vertical: the sorted columns the q tile reads

  __device__ bool next(const Args& a, int mode, int bh, int pad, int& k0,
                       int& wg) {
    if (mode == kVertical) {
      if (k >= n_last) return false;
      k0 = k;
      k += BK;
      wg = wgs[0];
      return true;
    }
    const int nq = a.N / a.q_block;
    while (w < nw) {
      if (k < kend) {
        const int c = k;
        k += UNIT;
        if (c > last[w] || c + UNIT - 1 < pad) continue;
        k0 = c;
        wg = wgs[w];
        return true;
      }
      if (t < a.T) {
        const size_t e = ((size_t)bh * nq + qb[w]) * a.T + t;
        ++t;
        if (a.tile_valid[e]) {
          k = a.tile_idx[e] * a.k_tile;
          kend = k + a.k_tile;
        }
        continue;
      }
      ++w;
      t = 0;
      k = kend = 0;
    }
    return false;
  }
};

// grid (B*H, nqt), NTHREADS threads, SMEM_BYTES of dynamic shared memory:
// block (bh, y) takes q tile nqt-1-y.  Maps, all bf16 with 128-byte
// swizzle: q {D, N, B*H} in boxes {64, 128, 1}; k and v {D, rows, planes}
// in boxes {64, 64, 1}, as the D = 128 kernel's.  CAP: cap the logits.
template <int MODE, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
sparse256_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[STAGES], v_full[STAGES],
      k_empty[STAGES], v_empty[STAGES];
  // per stage: its unit's first key and the warpgroups it is for (bit w:
  // warpgroup w; 0: the walk has ended)
  __shared__ int tile_k0[STAGES], tile_wg[STAGES];
  // 128-byte swizzle repeats every 1024 bytes: boxes start 1024-aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                            // [NBOX][BQ][128 B]
  uint8_t* kring = qs + NBOX * Q_BOX;            // [STAGES][NBOX][BK][128 B]
  uint8_t* vring = kring + STAGES * TILE_BYTES;  // the same
  uint8_t* meta = vring + STAGES * TILE_BYTES;   // [STAGES][META_BYTES]

  const int bh = blockIdx.x;
  const int qt = a.nqt - 1 - (int)blockIdx.y;  // heaviest q tiles first
  const int q0 = qt * BQ;
  const int b = bh / a.H;
  const int plane =
      MODE == kVertical ? bh : b * a.Hk + (bh % a.H) / (a.H / a.Hk);
  const int pad = MODE == kSlash ? a.N - a.true_len[b] : 0;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], NTHREADS);
      mbar_init(&v_empty[i], NTHREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the producer's state (thread 0): the walk, units issued, walk done
  Walker walker = {};
  int issued = 0;
  bool done = false, q_sent = false;
  if (threadIdx.x == 0) {
    // warpgroup 1 has rows unless N % 128 = 64 cuts the q tile short
    const int row_wgs = q0 + 64 < a.N ? 3 : 1;
    if (MODE == kVertical) {
      walker.n_last = a.counts[((size_t)bh * a.nqt + qt) * 2 + 1];
      walker.wgs[0] = row_wgs;
    } else {
      // a warpgroup walks if it has a row past the pad; both share one
      // walk where their 64-row halves lie in one q-block
      const int last0 = min(q0 + 63, a.N - 1);
      const int last1 = min(q0 + 127, a.N - 1);
      const bool live0 = last0 >= pad;
      const bool live1 = row_wgs == 3 && last1 >= pad;
      const int qb0 = q0 / a.q_block, qb1 = (q0 + UNIT) / a.q_block;
      if (live0 && live1 && qb0 == qb1) {
        walker = {1, {qb0, 0}, {3, 0}, {last1, 0}};
      } else {
        if (live0) {
          walker.qb[walker.nw] = qb0;
          walker.wgs[walker.nw] = 1;
          walker.last[walker.nw++] = last0;
        }
        if (live1) {
          walker.qb[walker.nw] = qb1;
          walker.wgs[walker.nw] = 2;
          walker.last[walker.nw++] = last1;
        }
      }
    }
  }
  // thread 0: the next unit (or the end) into its stage, once both
  // warpgroups have released the unit STAGES back there
  auto produce = [&]() {
    if (done) return;
    const int st = issued % STAGES;
    if (issued >= STAGES) {
      mbar_wait(&k_empty[st], ((issued / STAGES) - 1) & 1);
      mbar_wait(&v_empty[st], ((issued / STAGES) - 1) & 1);
    }
    int k0, wgs;
    if (!walker.next(a, MODE, bh, pad, k0, wgs)) {
      tile_wg[st] = 0;  // the end: a stage for no warpgroup, no copy
      mbar_arrive(&k_full[st]);
      mbar_arrive(&v_full[st]);
      done = true;
      return;
    }
    if (!q_sent) {
      mbar_expect(&q_full, NBOX * Q_BOX);
      for (int x = 0; x < NBOX; ++x)
        tma_load_3d(qs + x * Q_BOX, &qmap, x * sp::BOX, q0, bh, &q_full);
      q_sent = true;
    }
    tile_k0[st] = k0;
    tile_wg[st] = wgs;
    uint8_t* md = meta + st * META_BYTES;
    mbar_expect(&k_full[st], TILE_BYTES + (MODE == kVertical ? META_BYTES
                                                              : 16));
    uint8_t* kd = kring + st * TILE_BYTES;
    for (int x = 0; x < NBOX; ++x)
      tma_load_3d(kd + x * KV_BOX, &kmap, x * sp::BOX, k0, plane,
                  &k_full[st]);
    if (MODE == kSlash)
      bulk_g2s(md, a.vbits + (size_t)bh * a.nwords + ((k0 / UNIT) & ~1), 16,
               &k_full[st]);
    else
      bulk_g2s(md, a.keys + (size_t)bh * a.vs_pad + k0, META_BYTES,
               &k_full[st]);
    uint8_t* vd = vring + st * TILE_BYTES;
    mbar_expect(&v_full[st], TILE_BYTES);
    for (int x = 0; x < NBOX; ++x)
      tma_load_3d(vd + x * KV_BOX, &vmap, x * sp::BOX, k0, plane,
                  &v_full[st]);
    ++issued;
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES; ++i) produce();

  const int cw = threadIdx.x / 128;  // consumer warpgroup: 64 rows
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const int r_lo = q0 + cw * 64;                  // the warpgroup's first row
  const int r0 = r_lo + warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  // vertical: the sorted columns every row of the q tile sees
  const int n_first =
      MODE == kVertical ? a.counts[((size_t)bh * a.nqt + qt) * 2] : 0;
  const uint32_t q_addr = smem_addr(qs) + cw * WG_Q_BYTES;
  const uint32_t kring_a = smem_addr(kring);
  const uint32_t vring_a = smem_addr(vring);
  const float inv_cap = CAP ? 1.f / a.cap : 0.f;
  float o[2][64], s[NS];
  uint32_t p[NS / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 64; ++e) o[h][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  bool q_ready = false;
  for (int i = 0;; ++i) {
    // the unit a step ahead, into the stage unit i - 1 held
    if (threadIdx.x == 0 && i >= 1) produce();
    const int st = i % STAGES, ph = (i / STAGES) & 1;
    mbar_wait(&k_full[st], ph);
    const int wgs = tile_wg[st];
    if (!((wgs >> cw) & 1)) {  // the other warpgroup's unit, or the end
      mbar_arrive(&k_empty[st]);
      mbar_wait(&v_full[st], ph);
      mbar_arrive(&v_empty[st]);
      if (wgs == 0) break;
      continue;
    }
    if (!q_ready) {
      // q * scale, rounded to bf16, in place (this warpgroup's 64 rows of
      // every box), then fenced for wgmma's async-proxy reads
      mbar_wait(&q_full, 0);
#pragma unroll
      for (int it = 0; it < NBOX * WG_Q_BYTES / 16 / 128; ++it) {
        const int c = tid + 128 * it;  // 16-byte chunk
        uint4* qp = reinterpret_cast<uint4*>(
            qs + (c / (WG_Q_BYTES / 16)) * Q_BOX + cw * WG_Q_BYTES +
            (c % (WG_Q_BYTES / 16)) * 16);
        uint4 x = *qp;
        x.x = sp::scale2(x.x, a.scale);
        x.y = sp::scale2(x.y, a.scale);
        x.z = sp::scale2(x.z, a.scale);
        x.w = sp::scale2(x.w, a.scale);
        *qp = x;
      }
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      q_ready = true;
    }
    wgmma_fence();
    qk_product(s, q_addr, kring_a + st * TILE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    sp::cap_tile<CAP>(s, inv_cap, a.cap);
    const uint8_t* md = meta + st * META_BYTES;
    const int k0 = tile_k0[st];
    if constexpr (MODE == kVertical) {
      // interior: every column's key <= the q tile's first row
      if (k0 + BK > n_first)
        sp::mask_keys(s, reinterpret_cast<const int*>(md), r0, tig);
    } else {
      const unsigned long long w =
          reinterpret_cast<const unsigned long long*>(md)[(k0 / UNIT) & 1];
      // every test unless every row of the warpgroup lies past the pad and
      // at or below every column
      if (!(k0 >= pad && k0 + UNIT - 1 <= r_lo))
        sp::mask_unit(s, 0, k0, w, r0, tig, pad);
      else if (w != 0ull)
        sp::mask_unit_bits(s, 0, w, tig);
    }
    mbar_arrive(&k_empty[st]);
    float alpha[2];
    sp::softmax_tile(s, m, l, alpha);
    rescale(o, alpha);
    sp::pack_p(s, p);
    mbar_wait(&v_full[st], ph);
    wgmma_fence();
    pv_product(o, p, vring_a + st * TILE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o[0]);
    fence_regs(o[1]);
    mbar_arrive(&v_empty[st]);
  }

  // full row sums across the 4 threads of a row group, then the rows that
  // exist (a last q tile may hold 64)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= a.N) continue;
    const size_t row = (size_t)bh * a.N + r;
    float* ab = a.acc + row * D;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int c = 0; c < 16; ++c)
        *reinterpret_cast<float2*>(ab + half * 128 + c * 8 + tig * 2) =
            make_float2(o[half][4 * c + 2 * h], o[half][4 * c + 2 * h + 1]);
    if (tig == 0) {
      a.m[row] = m[h] == -INFINITY ? NEG_MAX : m[h];
      a.l[row] = l[h];
    }
  }
}

template <int MODE, bool CAP>
int launch(const void* q, const void* k, const void* v, const Args& a,
           int B, int planes, void* stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, a.N, B * a.H, a.N, BQ, D) ||
      !make_map(&km, k, a.rows, planes, a.rows, BK, D) ||
      !make_map(&vm, v, a.rows, planes, a.rows, BK, D))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse256_kernel<MODE, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid(B * a.H, a.nqt);
  sparse256_kernel<MODE, CAP><<<grid, NTHREADS, SMEM_BYTES,
                                (cudaStream_t)stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

}  // namespace s2

// The launch for head dim D (128 or 256) and the cap (a.cap > 0);
// cudaErrorInvalidValue for another D.
template <int MODE>
int dispatch(const void* q, const void* k, const void* v, const sp::Args& a,
             int B, int planes, int D, void* stream) {
  const bool cap = a.cap > 0.f;
  if (D == 128)
    return cap ? sp::launch<MODE, true>(q, k, v, a, B, planes, stream)
               : sp::launch<MODE, false>(q, k, v, a, B, planes, stream);
  if (D == 256)
    return cap ? s2::launch<MODE, true>(q, k, v, a, B, planes, stream)
               : s2::launch<MODE, false>(q, k, v, a, B, planes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Slash over the entries tile_valid flags (the grid function's flags, or
// the db function's valid prefix): acc [B*H, N, D], m, l [B*H, N] f32.
// vbits [B*H, nwords] int64: the vert flags packed 64 columns a word.  D:
// 128 or 256; cap: the logit cap, 0 for none.
extern "C" int pkv_slash_tiles(const void* q, const void* k, const void* v,
                               const void* tile_idx, const void* tile_valid,
                               const void* vbits, const void* true_len,
                               void* acc, void* m, void* l, int B, int H,
                               int Hk, int D, int N, int q_block, int k_tile,
                               int T, int nwords, float scale, float cap,
                               void* stream) {
  sp::Args a = sp::base_args(acc, m, l, H, N, scale, cap);
  a.Hk = Hk;
  a.rows = N;
  a.true_len = (const int*)true_len;
  a.tile_idx = (const int*)tile_idx;
  a.tile_valid = (const uint8_t*)tile_valid;
  a.vbits = (const unsigned long long*)vbits;
  a.nwords = nwords;
  a.q_block = q_block;
  a.k_tile = k_tile;
  a.T = T;
  return dispatch<sp::kSlash>(q, k, v, a, B, B * Hk, D, stream);
}

// Vertical: k_vert, v_vert [B*H, Vs, D] bf16 as gathered; order [B*H, Vs]
// int64, each (b, h)'s columns by key; keys [B*H, vs_pad] the keys in that
// order (int max past the valid ones and up to vs_pad); counts [B*H,
// ceil(N/128), 2]: the keys <= each q tile's first and last row; k_sorted,
// v_sorted [B*H, Vs, D] bf16 scratch for the rows in key order.  D: 128 or
// 256; cap: the logit cap, 0 for none.
extern "C" int pkv_vertical_partials(const void* q, const void* k_vert,
                                     const void* v_vert, const void* order,
                                     const void* keys, const void* counts,
                                     void* k_sorted, void* v_sorted,
                                     void* acc, void* m, void* l, int B,
                                     int H, int D, int N, int Vs, int vs_pad,
                                     float scale, float cap, void* stream) {
  if (D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  sp::Args a = sp::base_args(acc, m, l, H, N, scale, cap);
  a.rows = Vs;
  a.keys = (const int*)keys;
  a.counts = (const int*)counts;
  a.vs_pad = vs_pad;
  const dim3 grid((Vs + sp::GATHER_ROWS - 1) / sp::GATHER_ROWS, B * H);
  if (D == 128)
    sp::gather_sorted_kernel<16><<<grid, sp::GATHER_ROWS * 16, 0,
                                   (cudaStream_t)stream>>>(
        (const uint4*)k_vert, (const uint4*)v_vert, (const long long*)order,
        a.counts, (uint4*)k_sorted, (uint4*)v_sorted, Vs, a.nqt);
  else
    sp::gather_sorted_kernel<32><<<grid, sp::GATHER_ROWS * 32, 0,
                                   (cudaStream_t)stream>>>(
        (const uint4*)k_vert, (const uint4*)v_vert, (const long long*)order,
        a.counts, (uint4*)k_sorted, (uint4*)v_sorted, Vs, a.nqt);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return dispatch<sp::kVertical>(q, k_sorted, v_sorted, a, B, B * H, D,
                                 stream);
}
