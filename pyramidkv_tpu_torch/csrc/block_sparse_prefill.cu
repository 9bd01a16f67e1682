// MInference's block-sparse prefill partials on sm_90a: the slash tiles
// (whole list, or its valid prefix double-buffered) and the vertical
// columns.
//
// Replaces: pyramidkv_tpu/kernels/block_sparse_prefill.py
//   slash_tile_attention               (body `_kernel`)      -> pkv_slash_tiles
//   slash_tile_attention_db            (body `_db_kernel`)   -> pkv_slash_tiles_db
//   vertical_attention_partials_kernel (body `_vert_kernel`) -> pkv_vertical_partials
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
// What bounds them on the H100: operations.  At 32k each 64-row q tile
// multiplies against at most T*k_tile = 2048 slash keys and Vs = 1024-3584
// vertical columns, ~4*64*2048*128 flops per 2*2048*128*2 bytes of K/V: far
// above the card's ~295 flop/byte bf16 ridge.
//
// What the design does about it:
// - One block per (64-row q tile, b*h), 4 warps x 16 rows, mma.sync
//   m16n8k16 bf16 with f32 accumulation; q fragments stay in registers and
//   the S -> P fragments feed P V without a trip through shared memory (the
//   layout of csrc/flash_prefill.cu).  A q tile takes the tile list of the
//   q-block it lies in; query head h reads KV head h / G (no repeat_kv).
// - Work that cannot contribute is not done: a 64-key sub-tile that is
//   invalid, wholly above the diagonal or wholly left of the pad is
//   skipped (exact: in the TPU kernel such a tile gives p = 0, alpha = 1),
//   as is a 64-column vertical chunk with no valid column at or below the
//   tile's last row (top-k order is not sorted, so no causal cut-off).
// - Natural-log row maxes: s = q K^T in f32, then exp(s - m) as
//   exp2(s * log2e - m * log2e); log2(e) is not folded into the rounded q,
//   as the TPU's block-sparse kernels do not fold it either.
// - The db kernel copies the next live sub-tile's K, V and vert flags with
//   cp.async into a second shared-memory buffer while the current one is
//   multiplied (the TPU pair's difference: a loop over every entry against
//   a double-buffered loop over the valid prefix).
// Dropped TPU-only limits: the scalar-memory chunking over b*h and the
// 8-row broadcast of m / l.  Left for later: TMA / wgmma, a deeper pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head dim (the only one the kernels take)
constexpr int BQ = 64;        // q rows per block: 4 warps x 16 rows
constexpr int BK = 64;        // keys per sub-tile / vertical chunk
constexpr int NTHREADS = 128;
constexpr int LDS = D + 8;    // padded smem row (bf16): conflict-free fragments
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_MAX = -3.4028234663852886e38f;  // float32.min
constexpr int NO_COL = 0x7fffffff;  // a column id no row reaches

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two consecutive bf16 of q, times `scale` in f32, rounded back to bf16
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Per-thread state of one warp's 16 query rows: q fragments, the f32
// accumulator fragments, and the running max / partial sum of the thread's
// two rows (r0 and r0 + 8).
struct Rows {
  uint32_t qf[D / 16][4];
  float o[D / 8][4];
  float m[2];
  float l[2];
};

__device__ __forceinline__ void load_rows(Rows& st,
                                          const __nv_bfloat16* qrow0,
                                          int tig, float scale) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    st.qf[kk][0] = load_q2(qrow0 + c, scale);
    st.qf[kk][1] = load_q2(qrow0 + 8 * D + c, scale);
    st.qf[kk][2] = load_q2(qrow0 + c + 8, scale);
    st.qf[kk][3] = load_q2(qrow0 + 8 * D + c + 8, scale);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    st.o[dt][0] = st.o[dt][1] = st.o[dt][2] = st.o[dt][3] = 0.f;
  }
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// One 64-key sub-tile (ks, vs: [64][LDS] in shared memory) into the rows'
// state.  colkey(c) is the id a column must not exceed the row to be
// visible (NO_COL: never visible): element (row, c) counts iff
// colkey(c) <= row.
template <class ColKey>
__device__ __forceinline__ void attend(Rows& st, const __nv_bfloat16* ks,
                                       const __nv_bfloat16* vs, int r0,
                                       int gid, int tig, ColKey colkey) {
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
      mma_bf16(s[nt], st.qf[kk], b0, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + ((e >> 1) << 3);
      if (colkey(nt * 8 + tig * 2 + (e & 1)) > row) s[nt][e] = -INFINITY;
    }
  }
  // online softmax, one update per fragment row (i = 0: r0, i = 1: r0 + 8)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[i], mx);
    // a row with nothing visible yet keeps p == 0 and alpha == 0
    const float ml = (m_new == -INFINITY) ? 0.f : m_new * LOG2E;
    const float alpha = exp2f(st.m[i] * LOG2E - ml);
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = exp2f(fmaf(s[nt][2 * i], LOG2E, -ml));
      const float p1 = exp2f(fmaf(s[nt][2 * i + 1], LOG2E, -ml));
      s[nt][2 * i] = p0;
      s[nt][2 * i + 1] = p1;
      rs += p0 + p1;
    }
    st.l[i] = st.l[i] * alpha + rs;
    st.m[i] = m_new;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      st.o[dt][2 * i] *= alpha;
      st.o[dt][2 * i + 1] *= alpha;
    }
  }
  // O += P V, P rounded to bf16
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
      mma_bf16(st.o[dt], a, b0, b1);
    }
  }
}

// Write the rows' partials: acc [.., N, D], m / l [.., N] at row r0 (and
// r0 + 8) of this (b, h).
__device__ __forceinline__ void store_rows(Rows& st, float* acc, float* m,
                                           float* l, int r0, int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 1);
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 2);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    *reinterpret_cast<float2*>(acc + (size_t)r0 * D + c) =
        make_float2(st.o[dt][0], st.o[dt][1]);
    *reinterpret_cast<float2*>(acc + (size_t)(r0 + 8) * D + c) =
        make_float2(st.o[dt][2], st.o[dt][3]);
  }
  if (tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[r0 + 8 * i] = st.m[i] == -INFINITY ? NEG_MAX : st.m[i];
      l[r0 + 8 * i] = st.l[i];
    }
  }
}

// a whole q tile with nothing visible: acc = 0, m = float32.min, l = 0
__device__ __forceinline__ void store_empty(float* acc, float* m, float* l,
                                            int q0, int tid) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < BQ * D / 4; i += NTHREADS) {
    reinterpret_cast<float4*>(acc + (size_t)q0 * D)[i] = z;
  }
  if (tid < BQ) {
    m[q0 + tid] = NEG_MAX;
    l[q0 + tid] = 0.f;
  }
}

// synchronous copy of 64 rows of K and V ([.., D] bf16) into shared memory
__device__ __forceinline__ void load_kv(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                        const __nv_bfloat16* kg,
                                        const __nv_bfloat16* vg, int tid) {
#pragma unroll
  for (int i = 0; i < BK * D / 8 / NTHREADS; ++i) {
    const int idx = tid + i * NTHREADS;
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&ks[r * LDS + c]) =
        *reinterpret_cast<const uint4*>(kg + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(&vs[r * LDS + c]) =
        *reinterpret_cast<const uint4*>(vg + (size_t)r * D + c);
  }
}

struct SlashArgs {
  const __nv_bfloat16* q;   // [B*H, N, D]
  const __nv_bfloat16* k;   // [B*Hk, N, D]
  const __nv_bfloat16* v;   // [B*Hk, N, D]
  const int* tile_idx;      // [B*H, N/q_block, T]
  const void* flags;        // grid: tile_valid uint8 [B*H, nq, T]; db: nval int [B*H, nq]
  const uint8_t* vert;      // [B*H, N]
  const int* true_len;      // [B]
  float* acc;               // [B*H, N, D]
  float* m;                 // [B*H, N]
  float* l;                 // [B*H, N]
  int H, Hk, N, q_block, k_tile, T;
  float scale;
};

// Which (b, h), rows and list a block works on.
struct SlashBlock {
  int bh, kv_row, pad, q0, last_row, r0;
  const int* list;  // this q-block's T tile ids
  int list_pos;     // (bh * nq + qb): index of the list
};

__device__ __forceinline__ SlashBlock slash_block(const SlashArgs& a,
                                                  int warp, int gid) {
  SlashBlock sb;
  sb.bh = blockIdx.y;
  const int b = sb.bh / a.H;
  sb.kv_row = b * a.Hk + (sb.bh % a.H) / (a.H / a.Hk);
  sb.pad = a.N - a.true_len[b];
  sb.q0 = blockIdx.x * BQ;
  sb.last_row = sb.q0 + BQ - 1;
  sb.r0 = sb.q0 + warp * 16 + gid;
  sb.list_pos = sb.bh * (a.N / a.q_block) + sb.q0 / a.q_block;
  sb.list = a.tile_idx + (size_t)sb.list_pos * a.T;
  return sb;
}

// Slash, grid (#11): every list entry in order; invalid entries and dead
// sub-tiles are skipped.
__global__ void __launch_bounds__(NTHREADS)
slash_tiles_kernel(const SlashArgs a) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LDS];
  __shared__ uint8_t vf[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const SlashBlock sb = slash_block(a, warp, gid);
  const size_t row_base = (size_t)sb.bh * a.N;
  if (sb.last_row < sb.pad) {  // every row is padding
    store_empty(a.acc + row_base * D, a.m + row_base, a.l + row_base, sb.q0,
                tid);
    return;
  }
  const uint8_t* valid =
      static_cast<const uint8_t*>(a.flags) + (size_t)sb.list_pos * a.T;
  const __nv_bfloat16* kb = a.k + (size_t)sb.kv_row * a.N * D;
  const __nv_bfloat16* vb = a.v + (size_t)sb.kv_row * a.N * D;
  const uint8_t* vrow = a.vert + row_base;
  const int pad = sb.pad;

  Rows st;
  load_rows(st, a.q + (row_base + sb.r0) * D, tig, a.scale);
  const int subs = a.k_tile / BK;
  for (int t = 0; t < a.T; ++t) {
    if (!valid[t]) continue;
    const int tile0 = sb.list[t] * a.k_tile;
    for (int sub = 0; sub < subs; ++sub) {
      const int k0 = tile0 + sub * BK;
      if (k0 > sb.last_row || k0 + BK - 1 < pad) continue;
      __syncthreads();  // the previous sub-tile is consumed
      load_kv(ks, vs, kb + (size_t)k0 * D, vb + (size_t)k0 * D, tid);
      if (tid < BK) vf[tid] = vrow[k0 + tid];
      __syncthreads();
      attend(st, ks, vs, sb.r0, gid, tig, [&](int c) {
        const int col = k0 + c;
        return (vf[c] || col < pad) ? NO_COL : col;
      });
    }
  }
  store_rows(st, a.acc + row_base * D, a.m + row_base, a.l + row_base, sb.r0,
             tig);
}

// Slash, db (#12): the valid prefix [0, nval) only, the next live
// sub-tile's K, V and vert flags copied with cp.async into the other half
// of a double buffer while the current one is multiplied.
constexpr int DB_SMEM = 2 * 2 * BK * LDS * 2 + 2 * BK;

__global__ void __launch_bounds__(NTHREADS)
slash_tiles_db_kernel(const SlashArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BK*LDS]
  __nv_bfloat16* vbuf = kbuf + 2 * BK * LDS;                      // [2][BK*LDS]
  uint8_t* vfbuf = reinterpret_cast<uint8_t*>(vbuf + 2 * BK * LDS);  // [2][BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const SlashBlock sb = slash_block(a, warp, gid);
  const size_t row_base = (size_t)sb.bh * a.N;
  if (sb.last_row < sb.pad) {
    store_empty(a.acc + row_base * D, a.m + row_base, a.l + row_base, sb.q0,
                tid);
    return;
  }
  const int nval = static_cast<const int*>(a.flags)[sb.list_pos];
  const __nv_bfloat16* kb = a.k + (size_t)sb.kv_row * a.N * D;
  const __nv_bfloat16* vb = a.v + (size_t)sb.kv_row * a.N * D;
  const uint8_t* vrow = a.vert + row_base;
  const int pad = sb.pad;
  const int subs = a.k_tile / BK;
  const int total = nval * subs;

  // first key of live sub-tile j (list entry j / subs), or -1 if dead
  auto key0 = [&](int j) {
    const int k0 = sb.list[j / subs] * a.k_tile + (j % subs) * BK;
    return (k0 > sb.last_row || k0 + BK - 1 < pad) ? -1 : k0;
  };
  auto next_live = [&](int j) {
    while (j < total && key0(j) < 0) ++j;
    return j;
  };
  auto prefetch = [&](int k0, int stage) {
    __nv_bfloat16* ks = kbuf + stage * BK * LDS;
    __nv_bfloat16* vs = vbuf + stage * BK * LDS;
#pragma unroll
    for (int i = 0; i < BK * D / 8 / NTHREADS; ++i) {
      const int idx = tid + i * NTHREADS;
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      cp_async16(&ks[r * LDS + c], kb + (size_t)(k0 + r) * D + c);
      cp_async16(&vs[r * LDS + c], vb + (size_t)(k0 + r) * D + c);
    }
    if (tid < BK / 16) cp_async16(vfbuf + stage * BK + tid * 16,
                                  vrow + k0 + tid * 16);
  };

  Rows st;
  load_rows(st, a.q + (row_base + sb.r0) * D, tig, a.scale);
  int cur = next_live(0);
  if (cur < total) prefetch(key0(cur), 0);
  cp_async_commit();
  int stage = 0;
  while (cur < total) {
    const int nxt = next_live(cur + 1);
    if (nxt < total) prefetch(key0(nxt), stage ^ 1);
    cp_async_commit();
    cp_async_wait1();  // cur's group has landed (groups complete in order)
    __syncthreads();
    const int k0 = key0(cur);
    const uint8_t* vf = vfbuf + stage * BK;
    attend(st, kbuf + stage * BK * LDS, vbuf + stage * BK * LDS, sb.r0, gid,
           tig, [&](int c) {
             const int col = k0 + c;
             return (vf[c] || col < pad) ? NO_COL : col;
           });
    __syncthreads();  // this buffer is consumed before it is refilled
    cur = nxt;
    stage ^= 1;
  }
  store_rows(st, a.acc + row_base * D, a.m + row_base, a.l + row_base, sb.r0,
             tig);
}

// Vertical (#13): every query row against its head's Vs gathered columns,
// walked in 64-column chunks with an online softmax.
__global__ void __launch_bounds__(NTHREADS)
vertical_partials_kernel(const __nv_bfloat16* __restrict__ q,   // [B*H, N, D]
                         const __nv_bfloat16* __restrict__ kv,  // [B*H, Vs, D]
                         const __nv_bfloat16* __restrict__ vv,  // [B*H, Vs, D]
                         const int* __restrict__ vcol,          // [B*H, Vs]
                         const uint8_t* __restrict__ vvalid,    // [B*H, Vs]
                         float* __restrict__ acc, float* __restrict__ m,
                         float* __restrict__ l, int N, int Vs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LDS];
  __shared__ int ckey[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int last_row = q0 + BQ - 1;
  const int r0 = q0 + warp * 16 + gid;
  const size_t row_base = (size_t)bh * N;
  const size_t col_base = (size_t)bh * Vs;

  Rows st;
  load_rows(st, q + (row_base + r0) * D, tig, scale);
  for (int c0 = 0; c0 < Vs; c0 += BK) {
    __syncthreads();  // the previous chunk is consumed
    int live = 0;
    if (tid < BK) {
      const int key = vvalid[col_base + c0 + tid] ? vcol[col_base + c0 + tid]
                                                  : NO_COL;
      ckey[tid] = key;
      live = key <= last_row;
    }
    if (!__syncthreads_or(live)) continue;  // nothing visible in this chunk
    load_kv(ks, vs, kv + (col_base + c0) * D, vv + (col_base + c0) * D, tid);
    __syncthreads();
    attend(st, ks, vs, r0, gid, tig, [&](int c) { return ckey[c]; });
  }
  store_rows(st, acc + row_base * D, m + row_base, l + row_base, r0, tig);
}

SlashArgs slash_args(const void* q, const void* k, const void* v,
                     const void* tile_idx, const void* flags,
                     const void* vert, const void* true_len, void* acc,
                     void* m, void* l, int H, int Hk, int N, int q_block,
                     int k_tile, int T, float scale) {
  SlashArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.tile_idx = (const int*)tile_idx;
  a.flags = flags;
  a.vert = (const uint8_t*)vert;
  a.true_len = (const int*)true_len;
  a.acc = (float*)acc;
  a.m = (float*)m;
  a.l = (float*)l;
  a.H = H;
  a.Hk = Hk;
  a.N = N;
  a.q_block = q_block;
  a.k_tile = k_tile;
  a.T = T;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" int pkv_slash_tiles(const void* q, const void* k, const void* v,
                               const void* tile_idx, const void* tile_valid,
                               const void* vert, const void* true_len,
                               void* acc, void* m, void* l, int B, int H,
                               int Hk, int N, int q_block, int k_tile, int T,
                               float scale, void* stream) {
  const SlashArgs a = slash_args(q, k, v, tile_idx, tile_valid, vert,
                                 true_len, acc, m, l, H, Hk, N, q_block,
                                 k_tile, T, scale);
  slash_tiles_kernel<<<dim3(N / BQ, B * H), NTHREADS, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int pkv_slash_tiles_db(const void* q, const void* k, const void* v,
                                  const void* tile_idx, const void* nval,
                                  const void* vert, const void* true_len,
                                  void* acc, void* m, void* l, int B, int H,
                                  int Hk, int N, int q_block, int k_tile,
                                  int T, float scale, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        slash_tiles_db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DB_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const SlashArgs a = slash_args(q, k, v, tile_idx, nval, vert, true_len,
                                 acc, m, l, H, Hk, N, q_block, k_tile, T,
                                 scale);
  slash_tiles_db_kernel<<<dim3(N / BQ, B * H), NTHREADS, DB_SMEM,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int pkv_vertical_partials(const void* q, const void* k_vert,
                                     const void* v_vert, const void* vcol,
                                     const void* vvalid, void* acc, void* m,
                                     void* l, int B, int H, int N, int Vs,
                                     float scale, void* stream) {
  vertical_partials_kernel<<<dim3(N / BQ, B * H), NTHREADS, 0,
                             (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_vert,
      (const __nv_bfloat16*)v_vert, (const int*)vcol, (const uint8_t*)vvalid,
      (float*)acc, (float*)m, (float*)l, N, Vs, scale);
  return (int)cudaGetLastError();
}
