// Weight-quantized matmuls for decode-sized x (sm_90a).
//
// Replaces, in pyramidkv_tpu/kernels/int4_matmul.py (Pallas TPU):
//   - int4_matmul      (bodies `_kernel_planar`, `_kernel_planar_grouped`,
//                       `_kernel`, `_kernel_grouped`)  -> pkv_int4_mm
//   - int4_matmul_dma  (body `_dma_window_body`)       -> pkv_int4_mm, its
//                       window the rows of a ring stage (the windowed copy
//                       is what TMA does on this card)
//   - int8_matmul      (body `_kernel8`)               -> pkv_int8_matmul
//
// What they compute, for x [rows, in] (bf16 or f32) and codes [in, ncb]:
//   int4: y = x @ dequant(codes), two signed nibbles per byte along the out
//         axis in the span-planar layout of models/weights.py::pack_span:
//         byte j, with s = j / span and p = j % span, holds column
//         2*s*span + p (low nibble) and 2*s*span + span + p (high nibble);
//         span is 128 when ncb % 128 == 0, else 1.  Scales are per output
//         channel [out] (an f32 epilogue) or per group [G, out] (each
//         group's f32 partial is scaled before it is summed).
//   int8: y = (bf16(x) @ codes) * scale: x is rounded to bf16 first, as the
//         TPU kernel's bf16 operands do, even when the caller passes f32.
// Products accumulate in f32 (nibble and int8 values are exact in f32, and
// so is each product with a bf16 x); y is written in x's dtype.
//
// What bounds them on the H100: bytes.  At decode a weight byte is read once
// and used for 2 (int4) or 1 (int8) multiply-adds per x row, 1-8 rows: far
// below the card's ridge.  Llama-3-8B's fused w_gateup is 58.7 MB of packed
// codes per launch, 17.5 us at 3.35 TB/s; one int4 decode step reads
// 3.49 GB of layer codes, a 1.04 ms floor.  At 3.35 TB/s the card decodes
// 6.7e12 nibbles a second, so instructions per nibble matter as much as
// bytes in flight.
//
// int4 (int4_mm_kernel): one kernel, one launch a call.
// - Schedule.  Block (rank, strip) takes a strip of 64 * ncol code bytes and
//   one slice of the in-dim; the slices of a strip are the ranks of a
//   thread-block cluster (at most 8).  Each rank writes its f32 partial
//   [rows][2][strip bytes] into rank 0's shared memory (distributed shared
//   memory) and meets the others at one cluster barrier; rank 0 sums them
//   in rank order, applies the per-channel scale (staged at its start),
//   casts and writes y.  No workspace, no second kernel, no atomics: two
//   calls are bitwise equal.  The launch is a programmatic dependent: its
//   start overlaps the tail of the kernel before, and it waits for that
//   kernel before it reads or writes device memory.
// - Ring.  A producer warp streams the slice through `stages` stages of
//   [ks rows x 64 bytes] boxes, one per 64-byte column of the strip, by TMA
//   (a 2-D tensor map over the codes [in, out2] bytes, 64-byte swizzle, so
//   the consumers' 8-byte loads meet no bank conflict).  Codes whose rows
//   are not 16-byte aligned (out2 % 16 != 0, or a view that starts off
//   alignment) are copied into the same layout by the producer warp's own
//   byte loads instead.  x's slice is staged once, by the consumers, while
//   the first stages land.
// - Products on the tensor cores: mma.sync m16n8k16 (bf16 -> f32).  A code
//   byte's low and high nibbles are M rows g and g + 8 (a lane's 8 bytes,
//   8 tiles), in-rows are K (a lane pairs rows k and k + 2 of a 4-row
//   quad, so x is staged with rows 1 and 2 of every quad swapped), x rows
//   are N (8 a pass; more rows take more passes over the slice, its codes
//   read again from L2).  A nibble becomes bf16 by bit operations: prmt
//   puts the same byte of two in-rows in one word, lop3 masks a nibble
//   under 0x43 with its sign bit flipped (bf16 128 + (u ^ 8)), and one
//   bf16x2 subtraction of 136 leaves the signed value: 1.5 instructions a
//   nibble, every product exact.
// - kw warps of one 64-byte column take turns at a stage's 16-row
//   k-steps; their partials add in warp order in shared memory before the
//   cluster's.  A block has 8 or 4 consumer warps (4 with group scales, whose
//   second accumulator set needs the registers); the plan takes 4 where
//   clusters would not all fit the card at once with 8.
// - Group scales: a group's products accumulate in a fresh fragment, which
//   is scaled and added to the warp's sum when the warp leaves the group;
//   the slice's scales of the strip are staged in shared memory first
//   (16-byte cp.async copies that land while x is staged, at span 128), or
//   read from L2 where they would take more than 16 KB; a slice holds whole
//   groups, and a k-step that spans groups takes one product per group with
//   x masked to it.
// - f32 x: hi + mid + lo, three bf16 terms that hold an f32 significand
//   exactly (|x| >= 2^-110; below, lo rounds at bf16's smallest subnormal,
//   2^-133), each multiplied by the same decoded codes: three products a
//   tile, one f32 sum.
//
// int8 (stream_mm_kernel + finish_kernel, unchanged since it was ported):
// every code byte read from device memory once in wide coalesced loads,
// decoded in registers with an exact float trick; the in-dim split across
// blocks (split-K), f32 partials summed in a fixed order by a second kernel
// that applies the scale and casts.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

// Dynamic shared memory above 48 KB needs the attribute once per kernel.
template <typename K>
int allow_smem(K kernel, size_t bytes, size_t& granted) {
  if (bytes > 48 * 1024 && bytes > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// int4
// ---------------------------------------------------------------------------

namespace i4 {

constexpr int COL = 64;            // code bytes of a strip column (a box's width)
constexpr int MAX_CONSUMERS = 8;   // consumer warps a block (ncol * kw; half with group scales)
constexpr int MAX_THREADS = 32 * (MAX_CONSUMERS + 1);
constexpr uint32_t BF16X2_136 = 0x43084308u;  // bf16 136 in both halves
constexpr int SMEM_MAX = 232448;   // a block's shared memory on the H100

struct Args {
  const void* x;
  const uint8_t* codes;
  const float* scale;
  void* y;
  int rows, in_dim, out2, span, gs;  // gs 0: per-channel scales
  int ncol, kw, ks, stages, cluster, slice, rp;
  int ss_rows;  // group-scale rows of a slice staged in shared memory (0: read from L2)
  int tma;
};

// Rows of a TMA box: a stage of ks rows takes ks / box_rows boxes a column.
__host__ __device__ inline int box_rows(int ks) {
  return ks % 256 == 0 ? 256 : ks % 128 == 0 ? 128 : 64;
}

// x's row pitch in shared memory (bf16): the slice in whole stages, plus 8
// so that the 8 x rows of a B fragment load fall in distinct banks.
__host__ __device__ inline int x_pitch(const Args& a) {
  return (a.slice + a.ks - 1) / a.ks * a.ks + 8;
}

// Shared memory of a block, from a 1024-byte aligned base: the ring (the
// warps' partials [kw][rp][2][64 * ncol] f32 once a pass's stages are
// read), x [terms][rp][pitch] bf16, the strip's scales [rows][2][64 * ncol]
// f32 (the slice's groups, or one row of per-channel scales), the partials
// the cluster's ranks send rank 0 [cluster][rp][2][64 * ncol] f32 (none
// without a cluster), then the ring's barriers.
struct Layout {
  int region, xs, ss, recv, total;
};

__host__ __device__ inline Layout layout(const Args& a, bool xf32) {
  Layout l;
  const int sb = COL * a.ncol;
  const int ring = a.stages * a.ks * sb;
  const int part = a.kw * a.rp * 2 * sb * 4;
  l.region = ((ring > part ? ring : part) + 1023) / 1024 * 1024;
  l.xs = ((xf32 ? 3 : 1) * a.rp * x_pitch(a) * 2 + 15) / 16 * 16;
  l.ss = (a.gs ? a.ss_rows : 1) * 2 * sb * 4;
  l.recv = a.cluster > 1 ? a.cluster * a.rp * 2 * sb * 4 : 0;
  l.total = l.region + l.xs + l.ss + l.recv + 2 * a.stages * 8 + 1024;  // + base alignment
  return l;
}

// Byte (r, c) of a [rows x 64 B] box as TMA lays it with 64-byte swizzle:
// the 16-byte chunk index XOR (r / 2) % 4.
__device__ __forceinline__ int swz(int r, int c) {
  return r * COL + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

// Output column of byte j's nibble `nib` in the span-planar layout
__device__ __forceinline__ int column(int j, int span, int nib) {
  return span == 1 ? 2 * j + nib : ((j >> 7) << 8) + nib * 128 + (j & 127);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t x;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(x) : "r"(a), "r"(b), "r"(sel));
  return x;
}

// bf16x2 of the signed low nibbles of bytes 0 and 2 of d: lop3 gives
// (d & 0x000F000F) ^ 0x43084308, bf16 128 + (u ^ 8) in each half, and the
// subtraction of 136 leaves (u ^ 8) - 8, the nibble's two's complement
// value.
__device__ __forceinline__ uint32_t nib2(uint32_t d) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(r) : "r"(d), "r"(0x000F000Fu), "r"(BF16X2_136));
  const uint32_t k = BF16X2_136;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&k));
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += A B, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k-step of a lane: its 8 bytes of in-rows (base, base + 2, base + 8,
// base + 10) in w, decoded into the 8 tiles' A fragments (tile i: byte i's
// low nibble on M row g, its high nibble on g + 8) and multiplied by each
// term's B fragment.
template <int TERMS>
__device__ __forceinline__ void tiles(float (&d)[8][4], const uint2 (&w)[4],
                                      const uint32_t (&b)[TERMS][2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // byte i of both words of a pair, in bytes 0 and 2 (and 1 and 3)
    const uint32_t sel = 0x4400u + (uint32_t)(i & 3) * 0x1111u;
    const uint32_t d01 = prmt(i < 4 ? w[0].x : w[0].y, i < 4 ? w[1].x : w[1].y, sel);
    const uint32_t d23 = prmt(i < 4 ? w[2].x : w[2].y, i < 4 ? w[3].x : w[3].y, sel);
    const uint32_t a0 = nib2(d01), a1 = nib2(d01 >> 4);
    const uint32_t a2 = nib2(d23), a3 = nib2(d23 >> 4);
#pragma unroll
    for (int t = 0; t < TERMS; ++t) mma(d[i], a0, a1, a2, a3, b[t][0], b[t][1]);
  }
}

// f32 v = hi + mid + lo, three bf16 values (exact for |v| >= 2^-110)
__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// x rows [r0, r0 + nr) of the slice [k_lo, k_hi) into xs, zero past k_hi,
// with rows 1 and 2 of every 4-row quad swapped (the order of a lane's
// B fragment); f32 x as its three bf16 terms, one plane each.  Each thread
// takes 8 positions at a time (16-byte loads where x allows them), four
// chunks' loads in flight before their stores.
template <bool XF32>
__device__ __forceinline__ void stage_x(const Args& a, __nv_bfloat16* xs, int xp, int r0, int nr,
                                        int k_lo, int k_hi, int tid, int nthr) {
  const int lpad = xp - 8, len = k_hi - k_lo;
  const int per_row = lpad / 8, n = nr * per_row;
  const bool vec = a.in_dim % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  for (int c0 = tid; c0 < n; c0 += 4 * nthr) {
    float v[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * nthr;
      if (c >= n) break;
      const int r = c / per_row, q = (c - r * per_row) * 8;
      const size_t row = (size_t)(r0 + r) * a.in_dim + k_lo + q;
      float p[8];
      if (vec && q + 8 <= len) {
        if (XF32) {
          const float4 f0 = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(a.x) + row);
          const float4 f1 = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(a.x) + row + 4);
          p[0] = f0.x; p[1] = f0.y; p[2] = f0.z; p[3] = f0.w;
          p[4] = f1.x; p[5] = f1.y; p[6] = f1.z; p[7] = f1.w;
        } else {
          const uint4 h = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const __nv_bfloat16*>(a.x) + row);
          const uint32_t hw[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            p[j] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(hw[j / 2] >> (16 * (j & 1)))));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = q + j;
          p[j] = k >= len ? 0.f
                 : XF32 ? reinterpret_cast<const float*>(a.x)[row + j]
                        : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.x)[row + j]);
        }
      }
      // logical position j holds physical row j with bits 0 and 1 swapped
#pragma unroll
      for (int j = 0; j < 8; ++j) v[u][j] = p[(j & ~3) | ((j & 1) << 1) | ((j >> 1) & 1)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * nthr;
      if (c >= n) break;
      const int r = c / per_row, q = (c - r * per_row) * 8;
      __nv_bfloat16 t[3][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (XF32) {
          split3(v[u][j], t[0][j], t[1][j], t[2][j]);
        } else {
          t[0][j] = __float2bfloat16_rn(v[u][j]);  // exact: x is bf16
        }
      }
#pragma unroll
      for (int pl = 0; pl < (XF32 ? 3 : 1); ++pl)
        *reinterpret_cast<uint4*>(xs + (pl * a.rp + r) * xp + q) =
            make_uint4(pack_bf16(t[pl][0], t[pl][1]), pack_bf16(t[pl][2], t[pl][3]),
                       pack_bf16(t[pl][4], t[pl][5]), pack_bf16(t[pl][6], t[pl][7]));
    }
  }
}

// The strip's scales into ss [row][nib][c] (the slice's groups, or the
// per-channel row): byte c's low-nibble column (nib 0) and high-nibble
// column (nib 1), 0 past the codes' width.  At span 128 a row's 64 * ncol
// columns of either nibble lie side by side: 16-byte cp.async copies that
// land while x is staged (the caller waits for them); else plain loads.
__device__ __forceinline__ void stage_scales(const Args& a, float* ss, int g_lo, int j0, int sb,
                                             int tid, int nthr) {
  const int g_hi = a.gs ? min(a.in_dim / a.gs, g_lo + a.ss_rows) : 1;
  const int n = (g_hi - g_lo) * 2 * sb;
  if (a.span == 128 && a.tma && reinterpret_cast<uintptr_t>(a.scale) % 16 == 0) {
    for (int e = tid; e < n / 4; e += nthr) {
      const int r = e / (sb / 2), nib = (e / (sb / 4)) & 1, j = j0 + 4 * (e % (sb / 4));
      const float* src = a.scale + (size_t)(g_lo + r) * 2 * a.out2;
      const bool in = j < a.out2;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(ss + 4 * e)),
                   "l"(in ? src + column(j, 128, nib) : src), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return;
  }
  for (int e0 = tid; e0 < n; e0 += 8 * nthr) {  // 8 loads in flight a thread
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * nthr;
      const int r = e / (2 * sb), nib = (e / sb) & 1, j = j0 + e % sb;
      v[u] = e < n && j < a.out2
                 ? __ldg(a.scale + (size_t)(g_lo + r) * 2 * a.out2 + column(j, a.span, nib))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (e0 + u * nthr < n) ss[e0 + u * nthr] = v[u];
  }
}

// acc += frag * the 16 scales of the lane's tiles in group grp ([i] byte i's
// low-nibble column, [8 + i] its high one; 0 past the codes' width), from
// the staged rows ([nib][c], c from the lane's first byte cb) or the
// group's row of the scales; frag = 0.
__device__ __forceinline__ void flush(float (&acc)[8][4], float (&frag)[8][4], const Args& a,
                                      const float* ss, int grp, int g_lo, int sb, int cb,
                                      int j0) {
  float s[16];
  if (a.ss_rows) {
    const float* row = ss + (grp - g_lo) * 2 * sb;
    const float4* p = reinterpret_cast<const float4*>(row + cb);
    const float4* q = reinterpret_cast<const float4*>(row + sb + cb);
    const float4 l0 = p[0], l1 = p[1], h0 = q[0], h1 = q[1];
    const float v[16] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w,
                         h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = v[i];
  } else {
    const float* row = a.scale + (size_t)grp * 2 * a.out2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = j0 + cb + i;
      s[i] = j < a.out2 ? row[column(j, a.span, 0)] : 0.f;
      s[8 + i] = j < a.out2 ? row[column(j, a.span, 1)] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i][0] = fmaf(frag[i][0], s[i], acc[i][0]);
    acc[i][1] = fmaf(frag[i][1], s[i], acc[i][1]);
    acc[i][2] = fmaf(frag[i][2], s[8 + i], acc[i][2]);
    acc[i][3] = fmaf(frag[i][3], s[8 + i], acc[i][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) frag[i][e] = 0.f;
  }
}

// grid (cluster ranks, strips), clusters along x; warps 0 .. ncol*kw - 1
// consume (warp w: column w % ncol, k-steps w / ncol (mod kw) of a
// stage), the last warp produces.
template <bool XF32, bool GROUPED>
__global__ void __launch_bounds__(GROUPED ? 32 * (MAX_CONSUMERS / 2 + 1) : MAX_THREADS, 2)
int4_mm_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  namespace cg = cooperative_groups;
  constexpr int TERMS = XF32 ? 3 : 1;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const Layout lay = layout(a, XF32);
  uint8_t* ring = sm;
  float* part = reinterpret_cast<float*>(sm);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sm + lay.region);
  float* ss = reinterpret_cast<float*>(sm + lay.region + lay.xs);
  float* recv = reinterpret_cast<float*>(sm + lay.region + lay.xs + lay.ss);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.region + lay.xs + lay.ss + lay.recv);
  uint64_t* empty = full + a.stages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwc = a.ncol * a.kw;
  const int sb = COL * a.ncol;
  const int nrank = a.cluster;
  const int rank = (int)cl.block_rank();
  const int j0 = blockIdx.y * sb;
  const int k_lo = rank * a.slice;
  const int k_hi = min(a.in_dim, k_lo + a.slice);
  const int nst = (k_hi - k_lo + a.ks - 1) / a.ks;  // stages of this slice
  const int xp = x_pitch(a);
  const int stage_bytes = a.ks * sb;
  const int psz = a.rp * 2 * sb;  // floats of a warp's (and a rank's) partial

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], a.tma ? 1 : 32);
      mbar_init(&empty[s], nwc);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // launched as a programmatic dependent: wait here for the kernels before
  // (x, the codes and y may be theirs) to finish
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  int seq = 0;  // stages of earlier passes (the ring's running count)
  for (int r0 = 0; r0 < a.rows; r0 += a.rp) {
    const int nr = min(a.rp, a.rows - r0);
    if (warp == nwc) {
      // producer: the slice's stages, in order
      const int br = box_rows(a.ks);
      for (int i = 0; i < nst; ++i) {
        const int sq = seq + i, s = sq % a.stages;
        uint8_t* st = ring + (size_t)s * stage_bytes;
        const int k0 = k_lo + i * a.ks;
        if (a.tma) {
          if (lane == 0) {
            if (sq >= a.stages) mbar_wait(&empty[s], (sq / a.stages - 1) & 1);
            mbar_expect(&full[s], stage_bytes);
            for (int c = 0; c < a.ncol; ++c)
              for (int b = 0; b < a.ks; b += br)
                tma_load_2d(st + (c * a.ks + b) * COL, &map, j0 + c * COL, k0 + b, &full[s]);
          }
        } else {
          if (sq >= a.stages) mbar_wait(&empty[s], (sq / a.stages - 1) & 1);
          for (int e = lane; e < stage_bytes; e += 32) {
            const int c = e % COL, r = (e / COL) % a.ks, col = e / (COL * a.ks);
            const int k = k0 + r, j = j0 + col * COL + c;
            st[col * a.ks * COL + swz(r, c)] =
                k < a.in_dim && j < a.out2 ? a.codes[(size_t)k * a.out2 + j] : 0;
          }
          mbar_arrive(&full[s]);
        }
      }
    } else {
      const int nthr = nwc * 32;
      const int col = warp % a.ncol, kwi = warp / a.ncol;
      const int g = lane >> 2, t = lane & 3;
      const int base = (t & 1) + 4 * (t >> 1);  // the lane's first row of a k-step
      const int cb = col * COL + 8 * g;         // the lane's first byte of the strip
      // the lane's 8 bytes in the 4 rows of a k-step: swizzled offsets
      int off[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = base + (q & 1) * 2 + (q >> 1) * 8;
        off[q] = r * COL + ((((g >> 1) ^ (r >> 1)) & 3) << 4) + 8 * (g & 1);
      }
      const bool xrow = g < nr;  // the lane's B fragment column is an x row
      const __nv_bfloat16* xl = xs + g * xp + 2 * t;
      const int g_lo = GROUPED ? k_lo / a.gs : 0;
      if (r0 == 0 && (GROUPED ? a.ss_rows > 0 : rank == 0))
        stage_scales(a, ss, g_lo, j0, sb, threadIdx.x, nthr);
      stage_x<XF32>(a, xs, xp, r0, nr, k_lo, k_hi, threadIdx.x, nthr);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      named_bar_sync(1, nthr);

      float acc[8][4], frag[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = frag[i][e] = 0.f;
      int cur = -1;  // the group in frag
      for (int i = 0; i < nst; ++i) {
        const int sq = seq + i, s = sq % a.stages;
        mbar_wait(&full[s], (sq / a.stages) & 1);
        const uint8_t* box = ring + (size_t)s * stage_bytes + col * a.ks * COL;
        // the stage's k-steps with rows in the slice; this warp's are kwi,
        // kwi + kw, ...
        const int nks = (min(a.ks, k_hi - k_lo - i * a.ks) + 15) / 16;
        for (int kq = kwi; kq < nks; kq += a.kw) {
          const int kk = i * a.ks + kq * 16;  // the k-step's first row in the slice
          uint2 w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = *reinterpret_cast<const uint2*>(box + kq * 16 * COL + off[q]);
          uint32_t b[TERMS][2];
#pragma unroll
          for (int tm = 0; tm < TERMS; ++tm) {
            b[tm][0] = b[tm][1] = 0u;
            if (xrow) {
              const uint32_t* xr = reinterpret_cast<const uint32_t*>(xl + tm * a.rp * xp + kk);
              b[tm][0] = xr[0];
              b[tm][1] = xr[4];
            }
          }
          if (!GROUPED) {
            tiles<TERMS>(acc, w, b);
            continue;
          }
          const int k0 = k_lo + kk;
          const int g0 = k0 / a.gs, g1 = (min(k0 + 16, k_hi) - 1) / a.gs;
          for (int grp = g0; grp <= g1; ++grp) {
            if (grp != cur) {  // leave group cur: its fragment, scaled, joins the sum
              if (cur >= 0) flush(acc, frag, a, ss, cur, g_lo, sb, cb, j0);
              cur = grp;
            }
            if (g0 == g1) {
              tiles<TERMS>(frag, w, b);
              continue;
            }
            // a k-step across groups: one product per group, x masked to it
            const uint32_t m0 = ((k0 + base) / a.gs == grp ? 0xFFFFu : 0u) |
                                ((k0 + base + 2) / a.gs == grp ? 0xFFFF0000u : 0u);
            const uint32_t m1 = ((k0 + base + 8) / a.gs == grp ? 0xFFFFu : 0u) |
                                ((k0 + base + 10) / a.gs == grp ? 0xFFFF0000u : 0u);
            uint32_t bm[TERMS][2];
#pragma unroll
            for (int tm = 0; tm < TERMS; ++tm) {
              bm[tm][0] = b[tm][0] & m0;
              bm[tm][1] = b[tm][1] & m1;
            }
            tiles<TERMS>(frag, w, bm);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (GROUPED && cur >= 0) flush(acc, frag, a, ss, cur, g_lo, sb, cb, j0);

      named_bar_sync(1, nthr);  // every stage read: the ring takes the partials
      float* wp = part + kwi * psz;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 2 * t + e;
          if (row < nr) {
            wp[(row * 2) * sb + cb + i] = acc[i][e];
            wp[(row * 2 + 1) * sb + cb + i] = acc[i][2 + e];
          }
        }
      named_bar_sync(1, nthr);
      // the column's warps add in warp order; a cluster rank sends its sum
      // to rank 0's shared memory
      float* dst = nrank > 1 ? cl.map_shared_rank(recv, 0) + rank * psz : part;
      for (int e = threadIdx.x; e < nr * 2 * sb; e += nthr) {
        float v = part[e];
        for (int k = 1; k < a.kw; ++k) v += part[k * psz + e];
        dst[e] = v;
      }
    }
    seq += nst;
    if (r0 + a.rp >= a.rows) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    cl.sync();  // every rank's partial has reached rank 0
    if (rank == 0 && warp < nwc) {
      const float* src = nrank > 1 ? recv : part;
      for (int e = threadIdx.x; e < nr * 2 * sb; e += nwc * 32) {
        const int row = e / (2 * sb), nib = (e / sb) & 1, j = j0 + e % sb;
        if (j >= a.out2) continue;
        float v = src[e];
        for (int r = 1; r < nrank; ++r) v += src[r * psz + e];
        const int c = column(j, a.span, nib);
        if (!GROUPED) v *= ss[e - row * 2 * sb];
        const size_t o = (size_t)(r0 + row) * 2 * a.out2 + c;
        if (XF32) {
          reinterpret_cast<float*>(a.y)[o] = v;
        } else {
          reinterpret_cast<__nv_bfloat16*>(a.y)[o] = __float2bfloat16(v);
        }
      }
    }
    if (r0 + a.rp < a.rows) {
      fence_proxy_async();  // the ring's generic writes before the next pass's copies
      cl.sync();            // rank 0 has read every partial
    }
  }
}

template <bool XF32, bool GROUPED>
int launch_int4(const CUtensorMap& map, const Args& a, cudaStream_t st) {
  static size_t granted = 0;
  auto kernel = int4_mm_kernel<XF32, GROUPED>;
  const Layout lay = layout(a, XF32);
  if (int e = allow_smem(kernel, lay.total, granted)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, (a.out2 + COL * a.ncol - 1) / (COL * a.ncol));
  cfg.blockDim = dim3(32 * (a.ncol * a.kw + 1));
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // its start (launch, barriers) overlaps the tail of the kernel before
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, map, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace i4

// ---------------------------------------------------------------------------
// int8
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int UNROLL = 8;   // code rows a thread has in flight at once

// VB code bytes loaded by one thread at once
template <int VB> struct Vec;
template <> struct Vec<16> {
  uint4 v;
  __device__ __forceinline__ void load(const uint8_t* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { v = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ uint32_t w(int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <> struct Vec<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const uint8_t* p) { v = *reinterpret_cast<const uint32_t*>(p); }
  __device__ __forceinline__ void zero() { v = 0; }
  __device__ __forceinline__ uint32_t w(int) const { return v; }
};
template <> struct Vec<1> {
  uint32_t v;
  __device__ __forceinline__ void load(const uint8_t* p) { v = *p; }
  __device__ __forceinline__ void zero() { v = 0; }
  __device__ __forceinline__ uint32_t w(int) const { return v; }
};

// Exact small-integer decode: for t in [0, 2^23), as_float(0x4B000000 | t)
// is 2^23 + t, so subtracting 2^23 + 128 gives t - 128 with no rounding:
// signed byte b = (u ^ 128) - 128.
__device__ __forceinline__ float sbyte(uint32_t word, int shift) {
  return __int_as_float(((word >> shift) & 0xFFu) ^ 0x4B000080u) - 8388736.f;
}

__device__ __forceinline__ float load_x(const void* x, int x_f32, size_t i) {
  return x_f32 ? reinterpret_cast<const float*>(x)[i]
               : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i]);
}

// Sum the per-thread accumulators over the 8 warps that share a column
// group (thread tid = ty * 32 + tx) and store the block's partial
// ws[split, row, col].  Done in pieces of P values through `red`.
template <int RT, int VB>
__device__ __forceinline__ void reduce_store(const float* acc, float* red, float* ws,
                                             int split, int rows, int r0, int ncb, int jbase) {
  constexpr int V = RT * VB;
  constexpr int P = V < 16 ? V : 16;
  constexpr int TXN = 32, TYN = THREADS / TXN;
  const int tid = threadIdx.x;
  const int tx = tid % TXN, ty = tid / TXN;
#pragma unroll
  for (int p0 = 0; p0 < V; p0 += P) {
#pragma unroll
    for (int v = 0; v < P; ++v) red[(ty * TXN + tx) * (P + 1) + v] = acc[p0 + v];
    __syncthreads();
    for (int e = tid; e < TXN * P; e += THREADS) {
      const int l = e / P, v = e % P;
      float s = 0.f;
#pragma unroll 8
      for (int w = 0; w < TYN; ++w) s += red[(w * TXN + l) * (P + 1) + v];
      const int flat = p0 + v;
      const int r = flat / VB, vi = flat % VB;
      const int j0 = jbase + l * VB;
      if (j0 < ncb && r0 + r < rows) {
        ws[((size_t)split * rows + r0 + r) * ncb + j0 + vi] = s;
      }
    }
    __syncthreads();
  }
}

// Split-K streaming kernel.  grid (column strips of 32*VB bytes, splits,
// row tiles); warp ty of a block takes rows [k0 + ty*RW, k0 + (ty+1)*RW)
// of the in-dim, RW = kc / 8; lane tx owns bytes j0 .. j0+VB-1.
template <int RT, int VB>
__global__ void __launch_bounds__(THREADS)
stream_mm_kernel(const void* __restrict__ x, const uint8_t* __restrict__ codes,
                 float* __restrict__ ws, int rows, int in_dim, int ncb, int kc, int x_f32) {
  constexpr int V = RT * VB;
  extern __shared__ __align__(16) float xs[];  // [RT][kc]
  __shared__ float red[THREADS * 17];
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int jbase = blockIdx.x * 32 * VB;
  const int j0 = jbase + tx * VB;
  const bool active = j0 < ncb;
  const int k0 = blockIdx.y * kc;
  const int r0 = blockIdx.z * RT;
  const int rw = kc / 8;

  for (int i = tid; i < RT * kc; i += THREADS) {
    const int r = i / kc, kk = i - r * kc;
    const int row = r0 + r, k = k0 + kk;
    float v = 0.f;
    if (row < rows && k < in_dim) {
      v = __bfloat162float(__float2bfloat16(load_x(x, x_f32, (size_t)row * in_dim + k)));
    }
    xs[i] = v;
  }
  __syncthreads();

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  const int kbeg = k0 + ty * rw;
  for (int kk = 0; kk < rw; kk += UNROLL) {
    Vec<VB> c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = kbeg + kk + u;
      if (active && kk + u < rw && k < in_dim) {
        c[u].load(codes + (size_t)k * ncb + j0);
      } else {
        c[u].zero();  // decodes to 0 and x is 0 there: adds nothing
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (kk + u < rw) {
        float xv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) xv[r] = xs[r * kc + ty * rw + kk + u];
#pragma unroll
        for (int b = 0; b < VB; ++b) {
          const float q = sbyte(c[u].w(b / 4), 8 * (b % 4));
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r * VB + b] = fmaf(xv[r], q, acc[r * VB + b]);
        }
      }
    }
  }
  reduce_store<RT, VB>(acc, red, ws, blockIdx.y, rows, r0, ncb, jbase);
}

// y[r, c] = cast(sum over splits of ws[split, r, c] * scale[c])
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ ws, const float* __restrict__ scale, void* __restrict__ y,
              int y_f32, int n, int out, int splits) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[(size_t)sp * n + i];
  s *= scale[i % out];
  if (y_f32) {
    reinterpret_cast<float*>(y)[i] = s;
  } else {
    reinterpret_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(s);
  }
}

template <int RT, int VB>
int launch_stream(const void* x, const void* codes, float* ws, int rows, int in_dim, int ncb,
                  int kc, int splits, int x_f32, cudaStream_t st) {
  static size_t granted = 0;
  const size_t smem = (size_t)RT * kc * sizeof(float);
  auto kernel = stream_mm_kernel<RT, VB>;
  if (int e = allow_smem(kernel, smem, granted)) return e;
  dim3 grid((ncb + 32 * VB - 1) / (32 * VB), splits, (rows + RT - 1) / RT);
  kernel<<<grid, THREADS, smem, st>>>(x, (const uint8_t*)codes, ws, rows, in_dim, ncb, kc, x_f32);
  return (int)cudaGetLastError();
}

int dispatch_stream(int rt, int vb, const void* x, const void* codes, float* ws, int rows,
                    int in_dim, int ncb, int kc, int splits, int x_f32, cudaStream_t st) {
#define PKV_CASE(R, B)   \
  if (rt == R && vb == B) \
    return launch_stream<R, B>(x, codes, ws, rows, in_dim, ncb, kc, splits, x_f32, st);
  PKV_CASE(1, 16) PKV_CASE(1, 4) PKV_CASE(1, 1)
  PKV_CASE(2, 16) PKV_CASE(2, 4) PKV_CASE(2, 1)
  PKV_CASE(4, 4) PKV_CASE(4, 1)
  PKV_CASE(8, 4) PKV_CASE(8, 1)
#undef PKV_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns a CUDA error code; cudaErrorInvalidValue for a plan the
// kernels do not take.

// The tensor map of 2-D int4 codes [in_dim, out2] bytes in boxes of
// 64 bytes x box_rows(ks) rows, 64-byte swizzle, written to `out` (128
// bytes, kept by the caller for later calls).
extern "C" int pkv_int4_map(void* out, const void* codes, int in_dim, int out2, int ks) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr || in_dim <= 0 || out2 <= 0 || out2 % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 16 || ks <= 0 || ks % 64)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const cuuint64_t dims[2] = {(cuuint64_t)out2, (cuuint64_t)in_dim};
  const cuuint64_t strides[1] = {(cuuint64_t)out2};
  const cuuint32_t box[2] = {(cuuint32_t)i4::COL, (cuuint32_t)i4::box_rows(ks)};
  const cuuint32_t elem[2] = {1, 1};
  if (enc(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(codes), dims, strides, box,
          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  memcpy(out, &m, sizeof m);
  return 0;
}

// y [rows, 2 * out2] = x [rows, in_dim] @ dequant(codes [in_dim, out2]);
// scale [2 * out2] (group_size 0) or [in_dim / group_size, 2 * out2].
// map: pkv_int4_map's 128 bytes for these codes and ks, or null for the
// producer warp's own copies.  The plan: strips of 64 * ncol bytes, kw
// warps a strip column, stages of ks rows, `stages` of them in the ring,
// clusters of `cluster` slices of `slice` rows, rp x rows a pass, ss_rows
// group-scale rows of a slice staged in shared memory (0: none).  x_f32: x
// and y are f32 (else bf16).
extern "C" int pkv_int4_mm(const void* x, const void* codes, const void* scale, void* y,
                           const void* map, int rows, int in_dim, int out2, int group_size,
                           int ncol, int kw, int ks, int stages, int cluster, int slice, int rp,
                           int ss_rows, int x_f32, void* stream) {
  using namespace i4;
  const Args a = {x,     (const uint8_t*)codes, (const float*)scale,       y,    rows,
                  in_dim, out2, out2 % 128 == 0 ? 128 : 1, group_size, ncol, kw,
                  ks,    stages, cluster, slice, rp, ss_rows, map != nullptr};
  if (rows <= 0 || in_dim <= 0 || out2 <= 0 || ncol <= 0 || kw <= 0 ||
      ncol * kw > (group_size ? MAX_CONSUMERS / 2 : MAX_CONSUMERS) || ks <= 0 || ks % 64 || ks % (16 * kw) || stages <= 0 ||
      cluster <= 0 || cluster > 8 || slice <= 0 || slice % 16 ||
      (long long)slice * cluster < in_dim || (long long)slice * (cluster - 1) >= in_dim ||
      rp <= 0 || rp > 8 || group_size < 0 ||
      (group_size && (in_dim % group_size || slice % group_size)) ||
      ss_rows < 0 || (ss_rows && (!group_size || ss_rows * group_size < slice)) ||
      (map && (out2 % 16 || reinterpret_cast<uintptr_t>(codes) % 16)) ||
      layout(a, x_f32 != 0).total > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memset(&m, 0, sizeof m);
  if (map) memcpy(&m, map, sizeof m);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_f32) {
    return group_size ? launch_int4<true, true>(m, a, st) : launch_int4<true, false>(m, a, st);
  }
  return group_size ? launch_int4<false, true>(m, a, st) : launch_int4<false, false>(m, a, st);
}

// x [rows, in_dim], codes [in_dim, out] int8, scale [out]; ws is f32
// [splits, rows, out]; y is [rows, out].  flags: 1 = x is f32 (else bf16),
// 2 = y is f32.
extern "C" int pkv_int8_matmul(const void* x, const void* codes, const void* scale, void* ws,
                               void* y, int rows, int in_dim, int out, int rt, int vb, int kc,
                               int splits, int flags, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || in_dim <= 0 || out <= 0 || kc <= 0 || kc % 8 || splits <= 0 ||
      (long long)kc * splits < in_dim || (long long)kc * (splits - 1) >= in_dim)
    return (int)cudaErrorInvalidValue;
  const int x_f32 = flags & 1, y_f32 = (flags >> 1) & 1;
  const int e = dispatch_stream(rt, vb, x, codes, (float*)ws, rows, in_dim, out, kc, splits,
                                x_f32, st);
  if (e) return e;
  const int n = rows * out;
  finish_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      (const float*)ws, (const float*)scale, y, y_f32, n, out, splits);
  return (int)cudaGetLastError();
}
