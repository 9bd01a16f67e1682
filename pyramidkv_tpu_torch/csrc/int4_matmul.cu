// Streaming weight-quantized matmuls for decode-sized x (sm_90a).
//
// Replaces, in pyramidkv_tpu/kernels/int4_matmul.py (Pallas TPU):
//   - int4_matmul      (bodies `_kernel_planar`, `_kernel_planar_grouped`,
//                       `_kernel`, `_kernel_grouped`)  -> pkv_int4_matmul
//   - int8_matmul      (body `_kernel8`)               -> pkv_int8_matmul
//   - int4_matmul_dma  (body `_dma_window_body`)       -> pkv_int4_matmul_dma
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
// 3.49 GB of layer codes, a 1.04 ms floor.
//
// What the design does about it:
// - Every code byte is read from device memory once, in wide coalesced
//   loads (16 bytes a thread for 1-2 rows, 4 bytes for 3-8), and never
//   staged: nibbles are decoded in registers with an exact float trick
//   (2^23 + (u ^ 8) - (2^23 + 8)), no int->float conversion instruction.
// - The in-dim is split across blocks (split-K) so that even the 16 column
//   strips of wo / w_down fill the 132 SMs: each block writes f32 partials
//   [split, rows, out] to a workspace that stays in L2, and a second small
//   kernel sums the splits in a fixed order (deterministic), applies the
//   per-channel scale and casts.  A split holds whole scale groups, and
//   each warp's row range lies inside one group, so a grouped warp scales
//   its own partial once.
// - x rows are tiled by RT <= 8 (grid z); more rows re-read the codes from
//   L2 for each row tile (rows > 8 only occur in verify-sized calls).
// - int4_matmul_dma streams each block's [win, 64-byte] code windows into
//   shared memory through a cp.async double buffer (the Hopper counterpart
//   of the TPU kernel's make_async_copy pair) and computes from there.
// Left for later: tensor-core (mma/wgmma) inner products for rows >= 8,
// TMA rings, and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;   // code rows a thread has in flight at once
constexpr int DMA_BO = 64;  // bytes of a DMA block's column strip

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
// is 2^23 + t, so subtracting 2^23 + bias gives t - bias with no rounding.
// Signed nibble n = (u ^ 8) - 8 and signed byte b = (u ^ 128) - 128.
__device__ __forceinline__ float nibble(uint32_t word, int shift) {
  return __int_as_float(((word >> shift) & 0xFu) ^ 0x4B000008u) - 8388616.f;
}
__device__ __forceinline__ float sbyte(uint32_t word, int shift) {
  return __int_as_float(((word >> shift) & 0xFFu) ^ 0x4B000080u) - 8388736.f;
}

__device__ __forceinline__ float load_x(const void* x, int x_f32, size_t i) {
  return x_f32 ? reinterpret_cast<const float*>(x)[i]
               : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i]);
}

// Logical output column of value vi of a thread whose bytes start at j0:
// int4 values are [lo of VB bytes | hi of VB bytes].
template <int VB, bool NIB>
__device__ __forceinline__ int column(int j0, int vi, int span) {
  if (!NIB) return j0 + vi;
  const int j = j0 + (vi % VB);
  const int s = j / span;
  return 2 * s * span + (j - s * span) + (vi / VB) * span;
}

// Sum the per-thread accumulators over the TYN threads that share a column
// group (thread tid = ty * TXN + tx) and store the block's partial
// ws[split, row, col].  Done in pieces of P values through `red`.
template <int RT, int VB, bool NIB, int TXN>
__device__ __forceinline__ void reduce_store(const float* acc, float* red, float* ws,
                                             int split, int rows, int r0, int ncb,
                                             int out, int span, int jbase) {
  constexpr int VALS = NIB ? 2 * VB : VB;
  constexpr int V = RT * VALS;
  constexpr int P = V < 16 ? V : 16;
  constexpr int TYN = THREADS / TXN;
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
      const int r = flat / VALS, vi = flat % VALS;
      const int j0 = jbase + l * VB;
      if (j0 < ncb && r0 + r < rows) {
        ws[((size_t)split * rows + r0 + r) * out + column<VB, NIB>(j0, vi, span)] = s;
      }
    }
    __syncthreads();
  }
}

// One FMA step of a code row: VB bytes against RT x values.
template <int RT, int VB, bool NIB>
__device__ __forceinline__ void fma_row(float* acc, const Vec<VB>& c, const float* xv) {
  constexpr int VALS = NIB ? 2 * VB : VB;
#pragma unroll
  for (int b = 0; b < VB; ++b) {
    const uint32_t word = c.w(b / 4);
    const int sh = 8 * (b % 4);
    if (NIB) {
      const float lo = nibble(word, sh), hi = nibble(word, sh + 4);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc[r * VALS + b] = fmaf(xv[r], lo, acc[r * VALS + b]);
        acc[r * VALS + VB + b] = fmaf(xv[r], hi, acc[r * VALS + VB + b]);
      }
    } else {
      const float q = sbyte(word, sh);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r * VALS + b] = fmaf(xv[r], q, acc[r * VALS + b]);
    }
  }
}

// Split-K streaming kernel.  grid (column strips of 32*VB bytes, splits,
// row tiles); warp ty of a block takes rows [k0 + ty*RW, k0 + (ty+1)*RW)
// of the in-dim, RW = kc / 8; lane tx owns bytes j0 .. j0+VB-1.
template <int RT, int VB, bool NIB, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
stream_mm_kernel(const void* __restrict__ x, const uint8_t* __restrict__ codes,
                 const float* __restrict__ scale, float* __restrict__ ws, int rows,
                 int in_dim, int ncb, int span, int kc, int gs, int x_f32, int round_x) {
  constexpr int VALS = NIB ? 2 * VB : VB;
  constexpr int V = RT * VALS;
  extern __shared__ __align__(16) float xs[];  // [RT][kc]
  __shared__ float red[THREADS * 17];
  const int out = NIB ? 2 * ncb : ncb;
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
      v = load_x(x, x_f32, (size_t)row * in_dim + k);
      if (round_x) v = __bfloat162float(__float2bfloat16(v));
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
        fma_row<RT, VB, NIB>(acc, c[u], xv);
      }
    }
  }
  if (GROUPED && active && kbeg < in_dim) {
    const float* sg = scale + (size_t)(kbeg / gs) * out;
#pragma unroll
    for (int vi = 0; vi < VALS; ++vi) {
      const float s = sg[column<VB, NIB>(j0, vi, span)];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r * VALS + vi] *= s;
    }
  }
  reduce_store<RT, VB, NIB, 32>(acc, red, ws, blockIdx.y, rows, r0, ncb, out, span, jbase);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Windowed int4 kernel (per-channel, span 128).  grid (ncb / 64, splits,
// row tiles); a block walks windows [w0, w0 + wpb) of `win` in-dim rows of
// its 64-byte strip, double-buffered in shared memory by cp.async; thread
// (ty, tx) takes window rows ty, ty + TYN, ... and bytes tx*VB .. +VB-1.
template <int RT, int VB>
__global__ void __launch_bounds__(THREADS)
dma_mm_kernel(const void* __restrict__ x, const uint8_t* __restrict__ codes,
              float* __restrict__ ws, int rows, int in_dim, int ncb, int win, int wpb,
              int x_f32) {
  constexpr int TXN = DMA_BO / VB, TYN = THREADS / TXN;
  constexpr int V = RT * 2 * VB;
  extern __shared__ __align__(16) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem + 2 * (size_t)win * DMA_BO);  // [RT][win]
  __shared__ float red[THREADS * 17];
  const int tid = threadIdx.x;
  const int tx = tid % TXN, ty = tid / TXN;
  const int jbase = blockIdx.x * DMA_BO;
  const int r0 = blockIdx.z * RT;
  const int w0 = blockIdx.y * wpb;
  const int nw = min(wpb, in_dim / win - w0);

  auto issue = [&](int slot, int w) {
    const uint8_t* src = codes + (size_t)(w0 + w) * win * ncb + jbase;
    for (int c = tid; c < win * (DMA_BO / 16); c += THREADS) {
      const int row = c / (DMA_BO / 16), q = c % (DMA_BO / 16);
      cp_async16(smem + (size_t)slot * win * DMA_BO + row * DMA_BO + q * 16, src + (size_t)row * ncb + q * 16);
    }
    cp_async_commit();
  };

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  issue(0, 0);
  for (int w = 0; w < nw; ++w) {
    const int slot = w & 1;
    if (w + 1 < nw) issue(slot ^ 1, w + 1);
    const int kw = (w0 + w) * win;
    for (int i = tid; i < RT * win; i += THREADS) {
      const int r = i / win, kk = i - r * win;
      xs[i] = r0 + r < rows ? load_x(x, x_f32, (size_t)(r0 + r) * in_dim + kw + kk) : 0.f;
    }
    if (w + 1 < nw) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* b = smem + (size_t)slot * win * DMA_BO;
#pragma unroll 4
    for (int rr = ty; rr < win; rr += TYN) {
      Vec<VB> c;
      c.load(b + rr * DMA_BO + tx * VB);
      float xv[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) xv[r] = xs[r * win + rr];
      fma_row<RT, VB, true>(acc, c, xv);
    }
    __syncthreads();  // the buffer and xs are refilled next
  }
  reduce_store<RT, VB, true, TXN>(acc, red, ws, blockIdx.y, rows, r0, ncb, 2 * ncb, 128, jbase);
}

// y[r, c] = cast(sum over splits of ws[split, r, c] (* scale[c]))
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ ws, const float* __restrict__ scale, void* __restrict__ y,
              int y_f32, int n, int out, int splits) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[(size_t)sp * n + i];
  if (scale) s *= scale[i % out];
  if (y_f32) {
    reinterpret_cast<float*>(y)[i] = s;
  } else {
    reinterpret_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(s);
  }
}

int finish(const float* ws, const float* scale, void* y, int y_f32, int rows, int out,
           int splits, cudaStream_t st) {
  const int n = rows * out;
  finish_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(ws, scale, y, y_f32, n, out,
                                                                 splits);
  return (int)cudaGetLastError();
}

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

template <int RT, int VB, bool NIB, bool GROUPED>
int launch_stream(const void* x, const void* codes, const float* scale, float* ws, int rows,
                  int in_dim, int ncb, int kc, int splits, int gs, int x_f32, cudaStream_t st) {
  static size_t granted = 0;
  const size_t smem = (size_t)RT * kc * sizeof(float);
  auto kernel = stream_mm_kernel<RT, VB, NIB, GROUPED>;
  if (int e = allow_smem(kernel, smem, granted)) return e;
  const int span = NIB && ncb % 128 == 0 ? 128 : 1;
  dim3 grid((ncb + 32 * VB - 1) / (32 * VB), splits, (rows + RT - 1) / RT);
  kernel<<<grid, THREADS, smem, st>>>(x, (const uint8_t*)codes, scale, ws, rows, in_dim, ncb,
                                      span, kc, gs, x_f32, NIB ? 0 : 1);
  return (int)cudaGetLastError();
}

template <bool NIB, bool GROUPED>
int dispatch_stream(int rt, int vb, const void* x, const void* codes, const float* scale,
                    float* ws, int rows, int in_dim, int ncb, int kc, int splits, int gs,
                    int x_f32, cudaStream_t st) {
#define PKV_CASE(R, B)                                                                    \
  if (rt == R && vb == B)                                                                 \
    return launch_stream<R, B, NIB, GROUPED>(x, codes, scale, ws, rows, in_dim, ncb, kc, \
                                             splits, gs, x_f32, st);
  PKV_CASE(1, 16) PKV_CASE(1, 4) PKV_CASE(1, 1)
  PKV_CASE(2, 16) PKV_CASE(2, 4) PKV_CASE(2, 1)
  PKV_CASE(4, 4) PKV_CASE(4, 1)
  PKV_CASE(8, 4) PKV_CASE(8, 1)
#undef PKV_CASE
  return (int)cudaErrorInvalidValue;
}

template <int RT, int VB>
int launch_dma(const void* x, const void* codes, float* ws, int rows, int in_dim, int ncb,
               int win, int wpb, int splits, int x_f32, cudaStream_t st) {
  static size_t granted = 0;
  const size_t smem = 2 * (size_t)win * DMA_BO + (size_t)RT * win * sizeof(float);
  auto kernel = dma_mm_kernel<RT, VB>;
  if (int e = allow_smem(kernel, smem, granted)) return e;
  dim3 grid(ncb / DMA_BO, splits, (rows + RT - 1) / RT);
  kernel<<<grid, THREADS, smem, st>>>(x, (const uint8_t*)codes, ws, rows, in_dim, ncb, win, wpb,
                                      x_f32);
  return (int)cudaGetLastError();
}

bool plan_ok(int rows, int in_dim, int ncb, int kc, int splits) {
  return rows > 0 && in_dim > 0 && ncb > 0 && kc > 0 && kc % 8 == 0 && splits > 0 &&
         (long long)kc * splits >= in_dim && (long long)kc * (splits - 1) < in_dim;
}

}  // namespace

// Each returns a CUDA error code; cudaErrorInvalidValue for a plan the
// kernels do not take.  flags: 1 = x is f32 (else bf16), 2 = y is f32.
// ws is f32 [splits, rows, out]; y is [rows, out].

extern "C" int pkv_int4_matmul(const void* x, const void* codes, const void* scale, void* ws,
                               void* y, int rows, int in_dim, int out2, int group_size, int rt,
                               int vb, int kc, int splits, int flags, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!plan_ok(rows, in_dim, out2, kc, splits)) return (int)cudaErrorInvalidValue;
  const int x_f32 = flags & 1, y_f32 = (flags >> 1) & 1;
  int e;
  if (group_size) {
    // whole groups per split, each warp's rows (kc / 8) inside one group
    if (kc % group_size || group_size % (kc / 8) || in_dim % group_size)
      return (int)cudaErrorInvalidValue;
    e = dispatch_stream<true, true>(rt, vb, x, codes, (const float*)scale, (float*)ws, rows,
                                    in_dim, out2, kc, splits, group_size, x_f32, st);
  } else {
    e = dispatch_stream<true, false>(rt, vb, x, codes, nullptr, (float*)ws, rows, in_dim, out2,
                                     kc, splits, 0, x_f32, st);
  }
  if (e) return e;
  return finish((const float*)ws, group_size ? nullptr : (const float*)scale, y, y_f32, rows,
                2 * out2, splits, st);
}

extern "C" int pkv_int8_matmul(const void* x, const void* codes, const void* scale, void* ws,
                               void* y, int rows, int in_dim, int out, int rt, int vb, int kc,
                               int splits, int flags, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!plan_ok(rows, in_dim, out, kc, splits)) return (int)cudaErrorInvalidValue;
  const int x_f32 = flags & 1, y_f32 = (flags >> 1) & 1;
  const int e = dispatch_stream<false, false>(rt, vb, x, codes, nullptr, (float*)ws, rows,
                                              in_dim, out, kc, splits, 0, x_f32, st);
  if (e) return e;
  return finish((const float*)ws, (const float*)scale, y, y_f32, rows, out, splits, st);
}

extern "C" int pkv_int4_matmul_dma(const void* x, const void* codes, const void* scale,
                                   void* ws, void* y, int rows, int in_dim, int out2, int rt,
                                   int vb, int win, int wpb, int splits, int flags,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || out2 % 128 || win <= 0 || in_dim % win || wpb <= 0 || splits <= 0 ||
      (long long)wpb * splits < in_dim / win || (long long)wpb * (splits - 1) >= in_dim / win)
    return (int)cudaErrorInvalidValue;
  const int x_f32 = flags & 1, y_f32 = (flags >> 1) & 1;
  int e;
  if (rt == 1 && vb == 16) {
    e = launch_dma<1, 16>(x, codes, (float*)ws, rows, in_dim, out2, win, wpb, splits, x_f32, st);
  } else if (rt == 2 && vb == 16) {
    e = launch_dma<2, 16>(x, codes, (float*)ws, rows, in_dim, out2, win, wpb, splits, x_f32, st);
  } else if (rt == 4 && vb == 4) {
    e = launch_dma<4, 4>(x, codes, (float*)ws, rows, in_dim, out2, win, wpb, splits, x_f32, st);
  } else if (rt == 8 && vb == 4) {
    e = launch_dma<8, 4>(x, codes, (float*)ws, rows, in_dim, out2, win, wpb, splits, x_f32, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
  return finish((const float*)ws, (const float*)scale, y, y_f32, rows, 2 * out2, splits, st);
}
