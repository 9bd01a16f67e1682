// One-token masked decode attention over the slot cache (sm_90a):
// split-S flash-decoding.
//
// Replaces: pyramidkv_tpu/kernels/decode_attn.py::decode_attention_pallas
// (Pallas TPU, body `_kernel`).
//
// What it computes, for each batch row b and query head h = kvh * G + g:
//   logits[s] = scale * (q[b,h] . k[b,kvh,s])   (f32; scale 1/sqrt(D) by
//   default, Gemma-2's query_pre_attn_scalar^-0.5 else), capped to
//   cap * tanh(logits[s] / cap) under a cap (Gemma-2's
//   attn_logit_softcapping: the TPU package computes that decode in XLA,
//   ops/attention.py::decode_attention), float32.min where mask[b,kvh,s]
//   is false; out[b,h] = softmax(logits) @ v[b,kvh].  D = 128 or 256, and
//   32 (the trained tiny retrieval checkpoint, G = 1 and 2).
// G = H / Hk is 1 for the per-query-head caches of snapkv/pyramidkv, 4
// for fullkv's true-GQA cache on Llama-3-8B, 7 on Qwen2.5-7B and 2 on
// Gemma-2-9B (D = 256).  A row whose slots are all
// masked averages every slot uniformly, exactly like the float32.min
// convention of the TPU kernel.  S is unbounded: the TPU's 4096-slot cap was
// a VMEM limit, and fullkv decodes over 8192 + decode slots.
//
// What bounds it on the H100: bytes.  Every visible K and V row is read once
// and used for G <= 8 dot products, ~G/2 flop per byte, far below the ridge.
//
// What the design does about it (D = 256 doubles every byte count below: a
// 3-stage ring of 192 KB, one block an SM):
// - the slots are split across blocks, grid (B * Hk, nsplit), nsplit from
//   the shapes alone (kernels/decode_attn.py::decode_split_plan: one wave
//   of the kernel's residency, two blocks an SM up to G = 4 and one above,
//   64-2048 slots a split), so B * Hk = 8 regions at
//   32k fill the card, and the host reads no device value (the step stays
//   capturable in a CUDA graph);
// - a block streams its split's K and V strips (contiguous [rows, D] bf16)
//   through a ring of 64-slot tiles in shared memory: thread 0 issues two
//   1-D bulk copies a tile (the copy engine, no tensor map), the warps wait
//   on the stage's mbarrier.  3 stages (96 KB, two blocks an SM), never more
//   than a split's tiles;
// - the split's first tiles are copied before its mask is read; the mask
//   then gives per-32-slot visibility words, and later tiles with no
//   visible slot are never copied: the engine's left pads and unwritten
//   decode slots are contiguous masked runs;
// - a warp takes 8 slots of each tile, 8 lanes a slot (D / 8 of the
//   channels each, the query's in registers): one 16-byte shared load per
//   lane and 64 channels, a 3-step shuffle sum per query; P.V with D / 32
//   channels a lane, the probabilities kept in f32;
// - the splits merge in a fixed order, with no atomics (two calls are
//   bitwise equal): up to 4 splits of a region (2 at D = 256) run as one
//   thread-block cluster and block 0 reads the others' partials from their shared
//   memory; more write f32 (acc, m, l) to a workspace that merge_kernel
//   combines (clusters of 8 were slower on the card, and so was a merge in
//   the last split to finish, through a counter); one split writes the
//   bf16 output itself.
// The float32.min convention across splits: a split with no visible slot in
// a row that has one contributes nothing (m = -inf); when the row has none
// at all (the block scans the row's mask to find out), every split attends
// over all its slots at logit float32.min, so the merge averages all S
// slots.  Logits are kept in the base-2 domain (scale * log2(e); under a
// cap, cap * log2(e) after the tanh, tanh.approx.f32 on the MUFU).
// Differences from the TPU kernel: the softmax is online, and the
// probabilities stay f32 in the PV product instead of being rounded to V's
// dtype first.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;                   // threads a block
constexpr int NWARPS = NT / 32;
constexpr int TILE = 64;                  // slots a tile, 8 a warp (the
                                          // wrapper's plan assumes it)
constexpr int HG = TILE / (NWARPS * 4);   // groups of 4 slots a warp
constexpr int WPT = TILE / 32;            // visibility words a tile
constexpr int STAGES = 3;                 // ring depth: 96 KB, two blocks
                                          // an SM, at D = 128
// Splits merged in a thread-block cluster at most (as the wrapper's
// MAX_CLUSTER), more through a workspace and merge_kernel: 4 at D = 128; 2
// at D = 256, whose blocks take a whole SM each, so clusters of 4 must find
// 4 free SMs of one GPC and 32 of them did not fit one wave of 132 SMs
// (Gemma-2's fullkv decode read 0.135 ms in clusters of 4, 0.099 in 5
// splits through merge_kernel, on an H100).
__host__ __device__ constexpr int max_cluster(int D) {
  return D == 256 ? 2 : 4;
}

// Slots a split at most: 2048 at D = 128 (and 32), 4096 at D = 256, where
// one block an SM would otherwise cut Gemma-2's 8224 fullkv slots of 32
// regions into 5 splits of 2048 (160 blocks: two waves of 132 SMs) instead
// of 4 of 2112.
__host__ __device__ constexpr int max_slots(int D) {
  return D == 256 ? 4096 : 2048;
}
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// Bytes of a ring of ns stages of K and V tiles at head dim D, which
// afterwards holds the warps' states (m, l [NWARPS][8 or fewer], acc
// [NWARPS][G][D]) and a cluster split's partial (acc [G][D], m [G], l [G]),
// all f32.
__host__ __device__ constexpr int ring_bytes(int ns, int G, int D) {
  return ns * 2 * TILE * D * 2 > (2 * NWARPS * 8 + (NWARPS + 1) * G * D + 2 * G) * 4
             ? ns * 2 * TILE * D * 2
             : (2 * NWARPS * 8 + (NWARPS + 1) * G * D + 2 * G) * 4;
}

// Dynamic shared memory of a ring of ns stages: the ring, then the stages'
// mbarriers.
__host__ __device__ constexpr int smem_bytes(int ns, int G, int D) {
  return ring_bytes(ns, G, D) + 8 * ns;
}
static_assert(smem_bytes(STAGES, 2, 256) <= 232448, "the ring at D = 256");

// The query's D / 8 channels of this lane, [64u + 8c, 64u + 8c + 8) for each
// 64 channels u (at D = 32 channels [4c, 4c + 4)): f32 registers for
// G <= 4, bf16 pairs for G = 7 and 8 (112-128 f32 would not fit).
template <int G, int D>
struct QReg {
  static constexpr bool PACKED = G > 4;
  float f[PACKED ? 1 : G][D / 8];
  __nv_bfloat162 p[PACKED ? G : 1][D / 16];
  __device__ __forceinline__ float2 pair(int g, int u) const {
    if constexpr (PACKED) return __bfloat1622float2(p[g][u]);
    else return make_float2(f[g][2 * u], f[g][2 * u + 1]);
  }
};


// grid (B * Hk, nsplit): block (bk, sp) attends over slots
// [sp * rows, min(S, (sp + 1) * rows)) of region bk; rows is a multiple of
// TILE.  One split: out[bk * G + g] = bf16 output.  Else the split's partials
// (acc [G, D], m [G], l [G], base-2 m) go to slot bk * nsplit + sp of the
// workspace, for merge_kernel; or with `cluster` (the grid launched as
// clusters of the nsplit blocks of a region) block 0 of the cluster merges
// the splits' partials from the blocks' shared memory, in split order, and
// writes the output.  ns: stages of the ring.  scale2 = scale * log2(e);
// under a cap (CAP) the logit is cap * tanh(scale * x / cap) * log2(e), with
// scale_cap = scale / cap and cap2 = cap * log2(e).
// Blocks an SM holds: two up to G = 4 at D = 128 (the query in f32
// registers, a 96 KB ring); one at G = 7 and 8 (packed pairs) and at
// D = 256 (a 192 KB ring); five at D = 32 (a 24 KB ring, 48 registers).
// At D = 32 a lane of a slot's 8 takes 4 channels (one 8-byte load) and a
// lane of P.V one channel.
template <int G, int D, bool CAP>
__global__ void __launch_bounds__(NT, (D == 128 && G <= 4) ? 2
                                      : D == 32          ? 5
                                                         : 1)
split_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hk*G, D]
             const __nv_bfloat16* __restrict__ k,   // [B, Hk, S, D]
             const __nv_bfloat16* __restrict__ v,   // [B, Hk, S, D]
             const uint8_t* __restrict__ mask,      // [B, Hk, S]
             __nv_bfloat16* __restrict__ out,       // [B, Hk*G, D]
             float* __restrict__ ws_acc, float* __restrict__ ws_m,
             float* __restrict__ ws_l, int S, int rows, float scale2,
             float scale_cap, float cap2, int ns, int cluster) {
  constexpr int MAXS = max_slots(D);        // slots a split at most
  constexpr int MAXT = MAXS / TILE;         // tiles a split at most
  constexpr int ROW_BYTES = D * 2;          // one bf16 K or V row
  constexpr int TILE_BYTES = TILE * ROW_BYTES;
  constexpr int NCH = D / 64;               // 16-byte chunks a lane a row
  constexpr int VCH = D / 32;               // channels a lane in P.V
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint32_t words[MAXS / 32];  // visibility bits, 32 slots a word
  __shared__ int list[MAXT];            // the tiles to attend over, in order
  __shared__ int nlist;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes(ns, G, D));

  const int bk = blockIdx.x, sp = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = sp * rows;
  const int s1 = min(S, s0 + rows);
  const int ntiles = (s1 - s0 + TILE - 1) / TILE;
  const uint8_t* mb = mask + (size_t)bk * S;

  const char* kb = reinterpret_cast<const char*>(k + (size_t)bk * S * D);
  const char* vb = reinterpret_cast<const char*>(v + (size_t)bk * S * D);
  // tile i of the list goes to stage i % ns, its K and V rows copied by the
  // copy engine (thread 0 issues two bulk copies) and awaited on the stage's
  // mbarrier.  The split's first ns tiles are copied before the mask is read
  // (visible or not: a masked slot adds nothing beside a visible one), so
  // the mask's and the tiles' latencies overlap.
  const int pre = min(ntiles, ns);
  auto issue = [&](int i, int t) {
    const int r0 = s0 + t * TILE;
    const int nbytes = min(TILE, s1 - r0) * ROW_BYTES;
    uint8_t* ks = smem + (i % ns) * 2 * TILE_BYTES;
    mbar_expect(&bars[i % ns], 2 * nbytes);
    bulk_g2s(ks, kb + (size_t)r0 * ROW_BYTES, nbytes, &bars[i % ns]);
    bulk_g2s(ks + TILE_BYTES, vb + (size_t)r0 * ROW_BYTES, nbytes, &bars[i % ns]);
  };
  if (tid == 0) {
    for (int i = 0; i < ns; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    for (int i = 0; i < pre; ++i) issue(i, i);
  }

  // the query's channels of this lane (loaded while the mask is read)
  const int j = lane >> 3, c = lane & 7;
  QReg<G, D> qr;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qg = q + ((size_t)bk * G + g) * D;
    if constexpr (D == 32) {
      const uint2 w = *reinterpret_cast<const uint2*>(qg + 4 * c);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if constexpr (QReg<G, D>::PACKED) {
          qr.p[g][u] = p2[u];
        } else {
          const float2 f = __bfloat1622float2(p2[u]);
          qr.f[g][2 * u] = f.x;
          qr.f[g][2 * u + 1] = f.y;
        }
      }
    }
#pragma unroll
    for (int half = 0; half < NCH; ++half) {
      const uint4 w = *reinterpret_cast<const uint4*>(qg + half * 64 + 8 * c);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (QReg<G, D>::PACKED) {
          qr.p[g][half * 4 + u] = p2[u];
        } else {
          const float2 f = __bfloat1622float2(p2[u]);
          qr.f[g][half * 8 + 2 * u] = f.x;
          qr.f[g][half * 8 + 2 * u + 1] = f.y;
        }
      }
    }
  }

  // the split's visibility words (every warp), then the list (warp 0): the
  // prefetched tiles, then the later tiles with a visible slot, in order
  {
    constexpr int PER_WARP = MAXS / 32 / NWARPS;
    bool vis[PER_WARP];
#pragma unroll
    for (int u = 0; u < PER_WARP; ++u) {  // the loads in flight together
      const int s = s0 + (warp + u * NWARPS) * 32 + lane;
      vis[u] = s < s1 && mb[s] != 0;
    }
#pragma unroll
    for (int u = 0; u < PER_WARP; ++u) {
      const int h = warp + u * NWARPS;
      const uint32_t bits = __ballot_sync(FULL, vis[u]);
      if (lane == 0 && h < ntiles * WPT) words[h] = bits;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    bool any = false;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      uint32_t w = 0;
#pragma unroll
      for (int x = 0; x < WPT; ++x) w |= t < ntiles ? words[t * WPT + x] : 0u;
      any |= __any_sync(FULL, w != 0);
      const bool keep = t < ntiles && (t < pre || w != 0);
      const uint32_t b = __ballot_sync(FULL, keep);
      if (keep) list[n + __popc(b & ((1u << lane) - 1u))] = t;
      n += __popc(b);
    }
    if (lane == 0) nlist = any ? n : 0;
  }
  __syncthreads();
  int n = nlist;
  bool uniform = false;
  if (n == 0) {
    // the prefetched tiles land before the block may end
    for (int i = 0; i < pre; ++i) mbar_wait(&bars[i], 0);
    // nothing visible in the split: does the row hold a visible slot?
    bool found = false;
    for (int base = 0; nsplit > 1 && base < S && !found; base += NT * 8) {
      bool mine = false;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = base + u * NT + tid;
        mine |= s < S && mb[s] != 0;
      }
      found = __syncthreads_or(mine);
    }
    // yes: this split attends over nothing, its partial is (0, -inf, 0).
    // No: every slot of the row is masked; attend over all of them at
    // logit float32.min (the words are all zero).  The prefetched tiles'
    // phase 0 has completed; waiting on it again returns at once.
    uniform = !found;
    n = found ? 0 : ntiles;
  }

  float m[G], l[G], acc[G][VCH];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int x = 0; x < VCH; ++x) acc[g][x] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    if (i > 0) {
      __syncthreads();  // stage (i - 1) % ns has been read by every warp
      const int nx = i - 1 + ns;
      if (tid == 0 && nx < n) {
        fence_proxy_async();
        issue(nx, uniform ? nx : list[nx]);
      }
    }
    mbar_wait(&bars[i % ns], (i / ns) & 1);  // tile i has landed
    const int t = uniform ? i : list[i];
    const int r0 = s0 + t * TILE;
    const uint8_t* ks = smem + (i % ns) * 2 * TILE_BYTES;
    const uint8_t* vs = ks + TILE_BYTES;

    // logits of the warp's slots: slot r = HG * 4 * warp + 4 h + j
    float sl[HG][G];
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const int r = warp * HG * 4 + h * 4 + j;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      if constexpr (D == 32) {  // channels [4c, 4c + 4)
        const uint2 k0 = *reinterpret_cast<const uint2*>(ks + r * ROW_BYTES + c * 8);
        const __nv_bfloat162* ka = reinterpret_cast<const __nv_bfloat162*>(&k0);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 fa = __bfloat1622float2(ka[u]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float2 qa = qr.pair(g, u);
            dot[g] = fmaf(qa.x, fa.x, dot[g]);
            dot[g] = fmaf(qa.y, fa.y, dot[g]);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < NCH; half += 2) {
        // channels [64 half + 8c, + 8) and the next 64 channels' likewise
        const uint4 k0 = *reinterpret_cast<const uint4*>(ks + r * ROW_BYTES + (c + 8 * half) * 16);
        const uint4 k1 = *reinterpret_cast<const uint4*>(ks + r * ROW_BYTES + (c + 8 * half + 8) * 16);
        const __nv_bfloat162* ka = reinterpret_cast<const __nv_bfloat162*>(&k0);
        const __nv_bfloat162* kc = reinterpret_cast<const __nv_bfloat162*>(&k1);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 fa = __bfloat1622float2(ka[u]);
          const float2 fc = __bfloat1622float2(kc[u]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float2 qa = qr.pair(g, 4 * half + u);
            const float2 qc = qr.pair(g, 4 * half + 4 + u);
            dot[g] = fmaf(qa.x, fa.x, dot[g]);
            dot[g] = fmaf(qa.y, fa.y, dot[g]);
            dot[g] = fmaf(qc.x, fc.x, dot[g]);
            dot[g] = fmaf(qc.y, fc.y, dot[g]);
          }
        }
      }
      const bool in_row = r0 + r < s1;
      const bool vis = (words[t * WPT + (r >> 5)] >> (r & 31)) & 1u;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = dot[g];
        x += __shfl_xor_sync(FULL, x, 1);
        x += __shfl_xor_sync(FULL, x, 2);
        x += __shfl_xor_sync(FULL, x, 4);
        // past S: not a slot; masked: float32.min
        const float y = CAP ? tanh_approx(x * scale_cap) * cap2 : x * scale2;
        sl[h][g] = !in_row ? -INFINITY : (vis ? y : -FLT_MAX);
      }
    }

    // online softmax over the warp's slots (a lane keeps its own slots' l)
    float e[HG][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = sl[0][g];
#pragma unroll
      for (int h = 1; h < HG; ++h) mx = fmaxf(mx, sl[h][g]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
      const float mn = fmaxf(m[g], mx);
      if (mn == -INFINITY) {  // the warp's slots all lie past S
#pragma unroll
        for (int h = 0; h < HG; ++h) e[h][g] = 0.f;
        continue;
      }
      const float alpha = exp2f(m[g] - mn);  // 0 while m = -inf
      float esum = 0.f;
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        e[h][g] = exp2f(sl[h][g] - mn);
        esum += e[h][g];
      }
      l[g] = fmaf(l[g], alpha, esum);
#pragma unroll
      for (int x = 0; x < VCH; ++x) acc[g][x] *= alpha;
      m[g] = mn;
    }

    // P.V: this lane owns channels [VCH lane, VCH lane + VCH)
#pragma unroll
    for (int h = 0; h < HG; ++h) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = warp * HG * 4 + h * 4 + jj;
        if (r0 + r >= s1) continue;  // the same for the whole warp
        float vf[VCH];
        if constexpr (VCH == 1)
          vf[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              vs + r * ROW_BYTES + lane * 2));
        const uint2* vw = reinterpret_cast<const uint2*>(vs + r * ROW_BYTES + lane * VCH * 2);
#pragma unroll
        for (int x = 0; x < VCH / 4; ++x) {
          const uint2 w = vw[x];
          const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
          const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
          vf[4 * x] = v01.x;
          vf[4 * x + 1] = v01.y;
          vf[4 * x + 2] = v23.x;
          vf[4 * x + 3] = v23.y;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(FULL, e[h][g], jj * 8);
#pragma unroll
          for (int x = 0; x < VCH; ++x) acc[g][x] = fmaf(pj, vf[x], acc[g][x]);
        }
      }
    }
  }
  __syncthreads();  // the ring is free: it holds the warps' states now

  float* wm = reinterpret_cast<float*>(smem);       // [NWARPS][G]
  float* wl = wm + NWARPS * G;                      // [NWARPS][G]
  float* wacc = wm + 2 * NWARPS * 8;                // [NWARPS][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lw = l[g];  // the 4 slot groups' sums
    lw += __shfl_xor_sync(FULL, lw, 8);
    lw += __shfl_xor_sync(FULL, lw, 16);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = lw;
    }
    if constexpr (VCH == 1) {
      wacc[(warp * G + g) * D + lane] = acc[g][0];
    } else {
#pragma unroll
      for (int x = 0; x < VCH; x += 4)
        *reinterpret_cast<float4*>(&wacc[(warp * G + g) * D + lane * VCH + x]) =
            make_float4(acc[g][x], acc[g][x + 1], acc[g][x + 2], acc[g][x + 3]);
    }
  }
  __syncthreads();

  const size_t row = ((size_t)bk * nsplit + sp) * G;
  float* part = wacc + NWARPS * G * D;  // cluster: the split's acc [G][D],
  float* pm = part + G * D;             // m [G] and l [G]
  float* pl = pm + G;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      // a warp with no slot (m = -inf) adds nothing; one with only masked
      // slots (m = float32.min) adds nothing beside a visible slot
      const float f = wm[w * G + g] == -INFINITY ? 0.f : exp2f(wm[w * G + g] - mx);
      lt = fmaf(wl[w * G + g], f, lt);
      o = fmaf(wacc[(w * G + g) * D + d], f, o);
    }
    if (nsplit == 1) {
      out[((size_t)bk * G + g) * D + d] = __float2bfloat16(o / lt);
    } else if (cluster) {
      part[i] = o;
      if (d == 0) {
        pm[g] = mx;
        pl[g] = lt;
      }
    } else {
      ws_acc[row * D + i] = o;
      if (d == 0) {
        ws_m[row + g] = mx;
        ws_l[row + g] = lt;
      }
    }
  }
  if (!cluster) return;

  // the cluster's merge: block 0 reads each split's partial from that
  // block's shared memory, in split order; every block stays until it has
  // been read
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  if (cl.block_rank() == 0) {
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      float mx = -INFINITY;
      for (int r = 0; r < nsplit; ++r) mx = fmaxf(mx, cl.map_shared_rank(pm, r)[g]);
      float lt = 0.f, o = 0.f;
      for (int r = 0; r < nsplit; ++r) {
        const float mr = cl.map_shared_rank(pm, r)[g];
        const float f = mr == -INFINITY ? 0.f : exp2f(mr - mx);
        lt = fmaf(cl.map_shared_rank(pl, r)[g], f, lt);
        o = fmaf(cl.map_shared_rank(part, r)[i], f, o);
      }
      out[(size_t)bk * G * D + i] = __float2bfloat16(o / lt);
    }
  }
  cl.sync();
}

// Combine the nsplit partials of (bk, g): block (bk, g), 4 warps, a lane
// D / 32 channels; warp w sums splits w, w + 4, ... in order (8 loads in
// flight), then the warps' sums add in warp order: the same order on every
// call.
template <int G, int D>
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_m,
             const float* __restrict__ ws_l, int nsplit,
             __nv_bfloat16* __restrict__ out) {
  constexpr int VCH = D / 32;
  __shared__ float red[4];
  __shared__ __align__(16) float wacc[4][D];
  __shared__ float wl[4];
  const int bk = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)bk * nsplit;
  float mx = -INFINITY;
  for (int s = tid; s < nsplit; s += 128) mx = fmaxf(mx, ws_m[(base + s) * G + g]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  float lt = 0.f;
  if constexpr (VCH == 1) {  // D = 32: a lane one channel
    float o1 = 0.f;
#pragma unroll 8
    for (int s = warp; s < nsplit; s += 4) {
      const size_t row = (base + s) * G + g;
      const float m = ws_m[row];
      const float f = m == -INFINITY ? 0.f : exp2f(m - mx);
      lt = fmaf(ws_l[row], f, lt);
      o1 = fmaf(ws_acc[row * D + lane], f, o1);
    }
    wacc[warp][lane] = o1;
  } else {
  float4 o[VCH / 4];
#pragma unroll
  for (int x = 0; x < VCH / 4; ++x) o[x] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = warp; s < nsplit; s += 4) {
    const size_t row = (base + s) * G + g;
    const float m = ws_m[row];
    const float f = m == -INFINITY ? 0.f : exp2f(m - mx);
    lt = fmaf(ws_l[row], f, lt);
#pragma unroll
    for (int x = 0; x < VCH / 4; ++x) {
      const float4 a = *reinterpret_cast<const float4*>(&ws_acc[row * D + lane * VCH + 4 * x]);
      o[x].x = fmaf(a.x, f, o[x].x);
      o[x].y = fmaf(a.y, f, o[x].y);
      o[x].z = fmaf(a.z, f, o[x].z);
      o[x].w = fmaf(a.w, f, o[x].w);
    }
  }
#pragma unroll
  for (int x = 0; x < VCH / 4; ++x)
    *reinterpret_cast<float4*>(&wacc[warp][lane * VCH + 4 * x]) = o[x];
  }
  if (lane == 0) wl[warp] = lt;
  __syncthreads();
  const float l = ((wl[0] + wl[1]) + wl[2]) + wl[3];
#pragma unroll
  for (int d = tid; d < D; d += 128) {
    const float od = ((wacc[0][d] + wacc[1][d]) + wacc[2][d]) + wacc[3][d];
    out[((size_t)bk * G + g) * D + d] = __float2bfloat16(od / l);
  }
}

template <int G, int D, bool CAP>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* ws_acc, void* ws_m, void* ws_l, int BHk, int S,
           int nsplit, int rows, float scale, float cap,
           cudaStream_t stream) {
  static bool smem_set = false;  // once a process, per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<G, D, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(STAGES, G, D));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int ns = min(STAGES, (rows + TILE - 1) / TILE);  // no deeper than a split
  // up to max_cluster(D) splits merge in a cluster, more in merge_kernel
  const int cluster = nsplit > 1 && nsplit <= max_cluster(D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BHk, nsplit);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(ns, G, D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster ? nsplit : 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, split_kernel<G, D, CAP>, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const uint8_t*)mask,
      (__nv_bfloat16*)out, (float*)ws_acc, (float*)ws_m, (float*)ws_l, S,
      rows, scale * LOG2E, CAP ? scale / cap : 0.f, cap * LOG2E, ns,
      cluster);
  if (le != cudaSuccess) return (int)le;
  const int err = (int)cudaGetLastError();
  if (err != 0 || nsplit == 1 || cluster) return err;
  merge_kernel<G, D><<<dim3(BHk, G), 128, 0, stream>>>(
      (const float*)ws_acc, (const float*)ws_m, (const float*)ws_l, nsplit,
      (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

// The instantiation for the group and head dim: D = 128 at G in {1, 2, 4,
// 7, 8}, D = 256 (Gemma-2) and D = 32 (the trained tiny retrieval
// checkpoint) at G in {1, 2}; each with and without the cap.
template <int G, int D>
int launch_cap(const void* q, const void* k, const void* v, const void* mask,
               void* out, void* ws_acc, void* ws_m, void* ws_l, int BHk,
               int S, int nsplit, int rows, float scale, float cap,
               cudaStream_t st) {
  return cap > 0.f
             ? launch<G, D, true>(q, k, v, mask, out, ws_acc, ws_m, ws_l, BHk,
                                  S, nsplit, rows, scale, cap, st)
             : launch<G, D, false>(q, k, v, mask, out, ws_acc, ws_m, ws_l,
                                   BHk, S, nsplit, rows, scale, cap, st);
}

}  // namespace

// q [B, H, D], k/v [B, Hk, S, D] bf16, mask [B, Hk, S] bool, out [B, H, D]
// bf16; ws_acc [B*Hk*nsplit, G, D], ws_m/ws_l [B*Hk*nsplit, G] f32
// (unused when nsplit = 1); rows: slots a split, a multiple of 64, at most
// max_slots(D), with (nsplit - 1) * rows < S <= nsplit * rows; scale: the softmax
// scale; softcap: the logit cap, 0 for none.  Returns a CUDA error code;
// cudaErrorInvalidValue for an unsupported D, G or plan.
extern "C" int pkv_decode_attn(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* ws_acc,
                               void* ws_m, void* ws_l, int B, int H, int Hk,
                               int D, int S, int nsplit, int rows,
                               float scale, float softcap, void* stream) {
  if (rows % TILE || rows > max_slots(D) || nsplit < 1 ||
      (long long)(nsplit - 1) * rows >= S || (long long)nsplit * rows < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int BHk = B * Hk;
#define PKV_DECODE_ARGS \
  q, k, v, mask, out, ws_acc, ws_m, ws_l, BHk, S, nsplit, rows, scale, \
      softcap, st
  if (D == 256) {
    switch (H / Hk) {
      case 1: return launch_cap<1, 256>(PKV_DECODE_ARGS);
      case 2: return launch_cap<2, 256>(PKV_DECODE_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D == 32) {
    switch (H / Hk) {
      case 1: return launch_cap<1, 32>(PKV_DECODE_ARGS);
      case 2: return launch_cap<2, 32>(PKV_DECODE_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D != 128) return (int)cudaErrorInvalidValue;
  switch (H / Hk) {
    case 1: return launch_cap<1, 128>(PKV_DECODE_ARGS);
    case 2: return launch_cap<2, 128>(PKV_DECODE_ARGS);
    case 4: return launch_cap<4, 128>(PKV_DECODE_ARGS);
    case 7: return launch_cap<7, 128>(PKV_DECODE_ARGS);
    case 8: return launch_cap<8, 128>(PKV_DECODE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PKV_DECODE_ARGS
}

// Blocks of split_kernel<G, D> an SM holds with a full ring (the occupancy
// the wrapper's split plan assumes, kernels/decode_attn.py::blocks_per_sm),
// or a negative CUDA error code; 0 for an unsupported (G, D).
extern "C" int pkv_decode_occupancy(int G, int D) {
  int n = 0;
  cudaError_t e = cudaSuccess;
  auto occ = [&](auto kern, int smem) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, NT, smem);
  };
  switch (D * 16 + G) {
    case 128 * 16 + 1: occ(split_kernel<1, 128, false>, smem_bytes(STAGES, 1, 128)); break;
    case 128 * 16 + 2: occ(split_kernel<2, 128, false>, smem_bytes(STAGES, 2, 128)); break;
    case 128 * 16 + 4: occ(split_kernel<4, 128, false>, smem_bytes(STAGES, 4, 128)); break;
    case 128 * 16 + 7: occ(split_kernel<7, 128, false>, smem_bytes(STAGES, 7, 128)); break;
    case 128 * 16 + 8: occ(split_kernel<8, 128, false>, smem_bytes(STAGES, 8, 128)); break;
    case 256 * 16 + 1: occ(split_kernel<1, 256, false>, smem_bytes(STAGES, 1, 256)); break;
    case 256 * 16 + 2: occ(split_kernel<2, 256, false>, smem_bytes(STAGES, 2, 256)); break;
    case 32 * 16 + 1: occ(split_kernel<1, 32, false>, smem_bytes(STAGES, 1, 32)); break;
    case 32 * 16 + 2: occ(split_kernel<2, 32, false>, smem_bytes(STAGES, 2, 32)); break;
    default: return 0;
  }
  return e == cudaSuccess ? n : -(int)e;
}
