#!/usr/bin/env python3
"""Rates of the int4 kernel's inner loop on one CUDA card: the nibble decode
(prmt, lop3, a bf16x2 subtraction), mma.sync m16n8k16 and both together,
in registers, with no memory traffic; and the decode without the
subtraction followed by a second product that takes 136 times x off.

    python3 scripts/port_int4_micro.py [--log FILE]

Builds a small CUDA source of its own (the decode and product helpers as
``csrc/int4_matmul.cu`` writes them) with the package's nvcc flags and times
one launch of 132 x B blocks of W warps, each warp running N iterations of
8 tiles (one k-step of ``int4_mm_kernel``), for several B and W.  Prints per
variant the device time per k-step per SM and the code bytes per SM cycle
it would stream at 1.98 GHz (the kernel needs 12.8 for 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = r"""
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t x;
  asm volatile("prmt.b32 %0, %1, %2, %3;" : "=r"(x) : "r"(a), "r"(b), "r"(sel));
  return x;
}
__device__ __forceinline__ uint32_t nib2(uint32_t d) {
  uint32_t r;
  asm volatile("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(r) : "r"(d), "r"(0x000F000Fu), "r"(0x43084308u));
#if SUB
  const uint32_t k = 0x43084308u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&k));
  return *reinterpret_cast<uint32_t*>(&v);
#else
  return r;
#endif
}
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

extern "C" __global__ void loop(float* out, int n, uint32_t seed) {
  float acc[8][4] = {};
  uint32_t w0 = seed ^ threadIdx.x, w1 = w0 * 3u, w2 = w0 * 5u, w3 = w0 * 7u;
  const uint32_t b0 = 0x3f803f80u, b1 = 0x3f803f80u;
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t sel = 0x4400u + (uint32_t)(i & 3) * 0x1111u;
#if DECODE
      const uint32_t d01 = prmt(w0, w1, sel), d23 = prmt(w2, w3, sel);
      const uint32_t a0 = nib2(d01), a1 = nib2(d01 >> 4), a2 = nib2(d23), a3 = nib2(d23 >> 4);
#else
      const uint32_t a0 = w0 + i, a1 = w1, a2 = w2, a3 = w3;
#endif
#if MMA
      mma(acc[i], a0, a1, a2, a3, b0, b1);
#if MMA == 2
      mma(acc[i], 0xC308C308u, 0xC308C308u, 0xC308C308u, 0xC308C308u, b0, b1);
#endif
#else
      acc[i][0] += __uint_as_float((a0 ^ a1 ^ a2 ^ a3) & 0x007FFFFFu);
#endif
    }
    w0 += 0x01010101u; w1 ^= w0; w2 += w1; w3 ^= w2;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(float* out, int n, int grid, int threads, void* stream) {
  loop<<<grid, threads, 0, (cudaStream_t)stream>>>(out, n, 7u);
  return (int)cudaGetLastError();
}
"""

VARIANTS = {"decode+sub+mma": (1, 1, 1), "decode+mma (no sub)": (1, 0, 1),
            "decode (no sub)+2 mma": (1, 0, 2), "decode+sub only": (1, 1, 0),
            "mma only": (0, 0, 1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    from pyramidkv_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    src = os.path.join(tmp, "micro.cu")
    with open(src, "w") as f:
        f.write(SRC)
    out_f = open(args.log, "a") if args.log else None
    n = 2000
    for name, (dec, sub, mm) in VARIANTS.items():
        so = os.path.join(tmp, f"lib{dec}{sub}{mm}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-DDECODE={dec}",
                        f"-DSUB={sub}", f"-DMMA={mm}", "-o", so, src],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p]
        lib.run.restype = ctypes.c_int
        for blocks_per_sm, warps in ((1, 4), (1, 8), (2, 8), (2, 16), (4, 8)):
            grid, threads = sms * blocks_per_sm, 32 * warps
            out = torch.empty(grid * threads, device=dev)

            def launch():
                e = lib.run(out.data_ptr(), n, grid, threads,
                            torch.cuda.current_stream().cuda_stream)
                assert e == 0, e
            launch()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            launch()
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1)
            ksteps_per_sm = blocks_per_sm * warps * n
            ns = ms * 1e6 / ksteps_per_sm
            rec = {"variant": name, "blocks_per_sm": blocks_per_sm,
                   "warps": warps, "ns_per_kstep_per_sm": ns,
                   "bytes_per_sm_cycle": 1024 / (ns * 1.98),
                   "device": smi}
            line = json.dumps(rec)
            print(line, flush=True)
            if out_f:
                out_f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
