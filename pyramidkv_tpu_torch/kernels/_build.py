"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the ``.cuh`` headers beside it) compiles
with ``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, loaded with :mod:`ctypes`.  The build runs at first use, keyed on a hash of the sources and flags, into
``pyramidkv_tpu_torch/_build/<hash>/`` (ignored by git), so a fresh
checkout builds itself.  :func:`build_all` starts one ``nvcc`` per source,
all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: the KIVI region kernels' shared signature (PKVQ_PARAMS in
#: csrc/quant_region.cuh)
_REGION = [_P] * 14 + [_I] * 13 + [_F] * 2 + [_P] * 3 + [_I] * 2 + [_P] * 2
#: C signatures of each library's entry points: [(symbol, argtypes), ...]
ENTRY_POINTS = {
    "flash_prefill": [
        ("pkv_flash_prefill", [_P] * 5 + [_I] * 9 + [_F, _F, _P]),
        ("pkv_flash_partials", [_P] * 7 + [_I] * 8 + [_F, _F, _P]),
        ("pkv_flash_row_max", [_P] * 4 + [_I] * 9 + [_F, _F, _P]),
        ("pkv_flash_pass_b", [_P] * 6 + [_I] * 9 + [_F, _F, _P]),
    ],
    "h2o_scores": [
        ("pkv_h2o_stats", [_P] * 5 + [_I] * 6 + [_F, _F, _P]),
        ("pkv_h2o_colsum", [_P] * 6 + [_I] * 6 + [_F, _F, _P]),
    ],
    "decode_attn": [("pkv_decode_attn", [_P] * 8 + [_I] * 7 + [_F, _F, _P]),
                    ("pkv_decode_occupancy", [_I, _I])],
    "int4_matmul": [
        ("pkv_int4_mm", [_P] * 5 + [_I] * 13 + [_P]),
        ("pkv_int4_map", [_P] * 2 + [_I] * 3),
        ("pkv_int8_matmul", [_P] * 5 + [_I] * 8 + [_P]),
    ],
    "quant_decode": [("pkv_quant_decode", _REGION)],
    "quant_group_fused": [("pkv_quant_group_fused", _REGION)],
    "quant_decode_mm_bf16": [("pkv_quant_decode_mm_bf16", _REGION)],
    "quant_fused_decode": [("pkv_quant_fused_pa", _REGION)],
    "block_sparse_prefill": [
        ("pkv_slash_tiles", [_P] * 10 + [_I] * 9 + [_F, _F, _P]),
        ("pkv_vertical_partials", [_P] * 11 + [_I] * 6 + [_F, _F, _P]),
    ],
}

_loaded: dict = {}
#: nvcc's output (register / spill report) per source, from the last build
build_log: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all(names=None) -> float:
    """Compile every (or the named) kernel library not yet built, one
    ``nvcc`` process per source, in parallel.  Returns the seconds taken."""
    t0 = time.perf_counter()
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names or ENTRY_POINTS:
        lib = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (p, tmp, lib) in procs.items():
        log, _ = p.communicate()
        build_log[name] = log
        if p.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = os.path.join(_build_dir(), f"lib{name}.so")
        if not os.path.exists(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        for symbol, argtypes in ENTRY_POINTS[name]:
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
