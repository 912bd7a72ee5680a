"""Build and load the package's CUDA kernels.

The sources under `comet_tpu_torch/csrc/` are compiled with nvcc into one
shared library with a plain C interface, loaded with ctypes. The build runs
at first use, into `build/kernels/` beside the package: one nvcc process
per `.cu` file, all started together, then one link. It is keyed by a hash
of the flags, the `.cu` sources and the `.cuh` headers they include, so a
changed source or header rebuilds and an unchanged tree loads the library
already built. Nothing is downloaded; a missing nvcc or a failed build
raises.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

# sm_90a keeps the Hopper-only instructions available; no --use_fast_math,
# which would change sqrtf, divisions and denormal handling.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
SIGNATURES = {
    # vals, idx, in_row, in_col, kin, rows, width, chunk, k, kout,
    # vout, iout, out_row, out_col, stream
    "comet_topk_pass": [_P, _P, _LL, _LL, _P, _I, _I, _I, _I, _P,
                        _P, _P, _LL, _LL, _P],
    # vals, idx, in_row, in_col, rows, width, n_pad, k, keys,
    # vout, iout, out_row, out_col, stream
    "comet_topk_rows_global": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P,
                               _P, _P, _LL, _LL, _P],
    # q, qn, x, mask, thr, Q, N, d, cosine, assign, words, n_words,
    # dist, gmin, stream
    "comet_fused_scan": [_P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _I,
                         _P, _P, _I, _P, _P, _P],
    # q, qn, x, mask, probes, P, chunk_ids, cluster_ids, thr, G, S, d,
    # cosine, dist, gmin, stream
    "comet_sparse_scan": [_P, _P, _P, _P, _P, _I, _P, _P, ctypes.c_float,
                          _I, _I, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Filled by the first build or load: nvcc path, library path, seconds spent,
# whether it was compiled in this process, and the compiler's output.
build_info: dict = {}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's usual place."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _source_hash(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build() -> ctypes.CDLL:
    t0 = time.perf_counter()
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib_path = os.path.join(BUILD_DIR, f"comet_kernels_{_source_hash(srcs + headers())}.so")
    compiled = False
    log = ""
    nvcc = None
    if not os.path.exists(lib_path):
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)
        ]
        outs = [(p, p.communicate()[0]) for p in procs]
        link = None
        if all(p.returncode == 0 for p, _ in outs):
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            outs.append((link, link.stdout + link.stderr))
        log = "".join(out for _, out in outs)
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        failed = [p.returncode for p, _ in outs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n{log}")
        os.replace(tmp, lib_path)
        with open(lib_path + ".log", "w") as f:
            f.write(log)
        compiled = True
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(
        nvcc=nvcc, library=lib_path, compiled=compiled,
        seconds=time.perf_counter() - t0, log=log,
    )
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def check(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {code}")
