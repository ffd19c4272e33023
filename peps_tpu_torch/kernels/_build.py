"""Build and load the port's hand-written CUDA kernels.

The sources under ``peps_tpu_torch/csrc/*.cu`` (and the headers they
include, ``complex_ops.cuh`` and ``complex_tiles.cuh``) have a plain C
interface.
``nvcc`` compiles them for Hopper (``sm_90a``), one process per source, all
started together, and links them into one shared library, on first use,
under ``build/peps_tpu_torch/`` at the root of the checkout; ``ctypes``
loads it. The library's file name carries a hash of the sources and
headers, so an edited file is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "peps_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuiltLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float   # compile time; 0.0 when an up-to-date library was found
    log: str         # nvcc / ptxas output of the build ("" when cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of peps_tpu_torch "
                       "are built on first use and need the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    for name in ("col_transfer_f32", "col_transfer_f64", "col_transfer_c64",
                 "col_transfer_c128"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    for name in ("pair_transfer_f32", "pair_transfer_f64",
                 "pair_transfer_c64", "pair_transfer_c128"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.col_transfer_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int64, ptr]
    lib.col_transfer_attributes.restype = ctypes.c_int
    lib.pair_transfer_attributes.argtypes = [ctypes.c_int, ctypes.c_int64,
                                             ptr]
    lib.pair_transfer_attributes.restype = ctypes.c_int
    lib.pair_transfer_cx_attributes.argtypes = [ctypes.c_int, ctypes.c_int64,
                                                ptr]
    lib.pair_transfer_cx_attributes.restype = ctypes.c_int
    lib.pair_transfer_zmma_tile.argtypes = [ptr, ptr, ptr, ptr]
    lib.pair_transfer_zmma_tile.restype = ctypes.c_int
    for name in ("centered_o_f32", "centered_o_f64", "centered_o_c64",
                 "centered_o_c128"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    for name in ("fermion_dress_f32", "fermion_dress_f64",
                 "fermion_dress_c64", "fermion_dress_c128"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    for name in ("bmps_overlap_f32", "bmps_overlap_f64", "bmps_overlap_c64",
                 "bmps_overlap_c128"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    for name in ("col_transfer_backward_f32", "col_transfer_backward_f64",
                 "col_transfer_backward_c64", "col_transfer_backward_c128"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 12
        fn.restype = ctypes.c_int
    lib.col_transfer_backward_attributes.argtypes = [ctypes.c_int, ptr]
    lib.col_transfer_backward_attributes.restype = ctypes.c_int
    lib.peps_cuda_error_string.argtypes = [ctypes.c_int]
    lib.peps_cuda_error_string.restype = ctypes.c_char_p


@functools.cache
def cuda_library() -> BuiltLibrary:
    """Compile (if needed) and load the kernel library. Raises when nvcc is
    missing or the build fails; never falls back."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha1()
    for src in sorted(CSRC.glob("*.cu*")):     # the sources and headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libpeps_kernels_{digest.hexdigest()[:12]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:12]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        failed = [src.name for src, proc in zip(sources, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink()
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return BuiltLibrary(lib, path, seconds, log)


def check(code: int) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if code != 0:
        msg = cuda_library().lib.peps_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({code})")
