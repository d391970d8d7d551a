"""Build a CUDA source of csrc/ into a shared library and load it.

`nvcc` compiles each source by hand into a `.so` with a plain C interface
(no PyTorch headers, no ninja), which ctypes then loads. The library's name
carries a hash of the source and the flags, so an unchanged source is built
once per checkout; builds land in humanoid_tpu_torch/_build/ (git-ignored).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: str
    seconds: float          # nvcc wall time; 0.0 when the library was already built
    ptxas: tuple            # nvcc's report, -Xptxas -v included (registers, stack, spills)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return nvcc


def build(source: str) -> BuiltLibrary:
    """Compile csrc/<source> (if not built yet) and load it."""
    src_path = os.path.join(CSRC_DIR, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    seconds, ptxas = 0.0, ()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = (proc.stdout + proc.stderr).splitlines()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):\n" + "\n".join(log))
        os.replace(tmp, out)
        ptxas = tuple(line.strip() for line in log if line.strip())
    return BuiltLibrary(lib=ctypes.CDLL(out), path=out, seconds=seconds, ptxas=ptxas)
