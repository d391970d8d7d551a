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
import re
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
    ptxas: tuple            # nvcc's report, -Xptxas -v included (registers, stack, spills),
                            # kept beside the library for a later load


def ptxas_summary(lines) -> dict:
    """Each kernel's registers, stack frame, spills and static shared memory
    from nvcc's `-Xptxas -v` report, by kernel name (a template kernel's
    bool argument as <true> or <false>)."""
    out, entry, props = {}, None, None
    for line in lines:
        m = re.search(r"Compiling entry function '(_Z(\d+)(\w+))'", line)
        if m:
            k = int(m.group(2))
            name, rest = m.group(3)[:k], m.group(3)[k:]
            if rest.startswith("ILb"):
                name += "<true>" if rest.startswith("ILb1") else "<false>"
            entry = (m.group(1), name)
            out[name] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props == entry[0]:
            out[entry[1]].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry[1]].update(registers=int(m.group(1)),
                                 smem=int(smem.group(1)) if smem else 0)
            entry = None
    return out


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return nvcc


def _target(source: str):
    src_path = os.path.join(CSRC_DIR, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return src_path, os.path.join(BUILD_DIR, f"{stem}_{digest}.so")


def build_all(sources) -> dict:
    """Compile every csrc/<source> not built yet, one nvcc each, all started
    together, and load them. Returns {source: BuiltLibrary}."""
    started = {}
    for source in sources:
        src_path, out = _target(source)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started[source] = (proc, tmp, out, time.perf_counter())
    built = {}
    for source in sources:
        seconds, ptxas = 0.0, ()
        if source in started:
            proc, tmp, out, t0 = started[source]
            log = proc.communicate()[0].splitlines()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):\n"
                                   + "\n".join(log))
            ptxas = tuple(line.strip() for line in log if line.strip())
            with open(f"{out}.ptxas", "w") as f:
                f.write("\n".join(ptxas))
            os.replace(tmp, out)
        out = _target(source)[1]
        if not ptxas and os.path.exists(f"{out}.ptxas"):
            with open(f"{out}.ptxas") as f:
                ptxas = tuple(f.read().splitlines())
        built[source] = BuiltLibrary(lib=ctypes.CDLL(out), path=out, seconds=seconds,
                                     ptxas=ptxas)
    return built


def build(source: str) -> BuiltLibrary:
    """Compile csrc/<source> (if not built yet) and load it."""
    return build_all([source])[source]
