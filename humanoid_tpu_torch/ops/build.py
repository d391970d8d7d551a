"""Build a CUDA source of csrc/ into a shared library and load it.

`nvcc` compiles each source by hand into a `.so` with a plain C interface
(no PyTorch headers, no ninja), which ctypes then loads. The library's name
carries a hash of the source and the flags, so an unchanged source is built
once per checkout; builds land in humanoid_tpu_torch/_build/ (git-ignored).
`start_build` and `Compile.finish` (hash, temporary file, rename, load) also
build native/'s C++ sources with g++ (native/build.py).
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
    seconds: float          # compiler wall time; 0.0 when the library was already built
    log: tuple              # the compiler's output: nvcc's holds the -Xptxas -v report
                            # (registers, stack, spills), kept beside the library for a
                            # later load


@dataclasses.dataclass
class Compile:
    """One compiler run that `start_build` began into `out`; `proc` is None
    when `out` was built already."""
    src: str
    out: str
    compiler: str = ""
    proc: subprocess.Popen | None = None
    tmp: str = ""
    t0: float = 0.0

    def finish(self) -> BuiltLibrary:
        """Wait for the compiler, move its output into place and load it.
        A failed build raises with the compiler's output."""
        seconds, log = 0.0, ()
        if self.proc is not None:
            text = self.proc.communicate()[0]
            seconds = time.perf_counter() - self.t0
            if self.proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(self.compiler)} failed on {self.src} "
                                   f"(rc {self.proc.returncode}):\n" + text)
            log = tuple(line.strip() for line in text.splitlines() if line.strip())
            os.replace(self.tmp, self.out)      # another process may load the same path
        return BuiltLibrary(lib=ctypes.CDLL(self.out), path=self.out, seconds=seconds, log=log)


def start_build(compiler: str, flags, src: str, build_dir=None) -> Compile:
    """Start `compiler flags -o <tmp> src` unless `build_dir` (default
    BUILD_DIR) already holds <stem>_<hash>.so, the hash covering the source
    and the flags; the caller ends it with `finish`. A compiler that cannot
    be run raises."""
    build_dir = build_dir or BUILD_DIR
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(build_dir, f"{stem}_{digest}.so")
    if os.path.exists(out):
        return Compile(src, out)
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.Popen([compiler, *flags, "-o", tmp, src], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {compiler} to build {src}: {e}") from e
    return Compile(src, out, compiler, proc, tmp, time.perf_counter())


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


def build_all(sources) -> dict:
    """Compile every csrc/<source> not built yet, one nvcc each, all started
    together, and load them. Returns {source: BuiltLibrary}."""
    started = {source: start_build(find_nvcc(), NVCC_FLAGS, os.path.join(CSRC_DIR, source))
               for source in sources}
    built = {}
    for source, run in started.items():
        info = run.finish()
        report = f"{info.path}.ptxas"
        if info.log:
            with open(report, "w") as f:
                f.write("\n".join(info.log))
        elif os.path.exists(report):
            with open(report) as f:
                info.log = tuple(f.read().splitlines())
        built[source] = info
    return built


def build(source: str) -> BuiltLibrary:
    """Compile csrc/<source> (if not built yet) and load it."""
    return build_all([source])[source]
