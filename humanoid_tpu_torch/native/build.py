"""Build a C++ source of native/ into a shared library with g++ and load it.

`g++ -O3 -shared -fPIC -std=c++17` compiles native/<name>.cpp into
humanoid_tpu_torch/_build/<name>_<hash>.so (git-ignored) through the same
helper that builds csrc/ with nvcc (ops/build.py): the hash covers the
source and the flags, so an unchanged source is built once per checkout, at
first use. A failed build raises; no caller has a fallback.
"""
from __future__ import annotations

import ctypes
import os

from ..ops.build import BUILD_DIR, BuiltLibrary, start_build

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_CACHE = {}


def build(name: str, build_dir=None) -> BuiltLibrary:
    """Compile native/<name>.cpp into `build_dir` (default BUILD_DIR) unless
    it is built there already, and load it."""
    return start_build(CXX, CXX_FLAGS, os.path.join(SRC_DIR, f"{name}.cpp"),
                       build_dir or BUILD_DIR).finish()


def load_library(name: str) -> ctypes.CDLL:
    """The library of native/<name>.cpp, built at its first use in this
    process (see `build`)."""
    if name not in _CACHE:
        _CACHE[name] = build(name).lib
    return _CACHE[name]
