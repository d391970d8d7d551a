"""ctypes binding for the C++ deployment policy runtime
(policy_runtime.cpp): evaluate an exported .npz policy with no Python-side
math, as the robot's own code would.

`NativePolicy` is call-compatible with deploy/npz_policy.NpzPolicy and
agrees with it within float32 round-off (tests/test_torch_native.py).
"""
from __future__ import annotations

import ctypes

import numpy as np

from .build import load_library


def _lib():
    lib = load_library("policy_runtime")
    if not getattr(lib, "_policy_sigs", False):
        lib.ht_policy_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.ht_policy_load.restype = ctypes.c_void_p
        lib.ht_policy_in_dim.argtypes = [ctypes.c_void_p]
        lib.ht_policy_in_dim.restype = ctypes.c_int
        lib.ht_policy_out_dim.argtypes = [ctypes.c_void_p]
        lib.ht_policy_out_dim.restype = ctypes.c_int
        lib.ht_policy_forward.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.ht_policy_forward.restype = None
        lib.ht_policy_free.argtypes = [ctypes.c_void_p]
        lib.ht_policy_free.restype = None
        lib._policy_sigs = True
    return lib


class NativePolicy:
    """ELU-MLP forward over the C ABI. One instance per exported head
    (prefix 'actor' or 'vel')."""

    def __init__(self, npz_path: str, prefix: str = "actor"):
        lib = _lib()
        self._lib = lib
        self._h = lib.ht_policy_load(npz_path.encode(), prefix.encode())
        if not self._h:
            raise ValueError(f"failed to load '{prefix}' from {npz_path}")
        self.in_dim = lib.ht_policy_in_dim(self._h)
        self.out_dim = lib.ht_policy_out_dim(self._h)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(obs, dtype=np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if x.ndim != 2 or x.shape[-1] != self.in_dim:
            raise ValueError(f"obs of shape {x.shape}: the policy takes (batch, {self.in_dim})")
        out = np.empty((x.shape[0], self.out_dim), dtype=np.float32)
        self._lib.ht_policy_forward(
            self._h,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            x.shape[0],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out[0] if squeeze else out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ht_policy_free(self._h)
            self._h = None
