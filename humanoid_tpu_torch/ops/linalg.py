"""Batched Cholesky factor, apply and solve of small SPD systems: the
wrappers of csrc/linalg.cu and their plain versions.

`factor_spd_batch` (N, n, n) -> L, `apply_spd_batch` (L, b) -> x and
`solve_spd_batch` (M, b) -> x, with M x = b, L the lower factor with its
true diagonal and zeros above it, b and x (N, n). `CholeskyKernels` holds
the wrappers: on CUDA tensors they launch the hand-written kernels of
csrc/linalg.cu, the ports of humanoid_tpu/ops/linalg.py's
_chol_factor_kernel, _chol_apply_kernel and _chol_solve_kernel, and count
them in the object's `launches`; on CPU tensors they run the plain
versions, the reference's unrolled column algorithm (chol_*_unrolled) in
PyTorch. There is no fallback from one to the other. `PLAIN` offers the
plain versions under the same names on any device. A matrix that is not
positive definite gives NaN in all of them, never an error (the env's
non-finite guard relies on it).
"""
from __future__ import annotations

import ctypes

import torch

MAX_N = 24
build_info = None
_lib = None


# ---------------------------------------------------------------------------
# plain versions: n unrolled rank-1 (outer-product) Cholesky steps

def chol_factor_unrolled(M):
    """Lower Cholesky factor of SPD M (..., n, n), true diagonal, zeros above."""
    n = M.shape[-1]
    idx = torch.arange(n, device=M.device)
    A = M
    cols = []
    for k in range(n):
        col = A[..., :, k] * torch.rsqrt(A[..., k, k])[..., None]
        col = torch.where(idx >= k, col, torch.zeros((), dtype=M.dtype, device=M.device))
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def chol_apply_unrolled(L, b):
    """x with L L^T x = b: the forward sweep by columns, then the backward
    sweep by rows."""
    n = L.shape[-1]
    y = b
    ys = []
    for k in range(n):
        yk = y[..., k] / L[..., k, k]
        ys.append(yk)
        y = y - L[..., :, k] * yk[..., None]
    acc = torch.stack(ys, dim=-1)
    x = [None] * n
    for k in reversed(range(n)):
        xk = acc[..., k] / L[..., k, k]
        x[k] = xk
        acc = acc - L[..., k, :] * xk[..., None]
    return torch.stack(x, dim=-1)


def chol_solve_unrolled(M, b):
    """x with M x = b for SPD M: the factor, then both sweeps."""
    return chol_apply_unrolled(chol_factor_unrolled(M), b)


# ---------------------------------------------------------------------------
# wrappers

def build():
    """Build (or load) the kernel library; returns the ctypes handle."""
    global _lib, build_info
    if _lib is None:
        from .build import build as nvcc_build

        info = nvcc_build("linalg.cu")
        lib = info.lib
        for name, n_ptr in (("chol_factor_launch", 2), ("chol_apply_launch", 3),
                            ("chol_solve_launch", 3)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.linalg_max_n.restype = ctypes.c_int
        for kernel in ("chol_factor", "chol_apply", "chol_solve"):
            fn = getattr(lib, f"{kernel}_envs_per_block")
            fn.restype = ctypes.c_int
            fn.argtypes = []
        if lib.linalg_max_n() != MAX_N:
            raise RuntimeError(f"linalg.cu takes n <= {lib.linalg_max_n()}, the wrapper {MAX_N}")
        build_info = info
        _lib = lib
    return _lib


def _check(name, x, shape, dev):
    if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous() \
            or tuple(x.shape) != shape:
        raise ValueError(f"{name}: need a contiguous float32 {shape} tensor on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device} "
                         f"(contiguous={x.is_contiguous()})")


def _launch(kernel: str, mat, vec=None):
    """Check the inputs and launch csrc/linalg.cu's `kernel`."""
    dev = mat.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu tensors, not {dev.type}")
    N, n = mat.shape[0], mat.shape[-1]
    if mat.dim() != 3 or not 1 <= n <= MAX_N:
        raise ValueError(f"{kernel}: need an (N, n, n) matrix with n <= {MAX_N}, got "
                         f"{tuple(mat.shape)}")
    _check("matrix", mat, (N, n, n), dev)
    if vec is not None:
        _check("rhs", vec, (N, n), dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if vec is None:
        out = torch.empty_like(mat)
        err = lib.chol_factor_launch(mat.data_ptr(), out.data_ptr(), N, n, stream)
    else:
        out = torch.empty_like(vec)
        err = getattr(lib, f"{kernel}_launch")(mat.data_ptr(), vec.data_ptr(), out.data_ptr(),
                                               N, n, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}_kernel launch failed: cudaError {err}")
    return out


class CholeskyKernels:
    """The wrappers of csrc/linalg.cu. `launches` counts this object's
    kernel launches by kernel (CUDA calls only)."""

    def __init__(self):
        self.launches = {"chol_factor": 0, "chol_apply": 0, "chol_solve": 0}

    @staticmethod
    def design(kernel: str) -> str:
        """How the built kernel spreads its work over the card."""
        envs = getattr(build(), f"{kernel}_envs_per_block")()
        return f"a warp per env, {envs} envs per block, matrices staged in shared memory"

    def _run(self, kernel, mat, vec=None):
        out = _launch(kernel, mat, vec)
        self.launches[kernel] += 1
        return out

    def factor_spd_batch(self, M):
        """Lower Cholesky factor (N, n, n) of the batch M (N, n, n)."""
        if M.device.type == "cpu":
            return chol_factor_unrolled(M)
        return self._run("chol_factor", M)

    def apply_spd_batch(self, L, b):
        """x (N, n) with L L^T x = b, for the factor L (N, n, n)."""
        if L.device.type == "cpu":
            return chol_apply_unrolled(L, b)
        return self._run("chol_apply", L, b)

    def solve_spd_batch(self, M, b):
        """x (N, n) with M x = b, for SPD M (N, n, n): factor and sweeps."""
        if M.device.type == "cpu":
            return chol_solve_unrolled(M, b)
        return self._run("chol_solve", M, b)


class PlainCholesky:
    """The plain versions under the wrappers' names, on any device."""
    factor_spd_batch = staticmethod(chol_factor_unrolled)
    apply_spd_batch = staticmethod(chol_apply_unrolled)
    solve_spd_batch = staticmethod(chol_solve_unrolled)


PLAIN = PlainCholesky()


# ---------------------------------------------------------------------------
# what one env's share of a launch must do: the bound's inputs

def operations_per_env(kernel: str, n: int) -> int:
    """fp32 operations (add, mul, div, rsqrt) per env, counted from the
    loops of csrc/linalg.cu: the factor's pivots and columns, two sweeps of
    n^2 each, and the apply's n reciprocals of the diagonal."""
    factor = sum(2 * j + 2 + (n - 1 - j) * (2 * j + 1) for j in range(n))
    sweeps = 2 * n * n
    return {"chol_factor": factor, "chol_apply": sweeps + n,
            "chol_solve": factor + sweeps}[kernel]


def bytes_per_env(kernel: str, n: int) -> int:
    """Bytes per env: every input read once, every output written once. A
    matrix input counts its lower triangle, n(n+1)/2 floats, the only part
    the kernels read; the factor writes the whole n x n L, zeros above the
    diagonal included."""
    tri = n * (n + 1) // 2
    return 4 * {"chol_factor": tri + n * n, "chol_apply": tri + 2 * n,
                "chol_solve": tri + 2 * n}[kernel]
