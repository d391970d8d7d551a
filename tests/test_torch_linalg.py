"""The batched Cholesky factor, apply and solve (ops/linalg.py,
csrc/linalg.cu) against the reference's.

The same random SPD matrices (numpy, seeded: A A^T + n I scaled to
condition numbers up to ~1e5, and CRBA mass matrices of the stand-in robot)
go through the reference's unrolled XLA versions, the reference's Pallas
kernel bodies (ops/linalg.py's _chol_*_kernel, wrapped here in
pl.pallas_call(..., interpret=True) as factor_spd_pallas wraps them), the
port's plain versions and csrc/linalg.cu compiled for the host.
Tolerances, relative to the largest entry of the result: 1e-4 for the
factor; for a solution, tol(cond) = max(1e-5, 2e-8 cond), since float32
round-off (6e-8) is amplified by up to the condition number (at 1e5 the
reference's kernel itself is 3.3e-4 off the float64 solution).
"""
import ctypes
import functools
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from humanoid_tpu.ops import linalg as jlinalg
from humanoid_tpu_torch.ops import linalg as tlinalg

CSRC = os.path.join(os.path.dirname(__file__), "..", "humanoid_tpu_torch", "csrc", "linalg.cu")
N = 16


def tol(cond):
    return max(1e-5, 2e-8 * cond)


def spd(n, seed, cond=1e3, count=N):
    """Random SPD matrices (count, n, n) with condition number ~cond."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(count, n, n)))
    eig = np.exp(rng.uniform(0.0, np.log(cond), (count, n)))
    eig[:, 0], eig[:, -1] = 1.0, cond
    return (Q * eig[:, None, :] @ np.swapaxes(Q, 1, 2)).astype(np.float32)


def rhs(n, seed, count=N):
    return np.random.default_rng(seed + 100).normal(size=(count, n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _interpreted(kernel, n, outs, shapes):
    count = shapes[0][1]
    return jax.jit(pl.pallas_call(
        functools.partial(kernel, n=n), grid=(1,),
        in_specs=[pl.BlockSpec(s, lambda g: (0, 0)) for s in shapes],
        out_specs=pl.BlockSpec((outs, count), lambda g: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((outs, count), jnp.float32), interpret=True))


def _pallas(kernel, n, outs, *ins):
    """A reference kernel body in interpret mode, env axis on the lanes."""
    count = ins[0].shape[0]
    flat = [np.ascontiguousarray(x.reshape(count, -1).T) for x in ins]
    fn = _interpreted(kernel, n, outs, tuple(x.shape for x in flat))
    return np.asarray(fn(*(jnp.asarray(x) for x in flat))).T


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("n,cond", [(18, 1e2), (18, 1e5), (24, 1e3), (6, 10.0)])
def test_plain_versions_match_reference_unrolled(n, cond):
    M, b = spd(n, n, cond), rhs(n, n)
    L = tlinalg.chol_factor_unrolled(_t(M)).numpy()
    np.testing.assert_allclose(L, np.asarray(jlinalg.chol_factor_unrolled(M)), rtol=0,
                               atol=1e-4 * np.abs(L).max())
    assert np.all(np.triu(L, 1) == 0.0)
    x_ref = np.asarray(jlinalg.chol_apply_unrolled(jnp.asarray(L), b))
    x = tlinalg.chol_apply_unrolled(_t(L), _t(b)).numpy()
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=tol(cond) * np.abs(x_ref).max())
    xs = tlinalg.chol_solve_unrolled(_t(M), _t(b)).numpy()
    xs_ref = np.asarray(jlinalg.chol_solve_unrolled(M, b))
    np.testing.assert_allclose(xs, xs_ref, rtol=0, atol=tol(cond) * np.abs(xs_ref).max())


@pytest.mark.parametrize("cond", [1e2, 1e5])
def test_plain_versions_match_reference_kernels_in_interpret_mode(cond):
    n = 18
    M, b = spd(n, 3, cond), rhs(n, 3)
    k = tlinalg.CholeskyKernels()
    Lk = _pallas(jlinalg._chol_factor_kernel, n, n * n, M).reshape(N, n, n)
    L = k.factor_spd_batch(_t(M)).numpy()
    np.testing.assert_allclose(L, Lk, rtol=0, atol=1e-4 * np.abs(Lk).max())
    xa = _pallas(jlinalg._chol_apply_kernel, n, n, Lk, b)
    x = k.apply_spd_batch(_t(Lk), _t(b)).numpy()
    np.testing.assert_allclose(x, xa, rtol=0, atol=tol(cond) * np.abs(xa).max())
    xs = _pallas(jlinalg._chol_solve_kernel, n, n, M, b)
    x = k.solve_spd_batch(_t(M), _t(b)).numpy()
    np.testing.assert_allclose(x, xs, rtol=0, atol=tol(cond) * np.abs(xs).max())
    # and the system is solved: float64 residual against the float32 inputs
    x64 = np.linalg.solve(M.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, x64, rtol=0, atol=tol(cond) * np.abs(x64).max())


def test_not_positive_definite_gives_nan_not_an_error():
    n = 18
    M = spd(n, 5, 1e2, count=4)
    M[1, 7, 7] = -1.0                      # a negative pivot
    M[2] = 0.0                             # a zero pivot
    M[3, 4, :] = M[3, :, 4] = np.nan       # a non-finite entry
    b = rhs(n, 5, count=4)
    k = tlinalg.CholeskyKernels()
    for x in (k.factor_spd_batch(_t(M)), k.solve_spd_batch(_t(M), _t(b)),
              k.apply_spd_batch(k.factor_spd_batch(_t(M)), _t(b))):
        x = x.reshape(4, -1)
        assert bool(torch.isfinite(x[0]).all())
        assert all(bool(torch.isnan(x[i]).any()) for i in (1, 2, 3))
    # the reference gives NaN on the same envs
    ref = np.asarray(jlinalg.chol_solve_unrolled(M, b))
    assert np.isfinite(ref[0]).all() and all(np.isnan(ref[i]).any() for i in (1, 2, 3))


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    M, b = spd(18, 6), rhs(18, 6)
    k = tlinalg.CholeskyKernels()
    L = tlinalg.chol_factor_unrolled(_t(M))
    for chol in (k, tlinalg.PLAIN):
        assert torch.equal(chol.factor_spd_batch(_t(M)), L)
        assert torch.equal(chol.solve_spd_batch(_t(M), _t(b)),
                           tlinalg.chol_solve_unrolled(_t(M), _t(b)))
        assert torch.equal(chol.apply_spd_batch(L, _t(b)), tlinalg.chol_apply_unrolled(L, _t(b)))
    assert k.launches == {"chol_factor": 0, "chol_apply": 0, "chol_solve": 0}


def test_wrappers_refuse_other_devices():
    M = torch.eye(18).expand(4, 18, 18).contiguous().to("meta")
    b = torch.zeros(4, 18, device="meta")
    k = tlinalg.CholeskyKernels()
    for call in (lambda: k.factor_spd_batch(M), lambda: k.apply_spd_batch(M, b),
                 lambda: k.solve_spd_batch(M, b)):
        with pytest.raises(ValueError):
            call()
    assert k.launches == {"chol_factor": 0, "chol_apply": 0, "chol_solve": 0}


def test_bound_counts():
    # the matrix in: its lower triangle, 171 floats at n = 18; the factor
    # writes the whole 18 x 18 L
    assert tlinalg.bytes_per_env("chol_factor", 18) == 4 * (171 + 324) == 1980
    assert tlinalg.bytes_per_env("chol_apply", 18) == tlinalg.bytes_per_env("chol_solve", 18)
    assert tlinalg.bytes_per_env("chol_solve", 18) == 4 * (171 + 2 * 18) == 828
    f = tlinalg.operations_per_env("chol_factor", 18)
    assert 18 ** 3 / 3 < f < 18 ** 3 / 3 + 3 * 18 ** 2
    assert tlinalg.operations_per_env("chol_solve", 18) == f + 2 * 18 * 18


# ---------------------------------------------------------------------------
# csrc/linalg.cu compiled for the host

@pytest.fixture(scope="module")
def host_linalg(tmp_path_factory):
    """csrc/linalg.cu compiled as host C++: its per-env bodies are
    __host__ __device__, so a host compiler checks the kernels' arithmetic
    here, where there is no nvcc."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_linalg")
    src = d / "harness.cpp"
    src.write_text(
        f'#include "{os.path.abspath(CSRC)}"\n'
        "extern \"C\" void host_factor(const float* M, float* L, int N, int n) {\n"
        "  for (int e = 0; e < N; ++e) factor_env(M + e * n * n, L + e * n * n, n);\n"
        "}\n"
        "extern \"C\" void host_apply(const float* L, const float* b, float* x, int N, int n) {\n"
        "  for (int e = 0; e < N; ++e) apply_env(L + e * n * n, b + e * n, x + e * n, n);\n"
        "}\n"
        "extern \"C\" void host_solve(const float* M, const float* b, float* x, int N, int n) {\n"
        "  for (int e = 0; e < N; ++e) solve_env(M + e * n * n, b + e * n, x + e * n, n);\n"
        "}\n")
    lib = d / "liblinalg.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.host_factor.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    lib.host_apply.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.host_solve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    return lib


def _host(lib, name, *ins, out_shape):
    ins = [_t(x).contiguous() for x in ins]
    out = torch.empty(out_shape)
    n = ins[0].shape[-1]
    getattr(lib, name)(*(x.data_ptr() for x in ins), out.data_ptr(), ins[0].shape[0], n)
    return out


@pytest.mark.parametrize("n,cond", [(18, 1e2), (18, 1e5), (24, 1e3), (1, 1.0), (6, 10.0)])
def test_kernel_source_matches_plain_on_host(host_linalg, n, cond):
    M, b = spd(n, 11 + n, cond), rhs(n, 11 + n)
    L = _host(host_linalg, "host_factor", M, out_shape=(N, n, n))
    Lp = tlinalg.chol_factor_unrolled(_t(M))
    np.testing.assert_allclose(L.numpy(), Lp.numpy(), rtol=0, atol=1e-4 * float(Lp.abs().max()))
    assert bool((torch.triu(L, 1) == 0).all())
    x = _host(host_linalg, "host_apply", Lp, b, out_shape=(N, n))
    xp = tlinalg.chol_apply_unrolled(Lp, _t(b))
    np.testing.assert_allclose(x.numpy(), xp.numpy(), rtol=0,
                               atol=tol(cond) * float(xp.abs().max()))
    xs = _host(host_linalg, "host_solve", M, b, out_shape=(N, n))
    xsp = tlinalg.chol_solve_unrolled(_t(M), _t(b))
    np.testing.assert_allclose(xs.numpy(), xsp.numpy(), rtol=0,
                               atol=tol(cond) * float(xsp.abs().max()))


def _upper_nan(A):
    """A copy of the batch A with NaN above each matrix's diagonal."""
    n = A.shape[-1]
    out = np.array(A, copy=True)
    out[:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] = np.nan
    return out


@pytest.mark.parametrize("n", [6, 18, 24])
def test_kernel_source_gives_nan_on_host_for_non_spd(host_linalg, n):
    """NaN on a negative or zero pivot, and exact zeros above the diagonal
    of L all the same; the lane bodies (with one lane on the host) never
    read the upper triangle of M or of L: NaN there gives the same bits."""
    M = spd(n, 5, 1e2, count=3)
    M[1, min(7, n - 1), min(7, n - 1)] = -1.0
    M[2] = 0.0
    b = rhs(n, 5, count=3)
    x = _host(host_linalg, "host_solve", M, b, out_shape=(3, n))
    L = _host(host_linalg, "host_factor", M, out_shape=(3, n, n))
    assert bool(torch.isfinite(x[0]).all()) and bool(torch.isfinite(L[0]).all())
    assert all(bool(torch.isnan(x[i]).any()) and bool(torch.isnan(L[i]).any()) for i in (1, 2))
    assert bool((torch.triu(L, 1) == 0).all())
    assert torch.equal(_host(host_linalg, "host_solve", _upper_nan(M), b, out_shape=(3, n))[0],
                       x[0])
    assert torch.equal(_host(host_linalg, "host_factor", _upper_nan(M), out_shape=(3, n, n))[0],
                       L[0])
    xa = _host(host_linalg, "host_apply", L[:1], b[:1], out_shape=(1, n))
    assert bool(torch.isfinite(xa).all())
    assert torch.equal(_host(host_linalg, "host_apply", _upper_nan(L[:1].numpy()), b[:1],
                             out_shape=(1, n)), xa)


@pytest.fixture(scope="module")
def mass_matrices(tmp_path_factory):
    """The CRBA mass matrices (N, 18, 18) of the stand-in robot in random
    states, right-hand sides (N, 18) and their largest condition number."""
    from humanoid_tpu_torch.assets import write_xbot_topology_urdf
    from humanoid_tpu_torch.physics.dynamics import assemble_mass_matrix, compute_kinematics_bias
    from humanoid_tpu_torch.physics.kinematics import RobotTensors
    from humanoid_tpu_torch.physics.urdf import load_urdf

    urdf = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("robot")))
    rt = RobotTensors.from_model(load_urdf(urdf, armature=0.01), "cpu")
    rng = np.random.default_rng(9)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    out = compute_kinematics_bias(rt, f(rng.normal(size=(N, 3))), f(q),
                                  f(rng.uniform(-1, 1, (N, 12))), f(rng.normal(size=(N, 18))))
    M = assemble_mass_matrix(rt, out[2], out[3]).contiguous()
    cond = np.linalg.cond(M.double().numpy()).max()
    assert cond > 1e2
    return M, f(rng.normal(size=(N, 18))), cond


def test_kernel_source_on_mass_matrices(host_linalg, mass_matrices):
    """B3, B4 and B5's lane bodies on the mass matrices: the solve against
    float64 and the plain version, the factor and the apply against theirs."""
    M, b, cond = mass_matrices
    xs = _host(host_linalg, "host_solve", M, b, out_shape=(N, 18))
    x64 = np.linalg.solve(M.double().numpy(), b.double().numpy()[..., None])[..., 0]
    np.testing.assert_allclose(xs.numpy(), x64, rtol=0, atol=tol(cond) * np.abs(x64).max())
    np.testing.assert_allclose(xs.numpy(), tlinalg.chol_solve_unrolled(M, b).numpy(), rtol=0,
                               atol=tol(cond) * np.abs(x64).max())
    L = _host(host_linalg, "host_factor", M, out_shape=(N, 18, 18))
    Lp = tlinalg.chol_factor_unrolled(M)
    np.testing.assert_allclose(L.numpy(), Lp.numpy(), rtol=0, atol=1e-4 * float(Lp.abs().max()))
    assert bool((torch.triu(L, 1) == 0).all())
    x = _host(host_linalg, "host_apply", Lp, b, out_shape=(N, 18))
    xp = tlinalg.chol_apply_unrolled(Lp, b)
    np.testing.assert_allclose(x.numpy(), xp.numpy(), rtol=0,
                               atol=tol(cond) * float(xp.abs().max()))


def test_kernel_source_matches_reference_kernels_on_mass_matrices(host_linalg, mass_matrices):
    """B3's and B4's lane bodies (one lane on the host) against the
    reference's _chol_factor_kernel and _chol_apply_kernel in interpret
    mode, on the mass matrices, within the tolerances of
    test_plain_versions_match_reference_kernels_in_interpret_mode."""
    M, b, cond = mass_matrices
    n = 18
    Lk = _pallas(jlinalg._chol_factor_kernel, n, n * n, M.numpy()).reshape(N, n, n)
    L = _host(host_linalg, "host_factor", M, out_shape=(N, n, n)).numpy()
    np.testing.assert_allclose(L, Lk, rtol=0, atol=1e-4 * np.abs(Lk).max())
    assert np.all(np.triu(L, 1) == 0.0)
    xa = _pallas(jlinalg._chol_apply_kernel, n, n, Lk, b.numpy())
    x = _host(host_linalg, "host_apply", Lk, b, out_shape=(N, n)).numpy()
    np.testing.assert_allclose(x, xa, rtol=0, atol=tol(cond) * np.abs(xa).max())


def test_variant_edits_apply_to_the_kernel_source():
    """scripts/linalg_variants.py's text edits still match csrc/linalg.cu:
    each variant builds from the source with its edit in place, and only
    the envs-per-block values the source already has leave it unchanged."""
    from humanoid_tpu_torch.scripts import linalg_variants

    with open(CSRC) as f:
        src = f.read()
    out = linalg_variants.variants(src)
    assert out.pop("source") == src
    envs = {k: re.search(rf"constexpr int {k}_ENVS = (\d+);", src).group(1)
            for k in ("FACTOR", "APPLY")}
    same = {name for name, text in out.items() if text == src}
    assert same == {f"factor_envs={envs['FACTOR']}", f"apply_envs={envs['APPLY']}"}
