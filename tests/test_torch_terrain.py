"""Terrain: the port's generator, Terrain sampling and heightfield sampler
against the reference package's.

- `env/terrain.py::build_terrain` is a copy: bit-equal heights and origins.
- `physics/contact.py::Terrain` sampling: atol 1e-6 (float32 arithmetic in
  the same order; in practice equal).
- `ops/terrain_sampler.py::sample_plain` equals the reference's Pallas
  TerrainSampler (interpret mode) exactly on scan heights, corner heights,
  tx and ty: both form count x vertical_scale in float32 from the same
  cells, and tile-local lerp parameters equal global ones because
  subtracting a tile's integer origin is exact. Against
  Terrain.sample_min3 (float64 heights rounded to float32) the bound is the
  reference test's 0.011 m.
- `csrc/terrain_sampler.cu`, compiled for the host with g++ (its per-point
  functions are __host__ __device__), equals sample_plain exactly.

The test world is the reference test's: num_rows=3, num_cols=4,
border_size=5.0, seed 7.
"""
import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import humanoid_tpu.config.structs as jcfg
import humanoid_tpu_torch.config.structs as tcfg
from humanoid_tpu.env import terrain as jterrain
from humanoid_tpu.ops.terrain_kernel import TerrainSampler as JSampler
from humanoid_tpu.physics.contact import Terrain as JTerrain
from humanoid_tpu_torch.env import terrain as tterrain
from humanoid_tpu_torch.ops.terrain_sampler import (TerrainSampler, heightfield_counts,
                                                    sample_bytes, sample_plain, touched_cells)
from humanoid_tpu_torch.physics.contact import Terrain

N = 32
CSRC = os.path.join(os.path.dirname(__file__), "..", "humanoid_tpu_torch", "csrc",
                    "terrain_sampler.cu")


def small_cfg(mod, **kw):
    return mod.TerrainCfg(mesh_type="heightfield", measure_heights=True, num_rows=3,
                          num_cols=4, border_size=5.0, **kw)


@pytest.fixture(scope="module")
def world():
    return tterrain.build_terrain(small_cfg(tcfg), seed=7)


@pytest.mark.parametrize("kw", [
    {},
    {"generator_set": "base"},
    {"generator_set": "base", "curriculum": False},
    {"curriculum": False},
    {"selected_type": "stairs"},
    {"selected_type": "discrete"},
    {"selected_type": "stepping_stones"},
    {"selected_type": "uneven"},
    "humanoid_ppo_terrain",
    "humanoid_ppo_trimesh",
], ids=lambda kw: kw if isinstance(kw, str) else "-".join(f"{k}={v}" for k, v in kw.items())
   or "humanoid")
def test_build_terrain_bit_equal(kw):
    if isinstance(kw, str):     # a registered task's full world (10 x 20 cells)
        from humanoid_tpu_torch.utils import registry

        tc = registry.get_cfgs(kw)[0].terrain
        jc = jcfg.TerrainCfg(**{f: getattr(tc, f) for f in tc.__dataclass_fields__})
        seed = 5
    else:
        tc, jc, seed = small_cfg(tcfg, **kw), small_cfg(jcfg, **kw), 7
    a = tterrain.build_terrain(tc, seed=seed)
    b = jterrain.build_terrain(jc, seed=seed)
    assert a.height.dtype == b.height.dtype and np.array_equal(a.height, b.height)
    assert np.array_equal(a.env_origins, b.env_origins)
    assert (a.num_rows, a.num_cols, a.terrain_length, a.horizontal_scale, a.border) == \
        (b.num_rows, b.num_cols, b.terrain_length, b.horizontal_scale, b.border)


def _points(world, seed, P, spread):
    """N bases inside the world, P points within +-spread of each (the
    reference test's layout)."""
    rng = np.random.default_rng(seed)
    Hm = world.height.shape[0] * world.horizontal_scale - world.border
    base = rng.uniform(2.0, min(20.0, Hm - 2.0), (N, 2)).astype(np.float32)
    pts = (base[:, None, :] + rng.uniform(-spread, spread, (N, P, 2))).astype(np.float32)
    return base, pts


@pytest.mark.parametrize("wall", [False, True])
def test_terrain_sampling_matches_reference(world, wall):
    thr = 0.75 * world.horizontal_scale if wall else 0.0
    jt = JTerrain(height=jnp.asarray(world.height, dtype=jnp.float32),
                  horizontal_scale=world.horizontal_scale, border=world.border, flat=False,
                  wall_thresh=thr)
    tt = Terrain.heightfield(world.height, world.horizontal_scale, world.border,
                             wall_thresh=thr)
    _, xy = _points(world, 11, 64, 1.5)
    # also points outside the world on every side: the clips
    xy = np.concatenate([xy, np.array([[[-9.0, -9.0], [1e3, 3.0], [3.0, 1e3], [-1e3, 1e3]]] * N,
                                      np.float32)], axis=1)
    jxy, txy = jnp.asarray(xy), torch.as_tensor(xy)
    np.testing.assert_allclose(tt.sample(txy).numpy(), np.asarray(jt.sample(jxy)), atol=1e-6)
    np.testing.assert_allclose(tt.sample_min3(txy).numpy(), np.asarray(jt.sample_min3(jxy)),
                               atol=1e-6)
    for a, b in zip(tt.sample_with_grad(txy), jt.sample_with_grad(jxy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(tt._corners(txy), jt._corners(jxy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    corners = [torch.as_tensor(np.array(c)) for c in jt._corners(jxy)]
    for a, b in zip(tt.interp_from_corners(*corners), jt.interp_from_corners(*jt._corners(jxy))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_flat_terrain_samples_zero():
    xy = torch.randn(4, 5, 2)
    t = Terrain.plane()
    for x in (t.sample(xy), t.sample_min3(xy), *t.sample_with_grad(xy)):
        assert x.shape == (4, 5) and float(x.abs().max()) == 0.0


@pytest.fixture(scope="module")
def sampled(world):
    """Scan and contact points as the env lays them out, through the
    reference's TerrainSampler (interpret mode) and the port's plain
    version."""
    base, scan = _points(world, 1, 187, 0.95)
    _, con = _points(world, 2, 9, 0.6)
    con = con - con.mean(axis=1, keepdims=True) + base[:, None, :]
    js = JSampler(world.height, 0.005, world.horizontal_scale, world.border, N, E=8,
                  interpret=True)
    j_scan, j_corners = js.sample(jnp.asarray(base), jnp.asarray(scan), jnp.asarray(con))
    raster = torch.as_tensor(heightfield_counts(world.height, 0.005))
    t_scan, t_corners = sample_plain(raster, 0.005, world.horizontal_scale, world.border,
                                     torch.as_tensor(scan), torch.as_tensor(con))
    return dict(scan=scan, con=con, raster=raster, j=(j_scan, j_corners),
                t=(t_scan, t_corners))


def test_sample_plain_equals_reference_sampler(sampled):
    """Exact: scan, the four corners, tx and ty."""
    (j_scan, j_corners), (t_scan, t_corners) = sampled["j"], sampled["t"]
    np.testing.assert_array_equal(t_scan.numpy(), np.asarray(j_scan))
    for a, b in zip(t_corners, j_corners):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_plain_scan_within_reference_bound_of_min3(world, sampled):
    jt = JTerrain(height=jnp.asarray(world.height, dtype=jnp.float32),
                  horizontal_scale=world.horizontal_scale, border=world.border, flat=False)
    ref = np.asarray(jt.sample_min3(jnp.asarray(sampled["scan"])))
    err = np.abs(sampled["t"][0].numpy() - ref)
    assert err.max() < 0.011
    # float32 rounding of the two products only: far below a count
    assert err.max() < 1e-6


def test_sampler_wrapper_takes_plain_path_on_cpu(world, sampled):
    s = TerrainSampler(world.height, 0.005, world.horizontal_scale, world.border, device="cpu")
    a_scan, a_corners = s(torch.as_tensor(sampled["scan"]), torch.as_tensor(sampled["con"]))
    assert s.launches == 0
    assert torch.equal(a_scan, sampled["t"][0])
    assert all(torch.equal(a, b) for a, b in zip(a_corners, sampled["t"][1]))
    with pytest.raises(ValueError):
        s(torch.zeros(2, 3, 2, device="meta"), torch.zeros(2, 3, 2, device="meta"))
    with pytest.raises(ValueError):
        heightfield_counts(np.full((4, 4), 200.0), 0.005)


def test_sample_bytes_counts_points_and_cells(sampled):
    raster = sampled["raster"]
    scan, con = torch.as_tensor(sampled["scan"]), torch.as_tensor(sampled["con"])
    cells = touched_cells(raster, 0.1, 5.0, scan, con)
    assert 0 < cells <= 3 * scan.shape[0] * scan.shape[1] + 4 * con.shape[0] * con.shape[1]
    assert sample_bytes(scan.shape[0] * 187, con.shape[0] * 9, cells) == \
        12 * N * 187 + 32 * N * 9 + 2 * cells


@pytest.fixture(scope="module")
def host_sampler(tmp_path_factory):
    """csrc/terrain_sampler.cu compiled as host C++."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_sampler")
    src = d / "harness.cpp"
    src.write_text(
        f'#include "{os.path.abspath(CSRC)}"\n'
        "extern \"C\" void host_sample(const int16_t* raster, int H, int W, float border,\n"
        "    float hs, float vs, float fx_max, float fy_max, const float* scan_xy,\n"
        "    long long n_scan, const float* con_xy, long long n_con, float* scan_h,\n"
        "    float* corners) {\n"
        "  const SamplerGrid g{H, W, border, hs, vs, fx_max, fy_max};\n"
        "  for (long long i = 0; i < n_scan + n_con; ++i)\n"
        "    sample_point(raster, g, i, scan_xy, n_scan, con_xy, n_con, scan_h, corners);\n"
        "}\n")
    lib = d / "libhost.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.host_sample.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                                + [ctypes.c_float] * 5
                                + [ctypes.c_void_p, ctypes.c_longlong] * 2
                                + [ctypes.c_void_p] * 2)
    return lib


@pytest.mark.parametrize("layout", ["env", "outside"])
def test_kernel_source_matches_plain_on_host(world, sampled, host_sampler, layout):
    raster = sampled["raster"].contiguous()
    scan, con = torch.as_tensor(sampled["scan"]), torch.as_tensor(sampled["con"])
    if layout == "outside":     # points beyond every edge: the clips
        rng = np.random.default_rng(3)
        scan = torch.as_tensor(rng.uniform(-30, 60, scan.shape).astype(np.float32))
        con = torch.as_tensor(rng.uniform(-30, 60, con.shape).astype(np.float32))
    H, W = raster.shape
    scan_h = torch.empty(scan.shape[:2])
    corners = torch.empty((6,) + tuple(con.shape[:2]))
    p = ctypes.c_void_p
    host_sampler.host_sample(p(raster.data_ptr()), H, W, world.border, world.horizontal_scale,
                             0.005, H - 1.001, W - 1.001, p(scan.data_ptr()),
                             scan.shape[0] * scan.shape[1], p(con.data_ptr()),
                             con.shape[0] * con.shape[1], p(scan_h.data_ptr()),
                             p(corners.data_ptr()))
    t_scan, t_corners = sample_plain(raster, 0.005, world.horizontal_scale, world.border, scan, con)
    np.testing.assert_array_equal(scan_h.numpy(), t_scan.numpy())
    for a, b in zip(corners, t_corners):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
