"""The port's native (C++) components against the reference package's:
the terrain synthesizer (native/terrain_native.py + terrain.cpp), which
builds the heightfield and trimesh worlds of the port's registry, and the
deployment policy runtime (native/policy_native.py + policy_runtime.cpp).

The reference's libraries are built by its own build code into a directory
of this test's (its `_DIR` patched to a copy of its sources), so that no two
test processes write the same library. Stated tolerances: the worlds equal
the reference's in bits (heights and origins); on the deterministic columns
(flat, slopes, stairs) they equal the port's numpy generator in bits; the
native policy equals the reference's in bits and the port's NpzPolicy
within the reference's 1e-5, on the port's export of a seeded actor.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import humanoid_tpu.native.build as jbuild
from humanoid_tpu.native import policy_native as jpolicy_native
from humanoid_tpu.native import terrain_native as jterrain_native
from humanoid_tpu_torch.algo.networks import ActorCritic
from humanoid_tpu_torch.config.structs import TerrainCfg
from humanoid_tpu_torch.deploy import export
from humanoid_tpu_torch.deploy.npz_policy import NpzPolicy
from humanoid_tpu_torch.env import terrain
from humanoid_tpu_torch.native import build, policy_native, terrain_native
from humanoid_tpu_torch.utils import registry

TOL = 1e-5


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's terrain and policy modules, their libraries built
    by the reference's load_library into a private directory."""
    src = tmp_path_factory.mktemp("ref_native")
    for name in ("terrain.cpp", "policy_runtime.cpp"):
        shutil.copy(os.path.join(os.path.dirname(jbuild.__file__), name), src / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbuild, "_DIR", str(src))
        mp.setattr(jbuild, "_CACHE", {})
        mp.setenv("HUMANOID_TPU_NATIVE_TERRAIN", "1")
        assert jterrain_native.native_available() and jpolicy_native.native_policy_available()
        yield jterrain_native, jpolicy_native


SMALL = dict(mesh_type="heightfield", num_rows=4, num_cols=7, border_size=5.0)


def deterministic_columns(cfg):
    """The columns of the humanoid generator set's curriculum whose cells
    draw no random numbers: flat (slot 0), slopes and stairs (slots 3-6);
    discrete (1), rough (2) and uneven (7) are random."""
    assert cfg.generator_set == "humanoid"
    props = np.cumsum(cfg.terrain_proportions)
    end = props[6] if len(props) > 7 else np.inf
    choices = [j / cfg.num_cols + 0.001 for j in range(cfg.num_cols)]
    return [j for j, c in enumerate(choices) if c < props[0] or props[2] <= c < end]


@pytest.mark.parametrize("which", ["small", "humanoid_ppo_terrain", "humanoid_ppo_trimesh"])
def test_world_equals_the_reference_in_bits(ref_native, which):
    cfg = (TerrainCfg(**SMALL) if which == "small" else registry.get_cfgs(which)[0].terrain)
    got = terrain_native.build_terrain_native(cfg, seed=3)
    want = ref_native[0].build_terrain_native(cfg, seed=3)
    assert got.height.dtype == want.height.dtype == np.float64
    assert got.height.tobytes() == want.height.tobytes()
    assert got.env_origins.tobytes() == want.env_origins.tobytes()
    assert (got.horizontal_scale, got.border, got.num_rows, got.num_cols, got.terrain_length) == \
        (want.horizontal_scale, want.border, want.num_rows, want.num_cols, want.terrain_length)


@pytest.mark.parametrize("which", ["small", "humanoid_ppo_terrain"])
def test_deterministic_columns_equal_the_numpy_generator(which):
    cfg = (TerrainCfg(**SMALL) if which == "small" else registry.get_cfgs(which)[0].terrain)
    native = terrain_native.build_terrain_native(cfg, seed=3)
    plain = terrain.build_terrain(cfg, seed=3)
    assert native.height.shape == plain.height.shape
    np.testing.assert_array_equal(native.env_origins[..., :2], plain.env_origins[..., :2])
    size = int(cfg.terrain_length / cfg.horizontal_scale)
    b = int(cfg.border_size / cfg.horizontal_scale)
    cols = deterministic_columns(cfg)
    assert cols
    for j in cols:
        cells = np.s_[b:b + cfg.num_rows * size, b + j * size:b + (j + 1) * size]
        assert native.height[cells].tobytes() == plain.height[cells].tobytes(), j
    assert not np.array_equal(native.height, plain.height)   # the random cells differ


def test_primitives_equal_the_numpy_generator():
    n, hs, vs = 80, 0.1, 0.005
    for slope in (0.12, -0.09):
        t = terrain.SubTerrain(n, hs, vs)
        terrain.pyramid_sloped_terrain(t, slope, platform_size=0.1)
        np.testing.assert_array_equal(terrain_native.pyramid_slope_native(n, hs, vs, slope, 0.1),
                                      t.height_field_raw)
    for step in (0.03, -0.02):
        t = terrain.SubTerrain(n, hs, vs)
        terrain.pyramid_stairs_terrain(t, 0.4, step, platform_size=1.0)
        np.testing.assert_array_equal(
            terrain_native.pyramid_stairs_native(n, hs, vs, 0.4, step, 1.0), t.height_field_raw)


def test_registry_trains_on_the_native_world():
    env_cfg, _ = registry.get_cfgs("humanoid_ppo_terrain")
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=2))
    env = registry.build_env(env_cfg, registry.default_urdf(), "cpu")
    want = terrain_native.build_terrain_native(env_cfg.terrain, seed=env_cfg.seed)
    assert env.terrain_world.height.tobytes() == want.height.tobytes()
    assert env.terrain_world.env_origins.tobytes() == want.env_origins.tobytes()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No numpy fallback and no switch: without g++ the world is not built."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_CACHE", {})
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        terrain_native.build_terrain_native(TerrainCfg(**SMALL), seed=0)
    with pytest.raises(RuntimeError, match="no-such-g"):
        policy_native.NativePolicy(str(tmp_path / "p.npz"))
    monkeypatch.setattr(build, "CXX", "g++")
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "SRC_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build("bad")
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path))


def test_build_is_cached_by_source(tmp_path):
    first = build.build("policy_runtime", build_dir=str(tmp_path))
    again = build.build("policy_runtime", build_dir=str(tmp_path))
    assert first.seconds > 0 and again.seconds == 0.0 and again.path == first.path
    assert os.path.basename(first.path).startswith("policy_runtime_")


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The port's export of an actor drawn from a numpy seed."""
    net = ActorCritic(705, 219, 12)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.as_tensor(rng.normal(0.0, 0.1, tuple(p.shape)), dtype=torch.float32))
    return export.export_policy_npz(net, str(tmp_path_factory.mktemp("x") / "policy.npz"),
                                    meta={"iteration": 7})


@pytest.mark.parametrize("prefix", ["actor", "vel"])
def test_native_policy_equals_the_reference_and_npz_policy(ref_native, npz, prefix):
    obs = np.random.default_rng(1).normal(size=(9, 705)).astype(np.float32)
    got = policy_native.NativePolicy(npz, prefix)
    want = ref_native[1].NativePolicy(npz, prefix)
    assert (got.in_dim, got.out_dim) == (want.in_dim, want.out_dim) == \
        (705, 12 if prefix == "actor" else 3)
    assert got(obs).tobytes() == want(obs).tobytes()
    np.testing.assert_allclose(got(obs), NpzPolicy(npz, prefix)(obs), rtol=TOL, atol=TOL)
    single = got(obs[0])
    assert single.shape == (got.out_dim,) and single.tobytes() == got(obs[:1])[0].tobytes()
    with pytest.raises(ValueError, match="takes"):
        got(obs[:, :10])


def test_native_policy_rejects_a_missing_head(npz):
    with pytest.raises(ValueError, match="critic"):
        policy_native.NativePolicy(npz, "critic")


def test_sim2sim_native_replays_through_the_runtime(npz, monkeypatch):
    """sim2sim --native: the replay's actions come from NativePolicy."""
    from humanoid_tpu_torch.deploy import sim2sim

    calls = []
    forward = policy_native.NativePolicy.__call__

    def counted(self, obs):
        calls.append(obs.shape)
        return forward(self, obs)

    monkeypatch.setattr(policy_native.NativePolicy, "__call__", counted)
    got = sim2sim.main(["--load-model", npz, "--task", "humanoid_ppo", "--duration", "0.2",
                        "--native"])
    assert calls and calls[0] == (1, 705) and np.isfinite(list(got.values())).all()
