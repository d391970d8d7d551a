"""The control step: the port's plain version vs the reference engine, the
frozen contact prep vs the exact one, and the CUDA kernel's source vs the
plain version.

Tolerances are the reference package's own kernel-vs-XLA bounds
(tests/test_physics_kernel.py): |du| < 1e-2, |base_pos| < 1e-5, foot forces
within 1% of body weight; frozen vs exact prep: |qj|, |base_pos| < 1e-3 and
|u| < 0.1.

The state: 8 robots standing on both feet after 0.3 s of settling, then
pressed 1 mm into the ground, so that every sole corner is in contact. The
contact set is then the same in both implementations: in a merely settled
state some lightly loaded corners hover within float32 round-off of zero
gap, and whether they count as in contact then differs between any two
float32 implementations, which sends those envs' velocities apart by up to
~0.05 m/s within one control step.
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

from humanoid_tpu.physics import engine as jeng
from humanoid_tpu.physics.contact import ContactParams as JContactParams
from humanoid_tpu.physics.contact import Terrain as JTerrain
from humanoid_tpu.physics.pgs import PGSParams as JPGSParams
from humanoid_tpu.physics.urdf import load_urdf as jax_load_urdf
from humanoid_tpu_torch.assets import write_xbot_topology_urdf
from humanoid_tpu_torch.ops.physics_kernel import (ControlStepKernel, ModelTable, pack_state,
                                                   unpack_diag, unpack_state)
from humanoid_tpu_torch.physics.contact import ContactParams
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.physics.pgs import PGSParams
from humanoid_tpu_torch.physics.urdf import load_urdf

N = 8
SWEEPS = 6
KP = np.array([200, 200, 350, 350, 15, 15] * 2, np.float32)
KD = np.full(12, 10.0, np.float32)
CSRC = os.path.join(os.path.dirname(__file__), "..", "humanoid_tpu_torch", "csrc",
                    "control_step.cu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf")))
    jm = jax_load_urdf(path, armature=0.01)
    tm = load_urdf(path, armature=0.01)
    lim = (tm.dof_effort * 0.85).astype(np.float32)
    kernel = ControlStepKernel(tm, KP, KD, lim, ContactParams(), PGSParams(iterations=SWEEPS),
                               0.001)
    rng = np.random.default_rng(0)
    qj = rng.uniform(-0.05, 0.05, (N, 12)).astype(np.float32)
    masses = np.tile(tm.mass, (N, 1)).astype(np.float32)
    masses[:, 0] += rng.uniform(-5.0, 5.0, N).astype(np.float32)
    friction = rng.uniform(0.1, 2.0, N).astype(np.float32)
    phys = PhysState(torch.tensor(np.c_[np.zeros((N, 2)), np.full(N, 0.90)], dtype=torch.float32),
                     torch.tensor([[1.0, 0.0, 0.0, 0.0]] * N), torch.tensor(qj),
                     torch.zeros(N, 18))
    pack = pack_state(phys)
    args = (torch.tensor(masses), torch.tensor(friction), torch.tensor(qj))
    for _ in range(30):
        pack, diag = kernel.plain(pack, *args, 10, True, True)
    weight = tm.total_mass * 9.81
    # both feet carry the robot
    assert float(diag.foot_forces[..., 2].sum(1).min()) > 0.8 * weight
    assert float(diag.foot_forces[..., 2].min()) > 0.1 * weight
    pack = pack.clone()
    pack[2] -= 1e-3
    return dict(jm=jm, tm=tm, kernel=kernel, lim=lim, pack=pack, masses=masses,
                friction=friction, targets=qj, weight=weight)


def _jax_state(pack, nj=12):
    s = pack.T.numpy()
    return jeng.PhysState(base_pos=jnp.asarray(s[:, 0:3]), base_quat=jnp.asarray(s[:, 3:7]),
                          qj=jnp.asarray(s[:, 7:7 + nj]), u=jnp.asarray(s[:, 7 + nj:]))


def _jax_torque(setup):
    tgt = jnp.asarray(setup["targets"])
    lim = jnp.asarray(setup["lim"])

    def torque(s):
        return jnp.clip(jnp.asarray(KP) * (tgt - s.qj) - jnp.asarray(KD) * s.u[:, 6:], -lim, lim)
    return torque


def _torch_args(setup):
    return (torch.tensor(setup["masses"]), torch.tensor(setup["friction"]),
            torch.tensor(setup["targets"]))


def _assert_within_kernel_bounds(pack_a, ff_a, pack_b, ff_b, weight):
    du = float(np.abs(np.asarray(pack_a)[19:] - np.asarray(pack_b)[19:]).max())
    dpos = float(np.abs(np.asarray(pack_a)[0:3] - np.asarray(pack_b)[0:3]).max())
    dff = float(np.abs(np.asarray(ff_a) - np.asarray(ff_b)).max())
    assert du < 1e-2, du
    assert dpos < 1e-5, dpos
    assert dff < 0.01 * weight, dff / weight


def test_control_step_matches_reference_engine(setup):
    """Plain control step (frozen factor, exact prep) vs engine.control_step_pgs."""
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]))
    step = jax.jit(lambda s: jeng.control_step_pgs(
        setup["jm"], params, JTerrain.plane(), JContactParams(),
        JPGSParams(iterations=SWEEPS), s, _jax_torque(setup), 10, 0.001,
        freeze_mass_matrix=True))
    js, jd = step(_jax_state(setup["pack"]))
    tp, td = setup["kernel"].plain(setup["pack"], *_torch_args(setup), 10, True, False)
    jpack = np.concatenate([np.asarray(js.base_pos), np.asarray(js.base_quat),
                            np.asarray(js.qj), np.asarray(js.u)], axis=1).T
    _assert_within_kernel_bounds(tp, td.foot_forces, jpack, jd.foot_forces, setup["weight"])
    np.testing.assert_allclose(td.body_pos.numpy(), np.asarray(jd.body_pos), atol=1e-5)
    np.testing.assert_allclose(td.tau.numpy(), np.asarray(jd.tau), atol=1e-2)


def test_exact_substep_matches_reference_engine(setup):
    """decimation=1, freeze=False (the substep kernel's instance) vs
    engine.substep_batch_pgs."""
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]))
    torque = _jax_torque(setup)
    sub = jax.jit(lambda s: jeng.substep_batch_pgs(
        setup["jm"], params, JTerrain.plane(), JContactParams(), JPGSParams(iterations=SWEEPS),
        s, torque(s), 0.001))
    js, jd = sub(_jax_state(setup["pack"]))
    tp, td = setup["kernel"].plain(setup["pack"], *_torch_args(setup), 1, False, False)
    jpack = np.concatenate([np.asarray(js.base_pos), np.asarray(js.base_quat),
                            np.asarray(js.qj), np.asarray(js.u)], axis=1).T
    _assert_within_kernel_bounds(tp, td.foot_forces, jpack, jd.foot_forces, setup["weight"])
    np.testing.assert_allclose(td.term_force.numpy(), np.asarray(jd.term_force), atol=1e-3)


def test_frozen_prep_close_to_exact_prep(setup):
    """freeze_prep has no reference on the CPU (the reference applies it
    inside its TPU kernel only): hold it against exact prep."""
    a, _ = setup["kernel"].plain(setup["pack"], *_torch_args(setup), 10, True, True)
    b, _ = setup["kernel"].plain(setup["pack"], *_torch_args(setup), 10, True, False)
    sa, sb = unpack_state(a, 12), unpack_state(b, 12)
    assert float((sa.qj - sb.qj).abs().max()) < 1e-3
    assert float((sa.base_pos - sb.base_pos).abs().max()) < 1e-3
    assert float((sa.u - sb.u).abs().max()) < 0.1


def test_wrapper_takes_plain_path_on_cpu_and_counts_no_launch(setup):
    k = setup["kernel"]
    before = k.launches
    a, da = k(setup["pack"], *_torch_args(setup), 10, True, True)
    b, db = k.plain(setup["pack"], *_torch_args(setup), 10, True, True)
    assert k.launches == before
    assert torch.equal(a, b) and torch.equal(da.foot_forces, db.foot_forces)


def test_wrapper_refuses_other_devices(setup):
    meta = setup["pack"].to("meta")
    with pytest.raises(ValueError):
        setup["kernel"](meta, *(x.to("meta") for x in _torch_args(setup)), 10)


def test_model_table_layout(setup):
    t = setup["kernel"].table
    tm = setup["tm"]
    assert ctypes.sizeof(ModelTable) % 4 == 0
    assert (t.nj, t.n_fpts, t.n_term, t.n_feet) == (12, 8, 1, 2)
    # body 6 (left ankle roll) hangs below joints 0..5, body 12 below 6..11
    assert t.anc[6] == 0b111111 and t.anc[12] == 0b111111 << 6 and t.anc[0] == 0
    assert list(t.parent[:13]) == [int(p) for p in tm.parent]
    assert list(t.fpt_foot[:8]) == [0, 0, 0, 0, 1, 1, 1, 1]


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """csrc/control_step.cu compiled as host C++: its per-env step is
    __host__ __device__, so a host compiler checks the kernel's arithmetic
    here, where there is no nvcc."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_kernel")
    src = d / "harness.cpp"
    src.write_text(
        f'#include "{os.path.abspath(CSRC)}"\n'
        "extern \"C\" void host_control_step(const float* s, const float* m, const float* f,\n"
        "    const float* t, float* so, float* d, int N, const void* table, int dec, int fr,\n"
        "    int fp, int it) {\n"
        "  const ModelTable& mt = *static_cast<const ModelTable*>(table);\n"
        "  Work* W = new Work;\n"
        "  for (int n = 0; n < N; ++n)\n"
        "    control_step_env(mt, n, N, s, m, f, t, so, d, dec, fr != 0, fp != 0, it, *W);\n"
        "  delete W;\n"
        "}\n"
        "extern \"C\" int host_table_bytes() { return (int)sizeof(ModelTable); }\n")
    lib = d / "libhost.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("instance", [(1, False, False), (10, True, True), (10, True, False),
                                      (10, False, False)])
def test_kernel_source_matches_plain_on_host(setup, host_build, instance):
    assert host_build.host_table_bytes() == ctypes.sizeof(ModelTable)
    k, tm = setup["kernel"], setup["tm"]
    pack = setup["pack"].contiguous()
    masses, friction, targets = (x.contiguous() for x in _torch_args(setup))
    out = torch.empty_like(pack)
    diag = torch.empty((k.n_diag, N))
    dec, fr, fp = instance
    p = ctypes.c_void_p
    host_build.host_control_step(
        p(pack.data_ptr()), p(masses.data_ptr()), p(friction.data_ptr()), p(targets.data_ptr()),
        p(out.data_ptr()), p(diag.data_ptr()), N, p(ctypes.addressof(k.table)), dec, int(fr),
        int(fp), SWEEPS)
    hd = unpack_diag(diag, tm)
    b, db = k.plain(pack, masses, friction, targets, dec, fr, fp)
    _assert_within_kernel_bounds(out, hd.foot_forces, b, db.foot_forces, setup["weight"])
    np.testing.assert_allclose(hd.body_pos.numpy(), db.body_pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(hd.body_quat.numpy(), db.body_quat.numpy(), atol=1e-5)
    np.testing.assert_allclose(hd.body_omega.numpy(), db.body_omega.numpy(), atol=1e-3)
    np.testing.assert_allclose(hd.tau.numpy(), db.tau.numpy(), atol=1e-2)
    np.testing.assert_allclose(hd.term_force.numpy(), db.term_force.numpy(), atol=1e-3)
