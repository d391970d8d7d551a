"""The control step: the port's plain version vs the reference engine, the
frozen contact prep vs the exact one, and the CUDA kernel's source vs the
plain version (the PGS instances' team step built with a team of one lane).

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

The kernel's optional inputs: per-env gains and bodies (random, in the
ranges of the reference's domain randomization) against the reference
engine with EnvPhysParams(com, inertia) and its gain torque; ground planes
on an exactly linear ramp, where a per-substep bilinear sample of the
heightfield and a per-control-step tangent plane are the same surface,
against the reference engine on that heightfield. The same bounds hold.

The setup and the checks take the robot, its gains and its pose from the
setup dict, so that tests/test_torch_d11.py runs the same checks on the
18-dof robot.
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

from humanoid_tpu.ops import linalg as jlinalg
from humanoid_tpu.physics import dynamics as jdyn
from humanoid_tpu.physics import engine as jeng
from humanoid_tpu.physics.contact import ContactParams as JContactParams
from humanoid_tpu.physics.contact import Terrain as JTerrain
from humanoid_tpu.physics.pgs import PGSParams as JPGSParams
from humanoid_tpu.physics.urdf import load_urdf as jax_load_urdf
from humanoid_tpu_torch.assets import write_xbot_topology_urdf
from humanoid_tpu_torch.ops.physics_kernel import (ControlStepKernel, ModelTable, n_points,
                                                   pack_body, pack_state, unpack_body,
                                                   unpack_diag, unpack_state)
from humanoid_tpu_torch.physics import engine as teng
from humanoid_tpu_torch.physics.contact import ContactParams, Terrain
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.physics.kinematics import RobotTensors
from humanoid_tpu_torch.physics.pgs import PGSParams
from humanoid_tpu_torch.physics.urdf import load_urdf

N = 8
SWEEPS = 6
KP = np.array([200, 200, 350, 350, 15, 15] * 2, np.float32)
KD = np.full(12, 10.0, np.float32)
CSRC = os.path.join(os.path.dirname(__file__), "..", "humanoid_tpu_torch", "csrc",
                    "control_step.cu")


def make_setup(path, kp, kd, default_pos):
    """The robot of the URDF `path` with the PD gains kp, kd, its kernel
    wrapper (PGS, 6 cold sweeps), and 8 robots posed at default_pos plus
    small random offsets (the PD targets), settled 0.3 s on both feet and
    pressed 1 mm into the ground."""
    jm = jax_load_urdf(path, armature=0.01)
    tm = load_urdf(path, armature=0.01)
    lim = (tm.dof_effort * 0.85).astype(np.float32)
    kernel = ControlStepKernel(tm, kp, kd, lim, ContactParams(), PGSParams(iterations=SWEEPS),
                               0.001)
    rng = np.random.default_rng(0)
    qj = (default_pos + rng.uniform(-0.05, 0.05, (N, tm.nj))).astype(np.float32)
    masses = np.tile(tm.mass, (N, 1)).astype(np.float32)
    masses[:, 0] += rng.uniform(-5.0, 5.0, N).astype(np.float32)
    friction = rng.uniform(0.1, 2.0, N).astype(np.float32)
    phys = PhysState(torch.tensor(np.c_[np.zeros((N, 2)), np.full(N, 0.90)], dtype=torch.float32),
                     torch.tensor([[1.0, 0.0, 0.0, 0.0]] * N), torch.tensor(qj),
                     torch.zeros(N, tm.nv))
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
                friction=friction, targets=qj, weight=weight, kp=np.asarray(kp, np.float32),
                kd=np.asarray(kd, np.float32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf")))
    return make_setup(path, KP, KD, np.zeros(12))


def _nj(pack):
    """The joint count of a state pack of 7 + nj + (6 + nj) rows."""
    return (pack.shape[0] - 13) // 2


def _jax_state(pack):
    s = pack.T.numpy()
    nj = _nj(pack)
    return jeng.PhysState(base_pos=jnp.asarray(s[:, 0:3]), base_quat=jnp.asarray(s[:, 3:7]),
                          qj=jnp.asarray(s[:, 7:7 + nj]), u=jnp.asarray(s[:, 7 + nj:]))


def _jax_torque(setup):
    tgt = jnp.asarray(setup["targets"])
    lim = jnp.asarray(setup["lim"])
    kp, kd = jnp.asarray(setup["kp"]), jnp.asarray(setup["kd"])

    def torque(s):
        return jnp.clip(kp * (tgt - s.qj) - kd * s.u[:, 6:], -lim, lim)
    return torque


def _torch_args(setup):
    return (torch.tensor(setup["masses"]), torch.tensor(setup["friction"]),
            torch.tensor(setup["targets"]))


def _kernel_errors(pack_a, ff_a, pack_b, ff_b, weight):
    """max |du|, max |base_pos| and max foot-force error over body weight."""
    u0 = 7 + _nj(pack_a)
    du = float(np.abs(np.asarray(pack_a)[u0:] - np.asarray(pack_b)[u0:]).max())
    dpos = float(np.abs(np.asarray(pack_a)[0:3] - np.asarray(pack_b)[0:3]).max())
    dff = float(np.abs(np.asarray(ff_a) - np.asarray(ff_b)).max())
    return du, dpos, dff / weight


def _assert_within_kernel_bounds(pack_a, ff_a, pack_b, ff_b, weight):
    du, dpos, dff = _kernel_errors(pack_a, ff_a, pack_b, ff_b, weight)
    assert du < 1e-2, du
    assert dpos < 1e-5, dpos
    assert dff < 0.01, dff


def test_control_step_matches_reference_engine(setup):
    """Plain control step (frozen factor, exact prep) vs engine.control_step_pgs."""
    check_control_step_matches_reference_engine(setup)


def check_control_step_matches_reference_engine(setup):
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
    nj = setup["tm"].nj
    sa, sb = unpack_state(a, nj), unpack_state(b, nj)
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
        "    const float* t, const float* g, const float* b, const float* pl, float* so,\n"
        "    float* d, int N, const void* table, int dec, int pgs, int warm, int fr, int fp,\n"
        "    int it, int tail) {\n"
        "  const ModelTable& mt = *static_cast<const ModelTable*>(table);\n"
        "  Work* W = new Work;\n"
        "  for (int n = 0; n < N + tail; ++n)\n"
        "    control_step_env(mt, n, N, s, m, f, t, g, b, pl, so, d, dec, pgs != 0, warm != 0,\n"
        "                     fr != 0, fp != 0, it, *W);\n"
        "  delete W;\n"
        "}\n"
        "extern \"C\" int host_table_bytes() { return (int)sizeof(ModelTable); }\n"
        # the penalty team's chain schedule at its card size, PENALTY_TEAM = 16
        "extern \"C\" int host_chains16(const void* table, int* len, int* joint) {\n"
        "  Chains<16> ch;\n"
        "  make_chains(*static_cast<const ModelTable*>(table), ch);\n"
        "  for (int l = 0; l < 16; ++l) {\n"
        "    len[l] = ch.len[l];\n"
        "    for (int s = 0; s < ch.len[l]; ++s) joint[l * MAX_NJ + s] = ch.joint[l][s];\n"
        "  }\n"
        "  return ch.steps;\n"
        "}\n")
    lib = d / "libhost.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.host_control_step.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 7
    lib.host_chains16.restype = ctypes.c_int
    lib.host_chains16.argtypes = [ctypes.c_void_p] * 3
    return lib


def _host_step(host_build, k, pack, masses, friction, targets, instance, gains=None, body=None,
               planes=None, tail=3):
    """One control step of the host-compiled kernel source, on the contact
    model of the wrapper k (PGS, cold or warm as its parameters say, or
    penalty without PGS parameters). The team step (with a team of one
    lane) also runs `tail` teams beyond the N envs, as a grid's last block
    does; they must write nothing, and the outputs sit in front of a NaN
    guard that is checked."""
    n = pack.shape[1]
    guard = 64
    out_buf = torch.full((pack.shape[0] * n + guard,), float("nan"))
    diag_buf = torch.full((k.n_diag * n + guard,), float("nan"))
    out, diag = out_buf[:-guard].view(pack.shape[0], n), diag_buf[:-guard].view(k.n_diag, n)
    dec, fr, fp = instance
    ptr = [None if x is None else x.contiguous().data_ptr()
           for x in (pack, masses, friction, targets, gains, body, planes)]
    pgs = k.pgs_params is not None
    warm = pgs and k.pgs_params.warm_start
    host_build.host_control_step(*ptr, out.data_ptr(), diag.data_ptr(), n,
                                 ctypes.addressof(k.table), dec, int(pgs), int(warm), int(fr),
                                 int(fp), SWEEPS if pgs else 0, tail)
    assert bool(torch.isnan(out_buf[-guard:]).all() and torch.isnan(diag_buf[-guard:]).all())
    return out, unpack_diag(diag, k.model)


def _warm_kernel(setup):
    return ControlStepKernel(setup["tm"], setup["kp"], setup["kd"], setup["lim"], ContactParams(),
                             PGSParams(iterations=SWEEPS, warm_start=True), 0.001)


def _penalty_kernel(setup):
    return ControlStepKernel(setup["tm"], setup["kp"], setup["kd"], setup["lim"], ContactParams(),
                             None, 0.001)


@pytest.mark.parametrize("instance,warm", [((1, False, False), False), ((10, True, True), False),
                                           ((10, True, False), False), ((10, False, False), False),
                                           ((10, True, True), True), ((10, False, False), True)])
def test_kernel_source_matches_plain_on_host(setup, host_build, instance, warm):
    """The host-compiled kernel vs the plain version on each instance; with
    `warm`, the warm-started PGS instance (PGSParams.warm_start) against the
    plain warm control step."""
    check_kernel_source_matches_plain_on_host(setup, host_build, instance, warm)


def check_kernel_source_matches_plain_on_host(setup, host_build, instance, warm):
    assert host_build.host_table_bytes() == ctypes.sizeof(ModelTable)
    k = _warm_kernel(setup) if warm else setup["kernel"]
    pack = setup["pack"].contiguous()
    masses, friction, targets = (x.contiguous() for x in _torch_args(setup))
    out, hd = _host_step(host_build, k, pack, masses, friction, targets, instance)
    b, db = k.plain(pack, masses, friction, targets, *instance)
    _assert_within_kernel_bounds(out, hd.foot_forces, b, db.foot_forces, setup["weight"])
    np.testing.assert_allclose(hd.body_pos.numpy(), db.body_pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(hd.body_quat.numpy(), db.body_quat.numpy(), atol=1e-5)
    np.testing.assert_allclose(hd.body_omega.numpy(), db.body_omega.numpy(), atol=1e-3)
    np.testing.assert_allclose(hd.tau.numpy(), db.tau.numpy(), atol=1e-2)
    np.testing.assert_allclose(hd.term_force.numpy(), db.term_force.numpy(), atol=1e-3)
    if warm:   # control: the cold plain version falls outside the bounds
        c, dc = setup["kernel"].plain(pack, masses, friction, targets, *instance)
        du, dpos, dff = _kernel_errors(out, hd.foot_forces, c, dc.foot_forces, setup["weight"])
        assert du >= 1e-2 or dpos >= 1e-5 or dff >= 0.01, (du, dpos, dff)


TEAMS_PER_BLOCK = 8      # envs per block of both team kernels (PGS and penalty)


@pytest.mark.parametrize("n,contact", [(1, "cold"), (1, "warm"), (1, "penalty"), (5, "cold"),
                                       (5, "penalty")])
def test_kernel_source_at_small_env_counts_matches_plain_on_host(setup, host_build, n,
                                                                 contact):
    """`play`'s env counts: 1 env (its block's other 7 teams are tail
    teams) and 5 (the last block of 37 envs: 5 envs, 3 tail teams). The
    team step with one lane, the tail teams run after the envs and behind
    the NaN guard, against the plain version."""
    check_kernel_source_at_small_env_counts(setup, host_build, n, contact)


def check_kernel_source_at_small_env_counts(setup, host_build, n, contact):
    k = {"cold": setup["kernel"], "warm": _warm_kernel(setup),
         "penalty": _penalty_kernel(setup)}[contact]
    pack = setup["pack"][:, :n].contiguous()
    masses, friction, targets = (x[:n].contiguous() for x in _torch_args(setup))
    for instance in ((10, True, True), (1, False, False)):
        out, hd = _host_step(host_build, k, pack, masses, friction, targets, instance,
                             tail=TEAMS_PER_BLOCK - n % TEAMS_PER_BLOCK)
        b, db = k.plain(pack, masses, friction, targets, *instance)
        assert out.shape == (pack.shape[0], n)
        _assert_within_kernel_bounds(out, hd.foot_forces, b, db.foot_forces, setup["weight"])
        np.testing.assert_allclose(hd.tau.numpy(), db.tau.numpy(), atol=1e-2)


# ---------------------------------------------------------------------------
# the optional inputs: gains, body, planes

GX, GY = 0.05, -0.05      # the ramp: h = 0.05 x - 0.05 y, one 5 mm count per 0.1 m cell


def _random_extras(setup, seed=1, n=N):
    """Gains and bodies drawn in the ranges of the reference's domain
    randomization (DomainRandCfg): strength, kp and kd factors in
    [0.8, 1.2], motor offsets in +-0.035 rad, base COM offsets, inertia
    factors in [0.8, 1.2] applied symmetrically."""
    rng = np.random.default_rng(seed)
    tm = setup["tm"]
    nb, nj = tm.nb, tm.nj
    strength = np.repeat(rng.uniform(0.8, 1.2, (n, 1)), nj, axis=1)
    kpf, kdf = rng.uniform(0.8, 1.2, (n, nj)), rng.uniform(0.8, 1.2, (n, nj))
    offsets = rng.uniform(-0.035, 0.035, (n, nj))
    com = np.tile(tm.com, (n, 1, 1))
    com[:, 0] += np.c_[rng.uniform(-0.07, 0.03, n), rng.uniform(-0.03, 0.03, (n, 2))]
    f6 = rng.uniform(0.8, 1.2, (n, nb, 6))
    inertia = np.tile(tm.inertia, (n, 1, 1, 1)) * f6[..., (0, 1, 2, 1, 3, 4, 2, 4, 5)].reshape(
        n, nb, 3, 3)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(kp_eff=f32(setup["kp"] * kpf), kd_eff=f32(setup["kd"] * kdf),
                strength=f32(strength),
                offsets=f32(offsets), com=f32(com), inertia=f32(inertia))


def _gains_body(ex):
    gains = torch.tensor(np.concatenate([ex["kp_eff"], ex["kd_eff"], ex["strength"]], axis=1))
    return gains, pack_body(torch.tensor(ex["com"]), torch.tensor(ex["inertia"]))


def _ramp_planes(tm, n=N):
    P = n_points(tm)
    return torch.tensor(np.tile([0.0, GX, GY], (n, P)), dtype=torch.float32)


@pytest.fixture(scope="module")
def ramp(setup):
    return make_ramp(setup)


def make_ramp(setup):
    """8 robots settled 0.3 s on the ramp (planes), then pressed 1 mm in."""
    k = setup["kernel"]
    pack = setup["pack"].clone()
    pack[2] += 1e-3
    args = _torch_args(setup)
    planes = _ramp_planes(setup["tm"])
    for _ in range(30):
        pack, diag = k.plain(pack, *args, 10, True, True, planes=planes)
    assert float(diag.foot_forces[..., 2].sum(1).min()) > 0.8 * setup["weight"]
    pack = pack.clone()
    pack[2] -= 1e-3
    return pack, planes


def test_body_rows_round_trip(setup):
    ex = _random_extras(setup)
    com, inertia = unpack_body(_gains_body(ex)[1], setup["tm"].nb)
    assert torch.equal(com, torch.tensor(ex["com"]))
    assert torch.equal(inertia, torch.tensor(ex["inertia"]))


def test_control_step_with_gains_and_body_matches_reference_engine(setup):
    """Plain control step with per-env gains and bodies vs
    engine.control_step_pgs with EnvPhysParams(com, inertia) and the
    reference env's randomized-gain torque."""
    check_gains_and_body_match_reference_engine(setup)


def check_gains_and_body_match_reference_engine(setup):
    ex = _random_extras(setup)
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]),
                                com=jnp.asarray(ex["com"]), inertia=jnp.asarray(ex["inertia"]))
    tgt, lim = jnp.asarray(setup["targets"]), jnp.asarray(setup["lim"])

    def torque(s):
        tau = (jnp.asarray(ex["kp_eff"]) * (tgt - s.qj + jnp.asarray(ex["offsets"]))
               - jnp.asarray(ex["kd_eff"]) * s.u[:, 6:]) * jnp.asarray(ex["strength"])
        return jnp.clip(tau, -lim, lim)

    step = jax.jit(lambda s: jeng.control_step_pgs(
        setup["jm"], params, JTerrain.plane(), JContactParams(), JPGSParams(iterations=SWEEPS),
        s, torque, 10, 0.001, freeze_mass_matrix=True))
    js, jd = step(_jax_state(setup["pack"]))
    gains, body = _gains_body(ex)
    masses, friction, targets = _torch_args(setup)
    tp, td = setup["kernel"].plain(setup["pack"], masses, friction,
                                   targets + torch.tensor(ex["offsets"]), 10, True, False,
                                   gains=gains, body=body)
    jpack = np.concatenate([np.asarray(js.base_pos), np.asarray(js.base_quat),
                            np.asarray(js.qj), np.asarray(js.u)], axis=1).T
    _assert_within_kernel_bounds(tp, td.foot_forces, jpack, jd.foot_forces, setup["weight"])
    np.testing.assert_allclose(td.tau.numpy(), np.asarray(jd.tau), atol=1e-2)
    # the randomization changed the step
    plain, _ = setup["kernel"].plain(setup["pack"], masses, friction, targets, 10, True, False)
    assert float((plain - tp).abs().max()) > 1e-4


def test_planes_on_a_ramp_match_reference_heightfield(setup, ramp):
    """control_step_plain(planes) vs engine.control_step_pgs on the ramp's
    heightfield (bilinear sampling every substep)."""
    pack, planes = ramp
    i = np.arange(101)[:, None]
    j = np.arange(101)[None, :]
    height = (0.005 * (i - j)).astype(np.float32)          # x, y in [-5, 5] m
    jt = JTerrain(height=jnp.asarray(height), horizontal_scale=0.1, border=5.0, flat=False)
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]))
    step = jax.jit(lambda s: jeng.control_step_pgs(
        setup["jm"], params, jt, JContactParams(), JPGSParams(iterations=SWEEPS), s,
        _jax_torque(setup), 10, 0.001, freeze_mass_matrix=True))
    js, jd = step(_jax_state(pack))
    tp, td = setup["kernel"].plain(pack, *_torch_args(setup), 10, True, False, planes=planes)
    jpack = np.concatenate([np.asarray(js.base_pos), np.asarray(js.base_quat),
                            np.asarray(js.qj), np.asarray(js.u)], axis=1).T
    _assert_within_kernel_bounds(tp, td.foot_forces, jpack, jd.foot_forces, setup["weight"])
    # on the ramp the feet push along its normal, not straight up
    assert float(td.foot_forces[..., 0].abs().max()) > 1.0


def test_engine_on_a_heightfield_matches_reference_engine(setup, ramp):
    """The port's engine.control_step_pgs on a heightfield Terrain (sampled
    at every substep, the reference's semantics) vs the reference's on the
    same heightfield: the ramp with up to 0.5 mm of random relief per cell,
    so that the sampled height and normal change from point to point and
    substep to substep, while every sole corner stays in contact."""
    pack, _ = ramp
    rng = np.random.default_rng(3)
    i = np.arange(101)[:, None]
    j = np.arange(101)[None, :]
    height = (0.005 * (i - j) + rng.uniform(-5e-4, 5e-4, (101, 101))).astype(np.float32)
    jt = JTerrain(height=jnp.asarray(height), horizontal_scale=0.1, border=5.0, flat=False)
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]))
    step = jax.jit(lambda s: jeng.control_step_pgs(
        setup["jm"], params, jt, JContactParams(), JPGSParams(iterations=SWEEPS), s,
        _jax_torque(setup), 10, 0.001, freeze_mass_matrix=True))
    js, jd = step(_jax_state(pack))
    masses, friction, targets = _torch_args(setup)
    kp, kd, lim = (torch.tensor(x) for x in (setup["kp"], setup["kd"], setup["lim"]))

    def torque(s):
        return torch.clamp(kp * (targets - s.qj) - kd * s.u[:, 6:], -lim, lim)

    ts, td = teng.control_step_pgs(
        RobotTensors.from_model(setup["tm"], "cpu"), teng.EnvPhysParams(masses, friction),
        Terrain.heightfield(height, 0.1, 5.0), ContactParams(), PGSParams(iterations=SWEEPS),
        unpack_state(pack, setup["tm"].nj), torque, 10, 0.001, freeze_mass_matrix=True)
    jpack = np.concatenate([np.asarray(js.base_pos), np.asarray(js.base_quat),
                            np.asarray(js.qj), np.asarray(js.u)], axis=1).T
    _assert_within_kernel_bounds(pack_state(ts), td.foot_forces, jpack, jd.foot_forces,
                                 setup["weight"])
    np.testing.assert_allclose(td.term_force.numpy(), np.asarray(jd.term_force), atol=1e-3)
    # every sole corner carries load
    assert float(td.foot_forces[..., 2].min()) > 0.1 * setup["weight"]


def _random_near_ground(tm, seed=7, n=N):
    """A random near-ground batch (the reference's kernel-vs-XLA PGS test
    layout) over random per-point planes with |slope| <= 0.3."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    phys = PhysState(f32(np.c_[rng.uniform(-0.1, 0.1, (n, 2)), rng.uniform(0.82, 0.95, n)]),
                     f32(np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))),
                     f32(rng.uniform(-0.2, 0.2, (n, tm.nj))),
                     f32(rng.uniform(-0.5, 0.5, (n, tm.nv))))
    P = n_points(tm)
    g = rng.uniform(-0.2, 0.2, (n, P, 2))
    planes = f32(np.concatenate([rng.uniform(-0.03, 0.03, (n, P, 1)), g], axis=2).reshape(n, -1))
    targets = f32(rng.uniform(-0.3, 0.3, (n, tm.nj)))
    return pack_state(phys), targets, planes


@pytest.mark.parametrize("case", ["ramp-exact", "ramp-shipping", "ramp-frozen-factor",
                                  "random-planes-exact", "ramp-warm"])
def test_kernel_source_with_extras_matches_plain_on_host(setup, ramp, host_build, case):
    """The host-compiled kernel with gains, body and planes vs the plain
    version (with `warm`, on the warm-started PGS instance)."""
    check_kernel_source_with_extras(setup, ramp, host_build, case)


def check_kernel_source_with_extras(setup, ramp, host_build, case):
    k = setup["kernel"]
    if case.endswith("warm"):
        k = _warm_kernel(setup)
    masses, friction, targets = _torch_args(setup)
    gains, body = _gains_body(_random_extras(setup))
    instance = {"exact": (1, False, False), "shipping": (10, True, True),
                "factor": (10, True, False), "warm": (10, True, True)}[case.split("-")[-1]]
    if case.startswith("ramp"):
        pack, planes = ramp
    else:
        pack, targets, planes = _random_near_ground(setup["tm"])
    out, hd = _host_step(host_build, k, pack, masses, friction, targets, instance, gains, body,
                         planes)
    b, db = k.plain(pack, masses, friction, targets, *instance, gains=gains, body=body,
                    planes=planes)
    _assert_within_kernel_bounds(out, hd.foot_forces, b, db.foot_forces, setup["weight"])
    np.testing.assert_allclose(hd.body_pos.numpy(), db.body_pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(hd.tau.numpy(), db.tau.numpy(), atol=1e-2)
    np.testing.assert_allclose(hd.term_force.numpy(), db.term_force.numpy(), atol=1e-3)


@pytest.mark.parametrize("dropped", ["gains", "body", "planes", "planes-warm"])
def test_bounds_catch_a_kernel_that_ignores_an_input(setup, ramp, host_build, dropped):
    """Control for the bounds the extras are held to: the host-compiled
    kernel with gains, body and planes (shipping instance, on the ramp; with
    `warm`, the warm-started one) against the plain version run without one
    of them falls outside the bounds, so a kernel that ignored that input
    would fail them."""
    k = setup["kernel"]
    dropped, _, warm = dropped.partition("-")
    if warm:
        k = _warm_kernel(setup)
    pack, planes = ramp
    masses, friction, targets = _torch_args(setup)
    gains, body = _gains_body(_random_extras(setup))
    extras = {"gains": gains, "body": body, "planes": planes}
    out, hd = _host_step(host_build, k, pack, masses, friction, targets, (10, True, True),
                         **extras)
    b, db = k.plain(pack, masses, friction, targets, 10, True, True,
                    **{key: v for key, v in extras.items() if key != dropped})
    du, dpos, dff = _kernel_errors(out, hd.foot_forces, b, db.foot_forces, setup["weight"])
    assert du >= 1e-2 or dpos >= 1e-5 or dff >= 0.01, (du, dpos, dff)


# ---------------------------------------------------------------------------
# the penalty contact model: engine.control_step_batch and the kernel's
# penalty instance (built without PGS parameters), on the same pressed
# states. Every sole corner is 1 mm or more inside the ground there, and the
# penalty force (2e4 N/m) pushes it deeper under the robot's weight, so the
# contact set holds for the control step in both implementations.

@pytest.fixture(scope="module")
def penalty_kernel(setup):
    return _penalty_kernel(setup)


def _jax_pack(js):
    return np.concatenate([np.asarray(js.base_pos), np.asarray(js.base_quat),
                           np.asarray(js.qj), np.asarray(js.u)], axis=1).T


@pytest.mark.parametrize("freeze", [True, False])
def test_penalty_control_step_matches_reference_engine(setup, penalty_kernel, freeze):
    """control_step_plain without PGS (engine.control_step_batch, frozen
    factor: B3 + B4; unfrozen: B5 each substep) vs the reference's."""
    check_penalty_matches_reference_engine(setup, penalty_kernel, freeze)


def check_penalty_matches_reference_engine(setup, penalty_kernel, freeze):
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]))
    step = jax.jit(lambda s: jeng.control_step_batch(
        setup["jm"], params, JTerrain.plane(), JContactParams(), s, _jax_torque(setup), 10,
        0.001, freeze_mass_matrix=freeze))
    js, jd = step(_jax_state(setup["pack"]))
    tp, td = penalty_kernel.plain(setup["pack"], *_torch_args(setup), 10, freeze, True)
    _assert_within_kernel_bounds(tp, td.foot_forces, _jax_pack(js), jd.foot_forces,
                                 setup["weight"])
    np.testing.assert_allclose(td.body_pos.numpy(), np.asarray(jd.body_pos), atol=1e-5)
    np.testing.assert_allclose(td.term_force.numpy(), np.asarray(jd.term_force), atol=1e-3)
    # the feet carry the robot through the penalty springs
    assert float(td.foot_forces[..., 2].sum(1).min()) > 0.5 * setup["weight"]


def test_cached_penalty_substep_matches_reference_engine(setup):
    """engine.substep_batch with a frozen factor L (B4 against it, B3 for
    L) vs the reference's substep_batch_cached, one substep from the
    pressed state."""
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]))
    torque = _jax_torque(setup)
    js0 = _jax_state(setup["pack"])

    def factor(s):
        jm = setup["jm"]
        k = jax.vmap(lambda bp, bq, qj, u, m: jdyn.compute_kinematics_bias(
            jm, bp, bq, qj, u, mass=m))(s.base_pos, s.base_quat, s.qj, s.u, params.masses)
        M = jax.vmap(lambda S, I: jdyn.assemble_mass_matrix(jm, S, I))(k[2], k[3])
        return jlinalg.factor_spd_batch(M)

    with jax.default_matmul_precision("highest"):
        L = jax.jit(factor)(js0)
    js, jd = jax.jit(lambda s: jeng.substep_batch_cached(
        setup["jm"], params, JTerrain.plane(), JContactParams(), s, torque(s), 0.001, L))(js0)
    masses, friction, targets = _torch_args(setup)
    kp, kd, lim = (torch.tensor(x) for x in (setup["kp"], setup["kd"], setup["lim"]))
    rt = RobotTensors.from_model(setup["tm"], "cpu")
    tparams = teng.EnvPhysParams(masses, friction)
    state = unpack_state(setup["pack"], setup["tm"].nj)
    tau = torch.clamp(kp * (targets - state.qj) - kd * state.u[:, 6:], -lim, lim)
    ts, td = teng.substep_batch(rt, tparams, Terrain.plane(), ContactParams(), state, tau, 0.001,
                                L=teng.mass_matrix_factor(rt, tparams, state))
    _assert_within_kernel_bounds(pack_state(ts), td.foot_forces, _jax_pack(js), jd.foot_forces,
                                 setup["weight"])
    np.testing.assert_allclose(td.foot_forces.numpy(), np.asarray(jd.foot_forces), rtol=1e-4,
                               atol=1e-2)


def test_unfrozen_pgs_control_step_matches_reference_engine(setup):
    """engine.control_step_pgs with freeze_mass_matrix=False (B3 each
    substep) vs the reference's."""
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]))
    step = jax.jit(lambda s: jeng.control_step_pgs(
        setup["jm"], params, JTerrain.plane(), JContactParams(), JPGSParams(iterations=SWEEPS),
        s, _jax_torque(setup), 10, 0.001, freeze_mass_matrix=False))
    js, jd = step(_jax_state(setup["pack"]))
    tp, td = setup["kernel"].plain(setup["pack"], *_torch_args(setup), 10, False, False)
    _assert_within_kernel_bounds(tp, td.foot_forces, _jax_pack(js), jd.foot_forces,
                                 setup["weight"])


def test_penalty_planes_on_a_ramp_match_reference_heightfield(setup, penalty_kernel, ramp):
    """control_step_plain without PGS with planes vs the reference's
    control_step_batch on the ramp's heightfield, where the per-substep
    bilinear sample and the per-control-step tangent plane coincide."""
    pack, planes = ramp
    i = np.arange(101)[:, None]
    j = np.arange(101)[None, :]
    height = (0.005 * (i - j)).astype(np.float32)
    jt = JTerrain(height=jnp.asarray(height), horizontal_scale=0.1, border=5.0, flat=False)
    params = jeng.EnvPhysParams(masses=jnp.asarray(setup["masses"]),
                                friction=jnp.asarray(setup["friction"]))
    step = jax.jit(lambda s: jeng.control_step_batch(
        setup["jm"], params, jt, JContactParams(), s, _jax_torque(setup), 10, 0.001,
        freeze_mass_matrix=True))
    js, jd = step(_jax_state(pack))
    tp, td = penalty_kernel.plain(pack, *_torch_args(setup), 10, True, True, planes=planes)
    _assert_within_kernel_bounds(tp, td.foot_forces, _jax_pack(js), jd.foot_forces,
                                 setup["weight"])
    assert float(td.foot_forces[..., 0].abs().max()) > 1.0


@pytest.mark.parametrize("case", ["flat-exact", "flat-shipping", "flat-unfrozen",
                                  "ramp-shipping", "ramp-exact", "random-planes-exact",
                                  "ramp-unfrozen", "random-planes-unfrozen"])
def test_penalty_kernel_source_matches_plain_on_host(setup, penalty_kernel, ramp, host_build,
                                                     case):
    """The host-compiled kernel's penalty instance (its team step with one
    lane, tail teams behind the NaN guard) vs control_step_batch: on the
    flat plane without inputs, and with gains, body and planes on the ramp
    and on random per-point planes, the factor frozen or not."""
    check_penalty_kernel_source_matches_plain_on_host(setup, penalty_kernel, ramp, host_build,
                                                      case)


def check_penalty_kernel_source_matches_plain_on_host(setup, penalty_kernel, ramp, host_build,
                                                      case):
    k = penalty_kernel
    masses, friction, targets = _torch_args(setup)
    instance = {"exact": (1, False, False), "shipping": (10, True, True),
                "unfrozen": (10, False, False)}[case.split("-")[-1]]
    extras = {}
    pack = setup["pack"]
    if case.startswith("ramp"):
        pack, planes = ramp
        gains, body = _gains_body(_random_extras(setup))
        extras = dict(gains=gains, body=body, planes=planes)
    elif case.startswith("random"):
        pack, targets, planes = _random_near_ground(setup["tm"])
        gains, body = _gains_body(_random_extras(setup))
        extras = dict(gains=gains, body=body, planes=planes)
    out, hd = _host_step(host_build, k, pack, masses, friction, targets, instance, **extras)
    b, db = k.plain(pack, masses, friction, targets, *instance, **extras)
    _assert_within_kernel_bounds(out, hd.foot_forces, b, db.foot_forces, setup["weight"])
    np.testing.assert_allclose(hd.body_pos.numpy(), db.body_pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(hd.tau.numpy(), db.tau.numpy(), atol=1e-2)
    np.testing.assert_allclose(hd.term_force.numpy(), db.term_force.numpy(), atol=1e-3)
    if not case.startswith("random"):      # both feet pushed by the springs
        assert float(db.foot_forces[..., 2].min()) > 0.1 * setup["weight"]


def test_penalty_bounds_catch_a_kernel_that_ignores_planes(setup, penalty_kernel, ramp,
                                                           host_build):
    """Control: the host-compiled penalty instance on the ramp against the
    plain version run without the planes falls outside the bounds."""
    pack, planes = ramp
    masses, friction, targets = _torch_args(setup)
    out, hd = _host_step(host_build, penalty_kernel, pack, masses, friction, targets,
                         (10, True, True), planes=planes)
    b, db = penalty_kernel.plain(pack, masses, friction, targets, 10, True, True)
    du, dpos, dff = _kernel_errors(out, hd.foot_forces, b, db.foot_forces, setup["weight"])
    assert du >= 1e-2 or dpos >= 1e-5 or dff >= 0.01, (du, dpos, dff)


def test_penalty_wrapper_takes_plain_path_on_cpu(setup, penalty_kernel):
    a, da = penalty_kernel(setup["pack"], *_torch_args(setup), 10, True, True)
    b, db = penalty_kernel.plain(setup["pack"], *_torch_args(setup), 10, True, True)
    assert penalty_kernel.launches == 0 and penalty_kernel.table.erp == 0.0
    assert torch.equal(a, b) and torch.equal(da.foot_forces, db.foot_forces)


def test_penalty_operation_count(setup):
    """The penalty instance has no contact prep and no sweeps: well under
    the PGS instance's count, and freeze_prep and the sweep count change
    nothing."""
    from humanoid_tpu_torch.ops.physics_kernel import operations_per_env

    tm = setup["tm"]
    pen = operations_per_env(tm, 10, True, True, 0, pgs=False)
    assert pen == operations_per_env(tm, 10, True, False, 6, pgs=False)
    assert 0 < pen < operations_per_env(tm, 10, True, True, 6) / 2
    assert operations_per_env(tm, 10, True, True, 6) == 228935
