"""The warm-started PGS control step (`PGSParams.warm_start`, the reference
kernel's pgs_warm_start) against the reference kernel itself.

The reference's Pallas kernel does not finish in interpret mode in the time
a test has, but its body runs eagerly: `_control_kernel` is called under
`jax.disable_jit()` with numpy-backed stand-ins for its refs (a read gives
`jnp.asarray(a[i])`, a write stores `np.asarray(v)`), on the model constants
of `make_model_consts(..., PGSParams(iterations=6, freeze_prep=True,
warm_start=True))`. That is the reference kernel's own code, run on the CPU.

The state: 8 robots standing on both feet after 0.3 s of settling, pressed
1 mm into the ground (as in test_torch_control_step). Bounds are the
reference package's kernel-vs-XLA bounds: |du| < 1e-2, |base_pos| < 1e-5,
foot forces within 1% of body weight. Control: the cold plain version,
held against the reference's warm kernel, falls outside them.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_tpu.ops import physics_kernel as jpk
from humanoid_tpu.physics.contact import ContactParams as JContactParams
from humanoid_tpu.physics.pgs import PGSParams as JPGSParams
from humanoid_tpu.physics.urdf import load_urdf as jax_load_urdf
from humanoid_tpu_torch.assets import write_xbot_topology_urdf
from humanoid_tpu_torch.ops.physics_kernel import (ControlStepKernel, diag_rows, pack_state,
                                                   unpack_diag)
from humanoid_tpu_torch.physics import pgs as tpgs
from humanoid_tpu_torch.physics.contact import ContactParams
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.physics.pgs import PGSParams
from humanoid_tpu_torch.physics.urdf import load_urdf

N = 8
SWEEPS = 6
KP = np.array([200, 200, 350, 350, 15, 15] * 2, np.float32)
KD = np.full(12, 10.0, np.float32)


class _Ref:
    """A numpy array standing in for a Pallas ref: rows read as jnp arrays."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, i):
        return jnp.asarray(self.a[i])

    def __setitem__(self, i, v):
        self.a[i] = np.asarray(v)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf")))
    jm = jax_load_urdf(path, armature=0.01)
    tm = load_urdf(path, armature=0.01)
    lim = (tm.dof_effort * 0.85).astype(np.float32)
    cold = ControlStepKernel(tm, KP, KD, lim, ContactParams(), PGSParams(iterations=SWEEPS), 0.001)
    warm = ControlStepKernel(tm, KP, KD, lim, ContactParams(),
                             PGSParams(iterations=SWEEPS, warm_start=True), 0.001)
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
        pack, diag = cold.plain(pack, *args, 10, True, True)
    weight = tm.total_mass * 9.81
    assert float(diag.foot_forces[..., 2].sum(1).min()) > 0.8 * weight
    pack = pack.clone()
    pack[2] -= 1e-3
    return dict(jm=jm, tm=tm, lim=lim, cold=cold, warm=warm, pack=pack, args=args,
                weight=weight)


def _reference_control_step(setup, decimation, warm=True):
    """The reference's _control_kernel body, run eagerly on the pressed
    state with a frozen factor and frozen contact prep. Returns (state
    pack (n_state, N), PhysDiag) as torch tensors."""
    tm = setup["tm"]
    mk = jpk.make_model_consts(
        setup["jm"], KP, KD, setup["lim"], JContactParams(), 0.001,
        pgs_params=JPGSParams(iterations=SWEEPS, freeze_prep=True, warm_start=warm))
    masses, friction, targets = (x.numpy() for x in setup["args"])
    out = np.zeros(tuple(setup["pack"].shape), np.float32)
    diag = np.zeros((diag_rows(tm), N), np.float32)
    with jax.disable_jit():
        jpk._control_kernel(
            _Ref(setup["pack"].numpy().copy()), _Ref(masses.T.copy()), _Ref(friction[None].copy()),
            _Ref(targets.T.copy()), _Ref(out), _Ref(diag), mk=mk, decimation=decimation,
            freeze=True, feats=dict(gains=False, body=False, planes=False))
    return torch.tensor(out), unpack_diag(torch.tensor(diag), tm)


@pytest.fixture(scope="module", params=[2, 3])
def reference_warm(request, setup):
    return request.param, _reference_control_step(setup, request.param)


def _errors(pack_a, ff_a, pack_b, ff_b, weight):
    """max |du|, max |base_pos| and max foot-force error over body weight."""
    du = float((pack_a[19:] - pack_b[19:]).abs().max())
    dpos = float((pack_a[0:3] - pack_b[0:3]).abs().max())
    return du, dpos, float((ff_a - ff_b).abs().max()) / weight


def test_warm_plain_matches_reference_kernel(setup, reference_warm):
    """The port's plain warm control step vs the reference's warm kernel
    body: within the kernel-vs-XLA bounds."""
    decimation, (rp, rd) = reference_warm
    tp, td = setup["warm"].plain(setup["pack"], *setup["args"], decimation, True, True)
    du, dpos, dff = _errors(tp, td.foot_forces, rp, rd.foot_forces, setup["weight"])
    assert du < 1e-2 and dpos < 1e-5 and dff < 0.01, (du, dpos, dff)
    np.testing.assert_allclose(td.body_pos.numpy(), rd.body_pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(td.tau.numpy(), rd.tau.numpy(), atol=1e-2)
    np.testing.assert_allclose(td.term_force.numpy(), rd.term_force.numpy(), atol=1e-3)


def test_cold_plain_fails_bounds_against_reference_warm(setup, reference_warm):
    """Control: the cold plain version against the reference's warm kernel
    falls outside the bounds, so they tell a warm start from a cold one."""
    decimation, (rp, rd) = reference_warm
    tp, td = setup["cold"].plain(setup["pack"], *setup["args"], decimation, True, True)
    du, dpos, dff = _errors(tp, td.foot_forces, rp, rd.foot_forces, setup["weight"])
    assert du >= 1e-2 or dpos >= 1e-5 or dff >= 0.01, (du, dpos, dff)


def test_warm_equals_cold_over_one_substep(setup):
    """The carry starts at zero at the control step's entry, so one substep
    is the cold one."""
    a, da = setup["warm"].plain(setup["pack"], *setup["args"], 1, True, True)
    b, db = setup["cold"].plain(setup["pack"], *setup["args"], 1, True, True)
    assert torch.equal(a, b) and torch.equal(da.foot_forces, db.foot_forces)


def test_warm_wrapper_takes_plain_path_on_cpu(setup):
    k = setup["warm"]
    a, da = k(setup["pack"], *setup["args"], 10, True, True)
    b, db = k.plain(setup["pack"], *setup["args"], 10, True, True)
    c, _ = setup["cold"].plain(setup["pack"], *setup["args"], 10, True, True)
    assert k.launches == 0
    assert torch.equal(a, b) and torch.equal(da.foot_forces, db.foot_forces)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("split", [1, 3])
def test_seeded_sweep_continues_the_sweep(split):
    """A seeded impulse enters the row velocities exactly as the sweep's
    own impulses do: `split` sweeps, then the rest seeded with their
    result, give the sweeps run at once."""
    rng = np.random.default_rng(split)
    n, K, nv = 4, 8, 18
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    Jc = f32(rng.normal(size=(n, 3 * K, nv)))
    Minv = f32(np.eye(nv) * 0.05)
    W = Jc @ Minv
    prep = tpgs.PGSPrep(Rk=f32(np.tile(np.eye(3), (n, K, 1, 1))), Jc=Jc, W=W,
                        A=W @ Jc.transpose(-1, -2) + 1e-3 * torch.eye(3 * K))
    phi = f32(rng.uniform(-0.01, 0.002, (n, K)))
    u_free = f32(rng.normal(size=(n, nv)) * 0.1)
    mu = f32(rng.uniform(0.3, 1.0, n))
    p = PGSParams(iterations=SWEEPS)
    u_all, f_all, lam_all = tpgs.pgs_solve(u_free, prep, phi, mu, 0.001, p)
    _, _, lam_a = tpgs.pgs_solve(u_free, prep, phi, mu, 0.001, p._replace(iterations=split))
    u_b, f_b, lam_b = tpgs.pgs_solve(u_free, prep, phi, mu, 0.001,
                                     p._replace(iterations=SWEEPS - split), lam0=lam_a)
    assert float(lam_all.abs().max()) > 0.0
    np.testing.assert_allclose(lam_b.numpy(), lam_all.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(u_b.numpy(), u_all.numpy(), rtol=1e-6, atol=1e-7)
    # with no sweep the seed passes through into u+
    u0, _, lam0 = tpgs.pgs_solve(u_free, prep, phi, mu, 0.001, p._replace(iterations=0),
                                 lam0=lam_all)
    assert torch.equal(lam0, lam_all)
    np.testing.assert_allclose(u0.numpy(), (u_free + torch.einsum("nkv,nk->nv", W, lam_all))
                               .numpy(), atol=1e-7)


def _env_pair(urdf, use_kernel):
    """humanoid_ppo at 8 envs with obs noise, pushes and action noise off,
    cold and warm-started."""
    import dataclasses

    from humanoid_tpu_torch.env.xbotl import XBotLEnv
    from humanoid_tpu_torch.utils import registry

    r = dataclasses.replace
    cfg = registry.get_cfgs("humanoid_ppo")[0]
    cfg = cfg.replace(env=r(cfg.env, num_envs=N),
                      sim=r(cfg.sim, use_pallas_substep=use_kernel),
                      domain_rand=r(cfg.domain_rand, action_delay=False,
                                    dynamic_randomization=0.0, push_robots=False),
                      noise=r(cfg.noise, add_noise=False))
    cold = XBotLEnv(cfg, urdf, device="cpu")
    warm = XBotLEnv(cfg.replace(sim=r(cfg.sim, pgs_warm_start=True)), urdf, device="cpu")
    return cold, warm


def _steps(env, n=3):
    gen = torch.Generator().manual_seed(3)
    s = env.initial_state(gen)
    for i in range(n):
        s, o = env.step(s, torch.full((N, 12), 0.1 * i), gen)
    return s, o


def test_engine_path_stays_cold_and_warns(tmp_path, caplog):
    """On the engine path (use_pallas_substep=False) pgs_warm_start changes
    nothing, and the env says so, as the reference does."""
    urdf = write_xbot_topology_urdf(str(tmp_path))
    with caplog.at_level(logging.WARNING, logger="humanoid_tpu_torch.env.xbotl"):
        cold, warm = _env_pair(urdf, use_kernel=False)
    assert any("pgs_warm_start are kernel-only" in r.getMessage() for r in caplog.records)
    assert warm.pgs_params.warm_start and not cold.pgs_params.warm_start
    (sc, oc), (sw, ow) = _steps(cold), _steps(warm)
    assert torch.equal(oc.obs, ow.obs) and torch.equal(sc.phys.u, sw.phys.u)


def test_kernel_path_runs_the_warm_instance(tmp_path):
    """On the kernel path the env builds the control step with the warm
    start: the same first step (one substep apart at most), then the
    trajectories part."""
    urdf = write_xbot_topology_urdf(str(tmp_path))
    cold, warm = _env_pair(urdf, use_kernel=True)
    assert warm.physics.pgs_params.warm_start and not cold.physics.pgs_params.warm_start
    (sc, oc), (sw, ow) = _steps(cold, 15), _steps(warm, 15)
    assert not torch.equal(sc.phys.u, sw.phys.u)
    assert bool(torch.isfinite(ow.obs).all())
