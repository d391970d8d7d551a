"""Card-only tests of the port: the CUDA control-step kernel (without and
with its gains, body and planes inputs, on PGS, warm-started PGS and
penalty contact; the team kernels also at a count of envs that leaves
tail teams), the
heightfield sampler and the batched Cholesky kernels against their plain
PyTorch versions. They import nothing of JAX, so that they run
on a machine with the card:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device they skip. Bounds are the reference package's
kernel-vs-XLA bounds (|du| < 1e-2, |base_pos| < 1e-5, foot forces within 1%
of body weight) on robots whose soles are pressed 1 mm into the ground, so
that every contact is active in both versions (see test_torch_control_step).
"""
import numpy as np
import pytest
import torch

from humanoid_tpu_torch.ops import linalg
from humanoid_tpu_torch.ops.physics_kernel import ControlStepKernel, n_points, pack_body, pack_state
from humanoid_tpu_torch.ops.terrain_sampler import TerrainSampler
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.physics.pgs import PGSParams
from humanoid_tpu_torch.utils import registry

N = 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _loaded_feet(kernel, model, device, planes=None, N=N, default_pos=0.0):
    rng = np.random.default_rng(0)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device).contiguous()

    qj = default_pos + rng.uniform(-0.05, 0.05, (N, model.nj))
    masses = np.tile(model.mass, (N, 1))
    masses[:, 0] += rng.uniform(-5.0, 5.0, N)
    phys = PhysState(t(np.c_[np.zeros((N, 2)), np.full(N, 0.90)]),
                     t(np.tile([1.0, 0.0, 0.0, 0.0], (N, 1))), t(qj),
                     torch.zeros(N, model.nv, device=device))
    pack, m, f, tg = pack_state(phys), t(masses), t(rng.uniform(0.1, 2.0, N)), t(qj)
    for _ in range(30):
        pack, _ = kernel.plain(pack, m, f, tg, 10, True, True, planes=planes)
    pack = pack.clone()
    pack[2] -= 1e-3
    return pack, m, f, tg


@pytest.mark.cuda
@pytest.mark.parametrize("instance", [(1, False, False), (10, True, True), (10, True, False)])
def test_cuda_kernel_matches_plain(cuda_device, instance):
    env, _, _ = registry.make_env("humanoid_ppo", device=cuda_device)
    k = ControlStepKernel(env.model, *env.physics.gains, env.physics.contact_params,
                          env.physics.pgs_params, env.physics.dt)
    inputs = _loaded_feet(k, env.model, cuda_device)
    a, da = k(*inputs, *instance)
    b, db = k.plain(*inputs, *instance)
    torch.cuda.synchronize()
    assert k.launches == 1
    weight = env.model.total_mass * 9.81
    assert float((a[19:] - b[19:]).abs().max()) < 1e-2
    assert float((a[0:3] - b[0:3]).abs().max()) < 1e-5
    assert float((da.foot_forces - db.foot_forces).abs().max()) < 0.01 * weight
    for x, y in zip(da, db):
        assert x.shape == y.shape and bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_cuda_wrapper_checks_inputs(cuda_device):
    env, _, _ = registry.make_env("humanoid_ppo", device=cuda_device)
    k = env.physics
    pack = torch.zeros(37, 64, device=cuda_device)
    masses = torch.zeros(64, 13, device=cuda_device)
    fric = torch.zeros(64, device=cuda_device)
    tg = torch.zeros(64, 12, device=cuda_device)
    with pytest.raises(ValueError):
        k(pack.double(), masses, fric, tg, 10)
    with pytest.raises(ValueError):
        k(pack, masses.T, fric, tg, 10)
    with pytest.raises(ValueError):
        k(pack, masses, fric, tg[:, :6], 10)
    assert k.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("instance", [(1, False, False), (10, True, True)])
def test_cuda_kernel_with_gains_body_planes_matches_plain(cuda_device, instance):
    """Random per-env gains and bodies, robots pressed 1 mm into a ramp
    (planes with gradient (0.05, -0.05))."""
    env, _, _ = registry.make_env("humanoid_ppo", device=cuda_device)
    m = env.model
    k = ControlStepKernel(m, *env.physics.gains, env.physics.contact_params,
                          env.physics.pgs_params, env.physics.dt)
    rng = np.random.default_rng(1)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=cuda_device).contiguous()

    planes = t(np.tile([0.0, 0.05, -0.05], (N, n_points(m))))
    inputs = _loaded_feet(k, m, cuda_device, planes)
    kp, kd = env.physics.gains[:2]
    gains = t(np.concatenate([kp * rng.uniform(0.8, 1.2, (N, m.nj)),
                              kd * rng.uniform(0.8, 1.2, (N, m.nj)),
                              np.repeat(rng.uniform(0.8, 1.2, (N, 1)), m.nj, axis=1)], axis=1))
    com = np.tile(m.com, (N, 1, 1))
    com[:, 0] += rng.uniform(-0.03, 0.03, (N, 3))
    inertia = np.tile(m.inertia, (N, 1, 1, 1)) * 1.1
    body = pack_body(t(com), t(inertia)).contiguous()
    a, da = k(*inputs, *instance, gains=gains, body=body, planes=planes)
    b, db = k.plain(*inputs, *instance, gains=gains, body=body, planes=planes)
    torch.cuda.synchronize()
    assert k.launches == 1
    weight = m.total_mass * 9.81
    assert float((a[19:] - b[19:]).abs().max()) < 1e-2
    assert float((a[0:3] - b[0:3]).abs().max()) < 1e-5
    assert float((da.foot_forces - db.foot_forces).abs().max()) < 0.01 * weight
    with pytest.raises(ValueError):
        k(*inputs, *instance, gains=gains[:, :12].contiguous())


@pytest.mark.cuda
def test_cuda_sampler_matches_plain(cuda_device):
    """The humanoid_ppo_terrain world, points over every cell: exact."""
    env, cfg, _ = registry.make_env("humanoid_ppo_terrain", device=cuda_device)
    w = env.terrain_world
    s = TerrainSampler(w.height, cfg.terrain.vertical_scale, w.horizontal_scale, w.border,
                       device=cuda_device)
    rng = np.random.default_rng(2)
    base = rng.uniform(0.0, [w.num_rows * w.terrain_length, w.num_cols * w.terrain_length],
                       (N, 2))
    scan = torch.as_tensor(base[:, None] + rng.uniform(-1, 1, (N, 187, 2)), dtype=torch.float32,
                           device=cuda_device).contiguous()
    con = torch.as_tensor(base[:, None] + rng.uniform(-0.5, 0.5, (N, 9, 2)), dtype=torch.float32,
                          device=cuda_device).contiguous()
    a_scan, a_corners = s(scan, con)
    b_scan, b_corners = s.plain(scan, con)
    torch.cuda.synchronize()
    assert s.launches == 1
    assert torch.equal(a_scan, b_scan)
    assert all(torch.equal(x, y) for x, y in zip(a_corners, b_corners))
    with pytest.raises(ValueError):
        s(scan.double(), con)


# ---------------------------------------------------------------------------
# the batched Cholesky kernels (csrc/linalg.cu) and the penalty instance, at
# the shipping 4096 envs

ENVS = 4096


def _spd(n, count, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(count, n, n)))
    eig = np.exp(rng.uniform(0.0, np.log(cond), (count, n)))
    eig[:, 0], eig[:, -1] = 1.0, cond
    return (Q * eig[:, None, :] @ np.swapaxes(Q, 1, 2)).astype(np.float32), \
        rng.normal(size=(count, n)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cond", [(18, 1e2), (18, 1e5), (24, 1e3)])
def test_cuda_linalg_matches_plain(cuda_device, n, cond):
    """B3, B4 and B5 vs their plain versions: the factor to 1e-4 of its
    largest entry, solutions to max(1e-5, eps cond) of theirs, eps the
    float32 machine epsilon (two float32 algorithms, each within ~eps cond
    of the exact solution; chip_smoke.py's bound)."""
    M, b = (torch.as_tensor(x, device=cuda_device) for x in _spd(n, ENVS, cond, n))
    tol = max(1e-5, float(np.finfo(np.float32).eps) * cond)
    k = linalg.CholeskyKernels()
    L = k.factor_spd_batch(M)
    Lp = linalg.chol_factor_unrolled(M)
    x = k.apply_spd_batch(Lp, b)
    xp = linalg.chol_apply_unrolled(Lp, b)
    xs = k.solve_spd_batch(M, b)
    xsp = linalg.chol_solve_unrolled(M, b)
    torch.cuda.synchronize()
    assert k.launches == {"chol_factor": 1, "chol_apply": 1, "chol_solve": 1}
    assert float((L - Lp).abs().max()) < 1e-4 * float(Lp.abs().max())
    assert bool((torch.triu(L, 1) == 0).all())
    assert float((x - xp).abs().max()) < tol * float(xp.abs().max())
    assert float((xs - xsp).abs().max()) < tol * float(xsp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("count,n", [(4093, 18), (4095, 24), (4098, 24), (3, 6)])
def test_cuda_solve_tail_blocks_match_plain(cuda_device, count, n):
    """B5 (a warp per env, several envs per block) at counts of envs that
    leave a part-filled last block, and at n = 24, the widest it takes; the
    upper triangle of M is never read (NaN there changes nothing); a
    second launch gives the same bits."""
    M, b = (torch.as_tensor(x, device=cuda_device) for x in _spd(n, count, 1e3, count + n))
    k = linalg.CholeskyKernels()
    assert k.design("chol_solve").startswith("a warp per env")
    xs = k.solve_spd_batch(M, b)
    upper_nan = M.clone()
    rows, cols = torch.triu_indices(n, n, 1, device=cuda_device)
    upper_nan[:, rows, cols] = float("nan")
    xs2 = k.solve_spd_batch(upper_nan, b)
    xsp = linalg.chol_solve_unrolled(M, b)
    torch.cuda.synchronize()
    assert k.launches["chol_solve"] == 2
    tol = max(1e-5, float(np.finfo(np.float32).eps) * 1e3)
    assert float((xs - xsp).abs().amax(1).div(xsp.abs().amax(1)).max()) < tol
    assert torch.equal(xs, xs2)


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("count,n", [(4093, 18), (4095, 18), (4098, 18), (4093, 24), (4095, 24),
                                     (4098, 24), (3, 6)])
def test_cuda_factor_apply_tail_blocks_match_plain(cuda_device, count, n):
    """B3 and B4 (a warp per env, several envs per block) at counts of envs
    that leave a part-filled last block, and at n = 24, the widest they
    take; the last env, in the tail block, is not positive definite and
    gives NaN, with exact zeros above the diagonal of L all the same; the
    apply never reads the upper triangle of L (NaN there gives the same
    bits); a second launch gives the same bits."""
    M, b = (torch.as_tensor(x, device=cuda_device) for x in _spd(n, count, 1e3, count + n))
    M[-1, 2, 2] = -1.0
    k = linalg.CholeskyKernels()
    assert k.design("chol_factor").startswith("a warp per env")
    assert k.design("chol_apply").startswith("a warp per env")
    L, L2 = k.factor_spd_batch(M), k.factor_spd_batch(M)
    Lp = linalg.chol_factor_unrolled(M)
    x, x2 = k.apply_spd_batch(Lp, b), k.apply_spd_batch(Lp, b)
    upper_nan = Lp.clone()
    rows, cols = torch.triu_indices(n, n, 1, device=cuda_device)
    upper_nan[:, rows, cols] = float("nan")
    x3 = k.apply_spd_batch(upper_nan, b)
    xp = linalg.chol_apply_unrolled(Lp, b)
    torch.cuda.synchronize()
    assert k.launches == {"chol_factor": 2, "chol_apply": 3, "chol_solve": 0}
    spd = slice(0, count - 1)
    assert float((L[spd] - Lp[spd]).abs().amax((1, 2)).div(Lp[spd].abs().amax((1, 2))).max()) \
        < 1e-4
    tol = max(1e-5, float(np.finfo(np.float32).eps) * 1e3)
    assert float((x[spd] - xp[spd]).abs().amax(1).div(xp[spd].abs().amax(1)).max()) < tol
    assert bool(torch.isfinite(L[spd]).all()) and bool(torch.isfinite(x[spd]).all())
    assert bool(torch.isnan(L[-1]).any()) and bool(torch.isnan(x[-1]).any())
    assert bool((torch.triu(L, 1) == 0).all())
    assert torch.equal(_bits(L), _bits(L2))
    assert torch.equal(_bits(x), _bits(x2)) and torch.equal(_bits(x), _bits(x3))


@pytest.mark.cuda
def test_cuda_linalg_gives_nan_on_non_spd_and_checks_inputs(cuda_device):
    M, b = (torch.as_tensor(x, device=cuda_device) for x in _spd(18, 64, 1e2, 1))
    M[1, 7, 7] = -1.0
    M[2] = 0.0
    k = linalg.CholeskyKernels()
    xs = k.solve_spd_batch(M, b)
    L = k.factor_spd_batch(M)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xs[0]).all()) and bool(torch.isfinite(L[0]).all())
    assert all(bool(torch.isnan(xs[i]).any()) and bool(torch.isnan(L[i]).any()) for i in (1, 2))
    with pytest.raises(ValueError):
        k.solve_spd_batch(M.double(), b.double())
    with pytest.raises(ValueError):
        k.apply_spd_batch(M.transpose(1, 2), b)
    with pytest.raises(ValueError):
        k.factor_spd_batch(torch.zeros(4, 25, 25, device=cuda_device))
    assert k.launches == {"chol_factor": 1, "chol_apply": 0, "chol_solve": 1}


def _penalty_kernel(device):
    env, _, _ = registry.make_env("humanoid_ppo_penalty", device=device)
    p = env.physics
    return env, ControlStepKernel(env.model, *p.gains, p.contact_params, None, p.dt)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", [(1, False, False), (10, True, True), (10, False, False)])
def test_cuda_penalty_kernel_matches_plain(cuda_device, instance):
    """The penalty instance vs engine.control_step_batch at 4096 envs, on
    robots pressed 1 mm into the flat ground."""
    env, k = _penalty_kernel(cuda_device)
    pgs = ControlStepKernel(env.model, *k.gains, k.contact_params, PGSParams(iterations=6), k.dt)
    inputs = _loaded_feet(pgs, env.model, cuda_device, N=ENVS)
    a, da = k(*inputs, *instance)
    b, db = k.plain(*inputs, *instance)
    torch.cuda.synchronize()
    assert k.launches == 1
    weight = env.model.total_mass * 9.81
    assert float((a[19:] - b[19:]).abs().max()) < 1e-2
    assert float((a[0:3] - b[0:3]).abs().max()) < 1e-5
    assert float((da.foot_forces - db.foot_forces).abs().max()) < 0.01 * weight
    assert float(db.foot_forces[..., 2].min()) > 0.1 * weight


@pytest.mark.cuda
def test_cuda_penalty_kernel_with_gains_body_planes_matches_plain(cuda_device):
    """The penalty instance with random gains and bodies on a ramp (planes
    with gradient (0.05, -0.05)) at 4096 envs."""
    env, k = _penalty_kernel(cuda_device)
    m = env.model
    pgs = ControlStepKernel(m, *k.gains, k.contact_params, PGSParams(iterations=6), k.dt)
    rng = np.random.default_rng(1)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=cuda_device).contiguous()

    planes = t(np.tile([0.0, 0.05, -0.05], (ENVS, n_points(m))))
    inputs = _loaded_feet(pgs, m, cuda_device, planes, N=ENVS)
    kp, kd = k.gains[:2]
    gains = t(np.concatenate([kp * rng.uniform(0.8, 1.2, (ENVS, m.nj)),
                              kd * rng.uniform(0.8, 1.2, (ENVS, m.nj)),
                              np.repeat(rng.uniform(0.8, 1.2, (ENVS, 1)), m.nj, axis=1)], axis=1))
    com = np.tile(m.com, (ENVS, 1, 1))
    com[:, 0] += rng.uniform(-0.03, 0.03, (ENVS, 3))
    body = pack_body(t(com), t(np.tile(m.inertia, (ENVS, 1, 1, 1)) * 1.1)).contiguous()
    a, da = k(*inputs, 10, True, True, gains=gains, body=body, planes=planes)
    b, db = k.plain(*inputs, 10, True, True, gains=gains, body=body, planes=planes)
    c, dc = k.plain(*inputs, 10, True, True, gains=gains, body=body)
    torch.cuda.synchronize()
    weight = m.total_mass * 9.81
    assert float((a[19:] - b[19:]).abs().max()) < 1e-2
    assert float((a[0:3] - b[0:3]).abs().max()) < 1e-5
    assert float((da.foot_forces - db.foot_forces).abs().max()) < 0.01 * weight
    # control: without the planes the plain version falls outside the bounds
    assert float((a[19:] - c[19:]).abs().max()) >= 1e-2 \
        or float((da.foot_forces - dc.foot_forces).abs().max()) >= 0.01 * weight


@pytest.mark.cuda
@pytest.mark.parametrize("instance", [(10, True, True), (10, False, False)])
def test_cuda_warm_kernel_matches_plain(cuda_device, instance):
    """The warm-started PGS instance (PGSParams.warm_start) vs the plain
    warm control step at 4096 envs, on robots pressed 1 mm into the flat
    ground; control: the cold plain version falls outside the bounds."""
    env, _, _ = registry.make_env("humanoid_ppo", device=cuda_device)
    p = env.physics
    cold = ControlStepKernel(env.model, *p.gains, p.contact_params, p.pgs_params, p.dt)
    k = ControlStepKernel(env.model, *p.gains, p.contact_params,
                          p.pgs_params._replace(warm_start=True), p.dt)
    inputs = _loaded_feet(cold, env.model, cuda_device, N=ENVS)
    a, da = k(*inputs, *instance)
    b, db = k.plain(*inputs, *instance)
    c, dc = cold.plain(*inputs, *instance)
    torch.cuda.synchronize()
    assert k.launches == 1 and cold.launches == 0
    weight = env.model.total_mass * 9.81
    assert float((a[19:] - b[19:]).abs().max()) < 1e-2
    assert float((a[0:3] - b[0:3]).abs().max()) < 1e-5
    assert float((da.foot_forces - db.foot_forces).abs().max()) < 0.01 * weight
    assert float((a[19:] - c[19:]).abs().max()) >= 1e-2 \
        or float((a[0:3] - c[0:3]).abs().max()) >= 1e-5 \
        or float((da.foot_forces - dc.foot_forces).abs().max()) >= 0.01 * weight


TEAM_CASES = {   # instance, contact model (cold or warm PGS, penalty), gains/body/planes
    "shipping": ((10, True, True), "cold", False),
    "exact": ((1, False, False), "cold", False),
    "unfrozen-prep": ((10, True, False), "cold", False),
    "warm": ((10, True, True), "warm", False),
    "extras": ((10, True, True), "cold", True),
    "warm-extras": ((10, True, True), "warm", True),
    "penalty": ((10, True, True), "penalty", False),
    "penalty-unfrozen": ((10, False, False), "penalty", False),
    "penalty-extras": ((10, True, True), "penalty", True),
    "penalty-extras-exact": ((1, False, False), "penalty", True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 256, 4093])
@pytest.mark.parametrize("case", list(TEAM_CASES))
def test_cuda_team_kernel_matches_plain(cuda_device, case, n):
    """The team kernels (PGS cold and warm, penalty) vs the plain version,
    at a count of envs that fills their blocks and ones that leave tail
    teams in the last block (4093; 37, and 1 as `play` runs): shipping, exact, unfrozen prep or
    factor, and with random gains and bodies on a ramp. A tail team that
    wrote its env N + j would overwrite env j's next output row; two
    launches give the same bits."""
    _check_team_kernel(cuda_device, "humanoid_ppo", case, n)


def _check_team_kernel(cuda_device, task, case, n):
    instance, model_kind, extras = TEAM_CASES[case]
    env, cfg, _ = registry.make_env(task, device=cuda_device)
    m, p = env.model, env.physics
    default_pos = np.asarray(cfg.init_state.default_joint_angles)
    params = None if model_kind == "penalty" else p.pgs_params._replace(
        warm_start=model_kind == "warm")
    k = ControlStepKernel(m, *p.gains, p.contact_params, params, p.dt)
    assert k.design().startswith("team of")
    rng = np.random.default_rng(3)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=cuda_device).contiguous()

    kw = {}
    if extras:
        kw["planes"] = t(np.tile([0.0, 0.05, -0.05], (n, n_points(m))))
        kp, kd = p.gains[:2]
        kw["gains"] = t(np.concatenate([kp * rng.uniform(0.8, 1.2, (n, m.nj)),
                                        kd * rng.uniform(0.8, 1.2, (n, m.nj)),
                                        np.repeat(rng.uniform(0.8, 1.2, (n, 1)), m.nj, axis=1)],
                                       axis=1))
        com = np.tile(m.com, (n, 1, 1))
        com[:, 0] += rng.uniform(-0.03, 0.03, (n, 3))
        kw["body"] = pack_body(t(com), t(np.tile(m.inertia, (n, 1, 1, 1)) * 1.1)).contiguous()
    # penalty: settled on the PGS contact, as the other penalty tests
    settle_with = k if params is not None else ControlStepKernel(m, *p.gains, p.contact_params,
                                                                 p.pgs_params, p.dt)
    inputs = _loaded_feet(settle_with, m, cuda_device, kw.get("planes"), N=n,
                          default_pos=default_pos)
    a, da = k(*inputs, *instance, **kw)
    a2, da2 = k(*inputs, *instance, **kw)
    b, db = k.plain(*inputs, *instance, **kw)
    torch.cuda.synchronize()
    assert k.launches == 2
    assert torch.equal(a, a2) and torch.equal(da.foot_forces, da2.foot_forces)
    weight = m.total_mass * 9.81
    u0 = 7 + m.nj
    assert float((a[u0:] - b[u0:]).abs().max()) < 1e-2
    assert float((a[0:3] - b[0:3]).abs().max()) < 1e-5
    assert float((da.foot_forces - db.foot_forces).abs().max()) < 0.01 * weight
    for x, y in zip(da, db):
        assert x.shape == y.shape and bool(torch.isfinite(x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 4093])
@pytest.mark.parametrize("case", ["shipping", "exact", "warm", "extras", "penalty",
                                  "penalty-extras"])
def test_cuda_18dof_team_kernel_matches_plain(cuda_device, case, n):
    """The team kernels on the 18-dof robot of d11_ppo (nj = 18, nv = 24;
    four branches off the base: the penalty team's chain schedule has its
    arm lanes), settled in the d11 pose: the same checks as
    test_cuda_team_kernel_matches_plain, with gains, body and planes
    (d12_ppo runs gains and body)."""
    _check_team_kernel(cuda_device, "d11_ppo", case, n)


@pytest.mark.cuda
def test_cuda_factor_apply_on_18dof_mass_matrices(cuda_device):
    """B3 and B4 at n = 24 on the mass matrices of 4096 settled 18-dof
    robots (the engine path's inputs), against the plain versions: within
    4e-6 of each env's largest entry (chip_smoke.py's bound on settled mass
    matrices), the same bits on repeat."""
    from humanoid_tpu_torch.ops.physics_kernel import unpack_state
    from humanoid_tpu_torch.physics.dynamics import assemble_mass_matrix, compute_kinematics_bias
    from humanoid_tpu_torch.physics.kinematics import RobotTensors

    env, cfg, _ = registry.make_env("d11_ppo", device=cuda_device)
    m, p = env.model, env.physics
    pack, masses, _, _ = _loaded_feet(p, m, cuda_device, N=ENVS,
                                      default_pos=np.asarray(cfg.init_state.default_joint_angles))
    st = unpack_state(pack, m.nj)
    rt = RobotTensors.from_model(m, cuda_device)
    out = compute_kinematics_bias(rt, st.base_pos, st.base_quat, st.qj, st.u, mass=masses)
    M, b = assemble_mass_matrix(rt, out[2], out[3]).contiguous(), (-out[5]).contiguous()
    assert M.shape == (ENVS, 24, 24)
    k = linalg.CholeskyKernels()
    L, L2 = k.factor_spd_batch(M), k.factor_spd_batch(M)
    Lp = linalg.chol_factor_unrolled(M)
    x, x2 = k.apply_spd_batch(Lp, b), k.apply_spd_batch(Lp, b)
    xp = linalg.chol_apply_unrolled(Lp, b)
    torch.cuda.synchronize()
    assert k.launches == {"chol_factor": 2, "chol_apply": 2, "chol_solve": 0}
    assert float((L - Lp).abs().amax((1, 2)).div(Lp.abs().amax((1, 2))).max()) < 4e-6
    assert float((x - xp).abs().amax(1).div(xp.abs().amax(1)).max()) < 4e-6
    assert torch.equal(_bits(L), _bits(L2)) and torch.equal(_bits(x), _bits(x2))
    assert bool((torch.triu(L, 1) == 0).all())
