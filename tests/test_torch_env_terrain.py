"""The humanoid_ppo_terrain env: port vs reference, at 8 envs.

Both envs take `humanoid_ppo_terrain`'s config with obs noise, pushes,
action delay and action noise off, and `lag_timesteps=0` so that the lag
ring's random index is always 0. The reference's `initial_state` is carried
across field by field, and both take the same actions. The reference runs
on its XLA path: the heightfield is sampled bilinearly at every substep and
the height scan by Terrain.sample_min3; the port takes one plane per
contact point per control step from its sampler (the reference kernel's
semantics) and its scan from the same sampler call.

(a) On an exactly linear ramp (one 5 mm count per 0.1 m cell in x, minus
    one in y) a per-substep bilinear sample and a per-control-step tangent
    plane are the same surface, so the step is held to the port's env
    bounds: dones exactly, obs, critic obs (height scan included), rewards
    and reward sums at atol 1e-4, over 5 steps. The contact prep is exact
    in both, as the reference's XLA path has no frozen prep.
(b) On the task's own curriculum world (seed 5) the two ground models
    differ by the tangent-plane approximation, and the trajectory stays
    within the reference package's kernel-vs-XLA bounds
    (tests/test_physics_kernel.py: max |dqj| < 0.05 over 20 steps and the
    median base heights within 0.01 m); the port runs the task's shipping
    frozen contact prep.
(c) Unit cases: the domain-randomization draws, which envs redraw their
    gains, the lag ring, the curriculum step against the reference's rule
    (demote_prob 1, random_level_frac 0, so that it is deterministic), and
    the reset origins and jitter. Then the task trains one iteration on
    the CPU through the CLI, and humanoid_ppo_trimesh builds and steps.
(d) humanoid_ppo_trimesh on its own world (walls where a cell edge rises
    more than slope_treshold x horizontal_scale = 0.075 m): the same
    trajectory bounds and equal resets as (b), and its contact planes
    against the reference's, with the c0 bound scaled by |gx x| + |gy y|
    (see _assert_trimesh_planes_close).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_tpu.env import terrain as jterrain
from humanoid_tpu.env.xbotl import XBotLEnv as JaxEnv
from humanoid_tpu.physics.contact import Terrain as JTerrain
from humanoid_tpu.physics.kinematics import fk as jfk
from humanoid_tpu.physics.spatial import quat_rotate as jquat_rotate
from humanoid_tpu.utils import registry as jreg
from humanoid_tpu_torch.assets import write_xbot_topology_urdf
from humanoid_tpu_torch.env import terrain as tterrain
from humanoid_tpu_torch.env.xbotl import EnvState, XBotLEnv, lag_push
from humanoid_tpu_torch.physics.contact import Terrain
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.utils import registry

N = 8
ATOL = 1e-4
TASK = "humanoid_ppo_terrain"


def make_cfg(cfg, urdf, freeze_prep, **sim):
    r = dataclasses.replace
    return cfg.replace(
        env=r(cfg.env, num_envs=N), asset=r(cfg.asset, urdf=urdf),
        sim=r(cfg.sim, pgs_freeze_prep=freeze_prep, **sim),
        domain_rand=r(cfg.domain_rand, action_delay=False, dynamic_randomization=0.0,
                      push_robots=False, lag_timesteps=0),
        noise=r(cfg.noise, add_noise=False),
        terrain=r(cfg.terrain, demote_prob=1.0, random_level_frac=0.0),
    )


def ramp_world(tc):
    """The task's world layout with an exactly linear ramp for ground:
    count = i - j, so h = 0.05 (x + border) - 0.05 (y + border)."""
    size_px = int(tc.terrain_length / tc.horizontal_scale)
    border_px = int(tc.border_size / tc.horizontal_scale)
    H = tc.num_rows * size_px + 2 * border_px
    W = tc.num_cols * size_px + 2 * border_px
    height = (np.arange(H)[:, None] - np.arange(W)[None, :]) * tc.vertical_scale
    origins = np.zeros((tc.num_rows, tc.num_cols, 3))
    for i in range(tc.num_rows):
        for j in range(tc.num_cols):
            cx, cy = (i + 0.5) * tc.terrain_length, (j + 0.5) * tc.terrain_length
            origins[i, j] = [cx, cy, 0.05 * cx - 0.05 * cy]
    return height, origins


def build_pair(urdf, freeze_prep, world, task=TASK, **sim):
    """(reference env, port env) of `task` on `world` = (height, origins)
    or None for the task's generated world; `sim` overrides its SimCfg. A
    trimesh task's walls rise at slope_treshold x horizontal_scale."""
    jc = make_cfg(jreg.get_cfgs(task)[0], urdf, freeze_prep, **sim)
    tc = make_cfg(registry.get_cfgs(task)[0], urdf, freeze_prep, **sim)
    wall = (tc.terrain.slope_treshold * tc.terrain.horizontal_scale
            if tc.terrain.mesh_type == "trimesh" else 0.0)
    if world is None:
        jw = jterrain.build_terrain(jc.terrain, seed=jc.seed)
        tw = tterrain.build_terrain(tc.terrain, seed=tc.seed)
    else:
        height, origins = world
        kw = dict(horizontal_scale=tc.terrain.horizontal_scale, border=tc.terrain.border_size,
                  env_origins=origins, num_rows=tc.terrain.num_rows,
                  num_cols=tc.terrain.num_cols, terrain_length=tc.terrain.terrain_length)
        jw = jterrain.TerrainWorld(height=height, **kw)
        tw = tterrain.TerrainWorld(height=height, **kw)
    jenv = JaxEnv(jc, terrain=JTerrain(height=jnp.asarray(jw.height, dtype=jnp.float32),
                                        horizontal_scale=jw.horizontal_scale, border=jw.border,
                                        flat=False, wall_thresh=wall), terrain_world=jw)
    tenv = XBotLEnv(tc, urdf, device="cpu",
                    terrain=Terrain.heightfield(tw.height, tw.horizontal_scale, tw.border,
                                                wall_thresh=wall),
                    terrain_world=tw)
    return jenv, tenv


def to_port_state(js, tenv) -> EnvState:
    """The reference's state field by field; on the kernel path the contact
    planes (which the reference's XLA path does not carry) from the port's
    sampler."""
    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)

    phys = PhysState(*(t(x) for x in js.phys))
    skip = ("phys", "common_step", "terrain_planes")
    fields = {f: t(getattr(js, f)) for f in EnvState._fields if f not in skip}
    planes = tenv.contact_planes(phys) if tenv.kernel_planes else None
    return EnvState(phys=phys, common_step=t(js.common_step, torch.int64),
                    terrain_planes=planes, **fields)


def run_pair(jenv, tenv, js, steps, actions, key0):
    step = jax.jit(jenv.step)
    ts = to_port_state(js, tenv)
    gen = torch.Generator().manual_seed(0)
    out = []
    for i in range(steps):
        a = actions(i)
        js, jo = step(js, jnp.asarray(a), jax.random.PRNGKey(key0 + i))
        ts, to = tenv.step(ts, torch.as_tensor(a), gen)
        out.append((js, jo, ts, to))
    return step, out


@pytest.fixture(scope="module")
def urdf(tmp_path_factory):
    return write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf")))


@pytest.fixture(scope="module")
def ramp(urdf):
    tc = registry.get_cfgs(TASK)[0].terrain
    jenv, tenv = build_pair(urdf, False, ramp_world(tc))
    js = jenv.initial_state(jax.random.PRNGKey(3))
    # stand the robots 0.91 m above the ramp under their base, so that
    # their feet land within the 5 steps
    bp = np.array(js.phys.base_pos)
    bp[:, 2] = 0.05 * bp[:, 0] - 0.05 * bp[:, 1] + 0.91
    js = js._replace(phys=js.phys._replace(base_pos=jnp.asarray(bp)))
    rng = np.random.default_rng(1)
    acts = [rng.uniform(-0.5, 0.5, (N, 12)).astype(np.float32) for _ in range(5)]
    step, out = run_pair(jenv, tenv, js, 5, lambda i: acts[i], 100)
    return jenv, tenv, step, out


@pytest.mark.parametrize("k", range(5))
def test_ramp_step_matches_reference(ramp, k):
    _, _, _, out = ramp
    js, jo, ts, to = out[k]
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_array_equal(to.time_outs.numpy(), np.asarray(jo.time_outs))
    np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=ATOL)
    np.testing.assert_allclose(to.privileged_obs.numpy(), np.asarray(jo.privileged_obs), atol=ATOL)
    np.testing.assert_allclose(to.rew.numpy(), np.asarray(jo.rew), atol=ATOL)
    np.testing.assert_allclose(to.rew_terms_mean.numpy(), np.asarray(jo.rew_terms_mean), atol=ATOL)


def test_ramp_reward_sums_and_scan(ramp):
    _, tenv, _, out = ramp
    js, jo, ts, to = out[-1]
    sums_t, sums_j = ts.episode_sums.numpy(), np.asarray(js.episode_sums)
    for i, name in enumerate(tenv.reward_names):
        np.testing.assert_allclose(sums_t[:, i], sums_j[:, i], atol=ATOL, err_msg=name)
    # the newest critic frame ends with the 187-point scan, and on the
    # ramp it is not constant
    scan = to.privileged_obs[:, -187:]
    assert to.privileged_obs.shape == (N, 780)
    assert float(scan.std(dim=1).min()) > 0.01
    # every robot has a foot on the ground by the last step (the newest
    # frame's contact flags sit before its scan)
    contact = to.privileged_obs[:, -187 - 2:-187]
    assert float(contact.amax(dim=1).min()) == 1.0


@pytest.fixture(scope="module")
def curriculum(urdf):
    """(reference env, port env) on the task's generated world (seed 5)."""
    return build_pair(urdf, True, None)


def test_curriculum_world_tracks_reference(curriculum):
    """The task's generated world, 20 steps: the reference's kernel-vs-XLA
    trajectory bounds."""
    jenv, tenv = curriculum
    js = jenv.initial_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    acts = [0.3 * rng.standard_normal((N, 12)).astype(np.float32) for _ in range(20)]
    _, out = run_pair(jenv, tenv, js, 20, lambda i: acts[i], 200)
    max_dq = max(float(np.abs(np.asarray(j.phys.qj) - t.phys.qj.numpy()).max())
                 for j, _, t, _ in out)
    js, _, ts, _ = out[-1]
    dz = abs(float(np.median(np.asarray(js.phys.base_pos[:, 2])))
             - float(ts.phys.base_pos[:, 2].median()))
    assert max_dq < 0.05, max_dq
    assert dz < 0.01, dz
    for j, jo, t, to in out:
        np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))


@pytest.fixture(scope="module")
def engine_world(urdf):
    """The engine path (use_pallas_substep=False) on the task's generated
    world with all its randomizations: both envs sample the heightfield at
    every substep and build the PGS prep every substep (the reference
    ignores the task's pgs_freeze_prep there). The robots stand 0.91 m
    above the ground under their base, so that their feet land."""
    jenv, tenv = build_pair(urdf, True, None, use_pallas_substep=False)
    js = jenv.initial_state(jax.random.PRNGKey(5))
    bp = np.array(js.phys.base_pos)
    bp[:, 2] = np.asarray(jenv.terrain.sample(jnp.asarray(bp[:, 0:2]))) + 0.91
    js = js._replace(phys=js.phys._replace(base_pos=jnp.asarray(bp)))
    rng = np.random.default_rng(4)
    acts = [rng.uniform(-0.5, 0.5, (N, 12)).astype(np.float32) for _ in range(5)]
    _, out = run_pair(jenv, tenv, js, 5, lambda i: acts[i], 300)
    return jenv, tenv, out


@pytest.mark.parametrize("k", range(5))
def test_engine_path_step_matches_reference_on_curriculum_world(engine_world, k):
    _, tenv, out = engine_world
    js, jo, ts, to = out[k]
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=ATOL)
    np.testing.assert_allclose(to.privileged_obs.numpy(), np.asarray(jo.privileged_obs), atol=ATOL)
    np.testing.assert_allclose(to.rew.numpy(), np.asarray(jo.rew), atol=ATOL)
    assert ts.terrain_planes is None and tenv.physics.launches == 0


def test_engine_path_on_curriculum_world_lands_and_scans(engine_world):
    jenv, tenv, out = engine_world
    js, _, ts, to = out[-1]
    sums_t, sums_j = ts.episode_sums.numpy(), np.asarray(js.episode_sums)
    for i, name in enumerate(tenv.reward_names):
        np.testing.assert_allclose(sums_t[:, i], sums_j[:, i], atol=ATOL, err_msg=name)
    contact = to.privileged_obs[:, -187 - 2:-187]
    assert float(contact.amax(dim=1).min()) == 1.0
    # the scan sees relief under some of the robots
    assert float(to.privileged_obs[:, -187:].std(dim=1).max()) > 0.01


def _reference_planes(jenv, xy):
    """The reference's contact planes [c0, gx, gy] (N, 3P) at the contact
    points xy (N, P, 2): its Terrain.sample_with_grad and c0 rule."""
    h, gx, gy = jenv.terrain.sample_with_grad(xy)
    c0 = h - gx * xy[..., 0] - gy * xy[..., 1]
    return np.asarray(jnp.stack([c0, gx, gy], axis=-1)).reshape(xy.shape[0], -1)


def _reference_contact_xy(jenv, body_pos, body_quat):
    """World xy (N, P, 2) of the sole corners, then the termination
    spheres, at a body pose (N, nb, 3), (N, nb, 4): the reference's
    point order and formula."""
    m = jenv.model
    pt_body, pt_off = m.contact_points()
    bodies = [int(b) for b in pt_body] + [int(b) for b in m.term_sphere_body]
    offs = list(pt_off) + list(m.term_sphere_offset)
    pts = [body_pos[:, b] + jquat_rotate(body_quat[:, b], jnp.asarray(o, dtype=jnp.float32))
           for b, o in zip(bodies, offs)]
    return jnp.stack(pts, axis=1)[..., 0:2]


def _assert_planes_close(got, want):
    """Gradients to 1e-6; c0 = h - gx x - gy y to 5e-5, a few float32 ulps
    of its terms (|gx x| reaches ~35 m on this world)."""
    got, want = got.reshape(got.shape[0], -1, 3), want.reshape(want.shape[0], -1, 3)
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=5e-5)


def test_contact_planes_match_reference_on_curriculum_world(curriculum):
    """contact_planes (sampler corners -> interp_from_corners -> c0) vs the
    reference's _contact_planes on the same states: 64 robots spread over
    the whole world with random yaw and joint angles, so each contact
    point stands on its own plane."""
    jenv, tenv = curriculum
    n = 64
    rng = np.random.default_rng(11)
    w = tenv.terrain_world
    bp = np.c_[rng.uniform(0.0, w.num_rows * w.terrain_length, n),
               rng.uniform(0.0, w.num_cols * w.terrain_length, n), np.full(n, 0.9)]
    yaw = rng.uniform(-np.pi, np.pi, n)
    quat = np.c_[np.cos(yaw / 2), np.zeros((n, 2)), np.sin(yaw / 2)]
    qj = np.asarray(jenv.default_dof_pos) + rng.uniform(-0.3, 0.3, (n, 12))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    jphys = jenv.initial_state(jax.random.PRNGKey(4)).phys._replace(
        base_pos=jnp.asarray(f32(bp)), base_quat=jnp.asarray(f32(quat)),
        qj=jnp.asarray(f32(qj)), u=jnp.zeros((n, 18)))
    tphys = PhysState(*(torch.tensor(np.asarray(x)) for x in jphys))
    want = np.asarray(jenv._contact_planes(jphys))
    got = tenv.contact_planes(tphys).numpy()
    assert got.shape == (n, 27)
    _assert_planes_close(got, want)
    # the points stand on different ground
    assert float(np.abs(want.reshape(n, 9, 3)[..., 1:]).max()) > 0.1


def test_step_planes_match_reference_at_exit_positions(curriculum, monkeypatch):
    """The next step's planes from one env step: for live envs at the
    contact points of the kernel's last-substep pose, for a just-reset env
    (env 1) at the default-stance offsets from its fresh base; each held
    against the reference's planes at those points."""
    jenv, tenv = curriculum
    ts = to_port_state(jenv.initial_state(jax.random.PRNGKey(5)), tenv)
    u = ts.phys.u.clone()
    u[1, 7] = float("nan")              # resets this step
    ts = ts._replace(phys=ts.phys._replace(u=u))
    diags = []
    physics = tenv.physics

    def recording(*args, **kwargs):
        out = physics(*args, **kwargs)
        diags.append(out[1])
        return out

    monkeypatch.setattr(tenv, "physics", recording)
    t2, to = tenv.step(ts, torch.zeros(N, 12), torch.Generator().manual_seed(5))
    assert to.reset.tolist() == [False, True] + [False] * (N - 2)
    (diag,) = diags
    live = _reference_contact_xy(jenv, jnp.asarray(diag.body_pos.numpy()),
                                 jnp.asarray(diag.body_quat.numpy()))
    bp0, bq0 = jfk(jenv.model, jnp.zeros(3), jnp.array([1.0, 0.0, 0.0, 0.0]),
                   jenv.default_dof_pos)
    fresh = (jnp.asarray(t2.phys.base_pos.numpy())[:, None, 0:2]
             + _reference_contact_xy(jenv, bp0[None], bq0[None]))
    xy = jnp.where(jnp.asarray(to.reset.numpy())[:, None, None], fresh, live)
    _assert_planes_close(t2.terrain_planes.numpy(), _reference_planes(jenv, xy))


# ---------------------------------------------------------------------------
# unit cases


def test_dof_and_body_randomization_draws(ramp):
    _, tenv, _, _ = ramp
    dr = tenv.cfg.domain_rand
    gen = torch.Generator().manual_seed(4)
    ms, mo, kpf, kdf = tenv._sample_dof_rand(gen, 64)
    for x, rng in ((ms, dr.motor_strength_range), (mo, dr.motor_offset_range),
                   (kpf, dr.kp_factor_range), (kdf, dr.kd_factor_range)):
        assert x.shape == (64, 12)
        assert rng[0] <= float(x.min()) and float(x.max()) <= rng[1]
    assert torch.equal(ms, ms[:, :1].expand(64, 12))        # one strength per env
    assert float(mo.std(dim=1).min()) > 0.0                  # offsets per dof
    base = torch.as_tensor(tenv.model.mass, dtype=torch.float32).repeat(64, 1)
    masses, com, inertia = tenv._sample_body_rand(gen, 64, base)
    f = masses[:, 1:] / base[:, 1:]
    assert torch.equal(masses[:, 0], base[:, 0])
    assert torch.allclose(f, f[:, :1].expand_as(f), rtol=1e-6)
    lo, hi = dr.link_mass_range
    assert lo - 1e-6 <= float(f.min()) and float(f.max()) <= hi + 1e-6
    mcom = torch.as_tensor(tenv.model.com, dtype=torch.float32)
    off = com[:, 0] - mcom[0]
    for i, rng in enumerate((dr.added_com_range_x, dr.added_com_range_y, dr.added_com_range_z)):
        assert rng[0] - 1e-6 <= float(off[:, i].min()) and float(off[:, i].max()) <= rng[1] + 1e-6
    assert torch.equal(com[:, 1:], mcom[1:].expand(64, -1, -1))
    assert torch.equal(inertia, inertia.transpose(-1, -2))
    I0 = torch.as_tensor(tenv.model.inertia, dtype=torch.float32)
    nz = I0.abs() > 1e-9
    fac = (inertia / torch.where(nz, I0, 1.0))[:, nz]
    assert 0.8 - 1e-5 <= float(fac.min()) and float(fac.max()) <= 1.2 + 1e-5


def test_gains_redraw_on_reset_and_interval(ramp):
    _, tenv, _, out = ramp
    ts = out[-1][2]
    n = tenv.dof_rand_interval
    el = ts.episode_length.clone()
    el[0] = n - 1                       # reaches the interval this step
    u = ts.phys.u.clone()
    u[1, 7] = float("nan")              # resets this step
    s = ts._replace(episode_length=el, phys=ts.phys._replace(u=u))
    s2, o = tenv.step(s, torch.zeros(N, 12), torch.Generator().manual_seed(5))
    assert bool(o.reset[1]) and not bool(o.reset[0])
    for name in ("motor_strengths", "motor_offsets", "kp_factors", "kd_factors"):
        changed = (getattr(s2, name) != getattr(s, name)).any(dim=1)
        assert changed.tolist() == [True, True] + [False] * (N - 2), name
    assert torch.equal(s2.body_com, s.body_com) and torch.equal(s2.body_inertia,
                                                                s.body_inertia)


@pytest.mark.parametrize("idx", range(4))
def test_lag_ring_given_an_index(idx):
    rng = np.random.default_rng(idx)
    ring = rng.standard_normal((N, 4, 12)).astype(np.float32)
    new = rng.standard_normal((N, 12)).astype(np.float32)
    j_ring = jnp.concatenate([jnp.asarray(ring)[:, 1:], jnp.asarray(new)[:, None, :]], axis=1)
    j_sel = jax.lax.dynamic_index_in_dim(j_ring, idx, axis=1, keepdims=False)
    t_ring, t_sel = lag_push(torch.as_tensor(ring), torch.as_tensor(new), torch.tensor([idx]))
    np.testing.assert_array_equal(t_ring.numpy(), np.asarray(j_ring))
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))


def test_curriculum_step_matches_reference_rule(ramp):
    """Envs 0-2 time out (0: tracked well under a walk command -> up;
    1: tracked badly -> stay; 2: stand command -> stay), envs 3-4 fall
    (demote_prob 1 -> down, clamped at 0), 5-7 go on."""
    jenv, tenv, step, out = ramp
    js = out[-1][0]
    T = jenv.max_episode_length
    scale = float(jenv.reward_scales[jenv.track_idx])
    el = np.array(js.episode_length)
    el[:3] = T
    sums = np.array(js.episode_sums)
    sums[:, jenv.track_idx] = [0.9 * (T + 1) * scale, 0.1 * (T + 1) * scale,
                               0.9 * (T + 1) * scale] + [0.0] * (N - 3)
    cmds = np.array(js.commands)
    cmds[:2, 0:2] = [0.5, 0.0]
    cmds[2, 0:2] = 0.0
    levels = np.array([2, 4, 1, 3, 0, 2, 2, 2], np.int32)
    u = np.array(js.phys.u)
    u[3:5, 7] = np.nan
    js = js._replace(episode_length=jnp.asarray(el), episode_sums=jnp.asarray(sums),
                     commands=jnp.asarray(cmds), terrain_levels=jnp.asarray(levels),
                     env_origins=jnp.asarray(np.asarray(jenv.terrain_origins)[
                         levels, np.asarray(js.terrain_types)]),
                     phys=js.phys._replace(u=jnp.asarray(u)))
    ts = to_port_state(js, tenv)
    j2, jo = step(js, jnp.zeros((N, 12)), jax.random.PRNGKey(9))
    t2, to = tenv.step(ts, torch.zeros(N, 12), torch.Generator().manual_seed(9))
    assert np.asarray(jo.reset).tolist() == [True] * 5 + [False] * 3
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_array_equal(t2.terrain_levels.numpy(), np.asarray(j2.terrain_levels))
    assert t2.terrain_levels.tolist() == [3, 4, 1, 2, 0, 2, 2, 2]
    np.testing.assert_array_equal(t2.env_origins.numpy(), np.asarray(j2.env_origins))


def test_reset_origins_and_jitter(urdf):
    env, cfg, _ = registry.make_env(TASK, device="cpu", urdf=urdf)
    gen = torch.Generator().manual_seed(6)
    s = env.initial_state(gen)
    n = cfg.env.num_envs
    w = env.terrain_world
    assert s.terrain_levels.dtype == torch.int32
    assert 0 <= int(s.terrain_levels.min()) and int(s.terrain_levels.max()) <= \
        cfg.terrain.max_init_terrain_level
    assert torch.equal(s.terrain_types.long(), torch.arange(n) * w.num_cols // n)
    cells = torch.as_tensor(w.env_origins, dtype=torch.float32)
    assert torch.equal(s.env_origins, cells[s.terrain_levels.long(), s.terrain_types.long()])
    d = s.phys.base_pos - s.env_origins
    assert float(d[:, 0:2].abs().max()) <= 1.0 and float(d[:, 0:2].abs().max()) > 0.5
    assert torch.allclose(d[:, 2], torch.full((n,), cfg.init_state.pos[2]))
    assert s.terrain_planes.shape == (n, 27) and bool(torch.isfinite(s.terrain_planes).all())


def test_train_cli_terrain_one_iteration_on_cpu(tmp_path):
    from humanoid_tpu_torch.scripts import train

    seen = []
    runner, carry = train.main(["--task", TASK, "--device", "cpu", "--num-envs", "8",
                                "--max-iterations", "1", "--log-root", str(tmp_path)],
                               log_fn=lambda it, m, fps: seen.append(m))
    assert len(seen) == 1 and carry.critic_obs.shape == (8, 780) and carry.obs.shape == (8, 705)
    assert seen[0].kernel_launches == 0 and seen[0].sampler_launches == 0   # plain on the CPU
    assert torch.isfinite(seen[0].update.value_loss) and torch.isfinite(carry.critic_obs).all()


def test_trimesh_builds_and_steps_on_cpu(urdf):
    args = type("A", (), {"num_envs": 8, "seed": None, "max_iterations": None})()
    env, cfg, _ = registry.make_env("humanoid_ppo_trimesh", args, device="cpu", urdf=urdf)
    assert env.terrain.wall_thresh == pytest.approx(0.075)
    gen = torch.Generator().manual_seed(0)
    s = env.initial_state(gen)
    for _ in range(2):
        s, o = env.step(s, torch.zeros(8, 12), gen)
    assert o.privileged_obs.shape == (8, 780) and bool(torch.isfinite(o.privileged_obs).all())


# ---------------------------------------------------------------------------
# humanoid_ppo_trimesh against the reference


@pytest.fixture(scope="module")
def trimesh(urdf):
    """(reference env, port env) of humanoid_ppo_trimesh on its generated
    world (seed 5), the port on its shipping frozen contact prep."""
    jenv, tenv = build_pair(urdf, True, None, task="humanoid_ppo_trimesh")
    assert tenv.terrain.wall_thresh == pytest.approx(0.075)
    assert jenv.terrain.wall_thresh == pytest.approx(0.075)
    return jenv, tenv


@pytest.mark.parametrize("seed", [0, 1])
def test_trimesh_world_tracks_reference(trimesh, seed):
    """20 steps: the reference's kernel-vs-XLA trajectory bounds (max |dqj|
    <= 0.05, the median base heights within 0.01 m) and equal resets."""
    jenv, tenv = trimesh
    js = jenv.initial_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(10 + seed)
    acts = [0.3 * rng.standard_normal((N, 12)).astype(np.float32) for _ in range(20)]
    _, out = run_pair(jenv, tenv, js, 20, lambda i: acts[i], 400 + 100 * seed)
    max_dq = max(float(np.abs(np.asarray(j.phys.qj) - t.phys.qj.numpy()).max())
                 for j, _, t, _ in out)
    js, _, ts, _ = out[-1]
    dz = abs(float(np.median(np.asarray(js.phys.base_pos[:, 2])))
             - float(ts.phys.base_pos[:, 2].median()))
    assert max_dq <= 0.05, max_dq
    assert dz <= 0.01, dz
    for j, jo, t, to in out:
        np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))


def _assert_trimesh_planes_close(got, want, xy):
    """c0 = h - gx x - gy y is a difference of terms that reach |gx x| ~
    1e5 m at a wall (gradients up to ~1e3): held to 5e-5 m plus 8 float32
    ulps of |gx x| + |gy y|; the gradients to 1e-6 plus 8 ulps of |g|."""
    eps = float(np.finfo(np.float32).eps)
    got, want = got.reshape(got.shape[0], -1, 3), want.reshape(want.shape[0], -1, 3)
    g = np.abs(want[..., 1:])
    assert (np.abs(got[..., 1:] - want[..., 1:]) <= 1e-6 + 8 * eps * g).all(), \
        np.abs(got[..., 1:] - want[..., 1:]).max()
    scale = g[..., 0] * np.abs(xy[..., 0]) + g[..., 1] * np.abs(xy[..., 1])
    err = np.abs(got[..., 0] - want[..., 0])
    assert (err <= 5e-5 + 8 * eps * scale).all(), (err.max(), (err / (5e-5 + eps * scale)).max())


def test_trimesh_contact_planes_match_reference(trimesh):
    """contact_planes vs the reference's on 256 robots spread over the
    trimesh world with random yaw and joint angles; many points stand on a
    wall band."""
    jenv, tenv = trimesh
    n = 256
    rng = np.random.default_rng(12)
    w = tenv.terrain_world
    bp = np.c_[rng.uniform(0.0, w.num_rows * w.terrain_length, n),
               rng.uniform(0.0, w.num_cols * w.terrain_length, n), np.full(n, 0.9)]
    yaw = rng.uniform(-np.pi, np.pi, n)
    quat = np.c_[np.cos(yaw / 2), np.zeros((n, 2)), np.sin(yaw / 2)]
    qj = np.asarray(jenv.default_dof_pos) + rng.uniform(-0.3, 0.3, (n, 12))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    jphys = jenv.initial_state(jax.random.PRNGKey(4)).phys._replace(
        base_pos=jnp.asarray(f32(bp)), base_quat=jnp.asarray(f32(quat)),
        qj=jnp.asarray(f32(qj)), u=jnp.zeros((n, 18)))
    tphys = PhysState(*(torch.tensor(np.asarray(x)) for x in jphys))
    want = np.asarray(jenv._contact_planes(jphys))
    got = tenv.contact_planes(tphys).numpy()
    body_pos, body_quat = jax.vmap(lambda p, q, j: jfk(jenv.model, p, q, j))(
        jphys.base_pos, jphys.base_quat, jphys.qj)
    xy = np.asarray(_reference_contact_xy(jenv, body_pos, body_quat))
    _assert_trimesh_planes_close(got, want, xy)
    # some points stand on a wall band
    assert float(np.abs(want.reshape(n, 9, 3)[..., 1:]).max()) > 100.0
