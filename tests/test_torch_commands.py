"""The command features of the env, port vs reference, at 8 envs: the
stand/walk switch (`commands.sw_switch`), the command curriculum, the
on-axis command practice (`commands.axis_frac`) and the height scan on a
plane.

The envs take a registered task's config with obs noise, pushes, action
delay and action noise off and `lag_timesteps=0` (the lag ring's random
index is then always 0). The reference's state is carried across field by
field and both take one step with the same actions; features whose outcome
is a fresh random draw (a reset, a walk command switching in) are checked
on the port alone, or only where the draw does not enter. Tolerances: the
port's env bounds, exact flags and counters, obs, critic obs and rewards at
atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_tpu.env.xbotl import XBotLEnv as JaxEnv
from humanoid_tpu.utils import registry as jreg
from humanoid_tpu_torch.assets import write_xbot_topology_urdf
from humanoid_tpu_torch.env.xbotl import EnvState, XBotLEnv, axis_project
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.utils import registry

N = 8
ATOL = 1e-4
NEVER = 10 ** 6          # a gait switch step no episode reaches


def make_cfg(cfg, urdf, **env):
    r = dataclasses.replace
    return cfg.replace(
        env=r(cfg.env, num_envs=N, **env), asset=r(cfg.asset, urdf=urdf),
        domain_rand=r(cfg.domain_rand, action_delay=False, dynamic_randomization=0.0,
                      push_robots=False, lag_timesteps=0),
        noise=r(cfg.noise, add_noise=False),
    )


def build_pair(task, urdf, **replace):
    """(reference env, port env) of `task`; `replace` maps a config
    section to fields replaced in it."""
    def cfg_of(mod):
        cfg = make_cfg(mod.get_cfgs(task)[0], urdf)
        return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                              for k, v in replace.items()})
    return JaxEnv(cfg_of(jreg)), XBotLEnv(cfg_of(registry), urdf, device="cpu")


def to_port_state(js) -> EnvState:
    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)

    phys = PhysState(*(t(x) for x in js.phys))
    skip = ("phys", "common_step", "terrain_planes")
    fields = {f: t(getattr(js, f)) for f in EnvState._fields if f not in skip}
    return EnvState(phys=phys, common_step=t(js.common_step, torch.int64), **fields)


def both_step(step, tenv, js, key, seed=0):
    ts = to_port_state(js)
    j2, jo = step(js, jnp.zeros((N, 12)), jax.random.PRNGKey(key))
    t2, to = tenv.step(ts, torch.zeros(N, 12), torch.Generator().manual_seed(seed))
    return j2, jo, t2, to


def assert_step_close(jo, to):
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=ATOL)
    np.testing.assert_allclose(to.privileged_obs.numpy(), np.asarray(jo.privileged_obs),
                               atol=ATOL)
    np.testing.assert_allclose(to.rew.numpy(), np.asarray(jo.rew), atol=ATOL)


@pytest.fixture(scope="module")
def urdf(tmp_path_factory):
    return write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf")))


@pytest.fixture(scope="module")
def robust(urdf):
    """humanoid_ppo_robust (sw_switch, walk-stand-walk schedule, command
    curriculum), its robots settled for 0.25 s on both feet under a stand
    command with no gait switch due. The contact prep is exact (the
    reference's XLA path has no frozen prep), so that the physics of the
    two agree to the env bounds. Returns (reference env, port env,
    jitted reference step, settled reference state)."""
    jenv, tenv = build_pair("humanoid_ppo_robust", urdf, sim={"pgs_freeze_prep": False})
    step = jax.jit(jenv.step)
    js = jenv.initial_state(jax.random.PRNGKey(0))
    js = js._replace(gait_time=jnp.full_like(js.gait_time, NEVER),
                     commands=jnp.zeros_like(js.commands))
    for i in range(25):
        js, jo = step(js, jnp.zeros((N, 12)), jax.random.PRNGKey(100 + i))
    assert not bool(np.asarray(jo.reset).any())
    return jenv, tenv, step, js


def test_sw_switch_step_matches_reference(robust):
    """One step from eight set-ups of the stand timer, the phase counter and
    its offset, the stand command and the stand gait switching in; each
    env's expected timer and counter is written out beside it."""
    jenv, tenv, step, js = robust
    el = np.full(N, 100, np.int32)
    cmds = np.zeros((N, 4), np.float32)
    cmds[0, 0] = 0.5            # 0: walk command -> timer restarts
    cmds[3, 0] = 0.5            # 3: walk command, the stand gait switches in
    cmds[5, 1] = 0.3            # 5: walk command
    cmds[6, 0] = 0.02           # 6: below the stand threshold -> a stand command
    ttss = np.array([3, 2, 5, 0, 5, 0, 1, 0], np.float32)
    plb = np.array([10, 10, 10, 10, 10, 0, 10, 37], np.int32)
    gs = np.array([0.0, 0.5, 0.0, 0.5, 0.0, 0.5, 0.0, 0.5], np.float32)
    gt = np.full((N, 3), NEVER, np.int32)
    gt[3:5, 1] = 101            # 3, 4: the stand gait switches in this step
    js = js._replace(episode_length=jnp.asarray(el), commands=jnp.asarray(cmds),
                     time_to_stand_still=jnp.asarray(ttss), phase_length_buf=jnp.asarray(plb),
                     gait_start=jnp.asarray(gs), gait_time=jnp.asarray(gt))
    j2, jo, t2, to = both_step(step, tenv, js, 7)
    # the set-up is what it says: slow robots on both feet
    contact = np.asarray(jo.privileged_obs)[:, -2:]
    assert (contact == 1.0).all()
    np.testing.assert_array_equal(t2.time_to_stand_still.numpy(),
                                  np.asarray(j2.time_to_stand_still))
    np.testing.assert_array_equal(t2.phase_length_buf.numpy(), np.asarray(j2.phase_length_buf))
    assert t2.time_to_stand_still.tolist() == [0, 3, 6, 5, 5, 0, 2, 1]
    assert t2.phase_length_buf.tolist() == [11, 11, 0, 11, 11, 1, 11, 38]
    np.testing.assert_array_equal(t2.gait_start.numpy(), gs)
    np.testing.assert_array_equal(t2.gait_time.numpy(), gt)
    np.testing.assert_allclose(t2.commands.numpy(), np.asarray(j2.commands), atol=1e-6)
    assert (t2.commands[3:5, 0:2] == 0).all()
    assert_step_close(jo, to)
    # the stance mask of the newest critic frame follows the counter and offset
    np.testing.assert_array_equal(to.privileged_obs[:, -4:-2].numpy(),
                                  np.asarray(jo.privileged_obs)[:, -4:-2])


def test_sw_switch_resets_and_walk_switch(robust):
    """Envs that reset restart the timer and the counter and draw a new
    offset and schedule; a walk gait switching in draws a command in the
    task's ranges. Port alone: the reference draws other numbers."""
    _, tenv, _, js = robust
    ts = to_port_state(js)
    u = ts.phys.u.clone()
    u[0:2, 7] = float("nan")                    # 0, 1 reset this step
    el = torch.full((N,), 100, dtype=torch.int32)
    gt = torch.full((N, 3), NEVER, dtype=torch.int32)
    gt[2:, 0] = 101                             # 2..7: a walk gait switches in
    ts = ts._replace(phys=ts.phys._replace(u=u), episode_length=el, gait_time=gt,
                     time_to_stand_still=torch.full((N,), 4.0),
                     phase_length_buf=torch.full((N,), 20, dtype=torch.int32))
    t2, to = tenv.step(ts, torch.zeros(N, 12), torch.Generator().manual_seed(1))
    assert to.reset.tolist() == [True, True] + [False] * (N - 2)
    assert t2.time_to_stand_still[:2].tolist() == [0.0, 0.0]
    assert t2.phase_length_buf[:2].tolist() == [0, 0]
    assert set(t2.gait_start.tolist()) <= {0.0, 0.5}
    seg = tenv.max_episode_length // 3
    lo = torch.arange(3) * seg
    assert bool(((t2.gait_time[:2] > lo) & (t2.gait_time[:2] < lo + seg)).all())
    assert torch.equal(t2.gait_time[2:], gt[2:])
    r = tenv.cfg.commands.ranges
    vx, vy = t2.commands[2:, 0], t2.commands[2:, 1]
    assert float(vx.min()) >= r.lin_vel_x[0] and float(vx.max()) <= r.lin_vel_x[1]
    assert float(vy.min()) >= r.lin_vel_y[0] and float(vy.max()) <= r.lin_vel_y[1]
    assert not torch.equal(t2.commands[2:, 0:2], ts.commands[2:, 0:2])
    # a walk command restarts the stand timer; a command the small-command
    # rule zeroed stands at once, both feet being down
    walk = torch.linalg.vector_norm(t2.commands[2:, 0:2], dim=1) > 0.0
    assert bool(walk.any())
    ttss = t2.time_to_stand_still[2:]
    assert bool((ttss[walk] == 0).all()) and bool((ttss[~walk] == 5).all())


@pytest.mark.parametrize("case", ["widen", "no widen", "off the grid"])
def test_command_curriculum_matches_reference(robust, case):
    """Envs 0-3 time out this step with their episodes' tracking sums set
    above ("widen", "off the grid") or below 80% of the possible; the range
    widens only on the max_episode_length grid of the common step."""
    jenv, tenv, step, js = robust
    T = jenv.max_episode_length
    scale = float(jenv.reward_scales[jenv.track_idx])
    frac = 0.5 if case == "no widen" else 0.95
    el = np.full(N, 100, np.int32)
    el[:4] = T
    sums = np.array(js.episode_sums)
    sums[:4, jenv.track_idx] = frac * T * scale
    common = T - (2 if case == "off the grid" else 1)
    js = js._replace(episode_length=jnp.asarray(el), episode_sums=jnp.asarray(sums),
                     common_step=jnp.asarray(common, dtype=js.common_step.dtype))
    j2, jo, t2, to = both_step(step, tenv, js, 11)
    assert np.asarray(jo.reset).tolist() == [True] * 4 + [False] * (N - 4)
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_allclose(t2.cmd_x_range.numpy(), np.asarray(j2.cmd_x_range), atol=1e-7)
    want = [-0.8, 1.0] if case == "widen" else [-0.3, 0.6]
    np.testing.assert_allclose(t2.cmd_x_range.numpy(), want, atol=1e-6)


def test_commands_resample_within_the_curriculum_range(robust):
    """Without sw_switch the periodic resample draws vx from the
    curriculum's range, not the static one."""
    _, tenv, _, _ = robust
    gen = torch.Generator().manual_seed(2)
    cmds = tenv._sample_commands(gen, 4096, torch.tensor([-0.8, 1.0]))
    vx = cmds[:, 0]
    assert float(vx.min()) >= -0.8 and float(vx.max()) <= 1.0
    assert float(vx.min()) < -0.6 and float(vx.max()) > 0.8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_axis_projection_matches_reference_on_fixed_draws(urdf, seed):
    """The reference's _sample_commands for humanoid_ppo_envelope
    (axis_frac 0.25) against the port's axis_project fed the same draws,
    which the test takes from the reference's own keys."""
    jenv = JaxEnv(make_cfg(jreg.get_cfgs("humanoid_ppo_envelope")[0], urdf))
    cfg = jenv.cfg.commands
    r = cfg.ranges
    n = 4096
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jenv._sample_commands(key, n))
    k1, k2, _ = jax.random.split(key, 3)
    vx = jax.random.uniform(k1, (n,), minval=r.lin_vel_x[0], maxval=r.lin_vel_x[1])
    vy = jax.random.uniform(k2, (n,), minval=r.lin_vel_y[0], maxval=r.lin_vel_y[1])
    ka, kb = jax.random.split(jax.random.fold_in(key, 1))
    on_axis = jax.random.uniform(ka, (n,)) < cfg.axis_frac
    sagittal = jax.random.bernoulli(kb, 0.5, (n,))
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    px, py = axis_project(t(vx), t(vy), t(on_axis), t(sagittal), r)
    keep = (torch.sqrt(px * px + py * py) > 0.2).float()
    np.testing.assert_allclose((px * keep).numpy(), want[:, 0], atol=1e-6)
    np.testing.assert_allclose((py * keep).numpy(), want[:, 1], atol=1e-6)
    # on-axis samples are pure and at least 0.2 m/s: none is zeroed
    axis = np.asarray(on_axis)
    assert ((want[axis, 0] == 0) ^ (want[axis, 1] == 0)).all()
    assert (np.abs(want[axis, :2]).max(axis=1) >= 0.2 - 1e-6).all()


def test_axis_frac_share_of_port_commands(urdf):
    """The port's own draws: about axis_frac of the commands are pure-axis."""
    env = XBotLEnv(make_cfg(registry.get_cfgs("humanoid_ppo_envelope")[0], urdf), urdf,
                   device="cpu")
    cmds = env._sample_commands(torch.Generator().manual_seed(0), 20000)
    pure = ((cmds[:, 0] == 0) ^ (cmds[:, 1] == 0)).float().mean()
    assert 0.23 < float(pure) < 0.29
    r = env.cfg.commands.ranges
    assert float(cmds[:, 0].min()) >= r.lin_vel_x[0] and float(cmds[:, 0].max()) <= r.lin_vel_x[1]


@pytest.mark.parametrize("k", range(2))
def test_height_scan_on_a_plane_matches_reference(urdf, k):
    """humanoid_ppo with the 187-point scan on its plane: the scan reads the
    flat ground, so the critic frame ends with clip(z - 0.5, -1, 1) x scale
    at every point; two steps from the reference's initial state."""
    jenv, tenv = build_pair("humanoid_ppo", urdf, env={"single_num_privileged_obs": 73 + 187},
                            terrain={"measure_heights": True})
    step = jax.jit(jenv.step)
    js = jenv.initial_state(jax.random.PRNGKey(4))
    ts = to_port_state(js)
    gen = torch.Generator().manual_seed(0)
    for i in range(k + 1):
        js, jo = step(js, jnp.zeros((N, 12)), jax.random.PRNGKey(i))
        ts, to = tenv.step(ts, torch.zeros(N, 12), gen)
    assert to.privileged_obs.shape == (N, 3 * 260)
    assert_step_close(jo, to)
    scan = to.privileged_obs[:, -187:]
    z = ts.phys.base_pos[:, 2:3]
    want = torch.clamp(z - 0.5, -1.0, 1.0) * tenv.cfg.normalization.obs_scales.height_measurements
    np.testing.assert_allclose(scan.numpy(), want.expand(N, 187).numpy(), atol=1e-6)


@pytest.mark.parametrize("task", ["humanoid_ppo_robust", "humanoid_ppo_envelope",
                                  "humanoid_ppo_sym"])
def test_command_feature_tasks_train_one_iteration_on_cpu(task):
    """One iteration of 4 steps at 8 envs on the CPU: finite losses (the
    symmetry loss on where the task has it), parameters and observations."""
    env_cfg, _ = registry.get_cfgs(task)
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=N))
    env, _, train_cfg = registry.make_env(task, device="cpu", env_cfg=env_cfg)
    train_cfg = train_cfg.replace(runner=dataclasses.replace(train_cfg.runner,
                                                             num_steps_per_env=4))
    runner = registry.make_alg_runner(env, train_cfg)
    carry, m = runner.train_iteration(runner.init_carry())
    u = m.update
    for x in (u.value_loss, u.surrogate_loss, u.kl, u.sym_loss, m.mean_step_reward):
        assert torch.isfinite(x)
    assert (float(u.sym_loss) > 0.0) == train_cfg.algorithm.sym_loss
    assert (runner.obs_perm is not None) == train_cfg.algorithm.sym_loss
    assert all(torch.isfinite(p).all() for p in runner.net.parameters())
    assert bool(torch.isfinite(carry.obs).all() and torch.isfinite(carry.critic_obs).all())
    assert m.kernel_launches == 0
