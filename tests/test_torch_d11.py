"""The 18-dof task family (d11_ppo, d11_ppo_pgs, d12_ppo): the port against
the reference package at nj = 18, nb = 19, nv = 24.

The robot is the port's 18-dof stand-in (assets.write_xbot18_topology_urdf:
XBot-L's legs and two 3-dof arms on the base), which both packages load.
Its document order is XBOT18_JOINT_ORDER, so the reference, given the file
through `AssetCfg(urdf=...)`, compiles the same dof order.

- The compiled model against the reference's loader, every field exactly;
  the kernel's table and the penalty team's chain schedule over the four
  branches of the base (two 3-joint arms, two 6-joint legs).
- The control step: the plain version against the reference engine on 8
  settled 18-dof robots pressed 1 mm into the ground, with and without
  gains and body, and on penalty contact, within the reference's
  kernel-vs-XLA bounds (|du| < 1e-2, |base_pos| < 1e-5, foot forces within
  1% of body weight); the host-built kernel source against the plain
  version on the PGS (cold and warm) and penalty instances, at 8 envs and
  at a count that leaves tail teams. The checks are
  tests/test_torch_control_step.py's own, on this robot.
- The env: d11_ppo and d12_ppo (noise, pushes, action delay and the lag's
  random index off; no gait switch due) over `initial_state` and 5 steps
  against the reference env, dones exact, obs, privileged obs, rewards and
  reward sums to atol 1e-4; and d11_ppo on the engine path.
- The configs, `--contact penalty`, `--urdf PATH` (a file with fixed arms
  gets them flipped), the mirror matrices at nj = 18, the export and play,
  and one training iteration.
"""
import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_tpu.algo import symmetry as jsym
from humanoid_tpu.env.xbotl import XBotLEnv as JaxEnv
from humanoid_tpu.physics.urdf import load_urdf as jax_load_urdf
from humanoid_tpu.utils import registry as jreg
from humanoid_tpu_torch.algo import symmetry as tsym
from humanoid_tpu_torch.assets import (XBOT18_ARM_JOINTS, XBOT18_JOINT_ORDER,
                                       write_xbot18_topology_urdf)
from humanoid_tpu_torch.env.xbotl import EnvState
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.physics.urdf import load_urdf
from humanoid_tpu_torch.utils import registry
from test_torch_control_step import host_build  # noqa: F401  (a fixture)
from test_torch_control_step import (TEAMS_PER_BLOCK, _penalty_kernel,
                                     check_control_step_matches_reference_engine,
                                     check_gains_and_body_match_reference_engine,
                                     check_kernel_source_at_small_env_counts,
                                     check_kernel_source_matches_plain_on_host,
                                     check_kernel_source_with_extras,
                                     check_penalty_kernel_source_matches_plain_on_host,
                                     check_penalty_matches_reference_engine, make_ramp,
                                     make_setup)

N = 8
STEPS = 5
ATOL = 1e-4
NEVER = 10 ** 6          # a gait switch step no episode reaches


@pytest.fixture(scope="module")
def urdf(tmp_path_factory):
    return write_xbot18_topology_urdf(str(tmp_path_factory.mktemp("urdf18")))


# ---------------------------------------------------------------------------
# the model, the kernel's table and the chain schedule

def test_18dof_model_matches_reference_loader(urdf):
    tm = load_urdf(urdf, joint_order=XBOT18_JOINT_ORDER, armature=0.01)
    jm = jax_load_urdf(urdf, armature=0.01)
    assert (tm.nj, tm.nb, tm.nv) == (18, 19, 24)
    assert tm.joint_names == XBOT18_JOINT_ORDER and tm.joint_names[:6] == XBOT18_ARM_JOINTS
    assert tm.joint_names[6] == "left_leg_roll_joint" and len(tm.foot_bodies) == 2
    assert not any("ankle_roll" in n or "knee" in n for n in tm.body_names[1:7])
    for f in dataclasses.fields(tm):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(a, np.ndarray):
            assert a.shape == np.shape(b) and np.array_equal(a, np.asarray(b)), f.name
        else:
            assert a == b, f.name
    # the arms' masses come out of the base: the legs carry the 12-dof load
    assert tm.total_mass == pytest.approx(39.54, abs=1e-6)


@pytest.fixture(scope="module")
def setup18(urdf):
    """8 settled 18-dof robots in the d11 pose with its gains, pressed 1 mm in."""
    cfg = registry.get_cfgs("d11_ppo")[0]
    return make_setup(urdf, np.asarray(cfg.control.stiffness, np.float32),
                      np.asarray(cfg.control.damping, np.float32),
                      np.asarray(cfg.init_state.default_joint_angles))


def test_18dof_model_table_and_chain_schedule(setup18, host_build):  # noqa: F811
    """The table at nj = 18 (parents, the ancestor masks of 19 bodies, the
    sole points' feet) and the penalty team's schedule over the base's four
    branches: lanes 0 and 1 the arms (3 joints), 2 and 3 the legs (6), in
    6 steps."""
    t, tm = setup18["kernel"].table, setup18["tm"]
    assert (t.nj, t.n_fpts, t.n_term, t.n_feet) == (18, 8, 1, 2)
    assert list(t.parent[:19]) == [int(p) for p in tm.parent]
    assert t.anc[0] == 0 and t.anc[3] == 0b111 and t.anc[6] == 0b111 << 3
    assert t.anc[12] == 0b111111 << 6 and t.anc[18] == 0b111111 << 12
    assert list(t.fpt_foot[:8]) == [0, 0, 0, 0, 1, 1, 1, 1]
    length = np.zeros(16, np.int32)
    joint = np.zeros((16, 18), np.int32)
    steps = host_build.host_chains16(ctypes.addressof(t), length.ctypes.data,
                                     joint.ctypes.data)
    assert steps == 6
    assert list(length) == [3, 3, 6, 6] + [0] * 12
    assert [list(joint[lane, :length[lane]]) for lane in range(4)] == [
        [0, 1, 2], [3, 4, 5], list(range(6, 12)), list(range(12, 18))]


# ---------------------------------------------------------------------------
# the control step at 18 dof

@pytest.mark.parametrize("case", ["pgs", "gains_body", "penalty"])
def test_18dof_control_step_matches_reference_engine(setup18, case):
    if case == "pgs":
        check_control_step_matches_reference_engine(setup18)
    elif case == "gains_body":
        check_gains_and_body_match_reference_engine(setup18)
    else:
        check_penalty_matches_reference_engine(setup18, _penalty_kernel(setup18), True)


@pytest.mark.parametrize("instance,warm", [((10, True, True), False), ((1, False, False), False),
                                           ((10, True, True), True)])
def test_18dof_kernel_source_matches_plain_on_host(setup18, host_build, instance,  # noqa: F811
                                                   warm):
    check_kernel_source_matches_plain_on_host(setup18, host_build, instance, warm)


@pytest.mark.parametrize("case", ["flat-shipping", "flat-exact"])
def test_18dof_penalty_kernel_source_matches_plain_on_host(setup18, host_build,  # noqa: F811
                                                           case):
    check_penalty_kernel_source_matches_plain_on_host(setup18, _penalty_kernel(setup18), None,
                                                      host_build, case)


@pytest.fixture(scope="module")
def ramp18(setup18):
    return make_ramp(setup18)


@pytest.mark.parametrize("case", ["ramp-shipping", "ramp-warm"])
def test_18dof_kernel_source_with_gains_body_planes_on_host(setup18, ramp18,
                                                           host_build,  # noqa: F811
                                                           case):
    check_kernel_source_with_extras(setup18, ramp18, host_build, case)


@pytest.mark.parametrize("contact", ["cold", "warm", "penalty"])
def test_18dof_kernel_source_at_a_tail_team_count_on_host(setup18, host_build,  # noqa: F811
                                                         contact):
    """5 envs, the last block of 37: 3 tail teams behind the NaN guard."""
    assert TEAMS_PER_BLOCK - 5 % TEAMS_PER_BLOCK == 3
    check_kernel_source_at_small_env_counts(setup18, host_build, 5, contact)


# ---------------------------------------------------------------------------
# the env against the reference's

def make_cfg(cfg, urdf, **sim):
    r = dataclasses.replace
    return cfg.replace(
        env=r(cfg.env, num_envs=N), asset=r(cfg.asset, urdf=urdf),
        sim=r(cfg.sim, pgs_freeze_prep=False, **sim),
        domain_rand=r(cfg.domain_rand, action_delay=False, dynamic_randomization=0.0,
                      push_robots=False, lag_timesteps=0),
        noise=r(cfg.noise, add_noise=False),
    )


def to_port_state(js) -> EnvState:
    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)

    phys = PhysState(*(t(x) for x in js.phys))
    skip = ("phys", "common_step", "terrain_planes")
    fields = {f: t(getattr(js, f)) for f in EnvState._fields if f not in skip}
    return EnvState(phys=phys, common_step=t(js.common_step, torch.int64), **fields)


def run_pair(task, urdf, **sim):
    """The reference env and the port's on `task`'s config (the contact
    prep exact, as on the reference's XLA path), 5 steps of the same random
    actions from the reference's initial state, 4 cm lower so that the feet
    land within them."""
    jenv = JaxEnv(make_cfg(jreg.get_cfgs(task)[0], urdf, **sim))
    cfg = make_cfg(registry.get_cfgs(task)[0], urdf, **sim)
    path, joint_order = registry.robot(cfg)
    tenv = registry.build_env(cfg, path, "cpu", joint_order)
    js = jenv.initial_state(jax.random.PRNGKey(3))
    js = js._replace(phys=js.phys._replace(base_pos=js.phys.base_pos.at[:, 2].add(-0.04)))
    if js.gait_time is not None:
        js = js._replace(gait_time=jnp.full_like(js.gait_time, NEVER))
    ts = to_port_state(js)
    step = jax.jit(jenv.step)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    out = []
    for i in range(STEPS):
        a = rng.uniform(-0.5, 0.5, (N, 18)).astype(np.float32)
        js, jo = step(js, jnp.asarray(a), jax.random.PRNGKey(100 + i))
        ts, to = tenv.step(ts, torch.as_tensor(a), gen)
        out.append((js, jo, ts, to))
    return tenv, out


PAIRS = {"d11_ppo": ("d11_ppo", {}), "d12_ppo": ("d12_ppo", {}),
         "d11_ppo-engine": ("d11_ppo", {"use_pallas_substep": False})}


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request, urdf):
    task, sim = PAIRS[request.param]
    return request.param, run_pair(task, urdf, **sim)


def test_18dof_env_matches_reference(pair):
    name, (tenv, out) = pair
    assert tenv.nj == 18 and tenv.model.joint_names == XBOT18_JOINT_ORDER
    assert tenv.use_kernel == (not name.endswith("engine"))
    for js, jo, ts, to in out:
        np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
        np.testing.assert_array_equal(to.time_outs.numpy(), np.asarray(jo.time_outs))
        assert to.obs.shape == (N, 15 * 65) and to.privileged_obs.shape == (N, 3 * 97)
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=ATOL)
        np.testing.assert_allclose(to.privileged_obs.numpy(), np.asarray(jo.privileged_obs),
                                   atol=ATOL)
        np.testing.assert_allclose(to.rew.numpy(), np.asarray(jo.rew), atol=ATOL)
        np.testing.assert_allclose(to.rew_terms_mean.numpy(), np.asarray(jo.rew_terms_mean),
                                   atol=ATOL)
    js, _, ts, to = out[-1]
    np.testing.assert_allclose(ts.episode_sums.numpy(), np.asarray(js.episode_sums), atol=ATOL)
    # the comparison covers contact: every robot has a foot on the ground
    assert float(to.privileged_obs[:, -2:].amax(dim=1).min()) == 1.0


def test_18dof_env_constants(pair):
    """The per-joint action scale, the elbows' default pose and the gait
    reference on the legs at +6."""
    _, (tenv, _) = pair
    np.testing.assert_array_equal(tenv.action_scale.numpy(),
                                  np.float32([0.1] * 6 + [0.25] * 12))
    assert tenv.default_dof_pos[[2, 5]].tolist() == pytest.approx([1.0472, -1.0472])
    assert torch.nonzero(tenv._ref_l).flatten().tolist() == [8, 9, 10]
    assert torch.nonzero(tenv._ref_r).flatten().tolist() == [14, 15, 16]


# ---------------------------------------------------------------------------
# the CLI, the mirror matrices, export and play, a training iteration

def test_contact_override_on_d11_matches_reference():
    from humanoid_tpu.scripts import train as jtrain
    from humanoid_tpu_torch.scripts import train

    argv = ["--task", "d11_ppo", "--contact", "penalty", "--num-envs", "64"]
    je, jt = jreg.update_cfg_from_args(*jreg.get_cfgs("d11_ppo"), jtrain.get_args(argv))
    te, tt = registry.update_cfg_from_args(*registry.get_cfgs("d11_ppo"), train.get_args(argv))
    assert te.sim.contact_model == "penalty" and te.env.num_actions == 18
    assert dataclasses.asdict(te) == dataclasses.asdict(je)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)


def _fixed_arms(urdf, tmp_path):
    """The stand-in with its six arm joints typed `fixed`, as a real XBot-L
    URDF has them."""
    with open(urdf) as f:
        text = f.read()
    for name in XBOT18_ARM_JOINTS:
        text, n = re.subn(r'(<joint name="%s" type=")revolute(")' % name, r"\1fixed\2", text)
        assert n == 1
    path = tmp_path / "xbot_fixed_arms.urdf"
    path.write_text(text)
    return str(path)


def _small_cfgs(monkeypatch):
    orig = registry.get_cfgs

    def small(name):
        e, t = orig(name)
        return e, t.replace(runner=dataclasses.replace(t.runner, num_steps_per_env=2))

    monkeypatch.setattr(registry, "get_cfgs", small)


def test_train_cli_urdf_flips_the_arms_of_an_18dof_task(urdf, tmp_path, monkeypatch):
    """`train --task d11_ppo --urdf PATH` on a file with fixed arms: the six
    arm joints made revolute, 18 dofs in XBOT18_JOINT_ORDER, one iteration
    with finite losses. On a 12-dof task the same file compiles as it is."""
    from humanoid_tpu_torch.scripts import train

    fixed = _fixed_arms(urdf, tmp_path)
    assert load_urdf(fixed).nj == 12          # control: the arms are fixed in the file
    _small_cfgs(monkeypatch)
    seen = []
    runner, carry = train.main(["--task", "d11_ppo", "--urdf", fixed, "--device", "cpu",
                                "--num-envs", "4", "--max-iterations", "1",
                                "--log-root", str(tmp_path / "logs")],
                               log_fn=lambda it, m, fps: seen.append(m))
    model = runner.env.model
    assert model.nj == 18 and model.joint_names == XBOT18_JOINT_ORDER
    path, order = registry.robot(runner.env.cfg, fixed)
    assert order == XBOT18_JOINT_ORDER and path != fixed
    with open(path) as f:
        flipped = f.read()
    for name in XBOT18_ARM_JOINTS:
        assert re.search(r'<joint name="%s" type="revolute"' % name, flipped)
    u = seen[0].update
    assert all(torch.isfinite(x) for x in (u.value_loss, u.surrogate_loss, u.kl))
    assert all(torch.isfinite(p).all() for p in runner.net.parameters())
    assert carry.obs.shape == (4, 15 * 65)
    cfg12 = registry.get_cfgs("humanoid_ppo")[0]
    cfg12 = cfg12.replace(env=dataclasses.replace(cfg12.env, num_envs=2))
    env12, _, _ = registry.make_env("humanoid_ppo", device="cpu", urdf=fixed, env_cfg=cfg12)
    assert env12.nj == 12


@pytest.mark.parametrize("task", ["d11_ppo", "d12_ppo"])
def test_18dof_task_trains_one_iteration_on_cpu(task):
    """One iteration of 4 steps at 8 envs on the CPU: finite losses,
    parameters and observations of the 18-dof widths."""
    env_cfg, _ = registry.get_cfgs(task)
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=N))
    env, _, train_cfg = registry.make_env(task, device="cpu", env_cfg=env_cfg)
    assert env.model.joint_names == XBOT18_JOINT_ORDER
    train_cfg = train_cfg.replace(runner=dataclasses.replace(train_cfg.runner,
                                                             num_steps_per_env=4))
    runner = registry.make_alg_runner(env, train_cfg, log_root=False)
    carry, m = runner.train_iteration(runner.init_carry())
    u = m.update
    for x in (u.value_loss, u.surrogate_loss, u.kl, m.mean_step_reward):
        assert torch.isfinite(x)
    assert all(torch.isfinite(p).all() for p in runner.net.parameters())
    assert carry.obs.shape == (N, 15 * 65) and carry.critic_obs.shape == (N, 3 * 97)
    assert bool(torch.isfinite(carry.obs).all()) and m.kernel_launches == 0


def test_mirror_matrices_at_18_dof_match_reference():
    obs_t, act_t = tsym.xbot_perm_matrices(15, 18)
    obs_j, act_j = jsym.xbot_perm_matrices(frame_stack=15, nj=18)
    assert obs_t.shape == (15 * 65, 15 * 65) and act_t.shape == (18, 18)
    np.testing.assert_array_equal(obs_t, np.asarray(obs_j))
    np.testing.assert_array_equal(act_t, np.asarray(act_j))
    np.testing.assert_array_equal(act_t @ act_t, np.eye(18))
    np.testing.assert_array_equal(obs_t @ obs_t, np.eye(15 * 65))


def test_play_exports_and_rolls_d11(tmp_path):
    """A d11_ppo checkpoint: play at 1 env on the CPU, its policy.npz,
    TorchScript actor and ONNX file within 1e-5 of the float32 actor on
    975-wide observations."""
    import copy

    from humanoid_tpu_torch.deploy import onnx_loader
    from humanoid_tpu_torch.deploy.npz_policy import NpzPolicy
    from humanoid_tpu_torch.scripts import play

    env_cfg, train_cfg = registry.get_cfgs("d11_ppo")
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=1))
    path, joint_order = registry.robot(env_cfg)
    runner = registry.make_alg_runner(registry.build_env(env_cfg, path, "cpu", joint_order),
                                      train_cfg, log_root=str(tmp_path / "logs"))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in runner.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    runner.iteration = 7
    runner.save()
    out = play.main(["--task", "d11_ppo", "--device", "cpu", "--num-envs", "1", "--steps", "5",
                     "--log-root", str(tmp_path / "logs"), "--out-dir", str(tmp_path / "play")])
    assert out["finite"] and out["steps"] == 5 and out["kernel_launches"] == 0
    with np.load(tmp_path / "play" / "openloop_action.npz") as z:
        assert z["action"].shape == (5, 18)
    f32 = copy.deepcopy(runner.net)
    f32.compute_dtype = torch.float32
    obs = np.random.default_rng(5).normal(size=(64, 15 * 65)).astype(np.float32)
    with torch.no_grad():
        want = f32.act_mean(torch.as_tensor(obs)).numpy()
        ts = torch.jit.load(str(tmp_path / "play" / "policy_1.pt"))(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(NpzPolicy(out["npz"])(obs), want, atol=1e-5)
    np.testing.assert_allclose(onnx_loader.load_onnx_mlp(str(tmp_path / "play" /
                                                             "policy.onnx"))(obs), want,
                               atol=1e-5)
    np.testing.assert_allclose(ts, want, atol=1e-5)
