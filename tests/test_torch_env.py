"""The env: port vs reference over `initial_state` and 5 `step`s.

One JAX env (CPU, XLA physics path) and one port env (CPU, plain physics)
are built from the same stand-in URDF with obs noise, pushes, action delay
and action noise off; commands are held (no resample within 5 steps). The
reference's initial state is carried across, and both take the same actions.
Dones must agree exactly; obs, privileged obs, rewards and every reward
term's episode sum to atol 1e-4. The robots start 4 cm below the reset
height so that their feet land within the 5 steps. The physics is the
shipping PGS path with the frozen factor; the contact prep is exact (per
substep) in both, since the reference applies frozen prep only inside its
TPU kernel.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import humanoid_tpu.config.structs as jcfg
from humanoid_tpu.env.xbotl import XBotLEnv as JaxEnv
from humanoid_tpu_torch.assets import write_xbot_topology_urdf
import humanoid_tpu_torch.config.structs as tcfg
from humanoid_tpu_torch.env.xbotl import EnvState, XBotLEnv
from humanoid_tpu_torch.physics.engine import PhysState

N = 8
STEPS = 5
ATOL = 1e-4


def make_cfg(mod, urdf, n=N):
    return mod.XBotLCfg(
        env=mod.EnvCfg(num_envs=n),
        asset=mod.AssetCfg(urdf=urdf),
        sim=mod.SimCfg(contact_model="pgs", pgs_iterations=6, pgs_freeze_prep=False),
        domain_rand=mod.DomainRandCfg(action_delay=False, dynamic_randomization=0.0,
                                      push_robots=False),
        noise=mod.NoiseCfg(add_noise=False),
    )


def to_port_state(js) -> EnvState:
    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype)

    phys = PhysState(*(t(x) for x in js.phys))
    fields = {f: t(getattr(js, f)) for f in EnvState._fields if f not in ("phys", "common_step")}
    return EnvState(phys=phys, common_step=t(js.common_step, torch.int64), **fields)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    urdf = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf")))
    jenv = JaxEnv(make_cfg(jcfg, urdf))
    tenv = XBotLEnv(make_cfg(tcfg, urdf), urdf, device="cpu")
    js = jenv.initial_state(jax.random.PRNGKey(3))
    # start 4 cm lower than the reset height, so the feet land within the 5 steps
    js = js._replace(phys=js.phys._replace(base_pos=js.phys.base_pos.at[:, 2].add(-0.04)))
    ts = to_port_state(js)
    step = jax.jit(jenv.step)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    out = []
    for i in range(STEPS):
        a = rng.uniform(-0.5, 0.5, (N, 12)).astype(np.float32)
        js, jo = step(js, jnp.asarray(a), jax.random.PRNGKey(100 + i))
        ts, to = tenv.step(ts, torch.as_tensor(a), gen)
        out.append((js, jo, ts, to))
    return jenv, tenv, out


def test_initial_state_shapes_match(tmp_path_factory):
    urdf = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf0")))
    jenv = JaxEnv(make_cfg(jcfg, urdf))
    tenv = XBotLEnv(make_cfg(tcfg, urdf), urdf, device="cpu")
    js = jenv.initial_state(jax.random.PRNGKey(0))
    ts = tenv.initial_state(torch.Generator().manual_seed(0))
    for f in EnvState._fields:
        if f == "phys":
            for a, b in zip(js.phys, ts.phys):
                assert tuple(a.shape) == tuple(b.shape)
        else:
            assert tuple(getattr(js, f).shape) == tuple(getattr(ts, f).shape), f
    assert tenv.reward_names == jenv.reward_names
    assert float(ts.phys.base_pos[:, 2].min()) == pytest.approx(0.95)


@pytest.mark.parametrize("k", range(STEPS))
def test_step_matches_reference(run, k):
    _, _, out = run
    js, jo, ts, to = out[k]
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_array_equal(to.time_outs.numpy(), np.asarray(jo.time_outs))
    np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=ATOL)
    np.testing.assert_allclose(to.privileged_obs.numpy(), np.asarray(jo.privileged_obs), atol=ATOL)
    np.testing.assert_allclose(to.rew.numpy(), np.asarray(jo.rew), atol=ATOL)
    np.testing.assert_allclose(to.rew_terms_mean.numpy(), np.asarray(jo.rew_terms_mean), atol=ATOL)


def test_reward_terms_match_reference(run):
    jenv, tenv, out = run
    js, _, ts, _ = out[-1]
    sums_t, sums_j = ts.episode_sums.numpy(), np.asarray(js.episode_sums)
    for i, name in enumerate(tenv.reward_names):
        np.testing.assert_allclose(sums_t[:, i], sums_j[:, i], atol=ATOL, err_msg=name)


def test_feet_reach_the_ground(run):
    """The comparison covers contact: by the last step every robot has a
    foot on the ground."""
    _, _, out = run
    _, _, ts, to = out[-1]
    contact = to.privileged_obs[:, -2:]        # newest frame's contact flags
    assert float(contact.amax(dim=1).min()) == 1.0


def test_guard_resets_non_finite_state(tmp_path_factory):
    """The non-finite / absurd-state guard: such an env terminates, resets
    and contributes a zero reward row."""
    urdf = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf1")))
    tenv = XBotLEnv(make_cfg(tcfg, urdf, n=4), urdf, device="cpu")
    gen = torch.Generator().manual_seed(0)
    s = tenv.initial_state(gen)
    u = s.phys.u.clone()
    u[1, 7] = float("nan")
    u[2, 8] = 2e4
    s = s._replace(phys=s.phys._replace(u=u))
    s2, o = tenv.step(s, torch.zeros(4, 12), gen)
    assert o.reset.tolist() == [False, True, True, False]
    assert torch.isfinite(s2.phys.u).all() and torch.isfinite(o.rew).all()
    assert float(s2.episode_sums[1:3].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# every reward term on one random context

from humanoid_tpu.env import rewards as jrew
from humanoid_tpu_torch.env import rewards as trew


def _context(mod_rewards, cfg, arrays, to):
    fields = {k: to(v) for k, v in arrays.items()}
    return mod_rewards.RewardContext(**fields, dt=0.01, cfg=cfg)


def _random_context_arrays(seed, n=16, nj=12):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return dict(
        dof_pos=f(n, nj, scale=0.3), dof_vel=f(n, nj), last_dof_vel=f(n, nj),
        actions=f(n, nj), last_actions=f(n, nj), last_last_actions=f(n, nj),
        torques=f(n, nj, scale=30.0), ref_dof_pos=f(n, nj, scale=0.3),
        default_dof_pos=np.zeros(nj, np.float32),
        base_pos=np.c_[f(n, 2), 0.89 + f(n, 1, scale=0.02)].astype(np.float32),
        base_lin_vel=f(n, 3, scale=0.3), base_ang_vel=f(n, 3, scale=0.3),
        base_euler=f(n, 3, scale=0.1), projected_gravity=f(n, 3, scale=0.1),
        root_vel=f(n, 6), last_root_vel=f(n, 6), commands=f(n, 4, scale=0.3),
        foot_pos=np.concatenate([f(n, 2, 2, scale=0.2), 0.05 + f(n, 2, 1, scale=0.02)],
                                axis=2).astype(np.float32),
        knee_pos=f(n, 2, 3, scale=0.2), foot_ang_vel=f(n, 2, 3),
        foot_forces=f(n, 2, 3, scale=400.0), term_force=np.abs(f(n, 1)),
        contact=rng.uniform(size=(n, 2)) < 0.5,
        stance_mask=(rng.uniform(size=(n, 2)) < 0.6).astype(np.float32),
        feet_air_time=np.abs(f(n, 2, scale=0.3)), first_contact=rng.uniform(size=(n, 2)) < 0.3,
        feet_height=0.06 + f(n, 2, scale=0.01),
    )


@pytest.mark.parametrize("directional", [False, True])
@pytest.mark.parametrize("name", sorted(trew.REWARD_FNS))
def test_reward_term_matches_reference(name, directional):
    arrays = _random_context_arrays(zlib.crc32(name.encode()) % 1000)
    jc = _context(jrew, jcfg.RewardsCfg(low_speed_directional=directional), arrays, jnp.asarray)
    tc = _context(trew, tcfg.RewardsCfg(low_speed_directional=directional), arrays,
                  lambda x: torch.as_tensor(np.array(x)))
    np.testing.assert_allclose(trew.REWARD_FNS[name](tc).numpy(),
                               np.asarray(jrew.REWARD_FNS[name](jc)), rtol=1e-5, atol=1e-5)


def test_reward_table_matches_reference():
    names, _, scales = trew.build_reward_table(tcfg.RewardsCfg(), 0.01)
    jnames, _, jscales = jrew.build_reward_table(jcfg.RewardsCfg(), 0.01)
    assert names == jnames and len(names) == 22
    np.testing.assert_allclose(scales, jscales)
