"""Networks, GAE, the PPO update and the slice as a whole: port vs reference.

Weights are carried across from flax param trees (and from the committed
exported policy validation/flagship_r5c/policy_3001.npz); batches and
permutations are made once and fed to both. Tolerances: 1e-5 on forward
passes, 1e-4 on parameters after one update (float32 on the CPU, summation
order differs); 1e-4 on obs and rewards of the deterministic rollout.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import humanoid_tpu.config.structs as jcfg
from humanoid_tpu.algo import gae as jgae
from humanoid_tpu.algo import networks as jnet
from humanoid_tpu.algo import ppo as jppo
from humanoid_tpu.deploy.npz_policy import NpzPolicy
from humanoid_tpu.env.xbotl import XBotLEnv as JaxEnv
from humanoid_tpu_torch.algo import networks as tnet
from humanoid_tpu_torch.algo.gae import compute_gae
from humanoid_tpu_torch.algo.ppo import Adam, Batch, ppo_update
from humanoid_tpu_torch.algo.runner import OnPolicyRunner
from humanoid_tpu_torch.assets import write_xbot_topology_urdf
import humanoid_tpu_torch.config.structs as tcfg
from humanoid_tpu_torch.env.xbotl import EnvState, XBotLEnv
from humanoid_tpu_torch.physics.engine import PhysState

OBS, PRIV, ACT = 705, 219, 12
NPZ = os.path.join(os.path.dirname(__file__), "..", "validation", "flagship_r5c",
                   "policy_3001.npz")


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _flax_net_and_params(seed=0, dtype="float32"):
    net = jnet.ActorCritic(num_actions=ACT, compute_dtype=dtype)
    params = jnet.init_params(jax.random.PRNGKey(seed), net, OBS, PRIV)
    # a std away from its init value, so that copying it is checked too
    params["params"]["std"] = jnp.linspace(0.5, 1.5, ACT)
    return net, params


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_flax(seed):
    jn, params = _flax_net_and_params(seed)
    tn = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT), _np_tree(params))
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(16, OBS)).astype(np.float32)
    priv = rng.normal(size=(16, PRIV)).astype(np.float32)
    mean, std, value, vel = jn.apply(params, obs, priv)
    with torch.no_grad():
        tm, ts, tv, tvel = tn(torch.as_tensor(obs), torch.as_tensor(priv))
    np.testing.assert_allclose(tm.numpy(), np.asarray(mean), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(std), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(value), atol=1e-5)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(vel), atol=1e-5)


def test_exported_policy_actor_matches_reference_runner():
    tn = tnet.from_npz(tnet.ActorCritic(OBS, PRIV, ACT), NPZ)
    obs = np.random.default_rng(0).normal(size=(32, OBS)).astype(np.float32)
    with torch.no_grad():
        act = tn.act_mean(torch.as_tensor(obs)).numpy()
        vel = tn.estimate_vel(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(act, NpzPolicy(NPZ)(obs), atol=1e-5)
    np.testing.assert_allclose(vel, NpzPolicy(NPZ, prefix="vel")(obs), atol=1e-5)
    np.testing.assert_array_equal(tn.std.detach().numpy(), np.load(NPZ)["std"])


def test_min_std_floor():
    net = tnet.ActorCritic(OBS, PRIV, ACT)
    with torch.no_grad():
        net.std.fill_(-1.0)
    assert tnet.MIN_STD == jnet.MIN_STD
    assert float(net.action_std().detach().min()) == pytest.approx(tnet.MIN_STD)


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_matches_reference(seed):
    rng = np.random.default_rng(seed)
    T, N = 6, 5
    rew = rng.normal(size=(T, N)).astype(np.float32)
    val = rng.normal(size=(T, N)).astype(np.float32)
    done = rng.uniform(size=(T, N)) < 0.2
    last = rng.normal(size=N).astype(np.float32)
    ja, jr = jgae.compute_gae(rew, val, done, last, 0.994, 0.9)
    ta, tr = compute_gae(torch.as_tensor(rew), torch.as_tensor(val), torch.as_tensor(done),
                         torch.as_tensor(last), 0.994, 0.9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_ppo_update_matches_reference():
    """One update (2 epochs x 4 minibatches) from an identical batch and
    tile permutation, compute_dtype float32."""
    acfg = jcfg.AlgorithmCfg(learning_rate=1e-3)
    jn, params = _flax_net_and_params(3)
    B = 64
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(B, OBS)).astype(np.float32)
    priv = rng.normal(size=(B, PRIV)).astype(np.float32)
    mu = rng.normal(size=(B, ACT)).astype(np.float32) * 0.3
    actions = (mu + rng.normal(size=(B, ACT))).astype(np.float32)
    sigma = np.ones((B, ACT), np.float32)
    logp = np.asarray(jnet.log_prob(mu, sigma, actions))
    batch = dict(obs=obs, critic_obs=priv, actions=actions, old_logp=logp, old_mu=mu,
                 old_sigma=sigma, target_values=rng.normal(size=B).astype(np.float32),
                 advantages=rng.normal(size=B).astype(np.float32),
                 returns=rng.normal(size=B).astype(np.float32))
    key = jax.random.PRNGKey(11)
    vel_slice = (53, 56)
    ts, jm = jppo.ppo_update(jn, acfg, jppo.init_train_state(params, acfg),
                             jppo.Batch(**batch), key, vel_slice)
    g = acfg.shuffle_granule
    tiles = np.asarray(jax.random.permutation(key, B // g))
    perm = torch.as_tensor((tiles[:, None] * g + np.arange(g)).reshape(-1))

    tn = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT), _np_tree(params))
    before = [p.detach().clone() for p in tn.parameters()]
    opt = Adam(list(tn.parameters()), acfg.max_grad_norm, acfg.learning_rate)
    tbatch = Batch(**{k: torch.as_tensor(np.array(v)) for k, v in batch.items()})
    tm = ppo_update(tn, tcfg.AlgorithmCfg(learning_rate=1e-3), opt, tbatch, perm, vel_slice)
    after = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT), _np_tree(ts.params))
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(tn.parameters(), before))
    assert moved > 1e-3
    for (name, p), q in zip(tn.named_parameters(), after.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(float(tm.lr), float(ts.lr), rtol=1e-6)
    np.testing.assert_allclose(float(tm.value_loss), float(jm.value_loss), rtol=1e-4)
    np.testing.assert_allclose(float(tm.kl), float(jm.kl), rtol=1e-3, atol=1e-7)


def _env_cfg(mod, urdf, n):
    return mod.XBotLCfg(
        env=mod.EnvCfg(num_envs=n), asset=mod.AssetCfg(urdf=urdf),
        sim=mod.SimCfg(contact_model="pgs", pgs_iterations=6, pgs_freeze_prep=False),
        domain_rand=mod.DomainRandCfg(action_delay=False, dynamic_randomization=0.0,
                                      push_robots=False),
        noise=mod.NoiseCfg(add_noise=False),
    )


def test_slice_rollout_matches_reference(tmp_path_factory):
    """The slice as a whole: env + actor from carried weights, 4
    deterministic (act_mean) steps, port vs reference."""
    N = 8
    urdf = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf")))
    jenv = JaxEnv(_env_cfg(jcfg, urdf, N))
    tenv = XBotLEnv(_env_cfg(tcfg, urdf, N), urdf, device="cpu")
    jn, params = _flax_net_and_params(5)
    tn = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT), _np_tree(params))
    js = jenv.initial_state(jax.random.PRNGKey(9))
    ts = EnvState(phys=PhysState(*(torch.as_tensor(np.array(x)) for x in js.phys)),
                  common_step=torch.as_tensor(int(js.common_step)),
                  **{f: torch.as_tensor(np.array(getattr(js, f))) for f in EnvState._fields
                     if f not in ("phys", "common_step")})
    step = jax.jit(jenv.step)
    gen = torch.Generator().manual_seed(0)
    jobs = jnp.zeros((N, OBS))
    tobs = torch.zeros(N, OBS)
    for i in range(4):
        ja = jn.apply(params, jobs, method="act_mean")
        with torch.no_grad():
            ta = tn.act_mean(tobs)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)
        js, jo = step(js, ja, jax.random.PRNGKey(i))
        ts, to = tenv.step(ts, ta, gen)
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=1e-4)
        np.testing.assert_allclose(to.rew.numpy(), np.asarray(jo.rew), atol=1e-4)
        np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
        jobs, tobs = jo.obs, to.obs


def test_train_iteration_runs_at_small_size():
    from humanoid_tpu_torch.utils import registry

    env_cfg, train_cfg = registry.get_cfgs("humanoid_ppo")
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=8))
    env = XBotLEnv(env_cfg, registry.default_urdf(), device="cpu")
    train_cfg = train_cfg.replace(runner=dataclasses.replace(train_cfg.runner,
                                                             num_steps_per_env=4))
    runner = OnPolicyRunner(env, train_cfg)
    before = [p.detach().clone() for p in runner.net.parameters()]
    carry, m = runner.train_iteration(runner.init_carry())
    assert carry.obs.shape == (8, OBS) and carry.critic_obs.shape == (8, PRIV)
    for x in (m.update.value_loss, m.update.surrogate_loss, m.update.kl, m.mean_step_reward):
        assert torch.isfinite(x)
    assert m.kernel_launches == 0          # CPU tensors take the plain version
    assert all(torch.isfinite(p).all() for p in runner.net.parameters())
    assert any(not torch.equal(p, q) for p, q in zip(runner.net.parameters(), before))


def test_registry_config_matches_reference():
    from humanoid_tpu.utils import registry as jreg
    from humanoid_tpu_torch.utils import registry

    je, jt = jreg.get_cfgs("humanoid_ppo")
    te, tt = registry.get_cfgs("humanoid_ppo")
    assert dataclasses.asdict(te) == dataclasses.asdict(je)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert registry.list_tasks() == ["humanoid_ppo"]


def test_train_cli_needs_a_card_unless_asked_for_cpu():
    from humanoid_tpu_torch.scripts import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--max-iterations", "1"])
