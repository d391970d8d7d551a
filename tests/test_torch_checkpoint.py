"""Checkpoints, resume, the run directory, the CLI overrides and the
training log of the port, against the reference package where it has the
same function.

The port runs on the CPU at 8 envs with short rollouts (plain kernel
versions). Stated tolerances: save -> load and an exact-state resume give
the same bits; a reference checkpoint carried into the port gives, on the
next PPO update, parameters within 1e-4 of the reference's and its
learning rate within 1e-6 (test_torch_algo.py's update tolerances).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import humanoid_tpu.config.structs as jcfg
from humanoid_tpu.algo import networks as jnet
from humanoid_tpu.algo import ppo as jppo
from humanoid_tpu.utils import checkpoint as jckpt
from humanoid_tpu_torch.algo import networks as tnet
from humanoid_tpu_torch.algo.ppo import Batch, ppo_update
from humanoid_tpu_torch.algo.runner import IterationCarry, OnPolicyRunner
from humanoid_tpu_torch.env.xbotl import EnvState
from humanoid_tpu_torch.utils import checkpoint, registry

N = 8
OBS, PRIV, ACT = 705, 219, 12
PORTED_TASKS = registry.list_tasks()


def _cfgs(task="humanoid_ppo", steps=2, **runner):
    env_cfg, train_cfg = registry.get_cfgs(task)
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=N))
    train_cfg = train_cfg.replace(runner=dataclasses.replace(
        train_cfg.runner, num_steps_per_env=steps, **runner))
    return env_cfg, train_cfg


def _runner(log_dir=None, **runner):
    env_cfg, train_cfg = _cfgs(**runner)
    env = registry.build_env(env_cfg, registry.default_urdf(), "cpu")
    return OnPolicyRunner(env, train_cfg, log_dir=log_dir)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _assert_same_training_state(a: OnPolicyRunner, b: OnPolicyRunner):
    for (name, p), (name_b, q) in zip(a.net.named_parameters(), b.net.named_parameters()):
        assert name == name_b and _same(p.detach(), q.detach()), name
    for buf_a, buf_b in ((a.opt.mu, b.opt.mu), (a.opt.nu, b.opt.nu)):
        assert all(_same(x, y) for x, y in zip(buf_a, buf_b))
    assert a.opt.count == b.opt.count and _same(a.opt.lr, b.opt.lr)
    assert a.iteration == b.iteration


def _assert_same_carry(a: IterationCarry, b: IterationCarry):
    for field in EnvState._fields:
        x, y = getattr(a.env_state, field), getattr(b.env_state, field)
        if field == "phys":
            assert all(_same(u, v) for u, v in zip(x, y))
        elif x is None:
            assert y is None, field
        else:
            assert _same(x, y), field
    assert _same(a.obs, b.obs) and _same(a.critic_obs, b.critic_obs)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A runner after one iteration (non-trivial Adam moments), saved."""
    r = _runner()
    carry = r.learn(1)
    d = tmp_path_factory.mktemp("ckpt")
    return r, carry, r.save(str(d / "model_1")), r.save_state(carry, str(d / "state_1"))


@pytest.mark.parametrize("load_optimizer", [True, False])
def test_save_then_load_gives_the_same_bits(trained, load_optimizer):
    r, _, path, _ = trained
    assert path.endswith("model_1.pt") and os.path.isfile(path)
    fresh = _runner()
    before = [b.clone() for b in fresh.opt.mu]
    fresh.load(path, load_optimizer=load_optimizer)
    if load_optimizer:
        _assert_same_training_state(r, fresh)
    else:
        for p, q in zip(r.net.parameters(), fresh.net.parameters()):
            assert _same(p.detach(), q.detach())
        assert fresh.iteration == r.iteration and fresh.opt.count == 0
        assert all(torch.equal(x, y) for x, y in zip(before, fresh.opt.mu))


def test_checkpoint_holds_adam_by_parameter_name_and_loads_weights_only(trained):
    r, _, path, state_path = trained
    payload = torch.load(path, weights_only=True)
    names = [n for n, _ in r.net.named_parameters()]
    assert set(payload) == {"model", "optimizer", "iteration"}
    assert sorted(payload["optimizer"]["mu"]) == sorted(names) == sorted(payload["optimizer"]["nu"])
    assert payload["optimizer"]["count"] == r.opt.count == 2 * 4
    state = torch.load(state_path, weights_only=True)
    assert set(state) == {"model", "optimizer", "iteration", "carry", "generator"}
    assert state["carry"]["env_state"]["body_com"] is None          # None fields kept
    assert set(state["carry"]["env_state"]["phys"]) == {"base_pos", "base_quat", "qj", "u"}
    # a reordered or renamed module fails loudly instead of loading mismatched moments
    payload["optimizer"]["mu"]["actor.renamed"] = payload["optimizer"]["mu"].pop(names[0])
    with pytest.raises(KeyError, match="keyed by"):
        _runner()._restore(payload)


def test_load_state_restores_carry_and_generator(trained):
    r, carry, _, state_path = trained
    fresh = _runner()
    restored = fresh.load_state(state_path)
    _assert_same_training_state(r, fresh)
    _assert_same_carry(carry, restored)
    assert torch.equal(fresh.gen.get_state(), r.gen.get_state())


def test_exact_state_resume_repeats_the_unbroken_run(tmp_path):
    """2 + 2 iterations through state_2.pt against 4 unbroken: the same bits
    in the parameters, Adam, episode lengths, the whole carry and the
    generator."""
    unbroken = _runner()
    c4 = unbroken.learn(4)
    first = _runner(log_dir=str(tmp_path), save_interval=2, save_env_state=True)
    first.learn(2)
    assert sorted(os.listdir(tmp_path)) == ["model_2.pt", "state_2.pt"]
    resumed = _runner()
    carry = resumed.load_state(str(tmp_path / "state_2"))
    assert resumed.iteration == 2
    c = resumed.learn(2, carry=carry)
    _assert_same_training_state(unbroken, resumed)
    assert torch.equal(c.env_state.episode_length, c4.env_state.episode_length)
    _assert_same_carry(c4, c)
    assert torch.equal(resumed.gen.get_state(), unbroken.gen.get_state())


@pytest.mark.parametrize("mode", ["plain", "full_state"])
def test_runner_resumes_from_its_checkpoint(trained, tmp_path, mode):
    """A config with runner.resume set builds a runner (make_alg_runner with
    a log root), which restores the model and optimizer (plain) or the exact
    state (full_state) and trains on."""
    r, carry, path, state_path = trained
    env_cfg, train_cfg = _cfgs(resume=True)
    env = registry.build_env(env_cfg, registry.default_urdf(), "cpu")
    runner = registry.make_alg_runner(env, train_cfg, log_root=str(tmp_path))
    assert isinstance(runner, OnPolicyRunner) and runner.iteration == 0
    assert runner.log_dir.startswith(str(tmp_path / train_cfg.runner.experiment_name))
    if mode == "plain":
        runner.load(path)
        start = None
    else:
        start = runner.load_state(state_path)
    _assert_same_training_state(r, runner)
    c = runner.learn(1, carry=start)
    assert runner.iteration == 2 and runner.opt.count == 16
    assert all(torch.isfinite(p).all() for p in runner.net.parameters())
    assert bool(torch.isfinite(c.obs).all())
    assert sorted(os.listdir(runner.log_dir)) == ["model_2.pt"]


def test_make_alg_runner_with_log_root_false_writes_nothing(tmp_path):
    env_cfg, train_cfg = _cfgs()
    env = registry.build_env(env_cfg, registry.default_urdf(), "cpu")
    runner = registry.make_alg_runner(env, train_cfg, log_root=False)
    assert runner.log_dir is None
    runner.learn(1)
    explicit = registry.make_alg_runner(env, train_cfg, log_dir=str(tmp_path / "run"))
    assert explicit.log_dir == str(tmp_path / "run") and not os.path.exists(explicit.log_dir)


@pytest.mark.parametrize("load_run,it", [("-1", -1), ("Oct01_10-00-00_b", -1), ("-1", 20),
                                         ("Oct02_09-00-00_", 5)])
def test_get_load_path_matches_reference(tmp_path, load_run, it):
    """The same run and checkpoint as the reference's lookup on one tree of
    run directories (each checkpoint in both file forms)."""
    tree = {"Oct01_10-00-00_b": [5, 20, 100], "Oct02_09-00-00_": [5, 40],
            "Oct02_09-00-00_a": [20, 3]}
    for run, its in tree.items():
        os.makedirs(tmp_path / run)
        for i in its:
            (tmp_path / run / f"model_{i}.pt").touch()
            (tmp_path / run / f"model_{i}.npz").touch()
        (tmp_path / run / "state_999.pt").touch()
        (tmp_path / run / "metrics.jsonl").touch()
    (tmp_path / "Oct09_not_a_dir").touch()
    want = jckpt.get_load_path(str(tmp_path), load_run, it)
    assert checkpoint.get_load_path(str(tmp_path), load_run, it) == want
    assert checkpoint.state_path_of(want) == want.replace("model_", "state_")


def test_get_load_path_reports_empty_runs(tmp_path):
    with pytest.raises(FileNotFoundError, match="no runs"):
        checkpoint.get_load_path(str(tmp_path))
    os.makedirs(tmp_path / "Oct01_run")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        checkpoint.get_load_path(str(tmp_path))


def _cli_args(module, task, extra):
    return module.get_args(["--task", task, "--experiment-name", "exp", "--run-name", "r1",
                            "--resume", *extra])


@pytest.mark.parametrize("task", PORTED_TASKS)
def test_cli_overrides_match_reference(task):
    """--experiment-name, --run-name, --resume and --terrain reach the
    configs as in the reference's update_cfg_from_args."""
    from humanoid_tpu.scripts import train as jtrain
    from humanoid_tpu.utils import registry as jreg
    from humanoid_tpu_torch.scripts import train

    terrain = "plane" if "terrain" in task or "trimesh" in task else "heightfield"
    extra = ["--terrain", terrain, "--load-run", "Oct01_x", "--checkpoint", "7"]
    je, jt = jreg.update_cfg_from_args(*jreg.get_cfgs(task), _cli_args(jtrain, task, extra))
    te, tt = registry.update_cfg_from_args(*registry.get_cfgs(task),
                                           _cli_args(train, task, extra))
    assert (tt.runner.experiment_name, tt.runner.run_name, tt.runner.resume) == ("exp", "r1", True)
    assert te.terrain.mesh_type == terrain
    assert dataclasses.asdict(te) == dataclasses.asdict(je)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    targs = train.get_args(["--resume", "--load-run", "Oct01_x", "--checkpoint", "7",
                            "--log-root", "/x", "--full-state"])
    jargs = jtrain.get_args(["--resume", "--load-run", "Oct01_x", "--checkpoint", "7",
                             "--log-root", "/x", "--full-state"])
    for name in ("resume", "load_run", "checkpoint", "log_root", "full_state"):
        assert getattr(targs, name) == getattr(jargs, name), name


def test_run_dir_is_the_reference_layout(tmp_path):
    _, train_cfg = _cfgs(experiment_name="exp", run_name="r1")
    d = registry.run_dir(train_cfg, str(tmp_path))
    head, leaf = os.path.split(d)
    assert head == str(tmp_path / "exp") and leaf.endswith("_r1")
    assert len(leaf.split("_")[0]) == 5                       # %b%d, e.g. Oct17
    assert registry.run_dir(train_cfg).startswith(os.path.join(registry.LOG_ROOT, "exp"))


def _small_cfgs(monkeypatch, **runner):
    orig = registry.get_cfgs

    def small(name):
        e, t = orig(name)
        return e, t.replace(runner=dataclasses.replace(t.runner, num_steps_per_env=2, **runner))

    monkeypatch.setattr(registry, "get_cfgs", small)


def test_train_cli_saves_and_logs_as_the_reference(tmp_path, monkeypatch, capsys):
    """train.main --device cpu --log-root: model_<it>.pt every save_interval
    and at the end, state_<it>.pt beside each with --full-state, and
    metrics.jsonl whose keys are the reference TrainLogger.log's on the same
    reward names and metrics; --resume then continues from the exact state."""
    from humanoid_tpu.utils.logging import TrainLogger as RefLogger
    from humanoid_tpu_torch.scripts import train

    _small_cfgs(monkeypatch, save_interval=2)
    seen = []
    argv = ["--device", "cpu", "--num-envs", str(N), "--log-root", str(tmp_path)]
    runner, _ = train.main(argv + ["--max-iterations", "3", "--full-state"],
                           log_fn=lambda it, m, fps: seen.append((it, m, fps)))
    run = runner.log_dir
    assert os.path.dirname(run) == str(tmp_path / "XBot_ppo")
    files = set(os.listdir(run))
    assert {"model_2.pt", "model_3.pt", "state_2.pt", "state_3.pt", "metrics.jsonl"} <= files
    assert not any(f.startswith(("model_1", "state_1")) for f in files)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["it"] for r in rows] == [1, 2, 3] == [it for it, _, _ in seen]
    env_cfg, train_cfg = registry.get_cfgs("humanoid_ppo")
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=N))
    ref = RefLogger(None, runner.env.reward_names, env_cfg, train_cfg)
    ref_keys = set(ref.log(1, seen[0][1], seen[0][2], 1.0))
    assert set(rows[0]) - {"it"} == ref_keys
    assert {f"Episode/rew_{n}" for n in runner.env.reward_names} < ref_keys
    assert rows[0]["Loss/learning_rate"] == pytest.approx(float(seen[0][1].update.lr))

    capsys.readouterr()
    resumed, _ = train.main(argv + ["--max-iterations", "1", "--resume"])
    assert "resuming exact state from" in capsys.readouterr().out
    assert resumed.iteration == 4
    assert os.path.isfile(os.path.join(resumed.log_dir, "model_4.pt"))


def _fake_metrics(levels):
    from humanoid_tpu_torch.algo.ppo import UpdateMetrics
    from humanoid_tpu_torch.algo.runner import IterationMetrics

    z = torch.tensor(0.5)
    hist = torch.bincount(levels, minlength=10)[:10].float() / len(levels)
    return IterationMetrics(
        update=UpdateMetrics(*(z for _ in UpdateMetrics._fields)), mean_step_reward=z,
        ep_rew_sums=torch.arange(4.0), ep_count=torch.tensor(3.0), ep_len_sum=torch.tensor(90.0),
        ep_term_count=torch.tensor(1.0), mean_action_std=z, rew_terms_mean=torch.zeros(4),
        rollout_s=1.0, update_s=0.5, kernel_launches=0, sampler_launches=0, factor_launches=0,
        apply_launches=0, solve_launches=0, terrain_level_mean=levels.float().mean(),
        terrain_level_hist=hist)


@pytest.mark.parametrize("levels", [[0, 0, 0, 0], [0, 3, 5, 9]])
def test_train_logger_scalars_equal_the_reference(tmp_path, levels):
    """The same scalars, names and values, on the plane (no terrain keys)
    and on the terrain curriculum (mean level and the 10-row occupancy)."""
    from humanoid_tpu.utils.logging import TrainLogger as RefLogger
    from humanoid_tpu_torch.utils.logging import TrainLogger

    env_cfg, train_cfg = _cfgs()
    names = ["a", "b", "c", "d"]
    m = _fake_metrics(torch.tensor(levels))
    port = TrainLogger(str(tmp_path), names, env_cfg, train_cfg)
    got = port.log(1, m, 123.0, 1.5)
    want = RefLogger(None, names, env_cfg, train_cfg).log(1, m, 123.0, 1.5)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert ("Train/terrain_level_occ_9" in got) == any(levels)
    assert "Learning iteration 1/10" in port.console(1, 10, got)
    port.close()
    with open(tmp_path / "metrics.jsonl") as f:
        assert json.loads(f.readline()) == {"it": 1, **got}


def test_reference_checkpoint_carries_into_the_port(tmp_path, monkeypatch):
    """One reference PPO update, its checkpoint written by the .npz path
    (orbax absent), loaded into a port runner; the next update on the same
    batch agrees within the update tolerances."""
    acfg = jcfg.AlgorithmCfg(learning_rate=1e-3)
    jn = jnet.ActorCritic(num_actions=ACT, compute_dtype="float32")
    params = jnet.init_params(jax.random.PRNGKey(4), jn, OBS, PRIV)
    B = 64
    rng = np.random.default_rng(4)
    obs = rng.normal(size=(B, OBS)).astype(np.float32)
    priv = rng.normal(size=(B, PRIV)).astype(np.float32)
    mu = rng.normal(size=(B, ACT)).astype(np.float32) * 0.3
    actions = (mu + rng.normal(size=(B, ACT))).astype(np.float32)
    sigma = np.ones((B, ACT), np.float32)
    batch = dict(obs=obs, critic_obs=priv, actions=actions,
                 old_logp=np.asarray(jnet.log_prob(mu, sigma, actions)), old_mu=mu,
                 old_sigma=sigma, target_values=rng.normal(size=B).astype(np.float32),
                 advantages=rng.normal(size=B).astype(np.float32),
                 returns=rng.normal(size=B).astype(np.float32))
    vel_slice = (53, 56)
    k1, k2 = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    ts1, _ = jppo.ppo_update(jn, acfg, jppo.init_train_state(params, acfg), jppo.Batch(**batch),
                             k1, vel_slice)
    monkeypatch.setattr(jckpt, "_have_orbax", lambda: False)
    payload = {"params": ts1.params, "opt_state": ts1.opt_state, "lr": ts1.lr,
               "iteration": jnp.asarray(7)}
    jckpt.save_checkpoint(str(tmp_path / "model_7"), jax.device_get(payload))
    assert os.path.isfile(tmp_path / "model_7.npz")

    env_cfg, train_cfg = _cfgs()
    train_cfg = train_cfg.replace(
        policy=dataclasses.replace(train_cfg.policy, compute_dtype="float32"),
        algorithm=dataclasses.replace(train_cfg.algorithm, learning_rate=1e-3))
    runner = OnPolicyRunner(registry.build_env(env_cfg, registry.default_urdf(), "cpu"),
                            train_cfg)
    checkpoint.load_reference_checkpoint(runner, str(tmp_path / "model_7"))
    assert runner.iteration == 7 and runner.opt.count == int(ts1.opt_state[1].count) == 8
    assert float(runner.opt.lr) == float(ts1.lr)
    want_p = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT), jax.device_get(ts1.params))
    for p, q in zip(runner.net.parameters(), want_p.parameters()):
        assert torch.equal(p.detach(), q.detach())
    mu0 = ts1.opt_state[1].mu["params"]["actor"]["Dense_0"]["kernel"]
    names = [n for n, _ in runner.net.named_parameters()]
    port_mu = dict(zip(names, runner.opt.mu))["actor.layers.0.weight"]
    assert torch.equal(port_mu, torch.as_tensor(np.asarray(mu0)).T)

    ts2, _ = jppo.ppo_update(jn, acfg, ts1, jppo.Batch(**batch), k2, vel_slice)
    g = acfg.shuffle_granule
    tiles = np.asarray(jax.random.permutation(k2, B // g))
    perm = torch.as_tensor((tiles[:, None] * g + np.arange(g)).reshape(-1))
    tbatch = Batch(**{k: torch.as_tensor(np.array(v)) for k, v in batch.items()})
    tm = ppo_update(runner.net, train_cfg.algorithm, runner.opt, tbatch, perm, vel_slice)
    after = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT), jax.device_get(ts2.params))
    for (name, p), q in zip(runner.net.named_parameters(), after.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(float(tm.lr), float(ts2.lr), rtol=1e-6)
    assert runner.opt.count == 16
