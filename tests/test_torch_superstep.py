"""The runner's superstep (algo/runner.py): `learn` runs
`runner.iters_per_dispatch` iterations per dispatch and pulls their metrics
once per dispatch, and train.py prints the reference's console block every
`runner.log_interval` iterations.

The schedule of dispatches and saves is held against the reference
package's `OnPolicyRunner.learn`, its dispatch and save stubbed, so no XLA
program is built. The port runs on the CPU at 4 envs with 4-step rollouts
and 1 epoch of 2 minibatches, where a superstep runs uncaptured; there K = 3
must give K = 1's bits (parameters, Adam, carry, generator, every
iteration's metrics). The captured superstep is held against the eager one
on the card (tests/test_torch_cuda.py, chip_smoke.py's superstep phase).
"""
import dataclasses
import os
import sys
import types

import jax.numpy as jnp
import pytest
import torch

from humanoid_tpu.algo import runner as jrunner
from humanoid_tpu_torch.algo.runner import (IterationMetrics, OnPolicyRunner, chunk_schedule,
                                            pack_metrics)
from humanoid_tpu_torch.env.xbotl import EnvState
from humanoid_tpu_torch.utils import registry

N, T = 4, 4


def _cfgs(**runner):
    env_cfg, train_cfg = registry.get_cfgs("humanoid_ppo")
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=N))
    train_cfg = train_cfg.replace(
        runner=dataclasses.replace(train_cfg.runner, num_steps_per_env=T, **runner),
        algorithm=dataclasses.replace(train_cfg.algorithm, num_learning_epochs=1,
                                      num_mini_batches=2))
    return env_cfg, train_cfg


def _runner(**runner):
    env_cfg, train_cfg = _cfgs(**runner)
    return OnPolicyRunner(registry.build_env(env_cfg, registry.default_urdf(), "cpu"), train_cfg)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _reference_events(iterations, K, save_interval, start):
    """The reference's learn with its dispatch and save stubbed: the events
    ("dispatch", k) and ("save", iteration) in order."""
    ref = object.__new__(jrunner.OnPolicyRunner)
    ref.env = types.SimpleNamespace(cfg=types.SimpleNamespace(env=types.SimpleNamespace(
        num_envs=N)))
    ref.cfg = types.SimpleNamespace(runner=types.SimpleNamespace(
        num_steps_per_env=T, save_interval=save_interval, iters_per_dispatch=K,
        save_env_state=False))
    ref.log_dir, ref.iteration = "run", start
    events = []

    def superstep(k):
        def dispatch(carry):
            events.append(("dispatch", k))
            return carry, None
        return dispatch

    ref._train_superstep = superstep
    ref.save = lambda path=None: events.append(("save", ref.iteration))
    carry = types.SimpleNamespace(train_state=types.SimpleNamespace(params=jnp.zeros(1)))
    ref.learn(iterations, carry=carry)
    return events


@pytest.fixture(scope="module")
def small_runner():
    """A runner, a carry and one iteration's metrics."""
    runner = _runner()
    return (runner, *runner.train_iteration(runner.init_carry()))


@pytest.mark.parametrize("iterations,K,save_interval,start",
                         [(7, 3, 2, 0), (10, 50, 4, 0), (5, 1, 0, 0), (6, 4, 3, 0),
                          (7, 3, 2, 3)])
def test_chunk_schedule_and_saves_match_reference_learn(small_runner, monkeypatch, iterations,
                                                        K, save_interval, start):
    """chunk_schedule's dispatches and saves are the reference learn's, and
    the port's learn saves where the schedule says (its iterations stubbed
    with one iteration's metrics)."""
    events, it = [], start
    for k, save in chunk_schedule(iterations, start, K, save_interval):
        it += k
        events += [("dispatch", k)] + ([("save", it)] if save else [])
    assert events == _reference_events(iterations, K, save_interval, start)

    runner, carry, metrics = small_runner
    saves = []
    monkeypatch.setattr(runner, "cfg", _cfgs(iters_per_dispatch=K,
                                             save_interval=save_interval)[1])
    monkeypatch.setattr(runner, "iteration", start)
    monkeypatch.setattr(runner, "log_dir", "run")
    monkeypatch.setattr(runner, "train_iteration", lambda c, sync=True: (c, metrics))
    monkeypatch.setattr(runner, "_save_all", lambda c: saves.append(runner.iteration))
    runner.learn(iterations, carry=carry)
    assert saves == [i for kind, i in events if kind == "save"]
    assert runner.iteration == start + iterations


@pytest.fixture(scope="module")
def eager_and_superstep():
    """learn(6) at K = 1 and at K = 3 from the same seed: for each, the
    runner, the carry and log_fn's (iteration, metrics, env-steps/s, the
    runner's iteration count when it was called)."""
    out = {}
    for K in (1, 3):
        runner, seen = _runner(iters_per_dispatch=K), []
        carry = runner.learn(6, log_fn=lambda it, m, fps: seen.append(
            (it, m, fps, runner.iteration)))
        out[K] = (runner, carry, seen)
    return out


def test_superstep_gives_the_eager_bits(eager_and_superstep):
    (eager, ce, seen_e), (stepped, cs, seen_s) = eager_and_superstep[1], eager_and_superstep[3]
    assert (eager.dispatch_mode(), stepped.dispatch_mode()) == ("sync", "eager")
    for p, q in zip(eager.net.parameters(), stepped.net.parameters()):
        assert _same(p.detach(), q.detach())
    for xs, ys in ((eager.opt.mu, stepped.opt.mu), (eager.opt.nu, stepped.opt.nu)):
        assert all(_same(x, y) for x, y in zip(xs, ys))
    assert int(eager.opt.count) == int(stepped.opt.count) == 6 * 2
    assert _same(eager.opt.lr, stepped.opt.lr) and eager.iteration == stepped.iteration == 6
    for f in EnvState._fields:
        x, y = getattr(ce.env_state, f), getattr(cs.env_state, f)
        if f == "phys":
            assert all(_same(u, v) for u, v in zip(x, y))
        else:
            assert (x is None and y is None) or _same(x, y), f
    assert _same(ce.obs, cs.obs) and _same(ce.critic_obs, cs.critic_obs)
    assert torch.equal(eager.gen.get_state(), stepped.gen.get_state())
    assert [s[0] for s in seen_e] == [s[0] for s in seen_s] == [1, 2, 3, 4, 5, 6]
    for (_, m, _, _), (_, n, _, _) in zip(seen_e, seen_s):
        assert _same(pack_metrics(m), pack_metrics(n))
        assert m.kernel_launches == n.kernel_launches


def test_superstep_times_its_dispatches_and_logs_after_the_next(eager_and_superstep):
    """iteration_s is set in both modes and env-steps/s comes from it;
    rollout_s and update_s are the synchronized seconds at K = 1 and None
    under K = 3; a dispatch's metrics are logged after the next dispatch
    ran (the last one's at the end)."""
    steps = T * N
    for K, (runner, _, seen) in eager_and_superstep.items():
        for it, m, fps, _ in seen:
            assert isinstance(m, IterationMetrics) and m.iteration_s > 0
            assert fps == pytest.approx(steps / m.iteration_s)
            assert all(x.device.type == "cpu" for x in (m.update.lr, m.ep_rew_sums))
            if K == 1:
                assert m.rollout_s > 0 and m.update_s > 0
            else:
                assert m.rollout_s is None and m.update_s is None
        # the runner's count when each iteration was logged
        assert [s[3] for s in seen] == ([2, 3, 4, 5, 6, 6] if K == 1 else [6, 6, 6, 6, 6, 6])
    iteration_s = [m.iteration_s for _, m, _, _ in eager_and_superstep[3][2]]
    assert iteration_s[:3] == [iteration_s[0]] * 3 and iteration_s[3:] == [iteration_s[3]] * 3


def test_train_prints_the_reference_console_every_log_interval(tmp_path, monkeypatch, capsys):
    """train.main without log_fn: the reference's console block at
    iterations 2 and 4 of 4 (log_interval 2), and no JSON line."""
    from humanoid_tpu_torch.scripts import train

    small = _cfgs(log_interval=2)
    monkeypatch.setattr(registry, "get_cfgs", lambda task: small)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)   # a slow import here
    capsys.readouterr()
    runner, _ = train.main(["--device", "cpu", "--num-envs", str(N), "--max-iterations", "4",
                            "--log-root", str(tmp_path)])
    out = capsys.readouterr().out
    assert runner.iteration == 4 and runner.cfg.runner.iters_per_dispatch == 50
    assert [line.strip() for line in out.splitlines() if "Learning iteration" in line] == [
        "Learning iteration 2/4", "Learning iteration 4/4"]
    assert "Computation:" in out and "Iteration time:" in out
    assert not any(line.lstrip().startswith("{") for line in out.splitlines())
    assert os.path.isfile(os.path.join(runner.log_dir, "metrics.jsonl"))
