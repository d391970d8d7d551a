"""The port's small modules against the reference package's: the profiling
helpers (utils/profiling.py) and `train --profile`, the stateful VecEnv
facade (env/vec_env.py), the gait-curve tool (utils/calculate_gait.py) and
the MJCF export (physics/mjcf_export.py).

Tolerances: PhaseTimer's totals, counts and report equal under a fake
clock; the VecEnv's dones and timeout flags exactly, its obs, privileged
obs, rewards and episode means at atol 1e-4 (the env's own bounds) over a
reset step and 3 steps in which two envs time out and reset (their fresh
states are random draws that differ between the packages, so those envs
are compared only up to their reset); the gait coefficients and curves to 1e-10
(both solve the same float64 system); the MJCF text equal.
"""
import dataclasses
import glob
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import humanoid_tpu.config.structs as jcfg
from humanoid_tpu.env.vec_env import VecEnvAdapter as JaxVecEnv
from humanoid_tpu.env.xbotl import XBotLEnv as JaxEnv
from humanoid_tpu.physics.mjcf_export import model_to_mjcf as jax_model_to_mjcf
from humanoid_tpu.physics.urdf import load_urdf as jax_load_urdf
from humanoid_tpu.utils import calculate_gait as jgait
from humanoid_tpu.utils import profiling as jprof
import humanoid_tpu_torch.config.structs as tcfg
from humanoid_tpu_torch.assets import write_xbot18_topology_urdf, write_xbot_topology_urdf
from humanoid_tpu_torch.env.vec_env import VecEnvAdapter
from humanoid_tpu_torch.env.xbotl import EnvState, XBotLEnv
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.physics.mjcf_export import model_to_mjcf
from humanoid_tpu_torch.physics.urdf import load_urdf
from humanoid_tpu_torch.utils import calculate_gait as tgait
from humanoid_tpu_torch.utils import profiling as tprof
from humanoid_tpu_torch.utils import registry

N = 8
ATOL = 1e-4


# ---------------------------------------------------------------------------
# profiling

def test_phase_timer_matches_reference_under_a_fake_clock(monkeypatch):
    def run(mod):
        ticks = iter([10.0, 10.5, 11.0, 11.25, 12.0, 13.75, 14.0, 14.125])
        monkeypatch.setattr(time, "time", lambda: next(ticks))
        timer = mod.PhaseTimer()
        for name in ("rollout", "update", "rollout", "save"):
            with timer(name):
                pass
        return dict(timer.totals), dict(timer.counts), timer.report(), timer.fps(4096 * 60)

    got, want = run(tprof), run(jprof)
    assert got == want
    assert got[0] == {"rollout": 2.25, "update": 0.25, "save": 0.125}
    assert got[1] == {"rollout": 2, "update": 1, "save": 1}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "run")) as prof:
        with torch.profiler.record_function("probe"):
            torch.ones(64).cumsum(0).sum()
    files = glob.glob(str(tmp_path / "run" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "probe" for e in events)
    assert any(a.key == "aten::cumsum" for a in prof.key_averages())


def test_train_profile_writes_its_trace_into_the_run_directory(tmp_path, monkeypatch, capsys):
    """train --profile 1 --device cpu at 4 envs and 2 steps per iteration:
    one warm-up iteration, one traced, one after; the trace in the run
    directory holds the traced iteration's `rollout` span."""
    from humanoid_tpu_torch.scripts import train

    orig = registry.get_cfgs

    def small(name):
        e, t = orig(name)
        return e, t.replace(runner=dataclasses.replace(t.runner, num_steps_per_env=2))

    monkeypatch.setattr(registry, "get_cfgs", small)
    seen = []
    runner, _ = train.main(["--device", "cpu", "--num-envs", "4", "--max-iterations", "3",
                            "--profile", "1", "--log-root", str(tmp_path)],
                           log_fn=lambda it, m, fps: seen.append(it))
    assert seen == [1, 2, 3] and runner.iteration == 3
    assert f"trace written under {runner.log_dir}" in capsys.readouterr().out
    files = glob.glob(os.path.join(runner.log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "rollout" for e in events) == 1
    assert os.path.isfile(os.path.join(runner.log_dir, "model_3.pt"))


# ---------------------------------------------------------------------------
# the VecEnv facade

def make_cfg(mod, urdf):
    return mod.XBotLCfg(
        env=mod.EnvCfg(num_envs=N), asset=mod.AssetCfg(urdf=urdf),
        sim=mod.SimCfg(contact_model="pgs", pgs_iterations=6, pgs_freeze_prep=False),
        domain_rand=mod.DomainRandCfg(action_delay=False, dynamic_randomization=0.0,
                                      push_robots=False),
        noise=mod.NoiseCfg(add_noise=False),
    )


def to_port_state(js) -> EnvState:
    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)

    phys = PhysState(*(t(x) for x in js.phys))
    skip = ("phys", "common_step", "terrain_planes")
    fields = {f: t(getattr(js, f)) for f in EnvState._fields if f not in skip}
    return EnvState(phys=phys, common_step=t(js.common_step, torch.int64), **fields)


def test_vec_env_matches_reference(tmp_path):
    urdf = write_xbot_topology_urdf(str(tmp_path))
    jvenv = JaxVecEnv(JaxEnv(make_cfg(jcfg, urdf)), seed=0)
    tvenv = VecEnvAdapter(XBotLEnv(make_cfg(tcfg, urdf), urdf, device="cpu"), seed=0)
    for name in ("num_envs", "num_obs", "num_privileged_obs", "num_actions",
                 "max_episode_length"):
        assert getattr(tvenv, name) == getattr(jvenv, name), name
    # the reference's initial state in both; envs 0 and 1 at the end of an
    # episode, so that they time out and reset within the steps
    js0 = jvenv.env.initial_state(jax.random.PRNGKey(3))
    el = np.zeros(N, np.int32)
    el[:2] = jvenv.max_episode_length
    js0 = js0._replace(episode_length=jnp.asarray(el))
    jvenv._state, tvenv._state = js0, to_port_state(js0)
    rng = np.random.default_rng(1)
    actions = [np.zeros((N, 12), np.float32)] + [
        rng.uniform(-0.5, 0.5, (N, 12)).astype(np.float32) for _ in range(3)]
    fresh = np.zeros(N, bool)          # envs that reset so far: random states since
    for a in actions:                  # the reset step, then 3 steps
        jo, jp, jr, jd, je = jvenv.step(a)
        to, tp, tr, td, te = tvenv.step(a)
        same = ~fresh                  # envs whose step both packages took from one state
        np.testing.assert_array_equal(td.numpy()[same], np.asarray(jd)[same])
        np.testing.assert_array_equal(te["time_outs"].numpy()[same],
                                      np.asarray(je["time_outs"])[same])
        np.testing.assert_allclose(tr.numpy()[same], np.asarray(jr)[same], atol=ATOL)
        assert sorted(te["episode"]) == sorted(je["episode"])
        for k, v in je["episode"].items():
            np.testing.assert_allclose(float(te["episode"][k]), float(v), atol=ATOL, err_msg=k)
        fresh |= np.asarray(jd)
        keep = ~fresh
        np.testing.assert_allclose(to.numpy()[keep], np.asarray(jo)[keep], atol=ATOL)
        np.testing.assert_allclose(tp.numpy()[keep], np.asarray(jp)[keep], atol=ATOL)
        assert tvenv.get_observations() is to and tvenv.get_privileged_observations() is tp
    assert fresh[:2].all() and not fresh[2:].any()
    assert tvenv.episode_length_buf.tolist() == np.asarray(jvenv.episode_length_buf).tolist()
    obs, priv = tvenv.reset()
    assert obs.shape == (N, tvenv.num_obs) and priv.shape == (N, tvenv.num_privileged_obs)
    assert bool(torch.isfinite(obs).all())


# ---------------------------------------------------------------------------
# the gait-curve tool

@pytest.mark.parametrize("kw", [{}, {"T": 0.4, "t_apex": 0.22, "h_apex": 0.08, "v_end": -0.2},
                                {"h_end": 0.01, "v0": 0.05}])
def test_quintic_swing_matches_reference(kw):
    c_t, c_j = tgait.solve_quintic_swing(**kw), jgait.solve_quintic_swing(**kw)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-10)
    t = np.linspace(0.0, kw.get("T", 0.32), 50)
    for a, b in zip(tgait.evaluate(c_t, t), jgait.evaluate(c_j, t)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_gait_main_plots_only_where_matplotlib_imports(tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "gait.png")
    assert tgait.main(path) == path and os.path.isfile(path)
    assert "apex height" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    other = str(tmp_path / "none.png")
    assert tgait.main(other) is None and not os.path.exists(other)


# ---------------------------------------------------------------------------
# the MJCF export

@pytest.mark.parametrize("robot", ["xbot12", "xbot18"])
@pytest.mark.parametrize("kw", [{}, {"perturb": 0.1, "perturb_seed": 3},
                                {"with_floor": True, "friction": 0.7}])
def test_mjcf_export_matches_reference_text(tmp_path, robot, kw):
    write = write_xbot18_topology_urdf if robot == "xbot18" else write_xbot_topology_urdf
    urdf = write(str(tmp_path))
    text = model_to_mjcf(load_urdf(urdf, armature=0.01), **kw)
    assert text == jax_model_to_mjcf(jax_load_urdf(urdf, armature=0.01), **kw)
    assert text.count('type="hinge"') == (18 if robot == "xbot18" else 12)
