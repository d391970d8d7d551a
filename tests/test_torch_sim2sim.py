"""The deploy side of the port against the reference package: the MuJoCo
sim2sim replay (deploy/sim2sim.py), the command matrix (gate_matrix.py),
the per-checkpoint eval gate (eval_gate.py) with `train --eval-gate`,
`sweep --eval-gate` and `--wandb`, the terrain oracle, `play --video` and
the joystick.

The robot is the 12-dof stand-in (`write_xbot_topology_urdf`), exported to
MJCF by physics/mjcf_export.py; where the reference's `cfg_for_task` needs
its robot, its `registry.get_cfgs` is patched to point `asset.urdf` at the
same stand-in. The policy's weights come from a numpy seed. Stated
tolerances: `run_mujoco`'s metrics and recorded states, `cfg_for_task`,
`judge_cell`, the gate's verdict and `run_matrix` equal the reference's
exactly (the same MJCF and .npz in, the same float64 arithmetic); a gate
replay in its subprocess records the in-process metrics exactly; the gate's
export within 1e-5 of the float32 actor.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from humanoid_tpu.deploy import eval_gate as jeval_gate
from humanoid_tpu.deploy import gate_matrix as jgate_matrix
from humanoid_tpu.deploy import sim2sim as jsim2sim
from humanoid_tpu.deploy.npz_policy import NpzPolicy as RefNpzPolicy
from humanoid_tpu.utils import registry as jreg
from humanoid_tpu_torch.algo.networks import ActorCritic
from humanoid_tpu_torch.deploy import eval_gate, export, gate_matrix, sim2sim, terrain_oracle
from humanoid_tpu_torch.deploy.npz_policy import NpzPolicy
from humanoid_tpu_torch.utils import registry

TASK = "humanoid_ppo"
TOL = 1e-5


def seeded_net(seed, task=TASK):
    """The task's ActorCritic with every parameter drawn from a numpy seed
    (small weights: the robot neither stands still nor flails)."""
    e = registry.get_cfgs(task)[0].env
    net = ActorCritic(e.num_observations, e.num_privileged_obs, e.num_actions)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.as_tensor(rng.normal(0.0, 0.02, tuple(p.shape)), dtype=torch.float32))
    return net


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return export.export_policy_npz(seeded_net(0), str(tmp_path_factory.mktemp("x") / "p.npz"))


@pytest.fixture(scope="module")
def cfg():
    return sim2sim.cfg_for_task(TASK, duration=2.0)


def ref_cfg(cfg):
    """The reference's Sim2simCfg with the port's values."""
    out = jsim2sim.Sim2simCfg(**dataclasses.asdict(cfg))
    out.tau_limit = cfg.tau_limit
    return out


def schedules():
    """(command_source, push_schedule) of the option case: walk, then a
    zero command from 1 s (the stand/walk switch freezes the gait clock),
    and a 50 N shove in +x from 0.5 s to 0.7 s."""
    calls = [0]

    def command_source():
        calls[0] += 1
        return (0.4, 0.0, 0.0) if calls[0] <= 100 else (0.0, 0.0, 0.0)

    def push_schedule(t):
        return np.array([50.0, 0.0, 0.0]) if 0.5 <= t < 0.7 else np.zeros(3)

    return command_source, push_schedule


@pytest.mark.parametrize("options", [False, True], ids=["plain", "heading_sw_switch_push"])
def test_run_mujoco_matches_the_reference_in_bits(npz, cfg, options):
    runs = []
    for mod, policy, c in ((sim2sim, NpzPolicy(npz), cfg),
                           (jsim2sim, RefNpzPolicy(npz), ref_cfg(cfg))):
        kw = {}
        if options:
            source, push = schedules()
            kw = dict(command_source=source, push_schedule=push, heading_hold=True,
                      sw_switch=True)
        runs.append(mod.run_mujoco(policy, c, record_states=True, **kw))
    got, want = runs
    states, want_states = got.pop("states"), want.pop("states")
    assert got == want
    assert states.shape == want_states.shape and states.shape[0] > 10
    assert states.tobytes() == want_states.tobytes()
    assert all(isinstance(v, float) for v in got.values())


@pytest.mark.parametrize("task", [TASK, "d11_ppo"])
def test_cfg_for_task_matches_the_reference(task, monkeypatch):
    port = sim2sim.cfg_for_task(task, duration=3.0, oracle_perturb=0.1)
    urdf = registry.robot(registry.get_cfgs(task)[0])[0]
    task_cfgs = jreg.get_cfgs

    def on_the_stand_in(name):
        e, t = task_cfgs(name)
        return e.replace(asset=dataclasses.replace(e.asset, urdf=urdf)), t

    monkeypatch.setattr(jreg, "get_cfgs", on_the_stand_in)
    ref = jsim2sim.cfg_for_task(task, duration=3.0, oracle_perturb=0.1)
    for f in dataclasses.fields(port):
        if f.name != "mujoco_model_path":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.tau_limit == ref.tau_limit and len(port.tau_limit) == port.num_actions
    with open(port.mujoco_model_path) as a, open(ref.mujoco_model_path) as b:
        assert a.read() == b.read()
    os.unlink(ref.mujoco_model_path)


# ---------------------------------------------------------------------------
# the command matrix and the gate's verdict, on the reference tests' cases

DT = 0.01


def fabricated_states(duration, vel, yaw_rate=0.0, z=0.95):
    """run_mujoco-style 100 Hz rows [qpos(7 + 12), ...] of a base moving at
    vel(t) with a constant yaw rate."""
    n = int(duration / DT) + 1
    rows, xy = [], np.zeros(2)
    for i in range(n):
        t = i * DT
        yaw = yaw_rate * t
        rows.append(np.concatenate([xy, [z], [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)],
                                    np.zeros(12)]))
        xy = xy + np.asarray(vel(t)) * DT
    return np.asarray(rows)


def turning(t):
    return (0.35 * math.cos(0.3 * t), 0.35 * math.sin(0.3 * t))


TRAJECTORIES = {
    "forward": (lambda t: (0.45, 0.0), 0.0),
    "backward": (lambda t: (-0.25, 0.0), 0.0),
    "left": (lambda t: (0.0, 0.25), 0.0),
    "right": (lambda t: (0.0, -0.25), 0.0),
    "turning_left": (turning, 0.3),
    "drift": (lambda t: (0.05, 0.0), 0.0),
    "run_off": (lambda t: (0.4, 0.0), 0.0),
    "stop_at_10": (lambda t: (0.45, 0.0) if t < 10.0 else (0.0, 0.0), 0.0),
    "walk_stand_walk": (lambda t: (0.45, 0.0) if t < 10.0 or t >= 18.0 else (0.0, 0.0), 0.0),
}
ENDINGS = {"upright": (None, 0.95), "fell": (3.2, 0.95), "crouched": (None, 0.5)}


def test_default_cells_are_the_references():
    assert [dataclasses.astuple(c) for c in gate_matrix.default_cells(0.6)] == \
        [dataclasses.astuple(c) for c in jgate_matrix.default_cells(0.6)]


@pytest.mark.parametrize("ending", sorted(ENDINGS))
@pytest.mark.parametrize("trajectory", sorted(TRAJECTORIES))
def test_judge_cell_matches_the_reference(trajectory, ending):
    vel, yaw_rate = TRAJECTORIES[trajectory]
    survived, z = ENDINGS[ending]
    verdicts = []
    for cell, ref_cell in zip(gate_matrix.default_cells(), jgate_matrix.default_cells()):
        states = fabricated_states(cell.duration, vel, yaw_rate)
        metrics = {"survived_s": survived or cell.duration, "final_base_z": z,
                   "distance_m": 1.5, "mean_speed": 0.3}
        got = gate_matrix.judge_cell(cell, dict(metrics), states, DT)
        assert got == jgate_matrix.judge_cell(ref_cell, dict(metrics), states, DT), cell.name
        verdicts.append(got["passed"])
    if ending != "upright":
        assert not any(verdicts)


VERDICT_CASES = [
    (10.0, (0.5, 0.0, 0.0), {"survived_s": 10.0, "distance_m": 4.2, "mean_speed": 0.42,
                             "final_base_z": 0.87}),
    (10.0, (0.5, 0.0, 0.0), {"survived_s": 4.5, "distance_m": 0.8, "mean_speed": 0.18,
                             "final_base_z": 0.3}),
    (20.0, (0.5, 0.0, 0.0), {"survived_s": 20.0, "distance_m": 0.05, "mean_speed": 0.0025,
                             "final_base_z": 0.88}),
    (60.0, (0.5, 0.0, 0.0), {"survived_s": 60.0, "distance_m": 16.2, "mean_speed": 0.27,
                             "final_base_z": 0.87}),
    (60.0, (0.5, 0.0, 0.0), {"survived_s": 60.0, "distance_m": 24.0, "mean_speed": 0.40,
                             "final_base_z": 0.55}),
    (60.0, (0.5, 0.0, 0.0), {"survived_s": 60.0, "distance_m": 24.0, "final_base_z": 0.9}),
    (60.0, (0.0, 0.0, 0.0), {"survived_s": 60.0, "distance_m": 0.02, "final_base_z": 0.9}),
    (60.0, (0.0, 0.0, 0.0), {"survived_s": 12.0}),
]


@pytest.mark.parametrize("case", range(len(VERDICT_CASES)))
def test_gate_verdict_matches_the_reference(case, tmp_path):
    duration, cmd, metrics = VERDICT_CASES[case]
    got = eval_gate.CheckpointEvalGate(str(tmp_path), duration=duration, cmd=cmd)
    want = jeval_gate.CheckpointEvalGate(str(tmp_path), duration=duration, cmd=cmd)
    assert got.verdict(metrics) == want.verdict(metrics)


def test_run_matrix_matches_the_reference(npz, cfg, tmp_path):
    """A 1.5 s walk-stand cell with a shove, judged segment by segment (the
    seeded policy topples the stand-in soon after 2 s), and a 2 s forward
    cell."""
    cells = [gate_matrix.GateCell("walk_stand_push", 1.5,
                                  ((0.0, (0.5, 0.0, 0.0)), (0.75, (0.0, 0.0, 0.0))),
                                  pushes=((0.4, 0.2, (20.0, 0.0, 0.0)),), settle_s=0.2),
             gate_matrix.GateCell("forward_2s", 2.0, ((0.0, (0.5, 0.0, 0.0)),), settle_s=0.5)]
    ref_cells = [jgate_matrix.GateCell(**dataclasses.asdict(c)) for c in cells]
    got = gate_matrix.run_matrix(NpzPolicy(npz), cfg, cells, out_path=str(tmp_path / "a.jsonl"),
                                 iteration=3)
    want = jgate_matrix.run_matrix(RefNpzPolicy(npz), ref_cfg(cfg), ref_cells,
                                   out_path=str(tmp_path / "b.jsonl"), iteration=3)
    assert got == want and len(got[0]["segments"]) == 2 and len(got[1]["segments"]) == 1
    assert (tmp_path / "a.jsonl").read_text() == (tmp_path / "b.jsonl").read_text()


# ---------------------------------------------------------------------------
# the eval gate's plumbing (the reference's tests/test_eval_gate.py cases)

@pytest.fixture(autouse=True)
def fast_polls(monkeypatch):
    monkeypatch.setattr(eval_gate, "POLL_S", 0.1)


def fake_proc(stdout_line: str, rc: int = 0):
    code = f"import sys; print({stdout_line!r}); sys.exit({rc})"
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_gate_parses_replays_and_records_crashes(tmp_path):
    gate = eval_gate.CheckpointEvalGate(str(tmp_path), duration=10.0)
    gate._procs += [
        (100, "x.npz", fake_proc("{'survived_s': 10.0, 'distance_m': 4.2, 'mean_speed': 0.42, "
                                 "'final_base_z': 0.87}"), time.time()),
        (200, "y.npz", fake_proc("{'survived_s': 4.5, 'distance_m': 0.8, 'mean_speed': 0.18, "
                                 "'final_base_z': 0.3}"), time.time()),
        (300, "z.npz", fake_proc("'boom'", rc=3), time.time())]
    gate.wait_all(timeout=30)
    by_it = {r["iteration"]: r for r in gate.results}
    assert by_it[100]["passed"] is True and by_it[100]["distance_m"] == 4.2
    assert by_it[200]["passed"] is False and by_it[200]["criterion"] == "fell"
    assert by_it[300]["passed"] is False and "error" in by_it[300]
    with open(tmp_path / "eval_gate.jsonl") as f:
        assert {json.loads(line)["iteration"] for line in f} == {100, 200, 300}


def test_gate_queues_a_backlog_and_drains_it(tmp_path, monkeypatch):
    exported = []
    monkeypatch.setattr(export, "export_policy_npz",
                        lambda net, path: exported.append((net, path)))
    runner = types.SimpleNamespace(net="actor")
    gate = eval_gate.CheckpointEvalGate(str(tmp_path), duration=10.0, max_concurrent=0)
    gate(runner, "ckpt", 300)
    assert exported == [("actor", str(tmp_path / "gate_policy_300.npz"))]
    assert gate._queue == [(300, str(tmp_path / "gate_policy_300.npz"))]
    assert gate.results == []
    gate.max_concurrent = 1
    monkeypatch.setattr(gate, "_launch", lambda it, npz: gate._procs.append((it, npz, fake_proc(
        "{'survived_s': 10.0, 'distance_m': 4.2, 'mean_speed': 0.42, 'final_base_z': 0.9}"),
        time.time())))
    gate.drain_async()
    gate.wait_all(timeout=30)
    assert [(r["iteration"], r["passed"]) for r in gate.results] == [(300, True)]


def test_gate_replays_a_checkpoint_in_its_subprocess(tmp_path):
    """A 1 s replay through `python -m humanoid_tpu_torch.deploy.sim2sim`:
    the record holds the metrics of run_mujoco in this process, the export
    reproduces the float32 actor and the dashboard is drawn."""
    net = seeded_net(1)

    class Runner:
        pass

    runner = Runner()
    runner.net = net
    gate = eval_gate.CheckpointEvalGate(str(tmp_path), duration=1.0, task=TASK)
    assert gate.heading_hold is registry.get_cfgs(TASK)[0].commands.heading_command
    gate(runner, "model_7.pt", 7)
    gate.wait_all(timeout=240)
    (rec,) = gate.results
    npz = str(tmp_path / "gate_policy_7.npz")
    want = sim2sim.run_mujoco(NpzPolicy(npz), sim2sim.cfg_for_task(TASK, duration=1.0),
                              command=gate.cmd, heading_hold=gate.heading_hold)
    assert "error" not in rec, rec
    assert {k: rec[k] for k in want} == want
    assert rec["iteration"] == 7 and isinstance(rec["passed"], bool)
    obs = np.random.default_rng(2).normal(size=(16, net.actor.layers[0].in_features))
    with torch.no_grad():
        actor = net.act_mean(torch.as_tensor(obs, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(NpzPolicy(npz)(obs), actor, atol=TOL)
    assert os.path.isfile(tmp_path / "gate_dashboard_7.png")


@pytest.fixture
def small_runs(monkeypatch):
    """4-step rollouts saving every iteration, no tensorboard (its import
    takes ~15 s here)."""
    task_cfgs = registry.get_cfgs

    def small(name):
        e, t = task_cfgs(name)
        return e, t.replace(runner=dataclasses.replace(t.runner, num_steps_per_env=4,
                                                       save_interval=1))

    monkeypatch.setattr(registry, "get_cfgs", small)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


class StubWandb:
    """A stand-in wandb module: records init, log and finish."""

    def __init__(self):
        self.inits, self.logged, self.finished = [], [], 0

    def init(self, **kw):
        self.inits.append(kw)
        return self

    def log(self, scalars, step):
        self.logged.append((step, dict(scalars)))

    def finish(self):
        self.finished += 1


def test_train_eval_gate_and_wandb(tmp_path, small_runs, monkeypatch):
    """train --eval-gate 1 --wandb: one gate record per save, each parsed to
    metrics, each gate_policy_<it>.npz the actor of that checkpoint; the
    wandb stub gets each iteration's scalars."""
    from humanoid_tpu_torch.scripts import train
    from humanoid_tpu_torch.utils.checkpoint import load_checkpoint

    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    runner, _ = train.main(["--task", TASK, "--device", "cpu", "--num-envs", "4",
                            "--max-iterations", "2", "--log-root", str(tmp_path),
                            "--eval-gate", "1", "--wandb"], log_fn=lambda *a: None)
    assert isinstance(runner.on_checkpoint, eval_gate.CheckpointEvalGate)
    with open(os.path.join(runner.log_dir, "eval_gate.jsonl")) as f:
        recs = sorted((json.loads(line) for line in f), key=lambda r: r["iteration"])
    assert [r["iteration"] for r in recs] == [1, 2]
    assert all("error" not in r and r["survived_s"] > 0 for r in recs), recs
    obs = torch.as_tensor(np.random.default_rng(3).normal(size=(16, runner.net.actor.layers[0]
                                                                .in_features)),
                          dtype=torch.float32)
    for it in (1, 2):
        net = seeded_net(0)
        net.load_state_dict(load_checkpoint(os.path.join(runner.log_dir, f"model_{it}"))["model"])
        with torch.no_grad():
            want = net.act_mean(obs).numpy()
        got = NpzPolicy(os.path.join(runner.log_dir, f"gate_policy_{it}.npz"))(obs.numpy())
        np.testing.assert_allclose(got, want, atol=TOL)
    assert stub.inits == [{"project": runner.cfg.runner.experiment_name,
                           "name": os.path.basename(runner.log_dir), "dir": runner.log_dir,
                           "mode": os.environ.get("WANDB_MODE", "offline")}]
    assert [s for s, _ in stub.logged] == [1, 2] and stub.finished == 1
    with open(os.path.join(runner.log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [{"it": s, **sc} for s, sc in stub.logged] == rows


def test_wandb_absent_goes_on(tmp_path, monkeypatch, capsys):
    from humanoid_tpu_torch.utils.logging import TrainLogger

    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    env_cfg, train_cfg = registry.get_cfgs(TASK)
    logger = TrainLogger(str(tmp_path), ["a"], env_cfg, train_cfg, use_wandb=True)
    assert logger.wandb is None and "wandb does not import" in capsys.readouterr().out
    logger.close()


def test_sweep_eval_gate_runs_the_gate(tmp_path, small_runs):
    from humanoid_tpu_torch.scripts import sweep

    (rec,) = sweep.main(["--spec", json.dumps({"seed": [3]}), "--num-envs", "4",
                         "--max-iterations", "1", "--log-root", str(tmp_path), "--device",
                         "cpu", "--eval-gate", "1"])
    with open(os.path.join(rec["run_dir"], "eval_gate.jsonl")) as f:
        (gate_rec,) = [json.loads(line) for line in f]
    assert gate_rec["iteration"] == 1 and "error" not in gate_rec and gate_rec["survived_s"] > 0
    assert rec["gate_passed"] is gate_rec["passed"]


# ---------------------------------------------------------------------------
# the shipped MJCFs, the terrain oracle, play --video, the joystick

def test_replays_on_the_shipped_mjcf_name_the_missing_file(npz, tmp_path, monkeypatch):
    monkeypatch.setenv("HUMANOID_TPU_ASSETS", str(tmp_path))
    for argv, name in (([], "XBot-L.xml"), (["--terrain"], "XBot-L-terrain.xml"),
                       (["--task", TASK, "--terrain"], "XBot-L-terrain.xml"),
                       (["--task", TASK, "--hfield-oracle", "stairs"], "XBot-L-terrain.xml")):
        with pytest.raises(FileNotFoundError, match=name):
            sim2sim.main(["--load-model", npz, *argv])


TERRAIN_MJCF = """<mujoco model="oracle_base">
  <option timestep="0.001" sensornoise="enable"/>
  <asset>
    <hfield file="../terrain/uneven.png" name="hf1" size="10 10 0.3 0.1" />
  </asset>
  <worldbody>
    <geom name="ground" type="hfield" hfield="hf1"/>
  </worldbody>
</mujoco>
"""


def test_terrain_oracle_substitutes_the_hfield(tmp_path, monkeypatch):
    import mujoco
    from PIL import Image

    import humanoid_tpu.assets as jassets
    from humanoid_tpu.deploy import terrain_oracle as jterrain_oracle
    from humanoid_tpu_torch.config.structs import TerrainCfg
    from humanoid_tpu_torch.env.terrain import selected_make_terrain

    robot = tmp_path / "robots" / "XBot"
    (robot / "mjcf").mkdir(parents=True)
    (robot / "terrain").mkdir()
    (robot / "mjcf" / "XBot-L-terrain.xml").write_text(TERRAIN_MJCF)
    Image.fromarray(np.zeros((8, 8), dtype=np.uint8)).save(robot / "terrain" / "uneven.png")
    monkeypatch.setenv("HUMANOID_TPU_ASSETS", str(tmp_path))
    assert terrain_oracle.parse_oracle_spec("gap:0.7") == ("gap", 0.7)
    assert terrain_oracle.parse_oracle_spec("stairs") == ("stairs", 0.4)
    path = terrain_oracle.make_hfield_oracle("stairs", 0.4, size_m=4.0)
    monkeypatch.setattr(jassets, "XBOT_MJCF_TERRAIN", str(robot / "mjcf" / "XBot-L-terrain.xml"))
    ref = jterrain_oracle.make_hfield_oracle("stairs", 0.4, size_m=4.0)
    png = os.path.join(os.path.dirname(path), "oracle_stairs_0.4.png")
    ref_png = os.path.join(os.path.dirname(ref), "oracle_stairs_0.4.png")
    assert np.array_equal(np.asarray(Image.open(png)), np.asarray(Image.open(ref_png)))
    with open(path) as a, open(ref) as b:
        assert a.read().replace(png, "PNG") == b.read().replace(ref_png, "PNG")

    model = mujoco.MjModel.from_xml_path(path)
    assert (int(model.hfield_nrow[0]), int(model.hfield_ncol[0])) == (40, 40)
    t = selected_make_terrain(TerrainCfg(horizontal_scale=0.1, vertical_scale=0.005), "stairs",
                              0.4, 40, np.random.RandomState(0))
    h = t.height_field_raw * 0.005
    elev = h.max() - h.min()
    assert model.hfield_size[0].tolist() == pytest.approx([2.0, 2.0, elev, 0.1], abs=1e-4)
    ground = sim2sim._hfield_lookup(model)
    assert ground(0.0, 0.0) == pytest.approx(h[20, 20] - h.min(), abs=elev / 255 + 1e-6)


class StubRenderer:
    """mujoco.Renderer without GL: black frames, the rendered qpos kept."""
    seen = []

    def __init__(self, model, height, width):
        self.shape = (height, width, 3)

    def update_scene(self, data, camera=None):
        StubRenderer.seen.append(data.qpos.copy())

    def render(self):
        return np.zeros(self.shape, dtype=np.uint8)

    def close(self):
        pass


def test_play_video_writes_its_frames(tmp_path, monkeypatch):
    import mujoco

    from humanoid_tpu_torch.scripts import play

    env_cfg, train_cfg = registry.get_cfgs(TASK)
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=1))
    runner = registry.make_alg_runner(registry.build_env(env_cfg, registry.default_urdf(),
                                                         "cpu"),
                                      train_cfg, log_root=str(tmp_path / "logs"))
    runner.save()
    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    monkeypatch.setenv("MUJOCO_GL", "egl")
    StubRenderer.seen = []
    out = play.main(["--device", "cpu", "--steps", "7", "--log-root", str(tmp_path / "logs"),
                     "--out-dir", str(tmp_path / "play"), "--video"])
    assert out["video"] == str(tmp_path / "play" / "play.mp4")
    assert os.path.getsize(out["video"]) > 0
    assert len(StubRenderer.seen) == 3                     # steps 0, 3, 6
    model = mujoco.MjModel.from_xml_path(str(tmp_path / "play" / "play_robot.xml"))
    base_z = model.body_pos[mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, "base_link")][2]
    with np.load(tmp_path / "play" / "eval_states.npz") as z:
        heights = z["base_height"][[0, 3, 6]]
    np.testing.assert_allclose([q[2] + base_z for q in StubRenderer.seen], heights, atol=1e-6)
    assert all(q.shape == (model.nq,) and np.isfinite(q).all() for q in StubRenderer.seen)


def test_joystick_shape_and_no_pad(monkeypatch):
    from humanoid_tpu.scripts import joystick as jjoystick
    from humanoid_tpu_torch.scripts import joystick

    for x in np.linspace(-1.0, 1.0, 41):
        assert joystick._shape(x) == jjoystick._shape(x)
    zero = {"vx": 0.0, "vy": 0.0, "wz": 0.0}
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    pad = joystick.JoystickController()
    pad.update_cmd_vel()
    pad.update_button_press()
    assert pad.joystick is None and pad.get_cmd_vel() == zero
    assert pad.get_button_press() == {b: 0 for b in joystick.BUTTONS}
    monkeypatch.setitem(sys.modules, "pygame", None)
    pad = joystick.JoystickController()
    assert pad._pygame is None and pad.get_cmd_vel() == zero
