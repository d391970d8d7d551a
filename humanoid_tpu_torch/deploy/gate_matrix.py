"""Command-matrix and push-recovery sim2sim gate: the reference package's
deploy/gate_matrix.py.

The single-command eval gate (eval_gate.py) proves straight-line walking;
deployment is interactive: joystick-driven omnidirectional commands and
push-force triggers during the MuJoCo replay (50 N on the base through
xfrc_applied while a button is held). This module replays a policy over
that whole envelope as a deterministic matrix of cells:

  forward / backward / lateral (both) / turn (both) / stand /
  stand-and-resume (walk -> stand -> walk) / push-recovery (50 N x 0.2 s
  shoves in +-x and +-y while walking, the training-push impulse scale:
  50 N * 0.2 s / ~45 kg = 0.22 m/s, matching max_push_vel_xy=0.2)

Each cell is judged on DIRECTIONAL tracking: the mean base velocity vector
(from the recorded 100 Hz states) projected on the commanded direction in
the heading frame, so that walking forward under a backward command fails,
unlike a |displacement|/time criterion. Turn cells are judged on the mean
yaw rate, stand cells on a bound of their drift.

  python -m humanoid_tpu_torch.deploy.gate_matrix --load-model policy.npz \
      --task humanoid_ppo [--urdf PATH] [--out matrix.jsonl]

It replays on the MJCF exported from the task's robot (sim2sim.cfg_for_task).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GateCell:
    name: str
    duration: float
    # piecewise-constant command schedule: (start_s, (vx, vy, wyaw))
    schedule: Tuple[Tuple[float, Tuple[float, float, float]], ...]
    heading_hold: bool = True
    # base shoves: (start_s, duration_s, (fx, fy, fz)) via xfrc_applied
    pushes: Tuple[Tuple[float, float, Tuple[float, float, float]], ...] = ()
    # per-segment tracking requirement as a fraction of ||cmd|| (walk
    # segments) — stand segments instead bound drift
    track_ratio: float = 0.7
    stand_drift_m: float = 1.5
    min_final_base_z: float = 0.65
    # ignore this many seconds after each command change (gait transient)
    settle_s: float = 2.0


def default_cells(forward_speed: float = 0.5) -> List[GateCell]:
    """The deployment envelope of the upstream joystick and push replay
    (cosine-shaped vx in [-0.4, 0.8], vy/wz in +-0.3/0.4; training command
    ranges lin_vel_x (-0.3, 0.6), lin_vel_y (-0.3, 0.3), ang_vel_yaw
    (-0.3, 0.3))."""
    f = forward_speed
    return [
        GateCell("forward", 20.0, ((0.0, (f, 0.0, 0.0)),)),
        GateCell("backward", 20.0, ((0.0, (-0.3, 0.0, 0.0)),)),
        GateCell("lateral_left", 20.0, ((0.0, (0.0, 0.3, 0.0)),)),
        GateCell("lateral_right", 20.0, ((0.0, (0.0, -0.3, 0.0)),)),
        GateCell("turn_left", 20.0, ((0.0, (0.3, 0.0, 0.3)),),
                 heading_hold=False),
        GateCell("turn_right", 20.0, ((0.0, (0.3, 0.0, -0.3)),),
                 heading_hold=False),
        GateCell("stand", 10.0, ((0.0, (0.0, 0.0, 0.0)),)),
        GateCell(
            "stand_resume", 28.0,
            ((0.0, (f, 0.0, 0.0)), (10.0, (0.0, 0.0, 0.0)),
             (18.0, (f, 0.0, 0.0))),
        ),
        GateCell(
            "push_recovery", 24.0, ((0.0, (f, 0.0, 0.0)),),
            pushes=((6.0, 0.2, (50.0, 0.0, 0.0)),
                    (10.0, 0.2, (-50.0, 0.0, 0.0)),
                    (14.0, 0.2, (0.0, 50.0, 0.0)),
                    (18.0, 0.2, (0.0, -50.0, 0.0))),
            # shoves legitimately cost ground speed while recovering;
            # training pushes (0.2 m/s kicks every 4 s) were absorbed at
            # the same duty cycle
            track_ratio=0.6,
        ),
    ]


def _yaw_of(quat_wxyz: np.ndarray) -> float:
    w, x, y, z = quat_wxyz
    return math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def _segment_bounds(cell: GateCell) -> List[Tuple[float, float, Tuple]]:
    starts = [s for s, _ in cell.schedule]
    ends = starts[1:] + [cell.duration]
    return [
        (s, e, cmd) for (s, cmd), e in zip(cell.schedule, ends)
    ]


def judge_cell(cell: GateCell, metrics: dict, states: np.ndarray,
               dt_policy: float) -> dict:
    """Per-segment directional-tracking verdict from the 100 Hz state
    recording (states rows = [qpos, qvel] as run_mujoco records them)."""
    rec = {"cell": cell.name, **{k: round(float(v), 3)
                                 for k, v in metrics.items()
                                 if isinstance(v, (int, float))}}
    if metrics["survived_s"] < cell.duration - 1e-6:
        rec.update(passed=False, criterion="fell")
        return rec
    if metrics["final_base_z"] < cell.min_final_base_z:
        rec.update(passed=False, criterion="crouched")
        return rec
    segs = []
    for s0, s1, cmd in _segment_bounds(cell):
        i0 = int(round((s0 + cell.settle_s) / dt_policy))
        i1 = min(int(round(s1 / dt_policy)), len(states) - 1)
        if i1 <= i0:
            continue
        xy0, xy1 = states[i0, 0:2], states[i1, 0:2]
        yaw0 = _yaw_of(states[i0, 3:7])
        yaw1 = _yaw_of(states[i1, 3:7])
        seg_t = (i1 - i0) * dt_policy
        vmean = (xy1 - xy0) / seg_t
        # yaw-rate from the unwrapped per-step increments (net yaw of a
        # turn cell exceeds pi)
        yaws = np.array([_yaw_of(q) for q in states[i0:i1 + 1, 3:7]])
        dyaw = np.unwrap(yaws)
        yaw_rate = (dyaw[-1] - dyaw[0]) / seg_t
        cmd_xy = np.asarray(cmd[:2])
        cmd_speed = float(np.linalg.norm(cmd_xy))
        seg = {"t": [round(s0, 1), round(s1, 1)], "cmd": list(cmd),
               "v_mean": [round(float(v), 3) for v in vmean],
               "yaw_rate": round(float(yaw_rate), 3)}
        turning = abs(cmd[2]) > 0.05 and not cell.heading_hold
        if turning:
            # a commanded turn walks a circular arc: the world-frame mean
            # velocity is small by construction, so judge the yaw rate
            # (plus survive/upright) instead of straight-line tracking
            seg["ok"] = bool(
                yaw_rate * cmd[2] >= cell.track_ratio * cmd[2] * cmd[2]
            )
        elif cmd_speed > 0.05:
            # commanded direction in the heading frame; under heading-hold
            # the heading stays ~= the segment's initial yaw
            c, s = math.cos(yaw0), math.sin(yaw0)
            dir_world = np.array([c * cmd_xy[0] - s * cmd_xy[1],
                                  s * cmd_xy[0] + c * cmd_xy[1]]) / cmd_speed
            v_along = float(vmean @ dir_world)
            seg["v_along"] = round(v_along, 3)
            seg["ok"] = bool(v_along >= cell.track_ratio * cmd_speed)
        else:
            drift = float(np.linalg.norm(xy1 - xy0))
            seg["drift_m"] = round(drift, 3)
            seg["ok"] = bool(drift <= cell.stand_drift_m)
        segs.append(seg)
    rec["segments"] = segs
    bad = [s for s in segs if not s["ok"]]
    rec["passed"] = not bad
    rec["criterion"] = (
        "survive+track+upright (all segments)" if not bad
        else f"segment failed: {bad[0]['t']} cmd={bad[0]['cmd']}"
    )
    return rec


def run_matrix(policy: Callable[[np.ndarray], np.ndarray], cfg,
               cells: Optional[Sequence[GateCell]] = None,
               out_path: Optional[str] = None,
               sw_switch: bool = False,
               iteration: Optional[int] = None) -> List[dict]:
    """Replay every cell; returns the verdict records (and appends each to
    out_path as JSONL when given)."""
    from .sim2sim import run_mujoco

    cells = list(cells) if cells is not None else default_cells()
    results = []
    for cell in cells:
        # copy, not dataclasses.replace: tau_limit is set post-construction
        # (cfg_for_task) and is not a dataclass field
        cfg_c = copy.copy(cfg)
        cfg_c.sim_duration = cell.duration
        dt_policy = cfg.dt * cfg.decimation

        calls = [0]
        sched = _segment_bounds(cell)

        def command_source():
            t = calls[0] * dt_policy
            calls[0] += 1
            for s0, s1, cmd in sched:
                if s0 <= t < s1:
                    return cmd
            return sched[-1][2]

        def push_schedule(t):
            for p0, pd, f in cell.pushes:
                if p0 <= t < p0 + pd:
                    return np.asarray(f)
            return np.zeros(3)

        metrics = run_mujoco(
            policy, cfg_c, command=sched[0][2],
            command_source=command_source,
            push_schedule=push_schedule if cell.pushes else None,
            heading_hold=cell.heading_hold,
            sw_switch=sw_switch,
            record_states=True,
        )
        states = metrics.pop("states")
        rec = judge_cell(cell, metrics, states, dt_policy)
        if iteration is not None:
            # checkpoint-stability matrices: tag every row so one JSONL
            # can hold several checkpoints' verdicts
            rec["iteration"] = iteration
        results.append(rec)
        tag = "PASS" if rec["passed"] else "FAIL"
        print(f"[gate-matrix] {cell.name}: {tag} ({rec['criterion']})",
              flush=True)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
    n = sum(1 for r in results if r["passed"])
    print(f"[gate-matrix] {n}/{len(results)} cells passed", flush=True)
    return results


def main(argv=None):
    import argparse

    from .npz_policy import NpzPolicy
    from .sim2sim import Sim2simCfg, cfg_for_task

    p = argparse.ArgumentParser(description="command-matrix sim2sim gate")
    p.add_argument("--load-model", "--load_model", dest="load_model",
                   required=True)
    p.add_argument("--task", default="humanoid_ppo")
    p.add_argument("--urdf", default=None,
                   help="the robot URDF the policy was trained on (train's --urdf)")
    p.add_argument("--out", default="", help="JSONL output path")
    p.add_argument("--cells", nargs="*", default=None,
                   help="subset of cell names to run")
    p.add_argument("--forward-speed", type=float, default=0.5)
    p.add_argument("--iteration", type=int, default=None,
                   help="tag each verdict row with this checkpoint "
                        "iteration (multi-checkpoint stability matrices)")
    p.add_argument("--fast-cell", action="store_true",
                   help="append the 0.8 m/s forward cell (the joystick "
                        "envelope's vx maximum)")
    args = p.parse_args(argv)

    # without a task: the shipped XBot-L MJCF (FileNotFoundError where it is missing)
    cfg = cfg_for_task(args.task, urdf=args.urdf) if args.task else Sim2simCfg()
    cells = default_cells(args.forward_speed)
    if args.fast_cell:
        cells.append(
            GateCell("forward_fast", 20.0, ((0.0, (0.8, 0.0, 0.0)),))
        )
    if args.cells:
        cells = [c for c in cells if c.name in set(args.cells)]
    policy = NpzPolicy(args.load_model)
    results = run_matrix(policy, cfg, cells, out_path=args.out or None,
                         iteration=args.iteration)
    return 0 if all(r["passed"] for r in results) else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
