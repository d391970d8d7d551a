"""Per-checkpoint sim2sim eval gate: the reference package's
deploy/eval_gate.py.

`CheckpointEvalGate` is the runner's checkpoint hook (`runner.on_checkpoint`,
called by `save` on rank 0): it exports the actor's float32 weights to
`<log_dir>/gate_policy_<it>.npz` (deploy/export.py) and replays it in MuJoCo
in a CPU subprocess (`python -m humanoid_tpu_torch.deploy.sim2sim`, with
CUDA_VISIBLE_DEVICES="" and MUJOCO_GL=disable unless set), so that training
never waits on it. One record per checkpoint lands in
`<log_dir>/eval_gate.jsonl` and on the console as each replay ends.

Pass criterion (a standing robot under a walk command must FAIL):
  * survives the whole gate duration (default 60 s);
  * under a velocity command above STAND_THRESHOLD, tracks it: mean ground
    speed >= TRACK_RATIO * ||cmd_xy|| (0.7x);
  * ends upright: final base height >= MIN_FINAL_BASE_Z (0.65 m against
    the 0.94 m target; rejects crouched shuffling that survives).
Replays are deterministic (a fixed command, no pushes, no RNG in the
sim2sim loop), so a verdict is reproducible from the exported .npz.
A replay that fails to run (no MuJoCo, a crash) is recorded as failed with
the end of its error output under `error`.
"""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import threading
import time
from typing import List, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POLL_S = 2.0            # seconds between two polls of the running replays
TRACK_RATIO = 0.7       # mean speed needed, as a share of the commanded speed
MIN_FINAL_BASE_Z = 0.65
STAND_THRESHOLD = 0.05  # a commanded speed at or below this asks the robot to stand


class CheckpointEvalGate:
    """Callable checkpoint hook: export -> async MuJoCo replay -> verdict."""

    def __init__(self, log_dir: str, duration: float = 60.0,
                 cmd: Tuple[float, float, float] = (0.5, 0.0, 0.0),
                 max_concurrent: int = 4, task: str = "",
                 extra_argv: Tuple[str, ...] = ()):
        self.log_dir = log_dir
        self.duration = duration
        self.cmd = cmd
        self.task = task
        self.max_concurrent = max_concurrent
        # extra sim2sim flags, e.g. ("--urdf", path) for the robot a run
        # trained, or ("--oracle-perturb", "0.1")
        self.extra_argv = tuple(extra_argv)
        # heading-mode policies (commands.heading_command) are trained with
        # wyaw recomputed from the heading error every step; replaying them
        # with a constant wyaw = 0 leaves the yaw drift uncorrected and the
        # robot walks in circles: mirror the training command distribution
        # through sim2sim --heading-hold
        self.heading_hold = False
        if task:
            from ..utils.registry import get_cfgs

            self.heading_hold = bool(get_cfgs(task)[0].commands.heading_command)
        self.jsonl_path = os.path.join(log_dir, "eval_gate.jsonl")
        self._procs: List[Tuple[int, str, subprocess.Popen, float]] = []
        # exported but not yet replayed checkpoints: training outruns the
        # CPU replays, so instead of skipping on backlog the gate queues
        # the cheap exports and drains them as slots free, and every
        # checkpoint gets a verdict
        self._queue: List[Tuple[int, str]] = []
        self.results: List[dict] = []
        self._drain_thread = None
        self._drain_stop = False

    # -- checkpoint hook (called by OnPolicyRunner.save) ------------------

    def __call__(self, runner, ckpt_path: str, iteration: int) -> None:
        npz = os.path.join(self.log_dir, f"gate_policy_{iteration}.npz")
        from .export import export_policy_npz

        export_policy_npz(runner.net, npz)
        self._queue.append((iteration, npz))
        self.poll()

    def _launch(self, iteration: int, npz: str) -> None:
        env = dict(os.environ)
        env["CUDA_VISIBLE_DEVICES"] = ""        # a CPU-only subprocess
        env.setdefault("MUJOCO_GL", "disable")
        argv = [sys.executable, "-m", "humanoid_tpu_torch.deploy.sim2sim",
                "--load-model", npz, "--duration", str(self.duration),
                "--cmd", *map(str, self.cmd),
                "--plot", os.path.join(self.log_dir, f"gate_dashboard_{iteration}.png")]
        if self.task:
            argv += ["--task", self.task]
        if self.heading_hold:
            argv += ["--heading-hold"]
        argv += list(self.extra_argv)
        proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, cwd=REPO_ROOT)
        self._procs.append((iteration, npz, proc, time.time()))

    # -- verdict -----------------------------------------------------------

    def verdict(self, metrics: dict) -> dict:
        """Survive + track the command + stay upright. Returns {'passed':
        bool, 'criterion': str}, the criterion naming the clause that
        decided the verdict."""
        survived = metrics.get("survived_s", 0.0) >= self.duration - 1e-6
        cmd_speed = (self.cmd[0] ** 2 + self.cmd[1] ** 2) ** 0.5
        if cmd_speed <= STAND_THRESHOLD:
            return {"passed": bool(survived),
                    "criterion": "survive" if survived else "fell"}
        if not survived:
            return {"passed": False, "criterion": "fell"}
        speed = metrics.get(
            "mean_speed",
            metrics.get("distance_m", 0.0) / max(self.duration, 1e-6),
        )
        need = TRACK_RATIO * cmd_speed
        if speed < need:
            return {"passed": False,
                    "criterion": f"undertracked {speed:.2f}<{need:.2f} m/s"}
        if metrics.get("final_base_z", 0.0) < MIN_FINAL_BASE_Z:
            return {"passed": False, "criterion": "crouched"}
        return {"passed": True, "criterion": "survive+track+upright"}

    # -- bookkeeping -------------------------------------------------------

    def poll(self) -> None:
        """Reap finished replays, record their verdicts, and launch queued
        replays as slots free."""
        live = []
        for it, npz, proc, t0 in self._procs:
            if proc.poll() is None:
                live.append((it, npz, proc, t0))
                continue
            out, err = proc.communicate()
            rec = {"iteration": it, "wall_s": round(time.time() - t0, 1)}
            try:
                metrics = ast.literal_eval(out.strip().splitlines()[-1])
                rec.update(metrics)
                rec.update(self.verdict(metrics))
            except (IndexError, ValueError, SyntaxError, TypeError, AttributeError):
                # no metrics dict on the last line: the replay failed
                rec["passed"] = False
                rec["error"] = (err or out).strip()[-500:]
            self._log(rec)
        self._procs = live
        while self._queue and len(self._procs) < self.max_concurrent:
            it, npz = self._queue.pop(0)
            self._launch(it, npz)

    def drain_async(self) -> None:
        """Start a daemon thread that keeps polling (reaping and launching
        queued replays) in the background, so that a caller can move on to
        its next training run while this run's backlog drains on the CPU.
        wait_all() joins it."""
        if self._drain_thread is not None:
            return
        self._drain_stop = False

        def loop():
            while not self._drain_stop and (self._procs or self._queue):
                self.poll()
                time.sleep(POLL_S)

        self._drain_thread = threading.Thread(target=loop, daemon=True)
        self._drain_thread.start()

    def wait_all(self, timeout: float = 7200.0) -> None:
        """Drain the queue and every live replay (called after training);
        a replay still running at the timeout is killed and recorded as
        failed."""
        if self._drain_thread is not None:
            self._drain_thread.join(timeout)
            self._drain_stop = True
            self._drain_thread = None
        deadline = time.time() + timeout
        while (self._procs or self._queue) and time.time() < deadline:
            self.poll()
            if self._procs:
                time.sleep(POLL_S)
        for it, npz, proc, _ in self._procs:
            proc.kill()
            proc.communicate()
            self._log({"iteration": it, "passed": False, "error": "gate timeout"})
        for it, npz in self._queue:
            self._log({"iteration": it, "passed": False, "error": "gate timeout (queued)"})
        self._procs = []
        self._queue = []

    def _log(self, rec: dict) -> None:
        self.results.append(rec)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        tag = "PASS" if rec.get("passed") else "FAIL"
        print(f"[eval-gate] iter {rec.get('iteration')}: {tag} "
              f"{ {k: v for k, v in rec.items() if k != 'iteration'} }", flush=True)
