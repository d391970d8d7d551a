"""A grid of training configs, split over the ranks of a launcher: the
port's counterpart of the reference package's scripts/sweep.py.

Each point of the grid (command ranges, reward-curriculum ratios, seeds,
...) is an independent training run. Rank r of W trains points r, r + W,
r + 2W, ... on its own device, with no traffic between ranks; alone, the
script trains every point in turn. Each point writes a normal run
directory (checkpoints, metrics.jsonl), its final actor as
`policy_final.npz` (deploy/export.py), and one line in
<log-root>/sweep_results.jsonl: final mean reward, episode length and
env-steps/s.

Sweep spec: a JSON file (or inline JSON) mapping flat config paths to
lists of values, e.g.

    {"rewards.course_ratio": [1.0, 1.001],
     "commands.ranges.lin_vel_x": [[-0.3, 0.6], [-0.5, 1.0]],
     "seed": [1, 2]}

The cross-product is the grid (8 points above). A path that both configs
have (`seed`) is set on both.

Usage:
  python -m humanoid_tpu_torch.scripts.sweep --task humanoid_ppo \\
      --spec sweep.json --max-iterations 500 [--num-envs 8192] [--device cpu]
  torchrun --nproc-per-node G -m humanoid_tpu_torch.scripts.sweep --multihost ...

`--eval-gate [SECONDS]` (default 10) runs the MuJoCo sim2sim gate
(deploy/eval_gate.py) on each checkpoint of each point, on the MJCF
exported from the task's robot; a point's `gate_passed` says whether every
one of its replays passed.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="humanoid_tpu_torch sweep")
    p.add_argument("--task", default="humanoid_ppo")
    p.add_argument("--spec", required=True,
                   help="JSON file path or inline JSON: {cfg.path: [values...]}")
    p.add_argument("--num-envs", dest="num_envs", type=int)
    p.add_argument("--max-iterations", dest="max_iterations", type=int, default=500)
    p.add_argument("--log-root", dest="log_root", default=None)
    p.add_argument("--eval-gate", dest="eval_gate", nargs="?", const=10.0, type=float,
                   default=None, metavar="SECONDS",
                   help="replay each checkpoint in MuJoCo for SECONDS (default 10) of sim "
                        "time (the sim2sim gate)")
    p.add_argument("--multihost", action="store_true",
                   help="take rank and world from the launcher's environment (torchrun); "
                        "the ranks split the grid")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _expand_grid(spec: dict):
    keys = list(spec)
    for combo in itertools.product(*(spec[k] for k in keys)):
        yield dict(zip(keys, combo))


def _set_path(cfg, path: str, value):
    """Immutable nested dataclasses.replace along a dotted path."""
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(cfg, **{head: _coerce(cfg, head, value)})
    sub = getattr(cfg, head)
    return dataclasses.replace(cfg, **{head: _set_path(sub, rest, value)})


def _coerce(cfg, field: str, value):
    cur = getattr(cfg, field)
    if isinstance(cur, tuple) and isinstance(value, list):
        return tuple(value)
    return value


def apply_point(env_cfg, train_cfg, point: dict):
    """Both configs with the point's values set, on every config that has
    the path's root field (`seed` is on both: the env and the runner seed
    from it)."""
    for path, value in point.items():
        root = path.partition(".")[0]
        hit = False
        if hasattr(env_cfg, root):
            env_cfg = _set_path(env_cfg, path, value)
            hit = True
        if hasattr(train_cfg, root):
            train_cfg = _set_path(train_cfg, path, value)
            hit = True
        if not hit:
            raise KeyError(f"sweep path {path!r} not in env or train cfg")
    return env_cfg, train_cfg


def main(argv=None):
    args = parse_args(argv)
    from ..deploy.export import export_policy_npz
    from ..parallel import dist
    from ..utils import registry
    from ..utils.logging import TrainLogger

    if args.multihost:
        if not dist.launched():
            raise RuntimeError("--multihost needs the launcher's environment "
                               f"({', '.join(dist.LAUNCH_VARS)}): start the ranks with torchrun")
        rank, ranks = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        rank, ranks = 0, 1
    device = dist.device_for_rank(args.device)

    spec = (json.load(open(args.spec)) if os.path.exists(args.spec)
            else json.loads(args.spec))
    grid = list(_expand_grid(spec))
    mine = grid[rank::ranks]
    log_root = args.log_root or registry.LOG_ROOT
    os.makedirs(log_root, exist_ok=True)
    results_path = os.path.join(log_root, "sweep_results.jsonl")
    print(f"rank {rank}/{ranks}: {len(mine)}/{len(grid)} sweep points", flush=True)

    records = []
    for idx, point in enumerate(mine):
        env_cfg, train_cfg = apply_point(*registry.get_cfgs(args.task), point)
        if args.num_envs:
            env_cfg = _set_path(env_cfg, "env.num_envs", args.num_envs)
        train_cfg = _set_path(train_cfg, "runner.run_name", f"sweep{rank}_{idx}")
        env, env_cfg, _ = registry.make_env(args.task, device=device, env_cfg=env_cfg)
        runner = registry.make_alg_runner(env, train_cfg, log_root=log_root)
        gate = None
        if args.eval_gate:
            from ..deploy.eval_gate import CheckpointEvalGate

            gate = CheckpointEvalGate(runner.log_dir, duration=args.eval_gate, task=args.task)
            runner.on_checkpoint = gate
        logger = TrainLogger(runner.log_dir, env.reward_names, env_cfg, train_cfg)
        last = {}

        def log_fn(it, metrics, fps):
            nonlocal last
            last = logger.log(it, metrics, fps, metrics.iteration_s)

        t0 = time.time()
        try:
            runner.learn(args.max_iterations, log_fn=log_fn)
        finally:
            if gate is not None:
                gate.wait_all()
            logger.close()
        # the point's final actor, for the judges downstream
        final_npz = export_policy_npz(runner.net, os.path.join(runner.log_dir,
                                                               "policy_final.npz"))
        rec = {
            "host": rank, "point": point, "run_dir": runner.log_dir, "policy": final_npz,
            "iterations": args.max_iterations, "wall_s": round(time.time() - t0, 1),
            "mean_reward": last.get("Train/mean_reward"),
            "mean_episode_length": last.get("Train/mean_episode_length"),
            "fps": last.get("Perf/total_fps"),
            "gate_passed": None if gate is None else all(r["passed"] for r in gate.results),
        }
        with open(results_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        records.append(rec)
        print(f"[sweep] done {point} -> reward {rec['mean_reward']}", flush=True)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
