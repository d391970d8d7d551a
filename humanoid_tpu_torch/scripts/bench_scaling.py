"""Weak scaling of the training iteration over ranks: the port's
counterpart of the reference package's scripts/bench_scaling.py.

For each rank count W of --devices, W ranks train humanoid_ppo at
--envs-per-device x W envs (the env axis split over them,
parallel/mesh.py): --warmup iterations, then the best of --iters timed
iterations (rollout, GAE and PPO update, the card synchronized), as
env-steps/s over every rank's envs. Efficiency is the throughput over W
times the 1-rank throughput. The collectives are those of the sharded
training iteration: the gradient and KL sum per minibatch, the advantage
normalization's two sums and the iteration's metrics.

On `--device cuda` each rank has a card of its own, over NCCL; a W above
the visible cards is refused. On `--device cpu` the W ranks are processes
over gloo, each with cores / W threads, the counterpart of the
reference's virtual CPU devices. Each W runs in fresh processes
(parallel/dist.py::launch); a rank run under the launcher's variables
measures one row and rank 0 prints it as JSON.

Usage:
  python -m humanoid_tpu_torch.scripts.bench_scaling                # 1, 2, 4, 8 cards
  python -m humanoid_tpu_torch.scripts.bench_scaling --device cpu --devices 1 2 \\
      --envs-per-device 64 --steps 4 --out BENCH_SCALING.md
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import torch

TASK = "humanoid_ppo"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="weak scaling of training over ranks")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--envs-per-device", type=int, default=256)
    ap.add_argument("--steps", type=int, default=12, help="env steps per iteration")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=7200.0, help="seconds per rank count")
    ap.add_argument("--out", default=None, help="write the markdown table to this path")
    return ap.parse_args(argv)


def measure(args) -> dict:
    """One row, on this rank of the launcher's group."""
    from ..parallel import dist
    from ..utils import registry

    dist.init_from_env(args.device)
    try:
        device = dist.device_for_rank(args.device)
        world = dist.process_count()
        env_cfg, train_cfg = registry.get_cfgs(TASK)
        envs = args.envs_per_device * world
        env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=envs))
        train_cfg = train_cfg.replace(runner=dataclasses.replace(
            train_cfg.runner, num_steps_per_env=args.steps))
        env, _, _ = registry.make_env(TASK, device=device, env_cfg=env_cfg, sharded=True)
        runner = registry.make_alg_runner(env, train_cfg, log_root=False)
        carry = runner.init_carry()
        for _ in range(args.warmup):
            carry, _ = runner.train_iteration(carry)
        times = []
        for _ in range(args.iters):
            carry, m = runner.train_iteration(carry)
            times.append(m.rollout_s + m.update_s)
        best = min(times)
        return {"devices": world, "envs": envs, "iter_s": best,
                "env_steps_per_sec": args.steps * envs / best,
                "backend": torch.distributed.get_backend(), "device": str(device)}
    finally:
        torch.distributed.destroy_process_group()


def run_one(n: int, args) -> dict:
    """The row of n ranks, each in a process of its own."""
    from ..parallel import dist

    argv = ["-m", "humanoid_tpu_torch.scripts.bench_scaling", "--envs-per-device",
            str(args.envs_per_device), "--steps", str(args.steps), "--warmup", str(args.warmup),
            "--iters", str(args.iters), "--device", args.device]
    env = ({"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // n))}
           if args.device == "cpu" else {})
    logs = dist.launch(n, argv, timeout=args.timeout,
                       log_dir=tempfile.mkdtemp(prefix=f"bench_scaling_{n}_"), env=env)
    with open(os.path.join(logs, "rank0.log")) as f:
        return json.loads([line for line in f if line.startswith("{")][-1])


def table(rows, args) -> str:
    base = rows[0]["env_steps_per_sec"] / rows[0]["devices"]
    where = ("NVIDIA cards over NCCL, one rank per card" if args.device == "cuda"
             else "CPU processes over gloo, cores / W threads each")
    lines = [
        "# Weak scaling: the training iteration over the env axis split over ranks",
        "",
        f"{where} ({TASK}, {args.envs_per_device} envs/rank, T={args.steps}); efficiency "
        "= throughput / (W x 1-rank throughput). The rollout is parallel over envs; the "
        "collectives are the gradient and KL sum per minibatch, the advantage normalization "
        "and the iteration's metrics.",
        "",
        "| ranks | envs | iter time (s) | env-steps/s | efficiency |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        eff = r["env_steps_per_sec"] / (base * r["devices"])
        lines.append(f"| {r['devices']} | {r['envs']} | {r['iter_s']:.3f} "
                     f"| {r['env_steps_per_sec']:,.0f} | {eff:.2f} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    args = parse_args(argv)
    from ..parallel import dist

    if dist.launched():
        row = measure(args)
        if int(os.environ["RANK"]) == 0:
            print(json.dumps(row), flush=True)
        return [row]
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        if max(args.devices) > cards:
            raise ValueError(f"--devices {max(args.devices)} ranks, but {cards} card(s) are "
                             "visible: one rank per card")
    rows = []
    for n in args.devices:
        rows.append(run_one(n, args))
        print(json.dumps(rows[-1]), flush=True)
    text = table(rows, args)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
