"""Training entry point of the port.

  python -m humanoid_tpu_torch.scripts.train --task humanoid_ppo \
      --max-iterations 3 [--num-envs 4096] [--device cuda] [--urdf PATH]

Runs on the card unless `--device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import json

import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description="humanoid_tpu_torch trainer")
    p.add_argument("--task", default="humanoid_ppo")
    p.add_argument("--num-envs", "--num_envs", dest="num_envs", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--max-iterations", "--max_iterations", dest="max_iterations", type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--urdf", default=None,
                   help="robot URDF (default: the XBot-topology stand-in)")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def main(argv=None, log_fn=None):
    """Train; returns (runner, last iteration carry). log_fn(it, metrics,
    env_steps_per_s) replaces the default one-JSON-line-per-iteration log."""
    from ..utils import registry

    args = get_args(argv)
    device = resolve_device(args.device)
    env, env_cfg, train_cfg = registry.make_env(args.task, args, device=device, urdf=args.urdf)
    runner = registry.make_alg_runner(env, train_cfg)
    total = train_cfg.runner.max_iterations

    def console(it, m, fps):
        print(json.dumps({
            "it": it, "of": total, "env_steps_per_s": fps,
            "rollout_s": m.rollout_s, "update_s": m.update_s,
            "mean_reward": float(m.mean_step_reward),
            "value_loss": float(m.update.value_loss),
            "surrogate_loss": float(m.update.surrogate_loss), "lr": float(m.update.lr),
        }), flush=True)

    print(f"task={args.task} envs={env_cfg.env.num_envs} iters={total} device={device}",
          flush=True)
    carry = runner.learn(total, log_fn=log_fn or console)
    return runner, carry


if __name__ == "__main__":
    main()
