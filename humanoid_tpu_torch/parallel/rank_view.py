"""Train one rank of a data-parallel run and write down what it holds, so
that the ranks can be held against each other and against one process.

    python -m humanoid_tpu_torch.parallel.rank_view OUT_DIR [train arguments]

Run under a launcher's variables (parallel/dist.py::launch, torchrun), once
per rank. It runs `scripts.train.main([train arguments..., "--mesh"])` and
writes OUT_DIR/rank<r>.pt: the parameters, Adam's moments, count and
learning rate, and the iteration (on the CPU); each iteration's global
metrics and this rank's kernel launches; the run directory and the
checkpoint files this rank wrote; the final observations of its envs and
the command curriculum's range; the backend and world; the count of its
all-reduces and the seconds spent in them (each timed between two
synchronizations of its device); and the modules of JAX or of the
reference package that the process loaded (none).
"""
from __future__ import annotations

import os
import sys
import time

import torch


def _row(m, fps) -> dict:
    return {"mean_step_reward": m.mean_step_reward, "value_loss": m.update.value_loss,
            "surrogate_loss": m.update.surrogate_loss, "vel_loss": m.update.vel_loss,
            "kl": m.update.kl, "lr": m.update.lr, "ep_count": m.ep_count,
            "ep_len_sum": m.ep_len_sum, "ep_rew_sums": m.ep_rew_sums,
            "rew_terms_mean": m.rew_terms_mean, "terrain_level_mean": m.terrain_level_mean,
            "kernel_launches": m.kernel_launches, "sampler_launches": m.sampler_launches,
            "env_steps_per_s": fps, "rollout_s": m.rollout_s, "update_s": m.update_s}


def main(argv=None) -> str:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_dir, train_argv = argv[0], argv[1:]
    from ..scripts import train
    from ..utils import checkpoint

    written, rows, group = [], [], {}
    save = checkpoint.save_checkpoint

    def recording_save(path, payload):
        written.append(save(path, payload))
        return written[-1]

    def log_fn(it, m, fps):
        if not group:
            group.update(backend=torch.distributed.get_backend(),
                         world=torch.distributed.get_world_size())
        rows.append({k: v.detach().cpu() if torch.is_tensor(v) else v
                     for k, v in _row(m, fps).items()})

    all_reduce = torch.distributed.all_reduce
    spent = {"collectives": 0, "collective_s": 0.0}

    def timed_all_reduce(tensor, *args, **kwargs):
        sync = torch.cuda.synchronize if tensor.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        work = all_reduce(tensor, *args, **kwargs)
        sync()
        spent["collectives"] += 1
        spent["collective_s"] += time.perf_counter() - t0
        return work

    checkpoint.save_checkpoint = recording_save
    torch.distributed.all_reduce = timed_all_reduce
    try:
        runner, carry = train.main([*train_argv, "--mesh"], log_fn=log_fn)
    finally:
        checkpoint.save_checkpoint = save
        torch.distributed.all_reduce = all_reduce
    cpu = lambda x: x.detach().cpu()  # noqa: E731
    opt = runner.opt
    shard = runner.shard
    view = {
        "rank": shard.rank, "world": shard.world, "offset": shard.offset,
        "n_local": shard.n_local, "n_global": shard.n_global, **group,
        "device": str(runner.device),
        "params": {n: cpu(p) for n, p in runner.net.named_parameters()},
        "adam_mu": [cpu(x) for x in opt.mu], "adam_nu": [cpu(x) for x in opt.nu],
        "adam_count": int(opt.count), "lr": cpu(opt.lr), "iteration": runner.iteration,
        "rows": rows, "log_dir": runner.log_dir, "written": written,
        "obs": cpu(carry.obs), "critic_obs": cpu(carry.critic_obs),
        "cmd_x_range": (cpu(carry.env_state.cmd_x_range)
                        if carry.env_state.cmd_x_range is not None else None),
        "launches": runner.env.physics.launches, **spent,
        "param_floats": sum(p.numel() for p in runner.net.parameters()),
        "loaded": sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "humanoid_tpu")
                         and sys.modules[m] is not None),
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rank{shard.rank}.pt")
    torch.save(view, path)
    return path


if __name__ == "__main__":
    main()
