#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (humanoid_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the control-step kernel from humanoid_tpu_torch/csrc with nvcc, holds
it against its plain PyTorch version at 4096 envs, trains `humanoid_ppo` for
3 iterations at 4096 envs through scripts.train.main, and times the kernel.
Each phase prints one JSON line before the next begins; a phase that fails
raises and the script exits non-zero. The last three lines are the card's
name and power limit, the kernel table, and {"ok": true, "device": ...}.
Without a CUDA device, or without the package beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

DEVICE = "cuda"
N = 4096
ITERATIONS = 3
STEPS_PER_ITERATION = 60
TIMED_LAUNCHES = 50
PEAK_FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# the reference package's own kernel-vs-XLA bounds (tests/test_physics_kernel.py)
TOL_DU, TOL_POS, TOL_FOOT_FRACTION = 1e-2, 1e-5, 0.01


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def feet_loaded_state(kernel, model, default_pos, gen_seed=0):
    """4096 envs standing on both feet: small random joint offsets held by
    the PD targets, randomized base mass and friction, settled for 0.3 s
    with the plain version. Returns (pack, masses, friction, targets)."""
    import numpy as np
    import torch

    from humanoid_tpu_torch.ops.physics_kernel import pack_state
    from humanoid_tpu_torch.physics.engine import PhysState

    rng = np.random.default_rng(gen_seed)
    dev = torch.device(DEVICE)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev).contiguous()

    qj = default_pos + rng.uniform(-0.05, 0.05, (N, model.nj))
    masses = np.tile(model.mass, (N, 1))
    masses[:, 0] += rng.uniform(-5.0, 5.0, N)
    phys = PhysState(t(np.c_[np.zeros((N, 2)), np.full(N, 0.90)]),
                     t(np.tile([1.0, 0.0, 0.0, 0.0], (N, 1))), t(qj),
                     torch.zeros(N, model.nv, device=dev))
    pack, masses, friction, targets = pack_state(phys), t(masses), t(rng.uniform(0.1, 2.0, N)), t(qj)
    for _ in range(30):
        pack, _ = kernel.plain(pack, masses, friction, targets, 10, True, True)
    torch.cuda.synchronize()
    return pack, masses, friction, targets


def compare(kernel, model, inputs, decimation, freeze, freeze_prep):
    """Kernel vs plain version on the same inputs."""
    import torch

    pack, masses, friction, targets = inputs
    a, da = kernel(pack, masses, friction, targets, decimation, freeze, freeze_prep)
    b, db = kernel.plain(pack, masses, friction, targets, decimation, freeze, freeze_prep)
    torch.cuda.synchronize()
    nj = model.nj
    du = (a[7 + nj:] - b[7 + nj:]).abs().amax(dim=0)                  # per env
    dpos = (a[0:3] - b[0:3]).abs().amax(dim=0)
    weight = model.total_mass * 9.81
    dff = (da.foot_forces - db.foot_forces).abs().amax(dim=(1, 2)) / weight
    over = (du >= TOL_DU) | (dpos >= TOL_POS) | (dff >= TOL_FOOT_FRACTION)
    return {
        "max_du": du.max().item(), "max_base_pos": dpos.max().item(),
        "max_foot_force_over_weight": dff.max().item(),
        "median_du": du.median().item(), "envs_over_bounds": int(over.sum()),
        "max_abs_err": (a - b).abs().max().item(),
        "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
        "fz_per_weight": (db.foot_forces[..., 2].sum(1) / weight).mean().item(),
    }


def check_within(name, r):
    if not (r["finite"] and r["max_du"] < TOL_DU and r["max_base_pos"] < TOL_POS
            and r["max_foot_force_over_weight"] < TOL_FOOT_FRACTION):
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {r}")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from humanoid_tpu_torch.ops.physics_kernel import (ControlStepKernel, launch_bytes,
                                                      operations_per_env)
    from humanoid_tpu_torch.scripts import train
    from humanoid_tpu_torch.utils import registry

    # ---- 0. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 1. build ----
    env_cfg, train_cfg = registry.get_cfgs("humanoid_ppo")
    env, _, _ = registry.make_env("humanoid_ppo", device=DEVICE)
    model, kernel = env.model, env.physics
    # a second wrapper of the same kernel for the comparisons and timings,
    # so that the training run's launch count is the main path's alone
    probe = ControlStepKernel(model, *kernel.gains, kernel.contact_params, kernel.pgs_params,
                              kernel.dt)
    t0 = time.perf_counter()
    probe.build()
    info = probe.build_info
    emit("build", source="humanoid_tpu_torch/csrc/control_step.cu", nvcc_s=info.seconds,
         load_s=time.perf_counter() - t0, ptxas=list(info.ptxas))

    # ---- 2./3. kernel instances vs plain, 4096 envs on loaded feet ----
    default_pos = np.asarray(env_cfg.init_state.default_joint_angles)
    settled = feet_loaded_state(probe, model, default_pos)
    pressed = (settled[0].clone(),) + settled[1:]
    pressed[0][2] -= 1e-3            # every sole corner 1 mm in: one active contact set
    sweeps = env_cfg.sim.pgs_iterations
    results = {}
    for name, args in (("exact", (1, False, False)), ("shipping", (10, True, True))):
        on_pressed = compare(probe, model, pressed, *args)
        on_settled = compare(probe, model, settled, *args)
        emit(f"{name}_vs_plain", decimation=args[0], freeze=args[1], freeze_prep=args[2],
             sweeps=sweeps, envs=N, tolerance={"du": TOL_DU, "base_pos": TOL_POS,
                                               "foot_force_over_weight": TOL_FOOT_FRACTION},
             pressed_1mm=on_pressed, settled=on_settled)
        check_within(f"{name} (feet pressed 1 mm)", on_pressed)
        if not on_settled["finite"] or on_settled["median_du"] >= 1e-3:
            raise AssertionError(f"{name} (settled): median per-env |du| too large: {on_settled}")
        results[name] = on_pressed

    # ---- 4. train humanoid_ppo, 3 iterations at 4096 envs ----
    del env, kernel
    torch.cuda.reset_peak_memory_stats()
    iters = []

    def log_fn(it, m, fps):
        row = {"it": it, "env_steps_per_s": fps, "rollout_s": m.rollout_s,
               "update_s": m.update_s, "mean_reward": float(m.mean_step_reward),
               "value_loss": float(m.update.value_loss),
               "surrogate_loss": float(m.update.surrogate_loss),
               "kl": float(m.update.kl), "kernel_launches": m.kernel_launches}
        emit("train_iteration", **row)
        iters.append(row)

    runner, carry = train.main(["--task", "humanoid_ppo", "--num-envs", str(N),
                                "--max-iterations", str(ITERATIONS), "--device", DEVICE],
                               log_fn=log_fn)
    launches = runner.env.physics.launches
    peak_train = torch.cuda.max_memory_allocated()
    losses_finite = all(np.isfinite([r["value_loss"], r["surrogate_loss"], r["kl"]]).all()
                        for r in iters)
    params_finite = all(bool(torch.isfinite(p).all()) for p in runner.net.parameters())
    shapes = [tuple(carry.obs.shape), tuple(carry.critic_obs.shape)]
    emit("train", iterations=len(iters), kernel_launches=launches,
         peak_bytes=peak_train, losses_finite=losses_finite, params_finite=params_finite,
         obs_shapes=shapes, obs_finite=bool(torch.isfinite(carry.obs).all()))
    if len(iters) != ITERATIONS or any(r["kernel_launches"] != STEPS_PER_ITERATION for r in iters):
        raise AssertionError(f"expected {STEPS_PER_ITERATION} kernel launches per iteration: {iters}")
    if not (losses_finite and params_finite and bool(torch.isfinite(carry.obs).all())):
        raise AssertionError("training produced non-finite numbers")
    if shapes != [(N, env_cfg.env.num_observations), (N, env_cfg.env.num_privileged_obs)]:
        raise AssertionError(f"unexpected observation shapes {shapes}")

    # ---- 5. kernel time against its bound ----
    pack, masses, friction, targets = settled
    timing = {}
    for name, args in (("exact", (1, False, False)), ("shipping", (10, True, True))):
        def run_kernel():
            probe(pack, masses, friction, targets, *args)

        def run_plain():
            probe.plain(pack, masses, friction, targets, *args)

        for _ in range(3):
            run_kernel()
        ms = cuda_ms(run_kernel, TIMED_LAUNCHES)
        run_plain()
        plain_ms = cuda_ms(run_plain, 3)
        ops = operations_per_env(model, args[0], args[1], args[2], sweeps) * N
        nbytes = launch_bytes(model, N)
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        timing[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                        "operations": ops, "bytes": nbytes}
        emit(f"{name}_time", launches_timed=TIMED_LAUNCHES, **timing[name])
    emit("memory", train_peak_bytes=peak_train, max_memory_allocated=torch.cuda.max_memory_allocated())

    # ---- 6. the table and the last line ----
    print(smi, flush=True)
    ship, exact = timing["shipping"], timing["exact"]
    print(json.dumps({"kernels": [{
        "name": "control_step_kernel",
        "route": "cuda",
        "source": "humanoid_tpu_torch/csrc/control_step.cu",
        "replaces": "humanoid_tpu/ops/physics_kernel.py:841",
        "launches": launches,
        "max_abs_err": results["shipping"]["max_abs_err"],
        "ms": ship["ms"], "plain_ms": ship["plain_ms"], "bound_ms": ship["bound_ms"],
        "bound_by": ship["bound_by"], "library_ms": None,
        "instance": f"decimation=10 freeze=1 freeze_prep=1 sweeps={sweeps}",
        "exact_instance": {
            "replaces": "humanoid_tpu/ops/physics_kernel.py:808",
            "instance": f"decimation=1 freeze=0 freeze_prep=0 sweeps={sweeps}",
            "max_abs_err": results["exact"]["max_abs_err"], "ms": exact["ms"],
            "plain_ms": exact["plain_ms"], "bound_ms": exact["bound_ms"],
            "bound_by": exact["bound_by"], "library_ms": None,
        },
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
