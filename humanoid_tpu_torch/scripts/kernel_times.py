#!/usr/bin/env python3
"""Kernel times of one checkout of humanoid_tpu_torch on one NVIDIA card,
each read three ways.

    python3 humanoid_tpu_torch/scripts/kernel_times.py
    PYTHONPATH=/path/to/other/checkout python3 humanoid_tpu_torch/scripts/kernel_times.py

Times the control step's shipping, warm, exact and penalty instances, the
batched Cholesky factor, apply and solve (B3-B5), and the library calls
that compute what B3-B5 compute, at chip_smoke.py's size and on its inputs
(4096 robots settled on the flat plane, and their mass matrices):
`graph_ms` is the device time per call of a CUDA graph of the calls,
`eager_ms` the calls back to back, whose reading holds the wrapper's host
cost, and `profiler_ms` the device time of the kernels a call launches, as
torch.profiler reads it. `torch.cholesky_solve` cannot be captured in a
graph (MAGMA allocates inside the call), so its `graph_ms` is null and
`profiler_ms` is its device time. It calls only what the wrappers offered
before the kernels' redesigns, so it also times an older checkout of the
package: put that checkout first on PYTHONPATH (the timing helpers stay
this checkout's chip_smoke.py), and run the two in turns to compare them on
one card. Prints one JSON line per kernel, then the card's name and power
limit.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profiler_ms(fn, reps):
    """Device time per call of fn: the durations of the kernels and copies
    that `reps` calls put on the card, summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us else None


def main():
    sys.path.append(ROOT)            # after PYTHONPATH: another checkout there wins
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    import humanoid_tpu_torch
    from humanoid_tpu_torch.ops import linalg
    from humanoid_tpu_torch.ops.physics_kernel import ControlStepKernel
    from humanoid_tpu_torch.utils import registry

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times.py needs a CUDA device")
    package = os.path.dirname(os.path.abspath(humanoid_tpu_torch.__file__))
    env_cfg, _ = registry.get_cfgs("humanoid_ppo")
    env, _, _ = registry.make_env("humanoid_ppo", device=cs.DEVICE)
    model, kernel = env.model, env.physics
    probe = ControlStepKernel(model, *kernel.gains, kernel.contact_params, kernel.pgs_params,
                              kernel.dt)
    pprobe = ControlStepKernel(model, *probe.gains, probe.contact_params, None, probe.dt)
    wprobe = ControlStepKernel(model, *probe.gains, probe.contact_params,
                               probe.pgs_params._replace(warm_start=True), probe.dt)
    del env, kernel
    settled = cs.settle(probe, model, np.asarray(env_cfg.init_state.default_joint_angles))
    M, b = cs.mass_matrices(model, settled)
    L = linalg.chol_factor_unrolled(M)
    chol = linalg.CholeskyKernels()
    calls = {
        "exact": (lambda: probe(*settled, 1, False, False), cs.TIMED_LAUNCHES, True),
        "shipping": (lambda: probe(*settled, 10, True, True), cs.TIMED_LAUNCHES, True),
        "warm": (lambda: wprobe(*settled, 10, True, True), cs.TIMED_LAUNCHES, True),
        "penalty": (lambda: pprobe(*settled, 10, True, True), cs.TIMED_LAUNCHES, True),
        "chol_factor": (lambda: chol.factor_spd_batch(M), cs.TIMED_LINALG, True),
        "chol_apply": (lambda: chol.apply_spd_batch(L, b), cs.TIMED_LINALG, True),
        "chol_solve": (lambda: chol.solve_spd_batch(M, b), cs.TIMED_LINALG, True),
        "library torch.linalg.cholesky_ex": (lambda: torch.linalg.cholesky_ex(M),
                                             cs.TIMED_LINALG, True),
        "library torch.cholesky_solve": (lambda: torch.cholesky_solve(b[..., None], L),
                                         cs.TIMED_LINALG, False),
        "library torch.linalg.cholesky_ex then torch.cholesky_solve": (
            lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky_ex(M).L),
            cs.TIMED_LINALG, False),
    }
    for name, (fn, reps, capturable) in calls.items():
        for _ in range(3):
            fn()
        eager_ms = cs.cuda_ms(fn, reps)
        cs.emit("kernel_time", name=name, package=package, calls_timed=reps, n=model.nv,
                envs=cs.N, graph_ms=cs.graph_ms(fn, reps) if capturable else None,
                eager_ms=eager_ms, profiler_ms=profiler_ms(fn, reps))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
