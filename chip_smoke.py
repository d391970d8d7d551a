#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (humanoid_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases control,warm,determinism,time

Builds the control-step kernel, the heightfield sampler and the batched
Cholesky kernels from humanoid_tpu_torch/csrc with nvcc (one nvcc per
source, started together), holds each kernel against its plain PyTorch
version at 4096 envs (first the Cholesky factor, apply and solve on the
settled robots' mass matrices and on random SPD matrices, each also run
again, with NaN above the diagonal and with non-SPD envs, for the same
bits and NaN where the input has no factor; then the control
step on PGS contact without and with its gains, body and planes inputs, on
penalty contact, whose plain version runs the plain Cholesky, and on
warm-started PGS; the sampler on the full humanoid_ppo_terrain world;
controls show that the bounds fail when the plain version drops an input
or starts cold), then drives every physics path: at 4096 envs
`humanoid_ppo`, `humanoid_ppo_terrain` and `humanoid_ppo_penalty` for 3
iterations each on the fused kernel, through scripts.train.main, then
`humanoid_ppo` on the warm6 solver (frozen prep, 6 warm-started sweeps),
`humanoid_ppo_robust` and `humanoid_ppo_envelope` for 3 iterations each,
`humanoid_ppo_trimesh` for 1, and `humanoid_ppo_8k` for 1 at 8192 envs;
and the engine path (`sim.use_pallas_substep=False`) for 1 iteration each
of `humanoid_ppo`, `humanoid_ppo_terrain` and `humanoid_ppo_penalty` with
an unfrozen factor, through registry.make_env(env_cfg=...) and
make_alg_runner. Each path's kernel launches per iteration are checked.
The checkpoint phase trains `humanoid_ppo` for 2 iterations with
--full-state, loads model_2 into a new runner (the same bits), resumes
the exact state for 1 iteration through `scripts.train.main --resume` (the
restored carry and generator the saved ones, in bits; its parameters'
largest difference from an unbroken 3-iteration run is printed, not
gated), runs `scripts.play.main` on that run at 1 and at 4096 envs for
300 steps (B1 once per step, finite states; policy.npz, the TorchScript
pair and policy.onnx within 1e-5 of the float32 actor; the bf16 actor's
gap printed), holds B1 against its plain version at 1 and 37 envs, and
times save, save_state, load and load_state. Every run writes its
checkpoints and logs into a temporary directory, removed at the end.
The 18-dof phases drive the d11_ppo robot (nj 18, nb 19, nv 24):
`d11_control` holds B1 against its plain version at 4096 envs on settled
18-dof robots pressed 1 mm in (shipping, exact, warm, with gains and body,
penalty; the settled median bound; the same bits on repeat) and B3-B5 at
n = 24 on their mass matrices; `d11_train` trains d11_ppo and d12_ppo for
3 iterations, d11_ppo on penalty contact (`--contact penalty`) for 1 and on
the engine path for 1, with their launches per iteration checked;
`d11_play` trains d11_ppo 1 iteration and plays it at 1 and 4096 envs
(B1 once per step, the exports within 1e-5). `profile` runs
`train --profile 1` on humanoid_ppo and prints the trace's five device
ops by total time and the share of the traced rollout's wall time in which
the device was busy.
A determinism phase runs the control step's PGS and penalty instances
several times on the same inputs and requires identical outputs (a missing
sync between the lanes of a team shows as run-to-run differences). Then it
times the kernels: `ms` is the device time per launch of a CUDA graph of
the wrapper's calls, `eager_ms` the wrapper called back to back (its host
cost per call, ~20 µs, sets the latter for a kernel of a few
microseconds). The build and time lines carry each kernel's design and
ptxas report (registers, stack frame, spills, shared memory). Each phase
prints one JSON line before the next begins; a phase that fails raises and
the script exits non-zero. The last three lines are the card's name and
power limit, the kernel table, and {"ok": true, "device": ...}.

`--phases` runs a subset of the phases (names in PHASES; the device and
build steps always run), for a short call while a kernel is worked on:
then the kernel table is left out, and `time` times only the kernels whose
phases ran. Without a CUDA device, or without the package beside it, it
exits non-zero before printing any result.
"""
from __future__ import annotations

import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

DEVICE = "cuda"
N = 4096
ITERATIONS = 3
STEPS_PER_ITERATION = 60
TIMED_LAUNCHES = 50
TIMED_SAMPLES = 200
PEAK_FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# the reference package's own kernel-vs-XLA bounds (tests/test_physics_kernel.py)
TOL_DU, TOL_POS, TOL_FOOT_FRACTION = 1e-2, 1e-5, 0.01
TOL_SAMPLER_M = 1e-6             # the sampler and its plain version read the same cells
# the Cholesky kernels vs their plain versions, per env and relative to the
# largest entry: the factor 1e-4; a solution max(1e-5, eps cond) with eps the
# float32 machine epsilon: the kernel (left-looking) and the plain version
# (right-looking) are two float32 algorithms, each within ~eps cond of the
# exact solution, which the float64 solve gives (and the kernel is held to
# the same bound against it)
TOL_FACTOR, TOL_SOLVE_FLOOR, TOL_SOLVE_PER_COND = 1e-4, 1e-5, 1.1920929e-07
# on the settled robots' mass matrices (cond ~3e3-4e3), which the main paths
# feed, one fixed bound for all four comparisons, five times the largest
# reading there on an H100 (the solve 7.7e-7 from the float64 one, the
# plain version's 7.0e-7): eps cond would allow ~5e-4
TOL_SETTLED = 4e-6
MAX_COND = 1e5
NON_SPD_EVERY = 7                # compare_linalg's envs with a negative pivot
TIMED_LINALG = 200
RAMP = (0.05, -0.05)             # gx, gy of the ramp the extras instance stands on
# the reference's round-4 "warm6" solver: frozen prep and 6 warm-started sweeps
WARM6 = {"pgs_freeze_prep": True, "pgs_iterations": 6, "pgs_warm_start": True}
SAMPLER_OPS_PER_SCAN, SAMPLER_OPS_PER_CONTACT = 13, 16
REPEATS = 5                      # runs of each instance in the determinism phase
PLAY_STEPS = 300                 # the reference play's default rollout
SMALL_N = (1, 37)                # B1 vs plain where play runs it: 1 env, a tail block
TOL_EXPORT = 1e-5                # the exports against the float32 actor
PHASES = ("linalg", "control", "extras", "sampler", "penalty", "warm", "determinism",
          "d11_control", "train", "d11_train", "checkpoint", "d11_play", "profile", "time")
D11_TASK = "d11_ppo"             # the 18-dof robot: nj 18, nb 19, nv 24
PROFILED_ITERATIONS = 1          # the profile phase: train --profile 1 on humanoid_ppo


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


def graph_ms(fn, reps):
    """Device time per call of fn: `reps` calls captured in one CUDA graph
    and replayed, so that the wrapper's host cost per call (its checks, the
    ctypes call), which sets cuda_ms for a kernel of a few microseconds, is
    left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, 3) / reps


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "operations": ops, "bytes": nbytes}


def t32(x):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=DEVICE).contiguous()


def settle(kernel, model, default_pos, planes=None, seed=0):
    """4096 envs standing on both feet: small random joint offsets held by
    the PD targets, randomized base mass and friction, settled for 0.3 s by
    the kernel (on the flat plane, or on `planes`). Returns (pack, masses,
    friction, targets)."""
    import numpy as np
    import torch

    from humanoid_tpu_torch.ops.physics_kernel import pack_state
    from humanoid_tpu_torch.physics.engine import PhysState

    rng = np.random.default_rng(seed)
    qj = default_pos + rng.uniform(-0.05, 0.05, (N, model.nj))
    masses = np.tile(model.mass, (N, 1))
    masses[:, 0] += rng.uniform(-5.0, 5.0, N)
    phys = PhysState(t32(np.c_[np.zeros((N, 2)), np.full(N, 0.90)]),
                     t32(np.tile([1.0, 0.0, 0.0, 0.0], (N, 1))), t32(qj),
                     torch.zeros(N, model.nv, device=DEVICE))
    pack, masses, friction, targets = pack_state(phys), t32(masses), t32(rng.uniform(0.1, 2.0, N)), t32(qj)
    for _ in range(30):
        pack, diag = kernel(pack, masses, friction, targets, 10, True, True, planes=planes)
    torch.cuda.synchronize()
    weight = model.total_mass * 9.81
    if float(diag.foot_forces[..., 2].sum(1).median()) < 0.8 * weight:
        raise AssertionError("the settled robots do not stand on their feet")
    return pack, masses, friction, targets


def pressed(inputs):
    pack = inputs[0].clone()
    pack[2] -= 1e-3                  # every sole corner 1 mm in: one active contact set
    return (pack,) + tuple(inputs[1:])


def dropped(inputs, nj):
    """The settled robots lifted 2 mm and falling at 0.3 m/s: their soles
    land within the control step, so the impulses build up over substeps."""
    pack = inputs[0].clone()
    pack[2] += 2e-3
    pack[7 + nj + 5] = -0.3          # the base's vertical velocity
    return (pack,) + tuple(inputs[1:])


def random_extras(model, kp, kd, seed=1):
    """Per-env gains (N, 3 nj) and bodies (N, 9 nb) in the ranges of the
    reference's domain randomization, and the motor offsets (N, nj)."""
    import numpy as np
    import torch

    from humanoid_tpu_torch.ops.physics_kernel import pack_body

    rng = np.random.default_rng(seed)
    nj, nb = model.nj, model.nb
    strength = np.repeat(rng.uniform(0.8, 1.2, (N, 1)), nj, axis=1)
    gains = np.concatenate([kp * rng.uniform(0.8, 1.2, (N, nj)),
                            kd * rng.uniform(0.8, 1.2, (N, nj)), strength], axis=1)
    com = np.tile(model.com, (N, 1, 1))
    com[:, 0] += np.c_[rng.uniform(-0.07, 0.03, N), rng.uniform(-0.03, 0.03, (N, 2))]
    f6 = rng.uniform(0.8, 1.2, (N, nb, 6))
    inertia = np.tile(model.inertia, (N, 1, 1, 1)) * f6[..., (0, 1, 2, 1, 3, 4, 2, 4, 5)].reshape(
        N, nb, 3, 3)
    body = pack_body(t32(com), t32(inertia)).contiguous()
    return t32(gains), body, t32(rng.uniform(-0.035, 0.035, (N, nj)))


def ramp_planes(model):
    import numpy as np

    from humanoid_tpu_torch.ops.physics_kernel import n_points

    return t32(np.tile([0.0, *RAMP], (N, n_points(model))))


def random_near_ground(model, seed=7):
    """A random near-ground batch (the reference's kernel-vs-XLA PGS test
    layout) over random per-point planes with |slope| <= 0.3. Returns
    (pack, targets, planes)."""
    import numpy as np

    from humanoid_tpu_torch.ops.physics_kernel import n_points, pack_state
    from humanoid_tpu_torch.physics.engine import PhysState

    rng = np.random.default_rng(seed)
    phys = PhysState(t32(np.c_[rng.uniform(-0.1, 0.1, (N, 2)), rng.uniform(0.82, 0.95, N)]),
                     t32(np.tile([1.0, 0.0, 0.0, 0.0], (N, 1))),
                     t32(rng.uniform(-0.2, 0.2, (N, model.nj))),
                     t32(rng.uniform(-0.5, 0.5, (N, model.nv))))
    P = n_points(model)
    planes = np.concatenate([rng.uniform(-0.03, 0.03, (N, P, 1)),
                             rng.uniform(-0.2, 0.2, (N, P, 2))], axis=2).reshape(N, -1)
    return pack_state(phys), t32(rng.uniform(-0.3, 0.3, (N, model.nj))), t32(planes)


def compare(kernel, model, inputs, decimation, freeze, freeze_prep, drop=None, plain_of=None,
            **extras):
    """Kernel vs plain version on the same inputs; with `drop`, the plain
    version runs without that optional input, with `plain_of` it is that
    wrapper's (controls: the bounds must then fail)."""
    import torch

    pack, masses, friction, targets = inputs
    a, da = kernel(pack, masses, friction, targets, decimation, freeze, freeze_prep, **extras)
    b, db = (plain_of or kernel).plain(pack, masses, friction, targets, decimation, freeze,
                                       freeze_prep,
                                       **{k: v for k, v in extras.items() if k != drop})
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


def within(r):
    return (r["finite"] and r["max_du"] < TOL_DU and r["max_base_pos"] < TOL_POS
            and r["max_foot_force_over_weight"] < TOL_FOOT_FRACTION)


def check_within(name, r):
    if not within(r):
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {r}")


def sampler_points(env, seed=3):
    """4096 envs spread over the curriculum cells, each with a random yaw:
    the 187 scan points of the yaw-rotated grid and the 9 contact points
    of the default stance, jittered by 5 cm."""
    import numpy as np
    import torch

    from humanoid_tpu_torch.physics.spatial import quat_apply_yaw

    rng = np.random.default_rng(seed)
    w = env.terrain_world
    base = np.c_[rng.uniform(0.0, w.num_rows * w.terrain_length, N),
                 rng.uniform(0.0, w.num_cols * w.terrain_length, N), np.full(N, 0.9)]
    yaw = rng.uniform(-math.pi, math.pi, N)
    quat = t32(np.c_[np.cos(yaw / 2), np.zeros((N, 2)), np.sin(yaw / 2)])
    base = t32(base)
    scan = (quat_apply_yaw(quat[:, None], env.height_points[None]) + base[:, None])[..., 0:2]
    c, s = torch.cos(t32(yaw))[:, None], torch.sin(t32(yaw))[:, None]
    d = env._default_contact_xy[None]
    con = base[:, None, 0:2] + torch.stack([c * d[..., 0] - s * d[..., 1],
                                            s * d[..., 0] + c * d[..., 1]], dim=-1)
    con = con + t32(rng.uniform(-0.05, 0.05, tuple(con.shape)))
    return scan.contiguous(), con.contiguous()


def train_phase(train, registry, task, iterations, log_name, log_root, sim=None, n_envs=N,
                argv=()):
    """Train `task` at n_envs envs: through scripts.train.main (with
    `argv` added), saving under `log_root`, or, with `sim` overrides of its
    SimCfg, through registry.make_env(env_cfg=...) and make_alg_runner,
    saving nothing. The env and its wrappers are new, so every count starts
    at 0. Returns (runner, carry, rows, peak)."""
    import dataclasses

    import torch

    torch.cuda.reset_peak_memory_stats()
    rows = []

    def log_fn(it, m, fps):
        row = {"it": it, "env_steps_per_s": fps, "rollout_s": m.rollout_s,
               "update_s": m.update_s, "mean_reward": float(m.mean_step_reward),
               "value_loss": float(m.update.value_loss),
               "surrogate_loss": float(m.update.surrogate_loss),
               "kl": float(m.update.kl), "sym_loss": float(m.update.sym_loss),
               "kernel_launches": m.kernel_launches,
               "sampler_launches": m.sampler_launches, "factor_launches": m.factor_launches,
               "apply_launches": m.apply_launches, "solve_launches": m.solve_launches}
        emit(log_name, task=task, sim=sim or {}, **row)
        rows.append(row)

    if sim is None:
        runner, carry = train.main(["--task", task, "--num-envs", str(n_envs),
                                    "--max-iterations", str(iterations), "--device", DEVICE,
                                    "--log-root", log_root, *argv], log_fn=log_fn)
    else:
        cfg, _ = registry.get_cfgs(task)
        cfg = cfg.replace(env=dataclasses.replace(cfg.env, num_envs=n_envs),
                          sim=dataclasses.replace(cfg.sim, **sim))
        env, _, train_cfg = registry.make_env(task, device=DEVICE, env_cfg=cfg)
        runner = registry.make_alg_runner(env, train_cfg, log_root=False)
        carry = runner.learn(iterations, log_fn=log_fn)
    return runner, carry, rows, torch.cuda.max_memory_allocated()


def check_training(task, runner, carry, rows, env_cfg, iterations, expect, n_envs=N):
    """Finite losses (the symmetry loss too, positive where the task has
    it), parameters and observations of the right shapes, and exactly the
    expected launches of each kernel in every iteration."""
    import numpy as np
    import torch

    losses_finite = all(np.isfinite([r["value_loss"], r["surrogate_loss"], r["kl"],
                                     r["sym_loss"]]).all() for r in rows)
    if runner.cfg.algorithm.sym_loss and not all(r["sym_loss"] > 0 for r in rows):
        raise AssertionError(f"{task}: the symmetry loss is on but reads 0: {rows}")
    params_finite = all(bool(torch.isfinite(p).all()) for p in runner.net.parameters())
    obs_finite = bool(torch.isfinite(carry.obs).all() and torch.isfinite(carry.critic_obs).all())
    shapes = [tuple(carry.obs.shape), tuple(carry.critic_obs.shape)]
    if len(rows) != iterations or any(r[k] != n for r in rows for k, n in expect.items()):
        raise AssertionError(f"{task}: expected {expect} launches per iteration: {rows}")
    if not (losses_finite and params_finite and obs_finite):
        raise AssertionError(f"{task}: training produced non-finite numbers")
    if shapes != [(n_envs, env_cfg.env.num_observations),
                  (n_envs, env_cfg.env.num_privileged_obs)]:
        raise AssertionError(f"{task}: unexpected observation shapes {shapes}")
    return {"losses_finite": losses_finite, "params_finite": params_finite,
            "obs_finite": obs_finite, "obs_shapes": shapes}


def random_spd(n, seed=12):
    """N random SPD matrices (N, n, n) with condition numbers log-uniform in
    [1, MAX_COND], and right-hand sides (N, n)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(N, n, n)))
    cond = np.exp(rng.uniform(0.0, math.log(MAX_COND), N))
    eig = np.exp(rng.uniform(0.0, 1.0, (N, n)) * np.log(cond)[:, None])
    eig[:, 0], eig[:, -1] = 1.0, cond
    return t32(Q * eig[:, None, :] @ np.swapaxes(Q, 1, 2)), t32(rng.normal(size=(N, n)))


def mass_matrices(model, inputs):
    """The CRBA mass matrices (N, nv, nv) of a state pack, and the bias
    forces' negative as right-hand sides (N, nv): the free acceleration."""
    from humanoid_tpu_torch.ops.physics_kernel import unpack_state
    from humanoid_tpu_torch.physics.dynamics import assemble_mass_matrix, compute_kinematics_bias
    from humanoid_tpu_torch.physics.kinematics import RobotTensors

    st = unpack_state(inputs[0], model.nj)
    rt = RobotTensors.from_model(model, DEVICE)
    out = compute_kinematics_bias(rt, st.base_pos, st.base_quat, st.qj, st.u, mass=inputs[1])
    return assemble_mass_matrix(rt, out[2], out[3]).contiguous(), (-out[5]).contiguous()


def compare_linalg(chol, M, b, fixed=None):
    """B3, B4 (against the plain factor) and B5 of the wrappers `chol` vs
    their plain versions on the same inputs, per env, relative to each env's
    largest entry; the solve also against the float64 one. The bounds:
    TOL_FACTOR and max(TOL_SOLVE_FLOOR, TOL_SOLVE_PER_COND cond), or
    `fixed` for all four. Then each kernel on the same inputs again: a
    second launch, NaN above the diagonal of M or L (never read), and a
    negative pivot in every NON_SPD_EVERY-th env (NaN there from that pivot
    on, the factor's upper triangle still zeros, the other envs unchanged);
    each must give the same bits as the first launch outside the NaN envs."""
    import torch

    from humanoid_tpu_torch.ops import linalg

    cond = torch.linalg.eigvalsh(M.double())
    cond = (cond[:, -1] / cond[:, 0]).float()
    L, Lp = chol.factor_spd_batch(M), linalg.chol_factor_unrolled(M)
    x, xp = chol.apply_spd_batch(Lp, b), linalg.chol_apply_unrolled(Lp, b)
    xs, xsp = chol.solve_spd_batch(M, b), linalg.chol_solve_unrolled(M, b)
    torch.cuda.synchronize()
    x64 = torch.linalg.solve(M.double(), b.double()[..., None])[..., 0]
    if fixed is None:
        tol_factor, tol = TOL_FACTOR, torch.clamp(TOL_SOLVE_PER_COND * cond, min=TOL_SOLVE_FLOOR)
    else:
        tol_factor, tol = fixed, torch.full_like(cond, fixed)
    rel = {"factor": (L - Lp).abs().amax((1, 2)) / Lp.abs().amax((1, 2)),
           "apply": (x - xp).abs().amax(1) / xp.abs().amax(1),
           "solve": (xs - xsp).abs().amax(1) / xsp.abs().amax(1)}
    vs64 = {name: ((y.double() - x64).abs().amax(1) / x64.abs().amax(1)).float()
            for name, y in (("solve_kernel", xs), ("solve_plain", xsp))}
    over = (rel["factor"] >= tol_factor) | (rel["apply"] >= tol) | (rel["solve"] >= tol) \
        | (vs64["solve_kernel"] >= tol)
    finite = all(bool(torch.isfinite(y).all()) for y in (L, x, xs, Lp, xp, xsp))
    n = M.shape[-1]
    rows, cols = torch.triu_indices(n, n, 1, device=M.device)
    M_nan, L_nan = M.clone(), Lp.clone()
    M_nan[:, rows, cols] = L_nan[:, rows, cols] = float("nan")
    bad = M.clone()
    bad[::NON_SPD_EVERY, 2, 2] = -1.0
    L_bad = chol.factor_spd_batch(bad)
    runs = {   # kernel: (first launch, [the same inputs again, NaN above the diagonal], non-SPD)
        "factor": (L, [chol.factor_spd_batch(M), chol.factor_spd_batch(M_nan)], L_bad),
        "apply": (x, [chol.apply_spd_batch(Lp, b), chol.apply_spd_batch(L_nan, b)],
                  chol.apply_spd_batch(linalg.chol_factor_unrolled(bad), b)),
        "solve": (xs, [chol.solve_spd_batch(M, b), chol.solve_spd_batch(M_nan, b)],
                  chol.solve_spd_batch(bad, b))}
    torch.cuda.synchronize()
    bits = lambda y: y.view(torch.int32)  # noqa: E731
    hit = torch.zeros(M.shape[0], dtype=torch.bool, device=M.device)
    hit[::NON_SPD_EVERY] = True
    nan_env = {k: torch.isnan(v[2].reshape(M.shape[0], -1)).any(1) for k, v in runs.items()}
    same_bits = {k: {"repeat": torch.equal(bits(v[0]), bits(v[1][0])),
                     "upper_nan": torch.equal(bits(v[0]), bits(v[1][1])),
                     "non_spd_elsewhere": torch.equal(bits(v[0][~hit]), bits(v[2][~hit]))}
                 for k, v in runs.items()}
    return {
        "cond_range": [cond.min().item(), cond.max().item()],
        "tolerance": {"factor": tol_factor, "solve": fixed if fixed is not None else
                      f"max({TOL_SOLVE_FLOOR}, {TOL_SOLVE_PER_COND} cond)"},
        "max_rel_err": {k: v.max().item() for k, v in rel.items()},
        "max_rel_err_over_tol": {"factor": (rel["factor"] / tol_factor).max().item(),
                                 "apply": (rel["apply"] / tol).max().item(),
                                 "solve": (rel["solve"] / tol).max().item()},
        "max_rel_err_vs_float64": {k: v.max().item() for k, v in vs64.items()},
        "max_rel_err_vs_float64_over_tol": {k: (v / tol).max().item() for k, v in vs64.items()},
        "max_abs_err": {"factor": (L - Lp).abs().max().item(), "apply": (x - xp).abs().max().item(),
                        "solve": (xs - xsp).abs().max().item()},
        "upper_zero": bool((torch.triu(L, 1) == 0).all() and (torch.triu(L_bad, 1) == 0).all()),
        "envs_over_bounds": int(over.sum()), "finite": finite,
        "nan_on_non_spd": {k: bool(torch.equal(v, hit)) for k, v in nan_env.items()},
        "same_bits": same_bits,
    }


def same_bits(a, b):
    """Equal tensors, bit for bit (float32 compared as int32), or both None."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    as_bits = (lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x)  # noqa: E731
    return a.shape == b.shape and torch.equal(as_bits(a), as_bits(b))


def same_training_state(a, b):
    """Every parameter and Adam moment in bits, Adam's count and learning
    rate, and the iteration, of runners a and b."""
    return {
        "params": all(same_bits(p.detach(), q.detach())
                      for p, q in zip(a.net.parameters(), b.net.parameters())),
        "adam_moments": all(same_bits(x, y) for xs, ys in ((a.opt.mu, b.opt.mu),
                                                           (a.opt.nu, b.opt.nu))
                            for x, y in zip(xs, ys)),
        "count": a.opt.count == b.opt.count, "lr": same_bits(a.opt.lr, b.opt.lr),
        "iteration": a.iteration == b.iteration}


def same_carry(a, b):
    """Each field of two iteration carries in bits, by name."""
    out = {f"env_state.{f}": same_bits(x, y)
           for f, x, y in zip(a.env_state._fields, a.env_state, b.env_state) if f != "phys"}
    out.update({f"phys.{f}": same_bits(x, y)
                for f, x, y in zip(a.env_state.phys._fields, a.env_state.phys, b.env_state.phys)})
    out.update(obs=same_bits(a.obs, b.obs), critic_obs=same_bits(a.critic_obs, b.critic_obs))
    return out


def timed(fn):
    """(result, seconds) of fn(), the card synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def play_and_check(play, task, net, runs, root, iteration):
    """`scripts.play.main` on the latest checkpoint of `task` under `runs` (of
    the network `net` at `iteration`) at 1 and at N envs for PLAY_STEPS
    steps: B1 once per step, finite states, the six artifacts written, and
    policy.npz, the TorchScript pair and policy.onnx within TOL_EXPORT of
    the float32 actor. Returns (a summary per env count, launches by path,
    the bf16 actor's largest gap from the export)."""
    import copy

    import numpy as np
    import torch

    from humanoid_tpu_torch.deploy.npz_policy import NpzPolicy
    from humanoid_tpu_torch.deploy.onnx_loader import load_onnx_mlp

    f32 = copy.deepcopy(net).cpu()
    f32.compute_dtype = torch.float32
    obs = torch.as_tensor(np.random.default_rng(5).normal(size=(256, f32.actor.layers[0]
                                                                 .in_features)),
                          dtype=torch.float32)
    with torch.no_grad():
        want, want_vel = f32.act_mean(obs).numpy(), f32.estimate_vel(obs).numpy()
        bf16_gap = (net.act_mean(obs.to(DEVICE)).cpu().numpy() - want)
    plays, launches = {}, {}
    for n in (1, N):   # play's default env count, and training's
        res = play.main(["--task", task, "--num-envs", str(n), "--steps", str(PLAY_STEPS),
                         "--log-root", runs, "--out-dir", os.path.join(root, f"play_{task}_{n}"),
                         "--device", DEVICE])
        d = res["out_dir"]
        artifacts = ["policy.npz", "policy_1.pt", "base_lin_vel.pt", "policy.onnx",
                     "openloop_action.npz", "eval_states.npz"]
        with torch.no_grad():
            err = {"npz_actor": np.abs(NpzPolicy(res["npz"])(obs.numpy()) - want).max(),
                   "npz_vel": np.abs(NpzPolicy(res["npz"], "vel")(obs.numpy()) - want_vel).max(),
                   "onnx": np.abs(load_onnx_mlp(os.path.join(d, "policy.onnx"))(obs.numpy())
                                  - want).max(),
                   "torchscript_actor": np.abs(torch.jit.load(os.path.join(d, "policy_1.pt"))(
                       obs).numpy() - want).max(),
                   "torchscript_vel": np.abs(torch.jit.load(os.path.join(d, "base_lin_vel.pt"))(
                       obs).numpy() - want_vel).max()}
        plays[n] = {"task": task, "envs": n, "steps": res["steps"], "launches": res["launches"],
                    "steps_per_s": res["steps_per_s"], "rollout_s": res["rollout_s"],
                    "final_z": res["final_z"], "finite": res["finite"],
                    "artifacts": {a: os.path.isfile(os.path.join(d, a)) for a in artifacts},
                    "max_abs_err_vs_float32_actor": {k: float(v) for k, v in err.items()},
                    "iteration": int(np.load(res["npz"])["meta_iteration"])}
        prefix = "play" if task == "humanoid_ppo" else f"play {task}"
        launches[f"{prefix} {n} env" + ("s" if n > 1 else "")] = res["launches"]
        if res["launches"]["control_step_kernel"] != res["steps"] or not res["finite"] \
                or not all(plays[n]["artifacts"].values()) or plays[n]["iteration"] != iteration \
                or not max(err.values()) <= TOL_EXPORT:
            raise AssertionError(f"play {task} at {n} envs: {plays[n]}")
    return list(plays.values()), launches, float(np.abs(bf16_gap).max())


def checkpoint_phase(train, play, registry, probe, model, inputs, root):
    """humanoid_ppo at N envs through the entry points a user calls: train
    2 iterations with --full-state, load model_2 into a new runner (the same
    bits), resume from the exact state for 1 iteration (the restored carry
    and generator the saved ones, in bits), then `play` the resumed run's
    checkpoint at 1 and at N envs and hold its four artifacts against the
    float32 actor. Also B1 against its plain version at 1 and 37 envs (the
    control phase's comparisons on the first envs of `inputs`) and its
    device time there, and the seconds and bytes of save, save_state, load
    and load_state. Returns (summary, launches by path)."""
    import torch

    from humanoid_tpu_torch.algo.runner import OnPolicyRunner
    from humanoid_tpu_torch.utils.checkpoint import get_load_path

    task, S = "humanoid_ppo", STEPS_PER_ITERATION
    runs, unbroken_root = os.path.join(root, "runs"), os.path.join(root, "unbroken")
    cfg, _ = registry.get_cfgs(task)
    expect = {"kernel_launches": S, "sampler_launches": 0, "factor_launches": 0,
              "apply_launches": 0, "solve_launches": 0}
    out, launches = {}, {}

    # 1. two iterations, saved with the exact state
    first, carry2, rows, _ = train_phase(train, registry, task, 2, "checkpoint_train", runs,
                                         n_envs=N, argv=["--full-state"])
    gen2 = first.gen.get_state().clone()
    check_training(task, first, carry2, rows, cfg, 2, expect, N)
    launches["checkpoint: train 2 iterations"] = play.kernel_launches(first.env)
    run = first.log_dir
    files = sorted(os.listdir(run))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    names = {"Loss/value_function", "Loss/surrogate", "Loss/base_lin_vel", "Loss/sym",
             "Loss/learning_rate", "Policy/mean_noise_std", "Policy/kl", "Train/mean_reward",
             "Train/mean_episode_length", "Train/mean_step_reward", "Train/ep_fail_frac",
             "Perf/total_fps", "Perf/iter_time",
             *(f"Episode/rew_{n}" for n in first.env.reward_names)}
    if not {"model_2.pt", "state_2.pt", "metrics.jsonl"} <= set(files) \
            or [r["it"] for r in logged] != [1, 2] or any(set(r) - {"it"} != names
                                                          for r in logged):
        raise AssertionError(f"checkpoint: the run wrote {files} and logged {logged}")

    # 2. model_2 into a new runner: the same bits
    loaded = OnPolicyRunner(first.env, first.cfg)
    model_path = get_load_path(os.path.join(runs, first.cfg.runner.experiment_name))
    loaded.load(model_path)
    out["load_same_bits"] = same_training_state(first, loaded)
    if not all(out["load_same_bits"].values()):
        raise AssertionError(f"checkpoint: load gave other bits: {out['load_same_bits']}")

    # the seconds and bytes of each way in and out, at N envs
    io_dir = os.path.join(root, "io")
    io = {}
    for name, fn in (("save", lambda: first.save(os.path.join(io_dir, "model_2"))),
                     ("save_state", lambda: first.save_state(carry2,
                                                             os.path.join(io_dir, "state_2")))):
        path, sec = timed(fn)
        io[name] = {"s": sec, "bytes": os.path.getsize(path)}
    for name, fn in (("load", lambda: loaded.load(os.path.join(io_dir, "model_2"))),
                     ("load_state", lambda: loaded.load_state(os.path.join(io_dir, "state_2")))):
        _, sec = timed(fn)
        io[name] = {"s": sec, "bytes": io[name.replace("load", "save")]["bytes"]}
    out["io"] = io
    del loaded

    # 3. resume through train.main from the exact state
    restored = {}
    load_state = OnPolicyRunner.load_state

    def spy(runner, path):
        carry = load_state(runner, path)
        restored.update(path=path, carry=carry, gen=runner.gen.get_state().clone())
        return carry

    OnPolicyRunner.load_state = spy
    try:
        resumed, carry3, rows, _ = train_phase(train, registry, task, 1, "checkpoint_resume", runs,
                                               n_envs=N, argv=["--resume", "--full-state"])
    finally:
        OnPolicyRunner.load_state = load_state
    check_training(task, resumed, carry3, rows, cfg, 1, expect, N)
    launches["checkpoint: resume 1 iteration"] = play.kernel_launches(resumed.env)
    carry_bits = same_carry(carry2, restored["carry"]) if restored else {}
    out["resume"] = {
        "from": restored.get("path"), "iteration": resumed.iteration,
        "carry_same_bits": all(carry_bits.values()) if carry_bits else False,
        "carry_fields_differing": [k for k, v in carry_bits.items() if not v],
        "generator_same_bits": bool(restored) and torch.equal(restored["gen"], gen2),
        "kernel_launches": [r["kernel_launches"] for r in rows],
        "value_loss": [r["value_loss"] for r in rows]}
    if not (restored and restored["path"].endswith("state_2") and resumed.iteration == 3
            and out["resume"]["carry_same_bits"] and out["resume"]["generator_same_bits"]):
        raise AssertionError(f"checkpoint: the exact-state resume failed: {out['resume']}")
    del first, carry2, restored

    # the unbroken 3-iteration run of the same seed: recorded, not a gate
    unbroken, _, _, _ = train_phase(train, registry, task, 3, "checkpoint_unbroken",
                                    unbroken_root, n_envs=N)
    out["resume_vs_unbroken_max_param_diff"] = max(
        (p.detach() - q.detach()).abs().max().item()
        for p, q in zip(resumed.net.parameters(), unbroken.net.parameters()))
    launches["checkpoint: unbroken 3 iterations"] = play.kernel_launches(unbroken.env)
    del unbroken

    # 4. play the resumed run (model_3) at 1 and at N envs
    out["play"], play_launches, out["bf16_actor_max_abs_gap_vs_export"] = play_and_check(
        play, task, resumed.net, runs, root, 3)
    launches.update(play_launches)
    del resumed

    # 5. B1 against its plain version where play runs it: 1 env, and 37 (a tail block)
    small = {}
    for n in SMALL_N:
        pack, masses, friction, targets = inputs
        sub = (pack[:, :n].contiguous(), masses[:n].contiguous(), friction[:n].contiguous(),
               targets[:n].contiguous())
        for name, args in (("shipping", (10, True, True)), ("exact", (1, False, False))):
            r = compare(probe, model, sub, *args)
            again = probe(*sub, *args)[0]
            r["same_bits_on_repeat"] = same_bits(probe(*sub, *args)[0], again)
            r["ms"] = graph_ms(lambda: probe(*sub, *args), TIMED_LAUNCHES)
            small[f"{name}_{n}"] = r
            check_within(f"B1 {name} at {n} envs", r)
            if not r["same_bits_on_repeat"]:
                raise AssertionError(f"B1 {name} at {n} envs: other bits on repeat")
    out["b1_small_n_vs_plain"] = small
    return out, launches


def trace_summary(path, top=5):
    """The device ops of a torch.profiler trace (kernels, copies, memsets)
    with the most total time, and the share of the `rollout` span's wall
    time in which the device ran any of them (their intervals' union)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == "rollout"]
    totals = {}
    for e in device:
        totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"]
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    out = {"device_ops": [{"name": n[:120], "total_ms": t / 1e3,
                           "calls": sum(e["name"] == n for e in device)} for n, t in ranked],
           "device_events": len(device), "rollout_spans": len(spans)}
    if len(spans) != 1:
        out["device_busy_share_of_rollout"] = None
        return out
    t0, t1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    busy, end = 0.0, t0
    for a, b in sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in device):
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    out.update(rollout_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3,
               device_busy_share_of_rollout=busy / (t1 - t0))
    return out


def parse_phases(argv):
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of humanoid_tpu_torch on one card.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown or not phases:
        ap.error(f"unknown phases {unknown}: choose from {','.join(PHASES)}")
    return set(phases)


def main(argv=None):
    phases = parse_phases(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    log_root = tempfile.mkdtemp(prefix="chip_smoke_")   # every run's checkpoints and logs
    try:
        run(phases, log_root)
    finally:
        shutil.rmtree(log_root, ignore_errors=True)


def run(phases, log_root):
    import torch

    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from humanoid_tpu_torch.ops import linalg
    from humanoid_tpu_torch.ops.build import build_all, ptxas_summary
    from humanoid_tpu_torch.ops.physics_kernel import (ControlStepKernel, launch_bytes,
                                                      operations_per_env)
    from humanoid_tpu_torch.ops.terrain_sampler import (TerrainSampler, sample_bytes,
                                                        sample_plain, touched_cells)
    from humanoid_tpu_torch.scripts import play, train
    from humanoid_tpu_torch.utils import registry

    # ---- 0. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, phases=[p for p in PHASES if p in phases])

    # ---- 1. build: one nvcc per source, started together ----
    sources = ("control_step.cu", "terrain_sampler.cu", "linalg.cu")
    t0 = time.perf_counter()
    built = build_all(sources)
    wall = time.perf_counter() - t0
    ptxas = {}
    for src in sources:
        ptxas.update(ptxas_summary(built[src].ptxas))
        emit("build", source=f"humanoid_tpu_torch/csrc/{src}", nvcc_s=built[src].seconds,
             all_builds_wall_s=wall, kernels=ptxas_summary(built[src].ptxas),
             ptxas=list(built[src].ptxas))

    # ---- settled robots on the flat plane: the inputs of phases 2 and 3 ----
    env_cfg, _ = registry.get_cfgs("humanoid_ppo")
    env, _, _ = registry.make_env("humanoid_ppo", device=DEVICE)
    model, kernel = env.model, env.physics
    # second wrappers of the same kernel for the comparisons and timings, so
    # that the training runs' launch counts are the main paths' alone: the
    # shipping PGS instance, the penalty one and the warm-started one
    probe = ControlStepKernel(model, *kernel.gains, kernel.contact_params, kernel.pgs_params,
                              kernel.dt)
    pprobe = ControlStepKernel(model, *probe.gains, probe.contact_params, None, probe.dt)
    wprobe = ControlStepKernel(model, *probe.gains, probe.contact_params,
                               probe.pgs_params._replace(warm_start=True), probe.dt)
    del env, kernel
    default_pos = np.asarray(env_cfg.init_state.default_joint_angles)
    settled = settle(probe, model, default_pos)
    on_flat = pressed(settled)
    sweeps = env_cfg.sim.pgs_iterations
    # the inputs of the extras instance: random gains and bodies, robots
    # settled on the ramp
    gains, body, offsets = random_extras(model, *probe.gains[:2])
    planes = ramp_planes(model)
    on_ramp = settle(probe, model, default_pos, planes=planes)
    ramp_pressed = pressed(on_ramp)
    with_offsets = lambda x: x[:3] + ((x[3] + offsets).contiguous(),)  # noqa: E731
    tolerance = {"du": TOL_DU, "base_pos": TOL_POS, "foot_force_over_weight": TOL_FOOT_FRACTION}
    results = {}

    # ---- 2. the Cholesky factor, apply and solve vs plain, ahead of the
    # control-step comparisons (whose plain version runs the plain Cholesky) ----
    if "linalg" in phases:
        spd_M, spd_b = random_spd(model.nv)
        crba_M, crba_b = mass_matrices(model, settled)
        lprobe = linalg.CholeskyKernels()
        linalg_results = {
            "settled_mass_matrices": compare_linalg(lprobe, crba_M, crba_b, fixed=TOL_SETTLED),
            "random_spd": compare_linalg(lprobe, spd_M, spd_b)}
        emit("linalg_vs_plain", envs=N, n=model.nv, **linalg_results)
        for name, r in linalg_results.items():
            if r["envs_over_bounds"] or not r["finite"] or not r["upper_zero"] \
                    or not all(r["nan_on_non_spd"].values()) \
                    or not all(all(v.values()) for v in r["same_bits"].values()):
                raise AssertionError(
                    f"linalg ({name}): a kernel disagrees with its plain version: {r}")
        linalg_err = {k: max(r["max_abs_err"][k] for r in linalg_results.values())
                      for k in ("factor", "apply", "solve")}

    # ---- 3. the control step vs plain on humanoid_ppo's instances (and the
    # unfrozen-prep one) ----
    if "control" in phases:
        for name, args in (("exact", (1, False, False)), ("shipping", (10, True, True)),
                           ("unfrozen_prep", (10, True, False))):
            on_pressed = compare(probe, model, on_flat, *args)
            on_settled = compare(probe, model, settled, *args)
            emit(f"{name}_vs_plain", decimation=args[0], freeze=args[1], freeze_prep=args[2],
                 sweeps=sweeps, envs=N, design=probe.design(), tolerance=tolerance,
                 pressed_1mm=on_pressed, settled=on_settled)
            check_within(f"{name} (feet pressed 1 mm)", on_pressed)
            if not on_settled["finite"] or on_settled["median_du"] >= 1e-3:
                raise AssertionError(
                    f"{name} (settled): median per-env |du| too large: {on_settled}")
            results[name] = on_pressed

    # ---- 3b. the control step's gains, body and planes inputs vs plain ----
    if "extras" in phases:
        rng_pack, rng_targets, rng_planes = random_near_ground(model)
        rng_inputs = (rng_pack, settled[1], settled[2], rng_targets)
        extras = {
            "gains_body_flat_pressed": compare(probe, model, with_offsets(on_flat), 10, True,
                                               True, gains=gains, body=body),
            "all_ramp_pressed": compare(probe, model, with_offsets(ramp_pressed), 10, True, True,
                                        gains=gains, body=body, planes=planes),
            "all_ramp_pressed_unfrozen_prep": compare(
                probe, model, with_offsets(ramp_pressed), 10, True, False, gains=gains,
                body=body, planes=planes),
            "all_random_planes_exact": compare(probe, model, rng_inputs, 1, False, False,
                                               gains=gains, body=body, planes=rng_planes),
        }
        emit("extras_vs_plain", envs=N, ramp_gradient=RAMP, tolerance=tolerance, **extras)
        for name, r in extras.items():
            check_within(name, r)
        results["extras"] = extras["all_ramp_pressed"]
        # controls: the plain version without one input must fall outside the
        # bounds, or they could not tell a kernel that ignores that input
        controls = {f"plain_without_{d}": compare(probe, model, with_offsets(ramp_pressed), 10,
                                                  True, True, drop=d, gains=gains, body=body,
                                                  planes=planes)
                    for d in ("gains", "body", "planes")}
        emit("extras_controls", envs=N, **controls)
        for name, r in controls.items():
            if within(r):
                raise AssertionError(f"{name}: the bounds do not see the missing input: {r}")

    # ---- 3c. the sampler vs plain on the full humanoid_ppo_terrain world ----
    if "sampler" in phases:
        tenv, tcfg, _ = registry.make_env("humanoid_ppo_terrain", device=DEVICE)
        world = tenv.terrain_world
        sprobe = TerrainSampler(world.height, tcfg.terrain.vertical_scale,
                                world.horizontal_scale, world.border, device=DEVICE)
        scan_xy, con_xy = sampler_points(tenv)
        del tenv
        k_scan, k_corners = sprobe(scan_xy, con_xy)
        p_scan, p_corners = sprobe.plain(scan_xy, con_xy)
        torch.cuda.synchronize()
        errs = {"scan": (k_scan - p_scan).abs().max().item()}
        for name, a, b in zip(("h00", "h10", "h01", "h11", "tx", "ty"), k_corners, p_corners):
            errs[name] = (a - b).abs().max().item()
        sampler_err = max(errs.values())
        emit("sampler_vs_plain", envs=N, raster=list(sprobe.raster.shape),
             scan_points=scan_xy.shape[1], contact_points=con_xy.shape[1], max_abs_err=errs,
             tolerance_m=TOL_SAMPLER_M, scan_range_m=[p_scan.min().item(), p_scan.max().item()],
             finite=bool(torch.isfinite(k_scan).all()))
        if not sampler_err <= TOL_SAMPLER_M or not bool(torch.isfinite(k_scan).all()):
            raise AssertionError(f"sampler disagrees with its plain version: {errs}")

    # ---- 3d. the control step's penalty instance vs plain ----
    if "penalty" in phases:
        penalty = {
            "flat_pressed_shipping": compare(pprobe, model, on_flat, 10, True, True),
            "flat_pressed_exact": compare(pprobe, model, on_flat, 1, False, False),
            "all_ramp_pressed_shipping": compare(pprobe, model, with_offsets(ramp_pressed), 10,
                                                 True, True, gains=gains, body=body,
                                                 planes=planes),
        }
        # settled, some sole corners sit at round-off of zero gap (Queue C of
        # ROADMAP.md): held to the median bound only, as the PGS instances
        settled_runs = {
            "flat_settled_shipping": compare(pprobe, model, settled, 10, True, True),
            "all_ramp_settled_shipping": compare(pprobe, model, with_offsets(on_ramp), 10, True,
                                                 True, gains=gains, body=body, planes=planes),
        }
        emit("penalty_vs_plain", envs=N, ramp_gradient=RAMP, design=pprobe.design(),
             tolerance=tolerance, **penalty, **settled_runs)
        for name, r in penalty.items():
            check_within(f"penalty {name}", r)
        for name, r in settled_runs.items():
            if not r["finite"] or r["median_du"] >= 1e-3:
                raise AssertionError(f"penalty {name}: median per-env |du| too large: {r}")
        control = compare(pprobe, model, with_offsets(ramp_pressed), 10, True, True,
                          drop="planes", gains=gains, body=body, planes=planes)
        emit("penalty_controls", envs=N, plain_without_planes=control)
        if within(control):
            raise AssertionError(f"penalty: the bounds do not see the missing planes: {control}")
        results["penalty"] = penalty["flat_pressed_shipping"]

    # ---- 3e. the warm-started PGS instance vs plain; control: the cold
    # plain version must fall outside the bounds, in the pressed state or,
    # failing that, in a short drop onto the ground ----
    if "warm" in phases:
        for state_name, inputs in (("pressed_1mm", on_flat), ("drop", dropped(settled, model.nj))):
            warm = {"shipping": compare(wprobe, model, inputs, 10, True, True),
                    "unfrozen": compare(wprobe, model, inputs, 10, False, False),
                    "extras_ramp": compare(wprobe, model, with_offsets(ramp_pressed), 10, True,
                                           True, gains=gains, body=body, planes=planes)}
            control = compare(wprobe, model, inputs, 10, True, True, plain_of=probe)
            emit("warm_compare", envs=N, state=state_name, sweeps=sweeps, tolerance=tolerance,
                 **warm, control_cold_plain=control)
            for name, r in warm.items():
                check_within(f"warm {name} ({state_name})", r)
            if not within(control):
                break
        else:
            raise AssertionError(
                f"warm: the bounds do not tell the cold plain version: {control}")
        results["warm"] = warm["shipping"]

    # ---- 3f. determinism: the PGS and penalty instances REPEATS times on
    # the same inputs give the same bits (a missing sync between a team's
    # lanes shows as differences from run to run) ----
    if "determinism" in phases:
        runs = {
            "shipping": (probe, settled, (10, True, True), {}),
            "exact": (probe, on_flat, (1, False, False), {}),
            "warm": (wprobe, settled, (10, True, True), {}),
            "extras": (probe, with_offsets(on_ramp), (10, True, True),
                       {"gains": gains, "body": body, "planes": planes}),
            "penalty": (pprobe, settled, (10, True, True), {}),
            "penalty_extras_unfrozen": (pprobe, with_offsets(on_ramp), (10, False, False),
                                        {"gains": gains, "body": body, "planes": planes}),
        }
        same = {}
        for name, (k, inputs, args, kw) in runs.items():
            first = k(*inputs, *args, **kw)
            outs = [k(*inputs, *args, **kw) for _ in range(REPEATS - 1)]
            same[name] = [torch.equal(first[0], out[0])
                          and all(torch.equal(x, y) for x, y in zip(first[1], out[1]))
                          for out in outs]
        emit("determinism", envs=N, repeats=REPEATS, identical=same)
        if not all(all(v) for v in same.values()):
            raise AssertionError(f"the control step gave different outputs on the same inputs: "
                                 f"{same}")

    # ---- 3g. the 18-dof robot (d11_ppo): B1 against its plain version at
    # nj = 18 on settled robots pressed 1 mm in (PGS, warm, exact, with gains
    # and body, penalty), the same bits on repeat, and B3-B5 at n = 24 on
    # the settled 18-dof mass matrices ----
    if phases & {"d11_control", "time"}:
        env18, cfg18, _ = registry.make_env(D11_TASK, device=DEVICE)
        model18, k18 = env18.model, env18.physics
        probe18 = ControlStepKernel(model18, *k18.gains, k18.contact_params, k18.pgs_params,
                                    k18.dt)
        pprobe18 = ControlStepKernel(model18, *probe18.gains, probe18.contact_params, None,
                                     probe18.dt)
        wprobe18 = ControlStepKernel(model18, *probe18.gains, probe18.contact_params,
                                     probe18.pgs_params._replace(warm_start=True), probe18.dt)
        del env18, k18
        settled18 = settle(probe18, model18, np.asarray(cfg18.init_state.default_joint_angles))
        on_flat18 = pressed(settled18)
        gains18, body18, offsets18 = random_extras(model18, *probe18.gains[:2])
        flat18_offsets = on_flat18[:3] + ((on_flat18[3] + offsets18).contiguous(),)
        crba_M18, crba_b18 = mass_matrices(model18, settled18)
        lprobe18 = linalg.CholeskyKernels()
    if "d11_control" in phases:
        runs18 = {
            "shipping": (probe18, on_flat18, (10, True, True), {}),
            "exact": (probe18, on_flat18, (1, False, False), {}),
            "warm": (wprobe18, on_flat18, (10, True, True), {}),
            "gains_body": (probe18, flat18_offsets, (10, True, True),
                           {"gains": gains18, "body": body18}),
            "penalty": (pprobe18, on_flat18, (10, True, True), {}),
        }
        d11 = {name: compare(k, model18, inputs, *args, **kw)
               for name, (k, inputs, args, kw) in runs18.items()}
        d11_settled = {name: compare(k, model18, settled18, *runs18[name][2])
                       for name, k in (("shipping", probe18), ("penalty", pprobe18))}
        same18 = {}
        for name, (k, inputs, args, kw) in runs18.items():
            first = k(*inputs, *args, **kw)
            same18[name] = [torch.equal(first[0], out[0])
                            and all(torch.equal(x, y) for x, y in zip(first[1], out[1]))
                            for out in (k(*inputs, *args, **kw) for _ in range(REPEATS - 1))]
        linalg18 = compare_linalg(lprobe18, crba_M18, crba_b18, fixed=TOL_SETTLED)
        emit("d11_control", task=D11_TASK, envs=N, nj=model18.nj, nb=model18.nb, nv=model18.nv,
             design={"pgs": probe18.design(), "penalty": pprobe18.design()},
             tolerance=tolerance, pressed_1mm=d11, settled=d11_settled, repeats=REPEATS,
             identical=same18, linalg_n24=linalg18)
        for name, r in d11.items():
            check_within(f"d11 {name} (feet pressed 1 mm)", r)
        for name, r in d11_settled.items():
            if not r["finite"] or r["median_du"] >= 1e-3:
                raise AssertionError(f"d11 {name} (settled): median per-env |du| too large: {r}")
        if not all(all(v) for v in same18.values()):
            raise AssertionError(f"d11: other outputs on the same inputs: {same18}")
        if linalg18["envs_over_bounds"] or not linalg18["finite"] or not linalg18["upper_zero"] \
                or not all(linalg18["nan_on_non_spd"].values()) \
                or not all(all(v.values()) for v in linalg18["same_bits"].values()):
            raise AssertionError(f"d11 linalg (n = 24): a kernel disagrees with its plain "
                                 f"version: {linalg18}")
        results.update({f"d11_{k}": v for k, v in d11.items()})
        linalg18_err = linalg18["max_abs_err"]

    # ---- 4. the main paths: every physics path, each with its kernels ----
    S = STEPS_PER_ITERATION
    D = env_cfg.control.decimation
    zero = {"kernel_launches": 0, "sampler_launches": 0, "factor_launches": 0,
            "apply_launches": 0, "solve_launches": 0}
    engine_pgs = {"use_pallas_substep": False}
    paths = [
        ("humanoid_ppo", "humanoid_ppo", None, ITERATIONS, {"kernel_launches": S}, ()),
        ("humanoid_ppo_terrain", "humanoid_ppo_terrain", None, ITERATIONS,
         {"kernel_launches": S, "sampler_launches": S}, ()),
        ("humanoid_ppo_penalty", "humanoid_ppo_penalty", None, ITERATIONS,
         {"kernel_launches": S}, ()),
        ("humanoid_ppo warm6", "humanoid_ppo", WARM6, ITERATIONS, {"kernel_launches": S}, ()),
        ("humanoid_ppo_robust", "humanoid_ppo_robust", None, ITERATIONS,
         {"kernel_launches": S}, ()),
        ("humanoid_ppo_envelope", "humanoid_ppo_envelope", None, ITERATIONS,
         {"kernel_launches": S}, ()),
        ("humanoid_ppo_trimesh", "humanoid_ppo_trimesh", None, 1,
         {"kernel_launches": S, "sampler_launches": S}, ()),
        ("humanoid_ppo_8k", "humanoid_ppo_8k", None, 1, {"kernel_launches": S}, ()),
        ("humanoid_ppo engine", "humanoid_ppo", engine_pgs, 1,
         {"factor_launches": S, "apply_launches": S * D}, ()),
        ("humanoid_ppo_terrain engine", "humanoid_ppo_terrain", engine_pgs, 1,
         {"sampler_launches": S, "factor_launches": S, "apply_launches": S * D}, ()),
        ("humanoid_ppo_penalty engine unfrozen", "humanoid_ppo_penalty",
         {"use_pallas_substep": False, "freeze_mass_matrix": False}, 1,
         {"solve_launches": S * D}, ()),
    ]
    # the 18-dof family: d11_ppo and d12_ppo (B1 with gains and body) on the
    # fused kernel, d11_ppo on penalty contact through --contact, and on the
    # engine path (B3 and B4 at n = 24)
    d11_paths = [
        ("d11_ppo", D11_TASK, None, ITERATIONS, {"kernel_launches": S}, ()),
        ("d12_ppo", "d12_ppo", None, ITERATIONS, {"kernel_launches": S}, ()),
        ("d11_ppo penalty", D11_TASK, None, 1, {"kernel_launches": S}, ("--contact", "penalty")),
        ("d11_ppo engine", D11_TASK, engine_pgs, 1,
         {"factor_launches": S, "apply_launches": S * D}, ()),
    ]
    launches, summaries = {}, {}
    todo = (paths if "train" in phases else []) + (d11_paths if "d11_train" in phases else [])
    for path, task, sim, iterations, nonzero, argv in todo:
        t_path = time.perf_counter()
        cfg, _ = registry.get_cfgs(task)
        n_envs = N * cfg.env.num_envs // 4096      # the task's count: humanoid_ppo_8k 2 N
        runner, carry, rows, peak = train_phase(train, registry, task, iterations,
                                                "train_iteration", log_root, sim, n_envs, argv)
        expect = {**zero, **nonzero}
        checks = check_training(path, runner, carry, rows, cfg, iterations, expect, n_envs)
        env_ = runner.env
        launches[path] = play.kernel_launches(env_)
        steady = rows[1:] if len(rows) > 1 else rows
        summaries[path] = {
            "task": task, "sim": sim or {}, "argv": list(argv), "envs": n_envs,
            "iterations": len(rows),
            "launches": launches[path],
            "warm_start": bool(env_.physics.pgs_params is not None
                               and env_.physics.pgs_params.warm_start),
            "launches_per_iteration": expect, "peak_bytes": peak,
            "wall_s": time.perf_counter() - t_path,
            "steady_env_steps_per_s": sum(r["env_steps_per_s"] for r in steady) / len(steady),
            "steady_rollout_s": sum(r["rollout_s"] for r in steady) / len(steady),
            "steady_update_s": sum(r["update_s"] for r in steady) / len(steady),
            "mean_terrain_level": float(carry.env_state.terrain_levels.float().mean()),
            **checks,
        }
        emit("train", path=path, **summaries[path])
        names = {"kernel_launches": "control_step_kernel",
                 "sampler_launches": "terrain_sampler_kernel",
                 "factor_launches": "chol_factor_kernel", "apply_launches": "chol_apply_kernel",
                 "solve_launches": "chol_solve_kernel"}
        if any(launches[path][names[k]] == 0 for k in nonzero):
            raise AssertionError(f"{path}: a kernel of the path was not launched: {launches}")
        del runner, carry, env_

    # ---- 4b. checkpoints, exact-state resume, export and play (B1 at 1, N envs) ----
    if "checkpoint" in phases:
        t_path = time.perf_counter()
        ckpt, ckpt_launches = checkpoint_phase(train, play, registry, probe, model, on_flat,
                                               log_root)
        launches.update(ckpt_launches)
        summaries["checkpoint"] = {"wall_s": time.perf_counter() - t_path}
        emit("checkpoint", envs=N, task="humanoid_ppo", launches=ckpt_launches,
             wall_s=summaries["checkpoint"]["wall_s"], **ckpt)

    # ---- 4c. the 18-dof policy exported and played: d11_ppo trained one
    # iteration, then `scripts.play.main` at 1 and at N envs ----
    if "d11_play" in phases:
        t_path = time.perf_counter()
        runs = os.path.join(log_root, "d11_play")
        trained, carry, rows, _ = train_phase(train, registry, D11_TASK, 1, "d11_play_train",
                                              runs, n_envs=N)
        check_training(D11_TASK, trained, carry, rows, registry.get_cfgs(D11_TASK)[0], 1,
                       {**zero, "kernel_launches": S}, N)
        played, play_launches, bf16_gap = play_and_check(play, D11_TASK, trained.net, runs,
                                                         log_root, 1)
        launches.update(play_launches)
        summaries["d11_play"] = {"wall_s": time.perf_counter() - t_path}
        emit("d11_play", task=D11_TASK, play=played, bf16_actor_max_abs_gap_vs_export=bf16_gap,
             wall_s=summaries["d11_play"]["wall_s"])
        del trained, carry

    # ---- 4d. a torch.profiler trace of one humanoid_ppo iteration through
    # `train --profile 1`: the device's busiest ops and its busy share of the
    # traced rollout ----
    if "profile" in phases:
        t_path = time.perf_counter()
        profiled, carry, rows, _ = train_phase(
            train, registry, "humanoid_ppo", 1 + PROFILED_ITERATIONS, "profile_train",
            os.path.join(log_root, "profile"), n_envs=N,
            argv=("--profile", str(PROFILED_ITERATIONS)))
        check_training("humanoid_ppo", profiled, carry, rows, env_cfg, 1 + PROFILED_ITERATIONS,
                       {**zero, "kernel_launches": S}, N)
        traces = glob.glob(os.path.join(profiled.log_dir, "*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile: expected one trace in {profiled.log_dir}: {traces}")
        prof = trace_summary(traces[0])
        summaries["profile"] = {"wall_s": time.perf_counter() - t_path}
        emit("profile", task="humanoid_ppo", envs=N, iterations_traced=PROFILED_ITERATIONS,
             trace_bytes=os.path.getsize(traces[0]),
             rollout_s_traced=rows[-1]["rollout_s"], rollout_s_untraced=rows[0]["rollout_s"],
             wall_s=summaries["profile"]["wall_s"], **prof)
        share = prof["device_busy_share_of_rollout"]
        if not prof["device_ops"] or share is None or not 0.0 < share <= 1.0:
            raise AssertionError(f"profile: the trace shows no device work in the rollout: {prof}")
        del profiled, carry

    # ---- 5. kernel times against their bounds ----
    timing = {}
    if "time" in phases:
        pack, masses, friction, targets = settled
        # shipping without sweeps: the sweeps' share of the shipping time
        no_sweeps = ControlStepKernel(model, *probe.gains, probe.contact_params,
                                      probe.pgs_params._replace(iterations=0), probe.dt)
        instances = {
            "exact": (probe, settled, (1, False, False), {}),
            "shipping": (probe, settled, (10, True, True), {}),
            "shipping_no_sweeps": (no_sweeps, settled, (10, True, True), {}),
            "extras": (probe, with_offsets(on_ramp), (10, True, True),
                       {"gains": gains, "body": body, "planes": planes}),
            "penalty": (pprobe, settled, (10, True, True), {}),
            "warm": (wprobe, settled, (10, True, True), {}),
            # nj = 18: shipping, with the gains and body that d12_ppo feeds, penalty
            "d11_shipping": (probe18, settled18, (10, True, True), {}),
            "d11_gains_body": (probe18, settled18[:3] + ((settled18[3] + offsets18).contiguous(),),
                               (10, True, True), {"gains": gains18, "body": body18}),
            "d11_penalty": (pprobe18, settled18, (10, True, True), {}),
        }
        for name, (k, inputs, args, kw) in instances.items():
            def run_kernel():
                k(*inputs, *args, **kw)

            def run_plain():
                k.plain(*inputs, *args, **kw)

            for _ in range(3):
                run_kernel()
            eager_ms = cuda_ms(run_kernel, TIMED_LAUNCHES)
            ms = graph_ms(run_kernel, TIMED_LAUNCHES)
            run_plain()
            plain_ms = cuda_ms(run_plain, 3)
            flags = {f: f in kw for f in ("gains", "body", "planes")}
            pgs = k.pgs_params is not None
            ops = operations_per_env(k.model, args[0], args[1], args[2],
                                     k.pgs_params.iterations if pgs else 0, pgs=pgs, **flags) * N
            timing[name] = {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                            "nj": k.model.nj, "design": k.design(),
                            "ptxas": ptxas.get(k.kernel_name()),
                            **bound(ops, launch_bytes(k.model, N, **flags))}
            emit(f"{name}_time", launches_timed=TIMED_LAUNCHES, **timing[name])
        # the warm and the shipping instance in turns (shipping, warm, warm,
        # shipping): does the carry cost time?
        turns = []
        for name in ("shipping", "warm", "warm", "shipping"):
            k, inputs, args, _ = instances[name]
            turns.append([name, cuda_ms(lambda: k(*inputs, *args), TIMED_LAUNCHES)])
        emit("warm_vs_shipping_time", launches_timed=TIMED_LAUNCHES, turns=turns)

    if "time" in phases and "sampler" in phases:
        def run_sampler():
            sprobe(scan_xy, con_xy)

        def run_sampler_plain():
            sample_plain(sprobe.raster, sprobe.vs, sprobe.hs, sprobe.border, scan_xy, con_xy)

        for _ in range(3):
            run_sampler()
        s_eager_ms = cuda_ms(run_sampler, TIMED_SAMPLES)
        s_ms = graph_ms(run_sampler, TIMED_SAMPLES)
        run_sampler_plain()
        s_plain_ms = cuda_ms(run_sampler_plain, 10)
        n_scan, n_con = scan_xy.shape[0] * scan_xy.shape[1], con_xy.shape[0] * con_xy.shape[1]
        cells = touched_cells(sprobe.raster, sprobe.hs, sprobe.border, scan_xy, con_xy)
        timing["sampler"] = {"ms": s_ms, "eager_ms": s_eager_ms, "plain_ms": s_plain_ms,
                             "raster_cells_read": cells,
                             **bound(SAMPLER_OPS_PER_SCAN * n_scan
                                     + SAMPLER_OPS_PER_CONTACT * n_con,
                                     sample_bytes(n_scan, n_con, cells))}
        emit("sampler_time", launches_timed=TIMED_SAMPLES, **timing["sampler"])

    def time_linalg(chol, M, b, names, suffix=""):
        """B3-B5 (those in `names`) on M, b beside their plain versions and
        the library calls (timed here only; the port never calls them)."""
        n = M.shape[-1]
        L = linalg.chol_factor_unrolled(M)
        calls = {
            "chol_factor": (lambda: chol.factor_spd_batch(M),
                            lambda: linalg.chol_factor_unrolled(M),
                            lambda: torch.linalg.cholesky_ex(M), "torch.linalg.cholesky_ex"),
            "chol_apply": (lambda: chol.apply_spd_batch(L, b),
                           lambda: linalg.chol_apply_unrolled(L, b),
                           lambda: torch.cholesky_solve(b[..., None], L),
                           "torch.cholesky_solve"),
            "chol_solve": (lambda: chol.solve_spd_batch(M, b),
                           lambda: linalg.chol_solve_unrolled(M, b),
                           lambda: torch.cholesky_solve(b[..., None],
                                                        torch.linalg.cholesky_ex(M).L),
                           "torch.linalg.cholesky_ex then torch.cholesky_solve"),
        }
        for name in names:
            run_k, run_p, run_lib, lib_name = calls[name]
            for fn in (run_k, run_p, run_lib):
                fn()
            timing[name + suffix] = {
                "ms": graph_ms(run_k, TIMED_LINALG), "eager_ms": cuda_ms(run_k, TIMED_LINALG),
                "plain_ms": cuda_ms(run_p, 10), "library_ms": cuda_ms(run_lib, TIMED_LINALG),
                "library": lib_name, "n": n, "design": chol.design(name),
                "ptxas": ptxas.get(f"{name}_kernel"),
                **bound(linalg.operations_per_env(name, n) * N, linalg.bytes_per_env(name, n) * N)}
            emit(f"{name}{suffix}_time", launches_timed=TIMED_LINALG, **timing[name + suffix])

    if "time" in phases and "linalg" in phases:
        # on the settled 12-dof robots' mass matrices (n = 18)
        time_linalg(lprobe, crba_M, crba_b, ("chol_factor", "chol_apply", "chol_solve"))
    if "time" in phases:
        # B3 and B4 at n = 24, on the settled 18-dof robots' mass matrices
        time_linalg(lprobe18, crba_M18, crba_b18, ("chol_factor", "chol_apply"), "_n24")
    emit("memory", max_memory_allocated=torch.cuda.max_memory_allocated())
    emit("paths_wall_s", **{p: v["wall_s"] for p, v in summaries.items()},
         script_s=time.perf_counter() - t_start)

    # ---- 6. the table (when every phase ran) and the last line ----
    print(smi, flush=True)
    if set(PHASES) <= phases:
        print(json.dumps(kernel_table(results, timing, launches, sampler_err, linalg_err,
                                      linalg18_err, sweeps, n=model.nv, design={
                                          "pgs": probe.design(), "penalty": pprobe.design()})),
              flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


def is_18dof(path):
    """Whether a path of the launch counts runs the 18-dof robot."""
    return path.startswith(("d11", "d12", "play d11"))


def kernel_table(results, timing, launches, sampler_err, linalg_err, linalg18_err, sweeps, n,
                 design):
    """The kernels line: one row per kernel on the 12-dof robot, the control
    step's instances inside its row, then the rows of the kernels at the
    18-dof robot's widths (nj = 18, n = 24), with the launches of its paths."""
    def row(name, result, t, **more):
        return {"max_abs_err": result, "ms": t["ms"], "eager_ms": t["eager_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"), "instance": name, **more}

    def by_path(kernel, paths18=False):
        return {p: v[kernel] for p, v in launches.items() if is_18dof(p) == paths18}

    def rows18(name, source, replaces, kernel, paths, result, t, instance):
        per_path = {p: c for p, c in by_path(kernel, True).items() if p in paths}
        return {"name": name, "route": "cuda", "source": f"humanoid_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(per_path.values()),
                "launches_by_path": per_path, **row(instance, result, t)}

    shipping18 = ("d11_ppo", "play d11_ppo 1 env", f"play d11_ppo {N} envs")
    d11_rows = [
        rows18("control_step_kernel[nj=18]", "control_step.cu",
               "humanoid_tpu/ops/physics_kernel.py:841", "control_step_kernel", shipping18,
               results["d11_shipping"]["max_abs_err"], timing["d11_shipping"],
               f"nj=18 decimation=10 freeze=1 freeze_prep=1 sweeps={sweeps}"),
        rows18("control_step_kernel[nj=18, gains body]", "control_step.cu",
               "humanoid_tpu/ops/physics_kernel.py:841", "control_step_kernel", ("d12_ppo",),
               results["d11_gains_body"]["max_abs_err"], timing["d11_gains_body"],
               f"nj=18 decimation=10 freeze=1 freeze_prep=1 sweeps={sweeps} gains body"),
        rows18("control_step_kernel[nj=18, penalty]", "control_step.cu",
               "humanoid_tpu/ops/physics_kernel.py:719", "control_step_kernel",
               ("d11_ppo penalty",), results["d11_penalty"]["max_abs_err"],
               timing["d11_penalty"], "nj=18 pgs=0 decimation=10 freeze=1"),
        rows18("chol_factor_kernel[n=24]", "linalg.cu", "humanoid_tpu/ops/linalg.py:144",
               "chol_factor_kernel", ("d11_ppo engine",), linalg18_err["factor"],
               timing["chol_factor_n24"], f"n=24, {N} envs"),
        rows18("chol_apply_kernel[n=24]", "linalg.cu", "humanoid_tpu/ops/linalg.py:165",
               "chol_apply_kernel", ("d11_ppo engine",), linalg18_err["apply"],
               timing["chol_apply_n24"], f"n=24, {N} envs"),
    ]

    cs_launches = by_path("control_step_kernel")
    linalg_rows = [
        {"name": f"{name}_kernel", "route": "cuda", "source": "humanoid_tpu_torch/csrc/linalg.cu",
         "replaces": f"humanoid_tpu/ops/linalg.py:{line}",
         "launches": sum(by_path(f"{name}_kernel").values()),
         "launches_by_path": by_path(f"{name}_kernel"),
         **row(f"n={n}, {N} envs", linalg_err[key], timing[name],
               library=timing[name]["library"], design=timing[name]["design"])}
        for name, key, line in (("chol_factor", "factor", 144), ("chol_apply", "apply", 165),
                                ("chol_solve", "solve", 108))]
    return {"kernels": [
        {
            "name": "control_step_kernel", "route": "cuda",
            "source": "humanoid_tpu_torch/csrc/control_step.cu",
            "replaces": "humanoid_tpu/ops/physics_kernel.py:841",
            "launches": sum(cs_launches.values()), "launches_by_path": cs_launches,
            "design": design,
            **row(f"decimation=10 freeze=1 freeze_prep=1 sweeps={sweeps}",
                  results["shipping"]["max_abs_err"], timing["shipping"]),
            "exact_instance": row(f"decimation=1 freeze=0 freeze_prep=0 sweeps={sweeps}",
                                  results["exact"]["max_abs_err"], timing["exact"],
                                  replaces="humanoid_tpu/ops/physics_kernel.py:808"),
            "extras_instance": row(
                f"decimation=10 freeze=1 freeze_prep=1 sweeps={sweeps} gains body planes",
                results["extras"]["max_abs_err"], timing["extras"],
                launches=cs_launches["humanoid_ppo_terrain"]),
            "penalty_instance": row(
                "pgs=0 decimation=10 freeze=1", results["penalty"]["max_abs_err"],
                timing["penalty"], launches=cs_launches["humanoid_ppo_penalty"],
                replaces="humanoid_tpu/ops/physics_kernel.py:719"),
            "warm_instance": row(
                f"decimation=10 freeze=1 freeze_prep=1 sweeps={sweeps} warm=1",
                results["warm"]["max_abs_err"], timing["warm"],
                launches=cs_launches["humanoid_ppo warm6"],
                replaces="humanoid_tpu/ops/physics_kernel.py:891"),
        },
        {
            "name": "terrain_sampler_kernel", "route": "cuda",
            "source": "humanoid_tpu_torch/csrc/terrain_sampler.cu",
            "replaces": "humanoid_tpu/ops/terrain_kernel.py:114",
            "launches": sum(by_path("terrain_sampler_kernel").values()),
            "launches_by_path": by_path("terrain_sampler_kernel"),
            **row("187 scan + 9 contact points per env", sampler_err, timing["sampler"]),
        },
        *linalg_rows,
        *d11_rows,
    ]}


if __name__ == "__main__":
    main()
