#!/usr/bin/env python3
"""Variants of csrc/linalg.cu built side by side and timed in turns on one
NVIDIA card: the envs-per-block sweep of B3 (the factor) and B4 (the
apply), and an ablation of B4's parts.

    python3 humanoid_tpu_torch/scripts/linalg_variants.py

Each variant is the source with one text edit (which must apply), built
by nvcc with the package's flags into humanoid_tpu_torch/_build/variants/,
all builds started together. Each is run once on chip_smoke.py's inputs
(4096 robots settled on the flat plane, their mass matrices, n = 18) and
held against the plain versions (`max_rel_err`: per env, relative to the
env's largest entry; the ablations do not compute the apply, so theirs is
large by design), and its apply's bits are compared with the source as it
is. Then the factor, apply and solve of every variant are timed under a
CUDA graph (chip_smoke.graph_ms), in order and then in reverse order.
Prints one JSON line per variant and per reading, then the card's name and
power limit.

The variants:
  source                 csrc/linalg.cu as it is
  factor_envs=E          B3 with E envs per block (E = 4, 8, 16)
  apply_envs=E           B4 with E envs per block
  apply_launch_only      B4 returns at once: the launch alone
  apply_staging_only     B4 stages its block's factors, then returns
  apply_no_sweeps        B4 without the sweeps (rows, b and x only)
  apply_forward_shared   B4's forward sweep reads L from shared memory
                         instead of the lane's registers (B5 too)
  apply_columns          B4 prefetches each lane's column of L into
                         registers for the backward sweep
  stepped_staging        one index division per float4 in the staging,
                         the next three entries stepped (all three kernels)
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMED = 200

APPLY_HEAD = ("  __shared__ float S[APPLY_ENVS * STAGE_STRIDE];\n"
              "  const int first = blockIdx.x * APPLY_ENVS;\n")
APPLY_STAGED = ("  stage_lower(L + static_cast<long long>(first) * n * n, S, envs, n);\n"
                "  __syncthreads();\n")
APPLY_SWEEPS = ("  load_vec<L>(b, y, n, lane);\n"
                "  sweeps_lanes<L, P>(S, a, iv, y, n, lane);\n"
                "  store_vec<L>(x, y, n, lane);\n}\n\n// B3")
APPLY_ROWS = ("  float a[ROWS(L)][MAX_N], y[ROWS(L)], iv[ROWS(L)];\n"
              "  load_rows<L, P>(S, a, n, lane);\n#pragma unroll\n"
              "  for (int r = 0; r < ROWS(L); ++r) {\n    const int i = lane + r * L;\n"
              "    iv[r] = i < n ? 1.0f / S[i * P + i] : 0.0f;")
FORWARD = "else if (i > j && i < n) y[r] -= a[r][j] * xj;"
BACKWARD = "else if (i < j) y[r] -= S[j * P + i] * xj;"
SWEEPS_HEAD = ("template <int L, int P>\n"
               "HDI void sweeps_lanes(const float* S, const float (&a)[ROWS(L)][MAX_N],\n"
               "                      const float (&iv)[ROWS(L)], float (&y)[ROWS(L)], int n, "
               "int lane) {\n")
COLUMNS = """  float c[ROWS(L)][MAX_N];
  if (COLS) {
#pragma unroll
    for (int r = 0; r < ROWS(L); ++r) {
      const int i = lane + r * L;
#pragma unroll
      for (int j = 0; j < MAX_N; ++j) c[r][j] = j > i && j < n ? S[j * P + i] : 0.0f;
    }
  }
"""
STAGE4 = """      put(4 * q, v.x);
      put(4 * q + 1, v.y);
      put(4 * q + 2, v.z);
      put(4 * q + 3, v.w);
"""
STEPPED = """      Entry t = entry_of(4 * q, n, nn, inv_n, inv_nn);
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (t.j <= t.i) S[t.e * STAGE_STRIDE + t.i * STAGE_P + t.j] = vs[c];
        if (++t.j == n) { t.j = 0; if (++t.i == n) { t.i = 0; ++t.e; } }
      }
"""


def edit(src, *pairs):
    """src with each (old, new) replaced; every old must occur exactly once."""
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"linalg.cu has changed: {old[:60]!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def envs_edit(src, name, envs):
    line = re.search(rf"constexpr int {name} = \d+;", src).group(0)
    return edit(src, (line, f"constexpr int {name} = {envs};"))


def variants(src):
    out = {"source": src}
    for e in (4, 8, 16):
        out[f"factor_envs={e}"] = envs_edit(src, "FACTOR_ENVS", e)
        out[f"apply_envs={e}"] = envs_edit(src, "APPLY_ENVS", e)
    out["apply_launch_only"] = edit(src, (APPLY_HEAD, "  if (n > 0) return;\n" + APPLY_HEAD))
    # a read of S that the compiler cannot drop keeps the staging's stores
    out["apply_staging_only"] = edit(src, (APPLY_STAGED, APPLY_STAGED
                                           + "  if (S[threadIdx.x] == 1234.5f) x[threadIdx.x] = 0.0f;\n"
                                           "  return;\n"))
    out["apply_no_sweeps"] = edit(src, (APPLY_SWEEPS, APPLY_SWEEPS.replace(
        "  sweeps_lanes<L, P>(S, a, iv, y, n, lane);\n",
        "#pragma unroll\n  for (int k = 0; k < MAX_N; ++k) y[0] += a[0][k] * iv[0];\n")))
    out["apply_forward_shared"] = edit(
        src, (FORWARD, "else if (i > j && i < n) y[r] -= S[i * P + j] * xj;"),
        (APPLY_ROWS, APPLY_ROWS.replace("  load_rows<L, P>(S, a, n, lane);\n", "")))
    out["apply_columns"] = edit(
        src, (SWEEPS_HEAD, SWEEPS_HEAD.replace("template <int L, int P>",
                                               "template <int L, int P, bool COLS = false>")
              + COLUMNS),
        (BACKWARD, "else if (i < j) y[r] -= (COLS ? c[r][j] : S[j * P + i]) * xj;"),
        (APPLY_SWEEPS, APPLY_SWEEPS.replace("sweeps_lanes<L, P>(", "sweeps_lanes<L, P, true>(")))
    out["stepped_staging"] = edit(src, (STAGE4, STEPPED))
    return out


def main():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from humanoid_tpu_torch.ops import linalg
    from humanoid_tpu_torch.ops.build import (BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc,
                                              ptxas_summary)
    from humanoid_tpu_torch.ops.physics_kernel import ControlStepKernel
    from humanoid_tpu_torch.utils import registry

    if not torch.cuda.is_available():
        raise SystemExit("linalg_variants.py needs a CUDA device")
    with open(os.path.join(CSRC_DIR, "linalg.cu")) as f:
        sources = variants(f.read())
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        stem = os.path.join(out_dir, "linalg_" + re.sub(r"\W", "_", name))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), stem + ".so")
    env_cfg, _ = registry.get_cfgs("humanoid_ppo")
    env, _, _ = registry.make_env("humanoid_ppo", device=cs.DEVICE)
    k = env.physics
    probe = ControlStepKernel(env.model, *k.gains, k.contact_params, k.pgs_params, k.dt)
    settled = cs.settle(probe, env.model, np.asarray(env_cfg.init_state.default_joint_angles))
    M, b = cs.mass_matrices(env.model, settled)
    N, n = M.shape[0], M.shape[-1]
    Lp = linalg.chol_factor_unrolled(M)
    plain = {"factor": Lp, "apply": linalg.chol_apply_unrolled(Lp, b),
             "solve": linalg.chol_solve_unrolled(M, b)}

    def rel(y, p):
        dims = tuple(range(1, y.dim()))
        return float(((y - p).abs().amax(dims) / p.abs().amax(dims)).max())

    calls, apply_bits = {}, {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, n_ptr in ((lib.chol_factor_launch, 2), (lib.chol_apply_launch, 3),
                          (lib.chol_solve_launch, 3)):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        outs = {"factor": torch.zeros_like(M), "apply": torch.zeros_like(b),
                "solve": torch.zeros_like(b)}

        def launch(err):
            if err != 0:
                raise RuntimeError(f"variant {name}: launch failed, cudaError {err}")

        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        run = {
            "factor": lambda lib=lib, o=outs: launch(lib.chol_factor_launch(
                M.data_ptr(), o["factor"].data_ptr(), N, n, stream())),
            "apply": lambda lib=lib, o=outs: launch(lib.chol_apply_launch(
                Lp.data_ptr(), b.data_ptr(), o["apply"].data_ptr(), N, n, stream())),
            "solve": lambda lib=lib, o=outs: launch(lib.chol_solve_launch(
                M.data_ptr(), b.data_ptr(), o["solve"].data_ptr(), N, n, stream())),
        }
        for fn in run.values():
            fn()
        torch.cuda.synchronize()
        apply_bits[name] = outs["apply"].clone()
        summary = ptxas_summary(log.splitlines())
        cs.emit("variant", name=name, envs=N, n=n,
                max_rel_err={key: rel(outs[key], plain[key]) for key in outs},
                apply_bits_equal_source=bool(torch.equal(
                    apply_bits[name].view(torch.int32), apply_bits["source"].view(torch.int32))),
                ptxas={kernel: summary.get(kernel) for kernel in
                       ("chol_factor_kernel", "chol_apply_kernel", "chol_solve_kernel")})
        calls[name] = run
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            cs.emit("variant_time", name=name, launches_timed=TIMED,
                    graph_ms={key: cs.graph_ms(fn, TIMED) for key, fn in calls[name].items()})
    print(json.dumps({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}), flush=True)


if __name__ == "__main__":
    main()
