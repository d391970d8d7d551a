"""The port stands alone: importing humanoid_tpu_torch, every one of its
modules and chip_smoke.py loads nothing of JAX, flax, MuJoCo or the
reference package, and neither does a rank of a data-parallel run. Checked
in fresh interpreters in which those packages cannot be imported at all."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "mujoco", "onnx", "wandb", "tensorboard", "cv2",
             "PIL", "pygame"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import humanoid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(humanoid_tpu_torch.__path__, "humanoid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if (m == "humanoid_tpu" or m.startswith("humanoid_tpu."))
                or (m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mujoco")
                    and sys.modules[m] is not None))
print(len(names), "modules")
print("MODULES", " ".join(names))
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


# the modules of the 18-dof, the data-parallel and the deploy slices, walked
# and imported like every other one (the deploy side imports mujoco, cv2,
# PIL, pygame and wandb inside the functions that use them)
NEW_MODULES = ("assets", "utils.profiling", "env.vec_env", "utils.calculate_gait",
               "physics.mjcf_export", "parallel.dist", "parallel.mesh", "parallel.rank_view",
               "scripts.sweep", "scripts.bench_scaling",
               "native", "native.build", "native.terrain_native", "native.policy_native",
               "deploy.sim2sim", "deploy.gate_matrix", "deploy.eval_gate",
               "deploy.terrain_oracle", "deploy.video", "scripts.joystick", "scripts.view")

# a rank of `train --mesh` (2 gloo ranks, 16 envs, one iteration of 4
# steps), with the same packages made unimportable
RANK = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "mujoco", "onnx", "wandb", "tensorboard"):
    sys.modules[name] = None
import dataclasses
import torch
torch.set_num_threads(1)
from humanoid_tpu_torch.scripts import train
from humanoid_tpu_torch.utils import registry
task_cfgs = registry.get_cfgs

def get_cfgs(name):
    env_cfg, train_cfg = task_cfgs(name)
    return env_cfg, train_cfg.replace(runner=dataclasses.replace(train_cfg.runner,
                                                                 num_steps_per_env=4))

registry.get_cfgs = get_cfgs
train.main(["--mesh", "--device", "cpu", "--num-envs", "16", "--max-iterations", "1",
            "--log-root", sys.argv[1]], log_fn=lambda *a: None)
print("LEAKED", sorted(m for m in sys.modules
                       if (m == "humanoid_tpu" or m.startswith("humanoid_tpu."))
                       or (m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mujoco")
                           and sys.modules[m] is not None)))
"""


def test_port_and_chip_smoke_import_nothing_of_jax_or_the_reference():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20, proc.stdout
    walked = set(proc.stdout.split("MODULES", 1)[1].split("\n", 1)[0].split())
    assert {f"humanoid_tpu_torch.{m}" for m in NEW_MODULES} <= walked, proc.stdout


def test_port_sources_never_name_the_reference_assets():
    """Nothing in the port names the reference package's asset directory
    (reference/resources). The asset root, which HUMANOID_TPU_ASSETS
    redirects, is read in assets.py alone (the shipped MJCFs that the
    sim2sim gate can replay on), and defaults to the repository's own
    resources/."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "humanoid_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith((".py", ".cu", ".cpp"))]
    readers = []
    for path in paths:
        with open(path) as f:
            text = f.read()
        assert "reference/resources" not in text, path
        if "HUMANOID_TPU_ASSETS" in text:
            readers.append(os.path.relpath(path, REPO))
    assert readers == [os.path.join("humanoid_tpu_torch", "assets.py")]
    from humanoid_tpu_torch import assets

    root = assets.asset_root()
    assert os.environ.get("HUMANOID_TPU_ASSETS") or root == os.path.join(REPO, "resources")


def test_a_spawned_rank_imports_nothing_of_jax_or_the_reference(tmp_path):
    from humanoid_tpu_torch.parallel import dist

    logs = dist.launch(2, ["-c", RANK, str(tmp_path / "runs")], timeout=120,
                       log_dir=str(tmp_path / "logs"))
    for r in range(2):
        with open(os.path.join(logs, f"rank{r}.log")) as f:
            assert "LEAKED []" in f.read()
