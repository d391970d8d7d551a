"""The port stands alone: importing humanoid_tpu_torch, every one of its
modules and chip_smoke.py loads nothing of JAX, flax, MuJoCo or the
reference package. Checked in a fresh interpreter in which those packages
cannot be imported at all."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "mujoco", "onnx", "wandb", "tensorboard"):
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
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


def test_port_and_chip_smoke_import_nothing_of_jax_or_the_reference():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20, proc.stdout


def test_port_sources_never_name_the_reference_assets():
    """Nothing in the port reads the reference package's asset directory
    (reference/resources, redirected by HUMANOID_TPU_ASSETS)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "humanoid_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith((".py", ".cu"))]
    for path in paths:
        with open(path) as f:
            text = f.read()
        assert "reference/resources" not in text and "HUMANOID_TPU_ASSETS" not in text, path
