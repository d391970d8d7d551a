"""Card-only tests of the port: the CUDA control-step kernel against its
plain PyTorch version, and one env step through each. They import nothing
of JAX, so that they run on a machine with the card:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device they skip. Bounds are the reference package's
kernel-vs-XLA bounds (|du| < 1e-2, |base_pos| < 1e-5, foot forces within 1%
of body weight) on robots whose soles are pressed 1 mm into the ground, so
that every contact is active in both versions (see test_torch_control_step).
"""
import numpy as np
import pytest
import torch

from humanoid_tpu_torch.ops.physics_kernel import ControlStepKernel, pack_state
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.utils import registry

N = 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _loaded_feet(kernel, model, device):
    rng = np.random.default_rng(0)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device).contiguous()

    qj = rng.uniform(-0.05, 0.05, (N, model.nj))
    masses = np.tile(model.mass, (N, 1))
    masses[:, 0] += rng.uniform(-5.0, 5.0, N)
    phys = PhysState(t(np.c_[np.zeros((N, 2)), np.full(N, 0.90)]),
                     t(np.tile([1.0, 0.0, 0.0, 0.0], (N, 1))), t(qj),
                     torch.zeros(N, model.nv, device=device))
    pack, m, f, tg = pack_state(phys), t(masses), t(rng.uniform(0.1, 2.0, N)), t(qj)
    for _ in range(30):
        pack, _ = kernel.plain(pack, m, f, tg, 10, True, True)
    pack = pack.clone()
    pack[2] -= 1e-3
    return pack, m, f, tg


@pytest.mark.cuda
@pytest.mark.parametrize("instance", [(1, False, False), (10, True, True), (10, True, False)])
def test_cuda_kernel_matches_plain(cuda_device, instance):
    env, _, _ = registry.make_env("humanoid_ppo", device=cuda_device)
    k = ControlStepKernel(env.model, *env.physics.gains, env.physics.contact_params,
                          env.physics.pgs_params, env.physics.dt)
    inputs = _loaded_feet(k, env.model, cuda_device)
    a, da = k(*inputs, *instance)
    b, db = k.plain(*inputs, *instance)
    torch.cuda.synchronize()
    assert k.launches == 1
    weight = env.model.total_mass * 9.81
    assert float((a[19:] - b[19:]).abs().max()) < 1e-2
    assert float((a[0:3] - b[0:3]).abs().max()) < 1e-5
    assert float((da.foot_forces - db.foot_forces).abs().max()) < 0.01 * weight
    for x, y in zip(da, db):
        assert x.shape == y.shape and bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_cuda_wrapper_checks_inputs(cuda_device):
    env, _, _ = registry.make_env("humanoid_ppo", device=cuda_device)
    k = env.physics
    pack = torch.zeros(37, 64, device=cuda_device)
    masses = torch.zeros(64, 13, device=cuda_device)
    fric = torch.zeros(64, device=cuda_device)
    tg = torch.zeros(64, 12, device=cuda_device)
    with pytest.raises(ValueError):
        k(pack.double(), masses, fric, tg, 10)
    with pytest.raises(ValueError):
        k(pack, masses.T, fric, tg, 10)
    with pytest.raises(ValueError):
        k(pack, masses, fric, tg[:, :6], 10)
    assert k.launches == 0
