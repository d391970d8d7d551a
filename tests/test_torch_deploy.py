"""Policy export, the numpy readers, the eval log and `play` of the port,
against the reference package's deploy/export.py, npz_policy.py and
onnx_loader.py.

Weights come from flax param trees through `from_jax_params`. Stated
tolerances: the .npz arrays and the ONNX initializers equal the
reference's in bits; every reader of the exported files (the reference's
NpzPolicy and load_onnx_mlp, the port's copies, the TorchScript pair)
within 1e-5 of the reference's act_mean / estimate_vel; play's policy.npz
within 1e-5 of the runner's actor run in float32.
"""
import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_tpu.algo import networks as jnet
from humanoid_tpu.deploy import export as jexport
from humanoid_tpu.deploy import onnx_loader as jonnx
from humanoid_tpu.deploy.npz_policy import NpzPolicy as RefNpzPolicy
from humanoid_tpu_torch.algo import networks as tnet
from humanoid_tpu_torch.deploy import export, onnx_loader
from humanoid_tpu_torch.deploy.npz_policy import NpzPolicy
from humanoid_tpu_torch.utils.eval_logger import EvalLogger

OBS, PRIV, ACT = 705, 219, 12
TOL = 1e-5


def _flax(seed):
    jn = jnet.ActorCritic(num_actions=ACT, compute_dtype="float32")
    params = jnet.init_params(jax.random.PRNGKey(seed), jn, OBS, PRIV)
    params["params"]["std"] = jnp.linspace(0.5, 1.5, ACT)
    params = jax.tree.map(np.asarray, params)
    return jn, params, tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT), params)


def _obs(seed, n=32):
    return np.random.default_rng(seed).normal(size=(n, OBS)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_npz_export_equals_the_reference_in_bits(tmp_path, seed):
    _, params, net = _flax(seed)
    meta = {"iteration": 3001, "task": "humanoid_ppo"}
    jexport.export_policy_npz(params, str(tmp_path / "ref.npz"), meta=meta)
    export.export_policy_npz(net, str(tmp_path / "port.npz"), meta=meta)
    with np.load(tmp_path / "ref.npz") as ref, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            assert got[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 1])
def test_readers_of_the_port_export_match_the_reference_actor(tmp_path, seed):
    """The reference's NpzPolicy (actor and velocity head) and
    load_onnx_mlp, and the port's TorchScript pair, on the port's files,
    against the reference's act_mean and estimate_vel."""
    jn, params, net = _flax(seed)
    obs = _obs(seed)
    want_act = np.asarray(jn.apply(params, obs, method="act_mean"))
    want_vel = np.asarray(jn.apply(params, obs, method="estimate_vel"))
    npz = export.export_policy_npz(net, str(tmp_path / "policy.npz"))
    onnx = export.export_policy_onnx(net, str(tmp_path / "policy.onnx"), OBS)
    ts = export.export_policy_torchscript(net, str(tmp_path))
    assert sorted(ts) == ["base_lin_vel.pt", "policy_1.pt"]
    np.testing.assert_allclose(RefNpzPolicy(npz)(obs), want_act, atol=TOL)
    np.testing.assert_allclose(RefNpzPolicy(npz, prefix="vel")(obs), want_vel, atol=TOL)
    np.testing.assert_allclose(jonnx.load_onnx_mlp(onnx)(obs), want_act, atol=TOL)
    with torch.no_grad():
        act = torch.jit.load(ts["policy_1.pt"])(torch.as_tensor(obs)).numpy()
        vel = torch.jit.load(ts["base_lin_vel.pt"])(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(act, want_act, atol=TOL)
    np.testing.assert_allclose(vel, want_vel, atol=TOL)


def test_onnx_graph_parses_to_the_reference_graph(tmp_path):
    """The same initializers (in bits) and the same nodes, op by op."""
    _, params, net = _flax(2)
    jexport.export_policy_onnx(params, str(tmp_path / "ref.onnx"), OBS)
    export.export_policy_onnx(net, str(tmp_path / "port.onnx"), OBS)
    init, nodes = onnx_loader.parse_graph(str(tmp_path / "port.onnx"))
    ref_init, ref_nodes = onnx_loader.parse_graph(str(tmp_path / "ref.onnx"))
    assert sorted(init) == sorted(ref_init) and nodes == ref_nodes
    for name, arr in ref_init.items():
        assert init[name].shape == arr.shape and np.array_equal(init[name], arr), name
    assert [n[0] for n in nodes] == ["Gemm", "Elu"] * 3 + ["Gemm"]
    assert all(n[3] == {"transB": 1} for n in nodes if n[0] == "Gemm")


def test_port_readers_match_the_reference_readers(tmp_path):
    """The port's numpy NpzPolicy and load_onnx_mlp against the reference's
    on the reference's own files (and the committed-layout velocity head)."""
    _, params, _ = _flax(3)
    npz = jexport.export_policy_npz(params, str(tmp_path / "ref.npz"))
    onnx = jexport.export_policy_onnx(params, str(tmp_path / "ref.onnx"), OBS)
    obs = _obs(3)
    for prefix in ("actor", "vel"):
        np.testing.assert_array_equal(NpzPolicy(npz, prefix)(obs), RefNpzPolicy(npz, prefix)(obs))
    got, want = onnx_loader.load_onnx_mlp(onnx), jonnx.load_onnx_mlp(onnx)
    np.testing.assert_array_equal(got(obs), want(obs))
    assert len(got.layers) == 4 and got.layers[0][0].shape == (OBS, 512)
    with pytest.raises(ValueError, match="no 'critic' layers"):
        NpzPolicy(npz, "critic")


def test_eval_logger_writes_traces_and_skips_the_plot_without_matplotlib(tmp_path, monkeypatch,
                                                                        capsys):
    log = EvalLogger(0.01)
    for i in range(5):
        log.log_states({"base_height": 0.9 + 0.01 * i, "dof_pos": float(i)})
    log.log_rewards({"rew_a": 2.0, "other": 1.0}, 2)
    log.print_rewards()
    assert "rew_a: 2.0000" in capsys.readouterr().out
    path = log.save_states(str(tmp_path / "eval_states.npz"))
    with np.load(path) as z:
        np.testing.assert_allclose(z["base_height"], 0.9 + 0.01 * np.arange(5), rtol=1e-6)
        assert float(z["dt"]) == 0.01
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert log.plot_states(str(tmp_path / "eval.png")) is None
    assert "matplotlib does not import" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "eval.png")


@pytest.fixture(scope="module")
def run_root(tmp_path_factory):
    """A run of humanoid_ppo with one checkpoint whose parameters are not
    the init (so the export is held to trained-looking weights)."""
    from humanoid_tpu_torch.algo.runner import OnPolicyRunner
    from humanoid_tpu_torch.utils import registry

    env_cfg, train_cfg = registry.get_cfgs("humanoid_ppo")
    env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=2))
    root = tmp_path_factory.mktemp("logs")
    runner = registry.make_alg_runner(
        registry.build_env(env_cfg, registry.default_urdf(), "cpu"), train_cfg,
        log_root=str(root))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in runner.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    runner.iteration = 12
    runner.save()
    assert isinstance(runner, OnPolicyRunner)
    return root, runner


def test_play_writes_its_files_and_its_npz_reproduces_the_actor(run_root, tmp_path):
    from humanoid_tpu_torch.scripts import play

    root, runner = run_root
    out = play.main(["--device", "cpu", "--num-envs", "2", "--steps", "5",
                     "--log-root", str(root), "--out-dir", str(tmp_path)])
    files = ["policy.npz", "policy_1.pt", "base_lin_vel.pt", "policy.onnx",
             "openloop_action.npz", "eval_states.npz"]
    assert all(os.path.isfile(tmp_path / f) for f in files)
    assert out["npz"] == str(tmp_path / "policy.npz") and out["finite"]
    assert out["kernel_launches"] == 0 and out["steps"] == 5     # plain on the CPU
    assert np.isfinite(out["final_z"]) and 0.3 < out["final_z"] < 1.5
    with np.load(tmp_path / "openloop_action.npz") as z:
        assert z["action"].shape == (5, ACT)
    with np.load(tmp_path / "eval_states.npz") as z:
        assert z["base_height"].shape == (5,) and z["command_x"][0] == pytest.approx(0.5)
    with np.load(tmp_path / "policy.npz") as z:
        assert int(z["meta_iteration"]) == 12
    f32 = copy.deepcopy(runner.net)
    f32.compute_dtype = torch.float32
    obs = _obs(5, 64)
    with torch.no_grad():
        want = f32.act_mean(torch.as_tensor(obs)).numpy()
        want_vel = f32.estimate_vel(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(NpzPolicy(out["npz"])(obs), want, atol=TOL)
    np.testing.assert_allclose(NpzPolicy(out["npz"], "vel")(obs), want_vel, atol=TOL)
    np.testing.assert_allclose(onnx_loader.load_onnx_mlp(str(tmp_path / "policy.onnx"))(obs),
                               want, atol=TOL)
    with torch.no_grad():
        ts = torch.jit.load(str(tmp_path / "policy_1.pt"))(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(ts, want, atol=TOL)


def test_play_needs_a_card_unless_asked_for_cpu(run_root):
    from humanoid_tpu_torch.scripts import play

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        play.main(["--log-root", str(run_root[0])])
