"""The port's live-viewer session (scripts/view.py ViewerSession) on the
CPU: the reference's five viewer cases (tests/test_viewer.py) on the port's
session, and the port's session against the reference's.

Both sessions run humanoid_ppo at 1 env on penalty contact with the eval
overrides; the reference's `registry.get_cfgs` is patched to point
`asset.urdf` at the port's 12-dof stand-in. The reference session's state
is carried across field by field, then both take 20 steps with the same
commands and a zero policy: base position, orientation and joints within
1e-4. Without a card the session raises unless asked for the CPU, and the
CLI exits 2 with its headless message where no window opens.
"""
import dataclasses

import numpy as np
import pytest
import torch

from humanoid_tpu.scripts import view as jview
from humanoid_tpu.utils import registry as jreg
from humanoid_tpu_torch.env.xbotl import EnvState
from humanoid_tpu_torch.physics.engine import PhysState
from humanoid_tpu_torch.scripts import view
from humanoid_tpu_torch.utils import registry

TASK = "humanoid_ppo"
ATOL = 1e-4


@pytest.fixture(scope="module")
def session():
    return view.ViewerSession(TASK, cmd=[0.5, 0.0, 0.0], device="cpu")


def test_step_returns_pose(session):
    pos, quat, qj = session.step()
    assert pos.shape == (3,) and quat.shape == (4,) and qj.shape == (12,)
    assert np.isfinite(pos).all() and 0.3 < pos[2] < 1.2


def test_keyboard_command_adjustment(session):
    session.cmd[:] = 0.0
    session.handle_key("w")
    session.handle_key("W")
    assert abs(session.cmd[0] - 0.2) < 1e-6
    session.handle_key("S")
    assert abs(session.cmd[0] - 0.1) < 1e-6
    session.handle_key("A")
    session.handle_key("Q")
    assert session.cmd[1] > 0 and session.cmd[2] > 0
    session.handle_key("D")
    session.handle_key("E")
    assert abs(session.cmd[1]) < 1e-6 and abs(session.cmd[2]) < 1e-6
    session.handle_key("Z")
    assert not session.cmd.any()
    # commands flow into the env state on the next step
    session.handle_key("W")
    session.step()
    assert float(session.state.commands[0, 0]) == pytest.approx(0.1)


def test_sync_toggle(session):
    s0 = session.sync
    session.handle_key("V")
    assert session.sync is (not s0)
    session.handle_key("V")
    assert session.sync is s0


def test_push_kicks_base_velocity(session):
    session.reset()
    v0 = session.state.phys.u[0, 3:5].clone()
    session.handle_key("P")
    v1 = session.state.phys.u[0, 3:5]
    assert float((v1 - v0).abs().max()) > 1e-4


def test_reset_restores_height(session):
    # knock it over with pushes and steps, then reset
    for _ in range(3):
        session.push(magnitude=3.0)
        for _ in range(10):
            session.step()
    session.handle_key("R")
    assert int(session.state.episode_length[0]) == 1
    pos, _, _ = session.step()
    assert pos[2] > 0.7


def test_session_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        view.ViewerSession(TASK, cmd=[0.5, 0.0, 0.0])


def to_port_state(js) -> EnvState:
    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)

    skip = ("phys", "common_step", "terrain_planes")
    fields = {f: t(getattr(js, f)) for f in EnvState._fields if f not in skip}
    return EnvState(phys=PhysState(*(t(x) for x in js.phys)),
                    common_step=t(js.common_step, torch.int64), terrain_planes=None, **fields)


def test_session_matches_the_reference_session(monkeypatch):
    urdf = registry.default_urdf()
    task_cfgs = jreg.get_cfgs

    def on_the_stand_in(name):
        e, t = task_cfgs(name)
        return e.replace(asset=dataclasses.replace(e.asset, urdf=urdf)), t

    monkeypatch.setattr(jreg, "get_cfgs", on_the_stand_in)
    ref = jview.ViewerSession(TASK, cmd=[0.4, 0.0, 0.0])
    port = view.ViewerSession(TASK, cmd=[0.4, 0.0, 0.0], device="cpu")
    assert port.env.cfg.sim.contact_model == ref.env.cfg.sim.contact_model == "penalty"
    assert (port.env.cfg.env.num_envs, port.env.cfg.noise.add_noise,
            port.env.cfg.domain_rand.push_robots) == (1, False, False)
    port.state = to_port_state(ref.state)
    for i in range(20):
        for s in (ref, port):
            if i == 5:
                s.handle_key("Q")
            if i == 12:
                s.handle_key("W")
        got, want = port.step(), ref.step()
        for g, w, name in zip(got, want, ("base_pos", "base_quat", "qj")):
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=f"{name}, step {i}")
    np.testing.assert_array_equal(port.cmd, ref.cmd)
    np.testing.assert_allclose(port.state.commands.numpy(), np.asarray(ref.state.commands),
                               atol=1e-7)


def test_view_cli_headless_exits_2(tmp_path, monkeypatch, capsys):
    """--policy with an exported .npz; the window cannot open here."""
    from humanoid_tpu_torch.algo.networks import ActorCritic
    from humanoid_tpu_torch.deploy.export import export_policy_npz

    npz = export_policy_npz(ActorCritic(705, 219, 12), str(tmp_path / "policy.npz"))
    sessions = []

    def no_window(session):
        sessions.append(session)
        session.step()
        raise view.WindowUnavailable("no display")

    monkeypatch.setattr(view, "run_window", no_window)
    with pytest.raises(SystemExit) as exit_info:
        view.view(view.get_args(["--policy", npz, "--device", "cpu"]))
    assert exit_info.value.code == 2
    assert "scripts.play --task humanoid_ppo --video" in capsys.readouterr().err
    (s,) = sessions
    assert s.env.physics.launches == 0 and int(s.state.episode_length[0]) == 2


def failing_step(*args, **kwargs):
    raise RuntimeError("B1 launch failed")


def test_view_cli_passes_step_errors_through(tmp_path, monkeypatch, capsys):
    """An error of the session's steps (a failed kernel launch, a state that
    blew up) comes through as it is, not as the headless message."""
    from humanoid_tpu_torch.algo.networks import ActorCritic
    from humanoid_tpu_torch.deploy.export import export_policy_npz

    npz = export_policy_npz(ActorCritic(705, 219, 12), str(tmp_path / "policy.npz"))

    def window(session):
        session.env.step = failing_step
        session.step()

    monkeypatch.setattr(view, "run_window", window)
    with pytest.raises(RuntimeError, match="B1 launch failed") as info:
        view.view(view.get_args(["--policy", npz, "--device", "cpu"]))
    assert not isinstance(info.value, view.WindowUnavailable)
    assert "headless" not in capsys.readouterr().err


class FakeWindow:
    """mujoco.viewer's passive handle, open for `frames` frames."""

    def __init__(self, frames=2):
        self.cam, self.polls, self.syncs, self.frames = type("Cam", (), {})(), 0, 0, frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def is_running(self):
        self.polls += 1
        return self.polls <= self.frames

    def sync(self):
        self.syncs += 1


def test_run_window_reports_only_window_failures(session, monkeypatch):
    """run_window raises WindowUnavailable where launch_passive fails (no
    display, no GL) and lets an error of session.step through."""
    import mujoco.viewer

    def no_display(*args, **kwargs):
        raise RuntimeError("could not initialize GLFW")

    monkeypatch.setattr(mujoco.viewer, "launch_passive", no_display)
    with pytest.raises(view.WindowUnavailable, match="GLFW"):
        view.run_window(session)
    window = FakeWindow()
    monkeypatch.setattr(mujoco.viewer, "launch_passive", lambda *a, **k: window)
    monkeypatch.setattr(session, "sync", True)
    view.run_window(session)
    assert window.syncs == 2 and window.cam.trackbodyid >= 0
    monkeypatch.setattr(mujoco.viewer, "launch_passive", lambda *a, **k: FakeWindow())
    monkeypatch.setattr(session.env, "step", failing_step)
    with pytest.raises(RuntimeError, match="B1 launch failed") as info:
        view.run_window(session)
    assert not isinstance(info.value, view.WindowUnavailable)
