"""Offscreen video of a rollout: the reference package's deploy/video.py.

The port's physics has no renderer, so a video replays generalized
coordinates (base pose and joint angles) through a MuJoCo model with an
offscreen `mujoco.Renderer` and a camera tracking `base_link`, and OpenCV
encodes the frames as mp4. It serves `scripts/play.py --video` (the port's
trajectory on the exported MJCF of the played robot) and `deploy/sim2sim.py
--video` (a MuJoCo replay). Without a display, MuJoCo renders through EGL
(MUJOCO_GL=egl) unless MUJOCO_GL is set.
"""
from __future__ import annotations

import os

import numpy as np


def _ensure_gl_backend() -> None:
    """Headless machines have no X display; default to EGL."""
    if "MUJOCO_GL" not in os.environ and not os.environ.get("DISPLAY"):
        os.environ["MUJOCO_GL"] = "egl"


class VideoRecorder:
    """Renders MuJoCo qpos frames of the model at `model_path` to an mp4
    with a base-tracking camera."""

    def __init__(
        self,
        out_path: str,
        model_path: str,
        fps: float = 30.0,
        width: int = 720,
        height: int = 480,
        track_body: str = "base_link",
        distance: float = 3.0,
        azimuth: float = 135.0,
        elevation: float = -20.0,
    ):
        _ensure_gl_backend()
        import cv2
        import mujoco

        self._mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_path(model_path)
        self.data = mujoco.MjData(self.model)
        self.base_id = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY, track_body)
        if self.base_id < 0:
            raise ValueError(f"{model_path} has no body {track_body!r} to track")
        # the default offscreen framebuffer is 640x480; grow it to fit
        self.model.vis.global_.offwidth = max(self.model.vis.global_.offwidth, width)
        self.model.vis.global_.offheight = max(self.model.vis.global_.offheight, height)
        self.renderer = mujoco.Renderer(self.model, height, width)
        self.camera = mujoco.MjvCamera()
        self.camera.type = mujoco.mjtCamera.mjCAMERA_TRACKING
        self.camera.trackbodyid = self.base_id
        self.camera.distance = distance
        self.camera.azimuth = azimuth
        self.camera.elevation = elevation
        self.out_path = out_path
        self._writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                       (width, height))
        self._cv2 = cv2
        self.frames = 0

    def add_qpos(self, qpos: np.ndarray) -> None:
        """Render one frame from a full MuJoCo qpos vector."""
        self.data.qpos[:] = np.asarray(qpos, dtype=np.float64)
        self._mujoco.mj_forward(self.model, self.data)
        self.renderer.update_scene(self.data, camera=self.camera)
        frame = self.renderer.render()
        self._writer.write(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))
        self.frames += 1

    def add_state(self, base_pos: np.ndarray, base_quat_wxyz: np.ndarray,
                  qj: np.ndarray) -> None:
        """Render one frame from the port's state (base pose and joint
        angles). The port's base_pos is the base_link frame's origin in the
        world; the MJCF's free joint carries the body at its body_pos
        offset, as in sim2sim's initial pose."""
        nj = len(qj)
        qpos = np.zeros(self.model.nq)
        qpos[0:3] = np.asarray(base_pos) - self.model.body_pos[self.base_id]
        qpos[3:7] = np.asarray(base_quat_wxyz)
        qpos[-nj:] = np.asarray(qj)
        self.add_qpos(qpos)

    def close(self) -> str:
        self._writer.release()
        self.renderer.close()
        return self.out_path
