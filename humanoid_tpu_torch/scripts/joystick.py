"""Gamepad command source for sim2sim and the viewer: the reference
package's scripts/joystick.py.

Polls an Xbox-style pad through pygame and maps the sticks through a cosine
shaping curve (smooth near the center, saturating at full deflection) to
(vx, vy, wz) velocity commands; the face buttons (A/B/X/Y/LB/RB) are read
for push-force triggers. Readings go through small bounded queues, so that
a slow consumer sees recent values.

With no pad (or no pygame, or no display backend for it) it serves zero
commands, so that headless harnesses share the code path. Set
SDL_VIDEODRIVER=dummy for fully headless operation.

  python -m humanoid_tpu_torch.scripts.joystick      # print the pad's readings
"""
from __future__ import annotations

import math
import queue

BUTTONS = ("A", "B", "X", "Y", "LB", "RB")


def _shape(x: float) -> float:
    """Cosine stick shaping: sign(x) * (1 - cos(pi*x)) / 2, inverted so
    pushing the stick forward (negative axis) drives positive velocity."""
    mag = 0.5 * (1.0 - math.cos(math.pi * x))
    return -(mag if x >= 0.0 else -mag)


class JoystickController:
    def __init__(self, queue_size: int = 5):
        self.joystick = None
        try:
            import pygame

            pygame.init()
            pygame.joystick.init()
            if pygame.joystick.get_count() > 0:
                self.joystick = pygame.joystick.Joystick(0)
                self.joystick.init()
            else:
                print("No joystick detected; serving zero commands.")
            self._pygame = pygame
        except (ImportError, RuntimeError) as e:    # no pygame, or no pad backend (pygame.error)
            print(f"pygame unavailable ({e}); serving zero commands.")
            self._pygame = None
        self.cmd_vel_queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self.button_queue: queue.Queue = queue.Queue(maxsize=queue_size)
        for _ in range(queue_size - 1):
            self.cmd_vel_queue.put(self._zero_cmd())
            self.button_queue.put(self._zero_buttons())

    @staticmethod
    def _zero_cmd():
        return {"vx": 0.0, "vy": 0.0, "wz": 0.0}

    @staticmethod
    def _zero_buttons():
        return {b: 0 for b in BUTTONS}

    def _pump(self):
        for event in self._pygame.event.get():
            if event.type == self._pygame.QUIT:
                self._pygame.quit()
                raise SystemExit

    def _put(self, q: queue.Queue, item):
        if q.full():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
        q.put(item)

    def update_button_press(self):
        if self.joystick is None:
            return
        self._pump()
        self._put(
            self.button_queue,
            {b: self.joystick.get_button(i) for i, b in enumerate(BUTTONS)},
        )

    def update_cmd_vel(self):
        if self.joystick is None:
            return
        self._pump()
        # left stick: vx (axis 1) / vy (axis 0); right stick x: wz (axis 3)
        self._put(
            self.cmd_vel_queue,
            {
                "vx": _shape(self.joystick.get_axis(1)),
                "vy": _shape(self.joystick.get_axis(0)),
                "wz": _shape(self.joystick.get_axis(3)),
            },
        )

    def get_cmd_vel(self):
        try:
            return self.cmd_vel_queue.get_nowait()
        except queue.Empty:
            return self._zero_cmd()

    def get_button_press(self):
        try:
            return self.button_queue.get_nowait()
        except queue.Empty:
            return self._zero_buttons()


if __name__ == "__main__":
    import time

    pad = JoystickController()
    while True:
        pad.update_cmd_vel()
        pad.update_button_press()
        print(pad.get_cmd_vel(), pad.get_button_press())
        time.sleep(0.1)
