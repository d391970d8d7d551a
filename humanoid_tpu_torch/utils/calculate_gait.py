"""Standalone gait-curve design tool (the upstream utils/calculate_gait.py;
the port's numpy copy of the reference package's): solves a quintic
swing-foot height profile h(t) = sum c_k t^k on [0, T] subject to boundary
and apex conditions, and reports and plots h, v, a.

Upstream uses scipy.fsolve on the nonlinear system; the system is linear
in the coefficients, so it is solved directly.

Conditions (mirroring upstream's):
  h(0) = 0, h(T) = h_end, h'(0) = v0, h'(T) = v_end, h(T_apex) = h_apex,
  h'(T_apex) = 0.

  python -m humanoid_tpu_torch.utils.calculate_gait [PLOT_PATH]
"""
from __future__ import annotations

import sys

import numpy as np


def solve_quintic_swing(
    T: float = 0.32,
    t_apex: float = 0.16,
    h_apex: float = 0.06,
    h_end: float = 0.0,
    v0: float = 0.0,
    v_end: float = -0.1,
) -> np.ndarray:
    """Return coefficients c[0..5] of h(t) = sum c_k t^k."""

    def row_h(t):
        return [t**k for k in range(6)]

    def row_v(t):
        return [k * t ** (k - 1) if k else 0.0 for k in range(6)]

    A = np.array(
        [
            row_h(0.0),
            row_h(T),
            row_v(0.0),
            row_v(T),
            row_h(t_apex),
            row_v(t_apex),
        ]
    )
    b = np.array([0.0, h_end, v0, v_end, h_apex, 0.0])
    return np.linalg.solve(A, b)


def evaluate(coeffs: np.ndarray, t: np.ndarray):
    h = sum(c * t**k for k, c in enumerate(coeffs))
    v = sum(k * c * t ** (k - 1) for k, c in enumerate(coeffs) if k)
    a = sum(k * (k - 1) * c * t ** (k - 2) for k, c in enumerate(coeffs) if k > 1)
    return h, v, a


def main(plot_path: str = "gait_profile.png"):
    """Print the default profile; where matplotlib imports, plot h, v and a
    into plot_path. Returns the plot's path, or None."""
    coeffs = solve_quintic_swing()
    t = np.linspace(0, 0.32, 200)
    h, v, a = evaluate(coeffs, t)
    print("coefficients:", np.round(coeffs, 5))
    print(f"apex height: {h.max():.4f} m at t={t[h.argmax()]:.3f} s")
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(3, 1, figsize=(7, 8), sharex=True)
    for ax, y, label in zip(axs, (h, v, a), ("h [m]", "v [m/s]", "a [m/s2]")):
        ax.plot(t, y)
        ax.set_ylabel(label)
        ax.grid(True)
    axs[-1].set_xlabel("t [s]")
    fig.savefig(plot_path, dpi=110)
    plt.close(fig)
    print("plot:", plot_path)
    return plot_path


if __name__ == "__main__":
    main(*sys.argv[1:2])
