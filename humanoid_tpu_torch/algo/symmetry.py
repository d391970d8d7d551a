"""Mirror-symmetry permutations of the XBot-L observation and action
spaces, for the PPO symmetry loss: the port's own copy of the reference
package's algo/symmetry.py (numpy only).

The mirror swaps left and right across the x-z plane. Every joint swaps
sides with a sign flip: the right leg's joint axes are the left's negated
(and so are the 18-dof layout's arm joints). Entries are (source index,
sign) pairs; a matrix built from them mirrors a row vector as x @ mat.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SignedPerm = Sequence[Tuple[int, float]]

# joints [L_roll, L_yaw, L_pitch, L_knee, L_ankle_p, L_ankle_r, R_*]
ACT_PERMUTATION: SignedPerm = (
    (6, -1), (7, -1), (8, -1), (9, -1), (10, -1), (11, -1),
    (0, -1), (1, -1), (2, -1), (3, -1), (4, -1), (5, -1),
)

# the 18-dof layout: 3 arm dofs per side, then the 12 leg dofs
ACT_PERMUTATION_18: SignedPerm = tuple(
    [(3, -1), (4, -1), (5, -1), (0, -1), (1, -1), (2, -1)]
    + [(src + 6, s) for src, s in ACT_PERMUTATION]
)


def act_permutation(nj: int) -> SignedPerm:
    if nj == 12:
        return ACT_PERMUTATION
    if nj == 18:
        return ACT_PERMUTATION_18
    raise ValueError(f"no mirror spec for nj={nj}")


def single_obs_permutation(nj: int = 12) -> SignedPerm:
    """The mirror of one actor frame:
    [sin, cos, vx, vy, wyaw | q | dq | actions | omega_xyz | euler_rpy]."""
    perm: List[Tuple[int, float]] = []
    perm += [(0, -1.0), (1, 1.0)]                  # a half-cycle phase shift
    perm += [(2, 1.0), (3, -1.0), (4, -1.0)]       # vx keeps, vy and wyaw flip
    base = 5
    dof_perm = act_permutation(nj)
    for block in range(3):                         # q, dq and actions
        off = base + block * nj
        perm += [(off + i, s) for i, s in dof_perm]
    off = base + 3 * nj
    perm += [(off + 0, -1.0), (off + 1, 1.0), (off + 2, -1.0)]   # roll and yaw rates flip
    perm += [(off + 3, -1.0), (off + 4, 1.0), (off + 5, -1.0)]   # roll and yaw flip
    return tuple(perm)


def build_perm_matrix(spec: SignedPerm, frame_stack: int = 1) -> np.ndarray:
    """(index, sign) spec -> the dense matrix with mirrored = x @ mat, the
    same spec on every frame of a stack."""
    width = len(spec)
    n = width * frame_stack
    mat = np.zeros((n, n), dtype=np.float32)
    for f in range(frame_stack):
        for i, (src, sign) in enumerate(spec):
            mat[f * width + src, f * width + i] = sign
    return mat


def xbot_perm_matrices(frame_stack: int = 15, nj: int = 12):
    """(obs_perm (frame_stack K, frame_stack K), act_perm (nj, nj))."""
    obs = build_perm_matrix(single_obs_permutation(nj), frame_stack)
    act = build_perm_matrix(act_permutation(nj))
    return obs, act
