"""The ground and the penalty contact model. Port of the reference
package's physics/contact.py.

`Terrain` is the flat plane z = 0 or a global heightfield shared by all
envs, sampled bilinearly or, with `wall_thresh > 0`, with the trimesh-like
vertical faces. `contact_forces` is the penalty model on every contact
point (sole corners and termination spheres); the PGS path keeps only the
termination spheres on it (they matter during falls only), and its feet go
through physics/pgs.py.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .spatial import quat_rotate


class ContactParams(NamedTuple):
    kn: float = 2.0e4       # normal stiffness [N/m]
    cn: float = 80.0        # normal damping [N s/m]
    v_reg: float = 0.05     # friction regularization velocity [m/s]


def _warp_t(t, delta, thr, w):
    """Vertical-face warp of a lerp parameter: where the rise across a cell
    edge exceeds `thr`, the surface keeps the low height up to the wall and
    then rises over a band of width w (a fraction of a cell)."""
    t_up = torch.clamp((t - (1.0 - w)) / w, 0.0, 1.0)
    t_dn = torch.clamp(t / w, 0.0, 1.0)
    return torch.where(delta > thr, t_up, torch.where(delta < -thr, t_dn, t))


def _warp_t_grad(t, delta, thr, w):
    """d(warped t)/dt: 1/w inside the wall band, 0 on the flats."""
    g_up = ((t > 1.0 - w) & (t < 1.0)).to(t.dtype) / w
    g_dn = ((t > 0.0) & (t < w)).to(t.dtype) / w
    return torch.where(delta > thr, g_up, torch.where(delta < -thr, g_dn, torch.ones_like(t)))


def to_cells(x, border: float, hs: float):
    """World coordinate -> cell units, (x + border) / hs, as an IEEE
    division: on a CUDA tensor a division by a Python scalar is a
    multiplication by the reciprocal, whose floor can flip at a cell edge."""
    return (x + border) / torch.full((), hs, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True, eq=False)
class Terrain:
    """The ground. height[i, j] is the height at x = i*hs - border,
    y = j*hs - border (float32 metres on the physics device); None on the
    flat plane. wall_thresh > 0 turns cell edges that rise more than
    wall_thresh metres into near-vertical walls of horizontal width
    wall_width*hs (the reference's trimesh slope-threshold semantics)."""
    height: Optional[torch.Tensor] = None
    horizontal_scale: float = 1000.0
    border: float = 1000.0
    flat: bool = True
    wall_thresh: float = 0.0
    wall_width: float = 0.1

    @staticmethod
    def plane() -> "Terrain":
        return Terrain()

    @staticmethod
    def heightfield(height, horizontal_scale: float, border: float,
                    wall_thresh: float = 0.0, device="cpu") -> "Terrain":
        h = torch.as_tensor(height, dtype=torch.float32, device=device).contiguous()
        return Terrain(height=h, horizontal_scale=float(horizontal_scale),
                       border=float(border), flat=False, wall_thresh=float(wall_thresh))

    def _corners(self, xy):
        fx, fy, x0, y0 = corner_cells(self.height.shape, self.border, self.horizontal_scale, xy)
        h = self.height
        return (h[x0, y0], h[x0 + 1, y0], h[x0, y0 + 1], h[x0 + 1, y0 + 1],
                fx - torch.floor(fx), fy - torch.floor(fy))

    def sample(self, xy):
        """Surface height at world xy (..., 2): bilinear, or wall-aware when
        wall_thresh > 0."""
        if self.flat:
            return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
        return self.interp_from_corners(*self._corners(xy))[0]

    def interp_from_corners(self, h00, h10, h01, h11, tx, ty):
        """(height, dh/dx, dh/dy) from the 4 cell-corner heights and the
        in-cell lerp parameters: the interpolation shared by the gather
        path and the heightfield sampler, vertical-face warp included."""
        hs = self.horizontal_scale
        if self.wall_thresh > 0.0:
            thr, w = self.wall_thresh, self.wall_width
            dx0, dx1 = h10 - h00, h11 - h01
            hx0 = h00 + dx0 * _warp_t(tx, dx0, thr, w)
            hx1 = h01 + dx1 * _warp_t(tx, dx1, thr, w)
            dy = hx1 - hx0
            tyw = _warp_t(ty, dy, thr, w)
            h = hx0 + dy * tyw
            dhx0 = dx0 * _warp_t_grad(tx, dx0, thr, w) / hs
            dhx1 = dx1 * _warp_t_grad(tx, dx1, thr, w) / hs
            gx = (1 - tyw) * dhx0 + tyw * dhx1
            gy = dy * _warp_t_grad(ty, dy, thr, w) / hs
            return h, gx, gy
        h = h00 * (1 - tx) * (1 - ty) + h10 * tx * (1 - ty) + h01 * (1 - tx) * ty + h11 * tx * ty
        gx = ((h10 - h00) * (1 - ty) + (h11 - h01) * ty) / hs
        gy = ((h01 - h00) * (1 - tx) + (h11 - h10) * tx) / hs
        return h, gx, gy

    def sample_with_grad(self, xy):
        """(height, dh/dx, dh/dy) of the sampled surface at world xy: the
        local tangent plane that sets the contact normal."""
        if self.flat:
            z = torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
            return z, z, z
        return self.interp_from_corners(*self._corners(xy))

    def sample_min3(self, xy):
        """Min of 3 neighbouring cells: the conservative height probe of the
        height scan."""
        if self.flat:
            return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
        x0, y0 = min3_cells(self.height.shape, self.border, self.horizontal_scale, xy)
        h = self.height
        return torch.minimum(torch.minimum(h[x0, y0], h[x0 + 1, y0]), h[x0, y0 + 1])


def corner_cells(shape, border: float, hs: float, xy):
    """The bilinear cell under world xy (..., 2): (fx, fy) in cell units
    clipped to [0, H-1.001] x [0, W-1.001], and the cell's indices."""
    H, W = shape
    fx = torch.clamp(to_cells(xy[..., 0], border, hs), 0.0, H - 1.001)
    fy = torch.clamp(to_cells(xy[..., 1], border, hs), 0.0, W - 1.001)
    return fx, fy, torch.floor(fx).long(), torch.floor(fy).long()


def min3_cells(shape, border: float, hs: float, xy):
    """The min3 probe's cell under world xy (..., 2): floor, clipped to
    [0, H-2] x [0, W-2]."""
    H, W = shape
    x0 = torch.clamp(torch.floor(to_cells(xy[..., 0], border, hs)), 0, H - 2).long()
    y0 = torch.clamp(torch.floor(to_cells(xy[..., 1], border, hs)), 0, W - 2).long()
    return x0, y0


def plane_normal(gx, gy):
    """Unit normal (..., 3) and 1/|(-gx, -gy, 1)| of the plane with
    gradient (gx, gy)."""
    inv_l = torch.rsqrt(1.0 + gx * gx + gy * gy)
    return torch.stack([-gx * inv_l, -gy * inv_l, inv_l], dim=-1), inv_l


def _point_forces(pts, vels, heights, mu, params: ContactParams, grads=None):
    """Penalty normal force + regularized Coulomb friction.

    pts/vels: (..., 3) world positions/velocities; heights: (...,) ground
    height; mu broadcasts against heights. grads, when given, is the local
    surface gradient (gx, gy): the force then acts along the surface normal,
    with the penetration measured along it and friction in the tangent
    plane; None is the vertical normal. Returns (force (..., 3), fn (...,)
    normal force magnitude)."""
    phi_z = pts[..., 2] - heights
    if grads is None:
        pen = (phi_z < 0.0).to(pts.dtype)
        fn = torch.clamp(-params.kn * phi_z - params.cn * vels[..., 2], min=0.0) * pen
        vt = vels[..., 0:2]
        speed = torch.sqrt(torch.sum(vt * vt, dim=-1) + params.v_reg ** 2)
        ft = -(mu * fn / speed)[..., None] * vt
        return torch.cat([ft, fn[..., None]], dim=-1), fn
    n, inv_l = plane_normal(*grads)
    phi = phi_z * inv_l
    pen = (phi < 0.0).to(pts.dtype)
    v_n = torch.sum(vels * n, dim=-1)
    fn = torch.clamp(-params.kn * phi - params.cn * v_n, min=0.0) * pen
    vt = vels - v_n[..., None] * n
    speed = torch.sqrt(torch.sum(vt * vt, dim=-1) + params.v_reg ** 2)
    f = fn[..., None] * n - (mu * fn / speed)[..., None] * vt
    return f, fn


class ContactInfo(NamedTuple):
    tau_gen: torch.Tensor       # (N, nv) generalized contact force
    point_forces: torch.Tensor  # (N, P, 3) world forces at the sole corners
    term_force: torch.Tensor    # (N, nt) normal force on the termination spheres


def contact_forces(rt, body_pos, body_quat, v_sp, terrain: Terrain, mu,
                   params: ContactParams, planes=None) -> ContactInfo:
    """Penalty forces on every sole corner and termination sphere, as
    generalized forces. body_pos/body_quat (N, nb, .) and v_sp (N, nb, 6)
    from the kinematics, mu (N,). The ground is `terrain` (the flat plane:
    vertical forces; a heightfield: along the sampled surface normal) or,
    when given, `planes` (N, 3P): one plane [c0, gx, gy] per contact point,
    forces along its normal (the control-step kernel's ground)."""
    N = body_pos.shape[0]
    nP = len(rt.model.contact_points()[0])
    A = body_pos[:, 0]
    bodies = rt.point_body
    pts = body_pos[:, bodies] + quat_rotate(body_quat[:, bodies], rt.point_off)
    pts = torch.cat([pts[..., 0:2], (pts[..., 2] - rt.point_rad)[..., None]], dim=-1)
    rel = pts - A[:, None]
    vels = v_sp[:, bodies, 3:6] + torch.linalg.cross(v_sp[:, bodies, 0:3], rel, dim=-1)
    if planes is not None:
        c0, gx, gy = planes.reshape(N, -1, 3).unbind(-1)
        f, fn = _point_forces(pts, vels, c0 + gx * pts[..., 0] + gy * pts[..., 1], mu[:, None],
                              params, grads=(gx, gy))
    elif terrain.flat:
        f, fn = _point_forces(pts, vels, terrain.sample(pts[..., 0:2]), mu[:, None], params)
    else:
        h, gx, gy = terrain.sample_with_grad(pts[..., 0:2])
        f, fn = _point_forces(pts, vels, h, mu[:, None], params, grads=(gx, gy))
    n_mom = torch.linalg.cross(rel, f, dim=-1)                       # (N,K,3)
    w_j = quat_rotate(body_quat[:, 1:], rt.joint_axis)               # (N,nj,3)
    lin_j = torch.linalg.cross(body_pos[:, 1:] - A[:, None], w_j, dim=-1)
    contrib = torch.einsum("nki,nji->nkj", n_mom, w_j) + torch.einsum("nki,nji->nkj", f, lin_j)
    tau_j = torch.sum(rt.ancestors[bodies] * contrib, dim=1)
    tau_gen = torch.cat([n_mom.sum(1), f.sum(1), tau_j], dim=1)
    return ContactInfo(tau_gen=tau_gen, point_forces=f[:, :nP], term_force=fn[:, nP:])
