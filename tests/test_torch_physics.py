"""Port vs reference: robot model, kinematics and dynamics.

The same random states (numpy, seeded) go through the JAX functions and
their counterparts in humanoid_tpu_torch, both on the CPU in float32.
Tolerances: atol 1e-5 on poses; rtol 1e-4 on the mass matrix (float32
reassociation of the CRBA sums).
"""
import jax
import numpy as np
import pytest
import torch

from humanoid_tpu.physics import dynamics as jdyn
from humanoid_tpu.physics import kinematics as jkin
from humanoid_tpu.physics.urdf import load_urdf as jax_load_urdf
from humanoid_tpu_torch.assets import XBOT_JOINT_ORDER, write_xbot_topology_urdf
from humanoid_tpu_torch.physics import kinematics as tkin
from humanoid_tpu_torch.physics.dynamics import assemble_mass_matrix, compute_kinematics_bias
from humanoid_tpu_torch.physics.kinematics import RobotTensors
from humanoid_tpu_torch.physics.urdf import load_urdf

N = 8


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_xbot_topology_urdf(str(tmp_path_factory.mktemp("urdf")))
    jm = jax_load_urdf(path, armature=0.01)
    tm = load_urdf(path, armature=0.01)
    return jm, tm, RobotTensors.from_model(tm, "cpu")


def _states(seed, nj=12):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        base_pos=rng.normal(size=(N, 3)).astype(np.float32),
        base_quat=q,
        qj=rng.uniform(-1.0, 1.0, (N, nj)).astype(np.float32),
        u=rng.normal(size=(N, nj + 6)).astype(np.float32),
        mass_add=rng.uniform(-5.0, 5.0, N).astype(np.float32),
    )


def _t(x):
    return torch.as_tensor(np.array(x))


def test_topology_urdf_has_xbot_widths(models):
    jm, tm, _ = models
    assert tm.joint_names == XBOT_JOINT_ORDER
    assert (tm.nj, tm.nb, tm.nv) == (12, 13, 18)
    assert [tm.body_names[b] for b in tm.foot_bodies] == ["left_ankle_roll_link",
                                                          "right_ankle_roll_link"]
    assert len(tm.knee_bodies) == 2 and list(tm.term_sphere_body) == [0]
    assert tm.contact_points()[0].shape == (8,)
    assert 30.0 < tm.total_mass < 60.0


@pytest.mark.parametrize("field", ["parent", "joint_pos", "joint_rot", "joint_axis", "mass",
                                   "com", "inertia", "dof_effort", "foot_corners",
                                   "term_sphere_offset", "term_sphere_radius", "body_zero_rot"])
def test_model_copy_matches_reference(models, field):
    jm, tm, _ = models
    np.testing.assert_array_equal(getattr(tm, field), getattr(jm, field))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fk_matches_reference(models, seed):
    jm, _, rt = models
    s = _states(seed)
    jp, jq = jax.vmap(lambda p, q, j: jkin.fk(jm, p, q, j))(s["base_pos"], s["base_quat"], s["qj"])
    tp, tq = tkin.fk(rt, _t(s["base_pos"]), _t(s["base_quat"]), _t(s["qj"]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_body_velocities_and_jacobians_match_reference(models, seed):
    jm, _, rt = models
    s = _states(seed)
    jp, jq = jax.vmap(lambda p, q, j: jkin.fk(jm, p, q, j))(s["base_pos"], s["base_quat"], s["qj"])
    jv, jw = jax.vmap(lambda p, q, u: jkin.body_velocities(jm, p, q, u))(jp, jq, s["u"])
    jJ = jax.vmap(lambda p, q: jkin.jacobians(jm, p, q))(jp, jq)
    tp, tq = _t(np.asarray(jp)), _t(np.asarray(jq))
    tv, tw = tkin.body_velocities(rt, tp, tq, _t(s["u"]))
    tJ = tkin.jacobians(rt, tp, tq)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_spatial_inertias_match_reference(models, seed):
    jm, tm, rt = models
    s = _states(seed)
    mass = np.tile(tm.mass, (N, 1)).astype(np.float32)
    mass[:, 0] += s["mass_add"]
    jp, jq = jax.vmap(lambda p, q, j: jkin.fk(jm, p, q, j))(s["base_pos"], s["base_quat"], s["qj"])
    jI, jc = jax.vmap(lambda p, q, m: jkin.spatial_inertias(jm, p, q, m))(jp, jq, mass)
    tI, tc = tkin.spatial_inertias(rt, _t(np.asarray(jp)), _t(np.asarray(jq)), _t(mass))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tI.numpy(), np.asarray(jI), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kinematics_bias_and_mass_matrix_match_reference(models, seed):
    jm, tm, rt = models
    s = _states(seed)
    mass = np.tile(tm.mass, (N, 1)).astype(np.float32)
    mass[:, 0] += s["mass_add"]
    with jax.default_matmul_precision("highest"):
        j = jax.vmap(lambda p, q, qj, u, m: jdyn.compute_kinematics_bias(jm, p, q, qj, u, mass=m))(
            s["base_pos"], s["base_quat"], s["qj"], s["u"], mass)
        jM = jax.vmap(lambda S, I: jdyn.assemble_mass_matrix(jm, S, I))(j[2], j[3])
    t = compute_kinematics_bias(rt, _t(s["base_pos"]), _t(s["base_quat"]), _t(s["qj"]),
                                _t(s["u"]), mass=_t(mass))
    tM = assemble_mass_matrix(rt, t[2], t[3])
    names = ["body_pos", "body_quat", "S", "I_sp", "v_sp"]
    for name, a, b in zip(names, t[:5], j[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)
    C_scale = float(np.abs(np.asarray(j[5])).max())
    np.testing.assert_allclose(t[5].numpy(), np.asarray(j[5]), rtol=1e-4, atol=1e-6 * C_scale)
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=1e-4, atol=1e-5)
    # and the factor the engine uses exists: M is symmetric positive definite
    torch.linalg.cholesky(tM)


# ---------------------------------------------------------------------------
# spatial algebra, contact set, PGS solve and penalty forces

from humanoid_tpu.physics import contact as jcontact
from humanoid_tpu.physics import pgs as jpgs
from humanoid_tpu.physics import spatial as jsp
from humanoid_tpu_torch.physics import contact as tcontact
from humanoid_tpu_torch.physics import pgs as tpgs
from humanoid_tpu_torch.physics import spatial as tsp


def _quats_vecs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(size=(N, 4)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return q, p, rng.normal(size=(N, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "quat_rotate_inverse", "quat_to_mat",
                                  "quat_to_euler_xyz", "quat_integrate", "mat_to_quat", "skew",
                                  "wrap_to_pi"])
def test_spatial_function_matches_reference(name):
    q, p, v = _quats_vecs(7)
    calls = {
        "quat_mul": lambda m: m.quat_mul(q, p),
        "quat_rotate": lambda m: m.quat_rotate(q, v),
        "quat_rotate_inverse": lambda m: m.quat_rotate_inverse(q, v),
        "quat_to_mat": lambda m: m.quat_to_mat(q),
        "quat_to_euler_xyz": lambda m: m.quat_to_euler_xyz(q),
        "quat_integrate": lambda m: m.quat_integrate(q, v, 0.01),
        "mat_to_quat": lambda m: m.mat_to_quat(np.asarray(jsp.quat_to_mat(q))),
        "skew": lambda m: m.skew(v),
        "wrap_to_pi": lambda m: m.wrap_to_pi(4.0 * v),
    }
    ref = np.asarray(calls[name](jsp))

    class Torch:
        def __getattr__(self, attr):
            fn = getattr(tsp, attr)
            return lambda *a: fn(*(torch.as_tensor(np.array(x)) if isinstance(x, np.ndarray)
                                   else x for x in a)).numpy()

    np.testing.assert_allclose(calls[name](Torch()), ref, atol=1e-5)


def _standing_kinematics(models, seed):
    """Bodies of robots standing near the ground with random velocities."""
    jm, tm, rt = models
    s = _states(seed)
    s["base_pos"][:, 2] = 0.88
    s["base_quat"][:] = [1.0, 0.0, 0.0, 0.0]
    s["qj"] *= 0.1
    jp, jq = jax.vmap(lambda p, q, j: jkin.fk(jm, p, q, j))(s["base_pos"], s["base_quat"], s["qj"])
    jv, _ = jax.vmap(lambda p, q, u: jkin.body_velocities(jm, p, q, u))(jp, jq, 0.1 * s["u"])
    return jp, jq, jv


@pytest.mark.parametrize("seed", [0, 1])
def test_foot_contact_set_matches_reference(models, seed):
    jm, _, rt = models
    jp, jq, jv = _standing_kinematics(models, seed)
    ref = jpgs.foot_contact_set(jm, jp, jq, jv, jcontact.Terrain.plane())
    out = tpgs.foot_contact_set(rt, _t(jp), _t(jq), _t(jv), tcontact.Terrain.plane())
    for name, a, b in zip(["pts", "vels", "phi", "n", "J"], out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_pgs_solve_matches_reference(models, seed):
    """One cold PGS solve from the same factor, gaps and free velocity."""
    jm, tm, rt = models
    jp, jq, jv = _standing_kinematics(models, seed)
    s = _states(seed + 10)
    _, _, phi, n, J = jpgs.foot_contact_set(jm, jp, jq, jv, jcontact.Terrain.plane())
    phi = np.asarray(phi) - 0.86 + np.random.default_rng(seed).uniform(-0.002, 0.002, (N, 8))
    with jax.default_matmul_precision("highest"):
        jk = jax.vmap(lambda p, q, qj, u: jdyn.compute_kinematics_bias(jm, p, q, qj, u))(
            s["base_pos"], s["base_quat"], s["qj"] * 0.1, s["u"])
        M = np.asarray(jax.vmap(lambda S, I: jdyn.assemble_mass_matrix(jm, S, I))(jk[2], jk[3]))
    L = np.linalg.cholesky(M.astype(np.float64)).astype(np.float32)
    mu = np.random.default_rng(seed).uniform(0.1, 2.0, N).astype(np.float32)
    u_free = 0.1 * s["u"]
    params = jpgs.PGSParams(iterations=6)
    with jax.default_matmul_precision("highest"):
        ju, jf = jpgs.pgs_solve(u_free, L, phi, n, J, mu, 0.001, params)
    prep = tpgs.pgs_prepare(_t(L), _t(n), _t(J))
    tu, tf, _ = tpgs.pgs_solve(_t(u_free), prep, _t(phi), _t(mu), 0.001, tpgs.PGSParams(iterations=6))
    assert int((phi < 0).sum()) > 0
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-4)
    weight = tm.total_mass * 9.81
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-3 * weight)


def test_penalty_point_forces_match_reference():
    rng = np.random.default_rng(4)
    pts = rng.normal(scale=0.02, size=(N, 3)).astype(np.float32)
    vels = rng.normal(scale=0.3, size=(N, 3)).astype(np.float32)
    mu = rng.uniform(0.1, 2.0, N).astype(np.float32)
    jf, jfn = jcontact._point_forces(pts, vels, np.zeros(N, np.float32), mu,
                                     jcontact.ContactParams())
    tf, tfn = tcontact._point_forces(_t(pts), _t(vels), torch.zeros(N), _t(mu),
                                     tcontact.ContactParams())
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tfn.numpy(), np.asarray(jfn), rtol=1e-5, atol=1e-3)


def _contact_inputs(models, seed):
    """Standing bodies (the reference's FK and velocities) and a per-env
    friction; the sole corners' median height is foot_z."""
    jm, _, _ = models
    jp, jq, jv = _standing_kinematics(models, seed)
    pt_body, pt_off = jm.contact_points()
    corners = _t(np.asarray(jp)[:, pt_body]) + tsp.quat_rotate(
        _t(np.asarray(jq)[:, pt_body]), _t(np.asarray(pt_off, np.float32)))
    foot_z = float(corners[..., 2].median())
    mu = np.random.default_rng(seed).uniform(0.1, 2.0, N).astype(np.float32)
    return jp, jq, jv, mu, foot_z


@pytest.mark.parametrize("ground", ["flat", "heightfield"])
def test_contact_forces_match_reference(models, ground):
    """The penalty model on every sole corner and termination sphere vs
    the reference's contact_forces. Flat: the robots lowered so that their
    soles are 2 mm into the plane z = 0 (vertical forces). Heightfield: a
    surface at the soles' height with +-3 mm of random relief per 0.1 m cell
    (forces along the sampled normal); some corners are in, some out."""
    jm, tm, rt = models
    jp, jq, jv, mu, foot_z = _contact_inputs(models, 3)
    if ground == "flat":
        jp = np.asarray(jp) - np.array([0.0, 0.0, foot_z + 0.002], np.float32)
        jt, tt = jcontact.Terrain.plane(), tcontact.Terrain.plane()
    else:
        rng = np.random.default_rng(8)
        height = (foot_z + rng.uniform(-0.003, 0.003, (101, 101))).astype(np.float32)
        jt = jcontact.Terrain(height=jax.numpy.asarray(height), horizontal_scale=0.1, border=5.0,
                              flat=False)
        tt = tcontact.Terrain.heightfield(height, 0.1, 5.0)
    params = jcontact.ContactParams()
    ref = jax.vmap(lambda p, q, v, m: jcontact.contact_forces(jm, p, q, v, jt, m, params))(
        jp, jq, jv, mu)
    out = tcontact.contact_forces(rt, _t(jp), _t(jq), _t(jv), tt, _t(mu),
                                  tcontact.ContactParams())
    weight = tm.total_mass * 9.81
    np.testing.assert_allclose(out.point_forces.numpy(), np.asarray(ref.point_forces), rtol=1e-4,
                               atol=1e-4 * weight)
    np.testing.assert_allclose(out.term_force.numpy(), np.asarray(ref.term_force), atol=1e-3)
    np.testing.assert_allclose(out.tau_gen.numpy(), np.asarray(ref.tau_gen), rtol=1e-4,
                               atol=1e-4 * weight)
    fz = out.point_forces[..., 2]
    assert float(fz.max()) > 10.0
    if ground == "heightfield":
        assert float((fz == 0).float().mean()) > 0.05          # some corners are out
        assert float(out.point_forces[..., 0:2].abs().max()) > 1.0


def test_contact_forces_with_planes_match_terrain_on_a_ramp(models):
    """`planes` (the kernel's ground) on an exactly linear ramp gives the
    same forces as the ramp's heightfield sampled at the points."""
    jm, tm, rt = models
    jp, jq, jv, mu, foot_z = _contact_inputs(models, 4)
    i = np.arange(101)[:, None]
    j = np.arange(101)[None, :]
    c0 = foot_z + 0.002
    height = (c0 + 0.005 * (i - j)).astype(np.float32)   # c0 + 0.05 x - 0.05 y
    terrain = tcontact.Terrain.heightfield(height, 0.1, 5.0)
    P = len(rt.point_body)
    planes = torch.tensor(np.tile([c0, 0.05, -0.05], (N, P)), dtype=torch.float32)
    args = (rt, _t(jp), _t(jq), _t(jv))
    a = tcontact.contact_forces(*args, terrain, _t(mu), tcontact.ContactParams())
    b = tcontact.contact_forces(*args, tcontact.Terrain.plane(), _t(mu),
                                tcontact.ContactParams(), planes=planes)
    weight = tm.total_mass * 9.81
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-4 * weight)
    assert float(a.point_forces[..., 2].max()) > 10.0
