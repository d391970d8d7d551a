// One 100 Hz control step of the humanoid physics as one CUDA kernel launch.
//
// Replaces the TPU kernel humanoid_tpu/ops/physics_kernel.py::_control_kernel
// (built by build_control_fn) on both of its contact models, chosen at launch
// by the flags `pgs` and `warm` (one compiled kernel per instance):
//   pgs = 1: block-PGS foot contact and penalty termination spheres (the
//            kernel built with pgs_params); each substep's sweep starts
//            from zero impulses, or, with the flag `warm` (pgs_warm_start,
//            the reference's lines 891-906), from the previous substep's,
//            carried through the substep loop from zeros at its entry;
//   pgs = 0: the penalty model on every contact point, sole corners and
//            termination spheres alike, summed into the generalized force,
//            then one solve with the mass-matrix factor (pgs_params=None:
//            _contact, _chol_solve and _integrate).
// `decimation`, `freeze` (factor the mass matrix once, from the entry
// configuration), `freeze_prep` (PGS only: build the contact frames,
// Jacobian rows and Delassus operator once, with the frozen factor) and the
// sweep count are runtime arguments: decimation=1, freeze=0 is the exact
// substep of _substep_kernel.
//
// Three optional per-env inputs, each (N, rows) env-major and a null
// pointer when absent, with the reference's row order (_extra_rows):
//   gains  (3 nj): kp_eff, kd_eff, strength per joint; they replace the
//          table's kp/kd in the PD law, (kp (q* - q) - kd qd) * strength,
//          still clipped at tau_lim;
//   body   (9 nb): COM xyz per body, then inertia xx xy xz yy yz zz per
//          body (body frame); they replace the table's in the spatial
//          inertias, so in the CRBA, the frozen factor and the bias;
//   planes (3 P):  [c0, gx, gy] per contact point, sole corners then
//          termination spheres: the ground height c0 + gx x + gy y, held for
//          the control step. It sets the gap along the plane normal and the
//          normal-aligned frame of every PGS row, and the normal of every
//          penalty force. Without it the ground is the plane z = 0.
// The rows are read from global memory where they are used.
//
// Each substep: PD torque, forward kinematics, joint screws, spatial
// inertias, the velocity/bias recursion, the CRBA mass matrix and its
// Cholesky factor (unless frozen), the penalty forces (the termination
// spheres; with pgs = 0 the sole corners too), then with pgs = 1 the free
// velocity, the contact prep (unless frozen) and the PGS sweeps, with
// pgs = 0 the acceleration, and semi-implicit Euler. The kernel writes the
// state and the last substep's diagnostics.
//
// The robot is data, not code: the wrapper packs a ModelTable (topology,
// joint frames, inertias, gains, contact points, solver constants) that
// each block copies into shared memory, so this source is generic in the
// robot and its outer loops stay loops. Arrays are sized at compile time
// for nj <= 18 and 8 sole points.
//
// What bounds it: the work is ~90,000 (penalty) to ~230,000 (PGS)
// dependent fp32 operations per env and control step against ~740 bytes
// moved per env (~1,700 with the gains, body and planes inputs), so the
// operation count sets the bound; at 4096 envs the card holds every env at
// once, and each env's chain of dependent operations sets the time.
//
// Design of the PGS instances: a team of TEAM lanes per env (TEAM = 4:
// eight envs per block, their teams interleaved in one warp). About 60% of
// an env's operations are contact-row work, which the team spreads over
// its lanes: the prep's Jacobian rows, column solves and Delassus entries,
// the free row velocities, the sweeps' row products (reduced with
// shuffles, Gauss-Seidel order kept: point k's impulses are written before
// point k+1's products read them) and the impulse map J^T lam. The tree
// recursions (kinematics, velocity/bias, CRBA and factor, the triangular
// solves, the penalty spheres and the integration) stay serial on the
// team's lane 0, in its own local Tree. The contact arrays, the factor and
// what the row work reads of the tree (joint screws, contact point
// offsets) live in shared memory, one Contact per env at the table's
// maximum sizes. The serial part then sets the time: each warp
// instruction of it, and each local-memory request for lane 0's Tree
// (mostly served by L2, as shared memory takes most of each SM's L1),
// serves as many envs as the warp holds teams. So the team is small, four
// lanes and eight teams per warp (eight lanes and four teams ran slower,
// PERF.md), and the teams interleave, so that their lanes 0 share a sector.
//
// Design of the penalty instance: a team of PENALTY_TEAM lanes per env, the
// teams of a warp interleaved as above, 8 envs per block. It has no contact
// rows; nearly all of its work is tree work, so that is what the team
// spreads: the PD torques and joint screws per joint, the spatial
// inertias and bias forces per body, the contact points (their generalized
// forces and the foot forces summed over the lanes by shuffles, in a fixed
// order), the CRBA's joint rows, the factor's rows column by column, and
// the two triangular solves by columns with shuffles. Only the chain
// recursions stay serial, one branch of the base per lane (Chains: the two
// legs at once, every lane stepping through the same slots, so that the
// branches do not wait on each other by divergence). The env's Tree,
// factor and state sit in shared memory, a PenaltyEnv per env.
//
// The team steps are __host__ __device__ code in which, outside the device
// pass, the shuffles and syncs compile to nothing: with a team of one lane
// a host compiler builds them and the CPU tests hold them against the
// plain version. The wrapper never runs them on the host.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__
#else
#include <cmath>
#define HD
static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
#endif

#define MAX_NJ 18
#define MAX_NB (MAX_NJ + 1)
#define MAX_NV (MAX_NJ + 6)
#define MAX_FPTS 8
#define MAX_TERM 4
#define MAX_FEET 2
#define MAX_R (3 * MAX_FPTS)
#define TRI(n) ((n) * ((n) + 1) / 2)

// Mirrored field by field by humanoid_tpu_torch/ops/physics_kernel.py
// (ModelTable). Every field is 4 bytes wide, so the layout has no padding.
struct ModelTable {
  int nj, n_fpts, n_term, n_feet;
  int parent[MAX_NB];
  unsigned int anc[MAX_NB];       // bit k: joint k lies on the path base -> body b
  int fpt_body[MAX_FPTS];
  int fpt_foot[MAX_FPTS];
  int term_body[MAX_TERM];
  float joint_quat[MAX_NJ][4];    // parent frame -> joint frame
  float joint_axis[MAX_NJ][3];
  float joint_pos[MAX_NJ][3];
  float com[MAX_NB][3];
  float inertia[MAX_NB][6];       // about the COM, body frame: xx xy xz yy yz zz
  float armature[MAX_NJ];
  float damping[MAX_NJ];
  float kp[MAX_NJ];
  float kd[MAX_NJ];
  float tau_lim[MAX_NJ];
  float fpt_off[MAX_FPTS][3];
  float term_off[MAX_TERM][3];
  float term_rad[MAX_TERM];
  float gravity;                  // upward bias acceleration, -model.gravity
  float dt, kn, cn, v_reg, erp, cfm, slop;
};

// One env's tree arrays, serial work. Spatial inertias are kept compact:
// mass m, first moment h = m (com - A) and the rotational inertia Ibar
// about the base point A (xx xy xz yy yz zz); I = [[Ibar, h~], [h~^T, m 1]].
struct Tree {
  float pos[MAX_NB][3], quat[MAX_NB][4];
  float w[MAX_NJ][3], lin[MAX_NJ][3];     // joint screw S_k = [w; lin]
  float isp[MAX_NB][10], ic[MAX_NB][10];  // body and composite inertias
  float v[MAX_NB][6], a[MAX_NB][6], g[MAX_NB][6];
  float C[MAX_NV], tmp[MAX_NV], rhs[MAX_NV];
  float foot_f[MAX_FEET][3], term_f[MAX_TERM], tau[MAX_NJ];
};

// The mass-matrix factor: packed lower Cholesky factor and 1 / diagonal.
struct Factor {
  float L[TRI(MAX_NV)], invd[MAX_NV];
};

// One env's contact arrays, in shared memory on the PGS kernel: what the
// team's lanes read from one another.
struct Contact {
  float J[MAX_R][MAX_NV + 1]; // contact rows n, t1, t2; cols 3..5 hold the frame
                              // (+1: lanes reading rows side by side hit distinct banks)
  float A[TRI(MAX_R)];        // packed lower Delassus operator
  Factor F;
  float lam[MAX_R], vf[MAX_R], ufree[MAX_NV], jl[MAX_NV], phi[MAX_FPTS];
  float rel[MAX_FPTS][3];     // sole points minus the base point (prep)
  float w[MAX_NJ][3], lin[MAX_NJ][3];   // the joint screws (prep)
};

// One env's whole working set, for a host build of the per-env step.
struct Work {
  Tree t;
  Contact c;
};

HD inline int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // j <= i

HD inline void cross3(const float a[3], const float b[3], float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

HD inline float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

HD inline void qmul(const float a[4], const float b[4], float o[4]) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// v + 2w (qv x v) + 2 qv x (qv x v)
HD inline void qrot(const float q[4], const float v[3], float o[3]) {
  float c[3], c2[3];
  cross3(q + 1, v, c);
  cross3(q + 1, c, c2);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.0f * (q[0] * c[i] + c2[i]);
}

HD inline void qmat(const float q[4], float R[3][3]) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0][0] = 1 - 2 * (y * y + z * z); R[0][1] = 2 * (x * y - z * w); R[0][2] = 2 * (x * z + y * w);
  R[1][0] = 2 * (x * y + z * w); R[1][1] = 1 - 2 * (x * x + z * z); R[1][2] = 2 * (y * z - x * w);
  R[2][0] = 2 * (x * z - y * w); R[2][1] = 2 * (y * z + x * w); R[2][2] = 1 - 2 * (x * x + y * y);
}

// y = I s for a compact spatial inertia and s = [w; v]:
// top = Ibar w + h x v, bottom = m v - h x w.
HD inline void inertia_apply(const float I[10], const float s[6], float y[6]) {
  const float m = I[0], *h = I + 1;
  const float xx = I[4], xy = I[5], xz = I[6], yy = I[7], yz = I[8], zz = I[9];
  float hv[3], hw[3];
  cross3(h, s + 3, hv);
  cross3(h, s, hw);
  y[0] = xx * s[0] + xy * s[1] + xz * s[2] + hv[0];
  y[1] = xy * s[0] + yy * s[1] + yz * s[2] + hv[1];
  y[2] = xz * s[0] + yz * s[1] + zz * s[2] + hv[2];
  for (int i = 0; i < 3; ++i) y[3 + i] = m * s[3 + i] - hw[i];
}

// Forward kinematics, joint screws and compact spatial inertias.
HD void kinematics(const ModelTable& m, const float bp[3], const float bq[4],
                   const float* qj, const float* mass, const float* body, Tree& W) {
  const int nj = m.nj;
  for (int i = 0; i < 3; ++i) W.pos[0][i] = bp[i];
  for (int i = 0; i < 4; ++i) W.quat[0][i] = bq[i];
  for (int k = 0; k < nj; ++k) {
    const int p = m.parent[k + 1];
    float qf[4], qjn[4], off[3];
    qmul(W.quat[p], m.joint_quat[k], qf);
    const float half = 0.5f * qj[k];
    const float ch = cosf(half), sh = sinf(half);
    qjn[0] = ch;
    for (int i = 0; i < 3; ++i) qjn[1 + i] = m.joint_axis[k][i] * sh;
    qmul(qf, qjn, W.quat[k + 1]);
    qrot(W.quat[p], m.joint_pos[k], off);
    for (int i = 0; i < 3; ++i) W.pos[k + 1][i] = W.pos[p][i] + off[i];
  }
  const float* A = W.pos[0];
  for (int k = 0; k < nj; ++k) {
    float anchor[3];
    qrot(W.quat[k + 1], m.joint_axis[k], W.w[k]);
    for (int i = 0; i < 3; ++i) anchor[i] = W.pos[k + 1][i] - A[i];
    cross3(anchor, W.w[k], W.lin[k]);
  }
  for (int b = 0; b <= nj; ++b) {
    float R[3][3], r[3], RI[3][3], Iw[3][3];
    qmat(W.quat[b], R);
    const float* c = body ? body + 3 * b : m.com[b];
    const float* i6 = body ? body + 3 * (nj + 1) + 6 * b : m.inertia[b];
    const float Ib[3][3] = {{i6[0], i6[1], i6[2]}, {i6[1], i6[3], i6[4]}, {i6[2], i6[4], i6[5]}};
    for (int i = 0; i < 3; ++i)
      r[i] = W.pos[b][i] + R[i][0] * c[0] + R[i][1] * c[1] + R[i][2] * c[2] - A[i];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        RI[i][j] = R[i][0] * Ib[0][j] + R[i][1] * Ib[1][j] + R[i][2] * Ib[2][j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Iw[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2];
    const float mb = mass[b];
    const float rr = dot3(r, r);
    float* I = W.isp[b];
    I[0] = mb;
    for (int i = 0; i < 3; ++i) I[1 + i] = mb * r[i];
    I[4] = Iw[0][0] + mb * (rr - r[0] * r[0]);
    I[5] = Iw[0][1] - mb * r[0] * r[1];
    I[6] = Iw[0][2] - mb * r[0] * r[2];
    I[7] = Iw[1][1] + mb * (rr - r[1] * r[1]);
    I[8] = Iw[1][2] - mb * r[1] * r[2];
    I[9] = Iw[2][2] + mb * (rr - r[2] * r[2]);
  }
}

// Body velocities and the generalized bias forces C (gravity, Coriolis,
// joint damping).
HD void vel_bias(const ModelTable& m, const float* u, Tree& W) {
  const int nj = m.nj;
  for (int i = 0; i < 6; ++i) { W.v[0][i] = u[i]; W.a[0][i] = 0.0f; }
  W.a[0][5] = m.gravity;
  for (int k = 0; k < nj; ++k) {
    const int p = m.parent[k + 1];
    const float qd = u[6 + k];
    float vJ[6], aw[3], t1[3], t2[3];
    for (int i = 0; i < 3; ++i) { vJ[i] = W.w[k][i] * qd; vJ[3 + i] = W.lin[k][i] * qd; }
    float* vb = W.v[k + 1];
    for (int i = 0; i < 6; ++i) vb[i] = W.v[p][i] + vJ[i];
    cross3(vb, vJ, aw);
    cross3(vb + 3, vJ, t1);
    cross3(vb, vJ + 3, t2);
    for (int i = 0; i < 3; ++i) {
      W.a[k + 1][i] = W.a[p][i] + aw[i];
      W.a[k + 1][3 + i] = W.a[p][3 + i] + t1[i] + t2[i];
    }
  }
  for (int b = 0; b <= nj; ++b) {
    float Iv[6], Ia[6], c1[3], c2[3], c3[3];
    inertia_apply(W.isp[b], W.v[b], Iv);
    inertia_apply(W.isp[b], W.a[b], Ia);
    cross3(W.v[b], Iv, c1);
    cross3(W.v[b] + 3, Iv + 3, c2);
    cross3(W.v[b], Iv + 3, c3);
    for (int i = 0; i < 3; ++i) {
      W.g[b][i] = Ia[i] + c1[i] + c2[i];
      W.g[b][3 + i] = Ia[3 + i] + c3[i];
    }
  }
  for (int b = nj; b > 0; --b) {
    const int p = m.parent[b];
    for (int i = 0; i < 6; ++i) W.g[p][i] += W.g[b][i];
  }
  for (int i = 0; i < 6; ++i) W.C[i] = W.g[0][i];
  for (int k = 0; k < nj; ++k)
    W.C[6 + k] = dot3(W.w[k], W.g[k + 1]) + dot3(W.lin[k], W.g[k + 1] + 3) +
                 m.damping[k] * u[6 + k];
}

// CRBA mass matrix into F.L (packed lower), factored in place.
HD void crba_chol(const ModelTable& m, Tree& W, Factor& F) {
  const int nj = m.nj, nv = nj + 6;
  for (int b = 0; b <= nj; ++b)
    for (int i = 0; i < 10; ++i) W.ic[b][i] = W.isp[b][i];
  for (int b = nj; b > 0; --b) {
    const int p = m.parent[b];
    for (int i = 0; i < 10; ++i) W.ic[p][i] += W.ic[b][i];
  }
  // base block: the composite inertia of the whole robot
  const float* I0 = W.ic[0];
  const float* h = I0 + 1;
  const float Ibar[3][3] = {{I0[4], I0[5], I0[6]}, {I0[5], I0[7], I0[8]}, {I0[6], I0[8], I0[9]}};
  const float hx[3][3] = {{0.0f, -h[2], h[1]}, {h[2], 0.0f, -h[0]}, {-h[1], h[0], 0.0f}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j <= i; ++j) {
      F.L[tri(i, j)] = Ibar[i][j];
      F.L[tri(3 + i, 3 + j)] = i == j ? I0[0] : 0.0f;
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) F.L[tri(3 + i, j)] = hx[j][i];   // (h~)^T
  // joint rows: f = IC_(body k+1) S_k
  for (int k = 0; k < nj; ++k) {
    float S[6], f[6];
    for (int i = 0; i < 3; ++i) { S[i] = W.w[k][i]; S[3 + i] = W.lin[k][i]; }
    inertia_apply(W.ic[k + 1], S, f);
    const int i = 6 + k;
    for (int j = 0; j < 6; ++j) F.L[tri(i, j)] = f[j];
    const unsigned int anc = m.anc[k + 1];
    for (int b = 0; b <= k; ++b) {
      float val = 0.0f;
      if ((anc >> b) & 1u)
        val = dot3(W.w[b], f) + dot3(W.lin[b], f + 3);
      F.L[tri(i, 6 + b)] = val;
    }
    F.L[tri(i, i)] += m.armature[k];
  }
  // dense left-looking Cholesky, in place
  for (int j = 0; j < nv; ++j) {
    float s = F.L[tri(j, j)];
    for (int k = 0; k < j; ++k) s -= F.L[tri(j, k)] * F.L[tri(j, k)];
    const float iv = rsqrtf(s);
    F.invd[j] = iv;
    F.L[tri(j, j)] = s * iv;
    for (int i = j + 1; i < nv; ++i) {
      float t = F.L[tri(i, j)];
      for (int k = 0; k < j; ++k) t -= F.L[tri(i, k)] * F.L[tri(j, k)];
      F.L[tri(i, j)] = t * iv;
    }
  }
}

// x = M^-1 b with the packed factor; x may alias b.
HD void chol_solve(const Factor& F, int nv, const float* b, float* x) {
  for (int i = 0; i < nv; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= F.L[tri(i, k)] * x[k];
    x[i] = s * F.invd[i];
  }
  for (int i = nv - 1; i >= 0; --i) {
    float s = x[i];
    for (int k = i + 1; k < nv; ++k) s -= F.L[tri(k, i)] * x[k];
    x[i] = s * F.invd[i];
  }
}

HD inline void point_world(const Tree& W, int b, const float off[3],
                           float p[3]) {
  float o[3];
  qrot(W.quat[b], off, o);
  for (int i = 0; i < 3; ++i) p[i] = W.pos[b][i] + o[i];
}

// Unit normal of the plane [c0, gx, gy] and 1/|(-gx, -gy, 1)|.
HD inline float plane_normal(const float* pl, float n[3]) {
  const float inv_l = rsqrtf(1.0f + pl[1] * pl[1] + pl[2] * pl[2]);
  n[0] = -pl[1] * inv_l;
  n[1] = -pl[2] * inv_l;
  n[2] = inv_l;
  return inv_l;
}

// Gap of world point p along the normal of plane pl (z on the flat plane).
HD inline float plane_gap(const float* pl, const float p[3]) {
  if (!pl) return p[2];
  float n[3];
  const float inv_l = plane_normal(pl, n);
  return (p[2] - (pl[0] + pl[1] * p[0] + pl[2] * p[1])) * inv_l;
}

// Penalty force f on world point p of body b (spring-damper normal force,
// regularized Coulomb friction) against the plane pl, or the plane z = 0
// with a vertical force when pl is null, and its moment
// nm = (p - base point) x f; returns the normal force.
HD float point_force(const ModelTable& m, const Tree& W, int b, const float p[3], const float* pl,
                     float mu, float f[3], float nm[3]) {
  float rel[3], wr[3], vl[3];
  for (int i = 0; i < 3; ++i) rel[i] = p[i] - W.pos[0][i];
  cross3(W.v[b], rel, wr);
  for (int i = 0; i < 3; ++i) vl[i] = W.v[b][3 + i] + wr[i];
  float fn;
  if (pl) {
    // normal-aligned penalty against the point's plane
    float nrm[3], vt[3];
    const float inv_l = plane_normal(pl, nrm);
    const float phi = (p[2] - (pl[0] + pl[1] * p[0] + pl[2] * p[1])) * inv_l;
    const float pen = phi < 0.0f ? 1.0f : 0.0f;
    const float vn = dot3(vl, nrm);
    fn = fmaxf(0.0f, -m.kn * phi - m.cn * vn) * pen;
    for (int i = 0; i < 3; ++i) vt[i] = vl[i] - vn * nrm[i];
    const float speed = sqrtf(dot3(vt, vt) + m.v_reg * m.v_reg);
    const float scale = mu * fn / speed;
    for (int i = 0; i < 3; ++i) f[i] = fn * nrm[i] - scale * vt[i];
  } else {
    const float pen = p[2] < 0.0f ? 1.0f : 0.0f;
    fn = fmaxf(0.0f, -m.kn * p[2] - m.cn * vl[2]) * pen;
    const float speed = sqrtf(vl[0] * vl[0] + vl[1] * vl[1] + m.v_reg * m.v_reg);
    const float scale = mu * fn / speed;
    f[0] = -scale * vl[0]; f[1] = -scale * vl[1]; f[2] = fn;
  }
  cross3(rel, f, nm);
  return fn;
}

// point_force's force f on world point p of body b; adds its generalized
// force to W.rhs and returns the normal force.
HD float penalty_point(const ModelTable& m, Tree& W, int b, const float p[3], const float* pl,
                       float mu, float f[3]) {
  float nm[3];
  const float fn = point_force(m, W, b, p, pl, mu, f, nm);
  for (int i = 0; i < 3; ++i) { W.rhs[i] += nm[i]; W.rhs[3 + i] += f[i]; }
  const unsigned int anc = m.anc[b];
  for (int k = 0; k < m.nj; ++k)
    if ((anc >> k) & 1u) W.rhs[6 + k] += dot3(nm, W.w[k]) + dot3(f, W.lin[k]);
  return fn;
}

// The new velocity unew into the state: position, the quaternion
// exponential map, joint angles.
HD void integrate(int nj, float dt, const float* unew, float bp[3], float bq[4], float* qj,
                  float* u) {
  const int nv = nj + 6;
  for (int i = 0; i < 3; ++i) bp[i] += dt * unew[3 + i];
  float om[3] = {unew[0] * dt, unew[1] * dt, unew[2] * dt};
  const float ang = sqrtf(dot3(om, om));
  const float half = 0.5f * ang;
  const bool small = ang < 1e-8f;
  const float kfac = small ? 0.5f : sinf(half) / ang;
  const float dq[4] = {cosf(half), om[0] * kfac, om[1] * kfac, om[2] * kfac};
  float qn[4];
  qmul(dq, bq, qn);
  const float nrm = rsqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3] + 1e-12f);
  for (int i = 0; i < 4; ++i) bq[i] = qn[i] * nrm;
  for (int k = 0; k < nj; ++k) qj[k] += dt * unew[6 + k];
  for (int i = 0; i < nv; ++i) u[i] = unew[i];
}

// This env's optional inputs (see the top of the file), or null pointers.
struct EnvExtras {
  const float* gains;
  const float* body;
  const float* planes;
};

// Env n's rows of the optional inputs, or null pointers.
HD inline EnvExtras env_extras(const ModelTable& m, int n, const float* gains, const float* body,
                               const float* planes) {
  const int nj = m.nj, nb = nj + 1;
  return EnvExtras{gains ? gains + static_cast<long long>(n) * 3 * nj : nullptr,
                   body ? body + static_cast<long long>(n) * 9 * nb : nullptr,
                   planes ? planes + static_cast<long long>(n) * 3 * (m.n_fpts + m.n_term)
                          : nullptr};
}

// Env n's state rows [pos 3, quat 4, qj nj, u nv], masses and targets.
HD void load_env(const ModelTable& m, int n, int N, const float* state, const float* masses,
                 const float* targets, float bp[3], float bq[4], float* qj, float* u,
                 float* mass, float* tgt) {
  const int nj = m.nj, nb = nj + 1, nv = nj + 6;
  for (int i = 0; i < 3; ++i) bp[i] = state[i * N + n];
  for (int i = 0; i < 4; ++i) bq[i] = state[(3 + i) * N + n];
  for (int k = 0; k < nj; ++k) qj[k] = state[(7 + k) * N + n];
  for (int i = 0; i < nv; ++i) u[i] = state[(7 + nj + i) * N + n];
  for (int b = 0; b < nb; ++b) mass[b] = masses[n * nb + b];
  for (int k = 0; k < nj; ++k) tgt[k] = targets[n * nj + k];
}

// Env n's new state and the diagnostics: body pos (3 nb), body quat (4 nb),
// body omega (3 nb), foot forces (3 n_feet), termination forces (n_term),
// torques (nj).
HD void store_env(const ModelTable& m, int n, int N, const float bp[3], const float bq[4],
                  const float* qj, const float* u, const Tree& W, float* state_out,
                  float* diag) {
  const int nj = m.nj, nb = nj + 1, nv = nj + 6;
  int row = 0;
  for (int i = 0; i < 3; ++i) state_out[(row++) * N + n] = bp[i];
  for (int i = 0; i < 4; ++i) state_out[(row++) * N + n] = bq[i];
  for (int k = 0; k < nj; ++k) state_out[(row++) * N + n] = qj[k];
  for (int i = 0; i < nv; ++i) state_out[(row++) * N + n] = u[i];
  row = 0;
  for (int b = 0; b < nb; ++b)
    for (int i = 0; i < 3; ++i) diag[(row++) * N + n] = W.pos[b][i];
  for (int b = 0; b < nb; ++b)
    for (int i = 0; i < 4; ++i) diag[(row++) * N + n] = W.quat[b][i];
  for (int b = 0; b < nb; ++b)
    for (int i = 0; i < 3; ++i) diag[(row++) * N + n] = W.v[b][i];
  for (int f = 0; f < m.n_feet; ++f)
    for (int i = 0; i < 3; ++i) diag[(row++) * N + n] = W.foot_f[f][i];
  for (int s = 0; s < m.n_term; ++s) diag[(row++) * N + n] = W.term_f[s];
  for (int k = 0; k < nj; ++k) diag[(row++) * N + n] = W.tau[k];
}

// The serial head of a substep: PD torque, kinematics, the velocity/bias
// recursion, the factor (with `factor`), the termination spheres' penalty
// forces and the free acceleration W.tmp = M^-1 (tau + penalty forces - C).
HD void substep_head(const ModelTable& m, const float bp[3], const float bq[4], const float* qj,
                     const float* u, const float* mass, float mu, const float* targets,
                     const EnvExtras& x, bool factor, Tree& W, Factor& F) {
  const int nj = m.nj, nv = nj + 6, K = m.n_fpts;
  for (int k = 0; k < nj; ++k) {
    float t;
    if (x.gains)
      t = (x.gains[k] * (targets[k] - qj[k]) - x.gains[nj + k] * u[6 + k]) * x.gains[2 * nj + k];
    else
      t = m.kp[k] * (targets[k] - qj[k]) - m.kd[k] * u[6 + k];
    W.tau[k] = fminf(fmaxf(t, -m.tau_lim[k]), m.tau_lim[k]);
  }
  kinematics(m, bp, bq, qj, mass, x.body, W);
  vel_bias(m, u, W);
  if (factor) crba_chol(m, W, F);
  for (int i = 0; i < nv; ++i) W.rhs[i] = 0.0f;
  for (int s = 0; s < m.n_term; ++s) {
    float p[3], f[3];
    point_world(W, m.term_body[s], m.term_off[s], p);
    p[2] -= m.term_rad[s];
    W.term_f[s] = penalty_point(m, W, m.term_body[s], p,
                                x.planes ? x.planes + 3 * (K + s) : nullptr, mu, f);
  }
  for (int k = 0; k < nj; ++k) W.rhs[6 + k] += W.tau[k];
  for (int i = 0; i < nv; ++i) W.rhs[i] -= W.C[i];
  chol_solve(F, nv, W.rhs, W.tmp);
}

// ---------------------------------------------------------------------------
// The PGS instances: a team of T lanes per env. Lane 0 runs the serial tree
// work in its own Tree; the team shares the env's Contact. Every lane of a
// team, a tail team's too, takes the same path through the syncs.

#ifdef __CUDA_ARCH__
#define TEAM_SYNC(mask) __syncwarp(mask)
#else
#define TEAM_SYNC(mask) ((void)(mask))
#endif

// A lane of a team: its index in the team, the warp lanes of the team
// (mask), and where they sit. The teams of a block interleave: lane j of
// team t is warp lane t + j * step, so that the teams' lanes 0, which run
// the serial work, sit side by side and their local-memory accesses fall
// into one sector.
struct Team {
  int lane;
  unsigned mask;
  int first, step;
};

// The sum of v over the team's lanes, on every lane (off the device a team
// has one lane).
template <int T>
HD inline float team_sum(float v, const Team& tm) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int o = T / 2; o > 0; o >>= 1)
    v += __shfl_sync(tm.mask, v, tm.first + (tm.lane ^ o) * tm.step);
#else
  (void)tm;
#endif
  return v;
}

HD inline float amat(const Contact& S, int i, int j) {
  return i >= j ? S.A[tri(i, j)] : S.A[tri(j, i)];
}

// The contact frame of a sole point: n = z, t1 = x, t2 = y on the flat
// plane; on a plane pl, its normal and the branchless tangent basis of the
// reference kernel (t1 = n x (x or y axis), normalized; t2 = n x t1).
HD inline void contact_frame(const float* pl, float fr[3][3]) {
  if (pl) {
    plane_normal(pl, fr[0]);
    const float ux = fabsf(fr[0][0]) < 0.9f ? 1.0f : 0.0f;
    const float a[3] = {ux, 1.0f - ux, 0.0f};
    cross3(fr[0], a, fr[1]);
    const float it1 = rsqrtf(dot3(fr[1], fr[1]) + 1e-12f);
    for (int i = 0; i < 3; ++i) fr[1][i] *= it1;
    cross3(fr[0], fr[1], fr[2]);
  } else {
    for (int d = 0; d < 3; ++d)
      for (int i = 0; i < 3; ++i) fr[d][i] = 0.0f;
    fr[0][2] = fr[1][0] = fr[2][1] = 1.0f;
  }
}

// Lane 0's part of the contact setup: each sole point's gap along its
// plane's normal (fresh every substep) and, when the prep is rebuilt, what
// the team's row work reads of the tree: the points' offsets from the base
// point and the joint screws.
HD void publish_points(const ModelTable& m, const Tree& W, const float* planes, bool prep,
                       Contact& S) {
  for (int c = 0; c < m.n_fpts; ++c) {
    float p[3];
    point_world(W, m.fpt_body[c], m.fpt_off[c], p);
    S.phi[c] = plane_gap(planes ? planes + 3 * c : nullptr, p);
    if (prep)
      for (int i = 0; i < 3; ++i) S.rel[c][i] = p[i] - W.pos[0][i];
  }
  if (prep)
    for (int k = 0; k < m.nj; ++k)
      for (int i = 0; i < 3; ++i) {
        S.w[k][i] = W.w[k][i];
        S.lin[k][i] = W.lin[k][i];
      }
}

// Contact rows and the Delassus operator A = J M^-1 J^T across the team:
// row r of J on lane r mod T (its point's frame recomputed there), then
// that lane's column solve M^-1 J_r^T and row r of the packed lower A.
template <int T>
HD void team_prepare(const ModelTable& m, const Team& tm, const float* planes, Contact& S) {
  const int nj = m.nj, nv = nj + 6, R = 3 * m.n_fpts;
  for (int r = tm.lane; r < R; r += T) {
    const int c = r / 3, d = r - 3 * c;
    const unsigned int anc = m.anc[m.fpt_body[c]];
    const float* rel = S.rel[c];
    float fr[3][3];
    contact_frame(planes ? planes + 3 * c : nullptr, fr);
    const float* e = fr[d];
    float* row = S.J[r];
    cross3(rel, e, row);
    for (int i = 0; i < 3; ++i) row[3 + i] = e[i];
    for (int k = 0; k < nj; ++k) {
      float val = 0.0f;
      if ((anc >> k) & 1u) {
        float wxr[3];
        cross3(S.w[k], rel, wxr);
        val = dot3(e, S.lin[k]) + dot3(e, wxr);
      }
      row[6 + k] = val;
    }
  }
  TEAM_SYNC(tm.mask);
  for (int c = tm.lane; c < R; c += T) {
    float x[MAX_NV];
    chol_solve(S.F, nv, S.J[c], x);
    for (int r = 0; r <= c; ++r) {
      float s = 0.0f;
      for (int i = 0; i < nv; ++i) s += S.J[r][i] * x[i];
      S.A[tri(c, r)] = s;
    }
  }
  TEAM_SYNC(tm.mask);
}

// One PGS substep of the team's env; `prep` rebuilds the contact rows and
// Delassus operator, `factor` the mass-matrix factor.
template <int T, bool WARM>
HD void team_substep(const ModelTable& m, const Team& tm, float bp[3], float bq[4],
                     float* qj, float* u, const float* mass, float mu, const float* targets,
                     const EnvExtras& x, bool factor, bool prep, int iterations, Tree& W,
                     Contact& S) {
  const int nj = m.nj, nv = nj + 6, K = m.n_fpts, R = 3 * K;
  const float dt = m.dt;
  if (tm.lane == 0) {
    substep_head(m, bp, bq, qj, u, mass, mu, targets, x, factor, W, S.F);
    for (int i = 0; i < nv; ++i) S.ufree[i] = u[i] + dt * W.tmp[i];
    publish_points(m, W, x.planes, prep, S);
  }
  TEAM_SYNC(tm.mask);
  if (prep) team_prepare<T>(m, tm, x.planes, S);

  // the free row velocities; the cold sweep starts from zero impulses, the
  // warm one from the carried S.lam
  for (int r = tm.lane; r < R; r += T) {
    float s = 0.0f;
    for (int i = 0; i < nv; ++i) s += S.J[r][i] * S.ufree[i];
    S.vf[r] = s;
    if (!WARM) S.lam[r] = 0.0f;
  }
  TEAM_SYNC(tm.mask);
  for (int it = 0; it < iterations; ++it) {
    for (int k = 0; k < K; ++k) {
      const int i0 = 3 * k;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      for (int c = tm.lane; c < R; c += T) {
        const float l = S.lam[c];
        s0 += amat(S, i0, c) * l;
        s1 += amat(S, i0 + 1, c) * l;
        s2 += amat(S, i0 + 2, c) * l;
      }
      const float vrow[3] = {S.vf[i0] + team_sum<T>(s0, tm),
                             S.vf[i0 + 1] + team_sum<T>(s1, tm),
                             S.vf[i0 + 2] + team_sum<T>(s2, tm)};
      // every tm.lane updates point k from the reduced row velocities
      const float phi = S.phi[k];
      const float act = phi < 0.0f ? 1.0f : 0.0f;
      const float bias = -(m.erp / dt) * fmaxf(-phi - m.slop, 0.0f);
      const float Ann = amat(S, i0, i0);
      const float gam = m.cfm * Ann;
      const float ln = S.lam[i0], lt1_0 = S.lam[i0 + 1], lt2_0 = S.lam[i0 + 2];
      const float ln_new = fmaxf(0.0f, ln - (vrow[0] + bias + gam * ln) / (Ann + gam)) * act;
      const float dln = ln_new - ln;
      const float vt1 = vrow[1] + amat(S, i0 + 1, i0) * dln;
      const float vt2 = vrow[2] + amat(S, i0 + 2, i0) * dln;
      const float a11 = amat(S, i0 + 1, i0 + 1) + gam;
      const float a22 = amat(S, i0 + 2, i0 + 2) + gam;
      const float a12 = amat(S, i0 + 1, i0 + 2);
      const float det = a11 * a22 - a12 * a12;
      const float r1 = vt1 + gam * lt1_0;
      const float r2 = vt2 + gam * lt2_0;
      const float lt1 = lt1_0 - (a22 * r1 - a12 * r2) / det;
      const float lt2 = lt2_0 - (a11 * r2 - a12 * r1) / det;
      const float tn = sqrtf(lt1 * lt1 + lt2 * lt2 + 1e-12f);
      const float sc = fminf(1.0f, mu * ln_new / tn) * act;
      TEAM_SYNC(tm.mask);   // every tm.lane has read point k's impulses ...
      if (tm.lane == 0) {
        S.lam[i0] = ln_new;
        S.lam[i0 + 1] = lt1 * sc;
        S.lam[i0 + 2] = lt2 * sc;
      }
      TEAM_SYNC(tm.mask);   // ... and reads the new ones from point k + 1 on
    }
  }
  // u+ = u_free + M^-1 J^T lam: the impulse map, a column per tm.lane
  for (int i = tm.lane; i < nv; i += T) {
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s += S.J[r][i] * S.lam[r];
    S.jl[i] = s;
  }
  TEAM_SYNC(tm.mask);
  if (tm.lane == 0) {
    chol_solve(S.F, nv, S.jl, W.tmp);
    for (int f = 0; f < m.n_feet; ++f)
      for (int i = 0; i < 3; ++i) W.foot_f[f][i] = 0.0f;
    for (int k = 0; k < K; ++k) {   // world force: frame^T lam / dt
      float* ff = W.foot_f[m.fpt_foot[k]];
      const float* lam = S.lam + 3 * k;
      if (x.planes) {
        for (int i = 0; i < 3; ++i)
          ff[i] += (S.J[3 * k][3 + i] * lam[0] + S.J[3 * k + 1][3 + i] * lam[1] +
                    S.J[3 * k + 2][3 + i] * lam[2]) / dt;
      } else {   // flat frame: n = z, t1 = x, t2 = y
        ff[0] += lam[1] / dt;
        ff[1] += lam[2] / dt;
        ff[2] += lam[0] / dt;
      }
    }
    // integrate: spatial -> conventional correction with the old velocity,
    // then semi-implicit Euler
    float corr[3], unew[MAX_NV];
    cross3(u, u + 3, corr);
    for (int i = 0; i < nv; ++i) unew[i] = S.ufree[i] + W.tmp[i];
    for (int i = 0; i < 3; ++i) unew[3 + i] += dt * corr[i];
    integrate(nj, dt, unew, bp, bq, qj, u);
  }
}

// A whole PGS control step for the team's env n; a tail team (n >= N)
// runs env N - 1 and writes nothing.
template <int T, bool WARM>
HD void team_control_step(const ModelTable& m, const Team& tm, int n, int N,
                          const float* state, const float* masses, const float* friction,
                          const float* targets, const float* gains, const float* body,
                          const float* planes, float* state_out, float* diag, int decimation,
                          bool freeze, bool freeze_prep, int iterations, Tree& W, Contact& S) {
  const int ne = n < N ? n : N - 1;
  const EnvExtras x = env_extras(m, ne, gains, body, planes);
  float bp[3], bq[4], qj[MAX_NJ], u[MAX_NV], mass[MAX_NB], tgt[MAX_NJ];
  if (tm.lane == 0) load_env(m, ne, N, state, masses, targets, bp, bq, qj, u, mass, tgt);
  const float mu = friction[ne];
  const bool frozen_prep = freeze && freeze_prep;
  if (freeze) {
    if (tm.lane == 0) {
      kinematics(m, bp, bq, qj, mass, x.body, W);
      crba_chol(m, W, S.F);
      if (frozen_prep) publish_points(m, W, x.planes, true, S);
    }
    TEAM_SYNC(tm.mask);
    if (frozen_prep) team_prepare<T>(m, tm, x.planes, S);
  }
  if (WARM)   // the carry starts at zero; the first substep syncs before reading it
    for (int r = tm.lane; r < 3 * m.n_fpts; r += T) S.lam[r] = 0.0f;
  for (int s = 0; s < decimation; ++s)
    team_substep<T, WARM>(m, tm, bp, bq, qj, u, mass, mu, tgt, x, !freeze, !frozen_prep,
                          iterations, W, S);
  if (tm.lane == 0 && n < N) store_env(m, n, N, bp, bq, qj, u, W, state_out, diag);
}

// ---------------------------------------------------------------------------
// The penalty instance: a team of T lanes per env, its Tree, factor and
// state in one PenaltyEnv in shared memory. The work of a substep is
// spread over the team by joint, body, contact point and row of the
// factor; only the chain recursions (the forward pose and velocity chains,
// the backward composite and bias sums) stay serial, one branch of the
// base per lane (`Chains`). Every lane of a team, a tail team's too,
// takes the same path through the syncs and shuffles.

struct PenaltyEnv {
  Tree t;
  Factor f;
  float bp[3], bq[4], qj[MAX_NJ], u[MAX_NV];   // the env's state
};

// The chain recursions' schedule for a team of T lanes: the branches of
// the base (the subtrees of its children) go to the lanes in turn, and lane
// l runs joints joint[l][0 .. len[l]) in ascending order. Every lane steps
// through the same `steps` slots, so that the lanes run their chains side
// by side (one leg each on a biped), not one after another.
template <int T>
struct Chains {
  int steps;
  unsigned char len[T];
  unsigned char joint[T][MAX_NJ];
};

template <int T>
HD inline void make_chains(const ModelTable& m, Chains<T>& ch) {
  int lane_of[MAX_NB], roots = 0;
  for (int l = 0; l < T; ++l) ch.len[l] = 0;
  for (int b = 1; b <= m.nj; ++b) {
    const int p = m.parent[b];
    const int l = lane_of[b] = p == 0 ? roots++ % T : lane_of[p];
    ch.joint[l][ch.len[l]++] = b - 1;
  }
  ch.steps = 0;
  for (int l = 0; l < T; ++l) ch.steps = ch.len[l] > ch.steps ? ch.len[l] : ch.steps;
}

// v of the team's lane `src`, on every lane (off the device a team has one
// lane).
HD inline float team_from(float v, int src, const Team& tm) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(tm.mask, v, tm.first + src * tm.step);
#else
  (void)src;
  (void)tm;
  return v;
#endif
}

// State row r of the pack [pos 3, quat 4, qj nj, u nv].
HD inline float& state_row(PenaltyEnv& P, int nj, int r) {
  return r < 3 ? P.bp[r] : r < 7 ? P.bq[r - 3] : r < 7 + nj ? P.qj[r - 7] : P.u[r - 7 - nj];
}

// Diagnostics row r (store_env's order).
HD inline float diag_row(const ModelTable& m, const Tree& W, int r) {
  const int nb = m.nj + 1;
  if (r < 3 * nb) return W.pos[r / 3][r % 3];
  r -= 3 * nb;
  if (r < 4 * nb) return W.quat[r / 4][r % 4];
  r -= 4 * nb;
  if (r < 3 * nb) return W.v[r / 3][r % 3];
  r -= 3 * nb;
  if (r < 3 * m.n_feet) return W.foot_f[r / 3][r % 3];
  r -= 3 * m.n_feet;
  if (r < m.n_term) return W.term_f[r];
  return W.tau[r - m.n_term];
}

// Kinematics across the team: the pose chains per branch (a lane keeps the
// last body it posed in registers, the parent of its next joint on a
// chain), then the joint screws per joint and the spatial inertias per body
// (kinematics' arithmetic).
template <int T>
HD void team_kinematics(const ModelTable& m, const Team& tm, const Chains<T>& ch,
                        const float* mass, const float* body, PenaltyEnv& P) {
  const int nj = m.nj;
  Tree& W = P.t;
  if (tm.lane == 0) {
    for (int i = 0; i < 3; ++i) W.pos[0][i] = P.bp[i];
    for (int i = 0; i < 4; ++i) W.quat[0][i] = P.bq[i];
  }
  TEAM_SYNC(tm.mask);
  float cq[4], cp[3];
  int last = -1;
  for (int s = 0; s < ch.steps; ++s) {
    if (s >= ch.len[tm.lane]) continue;
    const int k = ch.joint[tm.lane][s];
    const int p = m.parent[k + 1];
    if (p != last) {
      for (int i = 0; i < 4; ++i) cq[i] = W.quat[p][i];
      for (int i = 0; i < 3; ++i) cp[i] = W.pos[p][i];
    }
    float qf[4], qjn[4], off[3], q[4];
    qmul(cq, m.joint_quat[k], qf);
    const float half = 0.5f * P.qj[k];
    float c, sh;
    sincosf(half, &sh, &c);
    qjn[0] = c;
    for (int i = 0; i < 3; ++i) qjn[1 + i] = m.joint_axis[k][i] * sh;
    qmul(qf, qjn, q);
    qrot(cq, m.joint_pos[k], off);
    for (int i = 0; i < 3; ++i) W.pos[k + 1][i] = cp[i] = cp[i] + off[i];
    for (int i = 0; i < 4; ++i) W.quat[k + 1][i] = cq[i] = q[i];
    last = k + 1;
  }
  TEAM_SYNC(tm.mask);
  const float* A = W.pos[0];
  for (int k = tm.lane; k < nj; k += T) {
    float anchor[3];
    qrot(W.quat[k + 1], m.joint_axis[k], W.w[k]);
    for (int i = 0; i < 3; ++i) anchor[i] = W.pos[k + 1][i] - A[i];
    cross3(anchor, W.w[k], W.lin[k]);
  }
  for (int b = tm.lane; b <= nj; b += T) {
    float R[3][3], r[3], RI[3][3], Iw[3][3];
    qmat(W.quat[b], R);
    const float* c = body ? body + 3 * b : m.com[b];
    const float* i6 = body ? body + 3 * (nj + 1) + 6 * b : m.inertia[b];
    const float Ib[3][3] = {{i6[0], i6[1], i6[2]}, {i6[1], i6[3], i6[4]}, {i6[2], i6[4], i6[5]}};
    for (int i = 0; i < 3; ++i)
      r[i] = W.pos[b][i] + R[i][0] * c[0] + R[i][1] * c[1] + R[i][2] * c[2] - A[i];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        RI[i][j] = R[i][0] * Ib[0][j] + R[i][1] * Ib[1][j] + R[i][2] * Ib[2][j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Iw[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2];
    const float mb = mass[b];
    const float rr = dot3(r, r);
    float* I = W.isp[b];
    I[0] = mb;
    for (int i = 0; i < 3; ++i) I[1 + i] = mb * r[i];
    I[4] = Iw[0][0] + mb * (rr - r[0] * r[0]);
    I[5] = Iw[0][1] - mb * r[0] * r[1];
    I[6] = Iw[0][2] - mb * r[0] * r[2];
    I[7] = Iw[1][1] + mb * (rr - r[1] * r[1]);
    I[8] = Iw[1][2] - mb * r[1] * r[2];
    I[9] = Iw[2][2] + mb * (rr - r[2] * r[2]);
  }
  TEAM_SYNC(tm.mask);
}

// x[b] (width `w` floats each, b = 0..nj) summed into the parents, leaves
// first, in vel_bias' order: each branch on its lane, then the branches'
// roots into the base on lane 0.
template <int T>
HD void team_to_parents(const ModelTable& m, const Team& tm, const Chains<T>& ch, float* x,
                        int w) {
  for (int s = ch.steps - 1; s >= 0; --s) {
    if (s >= ch.len[tm.lane]) continue;
    const int b = ch.joint[tm.lane][s] + 1, p = m.parent[b];
    if (p != 0)
      for (int i = 0; i < w; ++i) x[p * w + i] += x[b * w + i];
  }
  TEAM_SYNC(tm.mask);
  if (tm.lane == 0)
    for (int b = m.nj; b > 0; --b)
      if (m.parent[b] == 0)
        for (int i = 0; i < w; ++i) x[i] += x[b * w + i];
  TEAM_SYNC(tm.mask);
}

// Body velocities and the bias forces C across the team (vel_bias'
// arithmetic): the velocity chains per branch, the bias force per body,
// the sums into the parents, C per joint.
template <int T>
HD void team_vel_bias(const ModelTable& m, const Team& tm, const Chains<T>& ch, PenaltyEnv& P) {
  const int nj = m.nj;
  Tree& W = P.t;
  const float* u = P.u;
  if (tm.lane == 0) {
    for (int i = 0; i < 6; ++i) { W.v[0][i] = u[i]; W.a[0][i] = 0.0f; }
    W.a[0][5] = m.gravity;
  }
  TEAM_SYNC(tm.mask);
  float cv[6], ca[6];   // the last body of the lane's chain, as in team_kinematics
  int last = -1;
  for (int s = 0; s < ch.steps; ++s) {
    if (s >= ch.len[tm.lane]) continue;
    const int k = ch.joint[tm.lane][s];
    const int p = m.parent[k + 1];
    if (p != last)
      for (int i = 0; i < 6; ++i) { cv[i] = W.v[p][i]; ca[i] = W.a[p][i]; }
    const float qd = u[6 + k];
    float vJ[6], aw[3], t1[3], t2[3];
    for (int i = 0; i < 3; ++i) { vJ[i] = W.w[k][i] * qd; vJ[3 + i] = W.lin[k][i] * qd; }
    for (int i = 0; i < 6; ++i) cv[i] += vJ[i];
    cross3(cv, vJ, aw);
    cross3(cv + 3, vJ, t1);
    cross3(cv, vJ + 3, t2);
    for (int i = 0; i < 3; ++i) {
      ca[i] += aw[i];
      ca[3 + i] = ca[3 + i] + t1[i] + t2[i];
    }
    for (int i = 0; i < 6; ++i) { W.v[k + 1][i] = cv[i]; W.a[k + 1][i] = ca[i]; }
    last = k + 1;
  }
  TEAM_SYNC(tm.mask);
  for (int b = tm.lane; b <= nj; b += T) {
    float Iv[6], Ia[6], c1[3], c2[3], c3[3];
    inertia_apply(W.isp[b], W.v[b], Iv);
    inertia_apply(W.isp[b], W.a[b], Ia);
    cross3(W.v[b], Iv, c1);
    cross3(W.v[b] + 3, Iv + 3, c2);
    cross3(W.v[b], Iv + 3, c3);
    for (int i = 0; i < 3; ++i) {
      W.g[b][i] = Ia[i] + c1[i] + c2[i];
      W.g[b][3 + i] = Ia[3 + i] + c3[i];
    }
  }
  TEAM_SYNC(tm.mask);
  team_to_parents<T>(m, tm, ch, &W.g[0][0], 6);
  if (tm.lane == 0)
    for (int i = 0; i < 6; ++i) W.C[i] = W.g[0][i];
  for (int k = tm.lane; k < nj; k += T)
    W.C[6 + k] = dot3(W.w[k], W.g[k + 1]) + dot3(W.lin[k], W.g[k + 1] + 3) +
                 m.damping[k] * u[6 + k];
  TEAM_SYNC(tm.mask);
}

// The CRBA mass matrix into P.f.L across the team (crba_chol's arithmetic:
// the composite inertias, the base block on lane 0, the joint rows per
// joint), then the left-looking Cholesky factor by columns, lane l owning
// rows l, l + T, ...; the pivot of column j comes from row j's lane.
template <int T>
HD void team_crba_chol(const ModelTable& m, const Team& tm, const Chains<T>& ch, PenaltyEnv& P) {
  const int nj = m.nj, nv = nj + 6;
  Tree& W = P.t;
  Factor& F = P.f;
  for (int b = tm.lane; b <= nj; b += T)
    for (int i = 0; i < 10; ++i) W.ic[b][i] = W.isp[b][i];
  TEAM_SYNC(tm.mask);
  team_to_parents<T>(m, tm, ch, &W.ic[0][0], 10);
  if (tm.lane == 0) {
    const float* I0 = W.ic[0];
    const float* h = I0 + 1;
    const float Ibar[3][3] = {{I0[4], I0[5], I0[6]}, {I0[5], I0[7], I0[8]}, {I0[6], I0[8], I0[9]}};
    const float hx[3][3] = {{0.0f, -h[2], h[1]}, {h[2], 0.0f, -h[0]}, {-h[1], h[0], 0.0f}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j <= i; ++j) {
        F.L[tri(i, j)] = Ibar[i][j];
        F.L[tri(3 + i, 3 + j)] = i == j ? I0[0] : 0.0f;
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) F.L[tri(3 + i, j)] = hx[j][i];   // (h~)^T
  }
  for (int k = tm.lane; k < nj; k += T) {
    float S[6], f[6];
    for (int i = 0; i < 3; ++i) { S[i] = W.w[k][i]; S[3 + i] = W.lin[k][i]; }
    inertia_apply(W.ic[k + 1], S, f);
    const int i = 6 + k;
    for (int j = 0; j < 6; ++j) F.L[tri(i, j)] = f[j];
    const unsigned int anc = m.anc[k + 1];
    for (int b = 0; b <= k; ++b) {
      float val = 0.0f;
      if ((anc >> b) & 1u)
        val = dot3(W.w[b], f) + dot3(W.lin[b], f + 3);
      F.L[tri(i, 6 + b)] = val;
    }
    F.L[tri(i, i)] += m.armature[k];
  }
  TEAM_SYNC(tm.mask);
  constexpr int R = (MAX_NV + T - 1) / T;
  for (int j = 0; j < nv; ++j) {
    float t[R], tj = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tm.lane + r * T;
      t[r] = 0.0f;
      if (i >= j && i < nv) {
        float s = F.L[tri(i, j)];
        for (int k = 0; k < j; ++k) s -= F.L[tri(i, k)] * F.L[tri(j, k)];
        t[r] = s;
        if (i == j) tj = s;
      }
    }
    const float s = team_from(tj, j % T, tm);
    const float iv = rsqrtf(s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tm.lane + r * T;
      if (i == j) {
        F.invd[j] = iv;
        F.L[tri(j, j)] = s * iv;
      } else if (i > j && i < nv) {
        F.L[tri(i, j)] = t[r] * iv;
      }
    }
    TEAM_SYNC(tm.mask);   // column j is written before column j + 1 reads row j + 1
  }
}

// The penalty forces of every contact point across the team (point c on
// lane c mod T), their generalized forces and the foot forces reduced over
// the lanes with shuffles (a fixed order: the same bits every run), then
// the right-hand side tau + forces - C of the rows the lane owns into y.
template <int T>
HD void team_points(const ModelTable& m, const Team& tm, float mu, const float* planes,
                    PenaltyEnv& P, float* y) {
  const int nj = m.nj, nv = nj + 6, K = m.n_fpts;
  Tree& W = P.t;
  float acc[MAX_NV], ff[MAX_FEET][3];
#pragma unroll
  for (int i = 0; i < MAX_NV; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int q = 0; q < MAX_FEET; ++q)
    for (int i = 0; i < 3; ++i) ff[q][i] = 0.0f;
  for (int c = tm.lane; c < K + m.n_term; c += T) {
    const bool foot = c < K;
    const int s = c - K;
    const int b = foot ? m.fpt_body[c] : m.term_body[s];
    float p[3], f[3], nm[3];
    point_world(W, b, foot ? m.fpt_off[c] : m.term_off[s], p);
    if (!foot) p[2] -= m.term_rad[s];
    const float fn = point_force(m, W, b, p, planes ? planes + 3 * c : nullptr, mu, f, nm);
    for (int i = 0; i < 3; ++i) { acc[i] += nm[i]; acc[3 + i] += f[i]; }
    const unsigned int anc = m.anc[b];
#pragma unroll
    for (int k = 0; k < MAX_NJ; ++k)
      if (k < nj && ((anc >> k) & 1u)) acc[6 + k] += dot3(nm, W.w[k]) + dot3(f, W.lin[k]);
    if (foot) {
#pragma unroll
      for (int q = 0; q < MAX_FEET; ++q)
        if (q == m.fpt_foot[c])
          for (int i = 0; i < 3; ++i) ff[q][i] += f[i];
    } else {
      W.term_f[s] = fn;
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_NV; ++i)
    if (i < nv) acc[i] = team_sum<T>(acc[i], tm);
#pragma unroll
  for (int q = 0; q < MAX_FEET; ++q)
    for (int i = 0; i < 3; ++i) ff[q][i] = team_sum<T>(ff[q][i], tm);
  if (tm.lane == 0)
    for (int q = 0; q < m.n_feet; ++q)
      for (int i = 0; i < 3; ++i) W.foot_f[q][i] = ff[q][i];
  constexpr int R = (MAX_NV + T - 1) / T;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tm.lane + r * T;
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < MAX_NV; ++q)
      if (q == i) v = acc[q];
    if (i < nv) y[r] = (i >= 6 ? v + W.tau[i - 6] : v) - W.C[i];
  }
}

// y = M^-1 y with the factor P.f by columns across the team (lane l holds
// rows l, l + T, ... of y): x_j from row j's lane by shuffle, then the rows
// below it; back by rows of L, then the rows above it. The loops over j
// are unrolled, so that row j's lane, its slot and the offsets into the
// packed L are constants.
template <int T>
HD void team_chol_solve(const Factor& F, int nv, const Team& tm, float* y) {
  constexpr int R = (MAX_NV + T - 1) / T;
  int row[R];   // the offset of the lane's row i in the packed L
#pragma unroll
  for (int r = 0; r < R; ++r) row[r] = tri(tm.lane + r * T, 0);
#pragma unroll
  for (int j = 0; j < MAX_NV; ++j) {
    if (j >= nv) break;
    const float xj = team_from(tm.lane == j % T ? y[j / T] * F.invd[j] : 0.0f, j % T, tm);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tm.lane + r * T;
      if (i == j) y[r] = xj;
      else if (i > j && i < nv) y[r] -= F.L[row[r] + j] * xj;
    }
  }
#pragma unroll
  for (int j = MAX_NV - 1; j >= 0; --j) {
    if (j >= nv) continue;
    const float xj = team_from(tm.lane == j % T ? y[j / T] * F.invd[j] : 0.0f, j % T, tm);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tm.lane + r * T;
      if (i == j) y[r] = xj;
      else if (i < j) y[r] -= F.L[tri(j, 0) + i] * xj;
    }
  }
}

// Semi-implicit Euler across the team (integrate's arithmetic): the
// spatial -> conventional correction with the old velocity, the new
// velocity and joint angles of the lane's rows, then the base on lane 0.
template <int T>
HD void team_integrate(const ModelTable& m, const Team& tm, const float* udot, PenaltyEnv& P) {
  const int nv = m.nj + 6;
  const float dt = m.dt;
  float corr[3];
  cross3(P.u, P.u + 3, corr);
  TEAM_SYNC(tm.mask);   // every lane has read the old base velocity
  constexpr int R = (MAX_NV + T - 1) / T;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tm.lane + r * T;
    if (i >= nv) continue;
    float a = udot[r];
    if (i >= 3 && i < 6) a += corr[i - 3];
    const float un = P.u[i] + dt * a;
    P.u[i] = un;
    if (i >= 6) P.qj[i - 6] += dt * un;
  }
  TEAM_SYNC(tm.mask);
  if (tm.lane == 0) {
    const float* un = P.u;
    for (int i = 0; i < 3; ++i) P.bp[i] += dt * un[3 + i];
    float om[3] = {un[0] * dt, un[1] * dt, un[2] * dt};
    const float ang = sqrtf(dot3(om, om));
    const float half = 0.5f * ang;
    const bool small = ang < 1e-8f;
    const float kfac = small ? 0.5f : sinf(half) / ang;
    const float dq[4] = {cosf(half), om[0] * kfac, om[1] * kfac, om[2] * kfac};
    float qn[4];
    qmul(dq, P.bq, qn);
    const float nrm = rsqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3] + 1e-12f);
    for (int i = 0; i < 4; ++i) P.bq[i] = qn[i] * nrm;
  }
}

// A whole penalty control step for the team's env n; a tail team (n >= N)
// runs env N - 1 and writes nothing.
template <int T>
HD void penalty_team_step(const ModelTable& m, const Team& tm, const Chains<T>& ch, int n, int N,
                          const float* state, const float* masses, const float* friction,
                          const float* targets, const float* gains, const float* body,
                          const float* planes, float* state_out, float* diag, int decimation,
                          bool freeze, PenaltyEnv& P) {
  const int nj = m.nj, nv = nj + 6, rows = 7 + nj + nv;
  const int ne = n < N ? n : N - 1;
  const EnvExtras x = env_extras(m, ne, gains, body, planes);
  const float* mass = masses + static_cast<long long>(ne) * (nj + 1);
  const float* tgt = targets + static_cast<long long>(ne) * nj;
  const float mu = friction[ne];
  for (int r = tm.lane; r < rows; r += T) state_row(P, nj, r) = state[r * N + ne];
  TEAM_SYNC(tm.mask);
  if (freeze) {
    team_kinematics<T>(m, tm, ch, mass, x.body, P);
    team_crba_chol<T>(m, tm, ch, P);
  }
  for (int s = 0; s < decimation; ++s) {
    for (int k = tm.lane; k < nj; k += T) {   // PD torque (substep_head's law)
      float t;
      if (x.gains)
        t = (x.gains[k] * (tgt[k] - P.qj[k]) - x.gains[nj + k] * P.u[6 + k]) *
            x.gains[2 * nj + k];
      else
        t = m.kp[k] * (tgt[k] - P.qj[k]) - m.kd[k] * P.u[6 + k];
      P.t.tau[k] = fminf(fmaxf(t, -m.tau_lim[k]), m.tau_lim[k]);
    }
    team_kinematics<T>(m, tm, ch, mass, x.body, P);
    team_vel_bias<T>(m, tm, ch, P);
    if (!freeze) team_crba_chol<T>(m, tm, ch, P);
    float y[(MAX_NV + T - 1) / T];
    team_points<T>(m, tm, mu, x.planes, P, y);
    team_chol_solve<T>(P.f, nv, tm, y);
    team_integrate<T>(m, tm, y, P);
  }
  TEAM_SYNC(tm.mask);
  if (n < N) {
    for (int r = tm.lane; r < rows; r += T) state_out[r * N + n] = state_row(P, nj, r);
    const int drows = 10 * (nj + 1) + 3 * m.n_feet + m.n_term + nj;
    for (int r = tm.lane; r < drows; r += T) diag[r * N + n] = diag_row(m, P.t, r);
  }
}

#ifndef __CUDACC__

// The per-env step of a host build (the CPU tests): every instance runs its
// team step with a team of one lane.
void control_step_env(const ModelTable& m, int n, int N, const float* state,
                      const float* masses, const float* friction, const float* targets,
                      const float* gains, const float* body, const float* planes,
                      float* state_out, float* diag, int decimation, bool pgs, bool warm,
                      bool freeze, bool freeze_prep, int iterations, Work& W) {
  if (pgs && warm)
    team_control_step<1, true>(m, Team{0, 1u, 0, 1}, n, N, state, masses, friction, targets, gains, body,
                               planes, state_out, diag, decimation, freeze, freeze_prep,
                               iterations, W.t, W.c);
  else if (pgs)
    team_control_step<1, false>(m, Team{0, 1u, 0, 1}, n, N, state, masses, friction, targets, gains, body,
                                planes, state_out, diag, decimation, freeze, freeze_prep,
                                iterations, W.t, W.c);
  else {
    Chains<1> ch;
    make_chains(m, ch);
    PenaltyEnv* P = new PenaltyEnv;
    penalty_team_step<1>(m, Team{0, 1u, 0, 1}, ch, n, N, state, masses, friction, targets,
                         gains, body, planes, state_out, diag, decimation, freeze, *P);
    delete P;
  }
}

#else

constexpr int TEAM = 4;   // lanes per env on the PGS instances
#define WARP 32
// Floats per env in shared memory: a Contact rounded up to an odd multiple
// of TEAM, so that the teams of a warp reading the same field of their
// Contacts, lane j word j, hit distinct banks.
constexpr int kContactWords = static_cast<int>(sizeof(Contact) / 4);
constexpr int kTeamStride = ((kContactWords + TEAM - 1) / TEAM) % 2
                                ? ((kContactWords + TEAM - 1) / TEAM) * TEAM
                                : ((kContactWords + TEAM - 1) / TEAM + 1) * TEAM;
// Teams per block: a warp's worth, as far as their Contacts and the table
// fit the 48 KB of static shared memory a block may have (8: 48,924 bytes).
constexpr int kTeamsFit = (48 * 1024 - static_cast<int>(sizeof(ModelTable))) / (4 * kTeamStride);
constexpr int kTeams = WARP / TEAM < kTeamsFit ? WARP / TEAM : kTeamsFit;

__device__ inline void load_table(ModelTable& sm, const ModelTable* table) {
  const int words = sizeof(ModelTable) / sizeof(int);
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    reinterpret_cast<int*>(&sm)[i] = reinterpret_cast<const int*>(table)[i];
  __syncthreads();
}

// PGS: kTeams envs per block, one team each, interleaved in the warp; one
// kernel per warm-start flag, so that each gets the registers of its own
// code.
template <bool WARM>
__global__ void __launch_bounds__(kTeams * TEAM)
pgs_team_kernel(const float* __restrict__ state, const float* __restrict__ masses,
                const float* __restrict__ friction, const float* __restrict__ targets,
                const float* __restrict__ gains, const float* __restrict__ body,
                const float* __restrict__ planes, float* __restrict__ state_out,
                float* __restrict__ diag, int N, const ModelTable* __restrict__ table,
                int decimation, int freeze, int freeze_prep, int iterations) {
  __shared__ ModelTable sm;
  __shared__ float team_mem[kTeams * kTeamStride];
  load_table(sm, table);
  const int team = threadIdx.x % kTeams;
  unsigned mask = 0u;
  for (int j = 0; j < TEAM; ++j) mask |= 1u << (team + j * kTeams);
  const Team tm{static_cast<int>(threadIdx.x) / kTeams, mask, team, kTeams};
  Tree W;
  team_control_step<TEAM, WARM>(sm, tm, blockIdx.x * kTeams + team, N, state, masses, friction,
                                targets, gains, body, planes, state_out, diag, decimation,
                                freeze != 0, freeze_prep != 0, iterations, W,
                                *reinterpret_cast<Contact*>(team_mem + team * kTeamStride));
}

constexpr int PENALTY_TEAM = 16;   // lanes per env on the penalty instance
// Floats per env in shared memory: a PenaltyEnv rounded up to an odd count,
// so that the teams of a warp reading the same field hit distinct banks.
constexpr int kPenaltyWords = static_cast<int>(sizeof(PenaltyEnv) / 4);
constexpr int kPenaltyStride = kPenaltyWords % 2 ? kPenaltyWords : kPenaltyWords + 1;
// Teams per block: 8, as far as their PenaltyEnvs, the table and the chain
// schedule fit the 48 KB of static shared memory a block may have, so that
// a block shares its copy of the table among as many envs as it can and
// 4096 envs take one wave; the teams of a warp interleave.
constexpr int kPenaltyFit = (48 * 1024 - static_cast<int>(sizeof(ModelTable)) -
                             static_cast<int>(sizeof(Chains<PENALTY_TEAM>))) /
                            (4 * kPenaltyStride);
constexpr int kPenaltyTeams = 8 < kPenaltyFit ? 8 : kPenaltyFit;
constexpr int kPenaltyWarpTeams =
    WARP / PENALTY_TEAM < kPenaltyTeams ? WARP / PENALTY_TEAM : kPenaltyTeams;
static_assert(kPenaltyTeams % kPenaltyWarpTeams == 0, "a team must lie in one warp");

// Penalty: kPenaltyTeams envs per block, one team each, the teams of a warp
// interleaved as the PGS kernel's; each env's PenaltyEnv in shared memory.
__global__ void __launch_bounds__(kPenaltyTeams * PENALTY_TEAM)
penalty_team_kernel(const float* __restrict__ state, const float* __restrict__ masses,
                    const float* __restrict__ friction, const float* __restrict__ targets,
                    const float* __restrict__ gains, const float* __restrict__ body,
                    const float* __restrict__ planes, float* __restrict__ state_out,
                    float* __restrict__ diag, int N, const ModelTable* __restrict__ table,
                    int decimation, int freeze) {
  __shared__ ModelTable sm;
  __shared__ Chains<PENALTY_TEAM> ch;
  __shared__ float team_mem[kPenaltyTeams * kPenaltyStride];
  load_table(sm, table);
  if (threadIdx.x == 0) make_chains(sm, ch);
  __syncthreads();
  const int lane = threadIdx.x % WARP, first = lane % kPenaltyWarpTeams;
  const int team = threadIdx.x / WARP * kPenaltyWarpTeams + first;
  unsigned mask = 0u;
  for (int j = 0; j < PENALTY_TEAM; ++j) mask |= 1u << (first + j * kPenaltyWarpTeams);
  const Team tm{lane / kPenaltyWarpTeams, mask, first, kPenaltyWarpTeams};
  penalty_team_step<PENALTY_TEAM>(
      sm, tm, ch, blockIdx.x * kPenaltyTeams + team, N, state, masses, friction, targets,
      gains, body, planes, state_out, diag, decimation, freeze != 0,
      *reinterpret_cast<PenaltyEnv*>(team_mem + team * kPenaltyStride));
}

extern "C" int control_step_launch(const float* state, const float* masses,
                                   const float* friction, const float* targets,
                                   const float* gains, const float* body, const float* planes,
                                   float* state_out, float* diag, int N, const void* table,
                                   int decimation, int pgs, int warm, int freeze,
                                   int freeze_prep, int iterations, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ModelTable* t = static_cast<const ModelTable*>(table);
  if (pgs) {
    const auto kernel = warm ? pgs_team_kernel<true> : pgs_team_kernel<false>;
    kernel<<<(N + kTeams - 1) / kTeams, kTeams * TEAM, 0, s>>>(
        state, masses, friction, targets, gains, body, planes, state_out, diag, N, t,
        decimation, freeze, freeze_prep, iterations);
  } else {
    penalty_team_kernel<<<(N + kPenaltyTeams - 1) / kPenaltyTeams, kPenaltyTeams * PENALTY_TEAM, 0,
                          s>>>(
        state, masses, friction, targets, gains, body, planes, state_out, diag, N, t,
        decimation, freeze);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int model_table_bytes() { return static_cast<int>(sizeof(ModelTable)); }

extern "C" int pgs_team_lanes() { return TEAM; }

extern "C" int penalty_team_lanes() { return PENALTY_TEAM; }

#endif
