// One 100 Hz control step of the humanoid physics as one CUDA kernel.
//
// Replaces the TPU kernel humanoid_tpu/ops/physics_kernel.py::_control_kernel
// (built by build_control_fn) with the shipping switches: block-PGS foot
// contact from a cold start, penalty termination spheres, flat ground, no
// per-env gains or body randomization. `decimation`, `freeze` (factor the
// mass matrix once, from the entry configuration), `freeze_prep` (build the
// contact frames, Jacobian rows and Delassus operator once, with the frozen
// factor) and the sweep count are runtime arguments: decimation=1,
// freeze=0 is the exact substep of _substep_kernel.
//
// Each substep: PD torque, forward kinematics, joint screws, spatial
// inertias, the velocity/bias recursion, the CRBA mass matrix and its
// Cholesky factor (unless frozen), the penalty termination spheres, the free
// velocity, the contact prep (unless frozen), the PGS sweeps, and
// semi-implicit Euler. State stays in the thread between substeps; the
// kernel writes the state and the last substep's diagnostics.
//
// Design: one thread per env. The robot is data, not code: the wrapper
// packs a ModelTable (topology, joint frames, inertias, gains, contact
// points, solver constants) that each block copies into shared memory, so
// this source is generic in the robot and its outer loops stay loops.
// Per-thread arrays are sized at compile time for nj <= 18.
//
// What bounds it: the work is a few hundred thousand dependent fp32
// operations per env and control step against ~740 bytes moved per env, so
// the operation count sets the bound. At the shipping 4096 envs one thread
// per env fills about 1.5% of the card's resident thread slots (132 SMs x
// 2048), and the per-thread arrays live in local memory: the kernel is
// latency-bound far above that bound. A warp or a few threads per env is
// the redesign that addresses it.
//
// The per-env step is __host__ __device__ so that a host compiler can check
// its arithmetic; the wrapper never runs it on the host.

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

// Per-env working set. Spatial inertias are kept compact: mass m, first
// moment h = m (com - A) and the rotational inertia Ibar about the base
// point A (xx xy xz yy yz zz); I = [[Ibar, h~], [h~^T, m 1]].
struct Work {
  float pos[MAX_NB][3], quat[MAX_NB][4];
  float w[MAX_NJ][3], lin[MAX_NJ][3];     // joint screw S_k = [w; lin]
  float isp[MAX_NB][10], ic[MAX_NB][10];  // body and composite inertias
  float v[MAX_NB][6], a[MAX_NB][6], g[MAX_NB][6];
  float C[MAX_NV];
  float L[TRI(MAX_NV)], invd[MAX_NV];     // packed lower Cholesky factor
  float J[MAX_R][MAX_NV];                 // contact rows: n = z, t1 = x, t2 = y
  float A[TRI(MAX_R)];                    // packed lower Delassus operator
  float tmp[MAX_NV], rhs[MAX_NV], ufree[MAX_NV], lam[MAX_R], vf[MAX_R];
  float phi[MAX_FPTS];
  float foot_f[MAX_FEET][3], term_f[MAX_TERM], tau[MAX_NJ];
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
                   const float* qj, const float* mass, Work& W) {
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
    const float* c = m.com[b];
    const float* i6 = m.inertia[b];
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
HD void vel_bias(const ModelTable& m, const float* u, Work& W) {
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

// CRBA mass matrix into W.L (packed lower), factored in place.
HD void crba_chol(const ModelTable& m, Work& W) {
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
      W.L[tri(i, j)] = Ibar[i][j];
      W.L[tri(3 + i, 3 + j)] = i == j ? I0[0] : 0.0f;
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) W.L[tri(3 + i, j)] = hx[j][i];   // (h~)^T
  // joint rows: F = IC_(body k+1) S_k
  for (int k = 0; k < nj; ++k) {
    float S[6], F[6];
    for (int i = 0; i < 3; ++i) { S[i] = W.w[k][i]; S[3 + i] = W.lin[k][i]; }
    inertia_apply(W.ic[k + 1], S, F);
    const int i = 6 + k;
    for (int j = 0; j < 6; ++j) W.L[tri(i, j)] = F[j];
    const unsigned int anc = m.anc[k + 1];
    for (int b = 0; b <= k; ++b) {
      float val = 0.0f;
      if ((anc >> b) & 1u)
        val = dot3(W.w[b], F) + dot3(W.lin[b], F + 3);
      W.L[tri(i, 6 + b)] = val;
    }
    W.L[tri(i, i)] += m.armature[k];
  }
  // dense left-looking Cholesky, in place
  for (int j = 0; j < nv; ++j) {
    float s = W.L[tri(j, j)];
    for (int k = 0; k < j; ++k) s -= W.L[tri(j, k)] * W.L[tri(j, k)];
    const float iv = rsqrtf(s);
    W.invd[j] = iv;
    W.L[tri(j, j)] = s * iv;
    for (int i = j + 1; i < nv; ++i) {
      float t = W.L[tri(i, j)];
      for (int k = 0; k < j; ++k) t -= W.L[tri(i, k)] * W.L[tri(j, k)];
      W.L[tri(i, j)] = t * iv;
    }
  }
}

// x = M^-1 b with the packed factor; x may alias b.
HD void chol_solve(const Work& W, int nv, const float* b, float* x) {
  for (int i = 0; i < nv; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= W.L[tri(i, k)] * x[k];
    x[i] = s * W.invd[i];
  }
  for (int i = nv - 1; i >= 0; --i) {
    float s = x[i];
    for (int k = i + 1; k < nv; ++k) s -= W.L[tri(k, i)] * x[k];
    x[i] = s * W.invd[i];
  }
}

HD inline void point_world(const Work& W, int b, const float off[3],
                           float p[3]) {
  float o[3];
  qrot(W.quat[b], off, o);
  for (int i = 0; i < 3; ++i) p[i] = W.pos[b][i] + o[i];
}

// Contact rows (frames n = z, t1 = x, t2 = y on the flat plane) and the
// Delassus operator A = J M^-1 J^T, from the current kinematics and factor.
HD void pgs_prepare(const ModelTable& m, Work& W) {
  const int nj = m.nj, nv = nj + 6, R = 3 * m.n_fpts;
  const int axis_of_row[3] = {2, 0, 1};
  for (int c = 0; c < m.n_fpts; ++c) {
    const int b = m.fpt_body[c];
    const unsigned int anc = m.anc[b];
    float p[3], rel[3];
    point_world(W, b, m.fpt_off[c], p);
    for (int i = 0; i < 3; ++i) rel[i] = p[i] - W.pos[0][i];
    for (int d = 0; d < 3; ++d) {
      float e[3] = {0.0f, 0.0f, 0.0f};
      e[axis_of_row[d]] = 1.0f;
      float* row = W.J[3 * c + d];
      cross3(rel, e, row);
      for (int i = 0; i < 3; ++i) row[3 + i] = e[i];
      for (int k = 0; k < nj; ++k) {
        float val = 0.0f;
        if ((anc >> k) & 1u) {
          float wxr[3];
          cross3(W.w[k], rel, wxr);
          val = dot3(e, W.lin[k]) + dot3(e, wxr);
        }
        row[6 + k] = val;
      }
    }
  }
  for (int c = 0; c < R; ++c) {
    chol_solve(W, nv, W.J[c], W.tmp);
    for (int r = 0; r <= c; ++r) {
      float s = 0.0f;
      for (int i = 0; i < nv; ++i) s += W.J[r][i] * W.tmp[i];
      W.A[tri(c, r)] = s;
    }
  }
}

HD inline float amat(const Work& W, int i, int j) {
  return i >= j ? W.A[tri(i, j)] : W.A[tri(j, i)];
}

// One substep from the thread's state; `prep` rebuilds the contact rows and
// Delassus operator, `factor` the mass-matrix factor.
HD void substep(const ModelTable& m, float bp[3], float bq[4], float* qj, float* u,
                const float* mass, float mu, const float* targets, bool factor,
                bool prep, int iterations, Work& W) {
  const int nj = m.nj, nv = nj + 6, K = m.n_fpts, R = 3 * K;
  const float dt = m.dt;
  for (int k = 0; k < nj; ++k) {
    const float t = m.kp[k] * (targets[k] - qj[k]) - m.kd[k] * u[6 + k];
    W.tau[k] = fminf(fmaxf(t, -m.tau_lim[k]), m.tau_lim[k]);
  }
  kinematics(m, bp, bq, qj, mass, W);
  vel_bias(m, u, W);
  if (factor) crba_chol(m, W);

  // penalty termination spheres, then the free velocity
  for (int i = 0; i < nv; ++i) W.rhs[i] = 0.0f;
  const float* A0 = W.pos[0];
  for (int s = 0; s < m.n_term; ++s) {
    const int b = m.term_body[s];
    float p[3], rel[3], wr[3], vl[3], f[3], nm[3];
    point_world(W, b, m.term_off[s], p);
    p[2] -= m.term_rad[s];
    for (int i = 0; i < 3; ++i) rel[i] = p[i] - A0[i];
    cross3(W.v[b], rel, wr);
    for (int i = 0; i < 3; ++i) vl[i] = W.v[b][3 + i] + wr[i];
    const float pen = p[2] < 0.0f ? 1.0f : 0.0f;
    const float fn = fmaxf(0.0f, -m.kn * p[2] - m.cn * vl[2]) * pen;
    const float speed = sqrtf(vl[0] * vl[0] + vl[1] * vl[1] + m.v_reg * m.v_reg);
    const float scale = mu * fn / speed;
    f[0] = -scale * vl[0]; f[1] = -scale * vl[1]; f[2] = fn;
    W.term_f[s] = fn;
    cross3(rel, f, nm);
    for (int i = 0; i < 3; ++i) { W.rhs[i] += nm[i]; W.rhs[3 + i] += f[i]; }
    const unsigned int anc = m.anc[b];
    for (int k = 0; k < nj; ++k)
      if ((anc >> k) & 1u) W.rhs[6 + k] += dot3(nm, W.w[k]) + dot3(f, W.lin[k]);
  }
  for (int k = 0; k < nj; ++k) W.rhs[6 + k] += W.tau[k];
  for (int i = 0; i < nv; ++i) W.rhs[i] -= W.C[i];
  chol_solve(W, nv, W.rhs, W.tmp);
  for (int i = 0; i < nv; ++i) W.ufree[i] = u[i] + dt * W.tmp[i];

  if (prep) pgs_prepare(m, W);

  // fresh penetrations against the (possibly frozen) frames
  for (int c = 0; c < K; ++c) {
    float p[3];
    point_world(W, m.fpt_body[c], m.fpt_off[c], p);
    W.phi[c] = p[2];
  }
  for (int r = 0; r < R; ++r) {
    float s = 0.0f;
    for (int i = 0; i < nv; ++i) s += W.J[r][i] * W.ufree[i];
    W.vf[r] = s;
    W.lam[r] = 0.0f;
  }
  for (int it = 0; it < iterations; ++it) {
    for (int k = 0; k < K; ++k) {
      const int i0 = 3 * k;
      float vrow[3];
      for (int d = 0; d < 3; ++d) {
        float s = W.vf[i0 + d];
        for (int c = 0; c < R; ++c) s += amat(W, i0 + d, c) * W.lam[c];
        vrow[d] = s;
      }
      const float act = W.phi[k] < 0.0f ? 1.0f : 0.0f;
      const float bias = -(m.erp / dt) * fmaxf(-W.phi[k] - m.slop, 0.0f);
      const float Ann = amat(W, i0, i0);
      const float gam = m.cfm * Ann;
      const float ln = W.lam[i0];
      const float ln_new = fmaxf(0.0f, ln - (vrow[0] + bias + gam * ln) / (Ann + gam)) * act;
      const float dln = ln_new - ln;
      const float vt1 = vrow[1] + amat(W, i0 + 1, i0) * dln;
      const float vt2 = vrow[2] + amat(W, i0 + 2, i0) * dln;
      const float a11 = amat(W, i0 + 1, i0 + 1) + gam;
      const float a22 = amat(W, i0 + 2, i0 + 2) + gam;
      const float a12 = amat(W, i0 + 1, i0 + 2);
      const float det = a11 * a22 - a12 * a12;
      const float r1 = vt1 + gam * W.lam[i0 + 1];
      const float r2 = vt2 + gam * W.lam[i0 + 2];
      const float lt1 = W.lam[i0 + 1] - (a22 * r1 - a12 * r2) / det;
      const float lt2 = W.lam[i0 + 2] - (a11 * r2 - a12 * r1) / det;
      const float tn = sqrtf(lt1 * lt1 + lt2 * lt2 + 1e-12f);
      const float sc = fminf(1.0f, mu * ln_new / tn) * act;
      W.lam[i0] = ln_new;
      W.lam[i0 + 1] = lt1 * sc;
      W.lam[i0 + 2] = lt2 * sc;
    }
  }
  // u+ = u_free + M^-1 J^T lam
  for (int i = 0; i < nv; ++i) {
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s += W.J[r][i] * W.lam[r];
    W.rhs[i] = s;
  }
  chol_solve(W, nv, W.rhs, W.tmp);
  for (int f = 0; f < m.n_feet; ++f)
    for (int i = 0; i < 3; ++i) W.foot_f[f][i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    float* ff = W.foot_f[m.fpt_foot[k]];
    ff[0] += W.lam[3 * k + 1] / dt;
    ff[1] += W.lam[3 * k + 2] / dt;
    ff[2] += W.lam[3 * k] / dt;
  }

  // integrate: spatial -> conventional correction with the old velocity,
  // then semi-implicit Euler and the quaternion exponential map
  float corr[3], unew[MAX_NV];
  cross3(u, u + 3, corr);
  for (int i = 0; i < nv; ++i) unew[i] = W.ufree[i] + W.tmp[i];
  for (int i = 0; i < 3; ++i) unew[3 + i] += dt * corr[i];
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

// A whole control step for env n. State rows: [pos 3, quat 4, qj nj, u nv];
// diag rows: body pos (3 nb), body quat (4 nb), body omega (3 nb), foot
// forces (3 n_feet), termination forces (n_term), torques (nj).
HD void control_step_env(const ModelTable& m, int n, int N, const float* state,
                         const float* masses, const float* friction, const float* targets,
                         float* state_out, float* diag, int decimation, bool freeze,
                         bool freeze_prep, int iterations, Work& W) {
  const int nj = m.nj, nb = nj + 1, nv = nj + 6;
  float bp[3], bq[4], qj[MAX_NJ], u[MAX_NV], mass[MAX_NB], tgt[MAX_NJ];
  for (int i = 0; i < 3; ++i) bp[i] = state[i * N + n];
  for (int i = 0; i < 4; ++i) bq[i] = state[(3 + i) * N + n];
  for (int k = 0; k < nj; ++k) qj[k] = state[(7 + k) * N + n];
  for (int i = 0; i < nv; ++i) u[i] = state[(7 + nj + i) * N + n];
  for (int b = 0; b < nb; ++b) mass[b] = masses[n * nb + b];
  for (int k = 0; k < nj; ++k) tgt[k] = targets[n * nj + k];
  const float mu = friction[n];

  const bool frozen_prep = freeze && freeze_prep;
  if (freeze) {
    kinematics(m, bp, bq, qj, mass, W);
    crba_chol(m, W);
    if (frozen_prep) pgs_prepare(m, W);
  }
  for (int s = 0; s < decimation; ++s)
    substep(m, bp, bq, qj, u, mass, mu, tgt, !freeze, !frozen_prep, iterations, W);

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

#ifdef __CUDACC__

#define THREADS 32  // one warp per block spreads 4096 envs over 128 SMs

__global__ void __launch_bounds__(THREADS)
control_step_kernel(const float* __restrict__ state, const float* __restrict__ masses,
                    const float* __restrict__ friction, const float* __restrict__ targets,
                    float* __restrict__ state_out, float* __restrict__ diag, int N,
                    const ModelTable* __restrict__ table, int decimation, int freeze,
                    int freeze_prep, int iterations) {
  __shared__ ModelTable sm;
  const int words = sizeof(ModelTable) / sizeof(int);
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    reinterpret_cast<int*>(&sm)[i] = reinterpret_cast<const int*>(table)[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  Work W;
  control_step_env(sm, n, N, state, masses, friction, targets, state_out, diag, decimation,
                   freeze != 0, freeze_prep != 0, iterations, W);
}

extern "C" int control_step_launch(const float* state, const float* masses,
                                   const float* friction, const float* targets,
                                   float* state_out, float* diag, int N, const void* table,
                                   int decimation, int freeze, int freeze_prep, int iterations,
                                   void* stream) {
  const int blocks = (N + THREADS - 1) / THREADS;
  control_step_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      state, masses, friction, targets, state_out, diag, N,
      static_cast<const ModelTable*>(table), decimation, freeze, freeze_prep, iterations);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int model_table_bytes() { return static_cast<int>(sizeof(ModelTable)); }

#endif
