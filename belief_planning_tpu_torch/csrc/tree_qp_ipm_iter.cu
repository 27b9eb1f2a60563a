// tree_qp_ipm_iter.cu -- one fused Mehrotra + Gondzio IPM iteration of the
// prox tree QP, for a batch of independent scenario trees, on Hopper (sm_90a).
//
// Replaces the TPU kernel belief_planning_tpu/solvers/tree_qp_pl.py:
// _make_pallas_iteration (body: make_iteration(...).iterate). Its plain
// PyTorch version is make_iteration in
// belief_planning_tpu_torch/solvers/tree_qp_pl.py; the two compute the same
// iteration: residuals and gap, barrier weights clamped at w_max_eff, the
// level-blocked tree-Riccati factor (closed-form small inverse), predictor /
// Mehrotra-corrector / `gondzio` centrality KKT solves (each a backward
// linear sweep + forward rollout on the shared factor), per-lane Gondzio
// accept (longer step AND every candidate entry finite), fraction-to-boundary
// step, the gap_tol freeze and two 0.3x backtracks.
//
// Design: one thread per tree (lane). Every lane is independent: the gap,
// the step length and the Gondzio accept reduce over one lane only, so there
// is no cross-thread reduction and no atomic. Global arrays keep the
// batch-last layout of the Python side: element e of lane t sits at e*B + t,
// so the 32 threads of a warp touch 32 consecutive words on every access.
// Loops over levels, branches and steps run at run time; only the n=4 / d=2
// inner loops unroll (the kernel is templated on the scalar type and n, d).
//
// What bounds it on an H100: memory traffic. The least traffic of one
// iteration is the 16 constants read once, the 9 carry arrays read and
// written once and the gap written: 6,389 + 2 x 3,819 + 1 = 14,028 scalars
// per lane at N=8, NB=2, m=3 (totalu=97, totalx=106, 5 state rows, 4 input
// rows), i.e. 56,112 B per lane in f32 and 1.84 GB at B=32768, which is
// 0.55 ms at the 3.35 TB/s of an H100 SXM (data sheet, 700 W power limit).
// Its arithmetic, about 0.5 Mflop per lane, takes 0.24 ms at that card's
// 67 TFLOP/s f32 rate, so bytes bound it.
// This first design moves several times that: the per-stage factor (K,
// Hinv, Acl: 52 scalars per stage), two direction buffers, the residuals
// and the right-hand sides (20,229 scalars per lane at that size, 2.65 GB
// at B=32768 in f32) live in a global scratch buffer; the factor alone is
// written once and read twice by each of the 2 + gondzio KKT solves (about
// 44k scalars per lane per iteration with gondzio=2). With one thread per
// lane only B/32 warps are in flight to hide the latency of those dependent
// loads. Shared-memory staging, warp-per-tree splits and tensor cores are
// later work.
//
// The same source carries the phase kernels that replace the reference's
// K1 profile (scripts/profile_ipm_kernel.py, make_phase_fn): run<PHASE> with
// PHASE 0 = barrier weights + tree-Riccati factor, 1 = that + one linear
// sweep on the raw (qx, qu, qterm) and the forward rollout, 2 = the full
// iteration (the main kernel itself). Their plain versions are make_phase in
// belief_planning_tpu_torch/solvers/tree_qp_pl.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kNConst = 16;
constexpr int kNCarry = 9;
constexpr int kThreads = 64;     // lanes per block
constexpr int kNHeader = 10;     // ints before the level table

// order of the constants (CONST_ORDER on the Python side)
enum { QX2, QX, RU2, QU, DAB2, QTERM, PTERM2, SLACK_LIN, SLACK_QUAD, A_ST, B_ST,
       DH, B1, FX, FU, BU };

struct Dims {
  int n, d, m, nlev, nFx, nFu, totalu, totalx, nbr, gondzio;
  int nb[kMaxLevels], l[kMaxLevels], lx[kMaxLevels], u0[kMaxLevels],
      x0[kMaxLevels], leaf[kMaxLevels], bo[kMaxLevels];  // bo: first branch id
};

// Per-lane element offsets of one direction (dx, du, dsv, dsl1, dlam1, dsl2,
// dlam2, dsl3, dlam3) in the scratch buffer.
struct DirOff {
  long long f[kNCarry];
};

struct Layout {
  long long K, Hinv, Acl, Phead, phead, xiend, kff, qxeff, qur, qsr;
  long long w1, w2, w3, kap, r1, r2, r3, rdx, rdu, rds, rdterm, rc1, rc2, rc3;
  DirOff D[2];
  long long total;
};

__host__ __device__ inline Layout make_layout(const Dims& dm) {
  const long long U = dm.totalu, X = dm.totalx, n = dm.n, d = dm.d, nd = n + d;
  const long long Nc = dm.nFx + 1, F = dm.nFu, nleaf = dm.nb[dm.nlev - 1];
  Layout L;
  long long o = 0;
  auto take = [&o](long long sz) { long long r = o; o += sz; return r; };
  L.K = take(U * d * nd);
  L.Hinv = take(U * d * d);
  L.Acl = take(U * nd * nd);
  L.Phead = take(dm.nbr * nd * nd);
  L.phead = take(dm.nbr * nd);
  L.xiend = take(dm.nbr * nd);
  L.kff = take(U * d);
  L.qxeff = take(U * n);
  L.qur = take(U * d);
  L.qsr = take(U * Nc);
  L.w1 = take(U * Nc);
  L.w2 = take(U * F);
  L.w3 = take(U * Nc);
  L.kap = take(U * Nc);
  L.r1 = take(U * Nc);
  L.r2 = take(U * F);
  L.r3 = take(U * Nc);
  L.rdx = take(U * n);
  L.rdu = take(U * d);
  L.rds = take(U * Nc);
  L.rdterm = take(nleaf * n);
  L.rc1 = take(U * Nc);
  L.rc2 = take(U * F);
  L.rc3 = take(U * Nc);
  const long long sizes[kNCarry] = {X * n, U * d, U * Nc, U * Nc, U * Nc, U * F, U * F,
                                    U * Nc, U * Nc};
  for (int i = 0; i < 2; ++i)
    for (int f = 0; f < kNCarry; ++f) L.D[i].f[f] = take(sizes[f]);
  L.total = o;
  return L;
}

template <typename T>
struct Params {
  const T* c[kNConst];
  const T* in[kNCarry];
  T* out[kNCarry];
  T* gap;
  T* scratch;
  long long B;
  T reg, tau, wmax, gap_tol, mtot, bmin, bmax;
  Dims dm;
  Layout ly;
};

// min / max that propagate NaN, as jnp.minimum / torch.minimum do
template <typename T>
__device__ __forceinline__ T pmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// strided view of one lane of a batch-last array
template <typename T>
struct Col {
  T* p;
  long long B;
  __device__ __forceinline__ T& operator[](long long e) const { return p[e * B]; }
};

template <typename T, int NX, int NU>
struct Lane {
  static constexpr int ND = NX + NU;
  const Params<T>& P;
  const Dims& dm;
  const Layout& ly;
  const int Nc, nF;
  Col<const T> Qx2, qx, Ru2, qu, Dab2, qterm, Pterm2, slack_lin, A_st, B_st, dh, b1;
  Col<const T> x, u, s, sl1, lam1, sl2, lam2, sl3, lam3;
  const T* Fx;
  const T* Fu;
  const T* bu;
  T slack_quad;
  Col<T> S;     // scratch of this lane: S[offset + e]
  T gap;

  __device__ Lane(const Params<T>& P_, long long t)
      : P(P_), dm(P_.dm), ly(P_.ly), Nc(P_.dm.nFx + 1), nF(P_.dm.nFu) {
    const long long B = P.B;
    Col<const T>* cs[] = {&Qx2, &qx, &Ru2, &qu, &Dab2, &qterm, &Pterm2, &slack_lin};
    for (int i = 0; i < 8; ++i) *cs[i] = Col<const T>{P.c[i] + t, B};
    A_st = Col<const T>{P.c[A_ST] + t, B};
    B_st = Col<const T>{P.c[B_ST] + t, B};
    dh = Col<const T>{P.c[DH] + t, B};
    b1 = Col<const T>{P.c[B1] + t, B};
    slack_quad = P.c[SLACK_QUAD][t];
    Fx = P.c[FX];
    Fu = P.c[FU];
    bu = P.c[BU];
    Col<const T>* cy[] = {&x, &u, &s, &sl1, &lam1, &sl2, &lam2, &sl3, &lam3};
    for (int i = 0; i < kNCarry; ++i) *cy[i] = Col<const T>{P.in[i] + t, B};
    S = Col<T>{P.scratch + t, B};
  }

  // ---- constraint rows: row 0 is -dh.x, rows 1.. are Fx x ----------------
  __device__ T row_val(int st, int r, const T* xv) const {
    if (r == 0) {
      T acc = dh[st * NX] * xv[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) acc += dh[st * NX + i] * xv[i];
      return -acc;
    }
    const T* f = Fx + (r - 1) * NX;
    T acc = f[0] * xv[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) acc += f[i] * xv[i];
    return acc;
  }
  __device__ T fu_val(int q, const T* uv) const {
    T acc = Fu[q * NU] * uv[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) acc += Fu[q * NU + a] * uv[a];
    return acc;
  }

  template <typename F>
  __device__ void for_each_stage(F&& f) const {
    for (int k = 0; k < dm.nlev; ++k)
      for (int b = 0; b < dm.nb[k]; ++b)
        for (int j = 0; j < dm.l[k]; ++j)
          f(k, b, j, dm.u0[k] + b * dm.l[k] + j, dm.x0[k] + b * dm.lx[k] + j);
  }

  // ---- residuals, gap, barrier weights, dual residuals ---------------------
  __device__ void residuals() {
    T g1 = 0, g2 = 0, g3 = 0;
    const T wmax = P.wmax;
    for_each_stage([&](int k, int b, int j, int st, int xn) {
      T xv[NX], uv[NU], rT[NX], FuT[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) { xv[i] = x[xn * NX + i]; rT[i] = T(0); }
#pragma unroll
      for (int a = 0; a < NU; ++a) { uv[a] = u[st * NU + a]; FuT[a] = T(0); }
      T lam0 = T(0);
      for (int r = 0; r < Nc; ++r) {
        const long long e = (long long)st * Nc + r;
        const T sl1e = sl1[e], lam1e = lam1[e], sl3e = sl3[e], lam3e = lam3[e], se = s[e];
        S[ly.r1 + e] = row_val(st, r, xv) - se + sl1e - b1[e];
        g1 += sl1e * lam1e;
        const T w1e = pmin(lam1e / sl1e, wmax), w3e = pmin(lam3e / sl3e, wmax);
        S[ly.w1 + e] = w1e;
        S[ly.w3 + e] = w3e;
        S[ly.kap + e] = slack_quad + w1e + w3e + P.reg;
        S[ly.r3 + e] = -se + sl3e;
        g3 += sl3e * lam3e;
        S[ly.rds + e] = slack_quad * se + slack_lin[st] - lam1e - lam3e;
        if (r == 0) {
          lam0 = lam1e;
        } else {
#pragma unroll
          for (int i = 0; i < NX; ++i) rT[i] += Fx[(r - 1) * NX + i] * lam1e;
        }
      }
      for (int q = 0; q < nF; ++q) {
        const long long e = (long long)st * nF + q;
        const T sl2e = sl2[e], lam2e = lam2[e];
        S[ly.r2 + e] = fu_val(q, uv) + sl2e - bu[q];
        g2 += sl2e * lam2e;
        S[ly.w2 + e] = pmin(lam2e / sl2e, wmax);
#pragma unroll
        for (int a = 0; a < NU; ++a) FuT[a] += Fu[q * NU + a] * lam2e;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T acc = Qx2[(st * NX + i) * NX] * xv[0];
#pragma unroll
        for (int jj = 1; jj < NX; ++jj) acc += Qx2[(st * NX + i) * NX + jj] * xv[jj];
        S[ly.rdx + st * NX + i] = (acc + qx[st * NX + i]) + (-dh[st * NX + i] * lam0 + rT[i]);
      }
      // rate-coupling edges: fwd = Dab2_sᵀ u_pred(s), bwd = Σ_succ Dab2_succ u_succ
      T fwd[NU], bwd[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) { fwd[a] = T(0); bwd[a] = T(0); }
      int ps = -1;
      if (j > 0) ps = st - 1;
      else if (k > 0) ps = dm.u0[k - 1] + (b / dm.m) * dm.l[k - 1] + dm.l[k - 1] - 1;
      if (ps >= 0) {
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          T acc = Dab2[(st * NU) * NU + a] * u[ps * NU];
#pragma unroll
          for (int c = 1; c < NU; ++c) acc += Dab2[(st * NU + c) * NU + a] * u[ps * NU + c];
          fwd[a] = acc;
        }
      }
      if (j < dm.l[k] - 1) {
        edge_bwd(st + 1, bwd, false);
      } else if (k + 1 < dm.nlev) {
        for (int i = 0; i < dm.m; ++i)
          edge_bwd(dm.u0[k + 1] + (b * dm.m + i) * dm.l[k + 1], bwd, i > 0);
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T acc = Ru2[(st * NU + a) * NU] * uv[0];
#pragma unroll
        for (int c = 1; c < NU; ++c) acc += Ru2[(st * NU + a) * NU + c] * uv[c];
        S[ly.rdu + st * NU + a] = ((acc + qu[st * NU + a]) + FuT[a]) + (fwd[a] + bwd[a]);
      }
    });
    gap = ((g1 + g2) + g3) / P.mtot;
    const int kl = dm.nlev - 1;
    for (int b = 0; b < dm.nb[kl]; ++b) {
      const int xt = dm.x0[kl] + b * dm.lx[kl] + dm.l[kl];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T acc = Pterm2[(b * NX + i) * NX] * x[xt * NX];
#pragma unroll
        for (int jj = 1; jj < NX; ++jj) acc += Pterm2[(b * NX + i) * NX + jj] * x[xt * NX + jj];
        S[ly.rdterm + b * NX + i] = acc + qterm[b * NX + i];
      }
    }
  }

  // the barrier weights alone (residuals() computes them beside the rest)
  __device__ void weights() {
    const T wmax = P.wmax;
    const long long U = dm.totalu;
    for (long long e = 0; e < U * Nc; ++e) {
      const T w1e = pmin(lam1[e] / sl1[e], wmax), w3e = pmin(lam3[e] / sl3[e], wmax);
      S[ly.w1 + e] = w1e;
      S[ly.w3 + e] = w3e;
      S[ly.kap + e] = slack_quad + w1e + w3e + P.reg;
    }
    for (long long e = 0; e < U * nF; ++e) S[ly.w2 + e] = pmin(lam2[e] / sl2[e], wmax);
  }

  // out (+)= Dab2_s u_s
  __device__ void edge_bwd(int st, T* out, bool add) const {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T acc = Dab2[(st * NU + a) * NU] * u[st * NU];
#pragma unroll
      for (int c = 1; c < NU; ++c) acc += Dab2[(st * NU + a) * NU + c] * u[st * NU + c];
      out[a] = add ? out[a] + acc : acc;
    }
  }

  // ---- backward quadratic sweep (tree Riccati) ----------------------------
  __device__ void riccati_step(int st, T (&W)[ND][ND]) {
    T A[NX][NX], Bm[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) A[i][j] = A_st[(st * NX + i) * NX + j];
#pragma unroll
      for (int a = 0; a < NU; ++a) Bm[i][a] = B_st[(st * NX + i) * NU + a];
    }
    // Qx2_eff = Qx2 + Σ_r c_r F_r F_rᵀ + reg I with c = w1 − w1²/κ
    T Qe[NX][NX];
    {
      const long long e0 = (long long)st * Nc;
      const T w0 = S[ly.w1 + e0], c0 = w0 - w0 * w0 / S[ly.kap + e0];
      T dv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) dv[i] = dh[st * NX + i];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) Qe[i][j] = c0 * dv[i] * dv[j];
      for (int r = 1; r < Nc; ++r) {
        const T w = S[ly.w1 + e0 + r], c = w - w * w / S[ly.kap + e0 + r];
        const T* f = Fx + (r - 1) * NX;
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) Qe[i][j] += c * (f[i] * f[j]);
      }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          Qe[i][j] = (Qx2[(st * NX + i) * NX + j] + Qe[i][j]) + (i == j ? P.reg : T(0));
    }
    // Ru2_eff = Ru2 + reg I + Σ_q w2_q Fu_q Fu_qᵀ
    T Re[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) Re[a][c] = T(0);
    for (int q = 0; q < nF; ++q) {
      const T w = S[ly.w2 + (long long)st * nF + q];
      const T* f = Fu + q * NU;
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < NU; ++c) Re[a][c] += w * (f[a] * f[c]);
    }
    // BtPxx = Bᵀ Pxx (d×n), BtPxu = Bᵀ Pxu (d×d)
    T BtPxx[NU][NX], BtPxu[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T acc = Bm[0][a] * W[0][j];
#pragma unroll
        for (int k = 1; k < NX; ++k) acc += Bm[k][a] * W[k][j];
        BtPxx[a][j] = acc;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T acc = Bm[0][a] * W[0][NX + c];
#pragma unroll
        for (int k = 1; k < NX; ++k) acc += Bm[k][a] * W[k][NX + c];
        BtPxu[a][c] = acc;
      }
    }
    T H[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T acc = BtPxx[a][0] * Bm[0][c];
#pragma unroll
        for (int k = 1; k < NX; ++k) acc += BtPxx[a][k] * Bm[k][c];
        const T Ru = Ru2[(st * NU + a) * NU + c] + (a == c ? P.reg : T(0));
        H[a][c] = (Ru + Re[a][c]) + (acc + BtPxu[a][c] + BtPxu[c][a] + W[NX + a][NX + c]);
      }
    // L = [BᵀPxx A + Pxuᵀ A, Dab2ᵀ]  (d × nd)
    T L[NU][ND];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T t1 = BtPxx[a][0] * A[0][j], t2 = W[0][NX + a] * A[0][j];
#pragma unroll
        for (int k = 1; k < NX; ++k) {
          t1 += BtPxx[a][k] * A[k][j];
          t2 += W[k][NX + a] * A[k][j];
        }
        L[a][j] = t1 + t2;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) L[a][NX + c] = Dab2[(st * NU + c) * NU + a];
    }
    T Hi[NU][NU];
    small_inv(H, Hi);
    T HL[NU][ND];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        T acc = Hi[a][0] * L[0][c];
#pragma unroll
        for (int b = 1; b < NU; ++b) acc += Hi[a][b] * L[b][c];
        HL[a][c] = acc;
      }
    // AtPxxA = Aᵀ (Pxx A)
    T PA[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T acc = W[i][0] * A[0][j];
#pragma unroll
        for (int k = 1; k < NX; ++k) acc += W[i][k] * A[k][j];
        PA[i][j] = acc;
      }
    // P = −Lᵀ H⁻¹ L, + (Qx2_eff + AᵀPxxA) on the x block, symmetrized
    T Pn[ND][ND];
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        T acc = L[0][c] * HL[0][e];
#pragma unroll
        for (int a = 1; a < NU; ++a) acc += L[a][c] * HL[a][e];
        Pn[c][e] = -acc;
      }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T acc = A[0][i] * PA[0][j];
#pragma unroll
        for (int k = 1; k < NX; ++k) acc += A[k][i] * PA[k][j];
        Pn[i][j] += Qe[i][j] + acc;
      }
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < ND; ++e) W[c][e] = T(0.5) * (Pn[c][e] + Pn[e][c]);
    // store K = −H⁻¹L, H⁻¹ and Acl = [[B K + [A 0]], [K]]
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < ND; ++c) S[ly.K + ((long long)st * NU + a) * ND + c] = -HL[a][c];
#pragma unroll
      for (int c = 0; c < NU; ++c) S[ly.Hinv + ((long long)st * NU + a) * NU + c] = Hi[a][c];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        T acc = Bm[i][0] * (-HL[0][c]);
#pragma unroll
        for (int a = 1; a < NU; ++a) acc += Bm[i][a] * (-HL[a][c]);
        S[ly.Acl + ((long long)st * ND + i) * ND + c] = c < NX ? acc + A[i][c] : acc;
      }
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < ND; ++c) S[ly.Acl + ((long long)st * ND + NX + a) * ND + c] = -HL[a][c];
  }

  // closed-form inverse (d ≤ 3), not LU
  __device__ static void small_inv(const T (&M)[NU][NU], T (&R)[NU][NU]) {
    if constexpr (NU == 1) {
      R[0][0] = T(1) / M[0][0];
    } else if constexpr (NU == 2) {
      const T a = M[0][0], b = M[0][1], c = M[1][0], e = M[1][1];
      const T det = a * e - b * c;
      R[0][0] = e / det; R[0][1] = -b / det;
      R[1][0] = -c / det; R[1][1] = a / det;
    } else {
      static_assert(NU == 3, "closed-form inverse only for d <= 3");
      const T a = M[0][0], b = M[0][1], c = M[0][2];
      const T e = M[1][0], f = M[1][1], g = M[1][2];
      const T h = M[2][0], i = M[2][1], j = M[2][2];
      const T A = f * j - g * i, B = -(e * j - g * h), C = e * i - f * h;
      const T det = a * A + b * B + c * C;
      R[0][0] = A / det; R[0][1] = -(b * j - c * i) / det; R[0][2] = (b * g - c * f) / det;
      R[1][0] = B / det; R[1][1] = (a * j - c * h) / det; R[1][2] = -(a * g - c * e) / det;
      R[2][0] = C / det; R[2][1] = -(a * i - b * h) / det; R[2][2] = (a * f - b * e) / det;
    }
  }

  __device__ void factor() {
    for (int k = dm.nlev - 1; k >= 0; --k) {
      for (int b = 0; b < dm.nb[k]; ++b) {
        T W[ND][ND];
        if (k == dm.nlev - 1) {
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j)
              W[i][j] = (i < NX && j < NX)
                  ? Pterm2[(b * NX + i) * NX + j] + (i == j ? P.reg : T(0)) : T(0);
        } else {
          fold(ly.Phead, dm.bo[k + 1] + b * dm.m, ND * ND, &W[0][0]);
        }
        for (int j = dm.l[k] - 1; j >= 0; --j) riccati_step(dm.u0[k] + b * dm.l[k] + j, W);
        if (k > 0) store(ly.Phead + (long long)(dm.bo[k] + b) * ND * ND, ND * ND, &W[0][0]);
      }
    }
  }

  // out = Σ_{i<m} blocks[first + i]  (sequential, child order)
  __device__ void fold(long long base, int first, int size, T* out) const {
    for (int e = 0; e < size; ++e) out[e] = S[base + (long long)first * size + e];
    for (int i = 1; i < dm.m; ++i)
      for (int e = 0; e < size; ++e) out[e] += S[base + (long long)(first + i) * size + e];
  }
  __device__ void store(long long base, int size, const T* v) const {
    for (int e = 0; e < size; ++e) S[base + e] = v[e];
  }

  // ---- one KKT solve on the factor: rhs → D ----------------------------------
  // rc1..rc3 (complementarity targets) are in scratch. `pure` drops the
  // residual terms (Gondzio centrality rhs, zero terminal rhs).
  __device__ void direction(const DirOff& D, bool pure) {
    // right-hand sides per stage
    for_each_stage([&](int, int, int, int st, int) {
      T eT[NX], vT[NX], e0 = T(0), v0 = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) { eT[i] = T(0); vT[i] = T(0); }
      for (int r = 0; r < Nc; ++r) {
        const long long e = (long long)st * Nc + r;
        const T s1 = sl1[e], l1 = lam1[e], s3 = sl3[e], l3 = lam3[e];
        const T ex1 = pure ? -S[ly.rc1 + e] / s1 : (-S[ly.rc1 + e] + l1 * S[ly.r1 + e]) / s1;
        const T ex3 = pure ? -S[ly.rc3 + e] / s3 : (-S[ly.rc3 + e] + l3 * S[ly.r3 + e]) / s3;
        const T qs = pure ? -ex1 - ex3 : S[ly.rds + e] - ex1 - ex3;
        S[ly.qsr + e] = qs;
        const T v = (S[ly.w1 + e] / S[ly.kap + e]) * qs;
        if (r == 0) {
          e0 = ex1;
          v0 = v;
        } else {
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            eT[i] += Fx[(r - 1) * NX + i] * ex1;
            vT[i] += Fx[(r - 1) * NX + i] * v;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const T d = dh[st * NX + i];
        const T rowT_ex = -d * e0 + eT[i];
        const T qxr = pure ? rowT_ex : S[ly.rdx + st * NX + i] + rowT_ex;
        S[ly.qxeff + st * NX + i] = qxr + (-d * v0 + vT[i]);
      }
      T fT[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) fT[a] = T(0);
      for (int q = 0; q < nF; ++q) {
        const long long e = (long long)st * nF + q;
        const T ex2 = pure ? -S[ly.rc2 + e] / sl2[e]
                           : (-S[ly.rc2 + e] + lam2[e] * S[ly.r2 + e]) / sl2[e];
#pragma unroll
        for (int a = 0; a < NU; ++a) fT[a] += Fu[q * NU + a] * ex2;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a)
        S[ly.qur + st * NU + a] = pure ? fT[a] : S[ly.rdu + st * NU + a] + fT[a];
    });
    sweep(D, pure);

    // slack / multiplier directions per stage
    for_each_stage([&](int, int, int, int st, int xn) {
      T dxv[NX], duv[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) dxv[i] = S[D.f[0] + (long long)xn * NX + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) duv[a] = S[D.f[1] + st * NU + a];
      for (int r = 0; r < Nc; ++r) {
        const long long e = (long long)st * Nc + r;
        const T rv = row_val(st, r, dxv);
        const T dsv = (S[ly.w1 + e] * rv - S[ly.qsr + e]) / S[ly.kap + e];
        const T drow1 = rv - dsv;
        const T dsl1 = pure ? -drow1 : -S[ly.r1 + e] - drow1;
        const T dsl3 = pure ? dsv : -S[ly.r3 + e] + dsv;
        S[D.f[2] + e] = dsv;
        S[D.f[3] + e] = dsl1;
        S[D.f[4] + e] = (-S[ly.rc1 + e] - lam1[e] * dsl1) / sl1[e];
        S[D.f[7] + e] = dsl3;
        S[D.f[8] + e] = (-S[ly.rc3 + e] - lam3[e] * dsl3) / sl3[e];
      }
      for (int q = 0; q < nF; ++q) {
        const long long e = (long long)st * nF + q;
        const T drow2 = fu_val(q, duv);
        const T dsl2 = pure ? -drow2 : -S[ly.r2 + e] - drow2;
        S[D.f[5] + e] = dsl2;
        S[D.f[6] + e] = (-S[ly.rc2 + e] - lam2[e] * dsl2) / sl2[e];
      }
    });
  }

  // The factor's backward linear sweep on the right-hand sides in scratch
  // (qxeff, qur; the terminal rdterm unless `pure`) → kff, then the forward
  // rollout from a zero root state → D's dx, du.
  __device__ void sweep(const DirOff& D, bool pure) {
    // backward linear sweep → kff
    for (int k = dm.nlev - 1; k >= 0; --k) {
      for (int b = 0; b < dm.nb[k]; ++b) {
        T p[ND];
        if (k == dm.nlev - 1) {
#pragma unroll
          for (int i = 0; i < ND; ++i)
            p[i] = (i < NX && !pure) ? S[ly.rdterm + b * NX + i] : T(0);
        } else {
          fold(ly.phead, dm.bo[k + 1] + b * dm.m, ND, p);
        }
        for (int j = dm.l[k] - 1; j >= 0; --j) {
          const int st = dm.u0[k] + b * dm.l[k] + j;
          T qr[NU], lu[NU];
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            qr[a] = S[ly.qur + st * NU + a];
            T acc = B_st[(st * NX) * NU + a] * p[0];
#pragma unroll
            for (int i = 1; i < NX; ++i) acc += B_st[(st * NX + i) * NU + a] * p[i];
            lu[a] = (qr[a] + acc) + p[NX + a];
          }
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            T acc = S[ly.Hinv + ((long long)st * NU + a) * NU] * lu[0];
#pragma unroll
            for (int c = 1; c < NU; ++c) acc += S[ly.Hinv + ((long long)st * NU + a) * NU + c] * lu[c];
            S[ly.kff + st * NU + a] = -acc;
          }
          T pn[ND];
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            T t1 = S[ly.Acl + ((long long)st * ND) * ND + c] * p[0];
#pragma unroll
            for (int e = 1; e < ND; ++e) t1 += S[ly.Acl + ((long long)st * ND + e) * ND + c] * p[e];
            T t2 = S[ly.K + ((long long)st * NU) * ND + c] * qr[0];
#pragma unroll
            for (int a = 1; a < NU; ++a) t2 += S[ly.K + ((long long)st * NU + a) * ND + c] * qr[a];
            pn[c] = t1 + t2;
          }
#pragma unroll
          for (int c = 0; c < ND; ++c)
            p[c] = c < NX ? pn[c] + S[ly.qxeff + st * NX + c] : pn[c];
        }
        if (k > 0) store(ly.phead + (long long)(dm.bo[k] + b) * ND, ND, p);
      }
    }

    // forward rollout from a zero root state → dx, du
    const long long DX = D.f[0], DU = D.f[1];
    for (int k = 0; k < dm.nlev; ++k) {
      for (int b = 0; b < dm.nb[k]; ++b) {
        T xi[ND];
        if (k == 0) {
#pragma unroll
          for (int i = 0; i < ND; ++i) xi[i] = T(0);
        } else {
          const long long base = ly.xiend + (long long)(dm.bo[k - 1] + b / dm.m) * ND;
#pragma unroll
          for (int i = 0; i < ND; ++i) xi[i] = S[base + i];
        }
        for (int j = 0; j < dm.l[k]; ++j) {
          const int st = dm.u0[k] + b * dm.l[k] + j;
          const int xn = dm.x0[k] + b * dm.lx[k] + j;
          T kf[NU];
#pragma unroll
          for (int a = 0; a < NU; ++a) kf[a] = S[ly.kff + st * NU + a];
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            T acc = S[ly.K + ((long long)st * NU + a) * ND] * xi[0];
#pragma unroll
            for (int c = 1; c < ND; ++c) acc += S[ly.K + ((long long)st * NU + a) * ND + c] * xi[c];
            S[DU + st * NU + a] = acc + kf[a];
          }
#pragma unroll
          for (int i = 0; i < NX; ++i) S[DX + (long long)xn * NX + i] = xi[i];
          T xn_[ND];
#pragma unroll
          for (int e = 0; e < ND; ++e) {
            T acc = S[ly.Acl + ((long long)st * ND + e) * ND] * xi[0];
#pragma unroll
            for (int c = 1; c < ND; ++c) acc += S[ly.Acl + ((long long)st * ND + e) * ND + c] * xi[c];
            T bk;
            if (e < NX) {
              bk = B_st[(st * NX + e) * NU] * kf[0];
#pragma unroll
              for (int a = 1; a < NU; ++a) bk += B_st[(st * NX + e) * NU + a] * kf[a];
            } else {
              bk = kf[e - NX];
            }
            xn_[e] = acc + bk;
          }
#pragma unroll
          for (int e = 0; e < ND; ++e) xi[e] = xn_[e];
        }
        if (dm.leaf[k]) {
          const int xt = dm.x0[k] + b * dm.lx[k] + dm.l[k];
#pragma unroll
          for (int i = 0; i < NX; ++i) S[DX + (long long)xt * NX + i] = xi[i];
        }
        if (k + 1 < dm.nlev) store(ly.xiend + (long long)(dm.bo[k] + b) * ND, ND, xi);
      }
    }
  }

  // ---- step rules ------------------------------------------------------------
  __device__ T all_step(const DirOff& D) const {
    T a = T(1);
    const T inf = T(INFINITY);
    auto ms = [&](const Col<const T>& v, long long off, long long cnt) {
      for (long long e = 0; e < cnt; ++e) {
        const T dv = S[off + e];
        a = pmin(a, dv < T(0) ? -v[e] / dv : inf);
      }
    };
    const long long U = dm.totalu;
    ms(sl1, D.f[3], U * Nc);
    ms(lam1, D.f[4], U * Nc);
    ms(sl2, D.f[5], U * nF);
    ms(lam2, D.f[6], U * nF);
    ms(sl3, D.f[7], U * Nc);
    ms(lam3, D.f[8], U * Nc);
    return a;
  }

  __device__ T gap_at(const DirOff& D, T a) const {
    const long long U = dm.totalu;
    auto g = [&](const Col<const T>& v, const Col<const T>& lam, long long dv, long long dl,
                 long long cnt) {
      T acc = T(0);
      for (long long e = 0; e < cnt; ++e) acc += (v[e] + a * S[dv + e]) * (lam[e] + a * S[dl + e]);
      return acc;
    };
    return ((g(sl1, lam1, D.f[3], D.f[4], U * Nc) + g(sl2, lam2, D.f[5], D.f[6], U * nF))
            + g(sl3, lam3, D.f[7], D.f[8], U * Nc)) / P.mtot;
  }

  // rc_i = sl_i λ_i + scale·dsl_i dλ_i − shift over all rows (scale 0: affine)
  __device__ void set_rc(const DirOff& D, T scale, T shift) {
    const long long U = dm.totalu;
    auto f = [&](long long rc, const Col<const T>& v, const Col<const T>& lam, long long dv,
                 long long dl, long long cnt) {
      for (long long e = 0; e < cnt; ++e)
        S[rc + e] = scale == T(0) ? v[e] * lam[e]
                                  : v[e] * lam[e] + S[dv + e] * S[dl + e] - shift;
    };
    f(ly.rc1, sl1, lam1, D.f[3], D.f[4], U * Nc);
    f(ly.rc2, sl2, lam2, D.f[5], D.f[6], U * nF);
    f(ly.rc3, sl3, lam3, D.f[7], D.f[8], U * Nc);
  }

  // Gondzio rhs: the capped distance of the trial products from [lo, hi]
  __device__ void set_rc_outlier(const DirOff& D, T ab, T lo, T hi, T cap) {
    const long long U = dm.totalu;
    auto f = [&](long long rc, const Col<const T>& v, const Col<const T>& lam, long long dv,
                 long long dl, long long cnt) {
      for (long long e = 0; e < cnt; ++e) {
        const T p = (v[e] + ab * S[dv + e]) * (lam[e] + ab * S[dl + e]);
        const T t = pmin(pmax(p, lo), hi);
        S[rc + e] = pmin(pmax(p - t, -cap), cap);
      }
    };
    f(ly.rc1, sl1, lam1, D.f[3], D.f[4], U * Nc);
    f(ly.rc2, sl2, lam2, D.f[5], D.f[6], U * nF);
    f(ly.rc3, sl3, lam3, D.f[7], D.f[8], U * Nc);
  }

  // D_cand += D_cur over every field; returns whether all entries are finite
  __device__ bool add_into(const DirOff& cand, const DirOff& cur) const {
    const long long U = dm.totalu;
    const long long sizes[kNCarry] = {(long long)dm.totalx * NX, U * NU, U * Nc, U * Nc,
                                      U * Nc, U * nF, U * nF, U * Nc, U * Nc};
    bool ok = true;
    for (int f = 0; f < kNCarry; ++f)
      for (long long e = 0; e < sizes[f]; ++e) {
        const T v = S[cur.f[f] + e] + S[cand.f[f] + e];
        S[cand.f[f] + e] = v;
        ok = ok && isfinite(v);
      }
    return ok;
  }

  // PHASE 2: one full iteration (the main path). PHASE 0 / 1: the profile's
  // phases, which write only t0 (Σ K + Σ Hinv, or Σ dx + Σ du over every
  // stage) into the gap output. The reference's phase kernels carry the whole
  // state through and nudge sl1 by 1e-30·t0 only to chain a scan of them
  // inside one jit; stream order chains CUDA launches, so these write t0 alone.
  // t0 sums up to ~1.5k values of one lane in order: in f32 that sequential
  // sum alone would part from the exact sum by more than the plain version's
  // pairwise one, so it is accumulated in double.
  template <int PHASE>
  __device__ void run(long long t) {
    if constexpr (PHASE < 2) {
      weights();
      factor();
      const long long U = dm.totalu;
      double t0 = 0.0;
      if constexpr (PHASE == 0) {
        for (long long e = 0; e < U * NU * ND; ++e) t0 += S[ly.K + e];
        for (long long e = 0; e < U * NU * NU; ++e) t0 += S[ly.Hinv + e];
      } else {
        for (long long e = 0; e < U * NX; ++e) S[ly.qxeff + e] = qx[e];
        for (long long e = 0; e < U * NU; ++e) S[ly.qur + e] = qu[e];
        for (long long e = 0; e < (long long)dm.nb[dm.nlev - 1] * NX; ++e)
          S[ly.rdterm + e] = qterm[e];
        const DirOff& D = ly.D[0];
        sweep(D, false);
        for (long long e = 0; e < (long long)dm.totalx * NX; ++e) t0 += S[D.f[0] + e];
        for (long long e = 0; e < U * NU; ++e) t0 += S[D.f[1] + e];
      }
      P.gap[t] = T(t0);
      return;
    }
    residuals();
    factor();
    const DirOff& Da = ly.D[0];
    set_rc(Da, T(0), T(0));
    direction(Da, false);
    const T a_aff = all_step(Da);
    const T gap_aff = gap_at(Da, a_aff);
    const T ratio = gap_aff / (gap + T(1e-30));
    const T sigma = pmin(pmax(ratio * ratio * ratio, T(0)), T(1));
    set_rc(Da, T(1), sigma * gap);
    int ic = 1, id = 0;
    direction(ly.D[ic], false);
    for (int g = 0; g < dm.gondzio; ++g) {
      const T mu_t = sigma * gap + T(1e-30);
      const T a_cur = all_step(ly.D[ic]);
      const T ab = pmin(P.tau * a_cur + T(0.3), T(1));
      const T hi = P.bmax * mu_t;
      set_rc_outlier(ly.D[ic], ab, P.bmin * mu_t, hi, T(10) * hi);
      direction(ly.D[id], true);
      const bool ok = add_into(ly.D[id], ly.D[ic]);
      const T a_new = all_step(ly.D[id]);
      if (a_new > a_cur && ok) {
        const int tmp = ic;
        ic = id;
        id = tmp;
      }
    }
    const DirOff& Dc = ly.D[ic];
    T a0 = P.tau * all_step(Dc);
    if (gap < P.gap_tol * (T(1) + fabs(gap))) a0 = T(0);
    const T grow = T(10) * gap + T(1e-10);
    const T a1 = gap_at(Dc, a0) > grow ? T(0.3) * a0 : a0;
    const T a = gap_at(Dc, a1) > grow ? T(0.3) * a1 : a1;

    const long long B = P.B;
    const long long U = dm.totalu;
    const long long sizes[kNCarry] = {(long long)dm.totalx * NX, U * NU, U * Nc, U * Nc,
                                      U * Nc, U * nF, U * nF, U * Nc, U * Nc};
    for (int f = 0; f < kNCarry; ++f) {
      const T* in = P.in[f] + t;
      T* out = P.out[f] + t;
      for (long long e = 0; e < sizes[f]; ++e) out[e * B] = in[e * B] + a * S[Dc.f[f] + e];
    }
    P.gap[t] = gap;
  }
};

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kThreads)
tree_qp_ipm_iter_kernel(const __grid_constant__ Params<T> P) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P.B) return;
  Lane<T, NX, NU> lane(P, t);
  lane.template run<2>(t);
}

template <typename T, int NX, int NU, int PHASE>
__global__ void __launch_bounds__(kThreads)
tree_qp_phase_kernel(const __grid_constant__ Params<T> P) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P.B) return;
  Lane<T, NX, NU> lane(P, t);
  lane.template run<PHASE>(t);
}

bool parse_dims(const int* ints, Dims* dm) {
  dm->n = ints[0];
  dm->d = ints[1];
  dm->m = ints[2];
  dm->nlev = ints[3];
  dm->nFx = ints[4];
  dm->nFu = ints[5];
  dm->totalu = ints[6];
  dm->totalx = ints[7];
  dm->nbr = ints[8];
  dm->gondzio = ints[9];
  if (dm->nlev < 1 || dm->nlev > kMaxLevels || dm->nFx < 1 || dm->nFu < 1 || dm->m < 1 ||
      dm->gondzio < 0)
    return false;
  int bo = 0;
  for (int k = 0; k < dm->nlev; ++k) {
    const int* lv = ints + kNHeader + 6 * k;
    dm->nb[k] = lv[0];
    dm->l[k] = lv[1];
    dm->lx[k] = lv[2];
    dm->u0[k] = lv[3];
    dm->x0[k] = lv[4];
    dm->leaf[k] = lv[5];
    dm->bo[k] = bo;
    bo += dm->nb[k];
    if (dm->nb[k] < 1 || dm->l[k] < 1) return false;
  }
  return bo == dm->nbr && dm->leaf[dm->nlev - 1] == 1;
}

// phase: 0 / 1 the profile's phase kernels, 2 the full iteration
template <typename T>
int launch(int phase, const void* const* ptrs, const int* ints, const double* dbl,
           long long B, int device, void* stream) {
  Params<T> P;
  if (B < 1 || phase < 0 || phase > 2 || !parse_dims(ints, &P.dm))
    return (int)cudaErrorInvalidValue;
  if (P.dm.n != 4 || P.dm.d != 2) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  int o = 0;
  for (int i = 0; i < kNConst; ++i) P.c[i] = static_cast<const T*>(ptrs[o++]);
  for (int i = 0; i < kNCarry; ++i) P.in[i] = static_cast<const T*>(ptrs[o++]);
  for (int i = 0; i < kNCarry; ++i) P.out[i] = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.gap = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.scratch = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.B = B;
  P.reg = T(dbl[0]);
  P.tau = T(dbl[1]);
  P.wmax = T(dbl[2]);
  P.gap_tol = T(dbl[3]);
  P.mtot = T(dbl[4]);
  P.bmin = T(dbl[5]);
  P.bmax = T(dbl[6]);
  P.ly = make_layout(P.dm);
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  if (phase == 0)
    tree_qp_phase_kernel<T, 4, 2, 0>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  else if (phase == 1)
    tree_qp_phase_kernel<T, 4, 2, 1>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  else
    tree_qp_ipm_iter_kernel<T, 4, 2>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: 16 constants (CONST_ORDER), 9 carry in, 9 carry out, gap (1, B),
// scratch (bp_tree_qp_iter_scratch(ints), B); every array batch-last,
// contiguous, on CUDA device `device`. ints: n, d, m, nlev, nFx, nFu, totalu,
// totalx, n_branches, gondzio, then (nb, l, lx, u0, x0, leaf) per level.
// dbl: reg, tau, w_max_eff, gap_tol, mtot, gondzio_bmin, gondzio_bmax.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success); does not synchronize.
extern "C" int bp_tree_qp_iter_f32(const void* const* ptrs, const int* ints,
                                   const double* dbl, long long B, int device,
                                   void* stream) {
  return launch<float>(2, ptrs, ints, dbl, B, device, stream);
}

extern "C" int bp_tree_qp_iter_f64(const void* const* ptrs, const int* ints,
                                   const double* dbl, long long B, int device,
                                   void* stream) {
  return launch<double>(2, ptrs, ints, dbl, B, device, stream);
}

// The profile's phase kernels 0 and 1: as bp_tree_qp_iter_*, with the 9
// carry-out pointers possibly null (only the gap output, which takes t0, is
// written). Phase 2, the full iteration, is bp_tree_qp_iter_* itself.
extern "C" int bp_tree_qp_phase_f32(int phase, const void* const* ptrs, const int* ints,
                                    const double* dbl, long long B, int device,
                                    void* stream) {
  if (phase != 0 && phase != 1) return (int)cudaErrorInvalidValue;
  return launch<float>(phase, ptrs, ints, dbl, B, device, stream);
}

extern "C" int bp_tree_qp_phase_f64(int phase, const void* const* ptrs, const int* ints,
                                    const double* dbl, long long B, int device,
                                    void* stream) {
  if (phase != 0 && phase != 1) return (int)cudaErrorInvalidValue;
  return launch<double>(phase, ptrs, ints, dbl, B, device, stream);
}

// scratch elements per lane for this level table, or -1 if it is invalid
extern "C" long long bp_tree_qp_iter_scratch(const int* ints) {
  Dims dm;
  if (!parse_dims(ints, &dm)) return -1;
  return make_layout(dm).total;
}
