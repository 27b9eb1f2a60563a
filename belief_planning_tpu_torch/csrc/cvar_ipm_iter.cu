// cvar_ipm_iter.cu -- one fused Mehrotra + Gondzio IPM iteration of the
// nested-CVaR tree SOCP, for a batch of independent scenario trees, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel belief_planning_tpu/solvers/cvar_pl.py:
// _make_pallas_cvar_iteration (body: make_cvar_iteration(...).iterate). Its
// plain PyTorch version is make_cvar_iteration in
// belief_planning_tpu_torch/solvers/cvar_pl.py; the two compute the same
// iteration: residuals and gap; barrier weights clamped at w_max_eff; the
// barrier-weighted tree-Riccati factor; one backward / forward sweep pair
// over R = K+1 right-hand-side columns (the K per-cone Woodbury columns and
// the predictor); the W^1/2-equilibrated K x K capacitance, inverted by
// unpivoted Gauss-Jordan; the per-branch (2+m)^2 risk saddle, solved by
// Gauss-Jordan with partial pivoting (the first maximal row wins, NaN
// propagates as in the plain version); the corrector; `gondzio` centrality
// correctors with a per-lane accept (longer step AND every candidate entry
// finite); the early step cap; the gap_tol freeze; two 0.3x backtracks on gap
// growth; and the finiteness mask on the step.
//
// Design: one thread per tree (lane), as tree_qp_ipm_iter.cu. Every lane is
// independent, so there is no cross-thread reduction. Global arrays keep the
// batch-last layout: element e of lane t sits at e*B + t, so the 32 threads
// of a warp touch 32 consecutive words on every access. Loops over levels,
// branches, steps, cones and columns run at run time; the n=4 / d=2 algebra
// unrolls. Right-hand-side columns go through the tree sweeps in chunks of
// kCW, so the factor is read once per chunk; the Woodbury columns are formed
// on the fly from the cone mask and the stage gradients, and only their
// solutions are stored. The risk saddle is solved one column at a time in
// local arrays (its pivots depend only on the matrix, so this equals the
// multi-column solve).
//
// What bounds it on an H100: memory traffic. The least traffic of one
// iteration is the 11 per-lane constants read once, the 14 carry arrays read
// and written once and the gap written: at the merge deployment (N=40,
// NB=1, m=2) 2 x 3,187 + 2,778 + 1 scalars per lane, 36,612 B in f32, 1.20 GB
// at B=32768, 0.36 ms at the 3.35 TB/s of an H100 SXM (data sheet, 700 W).
// This first design moves far more: the factor, residuals, weights, the
// K+1 solution columns and two direction buffers live in a per-lane global
// scratch buffer (sized from the level table by bp_cvar_iter_scratch), the
// factor is re-read by every sweep chunk and every single-column solve, and
// with one thread per lane only B/32 warps are in flight to hide the latency
// of those dependent loads. Warps per tree, a shared-memory factor and
// tensor cores for the K-column contractions are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kNConst = 11;
constexpr int kNShared = 9;
constexpr int kNCarry = 14;
constexpr int kThreads = 64;     // lanes per block
constexpr int kNHeader = 15;     // ints before the level table
constexpr int kCW = 4;           // right-hand-side columns per sweep chunk
constexpr int kMaxM = 3;         // policies per branch
constexpr int kMaxA = 2 + kMaxM; // risk saddle size per branch

// Sums over every complementarity pair (the gap, and the trial gaps of the
// step rules: up to about 1,400 terms) accumulate in double, also in the
// float instantiation. A sequential float sum of that length is several
// times less accurate than the plain version's cascade sums, and the
// centering σ = (gap_aff / gap)³ amplifies that error into every direction.
using Acc = double;

// order of the per-lane constants (CONST_ORDER on the Python side)
enum { A_ST, B_ST, DH, B1, PA, CSC, CX, CC, QXC, FXL, FXFX };
// order of the shared constants (SHARED_ORDER)
enum { FU, BU, RM, MASK, MASKT, FRISK, FRISKT, SSGN, SSGNT };
// order of the carry (CARRY_ORDER); a direction uses the same order
enum { IX, IU, IS, IR, ISL1, ILAM1, ISL2, ILAM2, ISL3, ILAM3, ISL4, ILAM4, ISQ, ILQ };

struct Dims {
  int n, d, m, nlev, nFx, nFu, totalu, totalx, nbr, gondzio, K, bdim, nrisk, nsgn,
      early_iters;
  int nb[kMaxLevels], l[kMaxLevels], lx[kMaxLevels], u0[kMaxLevels], x0[kMaxLevels],
      leaf[kMaxLevels], bo[kMaxLevels];  // bo: first branch id of the level
};

struct DirOff {
  long long f[kNCarry];
};

// Per-lane element offsets in the scratch buffer.
struct Layout {
  long long gx, gu, sc, r1, r2, r3, r4, rq, w1, w2, w3, kap, w4, wq, lqs, hd;
  long long rdx, rdu, rds, rdr, rc[5];
  long long Kf, Hinv, Acl, Phead;
  long long qx1, qu1, qs1, qr1, exqc, kff, phead, xiend;
  long long Zx, Zu, Zs, Zr, dtmp, gd, Winv, gjaug, phi, dq;
  DirOff D[2];
  long long total;
};

__host__ __device__ inline void carry_sizes(const Dims& dm, long long* sz) {
  const long long U = dm.totalu, Nc = dm.nFx + 1, F = dm.nFu;
  const long long s[kNCarry] = {(long long)dm.totalx * dm.n, U * dm.d, U * Nc, dm.nrisk,
                                U * Nc, U * Nc, U * F, U * F, U * Nc, U * Nc,
                                dm.nsgn, dm.nsgn, dm.K, dm.K};
  for (int f = 0; f < kNCarry; ++f) sz[f] = s[f];
}

__host__ __device__ inline Layout make_layout(const Dims& dm) {
  const long long U = dm.totalu, X = dm.totalx, n = dm.n, d = dm.d, nd = n + d;
  const long long Nc = dm.nFx + 1, F = dm.nFu, K = dm.K, R = dm.K + 1;
  Layout L;
  long long o = 0;
  auto take = [&o](long long sz) { long long r = o; o += sz; return r; };
  L.gx = take(U * n);
  L.gu = take(U * d);
  L.sc = take(U);
  L.r1 = take(U * Nc);
  L.r2 = take(U * F);
  L.r3 = take(U * Nc);
  L.r4 = take(dm.nsgn);
  L.rq = take(K);
  L.w1 = take(U * Nc);
  L.w2 = take(U * F);
  L.w3 = take(U * Nc);
  L.kap = take(U * Nc);
  L.w4 = take(dm.nsgn);
  L.wq = take(K);
  L.lqs = take(U);
  L.hd = take(dm.nrisk);
  L.rdx = take(U * n);
  L.rdu = take(U * d);
  L.rds = take(U * Nc);
  L.rdr = take(dm.nrisk);
  L.rc[0] = take(U * Nc);
  L.rc[1] = take(U * F);
  L.rc[2] = take(U * Nc);
  L.rc[3] = take(dm.nsgn);
  L.rc[4] = take(K);
  L.Kf = take(U * d * nd);
  L.Hinv = take(U * d * d);
  L.Acl = take(U * nd * nd);
  L.Phead = take(dm.nbr * nd * nd);
  L.qx1 = take(U * n);
  L.qu1 = take(U * d);
  L.qs1 = take(U * Nc);
  L.qr1 = take(dm.nrisk);
  L.exqc = take(K);
  L.kff = take(U * d * kCW);
  L.phead = take(dm.nbr * nd * kCW);
  L.xiend = take(dm.nbr * nd * kCW);
  L.Zx = take(X * n * R);
  L.Zu = take(U * d * R);
  L.Zs = take(U * Nc * R);
  L.Zr = take(dm.nrisk * R);
  L.dtmp = take(U);
  L.gd = take(K * R);
  L.Winv = take(K * K);
  L.gjaug = take(K * 2 * K);
  L.phi = take(K);
  L.dq = take(K);
  long long sz[kNCarry];
  carry_sizes(dm, sz);
  for (int i = 0; i < 2; ++i)
    for (int f = 0; f < kNCarry; ++f) L.D[i].f[f] = take(sz[f]);
  L.total = o;
  return L;
}

template <typename T>
struct Params {
  const T* c[kNConst];
  const T* sh[kNShared];
  const T* in[kNCarry];
  T* out[kNCarry];
  T* gap;
  T* scratch;
  long long B;
  T reg, tau, wmax, gap_tol, mtot, bmin, bmax, a_cap_early, qslack1, itv;
  Dims dm;
  Layout ly;
};

// min / max that propagate NaN, as torch.minimum / jnp.minimum do
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

// Where one solve's outputs go: x (totalx, n), u (totalu, d), s (totalu, Nc)
// and r (nrisk) blocks in scratch, each with `R` columns (element e, column c
// at e*R + c).
struct Out {
  long long x, u, s, r;
  int R;
};

template <typename T>
struct Lane {
  static constexpr int NX = 4, NU = 2, NC = 5, NF = 4, ND = NX + NU;
  const Params<T>& P;
  const Dims& dm;
  const Layout& ly;
  Col<const T> A_st, B_st, dh, b1, pa, csc, cx, QxC, Fxl, FxFx;
  T cc;
  const T *Fu, *bu, *Rm, *mask, *maskT, *frisk, *friskT, *Ssgn, *SsgnT;
  Col<const T> v[kNCarry];
  Col<T> S;     // scratch of this lane: S[offset + e]
  T gap;
  int U, K, nrisk, nsgn, bdim, m;

  __device__ Lane(const Params<T>& P_, long long t) : P(P_), dm(P_.dm), ly(P_.ly) {
    const long long B = P.B;
    Col<const T>* cs[] = {&A_st, &B_st, &dh, &b1, &pa, &csc, &cx, nullptr, &QxC, &Fxl, &FxFx};
    for (int i = 0; i < kNConst; ++i)
      if (cs[i]) *cs[i] = Col<const T>{P.c[i] + t, B};
    cc = P.c[CC][t];
    Fu = P.sh[FU]; bu = P.sh[BU]; Rm = P.sh[RM]; mask = P.sh[MASK]; maskT = P.sh[MASKT];
    frisk = P.sh[FRISK]; friskT = P.sh[FRISKT]; Ssgn = P.sh[SSGN]; SsgnT = P.sh[SSGNT];
    for (int i = 0; i < kNCarry; ++i) v[i] = Col<const T>{P.in[i] + t, B};
    S = Col<T>{P.scratch + t, B};
    U = dm.totalu; K = dm.K; nrisk = dm.nrisk; nsgn = dm.nsgn; bdim = dm.bdim; m = dm.m;
  }

  __device__ T cinv(int k) const { return T(1) / csc[k]; }

  template <typename F>
  __device__ void for_each_stage(F&& f) const {
    for (int k = 0; k < dm.nlev; ++k)
      for (int b = 0; b < dm.nb[k]; ++b)
        for (int j = 0; j < dm.l[k]; ++j)
          f(k, b, j, dm.u0[k] + b * dm.l[k] + j, dm.x0[k] + b * dm.lx[k] + j);
  }

  // ---- constraint rows: row 0 is -dh.x, rows 1.. are Fxl x ----------------
  __device__ T row_val(int st, int r, const T* xv) const {
    if (r == 0) {
      T acc = dh[st * NX] * xv[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) acc += dh[st * NX + i] * xv[i];
      return -acc;
    }
    T acc = Fxl[(r - 1) * NX] * xv[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) acc += Fxl[(r - 1) * NX + i] * xv[i];
    return acc;
  }
  // out_i = (-dh_i v_0) + sum_q Fxl[q][i] v_{1+q}
  __device__ void row_valT(int st, const T* vv, T* out) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T acc = Fxl[i] * vv[1];
#pragma unroll
      for (int q = 1; q < NC - 1; ++q) acc += Fxl[q * NX + i] * vv[1 + q];
      out[i] = -dh[st * NX + i] * vv[0] + acc;
    }
  }
  __device__ T fu_val(int q, const T* uv) const {
    T acc = Fu[q * NU] * uv[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) acc += Fu[q * NU + a] * uv[a];
    return acc;
  }
  // out_a = sum_q Fu[q][a] v_q
  __device__ void fu_valT(const T* vv, T* out) const {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T acc = Fu[a] * vv[0];
#pragma unroll
      for (int q = 1; q < NF; ++q) acc += Fu[q * NU + a] * vv[q];
      out[a] = acc;
    }
  }

  // ---- stage pieces, residuals, gap, weights, dual residuals ---------------
  __device__ void residuals() {
    const T wmax = P.wmax, reg = P.reg, q1 = P.qslack1;
    const Col<const T>&x = v[IX], &u = v[IU], &s = v[IS], &r = v[IR];
    Acc g1 = 0, g2 = 0, g3 = 0;
    for_each_stage([&](int, int, int, int st, int xn) {
      T xc[NX], uu[NU], gx[NX], gu[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) xc[i] = x[xn * NX + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) uu[a] = u[st * NU + a];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T acc = xc[0] * QxC[j];
#pragma unroll
        for (int i = 1; i < NX; ++i) acc += xc[i] * QxC[i * NX + j];
        gx[j] = T(2) * acc + cx[j];
        S[ly.gx + st * NX + j] = gx[j];
      }
#pragma unroll
      for (int b = 0; b < NU; ++b) {
        T acc = uu[0] * Rm[b];
#pragma unroll
        for (int a = 1; a < NU; ++a) acc += uu[a] * Rm[a * NU + b];
        gu[b] = T(2) * acc;
        S[ly.gu + st * NU + b] = gu[b];
      }
      T t1 = xc[0] * (gx[0] - cx[0]), t2 = xc[0] * cx[0], t3 = uu[0] * gu[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) {
        t1 += xc[i] * (gx[i] - cx[i]);
        t2 += xc[i] * cx[i];
      }
#pragma unroll
      for (int a = 1; a < NU; ++a) t3 += uu[a] * gu[a];
      T ssum = s[st * NC];
      for (int q = 1; q < NC; ++q) ssum += s[st * NC + q];
      S[ly.sc + st] = (((t1 * T(0.5) + t2) + cc) + t3 * T(0.5)) + q1 * ssum;
      for (int q = 0; q < NC; ++q) {
        const long long e = (long long)st * NC + q;
        const T sl1e = v[ISL1][e], lam1e = v[ILAM1][e], sl3e = v[ISL3][e], lam3e = v[ILAM3][e];
        const T se = s[e];
        S[ly.r1 + e] = ((row_val(st, q, xc) - se) + sl1e) - b1[e];
        S[ly.r3 + e] = -se + sl3e;
        g1 += sl1e * lam1e;
        g3 += sl3e * lam3e;
        const T w1e = pmin(lam1e / sl1e, wmax), w3e = pmin(lam3e / sl3e, wmax);
        S[ly.w1 + e] = w1e;
        S[ly.w3 + e] = w3e;
        S[ly.kap + e] = (w1e + w3e) + reg;
      }
      for (int q = 0; q < NF; ++q) {
        const long long e = (long long)st * NF + q;
        const T sl2e = v[ISL2][e], lam2e = v[ILAM2][e];
        S[ly.r2 + e] = (fu_val(q, uu) + sl2e) - bu[q];
        g2 += sl2e * lam2e;
        S[ly.w2 + e] = pmin(lam2e / sl2e, wmax);
      }
    });
    // risk rows, cones and the gap
    Acc g4 = 0, g5 = 0;
    for (int i = 0; i < nsgn; ++i) {
      T acc = Ssgn[(long long)i * nrisk] * r[0];
      for (int q = 1; q < nrisk; ++q) acc += Ssgn[(long long)i * nrisk + q] * r[q];
      S[ly.r4 + i] = -acc + v[ISL4][i];
      g4 += v[ISL4][i] * v[ILAM4][i];
      S[ly.w4 + i] = pmin(v[ILAM4][i] / v[ISL4][i], wmax);
    }
    for (int k = 0; k < K; ++k) {
      T a1 = mask[(long long)k * U] * S[ly.sc];
      for (int j = 1; j < U; ++j) a1 += mask[(long long)k * U + j] * S[ly.sc + j];
      T a2 = frisk[(long long)k * nrisk] * r[0];
      for (int q = 1; q < nrisk; ++q) a2 += frisk[(long long)k * nrisk + q] * r[q];
      const T ci = cinv(k);
      S[ly.rq + k] = (a1 * ci + a2 * ci) + v[ISQ][k];
      g5 += v[ISQ][k] * v[ILQ][k];
      S[ly.wq + k] = pmin(v[ILQ][k] / v[ISQ][k], wmax);
    }
    gap = T(((((g1 + g2) + g3) + g4) + g5) / Acc(P.mtot));
    // cone multipliers per stage, risk Hessian, risk dual residual
    for (int j = 0; j < U; ++j) {
      T acc = maskT[(long long)j * K] * (v[ILQ][0] * cinv(0));
      for (int k = 1; k < K; ++k) acc += maskT[(long long)j * K + k] * (v[ILQ][k] * cinv(k));
      S[ly.lqs + j] = acc;
    }
    for (int q = 0; q < nrisk; ++q) {
      T a1 = SsgnT[(long long)q * nsgn] * S[ly.w4];
      T a2 = SsgnT[(long long)q * nsgn] * v[ILAM4][0];
      for (int i = 1; i < nsgn; ++i) {
        a1 += SsgnT[(long long)q * nsgn + i] * S[ly.w4 + i];
        a2 += SsgnT[(long long)q * nsgn + i] * v[ILAM4][i];
      }
      S[ly.hd + q] = reg + a1;
      T a3 = friskT[(long long)q * K] * (v[ILQ][0] * cinv(0));
      for (int k = 1; k < K; ++k) a3 += friskT[(long long)q * K + k] * (v[ILQ][k] * cinv(k));
      S[ly.rdr + q] = ((q == 0 ? T(1) : T(0)) + a3) - a2;
    }
    // per-stage dual residuals
    for_each_stage([&](int, int, int, int st, int) {
      const T lq_s = S[ly.lqs + st];
      T lam1v[NC], lam2v[NF], rT[NX], fT[NU];
      for (int q = 0; q < NC; ++q) lam1v[q] = v[ILAM1][(long long)st * NC + q];
      for (int q = 0; q < NF; ++q) lam2v[q] = v[ILAM2][(long long)st * NF + q];
      row_valT(st, lam1v, rT);
      fu_valT(lam2v, fT);
#pragma unroll
      for (int i = 0; i < NX; ++i) S[ly.rdx + st * NX + i] = lq_s * S[ly.gx + st * NX + i] + rT[i];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const T obj = st == 0 ? S[ly.gu + a] : T(0);
        S[ly.rdu + st * NU + a] = (lq_s * S[ly.gu + st * NU + a] + obj) + fT[a];
      }
      for (int q = 0; q < NC; ++q) {
        const T obj = st == 0 ? q1 : T(0);
        S[ly.rds + (long long)st * NC + q] = ((obj + q1 * lq_s) - lam1v[q])
            - v[ILAM3][(long long)st * NC + q];
      }
    });
  }

  // ---- backward quadratic sweep (tree Riccati) ----------------------------
  __device__ void riccati_step(int st, T (&W)[ND][ND]) {
    const T reg = P.reg;
    T A[NX][NX], Bm[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) A[i][j] = A_st[(st * NX + i) * NX + j];
#pragma unroll
      for (int a = 0; a < NU; ++a) Bm[i][a] = B_st[(st * NX + i) * NU + a];
    }
    const T lq2 = T(2) * S[ly.lqs + st];
    // Qx2 = 2 lqs QxC + reg I + c_0 dh dh^T + sum_q c_{1+q} FxFx_q, c = w1 - w1^2/kap
    T Qe[NX][NX];
    {
      const long long e0 = (long long)st * NC;
      T c[NC];
      for (int q = 0; q < NC; ++q) {
        const T w = S[ly.w1 + e0 + q];
        c[q] = w - w * w / S[ly.kap + e0 + q];
      }
      T dv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) dv[i] = dh[st * NX + i];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T sum = c[1] * FxFx[i * NX + j];
#pragma unroll
          for (int q = 1; q < NC - 1; ++q) sum += c[1 + q] * FxFx[(q * NX + i) * NX + j];
          Qe[i][j] = ((lq2 * QxC[i * NX + j] + (i == j ? reg : T(0))) + (c[0] * dv[i]) * dv[j])
                     + sum;
        }
    }
    // Ru2 = 2 lam_stage Rm + reg I + sum_q w2_q Fu_q Fu_q^T
    T Re[NU][NU];
    {
      const T ls2 = T(2) * (S[ly.lqs + st] + (st == 0 ? T(1) : T(0)));
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int b = 0; b < NU; ++b) {
          T sum = S[ly.w2 + (long long)st * NF] * (Fu[a] * Fu[b]);
          for (int q = 1; q < NF; ++q)
            sum += S[ly.w2 + (long long)st * NF + q] * (Fu[q * NU + a] * Fu[q * NU + b]);
          Re[a][b] = (ls2 * Rm[a * NU + b] + (a == b ? reg : T(0))) + sum;
        }
    }
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
        H[a][c] = Re[a][c] + (((acc + BtPxu[a][c]) + BtPxu[c][a]) + W[NX + a][NX + c]);
      }
    // L = [B^T Pxx A + Pxu^T A, 0]  (d x nd; the rate coupling is zero here)
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
      for (int c = 0; c < NU; ++c) L[a][NX + c] = T(0);
    }
    T Hi[NU][NU];
    {
      const T a = H[0][0], b = H[0][1], c = H[1][0], e = H[1][1];
      const T det = a * e - b * c;
      Hi[0][0] = e / det; Hi[0][1] = -b / det;
      Hi[1][0] = -c / det; Hi[1][1] = a / det;
    }
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
    // store K = -H^-1 L, H^-1 and Acl = [[B K + [A 0]], [K]]
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < ND; ++c) S[ly.Kf + ((long long)st * NU + a) * ND + c] = -HL[a][c];
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

  __device__ void factor() {
    for (int k = dm.nlev - 1; k >= 0; --k) {
      for (int b = 0; b < dm.nb[k]; ++b) {
        T W[ND][ND];
        if (k == dm.nlev - 1) {
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j) W[i][j] = (i < NX && i == j) ? P.reg : T(0);
        } else {
          const long long first = dm.bo[k + 1] + (long long)b * m;
          for (int e = 0; e < ND * ND; ++e) {
            T acc = S[ly.Phead + first * ND * ND + e];
            for (int i = 1; i < m; ++i) acc += S[ly.Phead + (first + i) * ND * ND + e];
            (&W[0][0])[e] = acc;
          }
        }
        for (int j = dm.l[k] - 1; j >= 0; --j) riccati_step(dm.u0[k] + b * dm.l[k] + j, W);
        if (k > 0)
          for (int e = 0; e < ND * ND; ++e)
            S[ly.Phead + (long long)(dm.bo[k] + b) * ND * ND + e] = (&W[0][0])[e];
      }
    }
  }

  // ---- right-hand sides of the H0 solve --------------------------------------
  // Column c of the stage rhs: a Woodbury column (c < K, formed from the cone
  // mask and the stage gradients) when `wood`, else the stored single rhs.
  __device__ void rhs_stage(bool wood, int c, int st, T* qx, T* qu, T* qs) const {
    if (wood && c < K) {
      const T mT = maskT[(long long)st * K + c] * cinv(c);
#pragma unroll
      for (int i = 0; i < NX; ++i) qx[i] = mT * S[ly.gx + st * NX + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) qu[a] = mT * S[ly.gu + st * NU + a];
      const T q = P.qslack1 * mT;
#pragma unroll
      for (int r = 0; r < NC; ++r) qs[r] = q;
    } else {
#pragma unroll
      for (int i = 0; i < NX; ++i) qx[i] = S[ly.qx1 + st * NX + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) qu[a] = S[ly.qu1 + st * NU + a];
#pragma unroll
      for (int r = 0; r < NC; ++r) qs[r] = S[ly.qs1 + (long long)st * NC + r];
    }
  }
  __device__ T rhs_risk(bool wood, int c, int q) const {
    return (wood && c < K) ? friskT[(long long)q * K + c] * cinv(c) : T(S[ly.qr1 + q]);
  }
  // qx_eff = qx + Fxc^T((w1/kap) qs)
  __device__ void qx_eff(int st, const T* qx, const T* qs, T* out) const {
    T vv[NC];
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const long long e = (long long)st * NC + r;
      vv[r] = (S[ly.w1 + e] / S[ly.kap + e]) * qs[r];
    }
    T rt[NX];
    row_valT(st, vv, rt);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = qx[i] + rt[i];
  }

  // ---- the H0 solve (tree + rows + risk) for columns [0, ncol) --------------
  __device__ void h0_solve(bool wood, int ncol, const Out& o) {
    for (int c0 = 0; c0 < ncol; c0 += kCW) {
      const int nc = ncol - c0 < kCW ? ncol - c0 : kCW;
      // backward linear sweep -> kff
      for (int k = dm.nlev - 1; k >= 0; --k) {
        for (int b = 0; b < dm.nb[k]; ++b) {
          T p[ND][kCW];
          if (k == dm.nlev - 1) {
#pragma unroll
            for (int e = 0; e < ND; ++e)
#pragma unroll
              for (int c = 0; c < kCW; ++c) p[e][c] = T(0);
          } else {
            const long long first = dm.bo[k + 1] + (long long)b * m;
#pragma unroll
            for (int e = 0; e < ND; ++e)
#pragma unroll
              for (int c = 0; c < kCW; ++c) {
                T acc = S[ly.phead + (first * ND + e) * kCW + c];
                for (int i = 1; i < m; ++i) acc += S[ly.phead + ((first + i) * ND + e) * kCW + c];
                p[e][c] = acc;
              }
          }
          for (int j = dm.l[k] - 1; j >= 0; --j) {
            const int st = dm.u0[k] + b * dm.l[k] + j;
            T Hi[NU][NU], Kf[NU][ND], Bm[NX][NU];
#pragma unroll
            for (int a = 0; a < NU; ++a) {
#pragma unroll
              for (int e = 0; e < NU; ++e) Hi[a][e] = S[ly.Hinv + ((long long)st * NU + a) * NU + e];
#pragma unroll
              for (int e = 0; e < ND; ++e) Kf[a][e] = S[ly.Kf + ((long long)st * NU + a) * ND + e];
            }
#pragma unroll
            for (int i = 0; i < NX; ++i)
#pragma unroll
              for (int a = 0; a < NU; ++a) Bm[i][a] = B_st[(st * NX + i) * NU + a];
            for (int c = 0; c < nc; ++c) {
              T qx[NX], qu[NU], qs[NC], qe[NX];
              rhs_stage(wood, c0 + c, st, qx, qu, qs);
              qx_eff(st, qx, qs, qe);
              T lu[NU];
#pragma unroll
              for (int a = 0; a < NU; ++a) {
                T acc = Bm[0][a] * p[0][c];
#pragma unroll
                for (int i = 1; i < NX; ++i) acc += Bm[i][a] * p[i][c];
                lu[a] = (qu[a] + acc) + p[NX + a][c];
              }
#pragma unroll
              for (int a = 0; a < NU; ++a) {
                T acc = Hi[a][0] * lu[0];
#pragma unroll
                for (int e = 1; e < NU; ++e) acc += Hi[a][e] * lu[e];
                S[ly.kff + ((long long)st * NU + a) * kCW + c] = -acc;
              }
              T pn[ND];
#pragma unroll
              for (int cc_ = 0; cc_ < ND; ++cc_) {
                T t1 = S[ly.Acl + ((long long)st * ND) * ND + cc_] * p[0][c];
                for (int e = 1; e < ND; ++e)
                  t1 += S[ly.Acl + ((long long)st * ND + e) * ND + cc_] * p[e][c];
                T t2 = Kf[0][cc_] * qu[0];
#pragma unroll
                for (int a = 1; a < NU; ++a) t2 += Kf[a][cc_] * qu[a];
                pn[cc_] = t1 + t2;
              }
#pragma unroll
              for (int e = 0; e < ND; ++e) p[e][c] = e < NX ? pn[e] + qe[e] : pn[e];
            }
          }
          if (k > 0)
            for (int e = 0; e < ND; ++e)
              for (int c = 0; c < kCW; ++c)
                S[ly.phead + ((long long)(dm.bo[k] + b) * ND + e) * kCW + c] = p[e][c];
        }
      }
      // forward rollout from a zero root state -> x, u columns
      for (int k = 0; k < dm.nlev; ++k) {
        for (int b = 0; b < dm.nb[k]; ++b) {
          T xi[ND][kCW];
          if (k == 0) {
#pragma unroll
            for (int e = 0; e < ND; ++e)
#pragma unroll
              for (int c = 0; c < kCW; ++c) xi[e][c] = T(0);
          } else {
            const long long base = (long long)(dm.bo[k - 1] + b / m) * ND;
#pragma unroll
            for (int e = 0; e < ND; ++e)
#pragma unroll
              for (int c = 0; c < kCW; ++c) xi[e][c] = S[ly.xiend + (base + e) * kCW + c];
          }
          for (int j = 0; j < dm.l[k]; ++j) {
            const int st = dm.u0[k] + b * dm.l[k] + j;
            const int xn = dm.x0[k] + b * dm.lx[k] + j;
            for (int c = 0; c < nc; ++c) {
              T kf[NU];
#pragma unroll
              for (int a = 0; a < NU; ++a) kf[a] = S[ly.kff + ((long long)st * NU + a) * kCW + c];
#pragma unroll
              for (int a = 0; a < NU; ++a) {
                T acc = S[ly.Kf + ((long long)st * NU + a) * ND] * xi[0][c];
                for (int e = 1; e < ND; ++e)
                  acc += S[ly.Kf + ((long long)st * NU + a) * ND + e] * xi[e][c];
                S[o.u + ((long long)st * NU + a) * o.R + c0 + c] = acc + kf[a];
              }
#pragma unroll
              for (int i = 0; i < NX; ++i) S[o.x + ((long long)xn * NX + i) * o.R + c0 + c] = xi[i][c];
              T xn_[ND];
#pragma unroll
              for (int e = 0; e < ND; ++e) {
                T acc = S[ly.Acl + ((long long)st * ND + e) * ND] * xi[0][c];
                for (int cc_ = 1; cc_ < ND; ++cc_)
                  acc += S[ly.Acl + ((long long)st * ND + e) * ND + cc_] * xi[cc_][c];
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
              for (int e = 0; e < ND; ++e) xi[e][c] = xn_[e];
            }
          }
          if (dm.leaf[k]) {
            const int xt = dm.x0[k] + b * dm.lx[k] + dm.l[k];
            for (int c = 0; c < nc; ++c)
#pragma unroll
              for (int i = 0; i < NX; ++i) S[o.x + ((long long)xt * NX + i) * o.R + c0 + c] = xi[i][c];
          }
          if (k + 1 < dm.nlev)
            for (int e = 0; e < ND; ++e)
              for (int c = 0; c < kCW; ++c)
                S[ly.xiend + ((long long)(dm.bo[k] + b) * ND + e) * kCW + c] = xi[e][c];
        }
      }
    }
    // slack columns: s = (w1 rows(x) - qs) / kap
    for_each_stage([&](int, int, int, int st, int xn) {
      for (int c = 0; c < ncol; ++c) {
        T qx[NX], qu[NU], qs[NC], xv[NX];
        rhs_stage(wood, c, st, qx, qu, qs);
#pragma unroll
        for (int i = 0; i < NX; ++i) xv[i] = S[o.x + ((long long)xn * NX + i) * o.R + c];
        for (int r = 0; r < NC; ++r) {
          const long long e = (long long)st * NC + r;
          S[o.s + e * o.R + c] = (S[ly.w1 + e] * row_val(st, r, xv) - qs[r]) / S[ly.kap + e];
        }
      }
    });
    // risk columns: -(top-left block of the risk saddle's inverse) q
    for (int c = 0; c < ncol; ++c) risk_column(wood, c, o);
  }

  // One column of the per-branch risk solve, by Gauss-Jordan with partial
  // pivoting on [M | rhs] (a = 2+m rows), as the plain version's
  // _gj_solve_pivot_bl: the pivot row is the first row j >= k with maximal
  // |aug[j][k]|, selected through comparison masks (NaN propagates).
  __device__ void risk_column(bool wood, int c, const Out& o) {
    const int mu0 = 2 * bdim + bdim * m;
    const int a = 2 + m;
    const T eps = P.reg;
    for (int q = 2 * bdim; q < mu0; ++q)
      S[o.r + (long long)q * o.R + c] = -(rhs_risk(wood, c, q) / S[ly.hd + q]);
    for (int br = 0; br < bdim; ++br) {
      T aug[kMaxA][kMaxA + 1];
      const T q_rho = rhs_risk(wood, c, br), q_sig = rhs_risk(wood, c, bdim + br);
      for (int i = 0; i < a; ++i)
        for (int j = 0; j <= a; ++j) aug[i][j] = T(0);
      aug[0][0] = S[ly.hd + br];
      aug[0][1] = -eps;
      aug[0][a] = q_rho - q_sig;
      aug[1][0] = T(1);
      aug[1][1] = T(1) + eps * eps;
      aug[1][a] = eps * q_sig;
      for (int i = 0; i < m; ++i) {
        const T pai = pa[br * m + i];
        aug[1][2 + i] = -pai;
        aug[2 + i][1] = eps * pai;
        for (int j = 0; j < m; ++j)
          aug[2 + i][2 + j] = S[ly.hd + mu0 + br * m + i] * (i == j ? T(1) : T(0));
        aug[2 + i][a] = rhs_risk(wood, c, mu0 + br * m + i) + pai * q_sig;
      }
      for (int k = 0; k < a; ++k) {
        T elig[kMaxA], fo[kMaxA];
        T mx = T(0);
        for (int j = 0; j < a; ++j) {
          elig[j] = fabs(aug[j][k]) * (j >= k ? T(1) : T(0));
          mx = j == 0 ? elig[0] : pmax(mx, elig[j]);
        }
        T taken = T(0);
        for (int j = 0; j < a; ++j) {
          const T eq = (elig[j] >= mx ? T(1) : T(0)) * (j >= k ? T(1) : T(0));
          fo[j] = eq * (T(1) - taken);
          taken = taken + fo[j];
        }
        T piv[kMaxA + 1], rowk[kMaxA + 1];
        for (int cc_ = 0; cc_ <= a; ++cc_) {
          T acc = fo[0] * aug[0][cc_];
          for (int j = 1; j < a; ++j) acc += fo[j] * aug[j][cc_];
          piv[cc_] = acc;
          rowk[cc_] = aug[k][cc_];
        }
        for (int j = 0; j < a; ++j)
          if (fo[j] > T(0.5))
            for (int cc_ = 0; cc_ <= a; ++cc_) aug[j][cc_] = rowk[cc_];
        const T d = piv[k];
        for (int cc_ = 0; cc_ <= a; ++cc_) piv[cc_] = piv[cc_] / d;
        for (int j = 0; j < a; ++j) {
          if (j == k) continue;
          const T f = aug[j][k];
          for (int cc_ = 0; cc_ <= a; ++cc_) aug[j][cc_] = aug[j][cc_] - f * piv[cc_];
        }
        for (int cc_ = 0; cc_ <= a; ++cc_) aug[k][cc_] = piv[cc_];
      }
      S[o.r + (long long)br * o.R + c] = -aug[0][a];
      S[o.r + (long long)(bdim + br) * o.R + c] = -aug[1][a];
      for (int i = 0; i < m; ++i)
        S[o.r + (long long)(mu0 + br * m + i) * o.R + c] = -aug[2 + i][a];
    }
  }

  // g_k^T v for every cone k, for column c of a solve's outputs -> out[K]
  __device__ void gdot(const Out& o, int c, long long out, long long ostride) {
    for_each_stage([&](int, int, int, int st, int xn) {
      T t1 = S[ly.gx + st * NX] * S[o.x + ((long long)xn * NX) * o.R + c];
#pragma unroll
      for (int i = 1; i < NX; ++i)
        t1 += S[ly.gx + st * NX + i] * S[o.x + ((long long)xn * NX + i) * o.R + c];
      T t2 = S[ly.gu + st * NU] * S[o.u + ((long long)st * NU) * o.R + c];
#pragma unroll
      for (int a = 1; a < NU; ++a)
        t2 += S[ly.gu + st * NU + a] * S[o.u + ((long long)st * NU + a) * o.R + c];
      T ss = S[o.s + ((long long)st * NC) * o.R + c];
      for (int r = 1; r < NC; ++r) ss += S[o.s + ((long long)st * NC + r) * o.R + c];
      S[ly.dtmp + st] = (t1 + t2) + P.qslack1 * ss;
    });
    for (int k = 0; k < K; ++k) {
      T a1 = mask[(long long)k * U] * S[ly.dtmp];
      for (int j = 1; j < U; ++j) a1 += mask[(long long)k * U + j] * S[ly.dtmp + j];
      T a2 = frisk[(long long)k * nrisk] * S[o.r + c];
      for (int q = 1; q < nrisk; ++q) a2 += frisk[(long long)k * nrisk + q] * S[o.r + (long long)q * o.R + c];
      const T ci = cinv(k);
      S[out + k * ostride] = a1 * ci + a2 * ci;
    }
  }

  // ---- Woodbury capacitance: W^-1 of I - (GtZ_ij sw_i) sw_j, sw = sqrt(wq) --
  __device__ void capacitance() {
    const long long R = K + 1, W2 = 2LL * K;
    for (int i = 0; i < K; ++i) {
      const T swi = sqrt(S[ly.wq + i]);
      for (int j = 0; j < K; ++j) {
        const T swj = sqrt(S[ly.wq + j]);
        S[ly.gjaug + i * W2 + j] = (i == j ? T(1) : T(0)) - (S[ly.gd + i * R + j] * swi) * swj;
        S[ly.gjaug + i * W2 + K + j] = i == j ? T(1) : T(0);
      }
    }
    for (int i = 0; i < K; ++i) {
      const T pv = S[ly.gjaug + i * W2 + i];
      for (int c = 0; c < W2; ++c) S[ly.gjaug + i * W2 + c] = S[ly.gjaug + i * W2 + c] / pv;
      for (int j = 0; j < K; ++j) {
        if (j == i) continue;
        const T f = S[ly.gjaug + j * W2 + i];
        for (int c = 0; c < W2; ++c)
          S[ly.gjaug + j * W2 + c] = S[ly.gjaug + j * W2 + c] - f * S[ly.gjaug + i * W2 + c];
      }
    }
    for (int i = 0; i < K; ++i)
      for (int j = 0; j < K; ++j) S[ly.Winv + i * K + j] = S[ly.gjaug + i * W2 + K + j];
  }

  // D's x, u, s, r := base (column `bc` of `b`) + sum_k Z_k corr_k, with
  // corr = wq * (Winv (sw phi0)) / sw and phi0 at S[phi0 + k*pstride]
  __device__ void wb_correct(const DirOff& D, const Out& b, int bc, long long phi0,
                             long long pstride) {
    for (int k = 0; k < K; ++k) {
      T acc = S[ly.Winv + k * K] * (sqrt(S[ly.wq]) * S[phi0]);
      for (int j = 1; j < K; ++j)
        acc += S[ly.Winv + k * K + j] * (sqrt(S[ly.wq + j]) * S[phi0 + j * pstride]);
      S[ly.phi + k] = S[ly.wq + k] * (acc / sqrt(S[ly.wq + k]));
    }
    const long long R = K + 1;
    long long sz[kNCarry];
    carry_sizes(dm, sz);
    const long long zoff[4] = {ly.Zx, ly.Zu, ly.Zs, ly.Zr};
    const long long boff[4] = {b.x, b.u, b.s, b.r};
    for (int f = 0; f < 4; ++f)
      for (long long e = 0; e < sz[f]; ++e) {
        T acc = S[zoff[f] + e * R] * S[ly.phi];
        for (int k = 1; k < K; ++k) acc += S[zoff[f] + e * R + k] * S[ly.phi + k];
        S[D.f[f] + e] = S[boff[f] + e * b.R + bc] + acc;
      }
  }

  // slack and multiplier directions from D's x, u, s, r; rc in scratch.
  // `pure` drops the residual terms (Gondzio corrector).
  __device__ void finish(const DirOff& D, bool pure) {
    for_each_stage([&](int, int, int, int st, int xn) {
      T xd[NX], ud[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) xd[i] = S[D.f[IX] + (long long)xn * NX + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) ud[a] = S[D.f[IU] + st * NU + a];
      for (int r = 0; r < NC; ++r) {
        const long long e = (long long)st * NC + r;
        const T dsv = S[D.f[IS] + e];
        const T drow1 = row_val(st, r, xd) - dsv;
        const T dsl1 = pure ? -drow1 : -S[ly.r1 + e] - drow1;
        const T dsl3 = pure ? dsv : -S[ly.r3 + e] + dsv;
        S[D.f[ISL1] + e] = dsl1;
        S[D.f[ISL3] + e] = dsl3;
        S[D.f[ILAM1] + e] = (-S[ly.rc[0] + e] - v[ILAM1][e] * dsl1) / v[ISL1][e];
        S[D.f[ILAM3] + e] = (-S[ly.rc[2] + e] - v[ILAM3][e] * dsl3) / v[ISL3][e];
      }
      for (int q = 0; q < NF; ++q) {
        const long long e = (long long)st * NF + q;
        const T drow2 = fu_val(q, ud);
        const T dsl2 = pure ? -drow2 : -S[ly.r2 + e] - drow2;
        S[D.f[ISL2] + e] = dsl2;
        S[D.f[ILAM2] + e] = (-S[ly.rc[1] + e] - v[ILAM2][e] * dsl2) / v[ISL2][e];
      }
    });
    for (int i = 0; i < nsgn; ++i) {
      T acc = Ssgn[(long long)i * nrisk] * S[D.f[IR]];
      for (int q = 1; q < nrisk; ++q) acc += Ssgn[(long long)i * nrisk + q] * S[D.f[IR] + q];
      const T dsl4 = pure ? acc : -S[ly.r4 + i] + acc;
      S[D.f[ISL4] + i] = dsl4;
      S[D.f[ILAM4] + i] = (-S[ly.rc[3] + i] - v[ILAM4][i] * dsl4) / v[ISL4][i];
    }
    const Out od{D.f[IX], D.f[IU], D.f[IS], D.f[IR], 1};
    gdot(od, 0, ly.dq, 1);
    for (int k = 0; k < K; ++k) {
      const T dsq = pure ? -S[ly.dq + k] : -S[ly.rq + k] - S[ly.dq + k];
      S[D.f[ISQ] + k] = dsq;
      S[D.f[ILQ] + k] = (-S[ly.rc[4] + k] - v[ILQ][k] * dsq) / v[ISQ][k];
    }
  }

  // the single right-hand side from rc: `pure` drops the residual terms
  __device__ void set_rhs(bool pure) {
    for (int k = 0; k < K; ++k) {
      const T sqk = v[ISQ][k];
      const T exq = pure ? -S[ly.rc[4] + k] / sqk
                         : (-S[ly.rc[4] + k] + v[ILQ][k] * S[ly.rq + k]) / sqk;
      S[ly.exqc + k] = exq * cinv(k);
    }
    for_each_stage([&](int, int, int, int st, int) {
      T eg = maskT[(long long)st * K] * S[ly.exqc];
      for (int k = 1; k < K; ++k) eg += maskT[(long long)st * K + k] * S[ly.exqc + k];
      T ex1[NC], ex2[NF];
      for (int r = 0; r < NC; ++r) {
        const long long e = (long long)st * NC + r;
        const T s1 = v[ISL1][e], s3 = v[ISL3][e];
        ex1[r] = pure ? -S[ly.rc[0] + e] / s1 : (-S[ly.rc[0] + e] + v[ILAM1][e] * S[ly.r1 + e]) / s1;
        const T ex3 = pure ? -S[ly.rc[2] + e] / s3
                           : (-S[ly.rc[2] + e] + v[ILAM3][e] * S[ly.r3 + e]) / s3;
        const T base = pure ? -ex1[r] - ex3 : (S[ly.rds + e] - ex1[r]) - ex3;
        S[ly.qs1 + e] = base + P.qslack1 * eg;
      }
      for (int q = 0; q < NF; ++q) {
        const long long e = (long long)st * NF + q;
        ex2[q] = pure ? -S[ly.rc[1] + e] / v[ISL2][e]
                      : (-S[ly.rc[1] + e] + v[ILAM2][e] * S[ly.r2 + e]) / v[ISL2][e];
      }
      T rt[NX], ft[NU];
      row_valT(st, ex1, rt);
      fu_valT(ex2, ft);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const T base = pure ? rt[i] : S[ly.rdx + st * NX + i] + rt[i];
        S[ly.qx1 + st * NX + i] = base + eg * S[ly.gx + st * NX + i];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const T base = pure ? ft[a] : S[ly.rdu + st * NU + a] + ft[a];
        S[ly.qu1 + st * NU + a] = base + eg * S[ly.gu + st * NU + a];
      }
    });
    for (int q = 0; q < nrisk; ++q) {
      T sc = T(0);
      for (int i = 0; i < nsgn; ++i) {
        const T ex4 = pure ? -S[ly.rc[3] + i] / v[ISL4][i]
                           : (-S[ly.rc[3] + i] + v[ILAM4][i] * S[ly.r4 + i]) / v[ISL4][i];
        const T t = SsgnT[(long long)q * nsgn + i] * ex4;
        sc = i == 0 ? t : sc + t;
      }
      T add = friskT[(long long)q * K] * S[ly.exqc];
      for (int k = 1; k < K; ++k) add += friskT[(long long)q * K + k] * S[ly.exqc + k];
      const T base = pure ? -sc : S[ly.rdr + q] - sc;
      S[ly.qr1 + q] = base + add;
    }
  }

  // one single-column direction into D from the rhs in q1 and rc
  __device__ void direction(const DirOff& D, bool pure) {
    set_rhs(pure);
    const Out od{D.f[IX], D.f[IU], D.f[IS], D.f[IR], 1};
    h0_solve(false, 1, od);
    gdot(od, 0, ly.dq, 1);
    wb_correct(D, od, 0, ly.dq, 1);
    finish(D, pure);
  }

  // ---- step rules over the five complementarity families -------------------
  __device__ long long fam_count(int f) const {
    long long sz[kNCarry];
    carry_sizes(dm, sz);
    return sz[ISL1 + 2 * f];
  }
  __device__ T all_step(const DirOff& D) const {
    T a = T(1);
    const T inf = T(INFINITY);
    for (int f = 0; f < 5; ++f) {
      const long long cnt = fam_count(f);
      for (int w = 0; w < 2; ++w) {
        const int idx = ISL1 + 2 * f + w;
        for (long long e = 0; e < cnt; ++e) {
          const T dv = S[D.f[idx] + e];
          a = pmin(a, dv < T(0) ? -v[idx][e] / dv : inf);
        }
      }
    }
    return a;
  }
  __device__ T gap_at(const DirOff& D, T a) const {
    T g = T(0);
    for (int f = 0; f < 5; ++f) {
      const int is = ISL1 + 2 * f, il = is + 1;
      const long long cnt = fam_count(f);
      Acc acc = 0;
      for (long long e = 0; e < cnt; ++e)
        acc += Acc((v[is][e] + a * S[D.f[is] + e]) * (v[il][e] + a * S[D.f[il] + e]));
      g = f == 0 ? acc : g + acc;
    }
    return T(g / Acc(P.mtot));
  }
  // rc_f = sl λ (+ dsl dλ − shift when `corr`)
  __device__ void set_rc(const DirOff& D, bool corr, T shift) {
    for (int f = 0; f < 5; ++f) {
      const int is = ISL1 + 2 * f, il = is + 1;
      const long long cnt = fam_count(f);
      for (long long e = 0; e < cnt; ++e) {
        const T p = v[is][e] * v[il][e];
        S[ly.rc[f] + e] = corr ? (p + S[D.f[is] + e] * S[D.f[il] + e]) - shift : p;
      }
    }
  }
  // Gondzio rhs: the capped distance of the trial products from [lo, hi]
  __device__ void set_rc_outlier(const DirOff& D, T ab, T lo, T hi, T cap) {
    for (int f = 0; f < 5; ++f) {
      const int is = ISL1 + 2 * f, il = is + 1;
      const long long cnt = fam_count(f);
      for (long long e = 0; e < cnt; ++e) {
        const T p = (v[is][e] + ab * S[D.f[is] + e]) * (v[il][e] + ab * S[D.f[il] + e]);
        const T t = pmin(pmax(p, lo), hi);
        S[ly.rc[f] + e] = pmin(pmax(p - t, -cap), cap);
      }
    }
  }
  // D_cand += D_cur over every field; returns whether all entries are finite
  __device__ bool add_into(const DirOff& cand, const DirOff& cur) const {
    long long sz[kNCarry];
    carry_sizes(dm, sz);
    bool ok = true;
    for (int f = 0; f < kNCarry; ++f)
      for (long long e = 0; e < sz[f]; ++e) {
        const T x = S[cur.f[f] + e] + S[cand.f[f] + e];
        S[cand.f[f] + e] = x;
        ok = ok && isfinite(x);
      }
    return ok;
  }

  __device__ void run(long long t) {
    residuals();
    factor();
    // predictor: the K Woodbury columns and the predictor rhs in one solve
    const DirOff& Da = ly.D[0];
    set_rc(Da, false, T(0));
    set_rhs(false);
    const int R = K + 1;
    const Out oz{ly.Zx, ly.Zu, ly.Zs, ly.Zr, R};
    h0_solve(true, R, oz);
    for (int c = 0; c < R; ++c) gdot(oz, c, ly.gd + c, R);
    capacitance();
    wb_correct(Da, oz, K, ly.gd + K, R);
    finish(Da, false);
    const T a_aff = all_step(Da);
    const T gap_aff = gap_at(Da, a_aff);
    const T ratio = gap_aff / (gap + T(1e-30));
    const T sigma = pmin(pmax(ratio * ratio * ratio, T(0)), T(1));
    // corrector
    set_rc(Da, true, sigma * gap);
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
    const T obj_now = (T(0.5) * (v[IU][0] * S[ly.gu] + v[IU][1] * S[ly.gu + 1]) + v[IR][0])
        + P.qslack1 * ((((v[IS][0] + v[IS][1]) + v[IS][2]) + v[IS][3]) + v[IS][4]);
    if (gap < P.gap_tol * (T(1) + fabs(obj_now))) a0 = T(0);
    if (P.itv < T(dm.early_iters)) a0 = pmin(a0, P.a_cap_early);
    const T grow = T(10) * gap + T(1e-9);
    const T a1 = gap_at(Dc, a0) > grow ? T(0.3) * a0 : a0;
    T a = gap_at(Dc, a1) > grow ? T(0.3) * a1 : a1;
    long long sz[kNCarry];
    carry_sizes(dm, sz);
    bool finite = isfinite(a);
    for (int f = 0; f < kNCarry && finite; ++f)
      for (long long e = 0; e < sz[f]; ++e)
        if (!isfinite(S[Dc.f[f] + e])) {
          finite = false;
          break;
        }
    if (!finite) a = T(0);
    const long long B = P.B;
    for (int f = 0; f < kNCarry; ++f) {
      const T* in = P.in[f] + t;
      T* out = P.out[f] + t;
      for (long long e = 0; e < sz[f]; ++e)
        out[e * B] = finite ? in[e * B] + a * S[Dc.f[f] + e] : in[e * B];
    }
    P.gap[t] = gap;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
cvar_ipm_iter_kernel(const __grid_constant__ Params<T> P) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P.B) return;
  Lane<T> lane(P, t);
  lane.run(t);
}

bool parse_dims(const int* ints, Dims* dm) {
  int* f[kNHeader] = {&dm->n, &dm->d, &dm->m, &dm->nlev, &dm->nFx, &dm->nFu, &dm->totalu,
                      &dm->totalx, &dm->nbr, &dm->gondzio, &dm->K, &dm->bdim, &dm->nrisk,
                      &dm->nsgn, &dm->early_iters};
  for (int i = 0; i < kNHeader; ++i) *f[i] = ints[i];
  // the kernel's algebra is written for these sizes
  if (dm->n != 4 || dm->d != 2 || dm->nFx != 4 || dm->nFu != 4 || dm->m < 1 ||
      dm->m > kMaxM || dm->nlev < 2 || dm->nlev > kMaxLevels || dm->gondzio < 0 ||
      dm->bdim < 1 || dm->K != dm->bdim * dm->m || dm->nrisk != dm->bdim * (2 + 2 * dm->m) ||
      dm->nsgn != dm->nrisk - dm->bdim)
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

template <typename T>
int launch(const void* const* ptrs, const int* ints, const double* dbl, long long B, int device,
           void* stream) {
  Params<T> P;
  if (B < 1 || !parse_dims(ints, &P.dm)) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  int o = 0;
  for (int i = 0; i < kNConst; ++i) P.c[i] = static_cast<const T*>(ptrs[o++]);
  for (int i = 0; i < kNShared; ++i) P.sh[i] = static_cast<const T*>(ptrs[o++]);
  for (int i = 0; i < kNCarry; ++i) P.in[i] = static_cast<const T*>(ptrs[o++]);
  for (int i = 0; i < kNCarry; ++i) P.out[i] = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.gap = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.scratch = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.B = B;
  T* dst[] = {&P.reg, &P.tau, &P.wmax, &P.gap_tol, &P.mtot, &P.bmin, &P.bmax, &P.a_cap_early,
              &P.qslack1, &P.itv};
  for (int i = 0; i < 10; ++i) *dst[i] = T(dbl[i]);
  P.ly = make_layout(P.dm);
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cvar_ipm_iter_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: 11 per-lane constants (CONST_ORDER), 9 shared constants
// (SHARED_ORDER), 14 carry in, 14 carry out (CARRY_ORDER), gap (1, B),
// scratch (bp_cvar_iter_scratch(ints), B); per-lane arrays batch-last, every
// array contiguous on CUDA device `device`. ints: n, d, m, nlev, nFx, nFu,
// totalu, totalx, n_branches, gondzio, K, bdim, nrisk, nsgn, early_iters,
// then (nb, l, lx, u0, x0, leaf) per level. dbl: reg, tau, w_max_eff,
// gap_tol, mtot, gondzio_bmin, gondzio_bmax, a_cap_early, Qslack[1], the
// iteration index. Launches on `stream` and returns the cudaError_t of the
// launch (0 on success); does not synchronize.
extern "C" int bp_cvar_iter_f32(const void* const* ptrs, const int* ints, const double* dbl,
                                long long B, int device, void* stream) {
  return launch<float>(ptrs, ints, dbl, B, device, stream);
}

extern "C" int bp_cvar_iter_f64(const void* const* ptrs, const int* ints, const double* dbl,
                                long long B, int device, void* stream) {
  return launch<double>(ptrs, ints, dbl, B, device, stream);
}

// scratch elements per lane for these dims, or -1 if the kernel does not take them
extern "C" long long bp_cvar_iter_scratch(const int* ints) {
  Dims dm;
  if (!parse_dims(ints, &dm)) return -1;
  return make_layout(dm).total;
}
