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
// linear sweep + forward rollout on the shared factor), per-tree Gondzio
// accept (longer step AND every candidate entry finite), fraction-to-boundary
// step, the gap_tol freeze and two 0.3x backtracks.
//
// Design: a team of one warp per tree, several trees a block, a persistent
// grid of (SMs x resident blocks) that walks over the batch.
// - Each block round stages its trees' constants and carry from the
//   batch-last arrays (element e of lane t at e*B + t): the block's trees are
//   adjacent lanes and every element row is read for all of them together,
//   so a sector serves 8 f32 trees. What goes to shared memory is copied by
//   cp.async, which a thread issues without waiting; what goes to the slot
//   passes through registers, 16 loads a batch. The new carry goes back the
//   same way.
// - Shared memory holds, a stage: the factor (K, H^-1 and the top rows of
//   the closed loop; its bottom rows are K), which first holds the factor's
//   inputs A, Qx2 -> Qx2_eff, Ru2 -> Ru2_eff and Dab2; B; qx -> the dual
//   residual rd_x, qu -> rd_u; the right-hand side of the sweeps and its
//   feed-forward term. A tree: the branch heads of the sweeps and Pterm2,
//   qterm -> rd_term. A block: Fx, Fu, bu and the stage tables.
// - The rest of a tree's working set lives in a tree-major scratch slot, one
//   per resident team, laid out row by row (entry r of every stage together)
//   so that the team's lanes read consecutive words: the carry, dh,
//   slack_lin, r1 (b1 until the residuals overwrite it) and two direction
//   records. It is sized to stay in L2: the barrier weights, r2, r3 and
//   rd_s are recomputed where they are read, and a direction is kept as its
//   dx, du and the complementarity targets rc it was solved with; its slack
//   and multiplier parts are affine in those and are made again where the
//   step rules and the carry update read them. A Gondzio candidate is the
//   record (dx + dx', du + du', rc + rc'), since a pure centrality direction
//   adds no residual terms.
// - Stages are numbered level by level, step-major and branch-minor, so the
//   branches that a sweep runs side by side (one lane each) and the stages
//   that a pass runs side by side (one lane each) touch consecutive words of
//   the slot and distinct banks of shared memory (a stage's shared slot has
//   an odd length).
// - Every per-tree decision (step length, Gondzio accept, freeze,
//   backtracks) is one value that the whole team holds: reductions run as a
//   butterfly of shuffles and are then broadcast from lane 0. Sums over
//   complementarity pairs (the gap, and the three coefficients of the trial
//   gap, a quadratic in the step) run in double, also in the float
//   instantiation.
// - Lanes exchange data through the slot and shared memory between warp
//   barriers; block barriers only frame a round.
//
// What bounds it on an H100: memory traffic. The least traffic of one
// iteration is the 16 constants read once, the 9 carry arrays read and
// written once and the gap written: 6,389 + 2 x 3,819 + 1 = 14,028 scalars
// per tree at N=8, NB=2, m=3 (totalu=97, totalx=106, 5 state rows, 4 input
// rows), i.e. 56,112 B per tree in f32 and 1.84 GB at B=32768, which is
// 0.55 ms at the 3.35 TB/s of an H100 SXM (data sheet, 700 W power limit).
// Its arithmetic, about 0.5 Mflop per tree, takes 0.24 ms at that card's
// 67 TFLOP/s f32 rate. The kernel is far from both: each team walks its
// scratch slot (34,964 B a tree in f32 at that size, all 1,056 resident
// slots 36.9 MB, inside L2) pass after pass, its passes are chains of
// divisions, and its sweeps serial chains of 17 stages; at B=32768 the
// staging, which reads one 32-byte sector of each element row a block,
// takes about a third of a round.
//
// The same source carries the phase kernels that replace the reference's
// K1 profile (scripts/profile_ipm_kernel.py, make_phase_fn): PHASE 0 =
// barrier weights + tree-Riccati factor, 1 = that + one linear sweep on the
// raw (qx, qu, qterm) and the forward rollout, 2 = the full iteration (the
// main kernel itself). Their plain versions are make_phase in
// belief_planning_tpu_torch/solvers/tree_qp_pl.py.

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kNConst = 16;
constexpr int kNCarry = 9;
constexpr int kNHeader = 10;     // ints before the level table
constexpr int kTeam = 32;        // threads of a team (one tree)
constexpr int kMaxTeams = 8;     // trees per block
constexpr int kMaxThreads = kTeam * kMaxTeams;
constexpr int kStageBatch = 16;  // loads in flight a thread while staging
constexpr unsigned kFull = 0xffffffffu;

// The dims a build instantiates the kernel for: state n, input d, state rows
// nFx (0: only the collision row is left) and input rows nFu. One library
// is built for each set, e.g. nvcc -DBP_QP_N=3 -DBP_QP_D=3 -DBP_QP_NFX=0
// -DBP_QP_NFU=6 (the quadruped); the default is the highway overtake's. The
// plain version takes any dims.
#ifndef BP_QP_N
#define BP_QP_N 4
#define BP_QP_D 2
#define BP_QP_NFX 4
#define BP_QP_NFU 4
#endif
template <int NX_, int NU_, int NFX_, int NFU_>
struct QpDims {
  static_assert(NX_ >= 1 && NU_ >= 1 && NU_ <= 3 && NFX_ >= 0 && NFU_ >= 1,
                "n >= 1, 1 <= d <= 3, nFx >= 0, nFu >= 1");
  static constexpr int NX = NX_, NU = NU_, NC = NFX_ + 1, NF = NFU_;
};
using Built = QpDims<BP_QP_N, BP_QP_D, BP_QP_NFX, BP_QP_NFU>;

// Sums over the complementarity pairs (1,358 a tree at the main path's
// size) accumulate in double, also in the float instantiation: per-lane
// partial sums, then a butterfly in double.
using Acc = double;

// order of the constants (CONST_ORDER on the Python side)
enum { QX2, QX, RU2, QU, DAB2, QTERM, PTERM2, SLACK_LIN, SLACK_QUAD, A_ST, B_ST,
       DH, B1, FX, FU, BU };
// order of the carry (CARRY_ORDER); a direction's fields use the same order
enum { IX, IU, IS, ISL1, ILAM1, ISL2, ILAM2, ISL3, ILAM3 };

struct Dims {
  int n, d, m, nlev, nFx, nFu, totalu, totalx, nbr, gondzio;
  int nb[kMaxLevels], l[kMaxLevels], lx[kMaxLevels], u0[kMaxLevels],
      x0[kMaxLevels], leaf[kMaxLevels], bo[kMaxLevels];  // bo: first branch id
};

// One direction in the slot: dx (row-major over the state's entries, totalx
// nodes a row), du, and the complementarity targets rc1..rc3 it was solved
// with (a row a constraint row, totalu stages a row).
struct Rec {
  int dx, du, rc[3];
};

// Element offsets in one team's tree-major scratch slot.
struct Layout {
  int v[kNCarry];   // the carry, staged in, updated in place
  int dh, slin, r1;
  Rec R[2];
  int total;
};

// Element offsets in one team's shared memory after its stage slots.
struct SmLayout {
  int Phead, Pt, rdt, ph, xe, sq, total;
};

// What a stage of a pass needs of the tree's shape (stage ids permuted)
struct StageInfo {
  int q;       // the stage's x node
  int pred;    // the previous stage, or -1 at the root
  int succ0;   // the first next stage (the next ones follow it), or -1
  int nsucc;   // number of next stages
};

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
  SmLayout sm;
};

// A stage's slot in shared memory (odd length: the lanes of a pass or a
// sweep read consecutive slots, so distinct banks).
template <int NX, int NU>
struct Slot {
  static constexpr int ND = NX + NU;
  // the factor: K (NU x ND), H^-1 (NU x NU), the closed loop's top rows (NX x ND)
  static constexpr int K = 0, Hi = NU * ND, Acl = Hi + NU * NU, Factor = Acl + NX * ND;
  // the factor's inputs, in its place until a Riccati step overwrites them
  static constexpr int A = 0, Q = NX * NX, R = Q + NX * NX, D = R + NU * NU;
  static constexpr int Bm = Factor, Rdx = Bm + NX * NU, Rdu = Rdx + NX, Qe = Rdu + NU,
                       Qu = Qe + NX, Kf = Qu + NU;
  static constexpr int size = (Kf + NU) | 1;
  static_assert(D + NU * NU <= Factor, "a stage's factor inputs fit its factor");
};

Layout make_layout(const Dims& dm) {
  const int U = dm.totalu, X = dm.totalx, n = dm.n, d = dm.d, Nc = dm.nFx + 1, F = dm.nFu;
  Layout L;
  int o = 0;
  auto take = [&o](int sz) { const int r = o; o += sz; return r; };
  const int sizes[kNCarry] = {X * n, U * d, U * Nc, U * Nc, U * Nc, U * F, U * F, U * Nc, U * Nc};
  for (int f = 0; f < kNCarry; ++f) L.v[f] = take(sizes[f]);
  L.dh = take(U * n);
  L.slin = take(U);
  L.r1 = take(U * Nc);
  for (int i = 0; i < 2; ++i) {
    L.R[i].dx = take(X * n);
    L.R[i].du = take(U * d);
    L.R[i].rc[0] = take(U * Nc);
    L.R[i].rc[1] = take(U * F);
    L.R[i].rc[2] = take(U * Nc);
  }
  L.total = o;
  return L;
}

template <int NX, int NU>
SmLayout make_sm_layout(const Dims& dm) {
  constexpr int ND = NX + NU;
  SmLayout L;
  int o = Slot<NX, NU>::size * dm.totalu;
  auto take = [&o](int sz) { const int r = o; o += sz; return r; };
  const int nleaf = dm.nb[dm.nlev - 1];
  L.Phead = take(dm.nbr * ND * ND);
  L.Pt = take(nleaf * NX * NX);
  L.rdt = take(nleaf * NX);
  L.ph = take(dm.nbr * ND);
  L.xe = take(dm.nbr * ND);
  L.sq = take(1);
  L.total = o;
  return L;
}

// the block's shared constants Fx, Fu, bu in shared memory
__host__ __device__ inline int n_shared(const Dims& dm) {
  return dm.nFx * dm.n + dm.nFu * dm.d + dm.nFu;
}
// the block's int tables: StageInfo a stage, then the stage and node permutations
int n_table_ints(const Dims& dm) { return 4 * dm.totalu + dm.totalu + dm.totalx; }

// min / max that propagate NaN, as torch.minimum / jnp.minimum do
template <typename T>
__device__ __forceinline__ T pmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// The largest step in [0, 1] that keeps v + a dv >= 0 for one entry (inf
// where dv >= 0 or NaN: such an entry bounds nothing), NaN-propagating as the
// plain version's minimum. A non-bounding entry divides by -1, so that no
// lane takes the slow path of 0/0.
template <typename T>
__device__ __forceinline__ T step_ratio(T v, T dv) {
  const bool neg = dv < T(0);
  const T r = -v / (neg ? dv : T(-1));
  return neg ? r : T(INFINITY);
}

// Team reductions: a butterfly over the team, then its lane 0's value for all
template <typename V>
__device__ __forceinline__ V team_sum(V v, unsigned mask) {
#pragma unroll
  for (int o = kTeam / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, kTeam);
  return __shfl_sync(mask, v, 0, kTeam);
}
template <typename V>
__device__ __forceinline__ V team_min(V v, unsigned mask) {
#pragma unroll
  for (int o = kTeam / 2; o > 0; o >>= 1) v = pmin(v, __shfl_xor_sync(mask, v, o, kTeam));
  return __shfl_sync(mask, v, 0, kTeam);
}
__device__ __forceinline__ bool team_all(bool b, unsigned mask) {
  int v = b ? 1 : 0;
#pragma unroll
  for (int o = kTeam / 2; o > 0; o >>= 1) v &= __shfl_xor_sync(mask, v, o, kTeam);
  return __shfl_sync(mask, v, 0, kTeam) != 0;
}

// A direction's fraction-to-boundary step over every complementarity entry,
// whether all its entries are finite, and the three coefficients of its
// trial gap sum_pairs (v + a dv)(l + a dl) = s0 + a s1 + a^2 s2.
template <typename T>
struct Step {
  T a;
  bool fin;
  Acc s0, s1, s2;
};

template <typename T, int NX, int NU, int NC, int NF>
struct Team {
  static constexpr int ND = NX + NU;
  using SL = Slot<NX, NU>;
  const Params<T>& P;
  const Dims& dm;
  const Layout& ly;
  const SmLayout& sm;
  T* S;                     // this tree's scratch slot
  T* F;                     // this tree's shared memory
  const T* Fx;              // (NC - 1) x NX, shared by the block
  const T* Fu;              // NF x NU
  const T* bu;              // NF
  const StageInfo* stg;
  int lane;
  unsigned mask;
  int U, X;
  T sq, gap;

  // The carry, residual and weight values of one stage's entries
  struct Stage {
    T s[NC], s1[NC], l1[NC], s3[NC], l3[NC], r1[NC], s2[NF], l2[NF], dh[NX], u[NU], slin;
  };
  // One direction at one stage: dx at its node, du, and its rc
  struct Dir {
    T dx[NX], du[NU], rc1[NC], rc2[NF], rc3[NC];
  };
  // The slack and multiplier parts of a direction at one stage
  struct Fields {
    T dsv[NC], dsl1[NC], dlam1[NC], dsl3[NC], dlam3[NC], dsl2[NF], dlam2[NF];
  };

  __device__ __forceinline__ Team(const Params<T>& P_, T* S_, T* F_, const T* shc,
                                  const StageInfo* stg_, int lane_, unsigned mask_)
      : P(P_), dm(P_.dm), ly(P_.ly), sm(P_.sm), S(S_), F(F_), Fx(shc),
        Fu(shc + P_.dm.nFx * NX), bu(shc + P_.dm.nFx * NX + P_.dm.nFu * NU), stg(stg_),
        lane(lane_), mask(mask_) {
    U = dm.totalu;
    X = dm.totalx;
    sq = F[sm.sq];
  }

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  __device__ __forceinline__ T* slot(int p) const { return F + p * SL::size; }
  // row r of carry field f at stage (or node, for x) p
  __device__ __forceinline__ T& cv(int f, int r, int p) const {
    return S[ly.v[f] + r * (f == IX ? X : U) + p];
  }

  // ---- constraint rows: row 0 is -dh.x, rows 1.. are Fx x ----------------
  __device__ __forceinline__ T row_val(int r, const T* dh, const T* xv) const {
    if (r == 0) {
      T acc = dh[0] * xv[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) acc += dh[i] * xv[i];
      return -acc;
    }
    const T* f = Fx + (r - 1) * NX;
    T acc = f[0] * xv[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) acc += f[i] * xv[i];
    return acc;
  }
  __device__ __forceinline__ T fu_val(int q, const T* uv) const {
    T acc = Fu[q * NU] * uv[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) acc += Fu[q * NU + a] * uv[a];
    return acc;
  }

  // ---- per-stage loads ------------------------------------------------------
  // the weights' inputs only (the phases), or everything the passes read
  template <bool FULL>
  __device__ __forceinline__ void load_stage(int p, Stage& v) const {
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      v.s1[r] = cv(ISL1, r, p);
      v.l1[r] = cv(ILAM1, r, p);
      v.s3[r] = cv(ISL3, r, p);
      v.l3[r] = cv(ILAM3, r, p);
      if constexpr (FULL) {
        v.s[r] = cv(IS, r, p);
        v.r1[r] = S[ly.r1 + r * U + p];
      }
    }
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      v.s2[q] = cv(ISL2, q, p);
      v.l2[q] = cv(ILAM2, q, p);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) v.dh[i] = S[ly.dh + i * U + p];
    if constexpr (FULL) {
#pragma unroll
      for (int a = 0; a < NU; ++a) v.u[a] = cv(IU, a, p);
      v.slin = S[ly.slin + p];
    }
  }
  // a record's dx, du and rc at stage p (node q); `affine`: rc = sl * lam
  __device__ __forceinline__ void load_dir(const Rec& R, bool affine, int p, int q,
                                           const Stage& v, Dir& o) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) o.dx[i] = S[R.dx + i * X + q];
#pragma unroll
    for (int a = 0; a < NU; ++a) o.du[a] = S[R.du + a * U + p];
    if (affine) {
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        o.rc1[r] = v.s1[r] * v.l1[r];
        o.rc3[r] = v.s3[r] * v.l3[r];
      }
#pragma unroll
      for (int q2 = 0; q2 < NF; ++q2) o.rc2[q2] = v.s2[q2] * v.l2[q2];
    } else {
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        o.rc1[r] = S[R.rc[0] + r * U + p];
        o.rc3[r] = S[R.rc[2] + r * U + p];
      }
#pragma unroll
      for (int q2 = 0; q2 < NF; ++q2) o.rc2[q2] = S[R.rc[1] + q2 * U + p];
    }
  }
  __device__ __forceinline__ void store_dir(const Rec& R, int p, int q, const Dir& o) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) S[R.dx + i * X + q] = o.dx[i];
#pragma unroll
    for (int a = 0; a < NU; ++a) S[R.du + a * U + p] = o.du[a];
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      S[R.rc[0] + r * U + p] = o.rc1[r];
      S[R.rc[2] + r * U + p] = o.rc3[r];
    }
#pragma unroll
    for (int q2 = 0; q2 < NF; ++q2) S[R.rc[1] + q2 * U + p] = o.rc2[q2];
  }

  // ---- the terms the plain version computes once and this kernel remakes ---
  __device__ __forceinline__ T w1_of(const Stage& v, int r) const {
    return pmin(v.l1[r] / v.s1[r], P.wmax);
  }
  __device__ __forceinline__ T kap_of(const Stage& v, int r, T w1) const {
    return ((sq + w1) + pmin(v.l3[r] / v.s3[r], P.wmax)) + P.reg;
  }
  __device__ __forceinline__ T r2_of(const Stage& v, int q) const {
    return (fu_val(q, v.u) + v.s2[q]) - bu[q];
  }
  __device__ __forceinline__ T r3_of(const Stage& v, int r) const { return -v.s[r] + v.s3[r]; }
  __device__ __forceinline__ T rds_of(const Stage& v, int r) const {
    return ((sq * v.s[r] + v.slin) - v.l1[r]) - v.l3[r];
  }

  // The slack and multiplier parts of the (non-pure) direction `o` at one
  // stage: the plain version's kkt_solve tail and direction().
  __device__ __forceinline__ void fields(const Stage& v, const Dir& o, Fields& f) const {
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const T w1 = w1_of(v, r), kap = kap_of(v, r, w1);
      const T r3 = r3_of(v, r);
      const T ex1 = (-o.rc1[r] + v.l1[r] * v.r1[r]) / v.s1[r];
      const T ex3 = (-o.rc3[r] + v.l3[r] * r3) / v.s3[r];
      const T qs = (rds_of(v, r) - ex1) - ex3;
      const T rv = row_val(r, v.dh, o.dx);
      const T dsv = (w1 * rv - qs) / kap;
      const T drow1 = rv - dsv;
      const T dsl1 = -v.r1[r] - drow1;
      const T dsl3 = -r3 + dsv;
      f.dsv[r] = dsv;
      f.dsl1[r] = dsl1;
      f.dlam1[r] = (-o.rc1[r] - v.l1[r] * dsl1) / v.s1[r];
      f.dsl3[r] = dsl3;
      f.dlam3[r] = (-o.rc3[r] - v.l3[r] * dsl3) / v.s3[r];
    }
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      const T dsl2 = -r2_of(v, q) - fu_val(q, o.du);
      f.dsl2[q] = dsl2;
      f.dlam2[q] = (-o.rc2[q] - v.l2[q] * dsl2) / v.s2[q];
    }
  }

  // ---- residuals, gap, dual residuals, the factor's inputs -----------------
  // FULL: the iteration's; else the phases' (the factor's inputs alone).
  template <bool FULL>
  __device__ __forceinline__ void residuals() {
    const T reg = P.reg, wmax = P.wmax;
    Acc g = 0;
    for (int p = lane; p < U; p += kTeam) {
      const StageInfo si = stg[p];
      T* sl = slot(p);
      Stage v;
      load_stage<FULL>(p, v);
      T Qx[NX][NX], Ru[NU][NU];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) Qx[i][j] = sl[SL::Q + i * NX + j];
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < NU; ++c) Ru[a][c] = sl[SL::R + a * NU + c];
      if constexpr (FULL) {
        T xv[NX], qxv[NX], quv[NU], Dab[NU][NU], up[NU], b1v[NC];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          xv[i] = cv(IX, i, si.q);
          qxv[i] = sl[SL::Rdx + i];
        }
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          quv[a] = sl[SL::Rdu + a];
          up[a] = si.pred >= 0 ? cv(IU, a, si.pred) : T(0);
#pragma unroll
          for (int c = 0; c < NU; ++c) Dab[a][c] = sl[SL::D + a * NU + c];
        }
#pragma unroll
        for (int r = 0; r < NC; ++r) b1v[r] = v.r1[r];   // b1, staged into r1's place
        // r1 and the gap
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          S[ly.r1 + r * U + p] = ((row_val(r, v.dh, xv) - v.s[r]) + v.s1[r]) - b1v[r];
          g += Acc(v.s1[r] * v.l1[r]);
          g += Acc(v.s3[r] * v.l3[r]);
        }
#pragma unroll
        for (int q = 0; q < NF; ++q) g += Acc(v.s2[q] * v.l2[q]);
        // rd_x = Qx2 x + qx + rowsᵀ λ1
        T rdx[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T rT = T(0);
#pragma unroll
          for (int r = 1; r < NC; ++r) rT += Fx[(r - 1) * NX + i] * v.l1[r];
          T acc = Qx[i][0] * xv[0];
#pragma unroll
          for (int j = 1; j < NX; ++j) acc += Qx[i][j] * xv[j];
          rdx[i] = (acc + qxv[i]) + (-v.dh[i] * v.l1[0] + rT);
        }
        // rd_u = Ru2 u + qu + Fuᵀ λ2 + the rate-coupling edges: fwd =
        // Dab2_sᵀ u_pred(s), bwd = Σ_succ Dab2_succ u_succ
        T rdu[NU];
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          T fT = T(0);
#pragma unroll
          for (int q = 0; q < NF; ++q) fT += Fu[q * NU + a] * v.l2[q];
          T fwd = T(0);
          if (si.pred >= 0) {
            fwd = Dab[0][a] * up[0];
#pragma unroll
            for (int c = 1; c < NU; ++c) fwd += Dab[c][a] * up[c];
          }
          T bwd = T(0);
          for (int i = 0; i < si.nsucc; ++i) {
            const int ps = si.succ0 + i;
            const T* Ds = slot(ps) + SL::D;
            T acc = Ds[a * NU] * cv(IU, 0, ps);
#pragma unroll
            for (int c = 1; c < NU; ++c) acc += Ds[a * NU + c] * cv(IU, c, ps);
            bwd = i == 0 ? acc : bwd + acc;
          }
          T acc = Ru[a][0] * v.u[0];
#pragma unroll
          for (int c = 1; c < NU; ++c) acc += Ru[a][c] * v.u[c];
          rdu[a] = ((acc + quv[a]) + fT) + (fwd + bwd);
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) sl[SL::Rdx + i] = rdx[i];
#pragma unroll
        for (int a = 0; a < NU; ++a) sl[SL::Rdu + a] = rdu[a];
      }
      // Qx2_eff = Qx2 + Σ_r c_r F_r F_rᵀ + reg I, c = w1 − w1²/κ, rows [−dh; Fx]
      T Qe[NX][NX];
      {
        const T w0 = w1_of(v, 0), c0 = w0 - w0 * w0 / kap_of(v, 0, w0);
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) Qe[i][j] = c0 * v.dh[i] * v.dh[j];
#pragma unroll
        for (int r = 1; r < NC; ++r) {
          const T w = w1_of(v, r), c = w - w * w / kap_of(v, r, w);
          const T* f = Fx + (r - 1) * NX;
#pragma unroll
          for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int j = 0; j < NX; ++j) Qe[i][j] += c * (f[i] * f[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          sl[SL::Q + i * NX + j] = (Qx[i][j] + Qe[i][j]) + (i == j ? reg : T(0));
      // Ru2_eff = (Ru2 + reg I) + Σ_q w2_q Fu_q Fu_qᵀ
      T Re[NU][NU];
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < NU; ++c) Re[a][c] = T(0);
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const T w = pmin(v.l2[q] / v.s2[q], wmax);
        const T* f = Fu + q * NU;
#pragma unroll
        for (int a = 0; a < NU; ++a)
#pragma unroll
          for (int c = 0; c < NU; ++c) Re[a][c] += w * (f[a] * f[c]);
      }
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < NU; ++c)
          sl[SL::R + a * NU + c] = (Ru[a][c] + (a == c ? reg : T(0))) + Re[a][c];
    }
    if constexpr (FULL) {
      // rd_term = Pterm2 x_term + qterm, over qterm in shared memory
      const int kl = dm.nlev - 1;
      for (int b = lane; b < dm.nb[kl]; b += kTeam) {
        const int qt = dm.x0[kl] + dm.l[kl] * dm.nb[kl] + b;
        T xt[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) xt[i] = cv(IX, i, qt);
        const T* Pt = F + sm.Pt + b * NX * NX;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T acc = Pt[i * NX] * xt[0];
#pragma unroll
          for (int j = 1; j < NX; ++j) acc += Pt[i * NX + j] * xt[j];
          F[sm.rdt + b * NX + i] = acc + F[sm.rdt + b * NX + i];
        }
      }
      gap = T(team_sum(g, mask) / Acc(P.mtot));
    }
    sync();
  }

  // ---- backward quadratic sweep (tree Riccati) ----------------------------
  // Reads the stage's inputs from its slot; the outputs overwrite them only
  // after the last read.
  __device__ __forceinline__ void riccati_step(int p, T (&W)[ND][ND]) const {
    T* sl = slot(p);
    T A[NX][NX], Bm[NX][NU], Qe[NX][NX], Re[NU][NU], Dab[NU][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        A[i][j] = sl[SL::A + i * NX + j];
        Qe[i][j] = sl[SL::Q + i * NX + j];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) Bm[i][a] = sl[SL::Bm + i * NU + a];
    }
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        Re[a][c] = sl[SL::R + a * NU + c];
        Dab[a][c] = sl[SL::D + a * NU + c];
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
        H[a][c] = Re[a][c] + (acc + BtPxu[a][c] + BtPxu[c][a] + W[NX + a][NX + c]);
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
      for (int c = 0; c < NU; ++c) L[a][NX + c] = Dab[c][a];
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
    // store K = −H⁻¹L, H⁻¹ and the top rows of Acl = [[B K + [A 0]], [K]]
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < ND; ++c) sl[SL::K + a * ND + c] = -HL[a][c];
#pragma unroll
      for (int c = 0; c < NU; ++c) sl[SL::Hi + a * NU + c] = Hi[a][c];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        T acc = Bm[i][0] * (-HL[0][c]);
#pragma unroll
        for (int a = 1; a < NU; ++a) acc += Bm[i][a] * (-HL[a][c]);
        sl[SL::Acl + i * ND + c] = c < NX ? acc + A[i][c] : acc;
      }
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

  // Σ_{i<m} blocks[first + i] of shared memory (sequential, child order)
  __device__ __forceinline__ void fold(int base, int first, int size, T* out) const {
    for (int e = 0; e < size; ++e) out[e] = F[base + first * size + e];
    for (int i = 1; i < dm.m; ++i)
      for (int e = 0; e < size; ++e) out[e] += F[base + (first + i) * size + e];
  }

  // The factor, level by level from the leaves; a lane a branch.
  __device__ __forceinline__ void factor() {
    for (int k = dm.nlev - 1; k >= 0; --k) {
      for (int b = lane; b < dm.nb[k]; b += kTeam) {
        T W[ND][ND];
        if (k == dm.nlev - 1) {
          const T* Pt = F + sm.Pt + b * NX * NX;
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j)
              W[i][j] = (i < NX && j < NX) ? Pt[i * NX + j] + (i == j ? P.reg : T(0)) : T(0);
        } else {
          fold(sm.Phead, dm.bo[k + 1] + b * dm.m, ND * ND, &W[0][0]);
        }
        for (int j = dm.l[k] - 1; j >= 0; --j) riccati_step(dm.u0[k] + j * dm.nb[k] + b, W);
        if (k > 0) {
          T* h = F + sm.Phead + (dm.bo[k] + b) * ND * ND;
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j) h[i * ND + j] = W[i][j];
        }
      }
      sync();
    }
  }

  // ---- one KKT solve on the factor -----------------------------------------
  // The backward linear sweep on the right-hand side in the stage slots
  // (x part at offset oqe, u part at oqu; the terminal rd_term if `term`)
  // → kff, then the forward rollout from a zero root state → R's dx, du.
  __device__ __forceinline__ void sweep(int oqe, int oqu, bool term, const Rec& R) const {
    for (int k = dm.nlev - 1; k >= 0; --k) {
      for (int b = lane; b < dm.nb[k]; b += kTeam) {
        T p[ND];
        if (k == dm.nlev - 1) {
#pragma unroll
          for (int i = 0; i < ND; ++i) p[i] = (i < NX && term) ? F[sm.rdt + b * NX + i] : T(0);
        } else {
          fold(sm.ph, dm.bo[k + 1] + b * dm.m, ND, p);
        }
        for (int j = dm.l[k] - 1; j >= 0; --j) {
          T* sl = slot(dm.u0[k] + j * dm.nb[k] + b);
          T qr[NU], lu[NU];
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            qr[a] = sl[oqu + a];
            T acc = sl[SL::Bm + a] * p[0];
#pragma unroll
            for (int i = 1; i < NX; ++i) acc += sl[SL::Bm + i * NU + a] * p[i];
            lu[a] = (qr[a] + acc) + p[NX + a];
          }
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            T acc = sl[SL::Hi + a * NU] * lu[0];
#pragma unroll
            for (int c = 1; c < NU; ++c) acc += sl[SL::Hi + a * NU + c] * lu[c];
            sl[SL::Kf + a] = -acc;
          }
          // the closed loop's rows e ≥ NX are K's rows
          auto acl = [sl](int e, int c) {
            return e < NX ? sl[SL::Acl + e * ND + c] : sl[SL::K + (e - NX) * ND + c];
          };
          T pn[ND];
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            T t1 = acl(0, c) * p[0];
#pragma unroll
            for (int e = 1; e < ND; ++e) t1 += acl(e, c) * p[e];
            T t2 = sl[SL::K + c] * qr[0];
#pragma unroll
            for (int a = 1; a < NU; ++a) t2 += sl[SL::K + a * ND + c] * qr[a];
            pn[c] = t1 + t2;
          }
#pragma unroll
          for (int c = 0; c < ND; ++c) p[c] = c < NX ? pn[c] + sl[oqe + c] : pn[c];
        }
        if (k > 0) {
          T* h = F + sm.ph + (dm.bo[k] + b) * ND;
#pragma unroll
          for (int i = 0; i < ND; ++i) h[i] = p[i];
        }
      }
      sync();
    }
    for (int k = 0; k < dm.nlev; ++k) {
      for (int b = lane; b < dm.nb[k]; b += kTeam) {
        T xi[ND];
        if (k == 0) {
#pragma unroll
          for (int i = 0; i < ND; ++i) xi[i] = T(0);
        } else {
          const T* h = F + sm.xe + (dm.bo[k - 1] + b / dm.m) * ND;
#pragma unroll
          for (int i = 0; i < ND; ++i) xi[i] = h[i];
        }
        for (int j = 0; j < dm.l[k]; ++j) {
          const int p = dm.u0[k] + j * dm.nb[k] + b, q = dm.x0[k] + j * dm.nb[k] + b;
          const T* sl = slot(p);
          T kf[NU], du[NU];
#pragma unroll
          for (int a = 0; a < NU; ++a) kf[a] = sl[SL::Kf + a];
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            T acc = sl[SL::K + a * ND] * xi[0];
#pragma unroll
            for (int c = 1; c < ND; ++c) acc += sl[SL::K + a * ND + c] * xi[c];
            du[a] = acc + kf[a];
            S[R.du + a * U + p] = du[a];
          }
#pragma unroll
          for (int i = 0; i < NX; ++i) S[R.dx + i * X + q] = xi[i];
          // the closed loop's rows e ≥ NX give du itself
          T xn[ND];
#pragma unroll
          for (int e = 0; e < NX; ++e) {
            T acc = sl[SL::Acl + e * ND] * xi[0];
#pragma unroll
            for (int c = 1; c < ND; ++c) acc += sl[SL::Acl + e * ND + c] * xi[c];
            T bk = sl[SL::Bm + e * NU] * kf[0];
#pragma unroll
            for (int a = 1; a < NU; ++a) bk += sl[SL::Bm + e * NU + a] * kf[a];
            xn[e] = acc + bk;
          }
#pragma unroll
          for (int a = 0; a < NU; ++a) xn[NX + a] = du[a];
#pragma unroll
          for (int e = 0; e < ND; ++e) xi[e] = xn[e];
        }
        if (dm.leaf[k]) {
          const int qt = dm.x0[k] + dm.l[k] * dm.nb[k] + b;
#pragma unroll
          for (int i = 0; i < NX; ++i) S[R.dx + i * X + qt] = xi[i];
        }
        if (k + 1 < dm.nlev) {
          T* h = F + sm.xe + (dm.bo[k] + b) * ND;
#pragma unroll
          for (int i = 0; i < ND; ++i) h[i] = xi[i];
        }
      }
      sync();
    }
  }

  // The right-hand side of a solve into the stage slots (Qe, Qu), from
  // complementarity targets: MODE 0 the predictor's (sl λ), 1 the
  // corrector's (sl λ + dsl dλ of the predictor in R[0] − shift), 2 a
  // Gondzio corrector's (the capped distance of the trial products of the
  // record `src` at step ab from [lo, hi]; a pure rhs). Modes 1 and 2 store
  // their targets into `dst`.
  template <int MODE>
  __device__ __forceinline__ void rhs(const Rec& src, const Rec& dst, T shift, T ab, T lo, T hi,
                                      T cap) const {
    constexpr bool pure = MODE == 2;
    for (int p = lane; p < U; p += kTeam) {
      const StageInfo si = stg[p];
      Stage v;
      load_stage<true>(p, v);
      T rc1[NC], rc2[NF], rc3[NC];
      if constexpr (MODE == 0) {
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          rc1[r] = v.s1[r] * v.l1[r];
          rc3[r] = v.s3[r] * v.l3[r];
        }
#pragma unroll
        for (int q = 0; q < NF; ++q) rc2[q] = v.s2[q] * v.l2[q];
      } else {
        Dir o;
        load_dir(src, MODE == 1, p, si.q, v, o);
        Fields f;
        fields(v, o, f);
        auto rc = [&](T s, T l, T ds, T dl) {
          if constexpr (MODE == 1) {
            return (s * l + ds * dl) - shift;
          } else {
            const T pr = (s + ab * ds) * (l + ab * dl);
            const T t = pmin(pmax(pr, lo), hi);
            return pmin(pmax(pr - t, -cap), cap);
          }
        };
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          rc1[r] = rc(v.s1[r], v.l1[r], f.dsl1[r], f.dlam1[r]);
          rc3[r] = rc(v.s3[r], v.l3[r], f.dsl3[r], f.dlam3[r]);
          S[dst.rc[0] + r * U + p] = rc1[r];
          S[dst.rc[2] + r * U + p] = rc3[r];
        }
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          rc2[q] = rc(v.s2[q], v.l2[q], f.dsl2[q], f.dlam2[q]);
          S[dst.rc[1] + q * U + p] = rc2[q];
        }
      }
      T* sl = slot(p);
      T eT[NX], vT[NX], e0 = T(0), v0 = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) { eT[i] = T(0); vT[i] = T(0); }
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        const T ex1 = pure ? -rc1[r] / v.s1[r] : (-rc1[r] + v.l1[r] * v.r1[r]) / v.s1[r];
        const T ex3 = pure ? -rc3[r] / v.s3[r]
                           : (-rc3[r] + v.l3[r] * r3_of(v, r)) / v.s3[r];
        const T qs = pure ? -ex1 - ex3 : (rds_of(v, r) - ex1) - ex3;
        const T w1 = w1_of(v, r);
        const T vv = (w1 / kap_of(v, r, w1)) * qs;
        if (r == 0) {
          e0 = ex1;
          v0 = vv;
        } else {
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            eT[i] += Fx[(r - 1) * NX + i] * ex1;
            vT[i] += Fx[(r - 1) * NX + i] * vv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const T d = v.dh[i];
        const T rowT_ex = -d * e0 + eT[i];
        const T qxr = pure ? rowT_ex : sl[SL::Rdx + i] + rowT_ex;
        sl[SL::Qe + i] = qxr + (-d * v0 + vT[i]);
      }
      T fT[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) fT[a] = T(0);
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const T ex2 = pure ? -rc2[q] / v.s2[q] : (-rc2[q] + v.l2[q] * r2_of(v, q)) / v.s2[q];
#pragma unroll
        for (int a = 0; a < NU; ++a) fT[a] += Fu[q * NU + a] * ex2;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) sl[SL::Qu + a] = pure ? fT[a] : sl[SL::Rdu + a] + fT[a];
    }
    sync();
  }

  // ---- step rules --------------------------------------------------------------
  // The step, the trial-gap coefficients and (ADD) the finiteness of the
  // record R (rc affine: the predictor); ADD first makes R the Gondzio
  // candidate R + cur, as a record.
  template <bool ADD>
  __device__ __forceinline__ Step<T> step_of(const Rec& R, bool affine, const Rec& cur) const {
    T am = T(1);
    bool fin = true;
    Acc s0 = 0, s1 = 0, s2 = 0;
    auto pair = [&](T s, T l, T ds, T dl) {
      am = pmin(am, pmin(step_ratio(s, ds), step_ratio(l, dl)));
      s0 += Acc(s) * Acc(l);
      s1 += Acc(s) * Acc(dl) + Acc(l) * Acc(ds);
      s2 += Acc(ds) * Acc(dl);
      if constexpr (ADD) fin = fin & isfinite(ds) & isfinite(dl);
    };
    for (int p = lane; p < U; p += kTeam) {
      const StageInfo si = stg[p];
      Stage v;
      load_stage<true>(p, v);
      Dir o;
      load_dir(R, affine, p, si.q, v, o);
      if constexpr (ADD) {
        Dir c;
        load_dir(cur, false, p, si.q, v, c);
#pragma unroll
        for (int i = 0; i < NX; ++i) o.dx[i] = c.dx[i] + o.dx[i];
#pragma unroll
        for (int a = 0; a < NU; ++a) o.du[a] = c.du[a] + o.du[a];
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          o.rc1[r] = c.rc1[r] + o.rc1[r];
          o.rc3[r] = c.rc3[r] + o.rc3[r];
        }
#pragma unroll
        for (int q = 0; q < NF; ++q) o.rc2[q] = c.rc2[q] + o.rc2[q];
        store_dir(R, p, si.q, o);
      }
      Fields f;
      fields(v, o, f);
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        pair(v.s1[r], v.l1[r], f.dsl1[r], f.dlam1[r]);
        pair(v.s3[r], v.l3[r], f.dsl3[r], f.dlam3[r]);
        if constexpr (ADD) fin = fin & isfinite(f.dsv[r]);
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) pair(v.s2[q], v.l2[q], f.dsl2[q], f.dlam2[q]);
      if constexpr (ADD) {
#pragma unroll
        for (int i = 0; i < NX; ++i) fin = fin & isfinite(o.dx[i]);
#pragma unroll
        for (int a = 0; a < NU; ++a) fin = fin & isfinite(o.du[a]);
      }
    }
    if constexpr (ADD) {
      // the terminal nodes, which no stage reads
      const int kl = dm.nlev - 1;
      for (int b = lane; b < dm.nb[kl]; b += kTeam) {
        const int qt = dm.x0[kl] + dm.l[kl] * dm.nb[kl] + b;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          const T y = S[cur.dx + i * X + qt] + S[R.dx + i * X + qt];
          S[R.dx + i * X + qt] = y;
          fin = fin & isfinite(y);
        }
      }
    }
    Step<T> st;
    st.a = team_min(am, mask);
    st.fin = ADD ? team_all(fin, mask) : true;
    st.s0 = team_sum(s0, mask);
    st.s1 = team_sum(s1, mask);
    st.s2 = team_sum(s2, mask);
    sync();
    return st;
  }

  // the mean complementarity product at v + a D
  __device__ __forceinline__ T gap_at(const Step<T>& st, T a) const {
    const Acc x = Acc(a);
    return T((st.s0 + x * (st.s1 + x * st.s2)) / Acc(P.mtot));
  }

  // the new carry v + a D of record R, in place in the slot
  __device__ __forceinline__ void update(const Rec& R, T a) const {
    for (int p = lane; p < U; p += kTeam) {
      const StageInfo si = stg[p];
      Stage v;
      load_stage<true>(p, v);
      Dir o;
      load_dir(R, false, p, si.q, v, o);
      Fields f;
      fields(v, o, f);
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        cv(IS, r, p) = v.s[r] + a * f.dsv[r];
        cv(ISL1, r, p) = v.s1[r] + a * f.dsl1[r];
        cv(ILAM1, r, p) = v.l1[r] + a * f.dlam1[r];
        cv(ISL3, r, p) = v.s3[r] + a * f.dsl3[r];
        cv(ILAM3, r, p) = v.l3[r] + a * f.dlam3[r];
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        cv(ISL2, q, p) = v.s2[q] + a * f.dsl2[q];
        cv(ILAM2, q, p) = v.l2[q] + a * f.dlam2[q];
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) cv(IU, c, p) = v.u[c] + a * o.du[c];
    }
    for (int e = lane; e < NX * X; e += kTeam) S[ly.v[IX] + e] += a * S[R.dx + e];
  }

  // PHASE 2: one full iteration (the main path); the new carry stays in
  // the slot for stage_out. PHASE 0 / 1: the profile's phases, which write
  // only t0 (Σ K + Σ Hinv, or Σ dx + Σ du over every stage) into the gap
  // output. The reference's phase kernels carry the whole state through and
  // nudge sl1 by 1e-30·t0 only to chain a scan of them inside one jit;
  // stream order chains CUDA launches, so these write t0 alone. t0 sums
  // ~1.5k values of a tree, in double.
  template <int PHASE>
  __device__ __forceinline__ void run(long long t) {
    if constexpr (PHASE < 2) {
      residuals<false>();
      factor();
      Acc t0 = 0;
      if constexpr (PHASE == 0) {
        for (int p = lane; p < U; p += kTeam)
#pragma unroll
          for (int e = 0; e < NU * ND + NU * NU; ++e) t0 += Acc(slot(p)[SL::K + e]);
      } else {
        const Rec& R = ly.R[0];
        sweep(SL::Rdx, SL::Rdu, true, R);
        for (int e = lane; e < NX * X; e += kTeam) t0 += Acc(S[R.dx + e]);
        for (int e = lane; e < NU * U; e += kTeam) t0 += Acc(S[R.du + e]);
      }
      t0 = team_sum(t0, mask);
      if (lane == 0) P.gap[t] = T(t0);
      return;
    }
    residuals<true>();
    factor();
    const Rec &R0 = ly.R[0], &R1 = ly.R[1];
    // predictor into R[0] (its targets sl λ are not stored), corrector into R[1]
    rhs<0>(R0, R0, T(0), T(0), T(0), T(0), T(0));
    sweep(SL::Qe, SL::Qu, true, R0);
    const Step<T> sa = step_of<false>(R0, true, R0);
    const T ratio = gap_at(sa, sa.a) / (gap + T(1e-30));
    const T sigma = pmin(pmax(ratio * ratio * ratio, T(0)), T(1));
    rhs<1>(R0, R1, sigma * gap, T(0), T(0), T(0), T(0));
    sweep(SL::Qe, SL::Qu, true, R1);
    int ic = 1;
    Step<T> cur = step_of<false>(R1, false, R1);
    for (int g = 0; g < dm.gondzio; ++g) {
      const Rec& Rc = ic ? R1 : R0;
      const Rec& Rd = ic ? R0 : R1;
      const T mu_t = sigma * gap + T(1e-30);
      const T ab = pmin(P.tau * cur.a + T(0.3), T(1));
      const T hi = P.bmax * mu_t;
      rhs<2>(Rc, Rd, T(0), ab, P.bmin * mu_t, hi, T(10) * hi);
      sweep(SL::Qe, SL::Qu, false, Rd);
      const Step<T> sc = step_of<true>(Rd, false, Rc);
      if (sc.a > cur.a && sc.fin) {
        ic = 1 - ic;
        cur = sc;
      }
    }
    T a0 = P.tau * cur.a;
    if (gap < P.gap_tol * (T(1) + fabs(gap))) a0 = T(0);
    const T grow = T(10) * gap + T(1e-10);
    const T a1 = gap_at(cur, a0) > grow ? T(0.3) * a0 : a0;
    const T a = gap_at(cur, a1) > grow ? T(0.3) * a1 : a1;
    update(ic ? R1 : R0, a);
    if (lane == 0) P.gap[t] = gap;
  }
};

// One element of a batch-last input into shared memory, asynchronously
// (cp.async, completed by stage_wait); the emulated build copies it.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void stage_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// Element rows of the block's trees between the batch-last arrays and the
// teams' scratch slots or shared memory. Thread tid takes tree tid % nT and
// elements tid / nT, + kTeam, ...: a warp reads kTeam / nT consecutive
// element rows of all the block's trees, so a sector serves nT trees. An
// array has `rows` rows of W entries (element e = row * W + col); `dst(tt,
// row, col)` is where an entry goes. A thread issues kStageBatch loads before
// it stores any, so that it waits one memory latency a batch.
template <int W, typename T, typename Dst>
__device__ __forceinline__ void copy_in(const T* src, int rows, long long B, long long base,
                                        int nv, int nT, Dst dst) {
  const int tt = threadIdx.x % nT, n = rows * W;
  if (tt >= nv) return;
  const T* s = src + base + tt;
  for (int e0 = threadIdx.x / nT; e0 < n; e0 += kTeam * kStageBatch) {
    T x[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kTeam;
      x[u] = e < n ? s[(long long)e * B] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kTeam;
      if (e < n) *dst(tt, e / W, e % W) = x[u];
    }
  }
}

// copy_in's mapping into shared memory, by cp.async, which a thread issues
// without waiting for any
template <int W, typename T, typename Dst>
__device__ __forceinline__ void copy_in_smem(const T* src, int rows, long long B, long long base,
                                             int nv, int nT, Dst dst) {
  const int tt = threadIdx.x % nT, n = rows * W;
  if (tt >= nv) return;
  const T* s = src + base + tt;
  for (int e = threadIdx.x / nT; e < n; e += kTeam)
    cp_async(dst(tt, e / W, e % W), s + (long long)e * B);
}

template <typename T, int NX, int NU, int NC, int NF, int PHASE>
__device__ __forceinline__ void stage_in(const Params<T>& P, T* Sblk, T* Fblk, const int* permu,
                                         const int* permx, long long base, int nv, int nT) {
  using SL = Slot<NX, NU>;
  const Dims& dm = P.dm;
  const Layout& ly = P.ly;
  const SmLayout& sm = P.sm;
  const int U = dm.totalu, X = dm.totalx, nleaf = dm.nb[dm.nlev - 1];
  const int lt = ly.total, st = sm.total;
  const long long B = P.B;
  // a per-stage array into the slot, row by row (entry col of every stage together)
  auto rows = [&](int off) {
    return [=](int tt, int row, int col) { return Sblk + tt * lt + off + col * U + permu[row]; };
  };
  // a per-stage array into each stage's shared slot at off
  auto slots = [&](int off) {
    return [=](int tt, int row, int col) {
      return Fblk + tt * st + permu[row] * SL::size + off + col;
    };
  };
  // a per-leaf array into the tree's shared memory at off
  auto leaves = [&](int off, int W) {
    return [=](int tt, int row, int col) { return Fblk + tt * st + off + row * W + col; };
  };
  // shared memory first: asynchronous, so it overlaps the slot's rows below
  copy_in_smem<NX * NX>(P.c[A_ST], U, B, base, nv, nT, slots(SL::A));
  copy_in_smem<NX * NX>(P.c[QX2], U, B, base, nv, nT, slots(SL::Q));
  copy_in_smem<NU * NU>(P.c[RU2], U, B, base, nv, nT, slots(SL::R));
  copy_in_smem<NU * NU>(P.c[DAB2], U, B, base, nv, nT, slots(SL::D));
  copy_in_smem<NX * NU>(P.c[B_ST], U, B, base, nv, nT, slots(SL::Bm));
  copy_in_smem<NX * NX>(P.c[PTERM2], nleaf, B, base, nv, nT, leaves(sm.Pt, NX * NX));
  copy_in_smem<1>(P.c[SLACK_QUAD], 1, B, base, nv, nT, leaves(sm.sq, 1));
  if constexpr (PHASE >= 1) {
    copy_in_smem<NX>(P.c[QX], U, B, base, nv, nT, slots(SL::Rdx));
    copy_in_smem<NU>(P.c[QU], U, B, base, nv, nT, slots(SL::Rdu));
    copy_in_smem<NX>(P.c[QTERM], nleaf, B, base, nv, nT, leaves(sm.rdt, NX));
  }
  copy_in<NX>(P.c[DH], U, B, base, nv, nT, rows(ly.dh));
  copy_in<NC>(P.in[ISL1], U, B, base, nv, nT, rows(ly.v[ISL1]));
  copy_in<NC>(P.in[ILAM1], U, B, base, nv, nT, rows(ly.v[ILAM1]));
  copy_in<NF>(P.in[ISL2], U, B, base, nv, nT, rows(ly.v[ISL2]));
  copy_in<NF>(P.in[ILAM2], U, B, base, nv, nT, rows(ly.v[ILAM2]));
  copy_in<NC>(P.in[ISL3], U, B, base, nv, nT, rows(ly.v[ISL3]));
  copy_in<NC>(P.in[ILAM3], U, B, base, nv, nT, rows(ly.v[ILAM3]));
  if constexpr (PHASE == 2) {
    copy_in<1>(P.c[SLACK_LIN], U, B, base, nv, nT, rows(ly.slin));
    copy_in<NC>(P.c[B1], U, B, base, nv, nT, rows(ly.r1));
    copy_in<NU>(P.in[IU], U, B, base, nv, nT, rows(ly.v[IU]));
    copy_in<NC>(P.in[IS], U, B, base, nv, nT, rows(ly.v[IS]));
    copy_in<NX>(P.in[IX], X, B, base, nv, nT, [=](int tt, int row, int col) {
      return Sblk + tt * lt + ly.v[IX] + col * X + permx[row];
    });
  }
  stage_wait();
}

// One carry field of each tree, from its slot, back to its batch-last array
// (the mapping of copy_in).
template <int W, typename T>
__device__ __forceinline__ void put_out(T* dst, const T* src, int lt, int nrows, const int* perm,
                                        long long B, long long base, int nv, int nT) {
  const int tt = threadIdx.x % nT, n = nrows * W;
  if (tt >= nv) return;
  const T* s = src + tt * lt;
  T* d = dst + base + tt;
  for (int e0 = threadIdx.x / nT; e0 < n; e0 += kTeam * kStageBatch) {
    T x[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kTeam;
      x[u] = e < n ? s[(e % W) * nrows + perm[e / W]] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kTeam;
      if (e < n) d[(long long)e * B] = x[u];
    }
  }
}

// The new carry of each tree, from its slot, back to the batch-last arrays.
template <typename T, int NX, int NU, int NC, int NF>
__device__ __forceinline__ void stage_out(const Params<T>& P, const T* Sblk, const int* permu,
                                          const int* permx, long long base, int nv, int nT) {
  const Layout& ly = P.ly;
  const int U = P.dm.totalu, X = P.dm.totalx, lt = ly.total;
  const long long B = P.B;
  put_out<NX>(P.out[IX], Sblk + ly.v[IX], lt, X, permx, B, base, nv, nT);
  put_out<NU>(P.out[IU], Sblk + ly.v[IU], lt, U, permu, B, base, nv, nT);
  put_out<NC>(P.out[IS], Sblk + ly.v[IS], lt, U, permu, B, base, nv, nT);
  put_out<NC>(P.out[ISL1], Sblk + ly.v[ISL1], lt, U, permu, B, base, nv, nT);
  put_out<NC>(P.out[ILAM1], Sblk + ly.v[ILAM1], lt, U, permu, B, base, nv, nT);
  put_out<NF>(P.out[ISL2], Sblk + ly.v[ISL2], lt, U, permu, B, base, nv, nT);
  put_out<NF>(P.out[ILAM2], Sblk + ly.v[ILAM2], lt, U, permu, B, base, nv, nT);
  put_out<NC>(P.out[ISL3], Sblk + ly.v[ISL3], lt, U, permu, B, base, nv, nT);
  put_out<NC>(P.out[ILAM3], Sblk + ly.v[ILAM3], lt, U, permu, B, base, nv, nT);
}

template <typename T, int NX, int NU, int NC, int NF, int PHASE>
__global__ void __launch_bounds__(kMaxThreads, 1)
tree_qp_kernel(const __grid_constant__ Params<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims& dm = P.dm;
  const int U = dm.totalu;
  const int tid = threadIdx.x, nT = blockDim.x / kTeam;
  T* Fblk = reinterpret_cast<T*>(smem_raw);             // the teams' regions
  T* shc = Fblk + (long long)nT * P.sm.total;            // Fx, Fu, bu
  StageInfo* stg = reinterpret_cast<StageInfo*>(shc + n_shared(dm));
  int* permu = reinterpret_cast<int*>(stg + U);          // natural stage → slot position
  int* permx = permu + U;                                // natural x node → slot position
  // once a block: the shared constants and the stage tables. Slot positions
  // run level by level, step-major and branch-minor.
  {
    const int nfx = dm.nFx * NX, nfu = dm.nFu * NU;
    for (int e = tid; e < nfx; e += blockDim.x) shc[e] = P.c[FX][e];
    for (int e = tid; e < nfu; e += blockDim.x) shc[nfx + e] = P.c[FU][e];
    for (int e = tid; e < dm.nFu; e += blockDim.x) shc[nfx + nfu + e] = P.c[BU][e];
  }
  for (int k = 0; k < dm.nlev; ++k) {
    const int nb = dm.nb[k], l = dm.l[k], lx = dm.lx[k];
    for (int idx = tid; idx < nb * l; idx += blockDim.x) {
      const int b = idx / l, j = idx - b * l;
      const int p = dm.u0[k] + j * nb + b;
      permu[dm.u0[k] + idx] = p;
      StageInfo si;
      si.q = dm.x0[k] + j * nb + b;
      si.pred = j > 0 ? p - nb
                      : (k > 0 ? dm.u0[k - 1] + (dm.l[k - 1] - 1) * dm.nb[k - 1] + b / dm.m : -1);
      if (j + 1 < l) {
        si.succ0 = p + nb;
        si.nsucc = 1;
      } else if (k + 1 < dm.nlev) {
        si.succ0 = dm.u0[k + 1] + b * dm.m;
        si.nsucc = dm.m;
      } else {
        si.succ0 = -1;
        si.nsucc = 0;
      }
      stg[p] = si;
    }
    for (int idx = tid; idx < nb * lx; idx += blockDim.x) {
      const int b = idx / lx, j = idx - b * lx;
      permx[dm.x0[k] + idx] = dm.x0[k] + j * nb + b;
    }
  }
  __syncthreads();
  const int w = tid / kTeam, lane = tid % kTeam;
  const unsigned mask = kTeam == 32 ? kFull
                                    : ((kFull >> (32 - kTeam)) << ((tid % 32) / kTeam * kTeam));
  T* Sblk = P.scratch + (long long)blockIdx.x * nT * P.ly.total;
  for (long long base = (long long)blockIdx.x * nT; base < P.B;
       base += (long long)gridDim.x * nT) {
    const int nv = P.B - base < nT ? (int)(P.B - base) : nT;
    stage_in<T, NX, NU, NC, NF, PHASE>(P, Sblk, Fblk, permu, permx, base, nv, nT);
    __syncthreads();
    if (w < nv) {
      Team<T, NX, NU, NC, NF> team(P, Sblk + w * P.ly.total, Fblk + (long long)w * P.sm.total,
                                   shc, stg, lane, mask);
      team.template run<PHASE>(base + w);
    }
    __syncthreads();
    if constexpr (PHASE == 2) {
      stage_out<T, NX, NU, NC, NF>(P, Sblk, permu, permx, base, nv, nT);
      __syncthreads();
    }
  }
}

bool parse_dims(const int* ints, Dims* dm) {
  int* f[kNHeader] = {&dm->n, &dm->d, &dm->m, &dm->nlev, &dm->nFx, &dm->nFu, &dm->totalu,
                      &dm->totalx, &dm->nbr, &dm->gondzio};
  for (int i = 0; i < kNHeader; ++i) *f[i] = ints[i];
  if (dm->nlev < 1 || dm->nlev > kMaxLevels || dm->nFx < 0 || dm->nFu < 1 || dm->m < 1 ||
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

// the kernel's algebra is instantiated for this build's dims alone
bool dims_supported(const Dims& dm) {
  return dm.n == Built::NX && dm.d == Built::NU && dm.nFx + 1 == Built::NC &&
         dm.nFu == Built::NF;
}

template <typename T, int PHASE>
auto kernel_of() {
  return tree_qp_kernel<T, Built::NX, Built::NU, Built::NC, Built::NF, PHASE>;
}

// The launch shape for B trees: teams (trees) a block, resident blocks an
// SM, a persistent grid of at most SMs x resident blocks, the dynamic shared
// memory a block and the scratch elements (one slot per team of the grid).
struct Plan {
  long long scratch, blocks;
  int teams, per_sm, sms, smem;
};

template <typename T>
int make_plan(const Dims& dm, long long B, int device, Plan* pl) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const long long fixed =
      (long long)n_shared(dm) * sizeof(T) + (long long)n_table_ints(dm) * sizeof(int);
  const long long per_team = (long long)make_sm_layout<Built::NX, Built::NU>(dm).total * sizeof(T);
  long long tmax = (optin - fixed) / per_team;
  if (tmax > kMaxTeams) tmax = kMaxTeams;
  if (tmax < 1) return (int)cudaErrorInvalidValue;
  // few trees: fewer a block, so that they spread over more SMs
  long long teams = (B + sms - 1) / sms;
  teams = teams < 1 ? 1 : (teams > tmax ? tmax : teams);
  const int smem = (int)(fixed + teams * per_team);
  // the card's whole opt-in size, so that every cached plan may launch
  err = cudaFuncSetAttribute(kernel_of<T, 0>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_of<T, 1>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_of<T, 2>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of<T, 2>(),
                                                      (int)teams * kTeam, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long need = (B + teams - 1) / teams;
  pl->blocks = need < (long long)sms * per_sm ? need : (long long)sms * per_sm;
  pl->teams = (int)teams;
  pl->per_sm = per_sm;
  pl->sms = sms;
  pl->smem = smem;
  pl->scratch = pl->blocks * teams * make_layout(dm).total;
  return 0;
}

// Plans already made (a cache for each dtype), by everything else that
// make_plan reads: device, B and the ints. A launch after its plan query
// makes no CUDA query.
constexpr int kNInts = kNHeader + 6 * kMaxLevels;
constexpr int kPlanCache = 64;

struct PlanKey {
  int device, nints;
  long long B;
  int ints[kNInts];
};

struct PlanCache {
  std::mutex mu;
  PlanKey key[kPlanCache];
  Plan plan[kPlanCache];
  int n = 0, next = 0;
};

template <typename T>
int cached_plan(const Dims& dm, const int* ints, long long B, int device, Plan* pl) {
  static PlanCache cache;
  PlanKey k{};
  k.device = device;
  k.nints = kNHeader + 6 * dm.nlev;
  k.B = B;
  for (int i = 0; i < k.nints; ++i) k.ints[i] = ints[i];
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int i = 0; i < cache.n; ++i) {
    const PlanKey& c = cache.key[i];
    bool same = c.device == k.device && c.nints == k.nints && c.B == k.B;
    for (int j = 0; same && j < k.nints; ++j) same = c.ints[j] == k.ints[j];
    if (same) {
      *pl = cache.plan[i];
      return 0;
    }
  }
  const int err = make_plan<T>(dm, B, device, pl);
  if (err != 0) return err;
  const int slot = cache.next;
  cache.next = (cache.next + 1) % kPlanCache;
  if (cache.n < kPlanCache) ++cache.n;
  cache.key[slot] = k;
  cache.plan[slot] = *pl;
  return 0;
}

// phase: 0 / 1 the profile's phase kernels, 2 the full iteration
template <typename T>
int launch(int phase, const void* const* ptrs, const int* ints, const double* dbl, long long B,
           int device, void* stream) {
  Params<T> P;
  if (B < 1 || phase < 0 || phase > 2 || !parse_dims(ints, &P.dm) || !dims_supported(P.dm))
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  Plan pl;
  const int err = cached_plan<T>(P.dm, ints, B, device, &pl);
  if (err != 0) return err;
  int o = 0;
  for (int i = 0; i < kNConst; ++i) P.c[i] = static_cast<const T*>(ptrs[o++]);
  for (int i = 0; i < kNCarry; ++i) P.in[i] = static_cast<const T*>(ptrs[o++]);
  for (int i = 0; i < kNCarry; ++i) P.out[i] = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.gap = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.scratch = static_cast<T*>(const_cast<void*>(ptrs[o++]));
  P.B = B;
  T* dst[] = {&P.reg, &P.tau, &P.wmax, &P.gap_tol, &P.mtot, &P.bmin, &P.bmax};
  for (int i = 0; i < 7; ++i) *dst[i] = T(dbl[i]);
  P.ly = make_layout(P.dm);
  P.sm = make_sm_layout<Built::NX, Built::NU>(P.dm);
  const unsigned blocks = (unsigned)pl.blocks, threads = (unsigned)(pl.teams * kTeam);
  const size_t smem = (size_t)pl.smem;
  if (phase == 0)
    tree_qp_kernel<T, Built::NX, Built::NU, Built::NC, Built::NF, 0>
        <<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  else if (phase == 1)
    tree_qp_kernel<T, Built::NX, Built::NU, Built::NC, Built::NF, 1>
        <<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  else
    tree_qp_kernel<T, Built::NX, Built::NU, Built::NC, Built::NF, 2>
        <<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: 16 constants (CONST_ORDER), 9 carry in, 9 carry out, gap (1, B),
// scratch (bp_tree_qp_iter_plan's elements); every array batch-last,
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

// The launch shape of B trees in f32 (f64 = 0) or f64 on `device`: out =
// scratch elements, blocks, trees a block, resident blocks an SM, SMs,
// dynamic shared memory bytes a block. Returns 0, or cudaErrorInvalidValue
// (1) for dims the kernel does not take, or the CUDA error of a query.
extern "C" int bp_tree_qp_iter_plan(const int* ints, long long B, int f64, int device,
                                    long long* out) {
  Dims dm;
  if (B < 1 || !parse_dims(ints, &dm) || !dims_supported(dm)) return (int)cudaErrorInvalidValue;
  Plan pl;
  const int err = f64 ? cached_plan<double>(dm, ints, B, device, &pl)
                      : cached_plan<float>(dm, ints, B, device, &pl);
  if (err != 0) return err;
  const long long v[6] = {pl.scratch, pl.blocks, pl.teams, pl.per_sm, pl.sms, pl.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
