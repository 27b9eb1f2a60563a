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
// correctors with a per-tree accept (longer step AND every candidate entry
// finite); the early step cap; the gap_tol freeze; two 0.3x backtracks on gap
// growth; and the finiteness mask on the step.
//
// Design: a team of one warp per tree, several trees a block, a persistent
// grid of (SMs x resident blocks) that walks over the batch.
// - Each block round stages its trees' per-lane constants and carry from
//   the batch-last arrays (element e of lane t at e*B + t) into a tree-major
//   scratch slot of each team; the block's trees are adjacent lanes and every
//   element row is read for all of them together, so a sector serves 8 f32
//   (4 f64) trees. The new carry goes back the same way. Scratch is sized by
//   the resident teams (bp_cvar_iter_plan), not by B.
// - Shared memory holds, a stage: the factor (K, H^-1 and the closed loop, 52
//   scalars, which first hold the factor's own inputs), B, and the single
//   right-hand side of the sweeps; a tree: its small constants (QxC, Fxl,
//   FxFx, ...) and K-sized vectors and matrices (capacitance, Woodbury
//   coefficients); a block: the shared constants (Fu, bu, Rm, the cone mask,
//   the risk maps and sign selectors, and their transposes) and each cone's
//   stage span.
// - The team spreads every pass over its 32 lanes: elementwise passes over
//   stages and complementarity entries; the sweeps over (branch, column)
//   pairs of a level, one serial chain per lane (a chain split over 8 lanes,
//   a row of its 6-vector each, joined by shuffles, was no faster on the
//   H100, not even for the merge's two 40-stage chains); the risk saddles over
//   (branch, column) pairs, each solved whole by one lane, which keeps the
//   reference's pivot rule; the capacitance's Gauss-Jordan over rows.
// - Memory-level parallelism: a pass loads a batch of entries a lane before
//   it stores any, and a chain loads its next stage's inputs while it
//   computes the current one. Passes are fused where their entries meet: the
//   complementarity right-hand side with the direction's rhs, the step length
//   and finiteness of a direction with the passes that make it, the cones'
//   stage dots with the slack columns, the new carry with the write-back.
// - Every per-tree decision (step length, Gondzio accept, freeze, backtracks,
//   finiteness) is one value that the whole team holds: reductions run as a
//   butterfly of shuffles and are then broadcast from lane 0.
// - Lanes exchange data through scratch and shared memory between warp
//   barriers (__syncwarp orders both); block barriers only frame a round.
//
// What bounds it on an H100: at the merge deployment (N=40, NB=1, m=2) the
// least traffic (the 11 per-lane constants read once, the 14 carry arrays read
// and written once, the gap written) is 36,612 B a tree in f32, 1.20 GB at
// B=32768, 0.36 ms at the 3.35 TB/s of an H100 SXM (data sheet, 700 W); at the
// overtake (N=8, NB=2, m=3) its 4.05e10 operations, 0.60 ms at 67 TFLOP/s.
// The kernel is far from both: each tree's team walks its scratch slot
// (87 KB at the merge, 173 KB at the overtake in f32, in L2 or device
// memory) pass after pass, one memory round trip a batch of loads, and an
// SM holds 8 teams (8 trees a block, and one block of 183 KB at the merge,
// 7 and 228 KB at the overtake, in shared memory); the serial stage chains
// (81 stages of two 40-stage branches at the merge) add their latency on
// top.

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kNConst = 11;
constexpr int kNShared = 9;
constexpr int kNCarry = 14;
constexpr int kNHeader = 15;     // ints before the level table
constexpr int kWarp = 32;        // threads of a team (one tree)
constexpr int kMaxTeams = 8;     // trees per block
constexpr int kMaxThreads = kWarp * kMaxTeams;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxM = 3;         // policies per branch
constexpr int kWbK = 16;         // cones held in registers by the Woodbury update
constexpr int NX = 4, NU = 2, NC = 5, NF = 4, ND = NX + NU;
constexpr int kFactor = NU * ND + NU * NU + ND * ND;   // K, H^-1, closed loop: 52 a stage
// A stage's slot in shared memory: the factor (its first kFactor scalars, which
// hold the factor's inputs A, Qx2, Ru2 until the factor overwrites them), then
// B, and the single right-hand side of the sweeps (qe, qu) with its kff.
constexpr int kSlotA = 0, kSlotQ = NX * NX, kSlotR = kSlotQ + NX * NX;
constexpr int kSlotB = kFactor, kSlotQe = kSlotB + NX * NU, kSlotQu = kSlotQe + NX;
constexpr int kSlotKf = kSlotQu + NU, kSlot = kSlotKf + NU;
static_assert(kSlotR + NU * NU <= kFactor, "a stage's factor inputs fit its factor");
static_assert(kSlot % 4 == 0, "slots keep 16-byte alignment");

// Sums over every complementarity pair (the gap, and the trial gaps of the
// step rules: up to about 1,400 terms) accumulate in double, also in the
// float instantiation: per-lane partial sums, then a butterfly in double. A
// float sum of that length is several times less accurate than the plain
// version's cascade sums, and the centering σ = (gap_aff / gap)³ amplifies
// that error into every direction.
using Acc = double;

// order of the per-lane constants (CONST_ORDER on the Python side); those
// from PA on are a few scalars a tree and live in the team's shared memory
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
  int f[kNCarry];
};

// Element offsets in one team's tree-major scratch slot.
struct Layout {
  int cst[PA], csz[kNConst];        // per-stage constants (staged in); sizes of all
  int v[kNCarry], vsz[kNCarry];     // carry (staged in, updated in place)
  int gx, gu, sc, r1, r2, r3, r4, rq, w1, w1kap, w2, kap, w4, wq, lqs, hd;
  int rdx, rdu, rds, rdr, rc[5];
  int Phead;
  int qs1, qr1, kff, phead, xiend;
  int Zx, Zu, Zs, Zr, dtmp;
  DirOff D[2];
  int total;
};

// Element offsets in one team's shared memory: the factor, then the tree's
// small constants and the K-sized vectors and matrices of the iteration.
struct SmLayout {
  int qc[kNConst];                  // constants from PA on
  int cinv, lqe, exqc, ex4, phi, sw, gd, gjaug, winv, dq, res, total;
};

void const_sizes(const Dims& dm, long long* sz) {
  const long long U = dm.totalu;
  const long long s[kNConst] = {U * NX * NX, U * NX * NU, U * NX, U * (dm.nFx + 1),
                                (long long)dm.bdim * dm.m, dm.K, NX, 1, NX * NX,
                                (long long)dm.nFx * NX, (long long)dm.nFx * NX * NX};
  for (int i = 0; i < kNConst; ++i) sz[i] = s[i];
}

void carry_sizes(const Dims& dm, long long* sz) {
  const long long U = dm.totalu, Nc = dm.nFx + 1, F = dm.nFu;
  const long long s[kNCarry] = {(long long)dm.totalx * dm.n, U * dm.d, U * Nc, dm.nrisk,
                                U * Nc, U * Nc, U * F, U * F, U * Nc, U * Nc,
                                dm.nsgn, dm.nsgn, dm.K, dm.K};
  for (int f = 0; f < kNCarry; ++f) sz[f] = s[f];
}

void shared_sizes(const Dims& dm, long long* sz) {
  const long long U = dm.totalu, K = dm.K;
  const long long s[kNShared] = {(long long)dm.nFu * dm.d, dm.nFu, (long long)dm.d * dm.d,
                                 K * U, U * K, K * dm.nrisk, dm.nrisk * K,
                                 (long long)dm.nsgn * dm.nrisk, (long long)dm.nrisk * dm.nsgn};
  for (int i = 0; i < kNShared; ++i) sz[i] = s[i];
}

Layout make_layout(const Dims& dm) {
  const long long U = dm.totalu, X = dm.totalx, n = dm.n, d = dm.d, nd = n + d;
  const long long Nc = dm.nFx + 1, F = dm.nFu, K = dm.K, R = dm.K + 1;
  Layout L;
  long long o = 0;
  auto take = [&o](long long sz) { const int r = (int)o; o += sz; return r; };
  long long csz[kNConst], vsz[kNCarry];
  const_sizes(dm, csz);
  for (int i = 0; i < kNConst; ++i) L.csz[i] = (int)csz[i];
  for (int i = 0; i < PA; ++i) L.cst[i] = take(csz[i]);
  carry_sizes(dm, vsz);
  for (int f = 0; f < kNCarry; ++f) {
    L.vsz[f] = (int)vsz[f];
    L.v[f] = take(vsz[f]);
  }
  L.gx = take(U * n);
  L.gu = take(U * d);
  L.sc = take(U);
  L.r1 = take(U * Nc);
  L.r2 = take(U * F);
  L.r3 = take(U * Nc);
  L.r4 = take(dm.nsgn);
  L.rq = take(K);
  L.w1 = take(U * Nc);
  L.w1kap = take(U * Nc);
  L.w2 = take(U * F);
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
  L.Phead = take(dm.nbr * nd * nd);
  L.qs1 = take(U * Nc);
  L.qr1 = take(dm.nrisk);
  L.kff = take(U * d * R);
  L.phead = take(dm.nbr * nd * R);
  L.xiend = take(dm.nbr * nd * R);
  L.Zx = take(X * n * R);
  L.Zu = take(U * d * R);
  L.Zs = take(U * Nc * R);
  L.Zr = take(dm.nrisk * R);
  L.dtmp = take(U * R);
  for (int i = 0; i < 2; ++i)
    for (int f = 0; f < kNCarry; ++f) L.D[i].f[f] = take(vsz[f]);
  L.total = (int)o;
  return L;
}

SmLayout make_sm_layout(const Dims& dm) {
  const long long K = dm.K;
  SmLayout L;
  long long o = (long long)kSlot * dm.totalu;
  auto take = [&o](long long sz) { const int r = (int)o; o += sz; return r; };
  long long csz[kNConst];
  const_sizes(dm, csz);
  for (int i = 0; i < kNConst; ++i) L.qc[i] = i < PA ? -1 : take(csz[i]);
  L.cinv = take(K);
  L.lqe = take(K);
  L.exqc = take(K);
  L.ex4 = take(dm.nsgn);
  L.phi = take(K);
  L.sw = take(K);
  L.gd = take(K * (K + 1));
  L.gjaug = take(K * 2 * K);
  L.winv = take(K * K);
  L.dq = take(K);
  L.res = take(3);   // the step, its finiteness and ic, for stage_out
  L.total = (int)((o + 3) / 4 * 4);   // keeps every team's region 16-byte aligned
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
  SmLayout sm;
  int shoff[kNShared], shsz[kNShared], shtotal;   // shared constants in shared memory
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

// Team reductions: a butterfly over the warp, then lane 0's value for all
template <typename V>
__device__ __forceinline__ V team_sum(V v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}
template <typename V>
__device__ __forceinline__ V team_min(V v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = pmin(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}
__device__ __forceinline__ bool team_all(bool b) {
  int v = b ? 1 : 0;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v &= __shfl_xor_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0) != 0;
}

// An elementwise pass over [0, n), N entries a lane at a time: every load of
// a batch is issued before the first store of it, so a lane waits one memory
// latency a batch and not one an entry (scratch loads and stores go through
// one pointer, so the compiler may not move a load above a store itself).
template <int N, typename L, typename F>
__device__ __forceinline__ void batched(int lane, int n, L load, F use) {
  for (int e0 = lane; e0 < n; e0 += kWarp * N) {
    decltype(load(0)) x[N] = {};
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (e0 + u * kWarp < n) x[u] = load(e0 + u * kWarp);
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (e0 + u * kWarp < n) use(e0 + u * kWarp, x[u]);
  }
}

// N contiguous scalars of shared memory into registers, 16 bytes a load;
// p is 16-byte aligned (N * sizeof(T) a multiple of 16)
template <int N, typename T>
__device__ __forceinline__ void ld_vec(const T* p, T* out) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 v = reinterpret_cast<const double2*>(p)[i];
      out[2 * i] = v.x; out[2 * i + 1] = v.y;
    }
  }
#else
  for (int i = 0; i < N; ++i) out[i] = p[i];
#endif
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

// A direction's fraction-to-boundary step over every complementarity entry
// (the plain version's all_step), and whether all its entries are finite:
// both taken where the direction's entries are made, and held by every lane.
template <typename T>
struct Step {
  T a;
  bool fin;
};

// Where one solve's outputs go: x (totalx, n), u (totalu, d), s (totalu, Nc)
// and r (nrisk) blocks in scratch, each with `R` columns (element e, column c
// at e*R + c).
struct Out {
  int x, u, s, r;
  int R;
};

// What a stage of the backward linear sweep reads; loaded a stage ahead
template <typename T>
struct SweepIn {
  T qe[NX], qu[NU], Bm[NX][NU];
};

template <typename T>
struct Team {
  const Params<T>& P;
  const Dims& dm;
  const Layout& ly;
  const SmLayout& sm;
  T* S;               // this tree's scratch slot (tree-major)
  T* F;               // this tree's shared memory: a slot a stage (kSlot), then SmLayout
  const T* shc;       // the block's shared constants in shared memory
  const int* xnode;   // x node of each stage
  const int* crange;  // stages [j0, j1) of each cone (its nonzero mask entries)
  int lane;
  T gap;
  int U, K, nrisk, nsgn, bdim, m;

  __device__ __forceinline__ Team(const Params<T>& P_, T* S_, T* F_, const T* shc_,
                                  const int* xnode_, int lane_)
      : P(P_), dm(P_.dm), ly(P_.ly), sm(P_.sm), S(S_), F(F_), shc(shc_), xnode(xnode_),
        crange(xnode_ + P_.dm.totalu),
        lane(lane_) {
    U = dm.totalu; K = dm.K; nrisk = dm.nrisk; nsgn = dm.nsgn; bdim = dm.bdim; m = dm.m;
  }

  __device__ __forceinline__ const T* cst(int i) const {
    return i < PA ? S + ly.cst[i] : F + sm.qc[i];
  }
  __device__ __forceinline__ T* vv(int f) const { return S + ly.v[f]; }
  __device__ __forceinline__ const T* shr(int i) const { return shc + P.shoff[i]; }
  __device__ __forceinline__ T* slot(int st) const { return F + st * kSlot; }
  __device__ __forceinline__ T* Kf(int st) const { return slot(st); }
  __device__ __forceinline__ T* Hinv(int st) const { return slot(st) + NU * ND; }
  __device__ __forceinline__ T* Acl(int st) const { return slot(st) + NU * ND + NU * NU; }
  // the sweeps' feed-forward term of column c: in the stage's slot for the
  // single right-hand side, else in scratch
  __device__ __forceinline__ T* kff(bool single, int st, int a, int c) const {
    return single ? slot(st) + kSlotKf + a : S + ly.kff + (st * NU + a) * (K + 1) + c;
  }
  // 1 / csc_k, set once a round by residuals()
  __device__ __forceinline__ T cinv(int k) const { return F[sm.cinv + k]; }
  // sum_j mask[k][j] v[j * stride] over cone k's stages: outside them the
  // mask is 0, and those terms add nothing to a finite sum
  __device__ __forceinline__ T cone_sum(int k, const T* v, int stride) const {
    const int j0 = crange[2 * k], j1 = crange[2 * k + 1];
    const T* mk = shr(MASK) + k * U;
    if (j0 >= j1) return T(0);
    T a = mk[j0] * v[j0 * stride];
#pragma unroll 8
    for (int j = j0 + 1; j < j1; ++j) a += mk[j] * v[j * stride];
    return a;
  }

  // ---- constraint rows: row 0 is -dh.x, rows 1.. are Fxl x ----------------
  __device__ __forceinline__ T row_val(const T* dh, int r, const T* xv) const {
    if (r == 0) {
      T acc = dh[0] * xv[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) acc += dh[i] * xv[i];
      return -acc;
    }
    const T* Fxl = cst(FXL) + (r - 1) * NX;
    T acc = Fxl[0] * xv[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) acc += Fxl[i] * xv[i];
    return acc;
  }
  // out_i = (-dh_i v_0) + sum_q Fxl[q][i] v_{1+q}
  __device__ __forceinline__ void row_valT(const T* dh, const T* vv_, T* out) const {
    const T* Fxl = cst(FXL);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T acc = Fxl[i] * vv_[1];
#pragma unroll
      for (int q = 1; q < NC - 1; ++q) acc += Fxl[q * NX + i] * vv_[1 + q];
      out[i] = -dh[i] * vv_[0] + acc;
    }
  }
  __device__ __forceinline__ T fu_val(int q, const T* uv) const {
    const T* Fu = shr(FU);
    T acc = Fu[q * NU] * uv[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) acc += Fu[q * NU + a] * uv[a];
    return acc;
  }
  // out_a = sum_q Fu[q][a] v_q
  __device__ __forceinline__ void fu_valT(const T* vv_, T* out) const {
    const T* Fu = shr(FU);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T acc = Fu[a] * vv_[0];
#pragma unroll
      for (int q = 1; q < NF; ++q) acc += Fu[q * NU + a] * vv_[q];
      out[a] = acc;
    }
  }
  __device__ __forceinline__ void load_dh(int st, T* dh) const {
    const T* p = cst(DH) + st * NX;
#pragma unroll
    for (int i = 0; i < NX; ++i) dh[i] = p[i];
  }

  // ---- stage pieces, residuals, gap, weights, dual residuals ---------------
  __device__ __forceinline__ void residuals() {
    const T wmax = P.wmax, reg = P.reg, q1 = P.qslack1;
    const T *x = vv(IX), *u = vv(IU), *s = vv(IS), *r = vv(IR);
    const T *QxC = cst(QXC), *cx = cst(CX), *b1 = cst(B1), *Rm = shr(RM), *bu = shr(BU);
    const T *sl1 = vv(ISL1), *lam1 = vv(ILAM1), *sl2 = vv(ISL2), *lam2 = vv(ILAM2),
            *sl3 = vv(ISL3), *lam3 = vv(ILAM3);
    const T cc = cst(CC)[0];
    for (int k = lane; k < K; k += kWarp) {
      const T ci = T(1) / cst(CSC)[k];
      F[sm.cinv + k] = ci;
      F[sm.lqe + k] = vv(ILQ)[k] * ci;
    }
    __syncwarp();
    Acc gacc = 0;
    for (int st = lane; st < U; st += kWarp) {
      const int xn = xnode[st];
      T xc[NX], uu[NU], dh[NX], sv[NC], s1[NC], l1[NC], s3[NC], l3[NC], bb[NC], s2[NF],
          l2[NF];
#pragma unroll
      for (int i = 0; i < NX; ++i) xc[i] = x[xn * NX + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) uu[a] = u[st * NU + a];
      load_dh(st, dh);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int e = st * NC + q;
        sv[q] = s[e]; s1[q] = sl1[e]; l1[q] = lam1[e]; s3[q] = sl3[e]; l3[q] = lam3[e];
        bb[q] = b1[e];
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        s2[q] = sl2[st * NF + q];
        l2[q] = lam2[st * NF + q];
      }
      T gx[NX], gu[NU];
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
      T ssum = sv[0];
#pragma unroll
      for (int q = 1; q < NC; ++q) ssum += sv[q];
      S[ly.sc + st] = (((t1 * T(0.5) + t2) + cc) + t3 * T(0.5)) + q1 * ssum;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int e = st * NC + q;
        S[ly.r1 + e] = ((row_val(dh, q, xc) - sv[q]) + s1[q]) - bb[q];
        S[ly.r3 + e] = -sv[q] + s3[q];
        gacc += s1[q] * l1[q];
        gacc += s3[q] * l3[q];
        const T w1e = pmin(l1[q] / s1[q], wmax), w3e = pmin(l3[q] / s3[q], wmax);
        const T kape = (w1e + w3e) + reg;
        S[ly.w1 + e] = w1e;
        S[ly.kap + e] = kape;
        S[ly.w1kap + e] = w1e / kape;
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const int e = st * NF + q;
        S[ly.r2 + e] = (fu_val(q, uu) + s2[q]) - bu[q];
        gacc += s2[q] * l2[q];
        S[ly.w2 + e] = pmin(l2[q] / s2[q], wmax);
      }
    }
    // risk rows, cones and the gap
    const T *Ssgn = shr(SSGN), *frisk = shr(FRISK);
    const T *sl4 = vv(ISL4), *lam4 = vv(ILAM4), *sq = vv(ISQ), *lq = vv(ILQ);
    for (int i = lane; i < nsgn; i += kWarp) {
      T acc = Ssgn[i * nrisk] * r[0];
      for (int q = 1; q < nrisk; ++q) acc += Ssgn[i * nrisk + q] * r[q];
      const T s4 = sl4[i], l4 = lam4[i];
      S[ly.r4 + i] = -acc + s4;
      gacc += s4 * l4;
      S[ly.w4 + i] = pmin(l4 / s4, wmax);
    }
    __syncwarp();
    for (int k = lane; k < K; k += kWarp) {
      const T a1 = cone_sum(k, S + ly.sc, 1);
      T a2 = frisk[k * nrisk] * r[0];
      for (int q = 1; q < nrisk; ++q) a2 += frisk[k * nrisk + q] * r[q];
      const T ci = cinv(k);
      S[ly.rq + k] = (a1 * ci + a2 * ci) + sq[k];
      gacc += sq[k] * lq[k];
      const T wqk = pmin(lq[k] / sq[k], wmax);
      S[ly.wq + k] = wqk;
      F[sm.sw + k] = sqrt(wqk);
    }
    gap = T(team_sum(gacc) / Acc(P.mtot));
    // cone multipliers per stage, risk Hessian, risk dual residual
    const T *maskT = shr(MASKT), *SsgnT = shr(SSGNT), *friskT = shr(FRISKT);
    for (int j = lane; j < U; j += kWarp) {
      const T* lqe = F + sm.lqe;
      T acc = maskT[j * K] * lqe[0];
      for (int k = 1; k < K; ++k) acc += maskT[j * K + k] * lqe[k];
      S[ly.lqs + j] = acc;
    }
    __syncwarp();
    for (int q = lane; q < nrisk; q += kWarp) {
      T a1 = SsgnT[q * nsgn] * S[ly.w4];
      T a2 = SsgnT[q * nsgn] * lam4[0];
      for (int i = 1; i < nsgn; ++i) {
        a1 += SsgnT[q * nsgn + i] * S[ly.w4 + i];
        a2 += SsgnT[q * nsgn + i] * lam4[i];
      }
      S[ly.hd + q] = reg + a1;
      const T* lqe = F + sm.lqe;
      T a3 = friskT[q * K] * lqe[0];
      for (int k = 1; k < K; ++k) a3 += friskT[q * K + k] * lqe[k];
      S[ly.rdr + q] = ((q == 0 ? T(1) : T(0)) + a3) - a2;
    }
    // per-stage dual residuals, and the inputs of the factor's stage into its
    // factor slot: A, B and the stage terms
    // Qx2 = 2 lqs QxC + reg I + c_0 dh dh^T + sum_q c_{1+q} FxFx_q, c = w1 - w1^2/kap;
    // Ru2 = 2 lam_stage Rm + reg I + sum_q w2_q Fu_q Fu_q^T
    const T *FxFx = cst(FXFX), *Fu = shr(FU), *Ast = cst(A_ST), *Bst = cst(B_ST);
    for (int st = lane; st < U; st += kWarp) {
      const T lq_s = S[ly.lqs + st];
      T l1[NC], l2[NF], l3[NC], gx[NX], gu[NU], dh[NX], w1[NC], kp[NC], w2[NF];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int e = st * NC + q;
        l1[q] = lam1[e]; l3[q] = lam3[e]; w1[q] = S[ly.w1 + e]; kp[q] = S[ly.kap + e];
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        l2[q] = lam2[st * NF + q];
        w2[q] = S[ly.w2 + st * NF + q];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) gx[i] = S[ly.gx + st * NX + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) gu[a] = S[ly.gu + st * NU + a];
      load_dh(st, dh);
      const T gu0[NU] = {S[ly.gu], S[ly.gu + 1]};
      T Av[NX * NX], Bv[NX * NU];
#pragma unroll
      for (int i = 0; i < NX * NX; ++i) Av[i] = Ast[st * NX * NX + i];
#pragma unroll
      for (int i = 0; i < NX * NU; ++i) Bv[i] = Bst[st * NX * NU + i];
      T rT[NX], fT[NU];
      row_valT(dh, l1, rT);
      fu_valT(l2, fT);
#pragma unroll
      for (int i = 0; i < NX; ++i) S[ly.rdx + st * NX + i] = lq_s * gx[i] + rT[i];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const T obj = st == 0 ? gu0[a] : T(0);
        S[ly.rdu + st * NU + a] = (lq_s * gu[a] + obj) + fT[a];
      }
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const T obj = st == 0 ? q1 : T(0);
        S[ly.rds + st * NC + q] = ((obj + q1 * lq_s) - l1[q]) - l3[q];
      }
      T* sl = slot(st);
#pragma unroll
      for (int i = 0; i < NX * NX; ++i) sl[kSlotA + i] = Av[i];
#pragma unroll
      for (int i = 0; i < NX * NU; ++i) sl[kSlotB + i] = Bv[i];
      T* terms = sl + kSlotQ;
      const T lq2 = T(2) * lq_s;
      T c[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) c[q] = w1[q] - (w1[q] * w1[q]) / kp[q];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T sum = c[1] * FxFx[i * NX + j];
#pragma unroll
          for (int q = 1; q < NC - 1; ++q) sum += c[1 + q] * FxFx[(q * NX + i) * NX + j];
          terms[i * NX + j] = ((lq2 * QxC[i * NX + j] + (i == j ? reg : T(0)))
                               + (c[0] * dh[i]) * dh[j]) + sum;
        }
      const T ls2 = T(2) * (lq_s + (st == 0 ? T(1) : T(0)));
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int b = 0; b < NU; ++b) {
          T sum = w2[0] * (Fu[a] * Fu[b]);
#pragma unroll
          for (int q = 1; q < NF; ++q) sum += w2[q] * (Fu[q * NU + a] * Fu[q * NU + b]);
          sl[kSlotR + a * NU + b] = (ls2 * shr(RM)[a * NU + b] + (a == b ? reg : T(0))) + sum;
        }
    }
    __syncwarp();
  }

  // ---- backward quadratic sweep (tree Riccati) ----------------------------
  // Reads the stage's inputs from its slot where it needs them; the outputs
  // overwrite A, Qx2, Ru2 in the slot only after their last use.
  __device__ __forceinline__ void riccati_step(int st, T (&W)[ND][ND]) const {
    const T* sl = slot(st);
    T Bm[NX][NU];
    ld_vec<NX * NU>(sl + kSlotB, &Bm[0][0]);
    auto A = [sl](int i, int j) { return sl[kSlotA + i * NX + j]; };
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
        H[a][c] = sl[kSlotR + a * NU + c]
                  + (((acc + BtPxu[a][c]) + BtPxu[c][a]) + W[NX + a][NX + c]);
      }
    // L = [B^T Pxx A + Pxu^T A, 0]  (d x nd; the rate coupling is zero here)
    T L[NU][ND];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T t1 = BtPxx[a][0] * A(0, j), t2 = W[0][NX + a] * A(0, j);
#pragma unroll
        for (int k = 1; k < NX; ++k) {
          t1 += BtPxx[a][k] * A(k, j);
          t2 += W[k][NX + a] * A(k, j);
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
        T acc = W[i][0] * A(0, j);
#pragma unroll
        for (int k = 1; k < NX; ++k) acc += W[i][k] * A(k, j);
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
        T acc = A(0, i) * PA[0][j];
#pragma unroll
        for (int k = 1; k < NX; ++k) acc += A(k, i) * PA[k][j];
        Pn[i][j] += sl[kSlotQ + i * NX + j] + acc;
      }
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < ND; ++e) W[c][e] = T(0.5) * (Pn[c][e] + Pn[e][c]);
    // store Acl = [[B K + [A 0]], [K]] (over Qx2, Ru2; it reads A), then K =
    // -H^-1 L and H^-1 (over A) in the slot
    T *Kp = Kf(st), *Hp = Hinv(st), *Ap = Acl(st);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        T acc = Bm[i][0] * (-HL[0][c]);
#pragma unroll
        for (int a = 1; a < NU; ++a) acc += Bm[i][a] * (-HL[a][c]);
        Ap[i * ND + c] = c < NX ? acc + A(i, c) : acc;
      }
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < ND; ++c) Ap[(NX + a) * ND + c] = -HL[a][c];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < ND; ++c) Kp[a * ND + c] = -HL[a][c];
#pragma unroll
      for (int c = 0; c < NU; ++c) Hp[a * NU + c] = Hi[a][c];
    }
  }

  // one lane per branch of a level, deepest level first
  __device__ __forceinline__ void factor() {
    for (int k = dm.nlev - 1; k >= 0; --k) {
      for (int b = lane; b < dm.nb[k]; b += kWarp) {
        T W[ND][ND];
        if (k == dm.nlev - 1) {
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j) W[i][j] = (i < NX && i == j) ? P.reg : T(0);
        } else {
          const int first = dm.bo[k + 1] + b * m;
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j) {
              const int e = i * ND + j;
              T acc = S[ly.Phead + first * ND * ND + e];
              for (int c = 1; c < m; ++c) acc += S[ly.Phead + (first + c) * ND * ND + e];
              W[i][j] = acc;
            }
        }
        const int st0 = dm.u0[k] + b * dm.l[k];
        for (int j = dm.l[k] - 1; j >= 0; --j) {
          riccati_step(st0 + j, W);
        }
        if (k > 0) {
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j)
              S[ly.Phead + (dm.bo[k] + b) * ND * ND + i * ND + j] = W[i][j];
        }
      }
      __syncwarp();
    }
  }

  // ---- right-hand sides of the H0 solve --------------------------------------
  // Column c of the stage rhs's slack part: a Woodbury column (c < K, formed
  // from the cone mask) when `wood`, else the stored single rhs.
  __device__ __forceinline__ void rhs_slack(bool wood, int c, int st, T* qs) const {
    if (wood && c < K) {
      const T q = P.qslack1 * (shr(MASKT)[st * K + c] * cinv(c));
#pragma unroll
      for (int r = 0; r < NC; ++r) qs[r] = q;
    } else {
#pragma unroll
      for (int r = 0; r < NC; ++r) qs[r] = S[ly.qs1 + st * NC + r];
    }
  }
  __device__ __forceinline__ T rhs_risk(bool wood, int c, int q) const {
    return (wood && c < K) ? shr(FRISKT)[q * K + c] * cinv(c) : S[ly.qr1 + q];
  }
  // Column c of the stage rhs as the backward sweep takes it: qe = qx +
  // Fxc^T((w1/kap) qs) and qu. A Woodbury column (c < K, `wood`) is formed
  // from the cone mask and the stage gradients; the single rhs's qe was made
  // by set_rhs.
  __device__ __forceinline__ void load_sweep(bool wood, int c, int st, SweepIn<T>& in) const {
    if (wood && c < K) {
      const T mT = shr(MASKT)[st * K + c] * cinv(c);
      const T q = P.qslack1 * mT;
      T dh[NX], vq[NC], rt[NX];
      load_dh(st, dh);
#pragma unroll
      for (int r = 0; r < NC; ++r) vq[r] = S[ly.w1kap + st * NC + r] * q;
      row_valT(dh, vq, rt);
#pragma unroll
      for (int i = 0; i < NX; ++i) in.qe[i] = mT * S[ly.gx + st * NX + i] + rt[i];
#pragma unroll
      for (int a = 0; a < NU; ++a) in.qu[a] = mT * S[ly.gu + st * NU + a];
    } else {
      const T* sl = slot(st);
#pragma unroll
      for (int i = 0; i < NX; ++i) in.qe[i] = sl[kSlotQe + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) in.qu[a] = sl[kSlotQu + a];
    }
    ld_vec<NX * NU>(slot(st) + kSlotB, &in.Bm[0][0]);
  }

  // ---- the H0 solve (tree + rows + risk) for columns [0, ncol) --------------
  // One serial chain per (branch, column) of a level, one chain per lane; each
  // stage's inputs are loaded while the stage before it is computed.
  __device__ __forceinline__ void h0_solve(bool wood, int ncol, const Out& o) {
    const int R = K + 1;
    const bool single = !wood;
    // backward linear sweep -> kff
    for (int k = dm.nlev - 1; k >= 0; --k) {
      for (int it = lane; it < dm.nb[k] * ncol; it += kWarp) {
        const int b = it / ncol, c = it - b * ncol;
        T p[ND];
        if (k == dm.nlev - 1) {
#pragma unroll
          for (int e = 0; e < ND; ++e) p[e] = T(0);
        } else {
          const int first = dm.bo[k + 1] + b * m;
#pragma unroll
          for (int e = 0; e < ND; ++e) {
            T acc = S[ly.phead + (first * ND + e) * R + c];
            for (int i = 1; i < m; ++i) acc += S[ly.phead + ((first + i) * ND + e) * R + c];
            p[e] = acc;
          }
        }
        const int st0 = dm.u0[k] + b * dm.l[k];
        SweepIn<T> cur;
        load_sweep(wood, c, st0 + dm.l[k] - 1, cur);
        for (int j = dm.l[k] - 1; j >= 0; --j) {
          const int st = st0 + j;
          SweepIn<T> nxt;
          if (j > 0) load_sweep(wood, c, st - 1, nxt);
          T Hi[NU * NU], Kp[NU * ND], Ap[ND * ND];
          ld_vec<NU * NU>(Hinv(st), Hi);
          ld_vec<NU * ND>(Kf(st), Kp);
          ld_vec<ND * ND>(Acl(st), Ap);
          T lu[NU];
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            T acc = cur.Bm[0][a] * p[0];
#pragma unroll
            for (int i = 1; i < NX; ++i) acc += cur.Bm[i][a] * p[i];
            lu[a] = (cur.qu[a] + acc) + p[NX + a];
          }
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            T acc = Hi[a * NU] * lu[0];
#pragma unroll
            for (int e = 1; e < NU; ++e) acc += Hi[a * NU + e] * lu[e];
            *kff(!wood, st, a, c) = -acc;
          }
          T pn[ND];
#pragma unroll
          for (int cc_ = 0; cc_ < ND; ++cc_) {
            T t1 = Ap[cc_] * p[0];
#pragma unroll
            for (int e = 1; e < ND; ++e) t1 += Ap[e * ND + cc_] * p[e];
            T t2 = Kp[cc_] * cur.qu[0];
#pragma unroll
            for (int a = 1; a < NU; ++a) t2 += Kp[a * ND + cc_] * cur.qu[a];
            pn[cc_] = t1 + t2;
          }
#pragma unroll
          for (int e = 0; e < ND; ++e) p[e] = e < NX ? pn[e] + cur.qe[e] : pn[e];
          if (j > 0) cur = nxt;
        }
        if (k > 0) {
#pragma unroll
          for (int e = 0; e < ND; ++e)
            S[ly.phead + ((dm.bo[k] + b) * ND + e) * R + c] = p[e];
        }
      }
      __syncwarp();
    }
    // forward rollout from a zero root state -> x, u columns
    for (int k = 0; k < dm.nlev; ++k) {
      for (int it = lane; it < dm.nb[k] * ncol; it += kWarp) {
        const int b = it / ncol, c = it - b * ncol;
        T xi[ND];
        if (k == 0) {
#pragma unroll
          for (int e = 0; e < ND; ++e) xi[e] = T(0);
        } else {
          const int base = (dm.bo[k - 1] + b / m) * ND;
#pragma unroll
          for (int e = 0; e < ND; ++e) xi[e] = S[ly.xiend + (base + e) * R + c];
        }
        const int st0 = dm.u0[k] + b * dm.l[k], xn0 = dm.x0[k] + b * dm.lx[k];
        T kf[NU], Bm[NX][NU];
        auto load = [&](int st, T* kf_, T (&Bm_)[NX][NU]) {
#pragma unroll
          for (int a = 0; a < NU; ++a) kf_[a] = *kff(single, st, a, c);
          ld_vec<NX * NU>(slot(st) + kSlotB, &Bm_[0][0]);
        };
        load(st0, kf, Bm);
        for (int j = 0; j < dm.l[k]; ++j) {
          const int st = st0 + j, xn = xn0 + j;
          T kf_n[NU], Bm_n[NX][NU];
          if (j + 1 < dm.l[k]) load(st + 1, kf_n, Bm_n);
          T Kp[NU * ND], Ap[ND * ND];
          ld_vec<NU * ND>(Kf(st), Kp);
          ld_vec<ND * ND>(Acl(st), Ap);
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            T acc = Kp[a * ND] * xi[0];
#pragma unroll
            for (int e = 1; e < ND; ++e) acc += Kp[a * ND + e] * xi[e];
            S[o.u + (st * NU + a) * o.R + c] = acc + kf[a];
          }
#pragma unroll
          for (int i = 0; i < NX; ++i) S[o.x + (xn * NX + i) * o.R + c] = xi[i];
          T xn_[ND];
#pragma unroll
          for (int e = 0; e < ND; ++e) {
            T acc = Ap[e * ND] * xi[0];
#pragma unroll
            for (int cc_ = 1; cc_ < ND; ++cc_) acc += Ap[e * ND + cc_] * xi[cc_];
            T bk;
            if (e < NX) {
              bk = Bm[e][0] * kf[0];
#pragma unroll
              for (int a = 1; a < NU; ++a) bk += Bm[e][a] * kf[a];
            } else {
              bk = kf[e - NX];
            }
            xn_[e] = acc + bk;
          }
#pragma unroll
          for (int e = 0; e < ND; ++e) xi[e] = xn_[e];
          if (j + 1 < dm.l[k]) {
#pragma unroll
            for (int a = 0; a < NU; ++a) kf[a] = kf_n[a];
#pragma unroll
            for (int i = 0; i < NX; ++i)
#pragma unroll
              for (int a = 0; a < NU; ++a) Bm[i][a] = Bm_n[i][a];
          }
        }
        if (dm.leaf[k]) {
          const int xt = xn0 + dm.l[k];
#pragma unroll
          for (int i = 0; i < NX; ++i) S[o.x + (xt * NX + i) * o.R + c] = xi[i];
        }
        if (k + 1 < dm.nlev) {
#pragma unroll
          for (int e = 0; e < ND; ++e)
            S[ly.xiend + ((dm.bo[k] + b) * ND + e) * R + c] = xi[e];
        }
      }
      __syncwarp();
    }
    // slack columns: s = (w1 rows(x) - qs) / kap, and with them each
    // column's stage dot of the cone gradient, dtmp = g_x.x + g_u.u + q1 sum(s)
    // (gdot_cones sums it over the cones)
    struct SlackIn {
      T xv[NX], qs[NC], w1[NC], kp[NC], dh[NX], uv[NU], gx[NX], gu[NU];
    };
    batched<2>(lane, U * ncol, [&](int it) {
      const int st = it / ncol, c = it - st * ncol;
      const int xn = xnode[st];
      SlackIn v;
      rhs_slack(wood, c, st, v.qs);
#pragma unroll
      for (int i = 0; i < NX; ++i) v.xv[i] = S[o.x + (xn * NX + i) * o.R + c];
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        v.w1[r] = S[ly.w1 + st * NC + r];
        v.kp[r] = S[ly.kap + st * NC + r];
      }
      load_dh(st, v.dh);
#pragma unroll
      for (int i = 0; i < NX; ++i) v.gx[i] = S[ly.gx + st * NX + i];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        v.uv[a] = S[o.u + (st * NU + a) * o.R + c];
        v.gu[a] = S[ly.gu + st * NU + a];
      }
      return v;
    }, [&](int it, const SlackIn& v) {
      const int st = it / ncol, c = it - st * ncol;
      T sv[NC];
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        sv[r] = (v.w1[r] * row_val(v.dh, r, v.xv) - v.qs[r]) / v.kp[r];
        S[o.s + (st * NC + r) * o.R + c] = sv[r];
      }
      S[ly.dtmp + st * (K + 1) + c] = stage_dot(v.gx, v.xv, v.gu, v.uv, sv);
    });
    // risk columns: -(top-left block of the risk saddle's inverse) q
    const int mu0 = 2 * bdim + bdim * m;
    for (int it = lane; it < bdim * m * ncol; it += kWarp) {
      const int q = 2 * bdim + it / ncol, c = it % ncol;
      S[o.r + q * o.R + c] = -(rhs_risk(wood, c, q) / S[ly.hd + q]);
    }
    for (int it = lane; it < bdim * ncol; it += kWarp) {
      const int br = it / ncol, c = it - br * ncol;
      if (m == 1) risk_column<1>(wood, br, c, mu0, o);
      else if (m == 2) risk_column<2>(wood, br, c, mu0, o);
      else risk_column<3>(wood, br, c, mu0, o);
    }
    __syncwarp();
  }

  // One column of one branch's risk solve, by Gauss-Jordan with partial
  // pivoting on [M | rhs] (a = 2+M rows), as the plain version's
  // _gj_solve_pivot_bl: the pivot row is the first row j >= k with maximal
  // |aug[j][k]|, selected through comparison masks (NaN propagates).
  template <int M>
  __device__ __forceinline__ void risk_column(bool wood, int br, int c, int mu0,
                                              const Out& o) const {
    constexpr int a = 2 + M;
    const T eps = P.reg;
    const T* pa = cst(PA);
    T aug[a][a + 1];
    const T q_rho = rhs_risk(wood, c, br), q_sig = rhs_risk(wood, c, bdim + br);
#pragma unroll
    for (int i = 0; i < a; ++i)
#pragma unroll
      for (int j = 0; j <= a; ++j) aug[i][j] = T(0);
    aug[0][0] = S[ly.hd + br];
    aug[0][1] = -eps;
    aug[0][a] = q_rho - q_sig;
    aug[1][0] = T(1);
    aug[1][1] = T(1) + eps * eps;
    aug[1][a] = eps * q_sig;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T pai = pa[br * M + i];
      aug[1][2 + i] = -pai;
      aug[2 + i][1] = eps * pai;
#pragma unroll
      for (int j = 0; j < M; ++j)
        aug[2 + i][2 + j] = S[ly.hd + mu0 + br * M + i] * (i == j ? T(1) : T(0));
      aug[2 + i][a] = rhs_risk(wood, c, mu0 + br * M + i) + pai * q_sig;
    }
#pragma unroll
    for (int k = 0; k < a; ++k) {
      T elig[a], fo[a];
      T mx = T(0);
#pragma unroll
      for (int j = 0; j < a; ++j) {
        elig[j] = fabs(aug[j][k]) * (j >= k ? T(1) : T(0));
        mx = j == 0 ? elig[0] : pmax(mx, elig[j]);
      }
      T taken = T(0);
#pragma unroll
      for (int j = 0; j < a; ++j) {
        const T eq = (elig[j] >= mx ? T(1) : T(0)) * (j >= k ? T(1) : T(0));
        fo[j] = eq * (T(1) - taken);
        taken = taken + fo[j];
      }
      T piv[a + 1], rowk[a + 1];
#pragma unroll
      for (int cc_ = 0; cc_ <= a; ++cc_) {
        T acc = fo[0] * aug[0][cc_];
#pragma unroll
        for (int j = 1; j < a; ++j) acc += fo[j] * aug[j][cc_];
        piv[cc_] = acc;
        rowk[cc_] = aug[k][cc_];
      }
#pragma unroll
      for (int j = 0; j < a; ++j) {
        const bool sel = fo[j] > T(0.5);
#pragma unroll
        for (int cc_ = 0; cc_ <= a; ++cc_) aug[j][cc_] = sel ? rowk[cc_] : aug[j][cc_];
      }
      const T d = piv[k];
#pragma unroll
      for (int cc_ = 0; cc_ <= a; ++cc_) piv[cc_] = piv[cc_] / d;
#pragma unroll
      for (int j = 0; j < a; ++j) {
        if (j == k) continue;
        const T f = aug[j][k];
#pragma unroll
        for (int cc_ = 0; cc_ <= a; ++cc_) aug[j][cc_] = aug[j][cc_] - f * piv[cc_];
      }
#pragma unroll
      for (int cc_ = 0; cc_ <= a; ++cc_) aug[k][cc_] = piv[cc_];
    }
    S[o.r + br * o.R + c] = -aug[0][a];
    S[o.r + (bdim + br) * o.R + c] = -aug[1][a];
#pragma unroll
    for (int i = 0; i < M; ++i) S[o.r + (mu0 + br * M + i) * o.R + c] = -aug[2 + i][a];
  }

  // a stage's dot of the cone gradient with (x, u, s): g_x.x + g_u.u + q1 sum(s)
  __device__ __forceinline__ T stage_dot(const T* gx, const T* xv, const T* gu, const T* uv,
                                         const T* sv) const {
    T t1 = gx[0] * xv[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) t1 += gx[i] * xv[i];
    T t2 = gu[0] * uv[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) t2 += gu[a] * uv[a];
    T ss = sv[0];
#pragma unroll
    for (int r = 1; r < NC; ++r) ss += sv[r];
    return (t1 + t2) + P.qslack1 * ss;
  }

  // g_k^T v for every cone k and column c < ncol of a solve's outputs, from
  // the stage dots in dtmp: out[k*kstride + c] (shared memory)
  __device__ __forceinline__ void gdot_cones(const Out& o, int ncol, T* out, int kstride) {
    const int R = K + 1;
    const T* frisk = shr(FRISK);
    for (int it = lane; it < K * ncol; it += kWarp) {
      const int k = it / ncol, c = it - k * ncol;
      const T a1 = cone_sum(k, S + ly.dtmp + c, R);
      T a2 = frisk[k * nrisk] * S[o.r + c];
      for (int q = 1; q < nrisk; ++q)
        a2 += frisk[k * nrisk + q] * S[o.r + q * o.R + c];
      const T ci = cinv(k);
      out[k * kstride + c] = a1 * ci + a2 * ci;
    }
    __syncwarp();
  }

  // ---- Woodbury capacitance: W^-1 of I - (GtZ_ij sw_i) sw_j, sw = sqrt(wq) --
  // in shared memory; one lane per row eliminates
  __device__ __forceinline__ void capacitance() {
    const int R = K + 1, W2 = 2 * K;
    T *g = F + sm.gjaug, *winv = F + sm.winv;
    const T *gd = F + sm.gd, *sw = F + sm.sw;
    for (int it = lane; it < K * K; it += kWarp) {
      const int i = it / K, j = it - i * K;
      g[i * W2 + j] = (i == j ? T(1) : T(0)) - (gd[i * R + j] * sw[i]) * sw[j];
      g[i * W2 + K + j] = i == j ? T(1) : T(0);
    }
    __syncwarp();
    for (int i = 0; i < K; ++i) {
      const T pv = g[i * W2 + i];
      __syncwarp();
      for (int c = lane; c < W2; c += kWarp) g[i * W2 + c] = g[i * W2 + c] / pv;
      __syncwarp();
      for (int j = lane; j < K; j += kWarp) {
        if (j == i) continue;
        const T f = g[j * W2 + i];
        for (int c = 0; c < W2; ++c) g[j * W2 + c] = g[j * W2 + c] - f * g[i * W2 + c];
      }
      __syncwarp();
    }
    for (int it = lane; it < K * K; it += kWarp) {
      const int i = it / K, j = it - i * K;
      winv[it] = g[i * W2 + K + j];
    }
    __syncwarp();
  }

  // D's x, u, s, r := base (column `bc` of `b`) + sum_k Z_k corr_k, with
  // corr = wq * (Winv (sw phi0)) / sw and phi0[k*pstride] in shared memory
  // returns whether this lane's entries of D's x, u, s, r are finite
  __device__ __forceinline__ bool wb_correct(const DirOff& D, const Out& b, int bc,
                                             const T* phi0, int pstride) {
    const T *winv = F + sm.winv, *sw = F + sm.sw;
    T* phi = F + sm.phi;
    for (int k = lane; k < K; k += kWarp) {
      T acc = winv[k * K] * (sw[0] * phi0[0]);
      for (int j = 1; j < K; ++j) acc += winv[k * K + j] * (sw[j] * phi0[j * pstride]);
      phi[k] = S[ly.wq + k] * (acc / sw[k]);
    }
    __syncwarp();
    const bool fin = K <= 4      ? wb_fields<4, 8>(D, b, bc)
                     : K <= kWbK ? wb_fields<kWbK, 2>(D, b, bc)
                                 : wb_fields<0, 1>(D, b, bc);
    __syncwarp();
    return fin;
  }
  // KM > 0: the K (<= KM) coefficients in registers and each entry's row of Z
  // loaded whole before its sum, NB entries a lane at a time; KM = 0: any K,
  // one entry at a time
  template <int KM, int NB>
  __device__ __forceinline__ bool wb_fields(const DirOff& D, const Out& b, int bc) {
    const int R = K + 1;
    bool fin = true;
    const T* phi = F + sm.phi;

    constexpr int KR = KM > 0 ? KM : 1;
    T ph[KR];
#pragma unroll
    for (int k = 0; k < KR; ++k) ph[k] = k < K ? phi[k] : T(0);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // (a chain of selects, not an array: f need not unroll)
      const T* z = S + (f == 0 ? ly.Zx : f == 1 ? ly.Zu : f == 2 ? ly.Zs : ly.Zr);
      const T* base = S + (f == 0 ? b.x : f == 1 ? b.u : f == 2 ? b.s : b.r);
      T* dst = S + D.f[f];
      if (KM > 0) {
        struct ZRow {
          T z[KR], base;
        };
        batched<NB>(lane, (int)ly.vsz[f], [&](int e) {
          ZRow v;
#pragma unroll
          for (int k = 0; k < KR; ++k) v.z[k] = k < K ? z[e * R + k] : T(0);
          v.base = base[e * b.R + bc];
          return v;
        }, [&](int e, const ZRow& v) {
          T acc = v.z[0] * ph[0];
#pragma unroll
          for (int k = 1; k < KR; ++k)
            if (k < K) acc += v.z[k] * ph[k];
          const T y = v.base + acc;
          dst[e] = y;
          fin = fin & isfinite(y);
        });
      } else {
        for (int e = lane; e < (int)ly.vsz[f]; e += kWarp) {
          T acc = z[e * R] * phi[0];
          for (int k = 1; k < K; ++k) acc += z[e * R + k] * phi[k];
          const T y = base[e * b.R + bc] + acc;
          dst[e] = y;
          fin = fin & isfinite(y);
        }
      }
    }
    return fin;
  }

  // slack and multiplier directions from D's x, u, s, r; rc in scratch.
  // `pure` drops the residual terms (Gondzio corrector). `fin_xusr`: this
  // lane's finiteness of D's x, u, s, r. Returns D's step and finiteness.
  __device__ __forceinline__ Step<T> finish(const DirOff& D, bool pure, bool fin_xusr) {
    const T *sl1 = vv(ISL1), *lam1 = vv(ILAM1), *sl2 = vv(ISL2), *lam2 = vv(ILAM2),
            *sl3 = vv(ISL3), *lam3 = vv(ILAM3);
    T a = T(1);
    bool fin = fin_xusr;
    auto take = [&](T v, T dv) {
      a = pmin(a, step_ratio(v, dv));
      fin = fin & isfinite(dv);
    };
    for (int st = lane; st < U; st += kWarp) {
      const int xn = xnode[st];
      T xd[NX], ud[NU], dh[NX], ds[NC], r1[NC], r3[NC], c0[NC], c2[NC], l1[NC], s1[NC],
          l3[NC], s3[NC], r2[NF], c1[NF], l2[NF], s2[NF], gx[NX], gu[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        xd[i] = S[D.f[IX] + xn * NX + i];
        gx[i] = S[ly.gx + st * NX + i];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        ud[a] = S[D.f[IU] + st * NU + a];
        gu[a] = S[ly.gu + st * NU + a];
      }
      load_dh(st, dh);
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        const int e = st * NC + r;
        ds[r] = S[D.f[IS] + e];
        r1[r] = pure ? T(0) : S[ly.r1 + e];
        r3[r] = pure ? T(0) : S[ly.r3 + e];
        c0[r] = S[ly.rc[0] + e];
        c2[r] = S[ly.rc[2] + e];
        l1[r] = lam1[e]; s1[r] = sl1[e]; l3[r] = lam3[e]; s3[r] = sl3[e];
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const int e = st * NF + q;
        r2[q] = pure ? T(0) : S[ly.r2 + e];
        c1[q] = S[ly.rc[1] + e];
        l2[q] = lam2[e]; s2[q] = sl2[e];
      }
      S[ly.dtmp + st * (K + 1)] = stage_dot(gx, xd, gu, ud, ds);
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        const int e = st * NC + r;
        const T drow1 = row_val(dh, r, xd) - ds[r];
        const T dsl1 = pure ? -drow1 : -r1[r] - drow1;
        const T dsl3 = pure ? ds[r] : -r3[r] + ds[r];
        const T dl1 = (-c0[r] - l1[r] * dsl1) / s1[r], dl3 = (-c2[r] - l3[r] * dsl3) / s3[r];
        S[D.f[ISL1] + e] = dsl1;
        S[D.f[ISL3] + e] = dsl3;
        S[D.f[ILAM1] + e] = dl1;
        S[D.f[ILAM3] + e] = dl3;
        take(s1[r], dsl1);
        take(l1[r], dl1);
        take(s3[r], dsl3);
        take(l3[r], dl3);
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const int e = st * NF + q;
        const T drow2 = fu_val(q, ud);
        const T dsl2 = pure ? -drow2 : -r2[q] - drow2;
        const T dl2 = (-c1[q] - l2[q] * dsl2) / s2[q];
        S[D.f[ISL2] + e] = dsl2;
        S[D.f[ILAM2] + e] = dl2;
        take(s2[q], dsl2);
        take(l2[q], dl2);
      }
    }
    const T* Ssgn = shr(SSGN);
    for (int i = lane; i < nsgn; i += kWarp) {
      T acc = Ssgn[i * nrisk] * S[D.f[IR]];
      for (int q = 1; q < nrisk; ++q) acc += Ssgn[i * nrisk + q] * S[D.f[IR] + q];
      const T dsl4 = pure ? acc : -S[ly.r4 + i] + acc;
      const T s4 = vv(ISL4)[i], l4 = vv(ILAM4)[i];
      const T dl4 = (-S[ly.rc[3] + i] - l4 * dsl4) / s4;
      S[D.f[ISL4] + i] = dsl4;
      S[D.f[ILAM4] + i] = dl4;
      take(s4, dsl4);
      take(l4, dl4);
    }
    const Out od{D.f[IX], D.f[IU], D.f[IS], D.f[IR], 1};
    T* dq = F + sm.dq;
    __syncwarp();
    gdot_cones(od, 1, dq, 1);
    for (int k = lane; k < K; k += kWarp) {
      const T dsq = pure ? -dq[k] : -S[ly.rq + k] - dq[k];
      const T sqk = vv(ISQ)[k], lqk = vv(ILQ)[k];
      const T dlq = (-S[ly.rc[4] + k] - lqk * dsq) / sqk;
      S[D.f[ISQ] + k] = dsq;
      S[D.f[ILQ] + k] = dlq;
      take(sqk, dsq);
      take(lqk, dlq);
    }
    __syncwarp();
    return Step<T>{team_min(a), team_all(fin)};
  }

  // The complementarity right-hand side rc: the predictor's sl λ (mode 0),
  // the corrector's sl λ + dsl dλ − shift (mode 1, dsl dλ of D), or a Gondzio
  // corrector's capped distance of the trial products from [lo, hi] (mode 2,
  // trial point v + ab D).
  struct RcSpec {
    int mode;
    const DirOff* D;
    T shift, ab, lo, hi, cap;
  };
  __device__ __forceinline__ T rc_of(const RcSpec& rs, T s, T l, T ds, T dl) const {
    if (rs.mode == 0) return s * l;
    if (rs.mode == 1) return (s * l + ds * dl) - rs.shift;
    const T p = (s + rs.ab * ds) * (l + rs.ab * dl);
    const T t = pmin(pmax(p, rs.lo), rs.hi);
    return pmin(pmax(p - t, -rs.cap), rs.cap);
  }

  // rc (stored for finish) and the single right-hand side from it; a
  // Gondzio corrector (mode 2) drops the residual terms
  __device__ __forceinline__ void set_rhs(const RcSpec& rs) {
    const bool pure = rs.mode == 2, dir = rs.mode != 0;
    const DirOff& D = *rs.D;
    T *exqc = F + sm.exqc, *ex4 = F + sm.ex4;
    for (int i = lane; i < nsgn; i += kWarp) {
      const T s4 = vv(ISL4)[i], l4 = vv(ILAM4)[i];
      const T c3 = rc_of(rs, s4, l4, dir ? S[D.f[ISL4] + i] : T(0),
                         dir ? S[D.f[ILAM4] + i] : T(0));
      S[ly.rc[3] + i] = c3;
      ex4[i] = pure ? -c3 / s4 : (-c3 + l4 * S[ly.r4 + i]) / s4;
    }
    for (int k = lane; k < K; k += kWarp) {
      const T sqk = vv(ISQ)[k], lqk = vv(ILQ)[k];
      const T c4 = rc_of(rs, sqk, lqk, dir ? S[D.f[ISQ] + k] : T(0),
                         dir ? S[D.f[ILQ] + k] : T(0));
      S[ly.rc[4] + k] = c4;
      const T exq = pure ? -c4 / sqk : (-c4 + lqk * S[ly.rq + k]) / sqk;
      exqc[k] = exq * cinv(k);
    }
    __syncwarp();
    const T* maskT = shr(MASKT);
    const T *sl1 = vv(ISL1), *lam1 = vv(ILAM1), *sl2 = vv(ISL2), *lam2 = vv(ILAM2),
            *sl3 = vv(ISL3), *lam3 = vv(ILAM3);
    for (int st = lane; st < U; st += kWarp) {
      T r1[NC], l1[NC], s1[NC], r3[NC], l3[NC], s3[NC], rds[NC], d1[NC], e1[NC], d3[NC],
          e3[NC], r2[NF], l2[NF], s2[NF], d2[NF], e2[NF], rdx[NX], gx[NX], rdu[NU], gu[NU],
          dh[NX], wk[NC];
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        const int e = st * NC + r;
        s1[r] = sl1[e]; s3[r] = sl3[e]; l1[r] = lam1[e]; l3[r] = lam3[e];
        d1[r] = dir ? S[D.f[ISL1] + e] : T(0);
        e1[r] = dir ? S[D.f[ILAM1] + e] : T(0);
        d3[r] = dir ? S[D.f[ISL3] + e] : T(0);
        e3[r] = dir ? S[D.f[ILAM3] + e] : T(0);
        r1[r] = pure ? T(0) : S[ly.r1 + e];
        r3[r] = pure ? T(0) : S[ly.r3 + e];
        rds[r] = pure ? T(0) : S[ly.rds + e];
        wk[r] = S[ly.w1kap + e];
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const int e = st * NF + q;
        s2[q] = sl2[e]; l2[q] = lam2[e];
        d2[q] = dir ? S[D.f[ISL2] + e] : T(0);
        e2[q] = dir ? S[D.f[ILAM2] + e] : T(0);
        r2[q] = pure ? T(0) : S[ly.r2 + e];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        rdx[i] = pure ? T(0) : S[ly.rdx + st * NX + i];
        gx[i] = S[ly.gx + st * NX + i];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        rdu[a] = pure ? T(0) : S[ly.rdu + st * NU + a];
        gu[a] = S[ly.gu + st * NU + a];
      }
      load_dh(st, dh);
      T eg = maskT[st * K] * exqc[0];
      for (int k = 1; k < K; ++k) eg += maskT[st * K + k] * exqc[k];
      T ex1[NC], ex2[NF], vq[NC];
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        const int e = st * NC + r;
        const T c0 = rc_of(rs, s1[r], l1[r], d1[r], e1[r]);
        const T c2 = rc_of(rs, s3[r], l3[r], d3[r], e3[r]);
        S[ly.rc[0] + e] = c0;
        S[ly.rc[2] + e] = c2;
        ex1[r] = pure ? -c0 / s1[r] : (-c0 + l1[r] * r1[r]) / s1[r];
        const T ex3 = pure ? -c2 / s3[r] : (-c2 + l3[r] * r3[r]) / s3[r];
        const T base = pure ? -ex1[r] - ex3 : (rds[r] - ex1[r]) - ex3;
        const T qs = base + P.qslack1 * eg;
        S[ly.qs1 + e] = qs;
        vq[r] = wk[r] * qs;
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const T c1 = rc_of(rs, s2[q], l2[q], d2[q], e2[q]);
        S[ly.rc[1] + st * NF + q] = c1;
        ex2[q] = pure ? -c1 / s2[q] : (-c1 + l2[q] * r2[q]) / s2[q];
      }
      T rt[NX], ft[NU], rq[NX];
      row_valT(dh, ex1, rt);
      fu_valT(ex2, ft);
      // the sweep's x term: qx + Fxc^T((w1/kap) qs)
      row_valT(dh, vq, rq);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const T base = pure ? rt[i] : rdx[i] + rt[i];
        slot(st)[kSlotQe + i] = (base + eg * gx[i]) + rq[i];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const T base = pure ? ft[a] : rdu[a] + ft[a];
        slot(st)[kSlotQu + a] = base + eg * gu[a];
      }
    }
    const T *SsgnT = shr(SSGNT), *friskT = shr(FRISKT);
    for (int q = lane; q < nrisk; q += kWarp) {
      T sc = T(0);
      for (int i = 0; i < nsgn; ++i) {
        const T t = SsgnT[q * nsgn + i] * ex4[i];
        sc = i == 0 ? t : sc + t;
      }
      T add = friskT[q * K] * exqc[0];
      for (int k = 1; k < K; ++k) add += friskT[q * K + k] * exqc[k];
      const T base = pure ? -sc : S[ly.rdr + q] - sc;
      S[ly.qr1 + q] = base + add;
    }
    __syncwarp();
  }

  // one single-column direction into D from the rhs in q1 and rc
  __device__ __forceinline__ Step<T> direction(const DirOff& D, const RcSpec& rs) {
    const bool pure = rs.mode == 2;
    set_rhs(rs);
    const Out od{D.f[IX], D.f[IU], D.f[IS], D.f[IR], 1};
    h0_solve(false, 1, od);
    T* dq = F + sm.dq;
    gdot_cones(od, 1, dq, 1);
    const bool fin = wb_correct(D, od, 0, dq, 1);
    return finish(D, pure, fin);
  }

  // ---- step rules over the five complementarity families -------------------
  struct Quad {
    T s, l, ds, dl;
  };
  // the mean complementarity product at v + a[i] D for each of NA steps, in
  // one pass over one flat range of the
  // pairs of the five families (pair p of family f: sl at v[ISL1+2f] and λ
  // right after it, ly.vsz[ISL1+2f] entries on)
  template <int NA>
  __device__ __forceinline__ void gap_at(const DirOff& D, const T (&a)[NA], T (&out)[NA]) const {
    Acc acc[NA] = {};
    const int n0 = ly.vsz[ISL1], n1 = n0 + ly.vsz[ISL2], n2 = n1 + ly.vsz[ISL3],
              n3 = n2 + ly.vsz[ISL4], n4 = n3 + ly.vsz[ISQ];
    const int base = ly.v[ISL1], dbase = D.f[ISL1];
    batched<8>(lane, n4, [&](int p) {
      // offset of the pair's sl from v[ISL1] (D likewise), and of its λ from sl
      const int f = p < n0 ? 0 : p < n1 ? 1 : p < n2 ? 2 : p < n3 ? 3 : 4;
      const int start = f == 0 ? 0 : f == 1 ? n0 : f == 2 ? n1 : f == 3 ? n2 : n3;
      const int off = 2 * start + (p - start);
      const int len = f == 0 ? n0 : f == 1 ? n1 - n0 : f == 2 ? n2 - n1 : f == 3 ? n3 - n2
                                                                           : n4 - n3;
      return Quad{S[base + off], S[base + off + len], S[dbase + off], S[dbase + off + len]};
    }, [&](int, const Quad& x) {
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += Acc((x.s + a[i] * x.ds) * (x.l + a[i] * x.dl));
    });
#pragma unroll
    for (int i = 0; i < NA; ++i) out[i] = T(team_sum(acc[i]) / Acc(P.mtot));
  }
  // D_cand += D_cur over every field; returns whether all entries are finite
  __device__ __forceinline__ int carry_len() const {
    return (int)(ly.v[ILQ] + ly.vsz[ILQ] - ly.v[IX]);
  }
  // D_cand += D_cur over every field; returns the candidate's step and
  // finiteness (its complementarity entries lie from pair0 on, as in v)
  __device__ __forceinline__ Step<T> add_into(const DirOff& cand, const DirOff& cur) {
    bool ok = true;
    T am = T(1);
    const T *a = S + cur.f[IX], *v = vv(IX);
    T* b = S + cand.f[IX];
    const int pair0 = (int)(ly.v[ISL1] - ly.v[IX]);
    struct In {
      T cur, cand, v;
    };
    batched<8>(lane, carry_len(), [&](int e) {
      return In{a[e], b[e], e >= pair0 ? v[e] : T(0)};
    }, [&](int e, const In& x) {
      const T y = x.cur + x.cand;
      b[e] = y;
      ok = ok & isfinite(y);
      if (e >= pair0) am = pmin(am, step_ratio(x.v, y));
    });
    __syncwarp();
    return Step<T>{team_min(am), team_all(ok)};
  }

  // One iteration of this tree; leaves the step for stage_out (which writes
  // the new carry) in the team's shared memory.
  __device__ __forceinline__ void run(int t) {
    residuals();
    factor();
    // predictor: the K Woodbury columns and the predictor rhs in one solve
    const DirOff& Da = ly.D[0];
    set_rhs(RcSpec{0, &Da, T(0), T(0), T(0), T(0), T(0)});
    const int R = K + 1;
    const Out oz{ly.Zx, ly.Zu, ly.Zs, ly.Zr, R};
    h0_solve(true, R, oz);
    T* gd = F + sm.gd;
    gdot_cones(oz, R, gd, R);
    capacitance();
    const Step<T> sa = finish(Da, false, wb_correct(Da, oz, K, gd + K, R));
    const T a_aff[1] = {sa.a};
    T gap_aff[1];
    gap_at(Da, a_aff, gap_aff);
    const T ratio = gap_aff[0] / (gap + T(1e-30));
    const T sigma = pmin(pmax(ratio * ratio * ratio, T(0)), T(1));
    // corrector (g = -1), then the Gondzio correctors, through one call site;
    // `cur` is the step of the current direction D[ic]
    int ic = 1;
    Step<T> cur{T(0), true};
    for (int g = -1; g < dm.gondzio; ++g) {
      const bool corr = g < 0;
      const DirOff& Dcur = ic ? ly.D[1] : ly.D[0];
      const DirOff& Dnew = (corr || !ic) ? ly.D[1] : ly.D[0];
      RcSpec rs{1, &Da, sigma * gap, T(0), T(0), T(0), T(0)};
      if (!corr) {
        const T mu_t = sigma * gap + T(1e-30);
        const T hi = P.bmax * mu_t;
        rs = RcSpec{2, &Dcur, T(0), pmin(P.tau * cur.a + T(0.3), T(1)), P.bmin * mu_t, hi,
                    T(10) * hi};
      }
      const Step<T> sn = direction(Dnew, rs);
      if (corr) {
        cur = sn;
      } else {
        const Step<T> sc = add_into(Dnew, Dcur);
        if (sc.a > cur.a && sc.fin) {
          ic = 1 - ic;
          cur = sc;
        }
      }
    }
    const DirOff& Dc = ic ? ly.D[1] : ly.D[0];
    T a0 = P.tau * cur.a;
    const T *u = vv(IU), *s = vv(IS);
    const T obj_now = (T(0.5) * (u[0] * S[ly.gu] + u[1] * S[ly.gu + 1]) + vv(IR)[0])
        + P.qslack1 * ((((s[0] + s[1]) + s[2]) + s[3]) + s[4]);
    if (gap < P.gap_tol * (T(1) + fabs(obj_now))) a0 = T(0);
    if (P.itv < T(dm.early_iters)) a0 = pmin(a0, P.a_cap_early);
    // the two 0.3x backtracks on gap growth: the gaps at a0, 0.3 a0 and
    // 0.3 (0.3 a0), taken in one pass
    const T grow = T(10) * gap + T(1e-9);
    const T cand[3] = {a0, T(0.3) * a0, T(0.3) * (T(0.3) * a0)};
    T g3[3];
    gap_at(Dc, cand, g3);
    const bool back1 = g3[0] > grow;
    const T a1 = back1 ? cand[1] : cand[0];
    const T a = (back1 ? g3[1] : g3[0]) > grow ? (back1 ? cand[2] : cand[1]) : a1;
    const bool finite = cur.fin && isfinite(a);
    if (lane == 0) {
      F[sm.res] = a;
      F[sm.res + 1] = finite ? T(1) : T(0);
      F[sm.res + 2] = T(ic);
      P.gap[t] = gap;
    }
  }
};

// Element rows of the block's trees between the batch-last arrays and the
// teams' scratch slots (per-stage constants, carry) or shared memory (the
// small per-tree constants): consecutive threads take consecutive lanes t.
template <typename T>
__device__ __forceinline__ void stage_in(const Params<T>& P, T* Sblk, T* Fblk, long long base,
                                         int nv, int nT) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const Layout& ly = P.ly;
  for (int i = 0; i < kNConst + kNCarry; ++i) {
    const bool c = i < kNConst;
    const T* src = (c ? P.c[i] : P.in[i - kNConst]) + base;
    const int n = (int)(c ? ly.csz[i] : ly.vsz[i - kNConst]);
    const bool smem = c && i >= PA;
    T* dst = smem ? Fblk + P.sm.qc[i] : Sblk + (c ? ly.cst[i] : ly.v[i - kNConst]);
    const int stride = smem ? P.sm.total : ly.total;
    for (int idx = tid; idx < n * nT; idx += nthr) {
      const int e = idx / nT, tt = idx - e * nT;
      if (tt < nv) dst[tt * stride + e] = src[e * P.B + tt];
    }
  }
}

// The new carry v + a D[ic] of each tree (its carry where the step is not
// finite), from the step that run() left in the team's shared memory.
template <typename T>
__device__ __forceinline__ void stage_out(const Params<T>& P, const T* Sblk, const T* Fblk,
                                          long long base, int nv, int nT) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const Layout& ly = P.ly;
  for (int f = 0; f < kNCarry; ++f) {
    T* dst = P.out[f] + base;
    const int n = (int)ly.vsz[f];
    for (int idx = tid; idx < n * nT; idx += nthr) {
      const int e = idx / nT, tt = idx - e * nT;
      if (tt >= nv) continue;
      const T* res = Fblk + tt * P.sm.total + P.sm.res;
      const T* St = Sblk + tt * ly.total;
      const T v = St[ly.v[f] + e];
      dst[e * P.B + tt] = res[1] != T(0)
          ? v + res[0] * St[(res[2] != T(0) ? ly.D[1].f[f] : ly.D[0].f[f]) + e] : v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
cvar_ipm_iter_kernel(const __grid_constant__ Params<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims& dm = P.dm;
  const int tid = threadIdx.x, nT = blockDim.x / kWarp;
  T* Fblk = reinterpret_cast<T*>(smem_raw);            // the teams' regions
  T* shc = Fblk + (long long)nT * P.sm.total;           // the shared constants
  int* xnode = reinterpret_cast<int*>(shc + P.shtotal);
  int* crange = xnode + dm.totalu;
  // once a block: the shared constants, the x node of each stage, and each
  // cone's stages: the span of its mask row's nonzeros, or all stages if the
  // row has a zero inside that span
  for (int i = 0; i < kNShared; ++i)
    for (int e = tid; e < P.shsz[i]; e += blockDim.x) shc[P.shoff[i] + e] = P.sh[i][e];
  for (int k = 0; k < dm.nlev; ++k)
    for (int idx = tid; idx < dm.nb[k] * dm.l[k]; idx += blockDim.x) {
      const int b = idx / dm.l[k], j = idx - b * dm.l[k];
      xnode[dm.u0[k] + idx] = dm.x0[k] + b * dm.lx[k] + j;
    }
  __syncthreads();
  for (int k = tid; k < dm.K; k += blockDim.x) {
    const T* mk = shc + P.shoff[MASK] + k * dm.totalu;
    int j0 = dm.totalu, j1 = 0;
    for (int j = 0; j < dm.totalu; ++j)
      if (mk[j] != T(0)) {
        j0 = j < j0 ? j : j0;
        j1 = j + 1;
      }
    bool dense = false;
    for (int j = j0; j < j1; ++j) dense = dense || mk[j] == T(0);
    crange[2 * k] = dense ? 0 : (j0 < j1 ? j0 : 0);
    crange[2 * k + 1] = dense ? dm.totalu : j1;
  }
  __syncthreads();
  const int w = tid / kWarp, lane = tid % kWarp;
  T* Sblk = P.scratch + (long long)blockIdx.x * nT * P.ly.total;
  for (long long base = (long long)blockIdx.x * nT; base < P.B;
       base += (long long)gridDim.x * nT) {
    const int nv = P.B - base < nT ? (int)(P.B - base) : nT;
    stage_in(P, Sblk, Fblk, base, nv, nT);
    __syncthreads();
    if (w < nv) {
      Team<T> team(P, Sblk + w * P.ly.total, Fblk + (long long)w * P.sm.total, shc, xnode,
                   lane);
      team.run(base + w);
    }
    __syncthreads();
    stage_out(P, Sblk, Fblk, base, nv, nT);
    __syncthreads();
  }
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
  long long shsz[kNShared], sh_total = 0;
  shared_sizes(dm, shsz);
  for (int i = 0; i < kNShared; ++i) sh_total += shsz[i];
  const long long fixed =
      sh_total * (long long)sizeof(T) + (long long)(dm.totalu + 2 * dm.K) * sizeof(int);
  const long long per_team = make_sm_layout(dm).total * (long long)sizeof(T);
  long long tmax = (optin - fixed) / per_team;
  if (tmax > kMaxTeams) tmax = kMaxTeams;
  if (tmax < 1) return (int)cudaErrorInvalidValue;
  // few trees: fewer a block, so that they spread over more SMs
  long long teams = (B + sms - 1) / sms;
  teams = teams < 1 ? 1 : (teams > tmax ? tmax : teams);
  const int smem = (int)(fixed + teams * per_team);
  // the card's whole opt-in size, so that every cached plan may launch
  err = cudaFuncSetAttribute(cvar_ipm_iter_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cvar_ipm_iter_kernel<T>,
                                                      (int)teams * kWarp, smem);
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

template <typename T>
int launch(const void* const* ptrs, const int* ints, const double* dbl, long long B, int device,
           void* stream) {
  Params<T> P;
  if (B < 1 || !parse_dims(ints, &P.dm)) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  Plan pl;
  const int err = cached_plan<T>(P.dm, ints, B, device, &pl);
  if (err != 0) return err;
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
  P.sm = make_sm_layout(P.dm);
  long long shsz[kNShared];
  shared_sizes(P.dm, shsz);
  P.shtotal = 0;
  for (int i = 0; i < kNShared; ++i) {
    P.shsz[i] = (int)shsz[i];
    P.shoff[i] = P.shtotal;
    P.shtotal += P.shsz[i];
  }
  const unsigned blocks = (unsigned)pl.blocks, threads = (unsigned)(pl.teams * kWarp);
  const size_t smem = (size_t)pl.smem;
  cvar_ipm_iter_kernel<T><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: 11 per-lane constants (CONST_ORDER), 9 shared constants
// (SHARED_ORDER), 14 carry in, 14 carry out (CARRY_ORDER), gap (1, B),
// scratch (bp_cvar_iter_plan's elements); per-lane arrays batch-last, every
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

// The launch shape of B trees in f32 (f64 = 0) or f64 on `device`: out =
// scratch elements, blocks, trees a block, resident blocks an SM, SMs,
// dynamic shared memory bytes a block. Returns 0, or cudaErrorInvalidValue
// (1) for dims the kernel does not take, or the CUDA error of a query.
extern "C" int bp_cvar_iter_plan(const int* ints, long long B, int f64, int device,
                                 long long* out) {
  Dims dm;
  if (B < 1 || !parse_dims(ints, &dm)) return (int)cudaErrorInvalidValue;
  Plan pl;
  const int err = f64 ? cached_plan<double>(dm, ints, B, device, &pl)
                      : cached_plan<float>(dm, ints, B, device, &pl);
  if (err != 0) return err;
  const long long v[6] = {pl.scratch, pl.blocks, pl.teams, pl.per_sm, pl.sms, pl.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
