"""The sweeps' small-matrix products, library against fixed order
(``solvers/tree_qp_pl.LIBRARY`` and ``FIXED_ORDER``), on one device:

1. batch invariance: each product on each level's blocks of the
   branch-sharded tree KKT's wide tree (``chip_smoke.kkt_case``: m=4, NB=5,
   N=2, T=256, f64), the whole batch against its two halves put together;
2. time: the KKT's unsharded sweeps (T=256, f64) and K1's and K2's plain
   iterations (the QP overtake and ``cvar_merge`` at B, f32), each product
   set in turns, CUDA events on the card, the host clock on the CPU;
3. accuracy: K1's plain iteration in f32 against the same in f64 on the
   upcast inputs, per product set (and with the fixed-order sums
   accumulated by ``torch.addcmul``): the max over the lanes, which
   K1's f32 bar in ``chip_smoke.py`` uses, and the 99.9th percentile, for
   the fields x, u, lam1, lam2, lam3.

    python scripts/torch_port_plain_products.py [--device cuda|cpu] [--B 32768]

Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from belief_planning_tpu_torch.solvers import cvar_pl  # noqa: E402
from belief_planning_tpu_torch.solvers import tree_qp_pl as tq  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig  # noqa: E402
from belief_planning_tpu_torch.utils.device import resolve_device  # noqa: E402


def _addcmul_products():
    """The fixed-order sums with each term added by ``torch.addcmul``."""
    def mm(A, B):
        out = A[:, :, 0, None] * B[:, None, 0]
        for k in range(1, A.shape[2]):
            out = torch.addcmul(out, A[:, :, k, None], B[:, None, k])
        return out

    def mtm(A, B):
        out = A[:, 0, :, None] * B[:, None, 0]
        for k in range(1, A.shape[1]):
            out = torch.addcmul(out, A[:, k, :, None], B[:, None, k])
        return out

    def mv(A, v):
        out = A[:, :, 0] * v[:, None, 0]
        for k in range(1, A.shape[2]):
            out = torch.addcmul(out, A[:, :, k], v[:, None, k])
        return out

    def mtv(A, v):
        out = A[:, 0] * v[:, None, 0]
        for k in range(1, A.shape[1]):
            out = torch.addcmul(out, A[:, k], v[:, None, k])
        return out

    return tq.Products(mm, mtm, mv, mtv)


def products():
    return {"library": tq.LIBRARY, "fixed_order": tq.FIXED_ORDER, "addcmul": _addcmul_products()}


def using(pr):
    """Make ``pr`` the sweeps' default products (K1's and K2's plain
    versions call the sweeps with the default)."""
    for f in (tq._riccati_step, tq._factor_blocks, tq._linear_blocks, tq._forward_blocks):
        d = list(f.__defaults__)
        d[-1] = pr
        f.__defaults__ = tuple(d)


def timer(dev):
    if dev.type == "cuda":
        return lambda fn, reps: cs.cuda_ms(fn, reps)

    def host_ms(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    return host_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--B", type=int, default=cs.BENCH_B, help="lanes of K1's / K2's iteration")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = timer(dev)
    sets = products()
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "B": args.B}

    plan, bl = cs.kkt_case(dev)
    levels = tq.build_levels(plan)
    out["whole_vs_halves_by_level"] = {name: cs.helpers_whole_vs_halves(bl, levels, pr)
                                       for name, pr in sets.items()}
    N_, NB_, m_, n_, d_ = cs.KKT_DIMS

    def kkt(pr):
        K_l, Hinv_l, Acl_l = tq._factor_blocks(levels, bl["Qx2"], bl["Dab2"], bl["Ru2"],
                                               bl["Pterm2"], bl["A"], bl["B"], n_, d_, m_, pr)
        kff_l = tq._linear_blocks(levels, K_l, Hinv_l, Acl_l, bl["B"], bl["qx"], bl["qu"],
                                  bl["qterm"], n_, d_, m_, pr)
        return tq._forward_blocks(levels, K_l, Acl_l, bl["B"], kff_l, n_, d_, m_, cs.KKT_T, pr)

    qcfg = QPIPMConfig(iters=8, gondzio=2)
    plan_q, _, su_q = cs.qp_case(dev, args.B, torch.float32, qcfg)
    mtot = float(plan_q.topo.totalu * (2 * 5 + 4))
    ccfg = CVaRIPMConfig(iters=24, gondzio=2)
    cplan, su_c, _ = cs.cvar_case("cvar_merge", dev, args.B, torch.float32, ccfg)
    times = {name: {"tree_kkt_ms": [], "k1_plain_ms": [], "k2_plain_ms": []} for name in sets}
    for _ in range(2):                       # in turns: library, fixed, addcmul, library, ...
        for name, pr in sets.items():
            using(pr)
            plain_q = tq.make_iteration(plan_q, qcfg, 4, 4, mtot)
            plain_c = cvar_pl.make_cvar_iteration(cplan, ccfg, su_c.dims)
            t = times[name]
            t["tree_kkt_ms"].append(ms(lambda: kkt(pr), 3))
            t["k1_plain_ms"].append(ms(lambda: plain_q(*su_q.const_args, *su_q.carry0), 2))
            t["k2_plain_ms"].append(ms(lambda: plain_c(*su_c.in_args, 0, *su_c.carry0), 1))
    out["times"] = times
    del bl, su_c

    up = lambda ts: [t.double() for t in ts]
    names = tq.CARRY_ORDER + ["gap"]
    using(tq.FIXED_ORDER)
    ref64 = tq.make_iteration(plan_q, qcfg, 4, 4, mtot)(*up(su_q.const_args), *up(su_q.carry0))
    acc = {}
    for name, pr in sets.items():
        using(pr)
        got = tq.make_iteration(plan_q, qcfg, 4, 4, mtot)(*su_q.const_args, *su_q.carry0)
        acc[name] = {}
        for nm, g, r in zip(names, got, ref64):
            if nm in ("x", "u", "lam1", "lam2", "lam3"):
                e = (g.double() - r).abs().reshape(-1, args.B).amax(0)
                acc[name][nm] = {"max": e.max().item(),
                                 "p999": torch.quantile(e.cpu(), 0.999).item()}
    using(tq.LIBRARY)
    out["k1_plain_f32_error_vs_f64"] = acc
    print(json.dumps(out))


if __name__ == "__main__":
    main()
