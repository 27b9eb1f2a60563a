"""Parity-grade measurement of the fused CVaR step: f32 against f64, the
port's counterpart of ``scripts/cvar_f32_parity.py``.

At B hard cold-start lanes (``torch_port_cvar_f32_diag.hard_batch``, numpy
seed 0; the CVaR overtake, N=8, NB=2, ralpha 0.9) the fused batched CVaR
step (``make_cvar_mpc_batched_step``: K2, the fused CVaR IPM iteration, on
the card; its plain version on the CPU) runs in four modes:

- ``ref``: f64 states and solve, IPM-100 with 2 Gondzio correctors (the
  reference-scale gate's budget): the answer the others are measured against;
- ``f32``: f32 states and solve, IPM-24 with 2 correctors (the bench config);
- ``refineK``: f64 states, the IPM-24 solve in f32 (``solve_dtype``) and a
  K-iteration f64 restart (``refine_f64``; K=24 by default, the restart with
  its flipped corrector pattern);
- ``refineK2g4``: as ``refineK`` with a K2-iteration restart at 4 correctors
  (``refine_cfg``; K2=60).

Each mode takes a cold step, a first warm step and REPS timed warm steps on
the same inputs; the u0 error of the cold and of the last warm step (the
settled receding-horizon point) is taken against ``ref``'s on the lanes where
``ref``'s gap is below CVAR_TIGHT_GAP (on hard cold lanes the cold-start
Mehrotra jam leaves some lanes unconverged for every solver; those lanes are
counted, not compared). Prints each mode's gap percentiles and ms a warm step,
then the u0 error p50 / p90 / max of each mode, cold and warm.

    python scripts/torch_port_cvar_f32_parity.py [--device cuda|cpu]

``--device`` defaults to the CUDA card. Env, as the reference script's:
CVAR_B (256), CVAR_REPS (5) timing reps, CVAR_REF_ITERS (100), CVAR_REFINE
(24), CVAR_REFINE2 (60), CVAR_TIGHT_GAP (1e-5); and CVAR_N, CVAR_NB (the
tree, 8 and 2 as the reference's) and CVAR_SOLVE_ITERS (the f32 solve's
iterations, 24; both smaller for a quick run). The reference's
CVAR_TILE has no counterpart: K2 plans its own launch.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step  # noqa
from belief_planning_tpu_torch.solvers import cvar_pl  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from belief_planning_tpu_torch.utils.device import resolve_device  # noqa: E402
from torch_port_cvar_f32_diag import XREF, hard_batch, overtake_setup  # noqa: E402

F32, F64 = torch.float32, torch.float64


def modes(ref_iters=100, k_ref=24, k2=60, solve_iters=24):
    """name: (state dtype, IPM config, f64 restart iterations, solve dtype,
    restart config), the reference first."""
    ipm = CVaRIPMConfig(iters=solve_iters, gondzio=2)
    return {
        "ref": (F64, CVaRIPMConfig(iters=ref_iters, gondzio=2), 0, None, None),
        "f32": (F32, ipm, 0, None, None),
        f"refine{k_ref}": (F64, ipm, k_ref, F32, None),
        f"refine{k2}g4": (F64, ipm, k2, F32, CVaRIPMConfig(iters=k2, gondzio=4)),
    }


def expected_launches(mode, steps):
    """K2's launches of ``steps`` steps of a mode: ``(f32, f64)``."""
    dtype, ipm, refine, sd, _ = mode
    solve_f64 = (sd or dtype) == F64
    return (0 if solve_f64 else steps * ipm.iters,
            steps * ((ipm.iters if solve_f64 else 0) + refine))


def run_mode(mode, B, reps, dev, kernel=None, N=8, NB=2):
    """A mode's cold step, first warm step and ``reps`` timed warm steps:
    a dict of u0 and gap (cold, warm), the median ms of a warm step and, with
    ``kernel``, its launches (f32, f64) over the mode, counted from 0."""
    dtype, ipm, refine, sd, rcfg = mode
    _, pset, model, params = overtake_setup(N, NB)
    _, _, init_carry, step = make_cvar_mpc_batched_step(model, params, ralpha=0.9, ipm=ipm,
                                                        refine_f64=refine, solve_dtype=sd,
                                                        refine_cfg=rcfg, device=dev)
    xs, zs = (torch.as_tensor(a, dtype=dtype, device=dev) for a in hard_batch(B))
    xRefs = torch.as_tensor(np.tile(XREF, (B, 1)), dtype=dtype, device=dev)
    u0 = lambda r: r.uPred[:, 0].double().cpu().numpy()
    gap = lambda r: r.gap.double().cpu().numpy().ravel()
    if kernel is not None:
        kernel.launches = kernel.launches_f64 = 0
    t0 = time.perf_counter()
    carrys, res = step(init_carry(B, dtype), xs, zs, xRefs, pset.params)
    out = {"u_cold": u0(res), "gap_cold": gap(res), "cold_s": time.perf_counter() - t0}
    carrys, res = step(carrys, xs, zs, xRefs, pset.params)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        carrys, res = step(carrys, xs, zs, xRefs, pset.params)
        _ = res.uPred.cpu()
        times.append(time.perf_counter() - t0)
    out.update(u_warm=u0(res), gap_warm=gap(res), ms=float(np.median(times)) * 1e3,
               finite=bool(np.isfinite(out["u_cold"]).all() and np.isfinite(u0(res)).all()))
    if kernel is not None:
        out["launches"] = (kernel.launches - kernel.launches_f64, kernel.launches_f64)
    return out


def u0_error(u, ref, mask):
    """p50, p90 and max over the lanes of ``mask`` of |u0 - ref u0|, or None."""
    e = np.abs(u - ref).max(axis=1)[mask]
    if e.size == 0:
        return None
    return {"p50": float(np.percentile(e, 50)), "p90": float(np.percentile(e, 90)),
            "max": float(e.max())}


def f32_parity(device=None, B=256, reps=5, kernel=None, ref_iters=100, k_ref=24, k2=60,
               tight_gap=1e-5, N=8, NB=2, solve_iters=24, out=print):
    """Every mode, then the error table against ``ref``: a dict with each
    mode's results (``modes``), the tight lane counts and the u0 error
    columns (``errors``: mode -> {"cold", "warm"} -> p50 / p90 / max)."""
    dev = resolve_device(device)
    ms = modes(ref_iters, k_ref, k2, solve_iters)
    res = {}
    for tag, mode in ms.items():
        r = res[tag] = run_mode(mode, B, reps, dev, kernel, N, NB)
        r["expected_launches"] = expected_launches(mode, 2 + reps)
        out(f"[{tag}] cold {r['cold_s']:.1f}s  warm-step "
            f"{r['ms']:.1f} ms/step (B={B})  gap cold p50 "
            f"{np.percentile(r['gap_cold'], 50):.2g}/p90 {np.percentile(r['gap_cold'], 90):.2g}"
            f"  warm p50 {np.percentile(r['gap_warm'], 50):.2g}/p90 "
            f"{np.percentile(r['gap_warm'], 90):.2g}")
        sys.stdout.flush()
    ref = res["ref"]
    m_cold, m_warm = ref["gap_cold"] < tight_gap, ref["gap_warm"] < tight_gap
    errors = {tag: {"cold": u0_error(r["u_cold"], ref["u_cold"], m_cold),
                    "warm": u0_error(r["u_warm"], ref["u_warm"], m_warm)}
              for tag, r in res.items() if tag != "ref"}
    fmt = lambda e: ("no tight reference lanes" if e is None
                     else f"p50 {e['p50']:.3g} p90 {e['p90']:.3g} max {e['max']:.3g}")
    out("")
    out(f"u0 error vs f64-{ref_iters}+g2 reference, on lanes where the reference is tight "
        f"(gap<{tight_gap:g}): cold {int(m_cold.sum())}/{B}, warm {int(m_warm.sum())}/{B}")
    for tag, e in errors.items():
        out(f"  {tag:<11s} cold: {fmt(e['cold'])}   warm: {fmt(e['warm'])}   "
            f"({res[tag]['ms']:.1f} ms/step)")
    return {"B": B, "reps": reps, "modes": res, "errors": errors,
            "tight_cold": int(m_cold.sum()), "tight_warm": int(m_warm.sum())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    env = os.environ.get
    f32_parity(dev, int(env("CVAR_B", "256")), int(env("CVAR_REPS", "5")),
               cvar_pl.KERNEL if dev.type == "cuda" else None, int(env("CVAR_REF_ITERS", "100")),
               int(env("CVAR_REFINE", "24")), int(env("CVAR_REFINE2", "60")),
               float(env("CVAR_TIGHT_GAP", "1e-5")), int(env("CVAR_N", "8")),
               int(env("CVAR_NB", "2")), int(env("CVAR_SOLVE_ITERS", "24")))


if __name__ == "__main__":
    main()
