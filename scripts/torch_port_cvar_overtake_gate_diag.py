"""Diagnosis of the overtake CVaR reference-scale gate
(``tests/test_torch_reference_scale.py::test_overtake_reference_scale_cvar``):
the port's counterpart of ``scripts/cvar_overtake_gate_diag.py``.

Runs the gate's closed loop (the demo overtake, N=8, NB=2, ralpha 0.9, both
worlds driven by their own applied inputs) with the port's one-tree
``BranchMPCCVaR`` (f64) against the dense f64 NumPy oracle
(``belief_planning_tpu.oracle.reference_cvar.OracleCVaRController``, its
model calls computed by the port's model) and prints at each step the
applied-input deviation, the teacher-forced twin's (the engine's warm start
forced to the oracle's previous solution on the oracle's state, the merge
gate's technique, so that solver error and genuine closed-loop forks are
told apart), the oracle's status, gap and primal residual and the engine's
gap; it saves every series (and the oracle's dual residual, its non-optimal
flag and both worlds' states) to an ``.npz``.

    python scripts/torch_port_cvar_overtake_gate_diag.py [steps] [iters] [gondzio] [--device cuda|cpu]

Defaults: 100 steps, IPM-100, 2 Gondzio correctors, as the reference
script's; ``--device`` defaults to the CUDA card. Env: CVAR_DIAG_OUT (the
``.npz``, default ``torch_port_cvar_overtake_diag.npz`` in the temporary
directory, ``$TMPDIR`` or ``/tmp``), CVAR_RESTART (the engine's restart
iterations, 0 as the reference script's; the gate runs 60), CVAR_N, CVAR_NB
(the tree, 8 and 2; smaller for a quick run). At the demo's size a step
takes most of a minute on the CPU, much more on the oracle's jam steps.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from belief_planning_tpu.oracle.reference_cvar import OracleCVaRController  # noqa: E402

from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from torch_port_cvar_hard_oracle import PortModelAdapter  # noqa: E402
from torch_port_f32_parity_episode import X0, Z0, demo, world_step  # noqa: E402

KEYS = ("err", "err_forced", "o_gap", "o_pr", "o_dr", "o_maxiter", "e_gap", "xo", "xj")


def diagnose(steps, iters, gondzio, device, restart=0, N=8, NB=2, out=print):
    """The gate's loop with both series; returns the record of every key
    of ``KEYS`` as numpy arrays."""
    cons, pset, model, params = demo(N, NB)
    oracle = OracleCVaRController(params, PortModelAdapter(model, pset.params), ralpha=0.9)
    mpc = BranchMPCCVaR(params, model, pset.params, ralpha=0.9,
                        ipm=CVaRIPMConfig(iters=iters, gondzio=gondzio), restart=restart,
                        dtype=torch.float64, device=device)
    xRef = params.xRef
    x_o, z_o = X0.copy(), Z0.copy()
    x_j, z_j = X0.copy(), Z0.copy()
    rec = {k: [] for k in KEYS}
    for t in range(steps):
        prev_u = None if oracle.uPred is None else np.asarray(oracle.uPred).copy()
        prev_old = np.asarray(oracle.OldInput).copy() if prev_u is not None else None
        u_o = oracle.solve(x_o, z_o, xRef)
        sol = oracle.solution
        # the forced twin: the oracle's program (its state and its previous
        # solution as the warm start), then the closed loop's own carry again
        c = mpc.carry
        u_j = np.asarray(mpc.solve(x_j, z_j, xRef))
        c_loop = mpc.carry
        if prev_u is not None:
            tt = lambda a: torch.as_tensor(a, dtype=c.u_lin.dtype, device=c.u_lin.device)[None]
            mpc.carry = c._replace(u_lin=tt(prev_u), old_input=tt(prev_old))
            u_f = np.asarray(mpc.solve(x_o, z_o, xRef))
            mpc.carry = c_loop
        else:
            u_f = u_j
        rec["err"].append(np.abs(u_o - u_j).max())
        rec["err_forced"].append(np.abs(u_o - u_f).max())
        rec["o_gap"].append(float(getattr(sol, "gap", np.nan)))
        rec["o_pr"].append(float(getattr(sol, "prim_res", np.nan)))
        rec["o_dr"].append(float(getattr(sol, "dual_res", np.nan)))
        rec["o_maxiter"].append(int(sol.status != "optimal"))
        rec["e_gap"].append(float(mpc.last.gap))
        rec["xo"].append(x_o.copy())
        rec["xj"].append(x_j.copy())
        out(f"t={t:3d} err={rec['err'][-1]:.3e} forced={rec['err_forced'][-1]:.3e} "
            f"o[{sol.status} gap={rec['o_gap'][-1]:.1e} pr={rec['o_pr'][-1]:.1e}] "
            f"e_gap={rec['e_gap'][-1]:.1e}")
        sys.stdout.flush()
        x_o, z_o = world_step(x_o, z_o, u_o, cons.Kpsi)
        x_j, z_j = world_step(x_j, z_j, u_j, cons.Kpsi)
    return {k: np.asarray(v) for k, v in rec.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=100)
    ap.add_argument("iters", nargs="?", type=int, default=100)
    ap.add_argument("gondzio", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    env = os.environ.get
    rec = diagnose(args.steps, args.iters, args.gondzio, args.device,
                   int(env("CVAR_RESTART", "0")), int(env("CVAR_N", "8")),
                   int(env("CVAR_NB", "2")))
    path = env("CVAR_DIAG_OUT",
               os.path.join(tempfile.gettempdir(), "torch_port_cvar_overtake_diag.npz"))
    np.savez(path, **rec)
    e, ef = rec["err"], rec["err_forced"]
    print(f"\nmax err {e.max():.3e} @ t={e.argmax()}; max FORCED err {ef.max():.3e} @ "
          f"t={ef.argmax()}; oracle max_iter steps: {int(rec['o_maxiter'].sum())}")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
