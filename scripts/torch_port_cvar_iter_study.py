"""Warm-started CVaR iteration-count study, receding-horizon parity against
iterations: the port's counterpart of ``scripts/cvar_iter_study.py``.

The 40-iteration default is the cold-start number. This measures the
warm-started receding-horizon accuracy: one trajectory of the dense f64
oracle (``belief_planning_tpu.oracle.reference_cvar.OracleCVaRController``,
ralpha 0.9, tol 1e-9, 300 iterations, its model calls computed by the
port's model; advanced with the oracle's applied input, its last iterate on
a step it does not solve to optimality), then the port's warm-started
one-tree ``BranchMPCCVaR`` along the same states for each iteration count,
printing each step's applied-input error against the oracle and the max.

    python scripts/torch_port_cvar_iter_study.py [--device cuda|cpu]

``--device`` defaults to the CUDA card. Env, as the reference script's:
CVAR_DTYPE (f64), CVAR_ITER_LIST (12,16,20,28,40), CVAR_GONDZIO (0), STEPS
(8); and CVAR_N, CVAR_NB (the tree, 8 and 2 as the reference's; smaller
for a quick run).
"""

import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from belief_planning_tpu.oracle.reference_cvar import OracleCVaRController  # noqa: E402

from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from torch_port_cvar_f32_diag import XREF, overtake_setup  # noqa: E402
from torch_port_cvar_hard_oracle import PortModelAdapter  # noqa: E402

X0 = np.array([0.0, 1.8, 20.0, 0.0])
Z0 = np.array([9.0, 1.8, 17.0, 0.0])


def _f(s, u):
    return s + np.array([s[2] * np.cos(s[3]), s[2] * np.sin(s[3]), u[0], u[1]]) * 0.1


def _take_last_iterate(oracle):
    """Make the oracle's last iterate its solution, as the reference script
    does on a step that is not solved to optimality."""
    sol = oracle.solution
    n, d = oracle.n, oracle.d
    oracle.uPred = sol.v[oracle.totalx * n: oracle.totalx * n + oracle.totalu * d].reshape(-1, d)
    oracle.xPred = sol.v[: oracle.totalx * n].reshape(-1, n)
    oracle.xLin = oracle.xPred
    oracle.uLin = np.vstack((oracle.uPred, oracle.uPred[-1]))
    oracle.OldInput = oracle.uPred[0].copy()
    return oracle.uPred[0].copy()


def oracle_trajectory(steps, N=8, NB=2, out=print):
    """``[(x, z, u_o), ...]``: the states of the oracle's closed loop and its
    applied input at each."""
    cons, pset, model, params = overtake_setup(N, NB)
    oracle = OracleCVaRController(params, PortModelAdapter(model, pset.params), ralpha=0.9)
    x, z = X0.copy(), Z0.copy()
    traj = []
    for t in range(steps):
        try:
            u_o = np.asarray(oracle.solve(x, z, xRef=XREF, tol=1e-9, max_iter=300))
        except RuntimeError:        # a first solve the oracle declares infeasible
            u_o = None
        sol = oracle.solution
        if sol.status != "optimal" or u_o is None:
            u_o = _take_last_iterate(oracle)
            out(f"  (oracle non-optimal at step {t}: {sol.status} "
                f"gap {float(getattr(sol, 'gap', np.nan)):.2e})")
        traj.append((x.copy(), z.copy(), u_o.copy()))
        x = _f(x, u_o)
        z = _f(z, np.array([0.0, -cons.Kpsi * z[3]]))
    return traj


def warm_steps(traj, iters, gondzio, dtype, device, N=8, NB=2):
    """The port's warm-started controller along ``traj``: its applied
    inputs and gaps by step."""
    _, pset, model, params = overtake_setup(N, NB)
    mpc = BranchMPCCVaR(params, model, pset.params, ralpha=0.9,
                        ipm=CVaRIPMConfig(iters=iters, gondzio=gondzio), dtype=dtype,
                        device=device)
    us, gaps = [], []
    for x, z, _ in traj:
        us.append(np.asarray(mpc.solve(x, z, xRef=XREF), np.float64).copy())
        gaps.append(float(mpc.last.gap))
    return np.asarray(us), np.asarray(gaps)


def study(steps, iter_list, gondzio, dtype, device, N=8, NB=2, out=print):
    """The reference script's lines; returns ``{iters: per-step errors}``."""
    traj = oracle_trajectory(steps, N, NB, out)
    u_o = np.asarray([u for _, _, u in traj])
    table = {}
    for iters in iter_list:
        u, _ = warm_steps(traj, iters, gondzio, dtype, device, N, NB)
        errs = np.abs(u - u_o).max(axis=1)
        table[iters] = errs
        out(f"iters {iters:3d} gondzio {gondzio}  per-step err "
            + " ".join(f"{e:.2e}" for e in errs) + f"   max {errs.max():.3e}")
        sys.stdout.flush()
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    env = os.environ.get
    dtype = {"f32": torch.float32, "f64": torch.float64}[env("CVAR_DTYPE", "f64")]
    study(int(env("STEPS", "8")), [int(v) for v in env("CVAR_ITER_LIST", "12,16,20,28,40").split(",")],
          int(env("CVAR_GONDZIO", "0")), dtype, args.device, int(env("CVAR_N", "8")),
          int(env("CVAR_NB", "2")))


if __name__ == "__main__":
    main()
