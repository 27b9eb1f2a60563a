"""Solution quality on the hard cold-start batch: the port's CVaR IPM
against the f64 oracle, the port's counterpart of
``scripts/cvar_hard_oracle.py``.

For each lane of the hard batch (``torch_port_cvar_f32_diag.py``'s, numpy
seed 0) the dense f64 oracle (``belief_planning_tpu.oracle.reference_cvar.
OracleCVaRController``, NumPy and SciPy only: the reference's QCQP assembly
and a reference-grade IPM) solves the tree, its model calls computed by the
port's model in f64 on the CPU (``PortModelAdapter``), and the port's
one-tree controller ``BranchMPCCVaR`` (the per-tree ``cvar_ipm_solve``,
ralpha 0.9) solves it on ``--device``. Prints each lane's u0 error with the
oracle's status and gap, then the p50, p90 and max of the error.

    python scripts/torch_port_cvar_hard_oracle.py [--device cuda|cpu]

``--device`` defaults to the CUDA card. Env, as the reference script's:
CVAR_B (16), CVAR_ITERS (40), CVAR_GONDZIO (0), CVAR_SPLIT (0), CVAR_NBR
(0), CVAR_DTYPE (f64), ORACLE_ITERS (300); and CVAR_N, CVAR_NB (the tree's
N and NB, 8 and 2 as the reference's; smaller for a quick run).
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
from belief_planning_tpu.oracle.reference_tree import OracleModelAdapter  # noqa: E402

from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from torch_port_cvar_f32_diag import XREF, hard_batch, overtake_setup  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64)


class PortModelAdapter(OracleModelAdapter):
    """The oracle's numpy-in, numpy-out model calls, computed by the port's
    model in f64 on the CPU."""

    def dyn_linearization(self, x, u):
        return tuple(a.numpy() for a in self.model.linearize(_t(x), _t(u)))

    def branch_eval(self, x, z):
        return tuple(a.numpy() for a in self.model.branch_eval(_t(x), _t(z),
                                                               self.policy_params))

    def zpred_eval(self, z):
        zp = self.model.zpred(_t(z), self.policy_params).numpy()
        return np.concatenate([zp[i] for i in range(self.m)], axis=1)

    def col_eval(self, x, z):
        h, dh = (a.numpy() for a in self.model.col_raw(_t(x), _t(z)))
        return h - dh @ np.asarray(x, np.float64), dh


def oracle_u0(params, adapter, x, z, max_iter):
    """The oracle's applied input on one tree, with its status and gap (its
    last iterate where it declares the tree infeasible: on a first solve the
    oracle then raises, having kept that iterate as its ``solution``)."""
    oracle = OracleCVaRController(params, adapter, ralpha=0.9)
    try:
        u_o = np.asarray(oracle.solve(x, z, xRef=XREF, tol=1e-9, max_iter=max_iter))
        return u_o, oracle.solution.status, oracle.solution.gap
    except (TypeError, RuntimeError):
        sol = oracle.solution
        # the cone-ADMM fallback's solution has residuals and no gap
        return (sol.v[oracle.totalx * 4: oracle.totalx * 4 + 2], sol.status,
                getattr(sol, "gap", float("nan")))


def u0_errors(B, ipm, dtype, device, oracle_iters, N=8, NB=2, out=print):
    """Each lane's |u0 − u0_oracle| (max over the input's components)."""
    _, pset, model, params = overtake_setup(N, NB)
    adapter = PortModelAdapter(model, pset.params)
    xs, zs = hard_batch(B)
    errs = []
    for i in range(B):
        u_o, st, gap_o = oracle_u0(params, adapter, xs[i], zs[i], oracle_iters)
        mpc = BranchMPCCVaR(params, model, pset.params, ralpha=0.9, ipm=ipm, dtype=dtype,
                            device=device)
        u_p = np.asarray(mpc.solve(xs[i], zs[i], xRef=XREF), np.float64)
        e = float(np.abs(u_p - np.asarray(u_o)).max())
        errs.append(e)
        out(f"lane {i:2d}  u0_err {e:10.3e}  oracle[{st} gap {gap_o:.2e}] "
            f"u_o {np.asarray(u_o)}  u_port {u_p}")
    return np.asarray(errs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    env = os.environ.get
    B = int(env("CVAR_B", "16"))
    iters = int(env("CVAR_ITERS", "40"))
    dtype = {"f32": torch.float32, "f64": torch.float64}[env("CVAR_DTYPE", "f64")]
    ipm = CVaRIPMConfig(iters=iters, gondzio=int(env("CVAR_GONDZIO", "0")),
                        split_step=env("CVAR_SPLIT", "0") == "1",
                        neighborhood=float(env("CVAR_NBR", "0")))
    err = u0_errors(B, ipm, dtype, args.device, int(env("ORACLE_ITERS", "300")),
                    int(env("CVAR_N", "8")), int(env("CVAR_NB", "2")))
    print(f"\nB={B} iters={iters} gondzio={ipm.gondzio} split={ipm.split_step} "
          f"nbr={ipm.neighborhood} dtype={dtype}")
    print(f"u0 err: p50 {np.percentile(err, 50):.3e}  p90 {np.percentile(err, 90):.3e}  "
          f"max {err.max():.3e}")


if __name__ == "__main__":
    main()
