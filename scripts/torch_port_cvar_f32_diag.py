"""Per-iteration CVaR IPM diagnostics on the hard cold-start batch: the
port's counterpart of ``scripts/cvar_f32_diag.py``.

Builds the overtake trees (N=8, NB=2, m=3, ralpha 0.9) of the hard batch
(B lanes drawn from numpy seed 0, the obstacle 12 m ahead) in the solve
dtype and runs ``solvers/cvar_ipm.cvar_ipm_solve`` on them, batched over
the trees, once for each refinement count; prints each run's final gap p50
and max, whether u is finite, and every second iteration's medians over the
lanes of gap, a, a_aff, sigma, wmax, prim1 and rq (with CVAR_FAMDIAG=1 also
the per-family step limits, the centrality spread, the non-finite masks,
the slack and multiplier extremes and the factor health).

    python scripts/torch_port_cvar_f32_diag.py [--device cuda|cpu]

``--device`` defaults to the CUDA card. Env, as the reference script's:
CVAR_DTYPE (f32 | f64), CVAR_ITERS (40), CVAR_B (32), CVAR_QUIRKS (1),
CVAR_REFINES (0,1,2), CVAR_REFINE_DTYPE, CVAR_OUTER_DTYPE, CVAR_WMAX,
CVAR_WMAX32, CVAR_RESID, CVAR_RECOVERY, CVAR_GONDZIO, CVAR_SPLIT,
CVAR_RECENTER, CVAR_NBR, CVAR_FAMDIAG; and CVAR_N, CVAR_NB (the tree's
N and NB, 8 and 2 as the reference's; smaller for a quick run).
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from belief_planning_tpu_torch.models.policies import cast_params, highway_policy_set  # noqa: E402
from belief_planning_tpu_torch.models.predictive import highway_model  # noqa: E402
from belief_planning_tpu_torch.presets import init_branch_mpc  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve  # noqa: E402
from belief_planning_tpu_torch.tree.engine import build_tree  # noqa: E402
from belief_planning_tpu_torch.tree.topology import build_topology  # noqa: E402
from belief_planning_tpu_torch.utils.config import BranchConstants  # noqa: E402
from belief_planning_tpu_torch.utils.device import resolve_device  # noqa: E402

XREF = np.array([0.0, 1.8, 18.0, 0.0])
KEYS = ["gap", "a", "a_aff", "sigma", "wmax", "prim1", "rq"]
FAMILY_KEYS = ["a1s", "a1l", "a2s", "a2l", "a3s", "a3l", "a4s", "a4l", "aqs", "aql", "cmin",
               "cmax"]


def overtake_setup(N=8, NB=2):
    """The CVaR overtake of the reference scripts: ``(cons, pset, model, params)``."""
    cons = BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                           J_c=20, s_c=1, ylb=0.0, yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xt)
    model = highway_model(cons, pset, N=N, dt=0.1)
    params = init_branch_mpc(4, 2, N, NB, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    return cons, pset, model, params


def hard_batch(B, seed=0):
    """The hard cold-start batch: ``(xs, zs)`` as numpy ``(B, 4)``."""
    rng = np.random.default_rng(seed)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    xs[:, 1] = np.clip(xs[:, 1], 1.3, 13.1)
    xs[:, 3] = np.clip(xs[:, 3], -0.2, 0.2)
    zs = np.array([12.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.5, (B, 4))
    zs[:, 1] = np.clip(zs[:, 1], 1.3, 13.1)
    zs[:, 3] = np.clip(zs[:, 3], -0.2, 0.2)
    return xs, zs


def config_from_env(iters, refine):
    """The solve's config from the reference script's environment variables."""
    env = os.environ.get
    return CVaRIPMConfig(iters=iters, refine=refine, refine_dtype=env("CVAR_REFINE_DTYPE", "same"),
                         outer_dtype=env("CVAR_OUTER_DTYPE", "same"),
                         w_max=float(env("CVAR_WMAX", "1e12")),
                         w_max_f32=float(env("CVAR_WMAX32", "1e6")),
                         resid=env("CVAR_RESID", "recompute"),
                         recovery=env("CVAR_RECOVERY", "direct"),
                         gondzio=int(env("CVAR_GONDZIO", "0")),
                         split_step=env("CVAR_SPLIT", "0") == "1",
                         recenter=int(env("CVAR_RECENTER", "0")),
                         neighborhood=float(env("CVAR_NBR", "0")),
                         diag_extra=env("CVAR_FAMDIAG", "0") == "1")


def hard_batch_trees(B, dtype, device, quirks=True, N=8, NB=2):
    """The hard batch's trees built in ``dtype`` on ``device``; returns
    ``solve(cfg) -> (diag, u, aux)``, ``diag`` a dict of numpy ``(B, iters)``
    arrays."""
    dev = resolve_device(device)
    _, pset, model, params = overtake_setup(N, NB)
    topo = build_topology(params.N, params.NB, model.m, params.n, params.d)
    cplan = build_cvar_plan(topo, replicate_quirks=quirks)
    xs, zs = (torch.as_tensor(a, dtype=dtype, device=dev) for a in hard_batch(B))
    ts = build_tree(model, topo, xs, zs,
                    torch.zeros(B, topo.totalu, params.d, dtype=dtype, device=dev),
                    cast_params(pset.params, dtype, dev))
    xRef = torch.as_tensor(XREF, dtype=dtype, device=dev)

    def solve(cfg):
        _, u, _, _, aux = cvar_ipm_solve(cplan, ts, params.Q, params.R, params.Qslack, xRef, 0.9,
                                         params.Fx, params.bx, params.Fu, params.bu, xs, cfg=cfg,
                                         device=dev)
        diag = {k: v.double().cpu().numpy() for k, v in aux["diag"].items()}
        return diag, u.double().cpu().numpy(), aux

    return solve


def report(diag, u, refine, iters, famdiag):
    """The reference script's lines for one run."""
    gaps = diag["gap"]
    print(f"refine={refine}  final gap p50 {np.percentile(gaps[:, -1], 50):.3g} "
          f"max {gaps[:, -1].max():.3g}  u finite {np.isfinite(u).all()}")
    extra = [k for k in FAMILY_KEYS if k in diag]
    for i in range(0, iters, 2):
        row = "  ".join(f"{k} {np.percentile(diag[k][:, i], 50):9.3g}" for k in KEYS)
        print(f"  it{i:3d}  {row}")
        if extra and famdiag:
            row2 = "  ".join(f"{k} {np.percentile(diag[k][:, i], 50):8.2g}" for k in extra)
            print(f"         {row2}")
            nf = diag["nfin"][:, i]
            more = "  ".join(f"{k} {np.min(diag[k][:, i]):.2g}" for k in ("finK", "finW", "finZ"))
            more2 = "  ".join(f"{k} {np.max(diag[k][:, i]):.2g}" for k in ("finF", "condW"))
            print(f"         nfin p50 {np.percentile(nf, 50):.0f} max {nf.max():.0f} "
                  f"frac {np.mean(nf > 0):.2f}  slmin {np.percentile(diag['slmin'][:, i], 0):.2g}  "
                  f"lmax {np.percentile(diag['lmax'][:, i], 100):.2g}  "
                  f"nfa_frac {np.mean(diag['nfa'][:, i] > 0):.2f}  {more}  {more2}")
    sys.stdout.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dtype = {"f32": torch.float32, "f64": torch.float64}[os.environ.get("CVAR_DTYPE", "f32")]
    iters = int(os.environ.get("CVAR_ITERS", "40"))
    B = int(os.environ.get("CVAR_B", "32"))
    quirks = os.environ.get("CVAR_QUIRKS", "1") == "1"
    famdiag = os.environ.get("CVAR_FAMDIAG", "0") == "1"
    solve = hard_batch_trees(B, dtype, args.device, quirks, int(os.environ.get("CVAR_N", "8")),
                             int(os.environ.get("CVAR_NB", "2")))
    for refine in (int(r) for r in os.environ.get("CVAR_REFINES", "0,1,2").split(",")):
        diag, u, _ = solve(config_from_env(iters, refine))
        report(diag, u, refine, iters, famdiag)


if __name__ == "__main__":
    main()
