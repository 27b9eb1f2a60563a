"""CVaR IPM convergence in f32 with and without iterative refinement: the
port's counterpart of ``scripts/cvar_f32_study.py``.

Runs a cold, then one warm, step of the per-tree CVaR controller step
(``make_cvar_mpc_step``: ``cvar_ipm_solve`` batched over the trees, ralpha
0.9) on the hard cold-start batch (B lanes of ``torch_port_cvar_f32_diag.
hard_batch``, numpy seed 0) of the CVaR overtake (N=8, NB=2), prints the
gap percentiles of both steps and writes ``u_cold``, ``gap_cold``,
``u_warm``, ``gap_warm`` to an ``.npz``. With several refinement counts in
CVAR_REFINE it runs each in turn, one file each.

    python scripts/torch_port_cvar_f32_study.py [--device cuda|cpu]

``--device`` defaults to the CUDA card. Env, as the reference script's:
CVAR_DTYPE (f32 | f64), CVAR_REFINE (1; a comma list runs each), CVAR_ITERS
(40), CVAR_B (256), CVAR_OUT (default ``torch_port_cvar_study_<tag>.npz``
in the temporary directory, ``$TMPDIR`` or ``/tmp``; with several
refinement counts ``<tag>`` is appended to it); and CVAR_N, CVAR_NB (the
tree, 8 and 2 as the reference's; smaller for a quick run).
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_step  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from belief_planning_tpu_torch.utils.device import resolve_device  # noqa: E402
from torch_port_cvar_f32_diag import XREF, hard_batch, overtake_setup  # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cold_warm(B, iters, refine, dtype, device, N=8, NB=2):
    """One cold and one warm step of the hard batch: ``(u_cold, gap_cold,
    u_warm, gap_warm, seconds of the cold step)``, numpy."""
    dev = resolve_device(device)
    _, pset, model, params = overtake_setup(N, NB)
    _, _, init_carry, step = make_cvar_mpc_step(model, params, ralpha=0.9,
                                                ipm=CVaRIPMConfig(iters=iters, refine=refine),
                                                device=dev)
    xs, zs = (torch.as_tensor(a, dtype=dtype, device=dev) for a in hard_batch(B))
    xRefs = torch.as_tensor(np.tile(XREF, (B, 1)), dtype=dtype, device=dev)
    t0 = time.perf_counter()
    carrys, res = step(init_carry(B, dtype), xs, zs, xRefs, pset.params)
    u_cold, gap_cold = res.uPred.double().cpu().numpy(), res.gap.double().cpu().numpy()
    _sync(dev)
    t_cold = time.perf_counter() - t0
    _, res2 = step(carrys, xs, zs, xRefs, pset.params)
    return (u_cold, gap_cold, res2.uPred.double().cpu().numpy(),
            res2.gap.double().cpu().numpy(), t_cold)


def stats(g):
    g = np.asarray(g, np.float64)
    return (f"finite {np.isfinite(g).mean() * 100:.1f}% p50 {np.nanpercentile(g, 50):.3g} "
            f"p90 {np.nanpercentile(g, 90):.3g} p99 {np.nanpercentile(g, 99):.3g} "
            f"max {np.nanmax(g):.3g}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    env = os.environ.get
    dname = env("CVAR_DTYPE", "f32")
    dtype = {"f32": torch.float32, "f64": torch.float64}[dname]
    refines = [int(v) for v in env("CVAR_REFINE", "1").split(",")]
    iters, B = int(env("CVAR_ITERS", "40")), int(env("CVAR_B", "256"))
    N, NB = int(env("CVAR_N", "8")), int(env("CVAR_NB", "2"))
    for refine in refines:
        u_cold, gap_cold, u_warm, gap_warm, t_cold = cold_warm(B, iters, refine, dtype, dev, N,
                                                               NB)
        tag = f"{dev.type}_{dname}_r{refine}_i{iters}"
        out = env("CVAR_OUT")
        out = (os.path.join(tempfile.gettempdir(), f"torch_port_cvar_study_{tag}.npz")
               if out is None
               else out if len(refines) == 1 else f"{out.removesuffix('.npz')}_{tag}.npz")
        np.savez(out, u_cold=u_cold, gap_cold=gap_cold, u_warm=u_warm, gap_warm=gap_warm)
        print(f"tag={tag} B={B} cold {t_cold:.1f}s")
        print("gap cold:", stats(gap_cold))
        print("gap warm:", stats(gap_warm))
        print("wrote", out)


if __name__ == "__main__":
    main()
