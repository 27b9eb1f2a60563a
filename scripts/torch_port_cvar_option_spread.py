"""How far rounding moves the first 10 iterations of ``cvar_ipm_solve`` on
the hard cold-start batch, by tree and option: the spread that
``chip_smoke.cvar_diag_options`` (card against CPU, 1e-10 of each field's
magnitude) has to stay under, measured on one device.

The overtake trees (N=8, NB=2) of ``torch_port_cvar_f32_diag.py``'s hard
batch (B=32, seed 0) are built in f64; each option of
``chip_smoke.DIAG_OPTIONS`` (with ``diag_extra`` on, so that every
diagnostic is compared) solves them as built and with every tree array
scaled by 1 + e, e in (2.2e-16, -2.2e-16, 4.4e-16). Per tree, the largest
|Δ| of any field (gaps, u, x, every diagnostic) over the field's magnitude
on the batch. Prints each tree's worst over the options and changes, the
eight trees that move least, and the worst of ``chip_smoke.DIAG_TREES``.

    python scripts/torch_port_cvar_option_spread.py [--device cuda|cpu]
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from belief_planning_tpu_torch.models.policies import cast_params  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve  # noqa
from belief_planning_tpu_torch.tree.engine import build_tree  # noqa: E402
from belief_planning_tpu_torch.tree.topology import build_topology  # noqa: E402
from belief_planning_tpu_torch.utils.device import resolve_device  # noqa: E402

CHANGES = (2.2e-16, -2.2e-16, 4.4e-16)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    diag = cs.load_script("torch_port_cvar_f32_diag")
    f64 = torch.float64
    _, pset, model, params = diag.overtake_setup()
    topo = build_topology(params.N, params.NB, model.m, params.n, params.d)
    cplan = build_cvar_plan(topo)
    B = 32
    xs, zs = (torch.as_tensor(a, dtype=f64, device=dev) for a in diag.hard_batch(B))
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, params.d, dtype=f64,
                                                     device=dev),
                    cast_params(pset.params, f64, dev))
    xRef = torch.as_tensor(diag.XREF, dtype=f64, device=dev)
    p = params

    def fields(tree, opts):
        x, u, _, _, aux = cvar_ipm_solve(cplan, tree, p.Q, p.R, p.Qslack, xRef, 0.9, p.Fx, p.bx,
                                         p.Fu, p.bu, xs, device=dev,
                                         cfg=CVaRIPMConfig(iters=10, **{**opts, "diag_extra": True}))
        return [aux["gaps"], u, x] + [aux["diag"][k] for k in sorted(aux["diag"])]

    worst = np.zeros(B)
    for opts in cs.DIAG_OPTIONS.values():
        base = fields(ts, opts)
        for e in CHANGES:
            moved = fields(type(ts)(*(a * (1 + e) if a.is_floating_point() else a for a in ts)),
                           opts)
            for a, b in zip(base, moved):
                mag = max(a.abs().max().item(), 1e-300)
                d = torch.nan_to_num((a - b).abs(), nan=float("inf")).reshape(B, -1).amax(1)
                worst = np.maximum(worst, (d / mag).cpu().numpy())
    order = np.argsort(worst)
    print(json.dumps({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "worst_by_tree": worst.tolist(), "least_moving_8": order[:8].tolist(),
                      "least_moving_8_worst": float(worst[order[:8]].max()),
                      "diag_trees": list(cs.DIAG_TREES),
                      "diag_trees_worst": float(worst[list(cs.DIAG_TREES)].max())}))


if __name__ == "__main__":
    main()
