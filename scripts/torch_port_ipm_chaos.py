"""How far the independent IPM solvers are reproducible, in the reference
itself and at the card's pin sizes, on the CPU in f64. Prints JSON lines.

    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py cvar
    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py qp_pin 1024 8 14 20 30 45
    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py cvar_pin 256 60

- ``cvar``: the CPU test's CVaR cases (``tests/test_torch_cvar_ipm.py``: the
  overtake, N=3, NB=1, 3 trees; IPM-10, and IPM-9 with 2 Gondzio
  correctors) through the JAX package's vmapped ``cvar_ipm_solve`` jitted
  and eagerly and through the port: the gap's relative difference per
  iteration and the largest |Δu| of the root input, for each pair.
- ``qp_pin B iters...``: the card's QP pin on the CPU, the port's fused
  batched step (plain version of K1's iteration) against its per-tree step
  at the bench config, two warm-carried steps of B trees, for each IPM
  iteration count (``GONDZIO`` env, default 2, correctors): the largest
  |Δu| and |Δx| per step and the trees above 1e-7 with their gaps.
- ``cvar_pin B iters``: the card's CVaR pin on the CPU, the port's fused
  CVaR solve against ``cvar_ipm_solve`` on both configurations: the first
  10 gaps' relative difference and the largest root |Δu|.
"""

import json
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

f64 = torch.float64


def cvar_reference_spread():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import tests.test_torch_cvar_ipm as T

    pb = T._problem("overtake")
    rel = lambda a, b: (np.abs(a - b) / np.abs(b)).max(0).tolist()
    for opts, iters in (({}, 10), (dict(gondzio=2), 9), (dict(gondzio=2), 10)):
        jit = T._jax_solve(pb, opts, iters, f64)
        with jax.disable_jit():        # the same vmapped solve, eagerly
            eager = T._jax_solve(pb, opts, iters, f64)
        port = T._port_solve(pb, opts, iters, f64)
        g = {"jit": jit[4]["gaps"], "eager": eager[4]["gaps"], "port": port[4]["gaps"].numpy()}
        u0 = {"jit": jit[1][:, 0], "eager": eager[1][:, 0], "port": port[1].numpy()[:, 0]}
        pairs = (("eager", "jit"), ("port", "jit"), ("port", "eager"))
        print(json.dumps({"case": opts, "iters": iters,
                          "gap_rel_per_iter": {f"{a}_vs_{b}": rel(g[a], g[b]) for a, b in pairs},
                          "root_du": {f"{a}_vs_{b}": float(np.abs(u0[a] - u0[b]).max())
                                      for a, b in pairs}}), flush=True)


def qp_pin(B, iter_counts):
    import chip_smoke as cs
    from belief_planning_tpu_torch.controllers.branch_mpc import (
        make_branch_mpc_batched_step,
        make_branch_mpc_step,
    )
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    pset, model, params = cs.overtake_setup()
    xs, zs, xr = (torch.as_tensor(a, dtype=f64) for a in cs.bench_states(B))
    for iters in iter_counts:
        ipm = QPIPMConfig(iters=iters, gondzio=int(os.environ.get("GONDZIO", "2")))
        runs = []
        for make in (make_branch_mpc_step, make_branch_mpc_batched_step):
            _, init, step = make(model, params, "prox", ipm=ipm, device="cpu")
            c, seq = init(B, f64), []
            for _ in range(2):
                c, r = step(c, xs, zs, xr, pset.params)
                seq.append(r)
            runs.append(seq)
        for k, (a, b) in enumerate(zip(*runs)):
            du = (a.uPred - b.uPred).abs().amax((1, 2))
            bad = torch.nonzero(du > 1e-7).flatten().tolist()
            print(json.dumps({"B": B, "iters": iters, "gondzio": ipm.gondzio, "step": k,
                              "max_abs_du": du.max().item(),
                              "max_abs_dx": (a.xPred - b.xPred).abs().max().item(),
                              "trees_du_over_1e-7": {i: [a.gap[i].item(), b.gap[i].item()]
                                                     for i in bad}}), flush=True)


def cvar_pin(B, iters):
    import chip_smoke as cs
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve
    from belief_planning_tpu_torch.solvers.cvar_pl import cvar_ipm_solve_pl
    from belief_planning_tpu_torch.solvers.layout import _from_bl, _to_bl
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology

    cfg = CVaRIPMConfig(iters=iters)
    cpu = torch.device("cpu")
    for name in cs.CVAR_CONFIGS:
        model, p, pset, _, ralpha, use_S = cs.cvar_config(name)
        tp = build_topology(p.N, p.NB, model.m, 4, 2)
        cplan = build_cvar_plan(tp)
        xs, zs, xRefs, S, bx = cs.cvar_states(name, B, cpu, f64)
        ts = build_tree(model, tp, xs, zs, torch.zeros(B, tp.totalu, 2, dtype=f64),
                        cast_params(pset.params, f64, cpu))
        floor = (torch.arange(B) % 2 == 0) if use_S else None
        _, u, _, _, aux = cvar_ipm_solve(cplan, ts, p.Q, p.R, p.Qslack, xRefs, ralpha, p.Fx,
                                         p.bx if bx is None else bx, p.Fu, p.bu, xs, S=S,
                                         cfg=cfg, dh0_floor=floor, device="cpu")
        bl = lambda a: None if a is None else _to_bl(a)
        _, u_bl, _, _, aux_pl = cvar_ipm_solve_pl(
            cplan, bl(ts.A), bl(ts.Bm), bl(ts.dh), bl(ts.h0), bl(ts.x_lin), bl(ts.u_lin),
            bl(ts.p), p.Q, p.R, p.Qslack, bl(xRefs), ralpha, p.Fx,
            p.bx if bx is None else bl(bx), p.Fu, p.bu, cfg=cfg, S_bl=bl(S), dh0_floor=floor)
        g, gp = aux["gaps"][:, :10], aux_pl["gaps"].T[:, :10]
        print(json.dumps({"config": name, "B": B, "iters": iters,
                          "gaps_first10_max_rel": ((g - gp).abs() / gp.abs()).amax(0).tolist(),
                          "root_du": (u[:, 0] - _from_bl(u_bl)[:, 0]).abs().max().item()}),
              flush=True)


def main():
    torch.set_num_threads(int(os.environ.get("THREADS", "4")))
    mode, rest = sys.argv[1], [int(a) for a in sys.argv[2:]]
    if mode == "cvar":
        cvar_reference_spread()
    elif mode == "qp_pin":
        qp_pin(rest[0], rest[1:])
    elif mode == "cvar_pin":
        cvar_pin(rest[0], rest[1])
    else:
        raise SystemExit(f"unknown mode {mode!r}: cvar | qp_pin B iters... | cvar_pin B iters")


if __name__ == "__main__":
    main()
