"""How far the independent IPM solvers are reproducible, in the reference
itself and at the card's pin sizes, on the CPU in f64. Prints JSON lines.

    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py cvar
    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py qp_pin 1024 8 14 20 30 45
    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py cvar_pin 256 60
    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py cvar_study 10 12
    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py overtake_forced 4
    JAX_PLATFORMS=cpu python scripts/torch_port_ipm_chaos.py overtake_oracle port 44

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
- ``cvar_study iters...``: the CVaR study test's first program
  (``tests/test_torch_study_scripts.py``: the overtake at N=4, NB=1, the
  cold step of ``torch_port_cvar_iter_study.py``'s trajectory) through the
  JAX package's ``BranchMPCCVaR`` with the start's speed moved by -2.2e-16,
  2.2e-16 and 4.4e-16 relative, for each iteration count: the largest
  relative change of the gap and |Δu|.
- ``overtake_forced steps``: the overtake CVaR gate's first teacher-forced
  programs (``tests/test_torch_reference_scale.py::
  test_overtake_reference_scale_cvar``: the oracle's closed loop on the
  port's model, each step's program its state and its previous solution)
  through both packages' ``BranchMPCCVaR`` at the gate's IPM-100 + 2 with
  the 60-iteration restart: each engine's |Δu0| from the oracle, its gap,
  and the engines' |Δu0|.
- ``overtake_oracle jax|port steps``: the overtake CVaR gate's oracle alone
  (tol 1e-9, 300 iterations), in its own closed loop, which no engine
  drives, with its model calls answered by the JAX package's model
  (``OracleModelAdapter``, as the JAX gate runs it) or by the port's
  (``PortModelAdapter``, as the port's gate runs it). Every call is also
  put to the other model (``TwinAdapter``): per step the oracle's status,
  tier and iterations, the largest relative difference of the two models'
  answers, and, on a step where the oracle fails or its dense LU meets a
  non-finite entry (the loop then stops), the same program solved from the
  same oracle state on the other model. Run it under the same ``THREADS``,
  ``OMP_NUM_THREADS`` and ``OPENBLAS_NUM_THREADS`` for both models, and
  again under another setting, to see whether the failed steps move with
  the model or with the threads.
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


def cvar_study_spread(iter_counts):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from belief_planning_tpu.controllers.cvar_mpc import BranchMPCCVaR
    from belief_planning_tpu.models.policies import highway_policy_set
    from belief_planning_tpu.models.predictive import highway_model
    from belief_planning_tpu.presets import init_branch_mpc
    from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig
    from belief_planning_tpu.utils.config import BranchConstants

    cons = BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                           J_c=20, s_c=1, ylb=0.0, yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xt)
    model = highway_model(cons, pset, N=4, dt=0.1)
    params = init_branch_mpc(4, 2, 4, 1, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    z, xr = np.array([9.0, 1.8, 17.0, 0.0]), np.array([0.0, 1.8, 18.0, 0.0])
    for iters in iter_counts:
        mpc = BranchMPCCVaR(params, model, pset.params, ralpha=0.9,
                            ipm=CVaRIPMConfig(iters=iters), dtype=jnp.float64)
        init, runs = mpc.carry, []
        for eps in (0.0, -2.2e-16, 2.2e-16, 4.4e-16):
            mpc.carry = init
            u = np.asarray(mpc.solve(np.array([0.0, 1.8, 20.0 * (1 + eps), 0.0]), z, xRef=xr))
            runs.append((u, float(np.asarray(mpc.last.gap).ravel()[0])))
        (u0, g0), rest = runs[0], runs[1:]
        print(json.dumps({"iters": iters, "gaps": [g for _, g in runs],
                          "gap_rel_max": max(abs(g / g0 - 1) for _, g in rest),
                          "du_max": max(float(np.abs(u - u0).max()) for u, _ in rest)}),
              flush=True)


def overtake_forced(steps):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import tests.test_torch_reference_scale as T
    from belief_planning_tpu.controllers.cvar_mpc import BranchMPCCVaR as JBranchMPCCVaR
    from belief_planning_tpu.oracle.reference_cvar import OracleCVaRController
    from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
    from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
    from tests.test_reference_scale import _oracle_tree_p, overtake_demo_setup

    cons, pset, model, params = T.overtake_demo_setup()
    _, jpset, jmodel, jparams = overtake_demo_setup()
    oracle = OracleCVaRController(params, T.PortModelAdapter(model, pset.params), ralpha=0.9)
    mpc = BranchMPCCVaR(params, model, pset.params, ralpha=0.9,
                        ipm=CVaRIPMConfig(iters=100, gondzio=2), restart=60, dtype=f64,
                        device="cpu")
    jmpc = JBranchMPCCVaR(jparams, jmodel, jpset.params, ralpha=0.9,
                          ipm=JCVaRIPMConfig(iters=100, gondzio=2), restart=60,
                          dtype=jnp.float64)
    step = lambda s, u: s + np.array([s[2] * np.cos(s[3]), s[2] * np.sin(s[3]), u[0], u[1]]) * 0.1
    x, z = np.array([0.0, 1.8, 20.0, 0.0]), np.array([9.0, 1.8, 17.0, 0.0])
    for t in range(steps):
        if oracle.uPred is not None:
            prev = (np.asarray(oracle.uPred).copy(), _oracle_tree_p(oracle, mpc.topo.m),
                    np.asarray(oracle.OldInput).copy())
            tt = lambda a: torch.as_tensor(a, dtype=f64)[None]
            mpc.carry = mpc.carry._replace(u_lin=tt(prev[0]), p=tt(prev[1]),
                                           old_input=tt(prev[2]))
            jmpc.carry = jmpc.carry._replace(u_lin=jnp.asarray(prev[0]),
                                             p=jnp.asarray(prev[1]),
                                             old_input=jnp.asarray(prev[2]))
        u_o = oracle.solve(x, z, params.xRef, tol=1e-9, max_iter=300)
        u_p = np.asarray(mpc.solve(x, z, params.xRef))
        u_j = np.asarray(jmpc.solve(x, z, params.xRef))
        print(json.dumps({"step": t, "oracle": oracle.solution.status,
                          "port_du0": float(np.abs(u_p - u_o).max()),
                          "port_gap": float(mpc.last.gap),
                          "jax_du0": float(np.abs(u_j - u_o).max()),
                          "jax_gap": float(np.asarray(jmpc.last.gap).ravel()[0]),
                          "port_vs_jax_du0": float(np.abs(u_p - u_j).max())}), flush=True)
        x, z = step(x, u_o), step(z, np.array([0.0, -cons.Kpsi * z[3]]))


class TwinAdapter:
    """An oracle model adapter that answers from ``primary`` and also asks
    ``twin`` the same call: ``worst`` keeps the largest difference of the
    answers since it was last reset, relative to max(1, |twin's answer|),
    and ``finite`` whether every answer was finite."""

    def __init__(self, primary, twin):
        self.primary, self.twin = primary, twin
        self.n, self.d, self.N, self.m, self.dt = (primary.n, primary.d, primary.N, primary.m,
                                                   primary.dt)
        self.worst, self.finite = 0.0, True

    def _both(self, name, *args):
        a = getattr(self.primary, name)(*args)
        b = getattr(self.twin, name)(*args)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            self.finite &= bool(np.isfinite(x).all() and np.isfinite(y).all())
            d = np.abs(x - y) / np.maximum(1.0, np.abs(y))
            self.worst = max(self.worst, float(np.nanmax(d)) if d.size else 0.0)
        return a

    def dyn_linearization(self, x, u):
        return self._both("dyn_linearization", x, u)

    def branch_eval(self, x, z):
        return self._both("branch_eval", x, z)

    def zpred_eval(self, z):
        return self._both("zpred_eval", z)

    def col_eval(self, x, z):
        return self._both("col_eval", x, z)


def overtake_oracle(which, steps):
    import copy

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import tests.test_reference_scale as J
    import tests.test_torch_reference_scale as T
    from belief_planning_tpu.oracle.reference_cvar import OracleCVaRController

    jcons, jpset, jmodel, _ = J.overtake_demo_setup()
    cons, pset, model, params = T.overtake_demo_setup()
    adapters = {"jax": J.OracleModelAdapter(jmodel, jpset.params),
                "port": T.PortModelAdapter(model, pset.params)}
    other = "port" if which == "jax" else "jax"
    twin = TwinAdapter(adapters[which], adapters[other])
    oracle = OracleCVaRController(params, twin, ralpha=0.9)
    step = lambda s, u: s + np.array([s[2] * np.cos(s[3]), s[2] * np.sin(s[3]), u[0], u[1]]) * 0.1
    x, z = np.array([0.0, 1.8, 20.0, 0.0]), np.array([9.0, 1.8, 17.0, 0.0])
    failed = []

    def solve(o):
        try:
            u = o.solve(x, z, params.xRef, tol=1e-9, max_iter=300)
            return u, o.quality, o.solution.status
        except ValueError as e:      # the dense LU met a non-finite entry
            return None, "crashed", str(e)

    for t in range(steps):
        before = copy.deepcopy(oracle)
        twin.worst, twin.finite = 0.0, True
        u, tier, status = solve(oracle)
        rec = {"step": t, "model": which, "status": status, "tier": tier,
               "model_diff": twin.worst, "models_finite": twin.finite, "x": x.tolist()}
        if tier != "crashed":
            rec.update(iterations=int(oracle.solution.iterations),
                       prim_res=float(oracle.solution.prim_res))
        if tier in ("failed", "crashed"):
            # the same program, from the same oracle state, on the other model
            failed.append(t)
            before.model = adapters[other]
            _, o_tier, o_status = solve(before)
            rec["other_model"] = {"model": other, "tier": o_tier, "status": o_status}
        print(json.dumps(rec), flush=True)
        if u is None:
            break
        x, z = step(x, u), step(z, np.array([0.0, -cons.Kpsi * z[3]]))
    print(json.dumps({"model": which, "steps": steps, "failed_or_crashed": failed,
                      "threads": [os.environ.get(k) for k in
                                  ("THREADS", "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS")]}))


def main():
    torch.set_num_threads(int(os.environ.get("THREADS", "4")))
    if sys.argv[1] == "overtake_oracle":
        return overtake_oracle(sys.argv[2], int(sys.argv[3]))
    mode, rest = sys.argv[1], [int(a) for a in sys.argv[2:]]
    if mode == "cvar":
        cvar_reference_spread()
    elif mode == "qp_pin":
        qp_pin(rest[0], rest[1:])
    elif mode == "cvar_pin":
        cvar_pin(rest[0], rest[1])
    elif mode == "cvar_study":
        cvar_study_spread(rest)
    elif mode == "overtake_forced":
        overtake_forced(rest[0])
    else:
        raise SystemExit(f"unknown mode {mode!r}: cvar | qp_pin B iters... | cvar_pin B iters"
                         " | cvar_study iters... | overtake_forced steps"
                         " | overtake_oracle jax|port steps")


if __name__ == "__main__":
    main()
