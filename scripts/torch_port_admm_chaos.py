"""How far the cone-ADMM CVaR solve (``solvers/cvar.cvar_solve``) parts
between implementations that differ only in rounding, on the CPU in f64.

For each iteration count it runs the JAX package's solve jitted and eagerly
(``jax.vmap`` without ``jit``) and the port's (``device="cpu"``) on the same
trees, and prints one JSON line with, per field, max |a − b| / max |b| for
port vs jit, eager vs jit and port vs eager, and the absolute max |Δu| of
port vs jit and eager vs jit. Usage (from the repository root):

    python scripts/torch_port_admm_chaos.py [test|test_S|overtake|overtake_f32] [B] [iters ...]

``test``: the CPU test's problem (overtake tree N=3, NB=1, 2 trees, random
warm inputs, without S), the default; ``test_S``: the same with the test's
shared S and per-tree dh[0] floor; ``overtake``: ``chip_smoke.py``'s
``admm_vs_cpu`` problem (the CVaR overtake, N=8, NB=2, the bench's states,
cold ``u_lin``, S=None); ``overtake_f32``: that problem in f32 (tree built
in f64, then cast), JAX jitted and the port, printing for each iteration
count the lanes whose u is not finite and the median ``prim_res``. Needs JAX
(CPU) and the port.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

FIELDS = ["x", "u", "s", "t", "risk", "z4", "y4"]


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import torch

    from belief_planning_tpu.solvers.cvar import CVaRConfig, build_cvar_plan, cvar_solve
    from belief_planning_tpu.tree.engine import build_tree
    from belief_planning_tpu.tree.topology import build_topology
    from belief_planning_tpu_torch.convert import convert_cvar_config, convert_tree_state
    from belief_planning_tpu_torch.solvers import cvar as tcvar
    from belief_planning_tpu_torch.tree.topology import build_topology as t_build_topology
    from tests.test_tree_qp import overtake_setup

    torch.set_num_threads(4)
    kind = sys.argv[1] if len(sys.argv) > 1 else "test"
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    iter_list = [int(a) for a in sys.argv[3:]] or [0, 1, 2, 3, 5, 10, 30]
    N, NB = (3, 1) if kind.startswith("test") else (8, 2)
    if kind not in ("test", "test_S", "overtake", "overtake_f32"):
        raise SystemExit(f"unknown problem {kind!r}")
    cons, pset, model, params = overtake_setup(N=N, NB=NB)
    topo = build_topology(N, NB, model.m, 4, 2)
    S, floor = None, None
    if kind == "test_S":
        S = np.eye(4)
        S[1, 0] = -0.15
        floor = np.arange(B) % 2 == 0
    if kind.startswith("test"):
        rng = np.random.default_rng(41)
        xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
        zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.5, (B, 4))
        u_lin = rng.normal(0, [0.5, 0.05], (B, topo.totalu, 2))
        xRef = params.xRef
    else:
        from chip_smoke import bench_states
        xs, zs, xRefs = bench_states(B)
        u_lin = np.zeros((B, topo.totalu, 2))
        xRef = xRefs[0]
    cplan = build_cvar_plan(topo)
    tcplan = tcvar.build_cvar_plan(t_build_topology(N, NB, model.m, 4, 2))
    if kind == "overtake_f32":
        ts64 = jax.jit(jax.vmap(lambda x, z, ul: build_tree(model, topo, x, z, ul, pset.params)))(
            xs, zs, u_lin)
        ts32 = jax.tree.map(lambda a: jax.numpy.asarray(a, jax.numpy.float32), ts64)
        x32 = jax.numpy.asarray(xs, jax.numpy.float32)
        tts = convert_tree_state(ts64, "cpu", torch.float32)
        for iters in iter_list:
            cfg = CVaRConfig(rho4=10.0, rho5=10.0, rho_eq=10.0, rho_sign=10.0, iters=iters)
            _, ju, _, _, jaux = jax.jit(jax.vmap(lambda ts, x: cvar_solve(
                cplan, ts, params.Q, params.R, params.Qslack, xRef, 0.9, params.Fx, params.bx,
                params.Fu, params.bu, x, cfg=cfg)))(ts32, x32)
            _, tu, _, _, taux = tcvar.cvar_solve(
                tcplan, tts, params.Q, params.R, params.Qslack, xRef, 0.9, params.Fx, params.bx,
                params.Fu, params.bu, torch.as_tensor(xs, dtype=torch.float32),
                cfg=convert_cvar_config(cfg), device="cpu")
            ju = np.asarray(ju)
            print(json.dumps({
                "kind": kind, "B": B, "iters": iters, "dtype": str(ju.dtype),
                "jax_nonfinite_lanes": int((~np.isfinite(ju).reshape(B, -1).all(1)).sum()),
                "port_nonfinite_lanes": int((~torch.isfinite(tu).reshape(B, -1).all(1)).sum()),
                "jax_prim_res_p50": float(np.median(np.asarray(jaux["prim_res"]))),
                "port_prim_res_p50": float(taux["prim_res"].median())}), flush=True)
        return
    for iters in iter_list:
        cfg = CVaRConfig(rho4=10.0, rho5=10.0, rho_eq=10.0, rho_sign=10.0, iters=iters)

        def one(x, z, ul, fl):
            ts = build_tree(model, topo, x, z, ul, pset.params)
            _, _, _, st, _ = cvar_solve(cplan, ts, params.Q, params.R, params.Qslack, xRef, 0.9,
                                        params.Fx, params.bx, params.Fu, params.bu, x, S=S,
                                        cfg=cfg, dh0_floor=None if floor is None else fl)
            return ts, st

        fl = np.zeros(B, bool) if floor is None else floor
        ts, st_jit = jax.jit(jax.vmap(one))(xs, zs, u_lin, fl)
        _, st_eager = jax.vmap(one)(xs, zs, u_lin, fl)
        _, _, _, st_port, _ = tcvar.cvar_solve(
            tcplan, convert_tree_state(ts, "cpu"), params.Q, params.R, params.Qslack, xRef,
            0.9, params.Fx, params.bx, params.Fu, params.bu, torch.as_tensor(xs), S=S,
            cfg=convert_cvar_config(cfg),
            dh0_floor=None if floor is None else torch.as_tensor(floor), device="cpu")
        rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        out = {"kind": kind, "B": B, "iters": iters, "fields": {}}
        for f in FIELDS:
            j, e = np.asarray(getattr(st_jit, f)), np.asarray(getattr(st_eager, f))
            p = getattr(st_port, f).numpy()
            out["fields"][f] = {"port_vs_jit": rel(p, j), "eager_vs_jit": rel(e, j),
                                "port_vs_eager": rel(p, e)}
        ju, eu, pu = np.asarray(st_jit.u), np.asarray(st_eager.u), st_port.u.numpy()
        out["max_abs_du_port_vs_jit"] = float(np.abs(pu - ju).max())
        out["max_abs_du_eager_vs_jit"] = float(np.abs(eu - ju).max())
        for key in ("port_vs_jit", "eager_vs_jit"):
            out[f"worst_{key}"] = max(v[key] for v in out["fields"].values())
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
