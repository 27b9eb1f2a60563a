"""Where the CVaR solve stops being reproducible, in the reference itself.

On a small merge problem (N=3, NB=1, m=2, B=4, per-lane S, bx and dh[0]
floor, Gondzio 2, 10 iterations, f64, CPU) this runs the JAX package's
``cvar_ipm_solve_pl(use_pallas=False)`` jitted and eagerly (``disable_jit``)
and the port's ``cvar_ipm_solve_pl``, and prints as JSON lines:

- the relative gap difference per iteration, port against JAX (jitted),
  port against JAX (eager), and JAX eager against JAX jitted, plus max |Δu|;
- one iteration at a time on identical carries (the eager run's): the
  largest scaled field difference of the port's and the jitted JAX
  iteration against the eager JAX one.

    JAX_PLATFORMS=cpu python scripts/torch_port_cvar_chaos.py
"""

import json
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from belief_planning_tpu.solvers import cvar_pl as jcv  # noqa: E402
from belief_planning_tpu.solvers.cvar import build_cvar_plan as j_build_cvar_plan  # noqa: E402
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig  # noqa: E402
from belief_planning_tpu.tree.topology import build_topology as j_build_topology  # noqa: E402
from belief_planning_tpu_torch.models.policies import cast_params  # noqa: E402
from belief_planning_tpu_torch.solvers import cvar_pl  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from belief_planning_tpu_torch.solvers.layout import _to_bl  # noqa: E402
from belief_planning_tpu_torch.tree.engine import build_tree  # noqa: E402
from belief_planning_tpu_torch.tree.topology import build_topology  # noqa: E402
from tests.test_torch_cuda import cvar_problem  # noqa: E402

N, NB, M, B, ITERS = 3, 1, 2, 4, 10


def main():
    torch.set_num_threads(1)
    params, _, pset, model, ralpha, xs, zs, xRefs, S, bx, floor = cvar_problem("merge", N, NB, B)
    topo = build_topology(N, NB, M, 4, 2)
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, 2, dtype=torch.float64),
                    cast_params(pset.params, torch.float64, "cpu"))
    keys = ("A", "Bm", "dh", "h0", "x_lin", "u_lin", "p")
    tsb = [_to_bl(getattr(ts, k)) for k in keys]
    extra = [_to_bl(xRefs), _to_bl(bx), _to_bl(S)]
    cfg = CVaRIPMConfig(iters=ITERS, gondzio=2)
    jcfg = JCVaRIPMConfig(iters=ITERS, gondzio=2)
    jplan = j_build_cvar_plan(j_build_topology(N, NB, M, 4, 2))

    def jsolve(A, Bm, dh, h0, x, u, p, xr, bxx, SS, fl):
        return jcv.cvar_ipm_solve_pl(jplan, A, Bm, dh, h0, x, u, p, params.Q, params.R,
                                     params.Qslack, xr, ralpha, params.Fx, bxx, params.Fu,
                                     params.bu, cfg=jcfg, use_pallas=False, S_bl=SS,
                                     dh0_floor=fl)

    args = [jnp.asarray(t.numpy()) for t in tsb + extra] + [jnp.asarray(floor.numpy())]
    jit_res = jax.jit(jsolve)(*args)
    # the eager run, with every iteration's inputs captured
    captured = []
    orig = jcv.make_cvar_iteration

    def capturing(cplan, cfg_, dims):
        it = orig(cplan, cfg_, dims)
        captured.append(dims)

        def wrapped(*a):
            captured.append([np.asarray(v) for v in a])
            return it(*a)
        return wrapped

    jcv.make_cvar_iteration = capturing
    with jax.disable_jit():
        eager_res = jsolve(*args)
    jcv.make_cvar_iteration = orig
    port_res = cvar_pl.cvar_ipm_solve_pl(
        build_cvar_plan(topo), *tsb, params.Q, params.R, params.Qslack, extra[0], ralpha,
        params.Fx, extra[1], params.Fu, params.bu, cfg, S_bl=extra[2], dh0_floor=floor)
    g_jit, g_eager = np.asarray(jit_res[4]["gaps"]), np.asarray(eager_res[4]["gaps"])
    g_port = port_res[4]["gaps"].numpy()
    rel = lambda a, b: (np.abs(a - b) / np.abs(b)).max(1).tolist()
    print(json.dumps({"solve": "gap relative difference per iteration",
                      "port_vs_jax_jit": rel(g_port, g_jit),
                      "port_vs_jax_eager": rel(g_port, g_eager),
                      "jax_eager_vs_jax_jit": rel(g_eager, g_jit),
                      "max_abs_du": {"port_vs_jax_jit": float(np.abs(
                          port_res[1].numpy() - np.asarray(jit_res[1])).max()),
                          "jax_eager_vs_jax_jit": float(np.abs(
                              np.asarray(eager_res[1]) - np.asarray(jit_res[1])).max())}}))
    dims = captured[0]
    jit_iter = jax.jit(orig(jplan, jcfg, dims))
    port_iter = cvar_pl.make_cvar_iteration(build_cvar_plan(topo), cfg, dims)
    eager_iter = orig(jplan, jcfg, dims)
    steps = []
    for a in captured[1:]:
        with jax.disable_jit():
            e = [np.asarray(o) for o in eager_iter(*[jnp.asarray(v) for v in a])]
        j = [np.asarray(o) for o in jit_iter(*a)]
        t = [o.numpy() for o in port_iter(*[torch.as_tensor(v) for v in a[:20]],
                                          float(a[20].ravel()[0]),
                                          *[torch.as_tensor(v) for v in a[21:]])]
        sc = lambda x, y: max(float(np.abs(p - q).max() / max(np.abs(q).max(), 1e-300))
                              for p, q in zip(x, y))
        steps.append({"port_vs_jax_eager": sc(t, e), "jax_jit_vs_jax_eager": sc(j, e)})
    print(json.dumps({"one_iteration_on_identical_carries": steps}))


if __name__ == "__main__":
    main()
