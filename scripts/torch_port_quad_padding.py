"""Why the quadruped's solve keeps one inert padded state row.

The quadruped has no state rows (Fx of shape (0, 3)). The JAX package's
fused solve (``tree_qp_pl.qp_ipm_solve_pl``, behind
``make_branch_mpc_batched_step``) pads them to one inert row 0·x ≤ 1e9,
whose slack and multipliers then take part in the iteration (the gap, the
centering, the step). Its per-tree solve (``tree_qp_ipm.qp_ipm_solve``,
behind ``make_branch_mpc_step``) does not pad. This prints, on the CPU in
f64 at the JAX tests' ``quad_setup(N=5, NB=2)``, B=8, over two warm steps:
the JAX batched step against the JAX per-tree step (padded against
unpadded), and the port's batched step against the JAX batched step.

    JAX_PLATFORMS=cpu python scripts/torch_port_quad_padding.py [iters ...]

(default iteration counts 8 and 30, each with 2 Gondzio correctors).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from belief_planning_tpu.controllers.branch_mpc import (  # noqa: E402
    make_branch_mpc_batched_step as j_batched,
    make_branch_mpc_step as j_per_tree,
)
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig  # noqa: E402

from belief_planning_tpu_torch.controllers.branch_mpc import (  # noqa: E402
    make_branch_mpc_batched_step,
)
from belief_planning_tpu_torch.convert import convert  # noqa: E402
from belief_planning_tpu_torch.models.policies import quadruped_policy_set  # noqa: E402
from belief_planning_tpu_torch.models.predictive import quadruped_model  # noqa: E402
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig  # noqa: E402

from tests.test_tree_qp import quad_setup  # noqa: E402

B, STEPS = 8, 2


def main(argv):
    iters_list = [int(a) for a in argv[1:]] or [8, 30]
    cons, pset, model, params = quad_setup(N=5, NB=2)
    rng = np.random.default_rng(0)
    xs = np.array([0.0, 1.8, 0.0]) + rng.normal(0, 0.3, (B, 3))
    zs = np.array([2.5, 2.5, -np.pi / 2]) + rng.normal(0, 0.3, (B, 3))
    xRefs = np.tile([5.0, 5.0, 0.0], (B, 1))
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = quadruped_model(tcons, quadruped_policy_set(tpp[0].v0), N=5, dt=0.2)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    for iters in iters_list:
        jcfg = JQPIPMConfig(iters=iters, gondzio=2)
        _, i1, s1 = j_per_tree(model, params, "prox", ipm=jcfg)
        _, i2, s2 = j_batched(model, params, "prox", ipm=jcfg, backend="pl_xla")
        lanes = lambda c: jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), c)
        c1, c2 = lanes(i1(jnp.float64)), lanes(i2(jnp.float64))
        v1 = jax.jit(jax.vmap(s1, in_axes=(0, 0, 0, 0, None)))
        v2 = jax.jit(s2)
        _, ti, ts = make_branch_mpc_batched_step(
            tmodel, tparams, "prox", ipm=QPIPMConfig(iters=iters, gondzio=2), device="cpu")
        tc = ti(B, torch.float64)
        for k in range(STEPS):
            c1, r1 = v1(c1, xs, zs, xRefs, pset.params)
            c2, r2 = v2(c2, xs, zs, xRefs, pset.params)
            tc, rt = ts(tc, t(xs), t(zs), t(xRefs), tpp)
            d = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max())
            print(f"IPM-{iters} step {k}: JAX padded vs unpadded |du| {d(r2.uPred, r1.uPred):.3e}"
                  f" |dx| {d(r2.xPred, r1.xPred):.3e}; port vs JAX padded"
                  f" |du| {d(rt.uPred.numpy(), r2.uPred):.3e} |dx| {d(rt.xPred.numpy(), r2.xPred):.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
