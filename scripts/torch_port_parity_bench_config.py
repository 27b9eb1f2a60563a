"""The PyTorch port against the JAX reference at the bench configuration, on
the CPU: N=8, NB=2, IPM-8 with 2 Gondzio correctors, ``bench.py``'s state
draw, two warm-started receding-horizon steps, in f64 and in f32. Prints
one JSON line per dtype: max |Δu|, and the feasible share, the infeasible
lanes and the max primal residual of each package.

    JAX_PLATFORMS=cpu python scripts/torch_port_parity_bench_config.py [B]
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

from belief_planning_tpu.controllers.branch_mpc import make_branch_mpc_batched_step as j_make  # noqa: E402
from belief_planning_tpu.models.policies import highway_policy_set as j_policies  # noqa: E402
from belief_planning_tpu.models.predictive import highway_model as j_model  # noqa: E402
from belief_planning_tpu.presets import init_branch_mpc as j_init_params  # noqa: E402
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig  # noqa: E402
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants  # noqa: E402
from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step  # noqa: E402
from belief_planning_tpu_torch.convert import convert  # noqa: E402
from belief_planning_tpu_torch.models.policies import highway_policy_set  # noqa: E402
from belief_planning_tpu_torch.models.predictive import highway_model  # noqa: E402
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig  # noqa: E402
from chip_smoke import bench_states  # noqa: E402


def main(B=256, N=8, steps=2):
    cons = JBranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0,
                            rm=0.3, J_c=20, s_c=1, ylb=0., yub=7.2, L=4, W=2.5,
                            col_alpha=5, Kpsi=0.1)
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    pset = j_policies(cons, xRef)
    model = j_model(cons, pset, N=N, dt=0.1)
    params = j_init_params(4, 2, N, 2, xRef, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = highway_model(tcons, highway_policy_set(tcons, tpp[2].x_target), N=N, dt=0.1)
    xs, zs, xRefs = bench_states(B)
    for jd, td in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        _, init, step = j_make(model, params, "prox", ipm=JQPIPMConfig(iters=8, gondzio=2),
                               backend="pl_xla")
        step = jax.jit(step)
        c = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), init(jd))
        for _ in range(steps):
            c, jr = step(c, jnp.asarray(xs, jd), jnp.asarray(zs, jd), jnp.asarray(xRefs, jd),
                         pset.params)
        _, tinit, tstep = make_branch_mpc_batched_step(
            tmodel, tparams, "prox", ipm=QPIPMConfig(iters=8, gondzio=2), device="cpu")
        tc = tinit(B, td)
        t = lambda a: torch.as_tensor(a, dtype=td)
        for _ in range(steps):
            tc, tr = tstep(tc, t(xs), t(zs), t(xRefs), tpp)
        jf, tf = np.asarray(jr.feasible), tr.feasible.numpy()
        print(json.dumps({
            "dtype": str(td)[6:], "B": B, "N": N, "steps": steps,
            "max_abs_du": float(np.abs(tr.uPred.double().numpy() - np.asarray(jr.uPred)).max()),
            "feasible_share": {"jax": float(jf.mean()), "port": float(tf.mean())},
            "same_infeasible_lanes": bool(np.array_equal(jf, tf)),
            "infeasible_lanes": np.nonzero(~tf)[0].tolist(),
            "prim_res_max": {"jax": float(np.asarray(jr.prim_res).max()),
                             "port": float(tr.prim_res.max())}}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
