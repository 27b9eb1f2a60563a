"""How far the robust controller's closed loop (``RobustMPC``, the demo's
N=8, NB=2, f64: ``chip_smoke.py``'s ``robust_host_loop``) parts under
changes of rounding size, in the port and in the JAX package, on the CPU.

It runs ``tests/test_robust_mpc.py``'s closed loop (5 steps on the IPM-100,
then 2 on ``ADMMConfig()`` from its carry) twice in each package, the second
time with the ego's start moved by 1e-13 in Y, and prints each step's max
|Δu|; then, in the port, each step solved again from the same carry with
the state scaled by (1 + 1e-15), the single-solve sensitivity. One JSON
line each. Usage (from the repository root):

    python scripts/torch_port_robust_chaos.py [port|jax|both]

Needs the port and, for ``jax``, the JAX package (CPU).
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

STEPS_IPM, STEPS_ADMM = 5, 2
X0, Z0 = np.array([0.0, 1.8, 20.0, 0.0]), np.array([10.0, 2.1, 16.0, 0.0])
XREF = np.array([0.0, 1.8, 18.0, 0.0])


def loop(mpcs, kpsi, dt, eps=0.0, probe=None):
    """The closed loop; with ``probe = (mpcs', copy_carry)`` each step is also
    solved by ``mpcs'`` from the same carry at the state × (1 + 1e-15)."""
    f = lambda s, u: s + np.array([s[2] * np.cos(s[3]), s[2] * np.sin(s[3]), u[0], u[1]]) * dt
    x, z = X0 + np.array([0.0, eps, 0.0, 0.0]), Z0.copy()
    us, single = [], []
    for k in range(STEPS_IPM + STEPS_ADMM):
        i = 0 if k < STEPS_IPM else 1
        if k == STEPS_IPM:
            mpcs[1].carry = mpcs[0].carry
        if probe is not None:
            probe[0][i].carry = probe[1](mpcs[i].carry)
            up = np.asarray(probe[0][i].solve(x * (1 + 1e-15), z, XREF))
        u = np.asarray(mpcs[i].solve(x, z, XREF))
        if probe is not None:
            single.append(float(np.abs(u - up).max()))
        us.append(u)
        x, z = f(x, u), f(z, np.array([0.0, -kpsi * z[3]]))
    return np.array(us), single


def port():
    import torch

    torch.set_num_threads(1)
    import chip_smoke as cs

    dt, kpsi = cs.overtake_setup()[1].dt, cs.overtake_cons().Kpsi
    a, single = loop(cs._robust_mpcs("cpu"), kpsi, dt,
                     probe=(cs._robust_mpcs("cpu"),
                            lambda c: type(c)(*(t.clone() for t in c))))
    b, _ = loop(cs._robust_mpcs("cpu"), kpsi, dt, eps=1e-13)
    print(json.dumps({"package": "port", "closed_loop_du_per_step_start_1e-13":
                      np.abs(a - b).max(axis=1).tolist(),
                      "single_solve_du_per_step_state_1e-15": single}), flush=True)


def jax_side():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from belief_planning_tpu.controllers.robust_mpc import RobustMPC
    from belief_planning_tpu.models.policies import highway_policy_set
    from belief_planning_tpu.models.predictive import highway_model
    from belief_planning_tpu.presets import init_branch_mpc
    from belief_planning_tpu.solvers.tree_qp import ADMMConfig
    from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig
    from belief_planning_tpu.utils.config import BranchConstants

    cons = BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                           J_c=20, s_c=1, ylb=0., yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xt)
    model = highway_model(cons, pset, N=8, dt=0.1)
    params = init_branch_mpc(4, 2, 8, 2, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    mk = lambda: (RobustMPC(params, model, pset.params, dtype=jnp.float64,
                            ipm=QPIPMConfig(iters=100)),
                  RobustMPC(params, model, pset.params, admm=ADMMConfig(), dtype=jnp.float64,
                            solver="admm"))
    a, _ = loop(mk(), cons.Kpsi, model.dt)
    b, _ = loop(mk(), cons.Kpsi, model.dt, eps=1e-13)
    print(json.dumps({"package": "jax", "closed_loop_du_per_step_start_1e-13":
                      np.abs(a - b).max(axis=1).tolist()}), flush=True)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    if which in ("port", "both"):
        port()
    if which in ("jax", "both"):
        jax_side()
