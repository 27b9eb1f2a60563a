"""Closed-loop QP IPM iteration-count study, iterations × Gondzio
correctors: the port's counterpart of ``scripts/qp_iter_study.py``.

For each (iters, gondzio) configuration the closed-loop overtake of
``tests/test_controller_parity.simulate_closed_loop`` (``BranchConstants()``,
N=8, NB=2, 10 steps, the cold first solve included, both worlds driven by
their own applied inputs) runs the port's ``BranchMPCProx`` (the per-tree
QP IPM, f64) against the dense f64 NumPy oracle
(``belief_planning_tpu.oracle.reference_tree.OracleBranchController``, the
prox variant), its model calls computed by the port's model
(``PortModelAdapter``), and prints the max applied-input deviation with the
``BASELINE.md`` gate, 1e-3. The oracle's world does not depend on the
engine, so its loop runs once for all configurations.

    python scripts/torch_port_qp_iter_study.py [n_steps] [--device cuda|cpu]

``--device`` defaults to the CUDA card. Env: QP_N, QP_NB (the tree, 8 and 2
as the reference's; smaller for a quick run), QP_ITER_LIST (6,8,10,12),
QP_GONDZIO_LIST (0,1,2).
"""

import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from belief_planning_tpu.oracle.reference_tree import OracleBranchController  # noqa: E402

from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx  # noqa: E402
from belief_planning_tpu_torch.models.policies import highway_policy_set  # noqa: E402
from belief_planning_tpu_torch.models.predictive import highway_model  # noqa: E402
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig  # noqa: E402
from belief_planning_tpu_torch.utils.config import BranchConstants, BranchMPCParams  # noqa: E402
from torch_port_cvar_hard_oracle import PortModelAdapter  # noqa: E402

X0 = np.array([0.0, 1.8, 20.0, 0.0])
Z0 = np.array([9.0, 1.8, 17.0, 0.0])
XREF = np.array([0.0, 1.8, 18.0, 0.0])


def overtake_setup(N=8, NB=2):
    """``tests/test_tree_qp.overtake_setup`` in the port: ``(cons, pset,
    model, params)``."""
    cons = BranchConstants()
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xt)
    model = highway_model(cons, pset, N=N, dt=0.1)
    params = BranchMPCParams(
        n=4, d=2, N=N, NB=NB, Q=np.diag([0., 3, 3, 10.]), R=np.diag([1., 100.]),
        Qslack=np.array([0., 300.]),
        Fx=np.array([[0., 1, 0, 0], [0., -1, 0, 0], [0., 0, 0, 1], [0., 0, 0, -1]]),
        bx=np.array([4 * 3.6 - 1.25, -1.25, 0.25, 0.25]),
        Fu=np.kron(np.eye(2), np.array([1., -1])).T, bu=np.array([6.0, 6.0, 0.3, 0.3]),
        xRef=xt)
    return cons, pset, model, params


def _world_step(x, z, u, Kpsi, dt):
    f = lambda s, v: np.array([s[2] * np.cos(s[3]), s[2] * np.sin(s[3]), v[0], v[1]])
    return x + f(x, u) * dt, z + f(z, np.array([0.0, -Kpsi * z[3]])) * dt


def closed_loop(controller, n_steps, cons, dt):
    """The applied inputs of ``n_steps`` steps of the controller's own world."""
    x, z = X0.copy(), Z0.copy()
    us = []
    for _ in range(n_steps):
        u = np.asarray(controller.solve(x, z, XREF), np.float64).copy()
        us.append(u)
        x, z = _world_step(x, z, u, cons.Kpsi, dt)
    return np.asarray(us)


def oracle_inputs(n_steps, N=8, NB=2):
    """The oracle's closed loop: its applied inputs by step."""
    cons, pset, model, params = overtake_setup(N, NB)
    oracle = OracleBranchController(params, PortModelAdapter(model, pset.params), "prox")
    return closed_loop(oracle, n_steps, cons, model.dt)


def engine_inputs(ipm, n_steps, device, N=8, NB=2):
    """The port's ``BranchMPCProx`` (f64) in its own closed loop: its applied
    inputs by step."""
    cons, pset, model, params = overtake_setup(N, NB)
    mpc = BranchMPCProx(params, model, pset.params, ipm=ipm, dtype=torch.float64, device=device)
    return closed_loop(mpc, n_steps, cons, model.dt)


def study(n_steps, device, N=8, NB=2, iter_list=(6, 8, 10, 12), gondzio_list=(0, 1, 2),
          out=print):
    """The reference script's table; returns ``{(iters, gondzio): max|du|}``."""
    out(f"closed-loop overtake, {n_steps} steps, N={N} NB={NB}; gate 1e-3")
    u_o = oracle_inputs(n_steps, N, NB)
    table = {}
    for gondzio in gondzio_list:
        for iters in iter_list:
            u_j = engine_inputs(QPIPMConfig(iters=iters, gondzio=gondzio), n_steps, device, N, NB)
            err = float(np.abs(u_o - u_j).max())
            table[(iters, gondzio)] = err
            out(f"iters={iters:3d} gondzio={gondzio}  max|du|={err:.3e} "
                f"{'PASS' if err < 1e-3 else 'fail'}")
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_steps", nargs="?", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    env = os.environ.get
    ints = lambda s: tuple(int(v) for v in s.split(","))
    study(args.n_steps, args.device, int(env("QP_N", "8")), int(env("QP_NB", "2")),
          ints(env("QP_ITER_LIST", "6,8,10,12")), ints(env("QP_GONDZIO_LIST", "0,1,2")))


if __name__ == "__main__":
    main()
