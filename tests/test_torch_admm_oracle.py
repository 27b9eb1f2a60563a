"""The port's tree-QP ADMM (``solvers/tree_qp.admm_solve``) on its own:

- ``ADMMConfig(iters=400)`` (ρ adapted every 50, 30 polish iterations) on
  the overtake tree (N=4, NB ∈ {1, 2}, the collision rows active) against
  the dense NumPy oracle (``oracle/reference_tree.OracleBranchController``
  with ``oracle/qp.solve_qp``) at ``tests/test_tree_qp.py``'s bars: u <
  2e-4, x < 2e-3, the applied input < 1e-4. The oracle's model calls go
  through the port's model (``PortModelAdapter``), which
  ``tests/test_torch_formulas.py`` and ``test_torch_tree.py`` hold to the
  JAX package's;
- a batch of 3 different trees against each tree solved alone, with ρ
  adapted per tree (θ per tree): 1e-12;
- resuming from ``init`` equals the straight iteration: 1e-12."""

import numpy as np
import pytest
import torch

from belief_planning_tpu.oracle.reference_tree import OracleBranchController, OracleModelAdapter

from belief_planning_tpu_torch.solvers.tree_qp import ADMMConfig

from tests.test_torch_tree_admm import B, _port_solve, _problem, _states, _t
from tests.test_tree_qp import oracle_full_solution

torch.set_num_threads(1)


class PortModelAdapter(OracleModelAdapter):
    """The oracle's numpy-in, numpy-out model calls, computed by the port's
    model in f64 on the CPU."""

    def dyn_linearization(self, x, u):
        return tuple(a.numpy() for a in self.model.linearize(_t(x), _t(u)))

    def branch_eval(self, x, z):
        return tuple(a.numpy() for a in self.model.branch_eval(_t(x), _t(z),
                                                               self.policy_params))

    def zpred_eval(self, z):
        zp = self.model.zpred(_t(z), self.policy_params).numpy()
        return np.concatenate([zp[i] for i in range(self.m)], axis=1)

    def col_eval(self, x, z):
        h, dh = (a.numpy() for a in self.model.col_raw(_t(x), _t(z)))
        return h - dh @ np.asarray(x, np.float64), dh


@pytest.mark.parametrize("NB", [1, 2])
def test_admm_matches_oracle(NB):
    """``ADMMConfig(iters=400)`` against the dense NumPy oracle, the
    collision rows active (the JAX package's ``test_admm_parity_highway``)."""
    x, z = np.array([0.0, 1.8, 20.0, 0.0]), np.array([9.0, 1.8, 17.0, 0.0])
    p = _problem(NB, x[None], z[None])
    ctrl = OracleBranchController(p["params"], PortModelAdapter(p["tmodel"], p["tpp"]), "prox")
    ctrl.inittree(x, z)
    x_o, u_o = oracle_full_solution(ctrl, x)
    xn, u, _, _, info = _port_solve(p, ADMMConfig(iters=400))
    err_u = np.abs(u[0].numpy() - u_o).max()
    err_x = np.abs(xn[0].numpy() - x_o).max()
    assert err_u < 2e-4 and err_x < 2e-3, (err_u, err_x)
    assert np.abs(u[0, 0].numpy() - u_o[0]).max() < 1e-4


def test_batch_of_trees_is_independent():
    """Three distinct trees in one batch against three one-tree solves, ρ
    adapted from each tree's own residuals (θ per tree)."""
    xs, zs = _states(2)
    p = _problem(2, xs, zs)
    cfg = ADMMConfig(iters=100, rho_update_every=25, polish_iters=10)
    whole = _port_solve(p, cfg)
    thetas = whole[4]["rho"]
    assert len({round(float(t), 6) for t in thetas}) == B      # the trees adapt apart
    for i in range(B):
        one = {k: (type(v)(*(a[i:i + 1] for a in v)) if k in ("ts", "cost") else
                   v[i:i + 1] if torch.is_tensor(v) else v) for k, v in p.items()}
        part = _port_solve(one, cfg)
        for a, b in zip(part[:3], whole[:3]):
            assert (a[0] - b[i]).abs().max().item() <= 1e-12
        assert abs(part[4]["rho"][0].item() - thetas[i].item()) <= 1e-12


def test_init_resumes_the_iteration():
    p = _problem(1, *_states(1))
    cfg = lambda k: ADMMConfig(iters=k, rho_update_every=0, polish_iters=0)
    x4, u4, s4, st4, _ = _port_solve(p, cfg(3))
    _, _, _, st1, _ = _port_solve(p, cfg(1))          # 1 + the final iteration = 2
    x, u, s, st, _ = _port_solve(p, cfg(1), init=st1)  # 2 more
    for a, b in zip((x, u, s) + tuple(st), (x4, u4, s4) + tuple(st4)):
        assert (a - b).abs().max().item() <= 1e-12
