"""IPM configuration (the reference package's ``solvers/tree_qp_ipm.py``;
the independent per-tree solver ``qp_ipm_solve`` is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QPIPMConfig:
    iters: int = 30
    reg: float = 1e-8
    tau: float = 0.99
    mu0: float = 10.0
    w_max: float = 1e12
    gap_tol: float = 1e-10
    # Slack floor of the starting point, sl = max(b − rows, sl_min): the rows
    # are evaluated at the rolled-out warm primal, so a small floor keeps the
    # start nearly primal-feasible.
    sl_min: float = 0.1
    # Gondzio multiple-centrality correctors per iteration, each a
    # factorization-reusing solve on a pure complementarity right-hand side
    # that pushes outlier products back into [bmin·σμ, bmax·σμ].
    gondzio: int = 0
    gondzio_bmin: float = 0.1
    gondzio_bmax: float = 10.0
