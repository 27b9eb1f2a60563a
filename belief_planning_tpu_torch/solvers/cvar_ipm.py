"""CVaR IPM configuration (the reference package's ``solvers/cvar_ipm.py``;
the vmapped per-tree solver ``cvar_ipm_solve`` is not ported yet).

Every field keeps the reference's name and default. The fused iteration
(``solvers/cvar_pl.py``) reads ``iters``, ``reg``, ``tau``, ``a_cap_early``,
``early_iters``, ``w_max``, ``w_max_f32``, ``gap_tol``, ``sl_min`` and the
Gondzio fields; ``mxu`` only chose the TPU unit for some contractions and
does not change the result. The remaining fields configure
``cvar_ipm_solve`` and are carried for parity of the parameter objects.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CVaRIPMConfig:
    iters: int = 40
    reg: float = 1e-8
    tau: float = 0.99            # fraction-to-boundary
    a_cap_early: float = 0.7     # step cap for the first (cold) iterations
    early_iters: int = 6
    w_max: float = 1e12          # clamp on barrier weights λ/s
    w_max_f32: float = 1e6       # the clamp below float64: min(w_max, w_max_f32)
    gap_tol: float = 1e-9        # freeze the iterate once the scaled gap is below
    refine: int = 0              # cvar_ipm_solve: refinement rounds per KKT solve
    refine_dtype: str = "same"   # cvar_ipm_solve: residual precision of refinement
    outer_dtype: str = "same"    # cvar_ipm_solve: precision of the outer iteration
    mxu: bool = False            # TPU matrix-unit routing; no effect on the result
    sl_min: float = 0.3          # slack floor of the starting point
    resid: str = "recompute"     # cvar_ipm_solve: residual handling
    recovery: str = "direct"     # cvar_ipm_solve: dual recovery algebra
    # Gondzio multiple-centrality correctors per iteration: each reuses the
    # factor on a pure complementarity right-hand side that pushes outlier
    # products back into [bmin·σμ, bmax·σμ], accepted per lane if the step grows
    gondzio: int = 0
    gondzio_bmin: float = 0.1
    gondzio_bmax: float = 10.0
    neighborhood: float = 0.0    # cvar_ipm_solve: wide-neighbourhood safeguard
    split_step: bool = False     # cvar_ipm_solve: separate primal / dual steps
    recenter: int = 0            # cvar_ipm_solve: jam-recovery recentering
    recenter_tol: float = 1e-5
    diag_extra: bool = False     # cvar_ipm_solve: extended diagnostics
