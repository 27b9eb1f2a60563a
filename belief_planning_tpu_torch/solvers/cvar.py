"""The static plan of the nested-CVaR tree SOCP (the reference package's
``solvers/cvar.py``: ``CVaRPlan`` and ``build_cvar_plan``; its cone-ADMM
solver is not ported yet).

Every non-leaf branch carries a dual-CVaR risk block ``[ρ; σ; μ⁺; μ⁻]`` and
one cone per child. The reference's μ-slot aliasing quirk (child ``i`` of
branch ``idx`` uses slot ``idx + i``, so neighbouring branches share slots)
is reproduced under ``replicate_quirks`` and corrected (``idx·m + i``)
otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from belief_planning_tpu_torch.solvers.tree_qp import StagePlan, build_stage_plan
from belief_planning_tpu_torch.tree.topology import TreeTopology


@dataclass(frozen=True)
class CVaRPlan:
    plan: StagePlan
    bdim: int                      # number of non-leaf branches (= risk branches)
    nrisk: int                     # ρ, σ, μ⁺, μ⁻ count
    slotP: np.ndarray              # (bdim, m) flat μ⁺ slot per (branch, child)
    slotM: np.ndarray              # (bdim, m) flat μ⁻ slot
    child_of: np.ndarray           # (bdim, m) child branch id
    child_nonleaf: np.ndarray      # (bdim, m) bool
    n_sum_rows: int                # bdim·m per-child cone rows


def build_cvar_plan(topo: TreeTopology, replicate_quirks: bool = True) -> CVaRPlan:
    plan = build_stage_plan(topo)
    bdim = int(np.sum(~np.asarray(topo.is_leaf)))
    m = topo.m
    slotP = np.zeros((bdim, m), dtype=np.int64)
    slotM = np.zeros((bdim, m), dtype=np.int64)
    for idx in range(bdim):
        for i in range(m):
            slot = idx + i if replicate_quirks else idx * m + i
            slotP[idx, i] = slot
            slotM[idx, i] = slot
    child_of = np.asarray(topo.children[:bdim], dtype=np.int64)
    child_nonleaf = ~np.asarray(topo.is_leaf)[child_of]
    return CVaRPlan(plan=plan, bdim=bdim, nrisk=bdim * (2 + 2 * m), slotP=slotP,
                    slotM=slotM, child_of=child_of, child_nonleaf=child_nonleaf,
                    n_sum_rows=bdim * m)
