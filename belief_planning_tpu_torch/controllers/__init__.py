from belief_planning_tpu_torch.controllers.branch_mpc import (
    MPCCarry,
    SolveResult,
    make_branch_mpc_batched_step,
    make_branch_mpc_step,
)
from belief_planning_tpu_torch.controllers.cvar_mpc import (
    CVaRSolveResult,
    make_cvar_mpc_batched_step,
    make_cvar_mpc_step,
)

__all__ = ["CVaRSolveResult", "MPCCarry", "SolveResult", "make_branch_mpc_batched_step",
           "make_branch_mpc_step", "make_cvar_mpc_batched_step", "make_cvar_mpc_step"]
