from belief_planning_tpu_torch.controllers.branch_mpc import (
    MPCCarry,
    SolveResult,
    make_branch_mpc_batched_step,
)

__all__ = ["MPCCarry", "SolveResult", "make_branch_mpc_batched_step"]
