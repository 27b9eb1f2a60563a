from belief_planning_tpu_torch.controllers.branch_mpc import (
    BranchMPC,
    BranchMPCProx,
    MPCCarry,
    SolveResult,
    make_branch_mpc_batched_step,
    make_branch_mpc_step,
)
from belief_planning_tpu_torch.controllers.cvar_mpc import (
    BranchMPCCVaR,
    CVaRSolveResult,
    make_cvar_mpc_batched_step,
    make_cvar_mpc_step,
)
from belief_planning_tpu_torch.controllers.hmm_mpc import (
    HMMMPC,
    make_hmm_mpc_batched_step,
    make_hmm_mpc_step,
)
from belief_planning_tpu_torch.controllers.robust_mpc import RobustMPC, make_robust_mpc_step

__all__ = ["BranchMPC", "BranchMPCCVaR", "BranchMPCProx", "CVaRSolveResult", "HMMMPC", "MPCCarry",
           "RobustMPC", "SolveResult", "make_branch_mpc_batched_step", "make_branch_mpc_step",
           "make_cvar_mpc_batched_step", "make_cvar_mpc_step", "make_hmm_mpc_batched_step",
           "make_hmm_mpc_step", "make_robust_mpc_step"]
