from belief_planning_tpu_torch.utils.config import BranchConstants, BranchMPCParams, QuadConstants

__all__ = ["BranchConstants", "BranchMPCParams", "QuadConstants"]
