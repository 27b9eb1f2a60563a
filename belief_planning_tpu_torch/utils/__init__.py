from belief_planning_tpu_torch.utils.config import BranchConstants, BranchMPCParams

__all__ = ["BranchConstants", "BranchMPCParams"]
