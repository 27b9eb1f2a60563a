from belief_planning_tpu_torch.tree.topology import TreeTopology, build_topology
from belief_planning_tpu_torch.tree.engine import TreeState, build_tree, shift_warm_start

__all__ = ["TreeTopology", "build_topology", "TreeState", "build_tree", "shift_warm_start"]
