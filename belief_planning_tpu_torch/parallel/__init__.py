from belief_planning_tpu_torch.parallel.ensemble import (
    make_batched_step,
    make_mesh,
    make_sharded_ensemble_step,
)
from belief_planning_tpu_torch.parallel.launch import launch

__all__ = ["launch", "make_batched_step", "make_mesh", "make_sharded_ensemble_step"]
