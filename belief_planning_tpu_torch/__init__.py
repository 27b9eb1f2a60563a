"""belief_planning_tpu_torch — the branch-MPC engine in PyTorch, for NVIDIA Hopper.

A port of ``belief_planning_tpu`` (the JAX reference, which stays unchanged).
The module layout mirrors the reference package so each counterpart is easy to
find. Entry points run on a CUDA device unless the caller passes
``device="cpu"``; each fused IPM iteration (the QP's and the nested CVaR's)
runs as a hand-written CUDA kernel (``csrc/tree_qp_ipm_iter.cu``,
``csrc/cvar_ipm_iter.cu``) on CUDA tensors and as its plain PyTorch version
on CPU tensors.

This package never imports ``jax`` or ``belief_planning_tpu``.
"""

__version__ = "0.1.0"

from belief_planning_tpu_torch.utils.config import BranchConstants, BranchMPCParams

__all__ = ["BranchConstants", "BranchMPCParams"]
