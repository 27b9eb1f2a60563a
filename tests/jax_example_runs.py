"""The JAX package's examples at the test's settings, one per process
(``tests/test_torch_examples.py`` runs them side by side, so that their
compiles overlap): CPU, f64, the controllers' IPM shortened, the step jitted
with ``FAST_XLA``. Imported by module path in each spawned process."""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import belief_planning_tpu.controllers.branch_mpc as jbranch  # noqa: E402
import belief_planning_tpu.controllers.cvar_mpc as jcvar  # noqa: E402
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig  # noqa: E402

# XLA's backend optimization level 0 without the expensive LLVM passes
# (as tests/test_torch_tree_admm.py's FAST_XLA)
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def f64_controller(cls, ipm):
    """``cls`` in f64 at ``ipm``, whatever dtype and IPM the caller asks."""
    def make(*args, dtype=None, **kw):
        mpc = cls(*args, dtype=jnp.float64, ipm=ipm, **kw)
        mpc._step = jax.jit(mpc._step, compiler_options=FAST_XLA)
        return mpc
    return make


def run(which, cvar_ipm, quad_ipm, T):
    """One example's records, with ``BranchMPCCVaR`` at
    ``CVaRIPMConfig(**cvar_ipm)`` and ``BranchMPCProx`` at
    ``QPIPMConfig(**quad_ipm)``."""
    jcvar.BranchMPCCVaR = f64_controller(jcvar.BranchMPCCVaR, CVaRIPMConfig(**cvar_ipm))
    jbranch.BranchMPCProx = f64_controller(jbranch.BranchMPCProx, QPIPMConfig(**quad_ipm))
    from examples import main_branch, main_quadruped

    if which == "overtake":
        return main_branch.sim_overtake(T=T, seed=0)
    if which == "merge":
        return main_branch.sim_merge(T=T, seed=0)
    return main_quadruped.main(T=T)
