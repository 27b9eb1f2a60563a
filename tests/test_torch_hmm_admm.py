"""The HMM controller's ADMM step against the JAX package's (CPU, f64; the
model carried over by ``convert_hmm_model``): ``make_hmm_mpc_step(solver=
"admm")`` against the JAX package's ``jit(vmap(make_hmm_mpc_step(solver=
"admm")))`` at ``tests/test_hmm.py``'s batched inputs (M=1, N=6, B=3) and
the entry's ADMM config (ρ=5, 50 iterations at fixed ρ, 10 polish), a cold
step and a warm one: u < 1e-7, x < 1e-6, the tree ADMM's bars
(``tests/test_torch_tree_admm.py``), the same feasible flags. This holds
the dispatch to ``admm_solve`` and the HMM's per-stage override rows (the
belief-gated collision rows) to the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.hmm_mpc import make_hmm_mpc_step as j_step
from belief_planning_tpu.solvers.tree_qp import ADMMConfig as JADMMConfig

from belief_planning_tpu_torch.controllers.hmm_mpc import make_hmm_mpc_step
from belief_planning_tpu_torch.convert import (
    convert_admm_config,
    convert_hmm_model,
    convert_mpc_params,
)

from tests.test_hmm import hmm_setup
from tests.test_torch_hmm import _mpc_inputs, _np, _t
from tests.test_torch_tree_admm import FAST_XLA

torch.set_num_threads(1)

B = 3
ENTRY_ADMM = dict(rho=5.0, iters=50, rho_update_every=0, polish_iters=10)


@pytest.fixture(scope="module")
def admm_steps():
    cons, model, params = hmm_setup(N=6)
    tmodel, tparams = convert_hmm_model(model, "cpu"), convert_mpc_params(params)
    args = _mpc_inputs(B)
    admm = JADMMConfig(**ENTRY_ADMM)
    _, jinit, jstep1 = j_step(model, params, admm, solver="admm")
    jstep = jax.jit(jax.vmap(jstep1, in_axes=(0, 0, 0, 0, None)), compiler_options=FAST_XLA)
    _, tinit, tstep = make_hmm_mpc_step(tmodel, tparams, convert_admm_config(admm),
                                        solver="admm", device="cpu")
    jc = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jinit(jnp.float64))
    tc, out = tinit(B, torch.float64), []
    for _ in range(2):
        jc, jr = jstep(jc, *(jnp.asarray(a) for a in args))
        tc, tr = tstep(tc, *(_t(a) for a in args))
        out.append((_np(jr), tr))
    return out


@pytest.mark.parametrize("k", range(2), ids=["cold", "warm"])
def test_hmm_admm_step_matches_jax(admm_steps, k):
    jr, tr = admm_steps[k]
    assert np.abs(tr.uPred.numpy() - jr.uPred).max() < 1e-7
    assert np.abs(tr.xPred.numpy() - jr.xPred).max() < 1e-6
    assert np.array_equal(tr.feasible.numpy(), jr.feasible)
    np.testing.assert_allclose(tr.prim_res.numpy(), jr.prim_res, rtol=1e-6, atol=1e-6)
