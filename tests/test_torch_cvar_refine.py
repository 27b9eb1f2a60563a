"""The f64 restart of the batched CVaR step (``refine_f64``) against the
JAX package's: after an 8-iteration f64 solve of the merge deployment
(per-lane ``S`` and ``bx``), 4 restart iterations with the flipped Gondzio
pattern (4 correctors), warm-started from the solve's x, u, s and r, over
two receding-horizon steps. Bar: the applied input u0 < 1e-7 and the
returned gap."""

import numpy as np
import torch

from tests.test_torch_cvar_mpc import _run

torch.set_num_threads(1)


def test_refine_f64_matches_jax():
    jres, tres = _run("merge", refine_f64=4)
    for jr, tr in zip(jres, tres):
        assert np.abs(tr.uPred.numpy()[:, 0] - jr.uPred[:, 0]).max() < 1e-7
        np.testing.assert_allclose(tr.gap.numpy(), jr.gap, rtol=1e-8, atol=1e-10)
