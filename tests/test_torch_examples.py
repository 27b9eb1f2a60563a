"""The port's examples (``belief_planning_tpu_torch/examples/``) against the
JAX package's (``examples/main_branch.py``, ``examples/main_quadruped.py``)
on the CPU, a few steps each: ``sim_overtake`` (3 steps), ``sim_merge`` (2)
and the quadruped's ``main`` (2), with the same scenario constants built by
each example.

Both packages' controllers are swapped, in the examples' namespaces, for the
same controller in f64 at a short IPM (the CVaR's IPM-8, the quadruped's
IPM-12 as in ``tests/test_torch_quad_env.py``), where the two packages
compare before the late iterates' chaos; the examples run the default IPM
in f32. Each JAX example runs in a process of its own
(``tests/jax_example_runs.py``), side by side, while the port's run here.
Bars, those of the host loops (PRs 12 and 13): states and inputs < 1e-7,
backup choices and the collision flag equal, the controller's branches <
1e-6."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx
from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR
from belief_planning_tpu_torch.examples import main_branch, main_quadruped
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig
from tests import jax_example_runs

torch.set_num_threads(1)

CVAR_IPM = dict(iters=8, gondzio=0)
QUAD_IPM = dict(iters=12)
T = {"overtake": 0.3, "merge": 0.2, "quadruped": 0.4}


def _port_f64(cls, ipm):
    def make(*args, dtype=None, **kw):
        return cls(*args, dtype=torch.float64, ipm=ipm, **kw)
    return make


@pytest.fixture(scope="module")
def records():
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn")) as ex:
        jax_recs = {k: ex.submit(jax_example_runs.run, k, CVAR_IPM, QUAD_IPM, t)
                    for k, t in T.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(main_branch, "BranchMPCCVaR", _port_f64(BranchMPCCVaR,
                                                               CVaRIPMConfig(**CVAR_IPM)))
            mp.setattr(main_quadruped, "BranchMPCProx", _port_f64(BranchMPCProx,
                                                                  QPIPMConfig(**QUAD_IPM)))
            port = {"overtake": main_branch.sim_overtake(T=T["overtake"], seed=0, device="cpu"),
                    "merge": main_branch.sim_merge(T=T["merge"], seed=0, device="cpu"),
                    "quadruped": main_quadruped.main(T=T["quadruped"], device="cpu")}
        return {k: (f.result(), port[k]) for k, f in jax_recs.items()}


@pytest.mark.parametrize("which", ["overtake", "merge", "quadruped"])
def test_example_matches_jax(records, which):
    jrec, trec = records[which]
    assert len(jrec) == len(trec)
    steps = jrec[0].shape[1]
    assert trec[0].shape == jrec[0].shape and steps >= 2
    assert np.abs(trec[0] - jrec[0]).max() < 1e-7          # states
    assert np.abs(trec[1] - jrec[1]).max() < 1e-7          # inputs
    assert trec[3] == jrec[3]                               # backup choices
    for t in range(steps):                                  # the controller's branches
        for xt, xj in zip(trec[4][t], jrec[4][t]):
            assert np.abs(np.asarray(xt) - np.asarray(xj)).max() < 1e-6
    if which != "quadruped":
        assert trec[-1] == jrec[-1]                         # collision


def test_examples_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only check of the default device")
    with pytest.raises(RuntimeError, match="CUDA"):
        main_branch.main(["overtake", "--T", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main_quadruped.cli(["--T", "0.2"])
