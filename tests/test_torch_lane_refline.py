"""A reference line a lane: ``policy_in_axes`` marking the merge policies'
``psiref`` (a :class:`RefLine` table) per lane, on the QP batched step,
against the JAX package, whose step ``vmap``s the marked leaves (CPU, f64,
the plain fused iteration; the merge model at N=3, NB=1, B=4, two tables
on alternate lanes, two warm-started steps: u < 1e-7, x < 1e-6, the tree's
p, w and x_lin < 1e-9). In the port alone: the per-lane step equals, to
1e-12, the shared-table step run once with each table, on that table's
lanes; and the tables reach their lanes (the two tables give different
trees on equal states)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.branch_mpc import (
    make_branch_mpc_batched_step as j_make_step,
)
from belief_planning_tpu.envs.merge import merge_ref_lines as j_merge_ref_lines
from belief_planning_tpu.models import policies as jpol
from belief_planning_tpu.models.predictive import merge_model as j_merge_model
from belief_planning_tpu.presets import init_branch_mpc as j_init_branch_mpc
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step
from belief_planning_tpu_torch.convert import convert
from belief_planning_tpu_torch.envs.batched_merge import draw_merge_worlds
from belief_planning_tpu_torch.models import policies as pol
from belief_planning_tpu_torch.models.predictive import merge_model
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_torch_tree_admm import FAST_XLA

torch.set_num_threads(1)

N, NB, B, V0 = 3, 1, 4, 20.0
IPM = dict(iters=8, gondzio=2)
F64 = torch.float64


def _tables():
    """Two reference-heading tables of one knot count: the ramp's, and the
    same ramp moved 6 m on and turned half as sharply."""
    _, refpsi = j_merge_ref_lines(2, 1, 30.0, 100.0)
    xs, ys = np.asarray(refpsi.xs), np.asarray(refpsi.ys)
    return (xs, ys), (xs + 6.0, 0.5 * ys)


def _inputs():
    xs, zs = draw_merge_worlds(B, 3)
    xRefs = np.tile([0.0, 1.8, V0, 0.0], (B, 1))
    return xs, zs, xRefs


def _lane_tables():
    (xa, ya), (xb, yb) = _tables()
    pick = lambda a, b: np.stack([a if i % 2 == 0 else b for i in range(B)])
    return pick(xa, xb), pick(ya, yb)


@pytest.fixture(scope="module")
def runs():
    cons = JBranchConstants(am=7.0)
    xs, zs, xRefs = _inputs()
    lx, ly = _lane_tables()

    # the JAX package: the psiref leaves of both policies carry the lane axis
    jref = jpol.RefLine(xs=jnp.asarray(lx), ys=jnp.asarray(ly))
    jpset = jpol.merge_policy_set(cons, V0, jpol.RefLine(xs=jnp.asarray(lx[0]),
                                                         ys=jnp.asarray(ly[0])))
    jmodel = j_merge_model(cons, jpset, N=N, dt=0.1)
    params = j_init_branch_mpc(4, 2, N, NB, np.array([0.5, 1.8, 15.0, 0.0]), am=7.0, rm=0.3,
                               N_lane=2, W=cons.W)
    jaxes = (jpol.MaintainTrackVParams(Kpsi=None, v0=None, psiref=0),
             jpol.BrakeParams(Kpsi=None, a_brake=None, gamma=None, psiref=0))
    _, jinit, jstep = j_make_step(jmodel, params, "prox", ipm=JQPIPMConfig(**IPM),
                                  backend="pl_xla", policy_in_axes=jaxes)
    jstep = jax.jit(jstep, compiler_options=FAST_XLA)
    jpp = tuple(p._replace(psiref=jref) for p in jpset.params)
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jinit(jnp.float64))
    jres = []
    for _ in range(2):
        c, r = jstep(c, jnp.asarray(xs), jnp.asarray(zs), jnp.asarray(xRefs), jpp)
        jres.append(jax.tree.map(np.asarray, r))

    # the port: per-lane tables, then the shared-table step once a table
    tparams, tcons, tpp = convert(params, cons, jpset.params, "cpu")
    tmodel = merge_model(tcons, pol.merge_policy_set(tcons, V0, tpp[0].psiref), N=N, dt=0.1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
    axes = (pol.MaintainTrackVParams(Kpsi=None, v0=None, psiref=0),
            pol.BrakeParams(Kpsi=None, a_brake=None, gamma=None, psiref=0))

    def port(policy_in_axes, pp):
        _, init, step = make_branch_mpc_batched_step(tmodel, tparams, "prox",
                                                     ipm=QPIPMConfig(**IPM), device="cpu",
                                                     policy_in_axes=policy_in_axes)
        tc, out = init(B, F64), []
        for _ in range(2):
            tc, r = step(tc, t(xs), t(zs), t(xRefs), pp)
            out.append(r)
        return out

    with_ref = lambda ref: tuple(p._replace(psiref=ref) for p in tpp)
    tres = port(axes, with_ref(pol.RefLine(xs=t(lx), ys=t(ly))))
    shared = [port(None, with_ref(pol.RefLine(xs=t(a), ys=t(b)))) for a, b in _tables()]
    return dict(jres=jres, tres=tres, shared=shared)


@pytest.mark.parametrize("k", range(2))
def test_per_lane_refline_step_matches_jax(runs, k):
    jr, tr = runs["jres"][k], runs["tres"][k]
    assert np.abs(tr.uPred.numpy() - jr.uPred).max() < 1e-7
    assert np.abs(tr.xPred.numpy() - jr.xPred).max() < 1e-6
    for f in ("p", "w", "x_lin"):
        assert np.abs(getattr(tr, f).numpy() - getattr(jr, f)).max() < 1e-9, f


@pytest.mark.parametrize("k", range(2))
def test_per_lane_refline_equals_shared_table_runs(runs, k):
    tr = runs["tres"][k]
    for j, sh in enumerate(runs["shared"]):
        lanes = slice(j, None, 2)
        for f in ("uPred", "xPred", "p"):
            assert (getattr(tr, f)[lanes] - getattr(sh[k], f)[lanes]).abs().max().item() < 1e-12


def test_each_lane_reads_its_own_table(runs):
    a, b = (sh[0].p for sh in runs["shared"])
    assert (a - b).abs().max().item() > 1e-6
