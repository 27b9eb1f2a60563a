"""The port's branch-sharded tree KKT (``parallel/tree_shard.py``) and
``entry.dryrun_multichip`` (CPU, gloo ranks spawned by
``parallel.launch.launch``):

- ``_random_tree_kkt_case`` of ``tests/test_parallel.py`` (N=4, NB=3, m=2,
  f64, T=8) over 4 ranks as (dp, mp) = (2, 2) and (1, 4): the gathered
  result equals the port's unsharded level-blocked sweeps with the same
  fixed-order products (``pr=FIXED_ORDER``) exactly (``torch.equal``), each
  rank's local blocks are its slices of it, and the
  sharded levels are the ones mp divides;
- the port's unsharded sweeps equal the JAX package's ``_factor_blocks`` +
  ``_linear_blocks`` + ``_forward_blocks`` to 1e-12;
- ``dryrun_multichip(2)`` passes on the CPU and reports each rank's backend
  and device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers.tree_qp_pl import _factor_blocks as j_factor
from belief_planning_tpu.solvers.tree_qp_pl import _forward_blocks as j_forward
from belief_planning_tpu.solvers.tree_qp_pl import _linear_blocks as j_linear
from belief_planning_tpu.solvers.tree_qp_pl import build_levels as j_build_levels

from belief_planning_tpu_torch.entry import dryrun_multichip
from belief_planning_tpu_torch.parallel.launch import launch
from belief_planning_tpu_torch.parallel.tree_shard import level_sharding
from belief_planning_tpu_torch.solvers.tree_qp import build_stage_plan
from belief_planning_tpu_torch.solvers.tree_qp_pl import (
    FIXED_ORDER,
    _factor_blocks,
    _forward_blocks,
    _linear_blocks,
    build_levels,
)
from belief_planning_tpu_torch.tree.topology import build_topology
from tests import torch_port_ranks as R
from tests.test_parallel import _random_tree_kkt_case
from tests.test_torch_tree_admm import FAST_XLA

torch.set_num_threads(1)

DIMS = (4, 3, 2, 3, 2)           # N, NB, m, n, d of _random_tree_kkt_case
T = 8
MESHES = ((2, 2), (1, 4))


@pytest.fixture(scope="module")
def case():
    jtopo, jplan, jbl = _random_tree_kkt_case()
    return jplan, jbl, {k: torch.as_tensor(np.array(v)) for k, v in jbl.items()}


@pytest.fixture(scope="module")
def unsharded(case):
    _, _, bl = case
    N, NB, m, n, d = DIMS
    levels = build_levels(build_stage_plan(build_topology(N, NB, m, n, d)))
    K_l, Hinv_l, Acl_l = _factor_blocks(levels, bl["Qx2"], bl["Dab2"], bl["Ru2"], bl["Pterm2"],
                                        bl["A"], bl["B"], n, d, m, FIXED_ORDER)
    kff_l = _linear_blocks(levels, K_l, Hinv_l, Acl_l, bl["B"], bl["qx"], bl["qu"],
                           bl["qterm"], n, d, m, FIXED_ORDER)
    return levels, _forward_blocks(levels, K_l, Acl_l, bl["B"], kff_l, n, d, m, T, FIXED_ORDER)


@pytest.fixture(scope="module")
def ranks(case):
    return launch(R.tree_kkt_rank, 4, "gloo", "cpu", args=(case[2], DIMS, MESHES))


def _flat(levels_out):
    return torch.cat([b.reshape((-1,) + b.shape[2:]) for b in levels_out], dim=0)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}_mp{s[1]}")
def test_sharded_kkt_equals_unsharded(ranks, unsharded, shape):
    levels, (dx_ref, du_ref) = unsharded
    dp, mp = shape
    shards = level_sharding(levels, mp)
    assert shards == [mt.nb % mp == 0 and mt.nb >= mp for mt in levels]
    assert shards[0] is False and shards[-1] is True
    for rank, out in enumerate(ranks):
        got = out[shape]
        assert got["coords"] == (rank // mp, rank % mp)
        assert got["shards"] == shards
        dx_l, du_l = got["whole"]
        assert torch.equal(_flat(dx_l), dx_ref)
        assert torch.equal(_flat(du_l), du_ref)
        # each rank's local blocks: its T block, and its branch block where sharded
        i, j = got["coords"]
        tl = T // dp
        for loc, whole, sh in zip(got["local"][1], du_l, shards):
            ref = whole[..., i * tl:(i + 1) * tl]
            if sh:
                bl = ref.shape[0] // mp
                ref = ref[j * bl:(j + 1) * bl]
            assert torch.equal(loc, ref)


def test_unsharded_sweeps_match_jax(case, unsharded):
    jplan, jbl, _ = case
    _, (dx_ref, du_ref) = unsharded
    N, NB, m, n, d = DIMS
    jlevels = j_build_levels(jplan)

    def sweeps(bl):
        K_l, Hinv_l, Acl_l = j_factor(jlevels, bl["Qx2"], bl["Dab2"], bl["Ru2"], bl["Pterm2"],
                                      bl["A"], bl["B"], n, d, m, 0.0)
        kff_l = j_linear(jlevels, K_l, Hinv_l, Acl_l, bl["B"], bl["qx"], bl["qu"], bl["qterm"],
                         n, d, m)
        return j_forward(jlevels, K_l, Hinv_l, Acl_l, bl["B"], kff_l, n, d, m, jnp.float64, T)

    dx_j, du_j = jax.jit(sweeps, compiler_options=FAST_XLA)(jbl)
    assert np.abs(dx_ref.numpy() - np.asarray(dx_j)).max() < 1e-12
    assert np.abs(du_ref.numpy() - np.asarray(du_j)).max() < 1e-12


def test_dryrun_multichip_cpu():
    reports = dryrun_multichip(2, "gloo", "cpu")
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["backend"] == "gloo" and r["device"] == "cpu" and r["mesh"] == {"dp": 2}
        assert r["ipm"]["uPred_shape"] == [2, 97, 2] and r["ipm"]["feasible_frac"] >= 0.0
        assert r["cvar"]["uPred_shape"] == [2, 97, 2]
        assert r["launches"] == {"tree_qp_ipm_iter": 0, "cvar_ipm_iter": 0}
        assert "tree_kkt" not in r          # a 1-D mesh has no "mp" axis
    assert reports[0]["ipm"] == reports[1]["ipm"]
