"""Highway demos: the overtake and the on-ramp merge, each one world on the
host with the nested-CVaR branch-MPC (the reference package's
``examples/main_branch.py``, the same scenario constants).

Run on the card: ``python -m belief_planning_tpu_torch.examples.main_branch
[overtake|merge]``; ``--device cpu`` runs on the CPU, ``--T`` sets the
simulated seconds, ``--seed`` the environment's generator, ``--animate``
writes ``overtake.mp4`` / ``merge.mp4`` (ffmpeg).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR
from belief_planning_tpu_torch.envs.highway import HighwayEnv, highway_sim
from belief_planning_tpu_torch.envs.merge import HighwayMergeEnv, merge_ref_lines
from belief_planning_tpu_torch.models.policies import highway_policy_set, merge_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model, merge_model
from belief_planning_tpu_torch.presets import init_branch_mpc
from belief_planning_tpu_torch.utils.config import BranchConstants


def sim_overtake(T=10.0, animate=False, seed=0, device=None):
    """The overtake (N=8, NB=2, ralpha=0.9), ``T`` seconds; returns
    ``highway_sim``'s records. ``device``: ``None`` = ``"cuda"``."""
    N, NB, n, d = 8, 2, 4, 2
    am, rm, dt, N_lane = 6.0, 0.3, 0.1, 4
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    cons = BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2,
                           am=am, rm=rm, J_c=20, s_c=1, ylb=0., yub=7.2,
                           L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    pset = highway_policy_set(cons, xRef)
    model = highway_model(cons, pset, N=N, dt=dt)
    params = init_branch_mpc(n, d, N, NB, xRef, am, rm, N_lane, cons.W)
    mpc = BranchMPCCVaR(params, model, pset.params, ralpha=0.9, dtype=torch.float32,
                        device=device)
    env = HighwayEnv(NV=2, mpc=mpc, cons=cons, lc_target=xRef, N_lane=N_lane, seed=seed)
    recs = highway_sim(env, T)
    state_rec, input_rec, *_, collision = recs
    print(f"overtake: {state_rec.shape[1]} steps, collision={collision}, "
          f"final ego X={state_rec[0, -1, 0]:.1f} m, obstacle X={state_rec[1, -1, 0]:.1f} m")
    if animate:
        from belief_planning_tpu_torch.envs.viz import animate_highway
        animate_highway(env, state_rec, recs[4], recs[5], output="overtake.mp4")
    return recs


def sim_merge(T=6.0, seed=0, animate=False, device=None):
    """The merge (N=40, NB=1, ralpha=0.1, the ramp's transform ``use_S``),
    ``T`` seconds; returns ``highway_sim``'s records."""
    N, NB, n, d = 40, 1, 4, 2
    am, rm, dt = 7.0, 0.3, 0.1
    N_lane, merge_lane, merge_s, merge_R, merge_side = 2, 1, 50, 300, 0
    v0 = 20.0
    cons = BranchConstants(am=am, rm=rm)
    refY, refpsi = merge_ref_lines(N_lane, merge_lane, merge_s, merge_R, merge_side)
    pset_normal = merge_policy_set(cons, v0, None)
    pset_merge = merge_policy_set(cons, v0, refpsi)
    model_normal = merge_model(cons, pset_normal, N=N, dt=dt)
    model_merge = merge_model(cons, pset_merge, N=N, dt=dt)
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    params = init_branch_mpc(n, d, N, NB, xRef, am, rm, N_lane, cons.W)
    mpc = BranchMPCCVaR(params, model_normal, pset_normal.params, ralpha=0.1, use_S=True,
                        dtype=torch.float32, device=device)
    env = HighwayMergeEnv(
        NV=2, N_lane=N_lane, mpc=mpc, models=[model_normal, model_merge],
        policy_param_sets=[pset_normal.params, pset_merge.params],
        merge_lane=merge_lane, merge_s=merge_s, merge_R=merge_R,
        merge_side=merge_side, dt=dt, cons=cons, seed=seed,
    )
    recs = highway_sim(env, T)          # the merge env has the same step / recorder API
    state_rec, *_, collision = recs
    print(f"merge: {state_rec.shape[1]} steps, collision={collision}, "
          f"final ego X={env.veh_set[0].state[0]:.1f} m, laneID={env.laneID[0]}")
    if animate:
        from belief_planning_tpu_torch.envs.viz import animate_merge
        animate_merge(env, state_rec, recs[4], recs[5], output="merge.mp4")
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="overtake", choices=("overtake", "merge"))
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--T", type=float, default=None,
                    help="simulated seconds (default: 10 overtake, 6 merge)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--animate", action="store_true")
    a = ap.parse_args(argv)
    sim = sim_merge if a.which == "merge" else sim_overtake
    kw = {} if a.T is None else {"T": a.T}
    sim(seed=a.seed, animate=a.animate, device=a.device, **kw)


if __name__ == "__main__":
    main()
