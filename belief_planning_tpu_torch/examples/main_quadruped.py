"""Quadruped demo: a two-robot world, the ego running ``BranchMPCProx``
toward a goal against a pedestrian-like robot with forward / stop backups
(the reference package's ``examples/main_quadruped.py``, the same
constants).

Run on the card: ``python -m belief_planning_tpu_torch.examples.main_quadruped
[default|ros]``; ``ros`` reproduces the ROS variant's reference (T = 14 s,
else 40 s); ``--device cpu`` runs on the CPU, ``--T`` sets the simulated
seconds, ``--animate`` writes ``quadruped.mp4`` (ffmpeg).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx
from belief_planning_tpu_torch.envs.quadruped import QuadEnv, robot_sim
from belief_planning_tpu_torch.models.policies import quadruped_policy_set
from belief_planning_tpu_torch.models.predictive import quadruped_model
from belief_planning_tpu_torch.presets import init_quad_branch_mpc
from belief_planning_tpu_torch.utils.config import QuadConstants


def main(T=40.0, ref_mode="default", animate=False, device=None):
    """``T`` seconds of the quadruped world (N=25, NB=2, dt = 0.2);
    returns ``robot_sim``'s records. ``device``: ``None`` = ``"cuda"``."""
    dt, NB = 0.2, 2
    vxm, vym, rm, v0 = 0.2, 0.1, 0.5, 0.2
    n, d, N = 3, 3, 25
    cons = QuadConstants(s1=2, s2=3, c2=0.5, alpha=1, R=1.2, vxm=vxm, vym=vym,
                         rm=rm, L1=0.5, W1=0.3, L2=1.0, W2=0.6, col_tol=0.2,
                         col_alpha=5)
    pset = quadruped_policy_set(v0)
    model = quadruped_model(cons, pset, N=N, dt=dt)
    xRef = np.array([5., 5., 0.])
    params = init_quad_branch_mpc(n, d, N, NB, xRef, vxm, vym, rm)
    mpc = BranchMPCProx(params, model, pset.params, dtype=torch.float32, device=device)
    x_des = np.array([5., -3., 0.])
    env = QuadEnv(NR=2, mpc=mpc, x_des=x_des, cons=cons, ref_mode=ref_mode)
    recs = robot_sim(env, T)
    state_rec = recs[0]
    dist = np.linalg.norm(state_rec[0, -1, :2] - x_des[:2])
    print(f"quadruped ({ref_mode}): {state_rec.shape[1]} steps, "
          f"final distance to goal {dist:.2f} m")
    if animate:
        from belief_planning_tpu_torch.envs.viz import animate_quadruped
        animate_quadruped(env, state_rec, recs[4], recs[5], x_des, output="quadruped.mp4")
    return recs


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref_mode", nargs="?", default="default", choices=("default", "ros"))
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--T", type=float, default=None,
                    help="simulated seconds (default: 14 ros, 40 default)")
    ap.add_argument("--animate", action="store_true")
    a = ap.parse_args(argv)
    T = a.T if a.T is not None else (14.0 if a.ref_mode == "ros" else 40.0)
    main(T=T, ref_mode=a.ref_mode, animate=a.animate, device=a.device)


if __name__ == "__main__":
    cli()
