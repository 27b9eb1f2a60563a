"""Highway-merge geometry (the reference package's ``envs/merge.py``: the
on-ramp tables only; the closed-loop environment is not ported yet).

The ego starts on an on-ramp (a straight segment, then an arc) that joins the
main road; its reference line, as ``RefLine`` lookup tables over the ramp's X
coordinate, gives the per-lane shear transform ``S``, the reference state
and the lane bounds of the merge deployment (``envs/batched_merge.py``).
"""

from __future__ import annotations

import numpy as np

from belief_planning_tpu_torch.models.policies import RefLine

LANE_WIDTH = 3.6


def merge_geometry(N_lane, merge_lane, merge_s, merge_R, merge_side=0):
    """Ramp reference-line tables ``(X1, X2, Y1, Y2, psi1, psi2)``: the
    straight segment (1) and the arc (2), sampled every 0.5 m."""
    lw = LANE_WIDTH
    theta = np.arccos(1 - lw * merge_lane / merge_R)
    if merge_side == 0:
        arc_center = np.array([merge_s + merge_R * np.sin(theta),
                               (N_lane - merge_lane) * lw + merge_R])
        lane_start = np.array([merge_s - merge_s * np.cos(theta),
                               N_lane * lw + np.sin(theta) * merge_s])
    else:
        arc_center = np.array([merge_s + merge_R * np.sin(theta),
                               merge_lane * lw - merge_R])
        lane_start = np.array([merge_s - merge_s * np.cos(theta),
                               -np.sin(theta) * merge_s - lw * merge_lane])

    s1 = np.linspace(0, merge_s, num=int(merge_s / 0.5), endpoint=False)
    s2 = merge_s + np.linspace(0, merge_R * theta, num=int(merge_R * theta / 0.5))
    if merge_side == 0:
        X1 = lane_start[0] + s1 * np.cos(theta)
        Y1 = lane_start[1] - s1 * np.sin(theta)
        psi1 = -np.ones_like(s1) * theta
        psi2 = (s2 - s2[-1]) / merge_R
        X2 = arc_center[0] + np.sin(psi2) * merge_R
        Y2 = arc_center[1] - np.cos(psi2) * merge_R
    else:
        X1 = lane_start[0] + s1 * np.cos(theta)
        Y1 = lane_start[1] + s1 * np.sin(theta)
        psi1 = np.ones_like(s1) * theta
        psi2 = (s2[-1] - s2) / merge_R
        X2 = arc_center[0] - np.sin(psi2) * merge_R
        Y2 = arc_center[1] + np.cos(psi2) * merge_R - merge_lane * lw
    return X1, X2, Y1, Y2, psi1, psi2


def merge_ref_lines(N_lane, merge_lane, merge_s, merge_R, merge_side=0):
    """``(refY, refpsi)`` lookup tables over the ramp X coordinate (numpy knots)."""
    X1, X2, Y1, Y2, psi1, psi2 = merge_geometry(N_lane, merge_lane, merge_s, merge_R,
                                                merge_side)
    X = np.append(X1, X2)
    order = np.argsort(X)
    return (RefLine(xs=X[order], ys=np.append(Y1, Y2)[order]),
            RefLine(xs=X[order], ys=np.append(psi1, psi2)[order]))
