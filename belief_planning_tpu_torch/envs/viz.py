"""Snapshots and animations of closed-loop episodes (the reference
package's ``envs/viz.py``): rotated vehicle patches, the ego's prediction
tree coloured by branch, the obstacle's dashed tree, lane lines and, for the
merge, the ramp's lines from ``envs/merge.merge_geometry``; ffmpeg export.

Host-side NumPy and matplotlib only (imported inside the functions), not a
performance path: the controllers' ``BT2array`` already returns NumPy
arrays. The y axis is drawn negated, as the reference draws it.
"""

from __future__ import annotations

import numpy as np

LANE_WIDTH = 3.6
_COLORS = [
    "tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
    "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan",
    "y", "m", "c", "g",
]


def _require_mpl():
    import matplotlib
    import matplotlib.pyplot as plt
    return matplotlib, plt


def plot_highway_snapshot(env, ax=None, idx=None):
    """Snapshot of a highway episode state with the current prediction tree
    (reference ``plot_snapshot``)."""
    matplotlib, plt = _require_mpl()
    if ax is None:
        fig = plt.figure(figsize=(10, 3))
        ax = fig.add_subplot(111)
    ego = env.veh_set[0]
    ego_x, ego_y = ego.state[0], ego.state[1]
    ax.set_xlim(ego_x - 10, ego_x + 40)
    ax.set_ylim(-(ego_y + 10), -(ego_y - 5))
    ts = ax.transData
    for i, veh in enumerate(env.veh_set):
        patch = plt.Rectangle(
            (veh.state[0] - veh.v_length / 2, -veh.state[1] - veh.v_width / 2),
            veh.v_length, veh.v_width, fc=("r" if i == 0 else "b"), zorder=0,
        )
        coords = ts.transform([veh.state[0], -veh.state[1]])
        tr = matplotlib.transforms.Affine2D().rotate_around(coords[0], coords[1], -veh.state[3])
        patch.set_transform(ts + tr)
        ax.add_patch(patch)
    xPred, zPred, uPred, w = env.mpc.BT2array()
    if idx is None:
        idx = range(len(zPred))
    for j in idx:
        ax.plot(xPred[j][:, 0], -xPred[j][:, 1], "--", color=_COLORS[j % len(_COLORS)], lw=1)
        ax.plot(zPred[j][:, 0], -zPred[j][:, 1], "m--", lw=1)
    lm = np.arange(0, env.N_lane + 1) * LANE_WIDTH
    ax.plot([ego_x - 60, ego_x + 80], [-lm[0]] * 2, "g", lw=2)
    for j in range(1, env.N_lane):
        ax.plot([ego_x - 60, ego_x + 80], [-lm[j]] * 2, "g--", lw=1)
    ax.plot([ego_x - 60, ego_x + 80], [-lm[env.N_lane]] * 2, "g", lw=2)
    return ax


def animate_highway(env, state_rec, xPred_rec, zPred_rec, output=None, interval=50,
                    frames=None):
    """Animate a recorded highway episode (reference ``animate_scenario``).

    ``output``: optional .mp4 path (ffmpeg writer). ``frames``: cap the frame
    count (tests animate a few frames without writing a full movie)."""
    matplotlib, plt = _require_mpl()
    if output:
        matplotlib.use("Agg")
    from matplotlib import animation

    fig = plt.figure(figsize=(10, 4))
    ax = fig.add_subplot(111)
    nframe = state_rec.shape[1] if frames is None else min(frames, state_rec.shape[1])
    NV = state_rec.shape[0]
    lm = np.arange(0, env.N_lane + 1) * LANE_WIDTH

    def animate(t):
        ax.clear()
        ego_x, ego_y = state_rec[0][t][0], state_rec[0][t][1]
        ax.set_xlim(ego_x - 10, ego_x + 40)
        ax.set_ylim(-(ego_y + 10), -(ego_y - 10))
        ts = ax.transData
        for i in range(NV):
            st = state_rec[i][t]
            veh = env.veh_set[i]
            patch = plt.Rectangle(
                (st[0] - veh.v_length / 2, -st[1] - veh.v_width / 2),
                veh.v_length, veh.v_width, fc=("r" if i == 0 else "b"), zorder=0,
            )
            coords = ts.transform([st[0], -st[1]])
            tr = matplotlib.transforms.Affine2D().rotate_around(coords[0], coords[1], -st[3])
            patch.set_transform(ts + tr)
            ax.add_patch(patch)
        if xPred_rec[t] is not None:
            for j in range(len(xPred_rec[t])):
                ax.plot(xPred_rec[t][j][:, 0], -xPred_rec[t][j][:, 1], "b--", lw=1)
            for j in range(len(zPred_rec[t])):
                ax.plot(zPred_rec[t][j][:, 0], -zPred_rec[t][j][:, 1], "r--", lw=1)
        ax.plot([ego_x - 60, ego_x + 80], [-lm[0]] * 2, "g", lw=2)
        for j in range(1, env.N_lane):
            ax.plot([ego_x - 60, ego_x + 80], [-lm[j]] * 2, "g--", lw=1)
        ax.plot([ego_x - 60, ego_x + 80], [-lm[env.N_lane]] * 2, "g", lw=2)
        return []

    anim = animation.FuncAnimation(fig, animate, frames=nframe, interval=interval,
                                   blit=False, repeat=False)
    if output:
        writer = animation.writers["ffmpeg"](fps=int(1 / env.dt), bitrate=1800)
        anim.save(output, writer=writer)
    else:
        plt.show()
    return anim


def _draw_merge_lanes(ax, env):
    """Ramp + main-road lane lines for a merge scene (reference
    ``Highway_env_branch.py:660-688``): solid outer edges, dashed interior
    lanes, the main-road edge broken over [merge_s, merge_end] where the ramp
    joins, and the ramp reference lines (straight portion + arc portion) from
    the same geometry tables the controller's S/bx overrides use."""
    from belief_planning_tpu_torch.envs.merge import LANE_WIDTH as LW, merge_geometry

    X1, X2, Y1, Y2, _, _ = merge_geometry(
        env.N_lane, env.merge_lane, env.merge_s, env.merge_R, env.merge_side)
    lm = np.arange(0, env.N_lane + 1) * LW
    if env.merge_side == 0:
        # ramp joins from above: bottom edge continuous, top edge broken
        ax.plot([-10, 1000], [-lm[0]] * 2, "g", lw=2)
        for j in range(1, env.N_lane):
            ax.plot([-10, 1000], [-lm[j]] * 2, "g--", lw=1)
        ax.plot([-10, env.merge_s], [-lm[env.N_lane]] * 2, "g", lw=2)
        ax.plot([env.merge_end, 1000], [-lm[env.N_lane]] * 2, "g", lw=2)
        ax.plot(X1, -Y1, "g", lw=2)
        ax.plot(X2, -Y2, "g--", lw=1)
        for j in range(1, env.merge_lane):
            ax.plot(X1, -Y1 - j * LW, "g--", lw=1)
            ax.plot(X2, -Y2 - j * LW, "g--", lw=1)
        X = np.append(X1, X2)
        Y = np.append(Y1, Y2)
        ax.plot(X, -Y - env.merge_lane * LW, "g", lw=2)
    else:
        # ramp joins from below
        ax.plot([-10, 1000], [-lm[env.N_lane]] * 2, "g", lw=2)
        for j in range(1, env.N_lane):
            ax.plot([-10, 1000], [-lm[j]] * 2, "g--", lw=1)
        ax.plot([-10, env.merge_s], [-lm[0]] * 2, "g", lw=2)
        ax.plot([env.merge_end, 1000], [-lm[0]] * 2, "g", lw=2)
        ax.plot(X1, -Y1, "g", lw=2)
        ax.plot(X2, -Y2, "g", lw=2)
        for j in range(1, env.merge_lane):
            ax.plot(X1, -Y1 - j * LW, "g--", lw=1)
            ax.plot(X2, -Y2 - j * LW, "g--", lw=1)
        X = np.append(X1, X2)
        Y = np.append(Y1, Y2)
        ax.plot(X, -Y - env.merge_lane * LW, "g", lw=2)


def _draw_pred_pose_patches(ax, matplotlib, plt, traj, length, width, color):
    """Semi-transparent predicted-pose rectangles along one predicted branch
    (reference ``Highway_env_branch.py:646-653``: every other horizon step)."""
    ts = ax.transData
    for k in range(traj.shape[0]):
        if k % 2 == 1:
            patch = plt.Rectangle(
                (traj[k, 0] - length / 2, -traj[k, 1] - width / 2),
                length, width, fc=color, alpha=0.3, zorder=0)
            coords = ts.transform([traj[k, 0], -traj[k, 1]])
            tr = matplotlib.transforms.Affine2D().rotate_around(
                coords[0], coords[1], -traj[k, 3])
            patch.set_transform(ts + tr)
            ax.add_patch(patch)


def plot_merge_snapshot(env, ax=None, idx=None):
    """Snapshot of a merge episode with the prediction tree, ramp lane lines
    and predicted-pose patches (merge mode of the reference ``animate_scenario``
    applied to one frame)."""
    matplotlib, plt = _require_mpl()
    if ax is None:
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111)
    ego = env.veh_set[0]
    ego_x = ego.state[0]
    # fixed merge viewport (Highway_env_branch.py:614-618)
    ax.set_xlim(ego_x - 5, ego_x + 45)
    ax.set_ylim(-35, 5)
    ts = ax.transData
    for i, veh in enumerate(env.veh_set):
        patch = plt.Rectangle(
            (veh.state[0] - veh.v_length / 2, -veh.state[1] - veh.v_width / 2),
            veh.v_length, veh.v_width, fc=("r" if i == 0 else "b"), zorder=0,
        )
        coords = ts.transform([veh.state[0], -veh.state[1]])
        tr = matplotlib.transforms.Affine2D().rotate_around(
            coords[0], coords[1], -veh.state[3])
        patch.set_transform(ts + tr)
        ax.add_patch(patch)
    xPred, zPred, uPred, w = env.mpc.BT2array()
    if idx is None:
        idx = range(len(zPred))
    for j in idx:
        ax.plot(xPred[j][:, 0], -xPred[j][:, 1], "b--", lw=1)
        _draw_pred_pose_patches(ax, matplotlib, plt, xPred[j], ego.v_length,
                                ego.v_width, _COLORS[j % len(_COLORS)])
        ax.plot(zPred[j][:, 0], -zPred[j][:, 1], "r--", lw=1)
    _draw_merge_lanes(ax, env)
    return ax


def animate_merge(env, state_rec, xPred_rec, zPred_rec, output=None,
                  interval=50, frames=None):
    """Animate a recorded merge episode: fixed viewport, ramp lane lines from
    the ref-line geometry, alpha predicted-pose patches (merge mode of the
    reference ``animate_scenario``, ``Highway_env_branch.py:608-709``).

    ``state_rec``: (NV, T, 4); ``xPred_rec``/``zPred_rec``: per-step lists of
    per-branch predicted trajectories (as recorded by the sim driver).
    ``output``: optional .mp4 path (ffmpeg writer). ``frames``: cap frames."""
    matplotlib, plt = _require_mpl()
    if output:
        matplotlib.use("Agg")
    from matplotlib import animation

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111)
    nframe = state_rec.shape[1] if frames is None else min(frames, state_rec.shape[1])
    NV = state_rec.shape[0]
    ego_len = env.veh_set[0].v_length
    ego_w = env.veh_set[0].v_width

    def animate(t):
        ax.clear()
        ax.grid(True)
        ego_x = state_rec[0][t][0]
        ax.set_xlim(ego_x - 5, ego_x + 45)
        ax.set_ylim(-35, 5)
        ts = ax.transData
        for i in range(NV):
            st = state_rec[i][t]
            veh = env.veh_set[i]
            patch = plt.Rectangle(
                (st[0] - veh.v_length / 2, -st[1] - veh.v_width / 2),
                veh.v_length, veh.v_width, fc=("r" if i == 0 else "b"),
                zorder=0,
            )
            coords = ts.transform([st[0], -st[1]])
            tr = matplotlib.transforms.Affine2D().rotate_around(
                coords[0], coords[1], -st[3])
            patch.set_transform(ts + tr)
            ax.add_patch(patch)
        if xPred_rec[t] is not None:
            for j in range(len(xPred_rec[t])):
                ax.plot(xPred_rec[t][j][:, 0], -xPred_rec[t][j][:, 1],
                        "b--", lw=1)
                _draw_pred_pose_patches(ax, matplotlib, plt, xPred_rec[t][j],
                                        ego_len, ego_w,
                                        _COLORS[j % len(_COLORS)])
            for j in range(len(zPred_rec[t])):
                ax.plot(zPred_rec[t][j][:, 0], -zPred_rec[t][j][:, 1],
                        "r--", lw=1)
        _draw_merge_lanes(ax, env)
        return []

    anim = animation.FuncAnimation(fig, animate, frames=nframe,
                                   interval=interval, blit=False, repeat=False)
    if output:
        writer = animation.writers["ffmpeg"](fps=int(1 / env.dt), bitrate=1800)
        anim.save(output, writer=writer)
    return anim


def animate_quadruped(env, state_rec, xPred_rec, zPred_rec, x_des, output=None,
                      frames=None):
    """Animate a recorded quadruped episode (reference ``quadruped_env.py:243``)."""
    matplotlib, plt = _require_mpl()
    if output:
        matplotlib.use("Agg")
    from matplotlib import animation, patches

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111)
    nframe = state_rec.shape[1] if frames is None else min(frames, state_rec.shape[1])
    NR = state_rec.shape[0]

    def animate(t):
        ax.clear()
        ax.grid()
        ax.set_xlim(-10, 10)
        ax.set_ylim(-10, 10)
        ax.add_patch(patches.Circle((x_des[0], x_des[1]), radius=0.3, fill=False, ec="c"))
        ts = ax.transData
        for i in range(NR):
            st = state_rec[i][t]
            rob = env.robot_set[i]
            patch = plt.Rectangle(
                (st[0] - rob.L / 2, st[1] - rob.W / 2), rob.L, rob.W,
                fc=("r" if i == 0 else "b"), zorder=0,
            )
            coords = ts.transform([st[0], st[1]])
            tr = matplotlib.transforms.Affine2D().rotate_around(coords[0], coords[1], st[2])
            patch.set_transform(ts + tr)
            ax.add_patch(patch)
        if xPred_rec[t] is not None:
            for j in range(len(xPred_rec[t])):
                ax.plot(xPred_rec[t][j][:, 0], xPred_rec[t][j][:, 1], "b--", lw=1)
            for j in range(len(zPred_rec[t])):
                ax.plot(zPred_rec[t][j][:, 0], zPred_rec[t][j][:, 1], "r--", lw=1)
        return []

    anim = animation.FuncAnimation(fig, animate, frames=nframe,
                                   interval=env.dt * 1000, blit=False, repeat=False)
    if output:
        writer = animation.writers["ffmpeg"](fps=int(1 / env.dt), bitrate=1800)
        anim.save(output, writer=writer)
    else:
        plt.show()
    return anim
