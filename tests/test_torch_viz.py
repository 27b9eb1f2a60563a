"""The port's snapshots and animations (``envs/viz.py``) against the JAX
package's (Agg backend, no display):

- for the same scene (vehicles, the controller's branches from
  ``BT2array``, the road), the highway and merge snapshots draw the same
  artists: patch vertices, line data, colours and styles, to 1e-12 (the
  merge's ramp lines come from each package's own ``merge_geometry``);
- the highway, merge and quadruped animations render a few frames with
  Pillow, as ``tests/test_viz.py`` does, and their last frames draw what
  the JAX package's draw."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from matplotlib import animation as mpl_animation  # noqa: E402

from belief_planning_tpu.envs import viz as jviz  # noqa: E402

from belief_planning_tpu_torch.envs import viz  # noqa: E402
from belief_planning_tpu_torch.envs.highway import Vehicle  # noqa: E402
from belief_planning_tpu_torch.envs.quadruped import Robot  # noqa: E402

STEPS, NBR = 4, 3


class _Mpc:
    def __init__(self, branches):
        self.branches = branches

    def BT2array(self):
        return self.branches


class _Scene:
    """What the drawing functions read of an env: vehicles (or robots), the
    controller's ``BT2array`` and the road's layout."""

    def __init__(self, kind, rng):
        self.dt, self.N_lane = 0.1, 2
        self.merge_lane, self.merge_s, self.merge_R, self.merge_side = 1, 50, 300, 0
        theta = np.arccos(1 - 3.6 * self.merge_lane / self.merge_R)
        self.merge_end = self.merge_s + self.merge_R * np.sin(theta)
        if kind == "quad":
            self.robot_set = [Robot(np.array([0.0, 0.0, 0.1]), 0.2, L=0.5, W=0.3),
                              Robot(np.array([2.5, 2.5, -1.5]), 0.2, L=1.0, W=0.6)]
            self.dt = 0.2
        self.veh_set = [Vehicle(np.array([30.0, 5.4, 20.0, 0.05]), 0.1),
                        Vehicle(np.array([42.0, 1.8, 18.0, -0.02]), 0.1)]
        self.mpc = _Mpc(_branches(rng))


def _branches(rng, nx=4):
    xPred = [np.cumsum(rng.normal(0, 1, (9, nx)), axis=0) + [30, 5, 0, 0][:nx]
             for _ in range(NBR)]
    zPred = [np.cumsum(rng.normal(0, 1, (9, nx)), axis=0) + [42, 2, 0, 0][:nx]
             for _ in range(NBR)]
    return xPred, zPred, [rng.normal(0, 1, (8, 2)) for _ in range(NBR)], np.ones(NBR) / NBR


def _records(rng, nv=2, nx=4):
    state_rec = np.cumsum(rng.normal(0, 0.3, (nv, STEPS, nx)), axis=1) + [30, 3, 20, 0][:nx]
    xs = [_branches(rng, nx) for _ in range(STEPS)]
    return state_rec, [x[0] for x in xs], [x[1] for x in xs]


def _artists(ax):
    patches = [(p.get_verts(), p.get_facecolor(), p.get_alpha()) for p in ax.patches]
    lines = [(ln.get_xydata(), ln.get_color(), ln.get_linestyle(), ln.get_linewidth())
             for ln in ax.lines]
    return patches, lines, ax.get_xlim(), ax.get_ylim()


def _same(a, b):
    (pa, la, xa, ya), (pb, lb, xb, yb) = a, b
    assert len(pa) == len(pb) and len(la) == len(lb)
    for (va, ca, aa), (vb, cb, ab) in zip(pa, pb):
        assert np.abs(va - vb).max() < 1e-12 and ca == cb and aa == ab
    for (da, *sa), (db, *sb) in zip(la, lb):
        assert da.shape == db.shape and np.abs(da - db).max() < 1e-12 and sa == sb
    assert np.allclose(xa, xb, rtol=0, atol=1e-12) and np.allclose(ya, yb, rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", ["highway", "merge"])
def test_snapshot_draws_the_same_artists(which):
    draw = {"highway": (viz.plot_highway_snapshot, jviz.plot_highway_snapshot),
            "merge": (viz.plot_merge_snapshot, jviz.plot_merge_snapshot)}[which]
    scene = _Scene(which, np.random.default_rng(0))
    got = [_artists(fn(scene)) for fn in draw]
    plt.close("all")
    assert len(got[0][0]) >= 2 and len(got[0][1]) >= 3
    _same(*got)


@pytest.mark.parametrize("which", ["highway", "merge", "quadruped"])
def test_animation_renders_frames(which, tmp_path):
    rng = np.random.default_rng(1)
    nx = 3 if which == "quadruped" else 4
    scene = _Scene("quad" if which == "quadruped" else which, rng)
    state_rec, xPred_rec, zPred_rec = _records(rng, nx=nx)
    x_des = np.array([5.0, -3.0, 0.0])
    drawn = []
    for mod in (viz, jviz):
        if which == "quadruped":
            anim = mod.animate_quadruped(scene, state_rec, xPred_rec, zPred_rec, x_des, frames=3)
        else:
            anim = getattr(mod, f"animate_{which}")(scene, state_rec, xPred_rec, zPred_rec,
                                                    frames=3)
        out = tmp_path / f"{which}-{mod.__name__.split('.')[0]}.gif"
        anim.save(str(out), writer=mpl_animation.PillowWriter(fps=5))
        assert out.exists() and out.stat().st_size > 0
        drawn.append(_artists(anim._fig.axes[0]))
        plt.close("all")
    _same(*drawn)
