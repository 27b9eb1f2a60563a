"""Configuration dataclasses (numpy), copied from the reference package's
``utils/config.py``.

``BranchConstants``, ``QuadConstants`` and ``HMMConstants`` hold the static
scenario constants of the highway, the quadruped and the HMM belief model;
``BranchMPCParams`` and ``MPCParams`` (the HMM controller's) the controllers'
weights and constraint polytopes. Reference behaviours kept:
``BranchMPCParams.Qf`` defaults to ``Q`` and ``MPCParams.Qf`` to zeros;
``Qslack = [quadratic, linear]`` as the reference uses it; a ``bx`` wrapped in
a 1-tuple is unwrapped.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class BranchConstants:
    """Branch prediction / collision / vehicle-model constants."""

    s1: float = 2.0          # branch-probability temperature
    s2: float = 3.0          # HMM observation-weight temperature
    c2: float = 0.5          # HMM observation-weight offset
    tran_diag: float = 0.3   # HMM transition-matrix diagonal boost
    alpha: float = 1.0       # CBF decay rate
    R: float = 1.2           # obstacle radius (legacy HMM cost)
    am: float = 6.0          # max acceleration magnitude
    rm: float = 0.3          # max steering rate magnitude
    J_c: float = 20.0        # legacy obstacle-cost magnitude
    s_c: float = 1.0         # legacy obstacle-cost sharpness
    ylb: float = 0.0         # road lower boundary
    yub: float = 7.2         # road upper boundary
    L: float = 4.0           # vehicle length
    W: float = 2.5           # vehicle width
    col_alpha: float = 5.0   # collision softmax sharpness
    Kpsi: float = 0.1        # heading P-gain for maintain/brake policies


@dataclass(frozen=True)
class QuadConstants:
    """Quadruped constants (the reference's ``Quad_constants``)."""

    s1: float = 2.0
    s2: float = 3.0
    c2: float = 0.5
    alpha: float = 1.0
    R: float = 1.2
    vxm: float = 0.2         # max body-frame forward velocity
    vym: float = 0.1         # max body-frame lateral velocity
    rm: float = 0.5          # max yaw rate
    W1: float = 0.3          # ego body width
    L1: float = 0.5          # ego body length
    W2: float = 0.6          # obstacle body width
    L2: float = 1.0          # obstacle body length
    col_tol: float = 0.2     # collision margin tolerance
    col_alpha: float = 5.0


@dataclass(frozen=True)
class HMMConstants:
    """Constants of the HMM belief model (its transition temperature ``s1``,
    observation weight ``s2``/``c2``, transition diagonal, CBF rate, input
    bounds, road bounds, vehicle size and collision sharpness)."""

    s1: float = 2.0
    s2: float = 3.0
    c2: float = 0.5
    tran_diag: float = 0.3
    alpha: float = 1.0
    R: float = 1.2
    am: float = 6.0
    rm: float = 0.3
    J_c: float = 20.0
    s_c: float = 1.0
    ylb: float = 0.0
    yub: float = 7.2
    L: float = 4.0
    W: float = 2.4
    col_alpha: float = 5.0
    Kpsi: float = 0.1


def _as_array(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    return np.asarray(np.squeeze(np.asarray(x, dtype=np.float64)))


def _normalize(p, qf_default):
    """Arrays as f64 numpy, ``bx`` unwrapped from the reference's 1-tuple,
    ``Qf = qf_default(Q)`` when unset, zero ``dR`` and ``xRef`` when unset."""
    if isinstance(p.bx, tuple):  # reference trailing-comma quirk
        p.bx = p.bx[0]
    for name in ("Q", "R", "Qf", "dR", "Qslack", "bx", "bu", "xRef"):
        setattr(p, name, _as_array(getattr(p, name)))
    for name in ("Fx", "Fu"):
        v = getattr(p, name)
        if v is not None:
            setattr(p, name, np.asarray(v, dtype=np.float64))
    if p.Qf is None and p.Q is not None:
        p.Qf = qf_default(p.Q)
    if p.dR is None:
        p.dR = np.zeros(p.d)
    if p.xRef is None:
        p.xRef = np.zeros(p.n)
    if p.bx is not None:
        p.bx = np.atleast_1d(p.bx)
    if p.bu is not None:
        p.bu = np.atleast_1d(p.bu)


@dataclass
class BranchMPCParams:
    """Branch-MPC controller parameters.

    ``n, d, N, NB`` are static (they fix the tree and the kernel's shapes); the
    arrays are numeric parameters.
    """

    n: int = 4
    d: int = 2
    N: int = 8
    NB: int = 2

    Q: np.ndarray = None
    R: np.ndarray = None
    Qf: np.ndarray = None
    dR: np.ndarray = None
    Qslack: np.ndarray = None
    Fx: np.ndarray = None
    bx: np.ndarray = None
    Fu: np.ndarray = None
    bu: np.ndarray = None
    xRef: np.ndarray = None

    slacks: bool = True
    timeVarying: bool = False

    def __post_init__(self):
        _normalize(self, qf_default=np.array)

    def replace(self, **kw) -> "BranchMPCParams":
        return dataclasses.replace(self, **kw)


@dataclass
class MPCParams:
    """The HMM belief controller's parameters over the belief-augmented
    state (``n = nx + M·m``). ``Qf`` defaults to zeros, unlike
    :class:`BranchMPCParams`."""

    n: int = 4
    d: int = 2
    N: int = 10
    M: int = 1               # number of uncontrolled agents
    m: int = 2               # number of backup policies

    Q: np.ndarray = None
    R: np.ndarray = None
    Qf: np.ndarray = None
    dR: np.ndarray = None
    Qslack: np.ndarray = None
    Fx: np.ndarray = None
    bx: np.ndarray = None
    Fu: np.ndarray = None
    bu: np.ndarray = None
    xRef: np.ndarray = None

    slacks: bool = True
    timeVarying: bool = False

    def __post_init__(self):
        _normalize(self, qf_default=np.zeros_like)

    def replace(self, **kw) -> "MPCParams":
        return dataclasses.replace(self, **kw)
