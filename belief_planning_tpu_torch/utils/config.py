"""Configuration dataclasses (numpy), copied from the reference package's
``utils/config.py``.

``BranchConstants`` holds the static scenario constants; ``BranchMPCParams``
the controller's weights and constraint polytopes. Reference behaviours kept:
``Qf`` defaults to ``Q``; ``Qslack = [quadratic, linear]`` as the reference uses
it; a ``bx`` wrapped in a 1-tuple is unwrapped.
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


def _as_array(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    return np.asarray(np.squeeze(np.asarray(x, dtype=np.float64)))


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
        if isinstance(self.bx, tuple):  # reference trailing-comma quirk
            self.bx = self.bx[0]
        for name in ("Q", "R", "Qf", "dR", "Qslack", "bx", "bu", "xRef"):
            setattr(self, name, _as_array(getattr(self, name)))
        for name in ("Fx", "Fu"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, np.asarray(v, dtype=np.float64))
        if self.Qf is None and self.Q is not None:
            self.Qf = np.array(self.Q)
        if self.dR is None:
            self.dR = np.zeros(self.d)
        if self.xRef is None:
            self.xRef = np.zeros(self.n)
        if self.bx is not None:
            self.bx = np.atleast_1d(self.bx)
        if self.bu is not None:
            self.bu = np.atleast_1d(self.bu)

    def replace(self, **kw) -> "BranchMPCParams":
        return dataclasses.replace(self, **kw)
