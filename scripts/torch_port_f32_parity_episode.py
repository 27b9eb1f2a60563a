"""Closed-loop parity episode on the card, the north-star measurement of
``BASELINE.md``: the port's counterpart of ``scripts/f32_parity_episode.py``.

Runs the demo overtake (N=8, NB=2, ``main_branch.py:24-48``) as a 100-step
closed loop at B=1 on ``make_branch_mpc_batched_step`` in several modes,
each driving its own trajectory from the same start:

- ``f64``: every state and the solve in f64, IPM-40 (K1's f64 build on the
  card): the reference loop;
- ``f32``: the bench config, K1 in f32 at IPM-8 with 2 Gondzio correctors;
- ``refine10`` / ``refine14``: f64 states, the IPM-8 solve in f32
  (``solve_dtype``) and a 10 / 14-iteration f64 restart through K1's f64
  build (``refine_f64``): the parity-grade modes.

Each mode runs self-driven (``closed_loop``: its own trajectory, so genuine
decision forks of the receding-horizon loop count), teacher-forced on the
f64 loop's states (``teacher_forced``, the reference script's series: each
step still re-linearizes around the mode's own warm start, so a warm start
1e-7 off can fork where the linearization sits at a tie) and, beyond the
reference script, teacher-forced on the f64 loop's states and warm starts
(``teacher_forced_warm``: both solve the same QP, the per-step solver
accuracy). Reports the max and median per-step deviation of the applied
input from the f64 loop, the step where it first passes 1e-3, the gate
``< 1e-3``,
the median time of a step (to the input on the host) against dt = 0.1 s,
and K1's launches; a control runs the f64 loop against itself from a start
moved by 1e-9 (the metric's floor at the loop's decision forks).

    python scripts/torch_port_f32_parity_episode.py [--device cuda|cpu]

``--device`` defaults to the CUDA card. Env, as the reference script's:
EP_STEPS (100), EP_CONTROL (1), EP_MODES (all: f32,refine10,refine14); and
EP_N, EP_NB (the tree's N and NB, the demo's 8 and 2; smaller for a quick
run). Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from belief_planning_tpu_torch.controllers.branch_mpc import (  # noqa: E402
    make_branch_mpc_batched_step,
)
from belief_planning_tpu_torch.models.policies import highway_policy_set  # noqa: E402
from belief_planning_tpu_torch.models.predictive import highway_model  # noqa: E402
from belief_planning_tpu_torch.presets import init_branch_mpc  # noqa: E402
from belief_planning_tpu_torch.solvers import tree_qp_pl  # noqa: E402
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig  # noqa: E402
from belief_planning_tpu_torch.utils.config import BranchConstants  # noqa: E402
from belief_planning_tpu_torch.utils.device import resolve_device  # noqa: E402

F32, F64 = torch.float32, torch.float64
DT = 0.1
XREF = np.array([0.5, 1.8, 15.0, 0.0])
X0 = np.array([0.0, 1.8, 20.0, 0.0])
Z0 = np.array([9.0, 1.8, 17.0, 0.0])
# name: (state dtype, IPM config, f64 restart iterations, solve dtype)
MODES = {
    "f32": (F32, QPIPMConfig(iters=8, gondzio=2), 0, None),
    "refine10": (F64, QPIPMConfig(iters=8, gondzio=2), 10, F32),
    "refine14": (F64, QPIPMConfig(iters=8, gondzio=2), 14, F32),
}
REFERENCE = (F64, QPIPMConfig(iters=40), 0, None)


def demo(N=8, NB=2):
    """The demo overtake: ``(cons, pset, model, params)``."""
    cons = BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                           J_c=20, s_c=1, ylb=0.0, yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    pset = highway_policy_set(cons, XREF)
    model = highway_model(cons, pset, N=N, dt=DT)
    params = init_branch_mpc(4, 2, N, NB, XREF, 6.0, 0.3, 4, cons.W)
    return cons, pset, model, params


def world_step(x, z, u, Kpsi):
    """The demo's Euler step of the ego (input u) and the obstacle (holding
    speed, heading to 0)."""
    x = x + np.array([x[2] * np.cos(x[3]), x[2] * np.sin(x[3]), u[0], u[1]]) * DT
    z = z + np.array([z[2] * np.cos(z[3]), z[2] * np.sin(z[3]), 0.0, -Kpsi * z[3]]) * DT
    return x, z


def make_episode(make_step, pset, Kpsi, steps, device, x0=X0, z0=Z0):
    """``episode(mode, forced_states=None, forced_carries=None, x0_shift=0.0)
    -> (us, times, states, carries)``: ``steps`` receding-horizon steps of
    one world at B=1 through the step ``make_step(mode)`` builds; with
    ``forced_states`` each step solves from the given (x, z) instead of its
    own trajectory, with ``forced_carries`` from the given warm start
    (``carries``: the warm start each step began from)."""
    dev = resolve_device(device)

    def episode(mode, forced_states=None, forced_carries=None, x0_shift=0.0):
        dtype = mode[0]
        init_carry, step = make_step(mode)
        carry = init_carry(1, dtype)
        t = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=dtype, device=dev)
        x, z = x0 + x0_shift, z0.copy()
        us, times, states, carries = [], [], [], []
        for k in range(steps):
            if forced_states is not None:
                x, z = forced_states[k]
            if forced_carries is not None:
                carry = type(carry)(*(a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                                      else a for a in forced_carries[k]))
            states.append((x.copy(), z.copy()))
            carries.append(carry)
            t0 = time.perf_counter()
            carry, res = step(carry, t(x), t(z), t(XREF), pset.params)
            u = res.uPred[0, 0].double().cpu().numpy()
            times.append(time.perf_counter() - t0)
            us.append(u.copy())
            x, z = world_step(x, z, u, Kpsi)
        return np.asarray(us), np.asarray(times[1:]), states, carries

    return episode


def deviation(u, u_ref):
    """The reference script's per-series summary of |u − u_ref|."""
    d = np.abs(u - u_ref)
    over = d.max(axis=1) > 1e-3
    return {"max_dev": float(d.max()), "p50_dev": float(np.median(d)),
            "fork_step": int(np.argmax(over)) if bool(over.any()) else None,
            "gate_1e-3": bool(d.max() < 1e-3)}


def mode_results(episode, mode, ref, count):
    """One mode's three series against the f64 loop ``ref = (us, states,
    carries)``, its step time and its launches over the three runs."""
    u64, states64, carries64 = ref
    u, t, _, _ = episode(mode)
    uf = episode(mode, forced_states=states64)[0]
    uw = episode(mode, forced_states=states64, forced_carries=carries64)[0]
    return {"closed_loop": deviation(u, u64), "teacher_forced": deviation(uf, u64),
            "teacher_forced_warm": deviation(uw, u64), "p50_ms": float(np.median(t)) * 1e3,
            "rt_budget_ok": bool(np.median(t) <= DT), "launches": count()}


def parity_episodes(device=None, steps=100, modes=None, control=True, kernel=None, N=8, NB=2):
    """The episodes of every mode against the f64 loop: a dict of the
    reference script's results, each mode with its K1 launches
    (``kernel.launches`` counted over its three runs; None without ``kernel``)."""
    cons, pset, model, params = demo(N, NB)
    dev = resolve_device(device)

    def make_step(mode):
        _, ipm, refine, sd = mode
        _, init_carry, step = make_branch_mpc_batched_step(model, params, "prox", ipm=ipm,
                                                           refine_f64=refine, solve_dtype=sd,
                                                           device=dev)
        return init_carry, step

    episode = make_episode(make_step, pset, cons.Kpsi, steps, dev)
    count = lambda: None if kernel is None else kernel.launches
    if kernel is not None:
        kernel.launches = 0
    u64, t64, states64, carries64 = episode(REFERENCE)
    out = {"steps": steps, "f64_ref_p50_ms": float(np.median(t64)) * 1e3,
           "f64_ref_launches": count()}
    if control:
        up = episode(REFERENCE, x0_shift=1e-9)[0]
        out["f64_selfperturbed_1e-9"] = {"closed_loop": deviation(up, u64)}
    for tag in (modes or list(MODES)):
        if kernel is not None:
            kernel.launches = 0
        out[tag] = mode_results(episode, MODES[tag], (u64, states64, carries64), count)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sel = os.environ.get("EP_MODES")
    res = parity_episodes(dev, int(os.environ.get("EP_STEPS", "100")),
                          sel.split(",") if sel else None,
                          os.environ.get("EP_CONTROL", "1") != "0",
                          tree_qp_pl.KERNEL if dev.type == "cuda" else None,
                          int(os.environ.get("EP_N", "8")), int(os.environ.get("EP_NB", "2")))
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"metric": "closed_loop_parity_overtake", "device": card, **res}))


if __name__ == "__main__":
    main()
