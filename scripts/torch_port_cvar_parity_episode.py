"""Closed-loop parity episode of the nested-CVaR controller on the card: the
port's counterpart of ``scripts/cvar_parity_episode.py``.

The CVaR analogue of ``torch_port_f32_parity_episode.py``: the demo
overtake (N=8, NB=2, ralpha 0.9) as a 100-step closed loop at B=1 on
``make_cvar_mpc_batched_step`` in three modes:

- ``f64``: every state and the solve in f64, IPM-40 with 2 Gondzio
  correctors (K2's f64 build on the card): the reference loop;
- ``f32``: K2 in f32 at the bench config, IPM-24 with 2 correctors;
- ``refine10``: f64 states, the IPM-24 solve in f32 (``solve_dtype``) and
  a 10-iteration f64 restart through K2's f64 build: the parity-grade mode.

Each mode runs self-driven, teacher-forced on the f64 loop's states (the
reference script's series) and on its states and warm starts
(``teacher_forced_warm``, the per-step solver accuracy); reports the max
and median per-step deviation of the applied input from the f64 loop, the
gate ``< 1e-3``, the median step time against dt = 0.1 s and K2's launches.

    python scripts/torch_port_cvar_parity_episode.py [--device cuda|cpu]

``--device`` defaults to the CUDA card. Env, as the reference script's:
EP_STEPS (100), EP_MODES (all: f32,refine10); and EP_N, EP_NB (the tree's
N and NB, the demo's 8 and 2; smaller for a quick run). Prints one JSON
line.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step  # noqa
from belief_planning_tpu_torch.solvers import cvar_pl  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from belief_planning_tpu_torch.utils.device import resolve_device  # noqa: E402
from torch_port_f32_parity_episode import demo, make_episode, mode_results  # noqa: E402

F32, F64 = torch.float32, torch.float64
# name: (state dtype, IPM config, f64 restart iterations, solve dtype)
MODES = {
    "f32": (F32, CVaRIPMConfig(iters=24, gondzio=2), 0, None),
    "refine10": (F64, CVaRIPMConfig(iters=24, gondzio=2), 10, F32),
}
REFERENCE = (F64, CVaRIPMConfig(iters=40, gondzio=2), 0, None)


def parity_episodes(device=None, steps=100, modes=None, kernel=None, N=8, NB=2):
    """The episodes of every mode against the f64 loop: a dict of the
    reference script's results, each mode with its K2 launches over its
    three runs (None without ``kernel``)."""
    cons, pset, model, params = demo(N, NB)
    dev = resolve_device(device)

    def make_step(mode):
        _, ipm, refine, sd = mode
        _, _, init_carry, step = make_cvar_mpc_batched_step(model, params, ralpha=0.9, ipm=ipm,
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
                          cvar_pl.KERNEL if dev.type == "cuda" else None,
                          int(os.environ.get("EP_N", "8")), int(os.environ.get("EP_NB", "2")))
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"metric": "closed_loop_parity_cvar_overtake", "device": card, **res}))


if __name__ == "__main__":
    main()
