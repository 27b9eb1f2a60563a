"""One step of the port's merge lane-switch gate, solved again by three
engines: the NumPy oracle at several iteration budgets, the port's
``BranchMPCCVaR`` and the JAX package's, on the same program and the same
forced warm start.

The gate (``tests/test_torch_reference_scale.py::
test_merge_reference_scale_lane_switch``: ``HighwayMergeEnv``, N=40, NB=1,
the port's controller at IPM-480 with 2 Gondzio correctors and a
120-iteration restart, f64) is teacher-forced: each step's engine solve
starts from the oracle's previous solution, and the engine's input is the one
applied. This script runs that loop (``torch_port_merge_gate.DualSolveMPC``,
the gate's own) up to step STEP with the forced solves only (the gate's free
solves do not move its trajectory; on a step before STEP where the oracle's
QCQP stops at 800 iterations it solves again, as the gate does, and says
so), saves the step's program (the states, ``S``, ``bx`` and the forced warm
start ``u_lin``, ``p``, ``old_input``) to MERGE_STEP_OUT, then solves it:

- with the oracle (tol 1e-8) at each budget of MERGE_STEP_BUDGETS, each from
  a copy of the oracle as it stood before the step;
- with the port's controller, its carry forced as the gate forces it;
- with the JAX package's controller at the same configuration (f64, CPU),
  its carry forced to the same warm start.

It prints the oracle's status, tier, iterations, gap and residuals at each
budget, each engine's |du0| and |duPred| against the converged oracle (the
largest budget that is ``optimal``) and against each budget's, and |du|
between the two engines.

    JAX_PLATFORMS=cpu python scripts/torch_port_merge_gate_step.py --device cpu [--step 26]

``--device`` is where the port's controller runs (default the CUDA card;
the gate runs on the CPU). Env: MERGE_STEP_BUDGETS ("800,3000,10000"),
MERGE_STEP_OUT (default ``torch_port_merge_gate_step.npz`` in the temporary
directory, ``$TMPDIR`` or ``/tmp``),
MERGE_N / MERGE_NB (the tree, 40 and 1 as the gate's; smaller for a quick
run). At the gate's size a step takes about two minutes on the CPU: 600
port iterations and the oracle. The step where the oracle first stops
depends on the CPU's thread counts (torch's and OpenBLAS's), through
rounding: step 24 with OMP_NUM_THREADS=2 and OPENBLAS_NUM_THREADS=2, step
26 in an earlier run of the gate, none through step 26 with one thread.
"""

import argparse
import copy
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from torch_port_merge_gate import (  # noqa: E402
    DualSolveMPC,
    StepReached,
    merge_demo_setup,
    merge_gate_controllers,
    merge_gate_env,
)


def jax_controller(N, NB):
    """The JAX package's controller at the gate's configuration (f64, CPU)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from belief_planning_tpu.controllers.cvar_mpc import BranchMPCCVaR as JBranchMPCCVaR
    from belief_planning_tpu.models.policies import merge_policy_set
    from belief_planning_tpu.models.predictive import merge_model
    from belief_planning_tpu.presets import init_branch_mpc
    from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
    from belief_planning_tpu.utils.config import BranchConstants

    cons = BranchConstants(am=7.0, rm=0.3)
    pset = merge_policy_set(cons, 20.0, None)
    model = merge_model(cons, pset, N=N, dt=0.1)
    params = init_branch_mpc(4, 2, N, NB, np.array([0.5, 1.8, 15.0, 0.0]), 7.0, 0.3, 2,
                             cons.W)
    mpc = JBranchMPCCVaR(params, model, pset.params, ralpha=0.1, use_S=True,
                         ipm=JCVaRIPMConfig(iters=480, gondzio=2), restart=120,
                         dtype=jnp.float64)
    return mpc, jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--step", type=int, default=26)
    a = ap.parse_args()
    budgets = [int(b) for b in os.environ.get("MERGE_STEP_BUDGETS", "800,3000,10000").split(",")]
    out_path = os.environ.get("MERGE_STEP_OUT", os.path.join(tempfile.gettempdir(),
                                                             "torch_port_merge_gate_step.npz"))
    N, NB = int(os.environ.get("MERGE_N", "40")), int(os.environ.get("MERGE_NB", "1"))

    cons, psets, models, params = merge_demo_setup(N, NB)
    oracle, mpc = merge_gate_controllers(params, models[0], psets[0], device=a.device)
    loop = DualSolveMPC(mpc, oracle, free=False, stop_at=a.step, progress=True)
    env = merge_gate_env(loop, cons, psets, models)
    try:
        for t in range(a.step + 1):
            env.step(t)
    except StepReached:
        pass
    pg = loop.program
    assert pg is not None and pg["prev_u"] is not None, "the step is not a warm one"
    prog = {k: pg[k] for k in ("x", "z", "xRef", "S", "Fx", "bx")}
    print(f"\nstep {a.step}: laneID {env.laneID[0]}, x {np.round(pg['x'], 6).tolist()}, "
          f"S {'given' if pg['S'] is not None else 'none'}")
    np.savez(out_path, step=a.step, x=pg["x"], z=pg["z"], xRef=pg["xRef"],
             S=np.asarray(pg["S"] if pg["S"] is not None else np.zeros((0, 0)), float),
             bx=np.asarray(pg["bx"] if pg["bx"] is not None else np.zeros(0), float),
             u_lin=pg["prev_u"], p=pg["prev_p"], old_input=pg["prev_old"])
    print(f"program saved to {out_path}")

    ora = {}
    for b in budgets:
        o = copy.deepcopy(pg["oracle"])
        t0 = time.perf_counter()
        o.solve(**prog, tol=1e-8, max_iter=b)
        s = o.solution
        ora[b] = (s.status, np.asarray(o.uPred).copy())
        print(f"oracle max_iter={b:6d}: {type(s).__name__} status={s.status} tier={o.quality} "
              f"feasible={o.feasible} iterations={s.iterations} "
              f"gap={float(getattr(s, 'gap', np.nan)):.3e} pr={s.prim_res:.3e} "
              f"dr={s.dual_res:.3e} ({time.perf_counter() - t0:.1f}s)", flush=True)
    conv = [b for b in budgets if ora[b][0] == "optimal"]
    ref_b = conv[-1] if conv else budgets[-1]
    u_ref = ora[ref_b][1]
    print(f"converged oracle: max_iter={ref_b} ({ora[ref_b][0]})")

    c = pg["carry"]
    t = lambda v: torch.as_tensor(v, dtype=c.u_lin.dtype, device=c.u_lin.device)[None]
    mpc.carry = c._replace(u_lin=t(pg["prev_u"]), p=t(pg["prev_p"]),
                           old_input=t(pg["prev_old"]))
    t0 = time.perf_counter()
    mpc.solve(**prog)
    u_port, gap_port = np.asarray(mpc.uPred), float(mpc.last.gap)
    t_port = time.perf_counter() - t0

    jm, jnp = jax_controller(N, NB)
    jm.carry = jm.carry._replace(u_lin=jnp.asarray(pg["prev_u"]), p=jnp.asarray(pg["prev_p"]),
                                 old_input=jnp.asarray(pg["prev_old"]),
                                 initialized=jnp.asarray(True))
    t0 = time.perf_counter()
    jm.solve(**prog)
    u_jax, gap_jax = np.asarray(jm.uPred), float(np.asarray(jm.last.gap).ravel()[0])
    t_jax = time.perf_counter() - t0

    for name, u, gap, secs in (("port", u_port, gap_port, t_port),
                               ("JAX ", u_jax, gap_jax, t_jax)):
        print(f"{name} BranchMPCCVaR: gap={gap:.3e} |du0|={np.abs(u[0] - u_ref[0]).max():.3e} "
              f"|duPred|={np.abs(u - u_ref).max():.3e} against the converged oracle "
              f"({secs:.1f}s)")
        for b in budgets:
            print(f"    against max_iter={b}: |du0|={np.abs(u[0] - ora[b][1][0]).max():.3e} "
                  f"|duPred|={np.abs(u - ora[b][1]).max():.3e}")
    print(f"port vs JAX: |du0|={np.abs(u_port[0] - u_jax[0]).max():.3e} "
          f"|duPred|={np.abs(u_port - u_jax).max():.3e}")


if __name__ == "__main__":
    main()
