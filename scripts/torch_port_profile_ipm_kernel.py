"""Phase-level timing of the fused QP IPM iteration kernel on the card: the
port's counterpart of ``scripts/profile_ipm_kernel.py``.

Each phase of the Mehrotra iteration is a kernel of its own, built from the
same source as the main path's (``csrc/tree_qp_ipm_iter.cu``): (a) barrier
weights + tree-Riccati factor, (b) that + one linear sweep + forward
rollout, (c) the full iteration. Each is launched ``PROF_REPS`` times in a
row and timed with CUDA events, ``PROF_TIMES`` times; the median is kept.
The inputs come from one prep pass of the port's main path at the bench
configuration (N=8, NB=2, IPM-12): one warm-up step, then the next step's
warm shift, tree build and cost assembly, in f32. Needs a CUDA card:

    python scripts/torch_port_profile_ipm_kernel.py

Env: BENCH_BATCH (2048), PROF_REPS (12), PROF_TIMES (8).
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASE_NAMES = {0: "factor", 1: "kkt1", 2: "full"}


def prep_inputs(B, dev, cfg):
    """The K1 inputs of one main-path step at the bench configuration:
    ``(plan, nFx, nFu, mtot, const_args, carry0)``, batch-last f32. The carry
    is the reference profile's: x, u from the tree, s = 0, slacks 0.5 and
    multipliers 0.2."""
    from chip_smoke import bench_states, overtake_setup

    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers import tree_qp_pl as P
    from belief_planning_tpu_torch.solvers.layout import _to_bl, cost_to_bl
    from belief_planning_tpu_torch.solvers.tree_qp import assemble_stage_cost, build_stage_plan
    from belief_planning_tpu_torch.tree.engine import build_tree, shift_warm_start

    pset, model, params = overtake_setup()
    f32 = torch.float32
    topo, init, step = make_branch_mpc_batched_step(model, params, "prox", ipm=cfg, device=dev)
    xs, zs, xRefs = (torch.as_tensor(a, dtype=f32, device=dev) for a in bench_states(B))
    carry, _ = step(init(B, f32), xs, zs, xRefs, pset.params)
    # the next step's prep, as the main path runs it
    u_lin = torch.where(carry.initialized[:, None, None],
                        shift_warm_start(topo, carry.u_lin, carry.p),
                        torch.zeros_like(carry.u_lin))
    ts = build_tree(model, topo, xs, zs, u_lin, cast_params(pset.params, f32, dev))
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR,
                               params.Qslack, xRefs, carry.old_input)
    plan = build_stage_plan(topo)
    consts = P._prep_consts(plan, cost_to_bl(cost), _to_bl(ts.A), _to_bl(ts.Bm),
                            _to_bl(ts.dh), _to_bl(ts.h0), params.Fx, params.bx, params.Fu,
                            params.bu)
    nFx, nFu = np.asarray(params.Fx).shape[0], np.asarray(params.Fu).shape[0]
    U, Nc = topo.totalu, nFx + 1
    full = lambda shape, v: torch.full(shape + (B,), v, dtype=f32, device=dev)
    sl, lam = full((U, Nc), 0.5), full((U, Nc), 0.2)
    carry0 = (_to_bl(ts.x_lin), _to_bl(ts.u_lin), full((U, Nc), 0.0), sl, lam,
              full((U, nFu), 0.5), full((U, nFu), 0.2), sl, lam)
    mtot = float(U * Nc + U * nFu + U * Nc)
    return plan, nFx, nFu, mtot, [consts[k] for k in P.CONST_ORDER], carry0


def time_phase(step, const_args, carry0, full, reps, times):
    """Median milliseconds of ``reps`` launches in a row (CUDA events), over
    ``times`` runs after one warm-up launch. The full iteration carries its
    output into the next launch, as the reference's scan does."""
    def run():
        c = carry0
        for _ in range(reps):
            out = step(*const_args, *c)
            if full:
                c = out[:9]

    step(*const_args, *carry0)
    torch.cuda.synchronize()
    ms = []
    for _ in range(times):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return float(np.median(ms))


def profile_phases(B, dev, reps, times):
    """Per-phase median ms of ``reps`` launches at batch ``B``; returns
    ``{"factor": ms, "kkt1": ms, "full": ms}``."""
    from belief_planning_tpu_torch.solvers import tree_qp_pl as P
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    cfg = QPIPMConfig(iters=12)
    plan, nFx, nFu, mtot, const_args, carry0 = prep_inputs(B, dev, cfg)
    return {name: time_phase(P.phase_step(plan, cfg, nFx, nFu, mtot, phase), const_args,
                             carry0, phase == 2, reps, times)
            for phase, name in PHASE_NAMES.items()}


def summary_lines(B, reps, t):
    """The reference script's summary lines."""
    lines = [f"B={B} reps={reps}"]
    lines += [f"{name:10s} {t[name]:9.3f} ms total, {t[name] / reps:7.3f} ms/iter"
              for name in PHASE_NAMES.values()]
    lines.append(f"\nper-iter: factor {t['factor'] / reps:.2f} | "
                 f"factor+1solve {t['kkt1'] / reps:.2f} | full {t['full'] / reps:.2f}")
    lines.append(f"=> linear+forward ≈ {(t['kkt1'] - t['factor']) / reps:.2f} ms/iter, "
                 f"bookkeeping+2nd solve ≈ {(t['full'] - t['kkt1']) / reps:.2f} ms/iter")
    return lines


def main():
    if not torch.cuda.is_available():
        print("torch_port_profile_ipm_kernel: needs a CUDA card", file=sys.stderr)
        return 2
    B = int(os.environ.get("BENCH_BATCH", "2048"))
    reps = int(os.environ.get("PROF_REPS", "12"))
    times = int(os.environ.get("PROF_TIMES", "8"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t = profile_phases(B, torch.device("cuda", 0), reps, times)
    for line in summary_lines(B, reps, t):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
