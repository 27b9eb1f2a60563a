#!/usr/bin/env python3
"""Drive the PyTorch port (``belief_planning_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:

0. the card's name and power limit (``nvidia-smi``);
1. build: nvcc compiles ``csrc/tree_qp_ipm_iter.cu`` once for each of its
   instantiations (n, d, nFx, nFu) = (4, 2, 4, 4), (3, 3, 1, 6), (3, 3, 0,
   6) (timed, with ptxas's registers, stack frame and spills for each
   kernel entry);
2. the kernel against its plain PyTorch version, both on the card, on real
   QP data from the port's tree build and cost assembly (N=8, NB=2): one
   iteration in f64 at B=256 and at B=32768 (bar 1e-10 of each field's
   magnitude), one in f32 at B=32768 (as accurate as the plain version in
   f32, both measured against the plain version in f64), and a full
   8-iteration f64 solve at B=256 (max |Δu|, |Δx| reported); then
   ``kernel_time``: ms a launch at B=32768 and, after one f32 iteration
   there held to the same bar, at B=256, beside the plain version's and the
   bound, with the launch plan (trees a block, resident teams an SM, shared
   memory a block, scratch bytes in total and a tree);
3. the main path: ``make_branch_mpc_batched_step`` at the bench config
   (N=8, NB=2, IPM-8 with 2 Gondzio correctors, f32, B=32768, shared policy
   params): one warm-up step and timed warm-started steps, each timed by
   fetching ``uPred`` to the host; outputs finite and inside the input
   bounds; the launch count equal to 8 × steps; p50 step at B=256; and the
   f64 path on the card against the same step on the CPU (the plain version
   the tests hold against the JAX package) at B=64;
4. the f64 restart (``refine_f64=10``) at B=256, which runs the double
   kernel on the path;
5. the CVaR slice (``make_cvar_mpc_batched_step``, kernel
   ``csrc/cvar_ipm_iter.cu``) at two configurations, IPM-24 with 2 Gondzio
   correctors, f32: the merge deployment (N=40, NB=1, m=2, per-lane ramp
   shear S and bounds bx, worlds drawn as the reference's ``init_worlds``)
   and the CVaR overtake (N=8, NB=2, m=3, ``bench_cvar.py``'s states):
   ``build_cvar`` (nvcc, ptxas report); ``cvar_kernel_vs_plain`` (one
   iteration in f64 at B=1024, at the first and the fifth iteration, bar
   1e-10 of each field's magnitude; one in f32 at B=32768 and one at B=256,
   2 trees a block, with the accuracy bar); ``cvar_kernel_time`` (ms a
   launch at B=32768 and at B=256 beside the plain version's and the bound,
   and the launch plan: trees a block, resident teams an SM, shared memory
   a block, scratch bytes in total and a team); ``cvar_main_path`` per
   configuration (solves/s at B=32768 over 5 warm-started steps, 24
   launches a step, gap p50 / max, one profiled step; for the merge also
   p50 step ms at B=256 against 100 ms);
   ``cvar_main_path_vs_cpu`` (the merge in f64 at B=64 on the card and on
   the CPU: two steps' |Δu| |Δx|, and the first 10 gaps of one solve to
   rtol 1e-8, atol 1e-10); ``cvar_refine_f64`` (the merge at B=256 with an
   8-iteration f64 restart through the double kernel);
6. the cone-ADMM slice (``solvers/cvar.cvar_solve``, kernel
   ``csrc/proj_soc.cu``): ``build_soc``; ``soc_kernel_vs_plain`` (f64 at
   1e-14 and f32 at 1e-6 of each input row's magnitude, tie rows exact;
   the team path on rows of k = 8, the general path on rows of k = 5 and
   on the k = 8 rows at a view that is not 16-byte aligned, each launch's
   path checked); ``soc_kernel_time`` (32768 × 97 rows, k = 8, f32 and
   f64, held to the same bars; GB/s and share of the bound);
   ``soc_kernel_on_admm_rows`` (every projection of the first 30
   iterations of the f64 solve at B=32768 also run by the plain version,
   and on the rows cast to f32, at the same bars); ``admm_main_path`` (a
   batched 400-iteration solve of the CVaR overtake at B=32768 in f64,
   where the reference converges: solve ms, prim_res, J, exactly iters + 2
   launches, all on the team path; K3's share of device time over a
   profiled 10-iteration solve);
   ``admm_vs_cpu`` (the same in f64 at B=64, card against CPU: |Δu| held
   at 1e-7 after 30 and after 100 iterations, |Δx| reported);
7. the K1 profile (the phase kernels of ``csrc/tree_qp_ipm_iter.cu``):
   ``k1_phases_vs_plain`` (phases 0 and 1 in f64 at B=1024, 1e-10; on
   the profile's f32 inputs at B=2048 and B=32768 with the f32 accuracy
   bar, and in f64 at B=32768, 1e-10), then
   ``scripts/torch_port_profile_ipm_kernel.py``'s timing at B=2048 and
   B=32768 (``k1_phases``, per-iteration factor | factor + 1 solve | full);
8. slice 4, the shared-row probe (K5, ``csrc/shared_rows_probe.cu``) and
   the per-tree IPM steps: ``build_shared_rows``; ``shared_rows_vs_plain``
   (each mode against the plain version in f64 at the reference's size,
   B=4096 × 25 nodes, and at the main path's width, B=32768 × 97 nodes,
   64 chained products: fma and 3xtf32 at the f32 accuracy bar, bf16 within
   2⁻⁷·Σ|Fx|·|cur| of every output and different from the f32 result);
   ``shared_rows_time`` (``scripts/torch_port_mxu_probe.py`` at both
   sizes: ms per launch, TFLOP/s, the bound and the share of it per mode,
   the probe's verdict line, with every launch counted); ``qp_ipm_main_path`` (``make_branch_mpc_step`` on the QP
   overtake, ``QPIPMConfig()`` defaults, f32, B=32768: a cold step, then a
   timed warm step, and a warm step profiled over 4 iterations); ``qp_ipm_pin`` (K1 in f64 at
   B=1024 against the per-tree step over two warm-carried steps at the main
   path's IPM-8 with 2 correctors, u < 1e-7, x < 1e-6); ``cvar_ipm_main_path`` (``make_cvar_mpc_step``, IPM-40, f32,
   B=8192, both CVaR configurations: solves/s, gap and J p50; the
   overtake profiled over 4 iterations; one cold step each); ``cvar_ipm_pin`` (K2 in f64
   against ``cvar_ipm_solve`` at B=64, IPM-60: first 10 gaps rtol 1e-8,
   root u < 2e-2);
9. slice 8, the quadruped on K1 and the closed-loop merge episode on K2
   (``scripts/bench_configs.py:193-222``: N=25, NB=2, 151 stages, the rate
   cost dR, IPM-8 with 2 correctors): ``quad_kernel_vs_plain`` (K1 at
   (3, 3, 1, 6), the solve's rows with one inert padded row, and at
   (3, 3, 0, 6), the quadruped's own rows: f64 at B=256 at iterations 1
   and 5, 1e-10; f32 at B=8192 and 256 with the accuracy bar);
   ``quad_k1_phases_vs_plain`` (phases 0 and 1 at both dims, f64, 1e-10);
   ``quad_kernel_time`` (ms a launch at B=8192 and 256 beside the plain
   version's and the bound, and the launch plan); ``quad_main_path``
   (``make_branch_mpc_batched_step`` on the quadruped, f32, B=8192:
   solves/s over 5 warm steps, every K1 launch at (3, 3, 1, 6), inputs
   inside their bounds on feasible lanes; p50 at B=256 beside the
   quadruped's 200 ms control period; a profiled step at each size);
   ``quad_main_path_vs_cpu`` (f64, B=64, two steps, u < 1e-7, x < 1e-6);
   ``merge_episode_vs_cpu`` (``envs/batched_merge.make_batched_merge_fused``
   in f64 at B=8, IPM-8, three steps, card against CPU: u, x, z < 1e-7,
   the same merged flags) and ``merge_episode`` (world-steps/s at
   B=32768, IPM-24, f32, over 5 warm steps, 24 K2 launches a step);
10. slice 9, the closed-loop overtake ensemble on K1 and the host loops:
    ``overtake_episode_vs_cpu`` (``envs/batched_highway.
    make_batched_overtake_fused`` in f64 at N=8, NB=2, B=8, IPM-8, three
    steps with the same draws, card against CPU: u, x, z < 1e-7, equal
    lanes, 24 K1 launches); ``overtake_episode`` (world-steps/s at
    B=32768, IPM-8 with 2 correctors, f32, over 5 warm steps after a cold
    one, 8 K1 launches a step, feasible, collided and lane-intent shares, a
    profiled world step); ``highway_host_loop`` (``HighwayEnv`` +
    ``BranchMPCProx`` for 5 steps and ``HighwayMergeEnv`` +
    ``BranchMPCCVaR`` for 3, the demos' widths at IPM-8, card against CPU in
    f64: states and inputs < 1e-7, equal backup choices; seconds a step);
11. slice 10, the tree-QP ADMM, the robust and HMM controllers and the
    quadruped's host loop, all plain PyTorch, each phase alone, its card
    side then its CPU reference (each phase sets every kernel's launch
    counter to 0 just before its card side and fails unless it stays 0):
    ``tree_admm_vs_cpu`` (``admm_solve`` on the overtake tree, f64, B=8,
    at 2 iterations |Δu|, |Δx| < 1e-10 and at the entry's config, ρ=5, 50
    iterations + 10 polish, |Δu| < 1e-7); ``admm_main_path``
    (``make_branch_mpc_step(solver="admm")`` at the entry's config, f32,
    B=4096: a cold step, 3 warm steps with the duals carried, a profiled
    one, solves/s, prim_res, the feasible share, f32 against f64 on the
    card, the card's f64 against the CPU on 64 trees < 1e-7; then
    ``entry()``'s step on the card, finite); ``hmm_main_path``
    (``make_hmm_mpc_batched_step`` at ``scripts/bench_configs.py:235-290``,
    M=1, m=2, N=6, IPM-8 with 2 correctors, f32, B=4096: solves/s over 5
    warm steps, the feasible share, f32 against f64, a profiled step);
    ``hmm_vs_cpu`` (f64, B=8, two steps, |Δu| < 1e-9); ``hmm_host_loop``
    (``HMMHighwayEnv`` + ``HMMMPC``, NV=3, M=2, N=5, 3 steps: states <
    1e-7, beliefs < 1e-9, backups and the generator's next draw equal);
    ``quad_host_loop`` (``QuadEnv`` + ``BranchMPCProx``, N=25, NB=2, 1 step
    in each ``ref_mode``: states < 1e-7, backups equal);
    ``robust_host_loop`` (``RobustMPC``, N=8, NB=2, f64: the closed loop of
    2 IPM-100 steps and 1 ``ADMMConfig()`` step on the CPU, each step
    solved again on the card from the same state and carry, |Δu| < 1e-7),
    and ``slice10_seconds``;
12. slice 11, scale-out over ``torch.distributed``: each phase spawns its
    own ranks (``parallel.launch.launch``; two gloo ranks share the one card,
    as NCCL refuses two ranks on one device), and each rank sets K1's and
    K2's launch counters to 0 just before its timed run, reads them just
    after and returns them: ``ensemble_ipm_sharded`` (the QP overtake on
    K1, IPM-8 with 2 correctors, f32, B=32768 as 2 × 16,384, 3 warm steps:
    each rank's and the aggregate solves/s beside the one-process step's,
    each rank's idle share, 8 launches a step; then in f64 at B=1024 each
    rank's u over two steps against the one-process step's rows on the card,
    ≤ 1e-12), ``ensemble_cvar_sharded`` (the merge on K2, IPM-24, the
    same), ``overtake_episode_sharded`` (B=32768, 10 warm world steps, the
    reduced metrics), ``tree_kkt_sharded`` (m=4, NB=5, N=2, T=256, f64,
    mp=2, equal to the unsharded sweeps (``torch.equal``), its bytes, and
    each small-matrix helper at every level, whole against halves),
    ``nccl_world1`` (the QP ensemble on one NCCL rank) and
    ``dryrun_multichip`` (2 gloo ranks), then ``slice11_seconds``;
13. slice 12, ``cvar_ipm_solve``'s diagnostic options and the closed-loop
    parity episodes: ``cvar_diag_options`` (each of the six options on the
    hard cold-start batch of ``scripts/torch_port_cvar_f32_diag.py``, N=8,
    NB=2: in f64 on 8 of its trees, 10 iterations, card against CPU within
    1e-10 of each field's magnitude, the option shown to act; then in f32 on
    all 32 trees, 40 iterations, the final gap p50), ``qp_parity_episode``
    and ``cvar_parity_episode`` (``scripts/torch_port_f32_parity_episode.py``
    and ``scripts/torch_port_cvar_parity_episode.py`` cut to 10 steps: the
    f64 loop on K1's / K2's f64 build, the f32 and refine10 modes
    self-driven and teacher-forced, their maxima and every mode's launches,
    the QP's refine10 teacher-forced deviation held at 1e-3), then
    ``slice12_seconds``;
14. the ``kernels`` line (all five kernels; K1's with an entry for each
    instantiation; K1's and K2's launches by path, the ranks' and the
    parity episodes' too), the ``nvidia-smi`` line, and the result line.

Every kernel source is built at the start, in parallel (one nvcc each).

Any failed check raises and the script exits non-zero. It needs one card,
and exits non-zero without printing a result when CUDA is unavailable or the
package is not beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# f32 kernel vs plain version, one iteration. The two differ in operation
# order and in nvcc's FMA contraction, and f32 rounding (unit roundoff 6e-8)
# is amplified by the conditioning of the barrier-weighted factor, which
# varies from lane to lane. So the f32 bar is one of accuracy: against the
# plain version in f64 on the same (upcast) inputs, the kernel's error in
# every field is at most F32_ERR_RATIO × the plain f32 version's own error
# plus F32_FLOOR × the field's magnitude (16 f32 ulps), i.e. the kernel in
# f32 is as accurate as the plain version in f32.
F32_ERR_RATIO = 2.0
F32_FLOOR = 1e-6
F64_TOL = 1e-10
# H100 SXM data-sheet peaks at its full 700 W power limit: HBM3 bandwidth,
# and the non-tensor-core f32 / f64 rates
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"float32": 67e12, "float64": 34e12}

N, NB, n, d = 8, 2, 4, 2
BENCH_B = 32768


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also gets ``t_s``, the script's seconds
    so far when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0].strip()


def overtake_cons():
    """The overtake demo's constants (``examples/main_branch.py:29-33``)."""
    from belief_planning_tpu_torch.utils.config import BranchConstants

    return BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2,
                           am=6.0, rm=0.3, J_c=20, s_c=1, ylb=0., yub=7.2,
                           L=4, W=2.5, col_alpha=5, Kpsi=0.1)


def overtake_setup():
    """The bench's reference overtake configuration (the port's counterpart
    of ``bench.py``'s setup)."""
    from belief_planning_tpu_torch.models.policies import highway_policy_set
    from belief_planning_tpu_torch.models.predictive import highway_model
    from belief_planning_tpu_torch.presets import init_branch_mpc

    cons = overtake_cons()
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xRef)
    model = highway_model(cons, pset, N=N, dt=0.1)
    params = init_branch_mpc(n, d, N, NB, xRef, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    return pset, model, params


def bench_states(B, seed=0):
    """Physically plausible in-bounds states, drawn as ``bench.py`` draws them."""
    rng = np.random.default_rng(seed)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    xs[:, 1] = np.clip(xs[:, 1], 1.3, 13.1)
    xs[:, 3] = np.clip(xs[:, 3], -0.2, 0.2)
    zs = np.array([12.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.5, (B, 4))
    zs[:, 1] = np.clip(zs[:, 1], 1.3, 13.1)
    zs[:, 3] = np.clip(zs[:, 3], -0.2, 0.2)
    xRefs = np.tile(np.array([0., 1.8, 18., 0.]), (B, 1))
    return xs, zs, xRefs


def qp_case(dev, B, dtype, cfg):
    """The fused solve's real inputs at the bench config: tree build and cost
    assembly in f64 on the card, cast to ``dtype``, then the solver's setup."""
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers.layout import _to_bl, cost_to_bl
    from belief_planning_tpu_torch.solvers.tree_qp import assemble_stage_cost, build_stage_plan
    from belief_planning_tpu_torch.solvers.tree_qp_pl import setup_ipm
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology

    pset, model, params = overtake_setup()
    topo = build_topology(N, NB, model.m, n, d)
    plan = build_stage_plan(topo)
    xs, zs, xRefs = bench_states(B)
    f64 = torch.float64
    t = lambda a: torch.as_tensor(a, dtype=f64, device=dev)
    ts = build_tree(model, topo, t(xs), t(zs), torch.zeros(B, topo.totalu, d, dtype=f64, device=dev),
                    cast_params(pset.params, f64, dev))
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR,
                               params.Qslack, t(xRefs), torch.zeros(B, d, dtype=f64, device=dev))
    cast = lambda a: _to_bl(a.to(dtype))
    cost_bl = cost_to_bl(type(cost)(*(c.to(dtype) for c in cost)))
    su = setup_ipm(plan, cost_bl, cast(ts.A), cast(ts.Bm), cast(ts.dh), cast(ts.h0),
                   params.Fx, params.bx, params.Fu, params.bu, cast(ts.x_lin),
                   cast(ts.u_lin), cfg)
    return plan, params, su


def iteration_bytes(su):
    """Least traffic of one iteration: each constant read once, the carry read
    and written once, the gap written once."""
    elems = sum(c.numel() for c in su.const_args) + 2 * sum(c.numel() for c in su.carry0)
    elems += su.carry0[0].shape[-1]
    return elems * su.carry0[0].element_size()


def iteration_flops(plan, nFx, nFu, gondzio, lanes):
    """Floating-point operations of one iteration, counted from the kernel's
    loops (multiply-add = 2) per stage, summed over stages and lanes. The
    count is data-independent: every corrector candidate is computed whether
    or not a lane accepts it."""
    nx, nu = plan.topo.n, plan.topo.d
    nd, nc, nf = nx + nu, nFx + 1, nFu
    U = plan.topo.totalu
    entries = 2 * nc + nf                       # slack/multiplier rows per stage
    residual = nc * (2 * nx + 14) + nf * (2 * nu + 6) + nx * (2 * nx + 2 * nc + 2) \
        + nu * (2 * nu + 2 * nf + 4 * nu + 3)
    riccati = (3 * nc + 2 * nx * nx + 3 * (nc - 1) * nx * nx + 2 * nx * nx + 3 * nf * nu * nu
               + 2 * nu * nx * nx + 2 * nu * nu * nx + nu * nu * (2 * nx + 4)
               + 4 * nu * nx * nx + 2 * nu * nd * nu + 2 * nx * nx * nx
               + 2 * nd * nd * nu + 2 * nx * nx * nx + 3 * nx * nx + 2 * nd * nd
               + nx * nd * 2 * nu + 12)
    kkt = (nc * 12 + 4 * (nc - 1) * nx + 6 * nx + nf * (4 + 2 * nu) + nu   # rhs
           + nu * (2 * nx + 2) + nu * 2 * nu + nd * (2 * nd + 2 * nu) + nx   # backward
           + nu * 2 * nd + nd * 2 * nd + nx * 2 * nu                          # forward
           + nc * (2 * nx + 11) + nf * (2 * nu + 5))                          # slacks
    n_dir = 2 + gondzio
    step_calls = 1 + 2 * gondzio + 1
    gap_calls = 1 + 2
    per_stage = (residual + riccati + n_dir * kkt + step_calls * 3 * 2 * entries
                 + gap_calls * 5 * entries + 3 * entries * (1 + gondzio)
                 + gondzio * 10 * entries + gondzio * 2 * (nx + nu + 2 * entries)
                 + 2 * (nx + nu + 2 * entries))
    return per_stage * U * lanes


def hold_iteration(step, plain, consts, carry, line, card):
    """One launch of K1 (``step``) against its plain version on the same
    inputs: in f64 every field within F64_TOL of its magnitude; in f32 as
    accurate as the plain version in f32, both against the plain version in
    f64 on the upcast inputs. Emits ``line`` with the errors, raises on a
    miss; returns the largest |kernel − plain|."""
    from belief_planning_tpu_torch.solvers.tree_qp_pl import CARRY_ORDER

    names = CARRY_ORDER + ["gap"]
    B = carry[0].shape[-1]
    got = step(*consts, *carry)
    torch.cuda.synchronize()
    ref = plain(*consts, *carry)
    errs = scaled_err(got, ref, names)
    worst = max(errs, key=lambda k: errs[k][0])
    max_abs = max(e[1] for e in errs.values())
    line = {**line, "worst_field": worst, "worst_scaled": errs[worst][0], "max_abs_err": max_abs}
    if carry[0].dtype == torch.float64:
        emit({**line, "tol_scaled": F64_TOL, **card})
        if errs[worst][0] > F64_TOL:
            raise AssertionError(f"kernel disagrees with its plain version: {worst} "
                                 f"{errs[worst][0]:.3e} > {F64_TOL:.0e} ({line})")
        return max_abs
    up = lambda ts: [t.double() for t in ts]
    ref64 = plain(*up(consts), *up(carry))
    acc = {}
    for nm, g, r, r64 in zip(names, got, ref, ref64):
        e_k = (g.double() - r64).abs().max().item()
        e_p = (r.double() - r64).abs().max().item()
        acc[nm] = (e_k, e_p, F32_ERR_RATIO * e_p + F32_FLOOR * r64.abs().max().item())
    bad = [nm for nm, (e_k, _, bar) in acc.items() if e_k > bar]
    lane_rel = torch.stack([((g - r).abs() / r.abs().amax()).reshape(-1, B).amax(0)
                            for g, r in zip(got, ref)]).amax(0)
    emit({**line, "err_vs_f64": {nm: {"kernel": v[0], "plain": v[1], "bar": v[2]}
                                  for nm, v in acc.items()},
          "lanes_over_1e-4": int((lane_rel > 1e-4).sum()),
          "lanes_over_1e-5": int((lane_rel > 1e-5).sum()), **card})
    if bad:
        raise AssertionError(f"f32 kernel less accurate than the plain version in {bad} ({line})")
    return max_abs


# ---- the CVaR slice ----------------------------------------------------------

CVAR_CONFIGS = ("cvar_merge", "cvar_overtake")


def cvar_config(name):
    """``(model, params, pset, cons, ralpha, use_S)`` of a CVaR configuration:
    the merge deployment (``examples/main_branch.py:50-75``,
    ``scripts/bench_ensemble.py:66-80``) or the CVaR overtake
    (``scripts/bench_cvar.py:40-90``)."""
    from belief_planning_tpu_torch.models.policies import merge_policy_set
    from belief_planning_tpu_torch.models.predictive import merge_model
    from belief_planning_tpu_torch.presets import init_branch_mpc
    from belief_planning_tpu_torch.utils.config import BranchConstants

    if name == "cvar_merge":
        cons = BranchConstants(am=7.0)
        pset = merge_policy_set(cons, 20.0, None)
        model = merge_model(cons, pset, N=40, dt=0.1)
        params = init_branch_mpc(n, d, 40, 1, np.array([0.5, 1.8, 15.0, 0.0]), am=7.0, rm=0.3,
                                 N_lane=2, W=cons.W)
        return model, params, pset, cons, 0.1, True
    pset, model, params = overtake_setup()
    return model, params, pset, None, 0.9, False


def cvar_states(name, B, dev, dtype, seed=0):
    """``(xs, zs, xRefs, S, bx)`` on ``dev``: merge worlds drawn as the
    reference's ``init_worlds`` with their per-lane ramp inputs, or the CVaR
    bench's overtake states (S, bx None)."""
    from belief_planning_tpu_torch.envs.batched_merge import draw_merge_worlds, merge_lane_inputs

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    if name == "cvar_merge":
        _, params, _, cons, _, _ = cvar_config(name)
        x0, z0 = draw_merge_worlds(B, seed)
        _, S, xRefs, bx = merge_lane_inputs(t(x0), torch.zeros(B, dtype=torch.bool, device=dev),
                                            params.bx, cons.W)
        return t(x0), t(z0), xRefs, S, bx
    xs, zs, xRefs = bench_states(B, seed)
    return t(xs), t(zs), t(xRefs), None, None


def cvar_case(name, dev, B, dtype, cfg, floor_mixed=True):
    """The fused CVaR solve's real inputs: tree build in f64 on ``dev`` from
    a cold start, cast to ``dtype``, then the solver's setup (merge: per-lane
    S and bx, the dh[0] floor on every other lane)."""
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers import cvar_pl
    from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
    from belief_planning_tpu_torch.solvers.layout import _to_bl
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology

    model, params, pset, _, ralpha, use_S = cvar_config(name)
    topo = build_topology(params.N, params.NB, model.m, n, d)
    cplan = build_cvar_plan(topo)
    f64 = torch.float64
    xs, zs, xRefs, S, bx = cvar_states(name, B, dev, f64)
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, d, dtype=f64, device=dev),
                    cast_params(pset.params, f64, dev))
    bl = lambda a: _to_bl(a.to(dtype))
    floor = (torch.arange(B, device=dev) % 2 == 0) if (use_S and floor_mixed) else None
    su = cvar_pl.setup_cvar_ipm(
        cplan, bl(ts.A), bl(ts.Bm), bl(ts.dh), bl(ts.h0), bl(ts.x_lin), bl(ts.u_lin), bl(ts.p),
        params.Q, params.R, params.Qslack, bl(xRefs), ralpha, params.Fx,
        params.bx if bx is None else bl(bx), params.Fu, params.bu, cfg,
        S_bl=bl(S) if use_S else None, dh0_floor=floor)
    return cplan, su, cvar_pl.make_cvar_iteration(cplan, cfg, su.dims)


def cvar_iteration_bytes(su):
    """Least traffic of one CVaR iteration: each constant read once (the
    shared ones once for all lanes), the carry read and written once, the
    gap written once."""
    elems = sum(c.numel() for c in su.in_args) + 2 * sum(c.numel() for c in su.carry0)
    elems += su.carry0[0].shape[-1]
    return elems * su.carry0[0].element_size()


def cvar_iteration_flops(cplan, dims, gondzio, lanes):
    """Floating-point operations of one CVaR iteration, counted from the
    kernel's loops (multiply-add = 2; +, -, ×, ÷, sqrt = 1; comparisons
    not counted), per lane, times the lanes. Data-independent: every
    corrector candidate is computed whether or not a lane accepts it."""
    topo = cplan.plan.topo
    U, X, nbr = topo.totalu, topo.totalx, topo.n_branches
    K, R, m = dims["K"], dims["K"] + 1, dims["m"]
    nrisk, nsgn, bdim = dims["nrisk"], dims["nsgn"], dims["bdim"]
    a = 2 + m
    carry = X * 4 + U * (2 + 5 + 5 + 5 + 4 + 4 + 5 + 5) + nrisk + 2 * nsgn + 2 * K
    pairs = U * (5 + 4 + 5) + nsgn + K                     # complementarity pairs
    residuals = U * (208 + 88) + nsgn * (2 * nrisk + 4) + K * (2 * U + 2 * nrisk + 8) \
        + U * 3 * K + nrisk * (4 * nsgn + 3 * K + 3)
    factor = U * 1219 + (nbr - 1) * 36 * (m - 1)
    risk_col = 2 * bdim * m + bdim * (6 + 4 * m + a * (5 * a + (a + 1) * (2 * a - 1)
                                                        + (a + 1) + 2 * (a - 1) * (a + 1)))
    h0_col = U * 341 + risk_col
    gdot = U * 17 + K * (2 * U + 2 * nrisk + 2)
    capacitance = K * K * 5 + 4 * K ** 3
    wb = K * (3 * K + 4) + 2 * K * (X * 4 + U * 7 + nrisk)
    finish = U * 131 + nsgn * (2 * nrisk + 5) + gdot + 5 * K
    rhs = 5 * K + U * (150 + 2 * K) + nrisk * (7 * nsgn + 2 * K + 2)
    n_single = 1 + gondzio
    per_lane = (residuals + factor + R * (h0_col + 18 * U) + R * gdot + capacitance
                + (2 + gondzio) * (wb + finish) + n_single * (rhs + h0_col + gdot) + rhs
                + (2 + 2 * gondzio) * 2 * 2 * pairs + 3 * 6 * pairs + pairs * (1 + 4)
                + gondzio * (10 * pairs + carry) + 2 * carry)
    return per_lane * lanes


def ptxas_entries(log):
    """nvcc's ptxas report as one entry a kernel: its name (for K1's, K3's
    and K5's templates, their arguments), registers, stack frame and spill
    bytes, and ``wgmma_serialized`` where ptxas reports that it serialized
    the kernel's ``wgmma`` instructions (C7514)."""
    import re

    out, cur, serialized = [], None, set()
    real = lambda c: "float" if c == "f" else "double"
    for ln in log.splitlines():
        m = re.search(r"\(C7514\).*function '([^']+)'", ln)
        if m:
            serialized.add(m.group(1))
            continue
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = mangled = m.group(1)
            k = re.search(r"tree_qp_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d)E", name)
            if k:
                name = (f"tree_qp_kernel<{real(k.group(1))}, "
                        f"{k.group(2)}, {k.group(3)}, {k.group(4)}, {k.group(5)}, "
                        f"PHASE={k.group(6)}>")
            k = re.search(r"shared_rows_wgmma_kernelILi(\d)ELi(\d)E", name)
            if k:
                name = (f"shared_rows_wgmma_kernel<{'bf16' if k.group(1) == '1' else '3xtf32'}, "
                        f"chains={k.group(2)}>")
            k = re.search(r"(shared_rows_fma_kernel|proj_soc_team_kernel|proj_soc_kernel)I([fd])E",
                          name)
            if k:
                name = f"{k.group(1)}<{real(k.group(2))}>"
            cur = {"entry": name, "mangled": mangled}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    for e in out:
        mangled = e.pop("mangled")
        if any(mangled.startswith(n) or n.startswith(mangled) for n in serialized):
            e["wgmma_serialized"] = True
    return out


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the device (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def scaled_err(a_list, b_list, names):
    """Per field: max |a − b| / max |b|, and max |a − b|."""
    out = {}
    for name, a, b in zip(names, a_list, b_list):
        if not (bool(a.isfinite().all()) and bool(b.isfinite().all())):
            raise AssertionError(f"{name}: non-finite values")
        diff = (a - b).abs().max().item()
        out[name] = (diff / max(b.abs().max().item(), 1e-300), diff)
    return out


def profile_step(run, kernels=()):
    """Where one warm-started step's time goes: ``run()`` under
    torch.profiler; the ``bp.*`` spans, device busy time and idle share, the
    top device ops, and the device ms of the ops whose name contains each
    of ``kernels``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_read = time.perf_counter()
    events = prof.events()
    read_s = time.perf_counter() - t_read
    on_device, spans = {}, {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith("bp."):
            kind = "cpu" if e.device_type == DeviceType.CPU else "device"
            spans[f"{e.name}.{kind}_ms"] = spans.get(f"{e.name}.{kind}_ms", 0.0) + ms
        elif e.device_type == DeviceType.CUDA:
            n_, t_ = on_device.get(e.name, (0, 0.0))
            on_device[e.name] = (n_ + 1, t_ + ms)
    device_ms = sum(t for _, t in on_device.values())
    top = sorted(on_device.items(), key=lambda kv: -kv[1][1])[:5]
    out = {"wall_ms_profiled": wall_ms, "trace_read_s": read_s, "device_busy_ms": device_ms,
           "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
           "device_ops": sum(n_ for n_, _ in on_device.values()), "spans": spans,
           "top_device_ms": [[k[:70], t, n_] for k, (n_, t) in top]}
    if kernels:
        out["kernel_device_ms"] = {k: sum(t for name, (_, t) in on_device.items() if k in name)
                                   for k in kernels}
    return out


def load_script(name):
    """A script of ``scripts/`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cvar_phases(dev, card, K2):
    """The CVaR slice's phases; returns its ``kernels`` entry."""
    from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step
    from belief_planning_tpu_torch.solvers import cvar_pl
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig

    cfg = CVaRIPMConfig(iters=24, gondzio=2)
    names = cvar_pl.CARRY_ORDER + ["gap"]
    f32, f64 = torch.float32, torch.float64

    # ---- kernel vs plain version on the card ---------------------------------
    def one_iteration(name, B, dtype, advance=0):
        """One launch against the plain version: at the first iteration, or
        after ``advance`` plain iterations with the index at early_iters (no
        early step cap)."""
        cplan, su, plain = cvar_case(name, dev, B, dtype, cfg)
        carry = su.carry0
        for itv in range(advance):    # a later carry of the same solve (plain steps)
            carry = plain(*su.in_args, itv, *carry)[:cvar_pl.CARRY_FIELDS]
        itv = cfg.early_iters if advance else 0
        got = su.step_fn(*su.in_args, itv, *carry)
        torch.cuda.synchronize()
        ref = plain(*su.in_args, itv, *carry)
        errs = scaled_err(got, ref, names)
        worst = max(errs, key=lambda k: errs[k][0])
        line = {"phase": "cvar_kernel_vs_plain", "config": name, "B": B,
                "dtype": str(dtype)[6:], "iteration": advance + 1, "itv": itv,
                "worst_field": worst,
                "worst_scaled": errs[worst][0], "max_abs_err": max(e[1] for e in errs.values())}
        if dtype == f64:
            emit({**line, "tol_scaled": F64_TOL, **card})
            if errs[worst][0] > F64_TOL:
                raise AssertionError(f"CVaR kernel disagrees with its plain version: {worst} "
                                     f"{errs[worst][0]:.3e} > {F64_TOL:.0e} ({name}, f64, B={B})")
        else:
            up = lambda ts: [t.double() for t in ts]
            ref64 = plain(*up(su.in_args), itv, *up(carry))
            acc = {}
            for nm, g, r, r64 in zip(names, got, ref, ref64):
                e_k = (g.double() - r64).abs().max().item()
                e_p = (r.double() - r64).abs().max().item()
                acc[nm] = (e_k, e_p, F32_ERR_RATIO * e_p + F32_FLOOR * r64.abs().max().item())
            del ref64
            bad = [nm for nm, (e_k, _, bar) in acc.items() if e_k > bar]
            emit({**line, "err_vs_f64": {nm: {"kernel": v[0], "plain": v[1], "bar": v[2]}
                                          for nm, v in acc.items()}, **card})
            if bad:
                raise AssertionError(f"f32 CVaR kernel less accurate than the plain version in "
                                     f"{bad} ({name}, B={B})")
        return cplan, su, plain, carry, max(e[1] for e in errs.values())

    def bound(su, cplan, B):
        """``(bound ms, what bounds it, bytes, flops)`` of one f32 iteration."""
        nbytes = cvar_iteration_bytes(su)
        flops = cvar_iteration_flops(cplan, su.dims, cfg.gondzio, B)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FLOPS["float32"] * 1e3
        return (t_bytes, "bytes", nbytes, flops) if t_bytes >= t_ops else \
            (t_ops, "operations", nbytes, flops)

    timing = {}
    for name in CVAR_CONFIGS:
        one_iteration(name, 1024, f64)
        one_iteration(name, 1024, f64, advance=4)
        cplan, su, plain, carry, err32 = one_iteration(name, BENCH_B, f32)
        k_ms = cuda_ms(lambda: su.step_fn(*su.in_args, 0, *carry), reps=3)
        plain_ms = cuda_ms(lambda: plain(*su.in_args, 0, *carry), reps=1)
        bound_ms, bound_by, nbytes, flops = bound(su, cplan, BENCH_B)
        ints = cvar_pl.kernel_ints(cplan, cfg, su.dims)
        plan = K2.plan(ints, BENCH_B, f32, dev.index)
        timing[name] = dict(ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            max_abs_err=err32)
        del su, carry, plain
        # the latency shape: B=256 (merge: the p50 cell of the main path), 2
        # trees a block, held to the plain version at the f32 bar as well
        cplan, su256, plain_fn, _, _ = one_iteration(name, 256, f32)
        ms256 = cuda_ms(lambda: su256.step_fn(*su256.in_args, 0, *su256.carry0), reps=20)
        plain256 = cuda_ms(lambda: plain_fn(*su256.in_args, 0, *su256.carry0), reps=3)
        b256 = bound(su256, cplan, 256)
        plan256 = K2.plan(ints, 256, f32, dev.index)
        elem = 4
        emit({"phase": "cvar_kernel_time", "config": name, "B": BENCH_B, "dtype": "float32",
              "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "bytes": nbytes, "flops": flops, "bytes_ms": nbytes / H100_BYTES_PER_S * 1e3,
              "flops_ms": flops / H100_FLOPS["float32"] * 1e3,
              "ms_B256": ms256, "plain_ms_B256": plain256, "bound_ms_B256": b256[0],
              "bound_by_B256": b256[1],
              # the launch plan: a warp (team) per tree, a persistent grid
              "trees_per_block": plan["trees_per_block"],
              "blocks_per_sm": plan["blocks_per_sm"],
              "resident_teams_per_sm": plan["trees_per_block"] * plan["blocks_per_sm"],
              "blocks": plan["blocks"], "smem_bytes_per_block": plan["smem_bytes"],
              "scratch_bytes": plan["scratch_elems"] * elem,
              "scratch_bytes_per_team": plan["scratch_elems"] * elem
              // (plan["blocks"] * plan["trees_per_block"]),
              "blocks_B256": plan256["blocks"], "trees_per_block_B256": plan256["trees_per_block"],
              **card})
        del su256, plain_fn
        torch.cuda.empty_cache()

    # ---- the main path, per configuration ------------------------------------
    def drive(name, B, steps, stepper, init, pset, dtype=f32, device=dev):
        xs, zs, xRefs, S, bx = cvar_states(name, B, device, dtype)
        kw = {} if S is None else dict(S=S, bx=bx)
        c = init(B, dtype)
        c, res = stepper(c, xs, zs, xRefs, pset.params, **kw)     # warm-up step
        _ = res.uPred.cpu()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            _c, res = stepper(c, xs, zs, xRefs, pset.params, **kw)
            _ = res.uPred.cpu()
            times.append(time.perf_counter() - t0)
        return res, times, (c, xs, zs, xRefs, kw)

    steps = 5
    main_launches = None
    res256 = None
    for name in CVAR_CONFIGS:
        model, params, pset, _, ralpha, use_S = cvar_config(name)
        topo, _, init, step = make_cvar_mpc_batched_step(model, params, ralpha, ipm=cfg,
                                                         use_S=use_S)
        K2.launches = 0
        res, times, warm = drive(name, BENCH_B, steps, step, init, pset)
        launches = K2.launches
        u, gap = res.uPred, res.gap
        finite = all(bool(t.isfinite().all()) for t in (res.xPred, u, res.slack, res.risk, gap))
        shapes_ok = (tuple(u.shape) == (BENCH_B, topo.totalu, d)
                     and tuple(res.xPred.shape) == (BENCH_B, topo.totalx, n))
        med = float(np.median(times))
        line = {"phase": "cvar_main_path", "config": name, "B": BENCH_B, "N": params.N,
                "NB": params.NB, "m": model.m, "ipm_iters": cfg.iters, "gondzio": cfg.gondzio,
                "dtype": "float32", "steps_timed": steps, "step_ms_median": med * 1e3,
                "step_ms_all": [t * 1e3 for t in times], "solves_per_s": BENCH_B / med,
                "launches": launches, "launches_expected": cfg.iters * (steps + 1),
                "finite": finite, "shapes_ok": shapes_ok,
                "gap_p50": float(gap.median()), "gap_max": float(gap.max()),
                "max_abs_a": u[..., 0].abs().max().item(),
                "max_abs_r": u[..., 1].abs().max().item()}
        if name == "cvar_merge":
            main_launches = launches
            res256, times256, _ = drive(name, 256, 10, step, init, pset)
            line["p50_ms_B256"] = float(np.median(times256)) * 1e3
            line["p50_limit_ms"] = 100.0
            line["gap_p50_B256"] = float(res256.gap.median())
        emit({**line, **card})
        if not (finite and shapes_ok):
            raise AssertionError(f"{name} main path: non-finite outputs or wrong shapes")
        if launches != cfg.iters * (steps + 1):
            raise AssertionError(f"{name} main path: {launches} kernel launches, expected "
                                 f"{cfg.iters * (steps + 1)}")
        c, xs, zs, xRefs, kw = warm
        for B_prof in (BENCH_B, 256):
            if B_prof == 256:
                if name != "cvar_merge":
                    break
                xs, zs, xRefs, S, bx = cvar_states(name, 256, dev, f32)
                kw = {} if S is None else dict(S=S, bx=bx)
                c, _ = step(init(256, f32), xs, zs, xRefs, pset.params, **kw)
            out = profile_step(lambda: step(c, xs, zs, xRefs, pset.params, **kw)[1].uPred.cpu())
            emit({"phase": "cvar_main_path_profile", "config": name, "B": B_prof, **out, **card})
        del res, warm, c
        torch.cuda.empty_cache()

    # ---- the merge in f64 on the card against the CPU ---------------------------
    name = "cvar_merge"
    model, params, pset, _, ralpha, _ = cvar_config(name)
    outs = {}
    for where, dv in (("cuda", dev), ("cpu", torch.device("cpu"))):
        _, _, in_, st_ = make_cvar_mpc_batched_step(model, params, ralpha, ipm=cfg, use_S=True,
                                                    device=dv)
        xs, zs, xRefs, S, bx = cvar_states(name, 64, dv, f64)
        c = in_(64, f64)
        seq = []
        for _ in range(2):
            c, r = st_(c, xs, zs, xRefs, pset.params, S=S, bx=bx)
            seq.append((r.uPred.cpu(), r.xPred.cpu()))
        outs[where] = seq
    du = max((a[0] - b[0]).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    dx = max((a[1] - b[1]).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    lanes_du = [int(((a[0] - b[0]).abs().amax((1, 2)) > 1e-7).sum())
                for a, b in zip(outs["cuda"], outs["cpu"])]
    # one solve of the same first-step data: the kernel on the card, the plain
    # version on the CPU, from identical (CPU-built) constants and carry
    cplan, su, _ = cvar_case(name, torch.device("cpu"), 64, f64, cfg, floor_mixed=False)
    step_gpu = cvar_pl.fused_cvar_iteration(cplan, cfg, su.dims)
    gaps = {}
    for where, fn, to in (("cuda", step_gpu, lambda t: t.to(dev)),
                          ("cpu", su.step_fn, lambda t: t)):
        ia = [to(t) for t in su.in_args]
        cy = tuple(to(t) for t in su.carry0)
        g = []
        for itv in range(cfg.iters):
            out = fn(*ia, itv, *cy)
            cy = out[:cvar_pl.CARRY_FIELDS]
            g.append(out[cvar_pl.CARRY_FIELDS].reshape(-1).cpu())
        gaps[where] = torch.stack(g)
    g_gpu, g_cpu = gaps["cuda"][:10], gaps["cpu"][:10]
    rel10 = ((g_gpu - g_cpu).abs() / g_cpu.abs()).max().item()
    ok10 = bool(torch.allclose(g_gpu, g_cpu, rtol=1e-8, atol=1e-10))
    rel_all = ((gaps["cuda"] - gaps["cpu"]).abs() / gaps["cpu"].abs()).amax(1).tolist()
    emit({"phase": "cvar_main_path_vs_cpu", "config": name, "B": 64, "dtype": "float64",
          "steps": 2, "max_abs_du": du, "max_abs_dx": dx, "lanes_du_over_1e-7": lanes_du,
          "gaps_first10_max_rel": rel10,
          "gaps_first10_ok": ok10, "gaps_max_rel_per_iter": rel_all, **card})
    if not ok10:
        raise AssertionError(f"CVaR f64 solve on the card vs CPU: first 10 gaps differ "
                             f"(max rel {rel10:.3e})")

    # ---- the f64 restart through the double kernel ------------------------------
    _, _, init_r, step_r = make_cvar_mpc_batched_step(model, params, ralpha, ipm=cfg,
                                                      use_S=True, refine_f64=8)
    K2.launches = 0
    res_r, times_r, _ = drive(name, 256, 1, step_r, init_r, pset)
    finite_r = all(bool(t.isfinite().all()) for t in (res_r.uPred, res_r.xPred, res_r.gap))
    emit({"phase": "cvar_refine_f64", "config": name, "B": 256, "refine_iters": 8,
          "launches": K2.launches, "launches_expected": 2 * (cfg.iters + 8),
          "finite": finite_r, "gap_p50": float(res_r.gap.median()),
          "gap_p50_f32_only": float(res256.gap.median()), "step_ms": times_r[0] * 1e3, **card})
    if K2.launches != 2 * (cfg.iters + 8) or not finite_r:
        raise AssertionError("CVaR refine_f64 step: wrong launch count or non-finite output")

    t = timing["cvar_merge"]
    return {"name": "cvar_ipm_iter", "route": "cuda",
            "source": "belief_planning_tpu_torch/csrc/cvar_ipm_iter.cu",
            "replaces": "belief_planning_tpu/solvers/cvar_pl.py:1057",
            "launches": main_launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}


# ---- the cone-ADMM slice and the K1 profile -----------------------------------

SOC_K = 2 + n + d          # cone row length of the CVaR ADMM: (1+t, x rows, u rows, 1−t)
ADMM_ITERS = 400
ADMM_EARLY_ITERS = 30
# the shorter ADMM solves that keep the script inside its time: the projection
# check on the main path's rows and the profile run 30 and 20 iterations of
# the 400-iteration solve (the profiler's trace of a launch-bound solve takes
# longer to read than the solve), the card-vs-CPU check 30 and 100
ADMM_TAP_ITERS = 30
ADMM_PROFILE_ITERS = 10
ADMM_LATE_ITERS = 100


def soc_test_rows(rows, dtype, dev, seed=0):
    """Random cone rows over five decades of scale, then the tie rows:
    ‖u‖ = t (kept), ‖u‖ = −t (zeroed), u = 0 with t < 0 (zeroed), t = 0 with
    u ≠ 0 (halved), t = 0 with u = 0, u = 0 with t > 0 (kept)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(rows, SOC_K)) * 10.0 ** rng.uniform(-2, 3, (rows, 1))
    ties = np.zeros((6, SOC_K))
    ties[0, :3] = [5.0, 3.0, 4.0]
    ties[1, :3] = [-5.0, 3.0, 4.0]
    ties[2, 0] = -2.0
    ties[3, 1:] = rng.normal(size=SOC_K - 1)
    ties[5, 0] = 1.5
    return torch.as_tensor(np.concatenate([ties, v]), dtype=dtype, device=dev)


def admm_problem(dev, B, dtype):
    """``cvar_solve``'s inputs on the CVaR overtake (N=8, NB=2, m=3, ralpha
    0.9): the bench's states, tree built in f64 on ``dev`` from a cold
    ``u_lin``, cast to ``dtype``."""
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
    from belief_planning_tpu_torch.tree.engine import TreeState, build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology

    model, params, pset, _, ralpha, _ = cvar_config("cvar_overtake")
    topo = build_topology(params.N, params.NB, model.m, n, d)
    f64 = torch.float64
    xs, zs, xRefs, _, _ = cvar_states("cvar_overtake", B, dev, f64)
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, d, dtype=f64, device=dev),
                    cast_params(pset.params, f64, dev))
    ts = TreeState(*(a.to(dtype) for a in ts))
    args = (build_cvar_plan(topo), ts, params.Q, params.R, params.Qslack, xRefs[0].cpu().numpy(),
            ralpha, params.Fx, params.bx, params.Fu, params.bu, xs.to(dtype))
    return topo, args


def admm_cfg(iters=ADMM_ITERS):
    from belief_planning_tpu_torch.solvers.cvar import CVaRConfig
    return CVaRConfig(rho4=10.0, rho5=10.0, rho_eq=10.0, rho_sign=10.0, iters=iters)


def run_admm_phases(dev, card, K3):
    """The cone-ADMM CVaR solve and its SOC projection kernel; returns the
    kernel's ``kernels`` entry."""
    from belief_planning_tpu_torch.ops import soc
    from belief_planning_tpu_torch.ops.soc import proj_soc
    from belief_planning_tpu_torch.solvers.cvar import _proj_soc_batch, cvar_solve

    f32, f64 = torch.float32, torch.float64
    # ---- the kernel against its plain version on the card -----------------------
    # Errors are scaled by the input row's magnitude: near ‖u‖ = −t the scale
    # a = ½(1 + t/‖u‖) cancels, so an output row can be far smaller than its
    # input while its rounding error stays of the input's order.
    bars = {f64: 1e-14, f32: 1e-6}

    def row_scaled(got, ref, v):
        """Worst |kernel − plain| of a row over the input row's magnitude."""
        row_mag = v.abs().amax(1).clamp(min=torch.finfo(v.dtype).tiny)
        return ((got - ref).abs().amax(1) / row_mag).amax().item()

    def general_k5(v):            # rows of length 5: the general path
        return v[:, :5].contiguous()

    def general_unaligned(v):     # the k = 8 rows one scalar past a 16-byte boundary
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        view = buf[1:].view(v.shape)
        view.copy_(v)
        return view

    # the team path (k = 8, aligned: the ADMM's rows), then the general path
    # on rows of length 5 and on an unaligned view of the same rows
    cases = [(dtype, path, make) for dtype in (f64, f32)
             for path, make in (("team", None), ("general", general_k5),
                                ("general", general_unaligned))]
    for dtype, path, make in cases:
        v = soc_test_rows(1 << 20, dtype, dev)
        if make is not None:
            v = make(v)
        before = dict(K3.path_launches)
        got = proj_soc(v)
        torch.cuda.synchronize()
        took = [q for q in K3.path_launches if K3.path_launches[q] != before[q]]
        ref = _proj_soc_batch(v)
        rel = row_scaled(got, ref, v)
        ties_exact = bool(torch.equal(got[:3], ref[:3]))
        emit({"phase": "soc_kernel_vs_plain", "dtype": str(dtype)[6:], "rows": v.shape[0],
              "k": v.shape[1], "aligned_16B": v.data_ptr() % 16 == 0, "path": took,
              "worst_row_scaled": rel, "tol_row_scaled": bars[dtype],
              "max_abs_err": (got - ref).abs().max().item(), "ties_exact": ties_exact, **card})
        if not (rel <= bars[dtype] and ties_exact and took == [path]):
            raise AssertionError(f"proj_soc kernel disagrees with its plain version: {rel:.3e} "
                                 f"> {bars[dtype]:.0e} of an input row's magnitude ({dtype}, "
                                 f"{path} path; took {took}), or a tie row differs")
        del v, got, ref

    # ---- its time at the ADMM path's shape, f32 and f64 -------------------------
    rows = BENCH_B * 97                       # trees × stages (totalu = 97)
    timing = {}
    for dtype in (f32, f64):
        v = soc_test_rows(rows - 6, dtype, dev, seed=1)
        got, ref = proj_soc(v), _proj_soc_batch(v)
        err, rel = (got - ref).abs().max().item(), row_scaled(got, ref, v)
        del got, ref
        k_ms = cuda_ms(lambda: proj_soc(v), reps=20)
        plain_ms = cuda_ms(lambda: _proj_soc_batch(v), reps=5)
        nbytes = 2 * v.numel() * v.element_size()
        flops = rows * (3 * SOC_K + 10)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FLOPS[str(dtype)[6:]] * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        timing[dtype] = dict(ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err)
        emit({"phase": "soc_kernel_time", "rows": rows, "k": SOC_K, "dtype": str(dtype)[6:],
              "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "share_of_bound": bound_ms / k_ms, "path_launches": dict(K3.path_launches),
              "bytes": nbytes, "flops": flops, "GB_per_s": nbytes / k_ms / 1e6,
              "max_abs_err": err, "worst_row_scaled": rel, "tol_row_scaled": bars[dtype],
              **card})
        if not rel <= bars[dtype]:
            raise AssertionError(f"proj_soc kernel disagrees with its plain version at the "
                                 f"ADMM shape: {rel:.3e} > {bars[dtype]:.0e} ({dtype})")
        del v

    # ---- the kernel on the cone rows the main path projects ---------------------
    # The main path's solve, its first ADMM_TAP_ITERS iterations, with every
    # projection of its z-update also run by the plain version (f64) and by
    # the kernel and the plain version on the rows cast to f32; not counted as
    # the main path's launches.
    cfg = admm_cfg(ADMM_TAP_ITERS)
    topo, args = admm_problem(dev, BENCH_B, f64)
    worst = {f64: 0.0, f32: 0.0}
    calls = []

    def tapped(v):                # cvar_solve looks proj_soc up in ops.soc at each call
        got = proj_soc(v)
        worst[f64] = max(worst[f64], row_scaled(got, _proj_soc_batch(v), v))
        v32 = v.float()
        worst[f32] = max(worst[f32], row_scaled(proj_soc(v32), _proj_soc_batch(v32), v32))
        calls.append(v.shape[0])
        return got

    soc.proj_soc = tapped
    try:
        cvar_solve(*args, cfg=cfg)
    finally:
        soc.proj_soc = proj_soc
    emit({"phase": "soc_kernel_on_admm_rows", "config": "cvar_overtake", "B": BENCH_B,
          "admm_iters": cfg.iters, "projections": len(calls), "rows_per_projection": calls[0],
          "worst_row_scaled": {"float64": worst[f64], "float32": worst[f32]},
          "tol_row_scaled": {"float64": bars[f64], "float32": bars[f32]}, **card})
    if not (worst[f64] <= bars[f64] and worst[f32] <= bars[f32]):
        raise AssertionError(f"proj_soc kernel disagrees with its plain version on the main "
                             f"path's cone rows: {worst}")
    if len(calls) != cfg.iters + 2 or calls[0] != BENCH_B * topo.totalu:
        raise AssertionError(f"ADMM solve: {len(calls)} projections of {calls[0]} rows")

    cfg = admm_cfg()

    # ---- the main path: a batched cvar_solve at B=32768, f64 ------------------
    # f64, not f32: the Woodbury correction cancels terms ~1e6 times larger than
    # its result, and in f32 the ADMM diverges to NaN on this problem in the
    # JAX package as in the port (scripts/torch_port_admm_chaos.py overtake_f32).
    torch.cuda.synchronize()
    K3.launches = 0
    K3.path_launches = dict.fromkeys(K3.PATHS, 0)
    t0 = time.perf_counter()
    x, u, s, st, aux = cvar_solve(*args, cfg=cfg)
    u_host = u.cpu()
    solve_s = time.perf_counter() - t0
    launches, paths = K3.launches, dict(K3.path_launches)
    finite = all(bool(t.isfinite().all()) for t in (x, u_host, s, st.risk, aux["prim_res"],
                                                    aux["J"]))
    shapes_ok = (tuple(u.shape) == (BENCH_B, topo.totalu, d)
                 and tuple(x.shape) == (BENCH_B, topo.totalx, n))
    prof = profile_step(lambda: cvar_solve(*args, cfg=admm_cfg(ADMM_PROFILE_ITERS))[1].cpu(),
                        kernels=("proj_soc",))
    k3_share = prof["kernel_device_ms"]["proj_soc"] / max(prof["device_busy_ms"], 1e-30)
    emit({"phase": "admm_main_path", "config": "cvar_overtake", "B": BENCH_B, "N": 8, "NB": 2,
          "m": 3, "ralpha": 0.9, "dtype": "float64", "admm_iters": cfg.iters,
          "solve_ms": solve_s * 1e3, "solves_per_s": BENCH_B / solve_s,
          "launches": launches, "launches_expected": cfg.iters + 2, "path_launches": paths,
          "finite": finite, "shapes_ok": shapes_ok,
          "prim_res_p50": float(aux["prim_res"].median()),
          "prim_res_max": float(aux["prim_res"].max()), "J_p50": float(aux["J"].median()),
          "profile_admm_iters": ADMM_PROFILE_ITERS,
          "k3_device_ms": prof["kernel_device_ms"]["proj_soc"], "k3_share_of_device": k3_share,
          "profile": {k: prof[k] for k in ("wall_ms_profiled", "device_busy_ms",
                                           "device_idle_share", "device_ops", "top_device_ms")},
          **card})
    if not (finite and shapes_ok):
        raise AssertionError("ADMM main path: non-finite outputs or wrong shapes")
    if launches != cfg.iters + 2 or paths["team"] != launches:
        raise AssertionError(f"ADMM main path: {launches} proj_soc launches ({paths}), expected "
                             f"{cfg.iters + 2}, all on the team path")
    del x, u, s, st, aux, args
    torch.cuda.empty_cache()

    # ---- the same solve in f64 on the card and on the CPU ---------------------
    # Held after 30 and after 100 iterations. The bar is as wide as the
    # reference's own reproducibility: the JAX package's jitted and eager runs
    # of this solve part by 2.7e-8 in u after 30 iterations and 1.0e-7 after
    # 400 on these states (scripts/torch_port_admm_chaos.py overtake 64).
    cpu = torch.device("cpu")
    _, args_cpu = admm_problem(cpu, 64, f64)
    res = {}
    for iters in (ADMM_EARLY_ITERS, ADMM_LATE_ITERS):
        c = admm_cfg(iters)
        on_card = cvar_solve(*args_cpu, cfg=c)          # moves the CPU-built inputs to the card
        on_cpu = cvar_solve(*args_cpu, cfg=c, device="cpu")
        res[iters] = ((on_card[1].cpu() - on_cpu[1]).abs().max().item(),
                      (on_card[0].cpu() - on_cpu[0]).abs().max().item())
    emit({"phase": "admm_vs_cpu", "config": "cvar_overtake", "B": 64, "dtype": "float64",
          "max_abs_du": {str(k): v[0] for k, v in res.items()},
          "max_abs_dx": {str(k): v[1] for k, v in res.items()}, "tol_du": 1e-7, **card})
    bad = [k for k, v in res.items() if not v[0] <= 1e-7]
    if bad:
        raise AssertionError(f"ADMM f64 solve on the card vs CPU: |du| > 1e-7 after {bad} "
                             "iterations")
    return {"name": "proj_soc", "route": "cuda",
            "source": "belief_planning_tpu_torch/csrc/proj_soc.cu",
            "replaces": "belief_planning_tpu/ops/pallas_kernels.py:42",
            "launches": launches, "dtype": "float64", **timing[f64], "library_ms": None}


def phase_cost(plan, nFx, nFu, phase, lanes):
    """Least bytes (f32) and operations of one phase kernel at ``lanes``:
    the inputs it reads once and t0 written; operations counted from the
    kernel's loops (multiply-add = 2) per stage: the barrier weights and the
    Riccati step, for phase 1 also the linear sweep and the rollout."""
    topo = plan.topo
    nx, nu = topo.n, topo.d
    nd, nc, nf = nx + nu, nFx + 1, nFu
    U, X = topo.totalu, topo.totalx
    nleaf = len(plan.leaf_ids)
    elems = (U * (2 * nx * nx + 2 * nu * nu + nx * nu + nx) + nleaf * nx * nx + 1
             + U * (4 * nc + 2 * nf) + 1)
    riccati = (3 * nc + 2 * nx * nx + 3 * (nc - 1) * nx * nx + 2 * nx * nx + 3 * nf * nu * nu
               + 2 * nu * nx * nx + 2 * nu * nu * nx + nu * nu * (2 * nx + 4)
               + 4 * nu * nx * nx + 2 * nu * nd * nu + 2 * nx * nx * nx
               + 2 * nd * nd * nu + 2 * nx * nx * nx + 3 * nx * nx + 2 * nd * nd
               + nx * nd * 2 * nu + 12)
    per_stage = riccati + 2 * (2 * nc + nf) + 3 * nc + nu * nd + nu * nu
    if phase == 1:
        elems += U * (nx + nu) + nleaf * nx
        per_stage += (nu * (2 * nx + 2) + nu * 2 * nu + nd * (2 * nd + 2 * nu) + nx
                      + nu * 2 * nd + nd * 2 * nd + nx * 2 * nu + nx + nu)
    return elems * 4 * lanes, per_stage * U * lanes


def run_k1_phases(dev, card, K, k1_ms):
    """The K1 profile: its phase kernels against their plain versions, then
    the profile script's timing at B=2048 and B=32768; returns the phase
    kernels' ``kernels`` entry."""
    from belief_planning_tpu_torch.solvers import tree_qp_pl
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    prof = load_script("torch_port_profile_ipm_kernel")
    cfg = QPIPMConfig(iters=12)
    nFx, nFu = 4, 4

    errs = {}
    for phase in (0, 1):
        plan, _, su = qp_case(dev, 1024, torch.float64, cfg)
        mtot = float(plan.topo.totalu * (2 * (nFx + 1) + nFu))
        got = tree_qp_pl.phase_step(plan, cfg, nFx, nFu, mtot, phase)(*su.const_args, *su.carry0)
        torch.cuda.synchronize()
        ref = tree_qp_pl.make_phase(plan, cfg, nFx, nFu, mtot, phase)(*su.const_args, *su.carry0)
        scaled = ((got - ref).abs().max() / ref.abs().max()).item()
        errs[phase] = (got - ref).abs().max().item()
        emit({"phase": "k1_phases_vs_plain", "k1_phase": phase, "B": 1024, "dtype": "float64",
              "worst_scaled": scaled, "max_abs_err": errs[phase], "tol_scaled": F64_TOL, **card})
        if not scaled <= F64_TOL:
            raise AssertionError(f"K1 phase {phase} kernel disagrees with its plain version: "
                                 f"{scaled:.3e} > {F64_TOL:.0e}")

    # phases 0 and 1 at the profile path's shapes, on its own (f32) inputs:
    # f32 held to the accuracy bar against the plain version in f64 on the
    # upcast inputs, and at B=32768 the f64 kernel against it at 1e-10
    for B in (2048, BENCH_B):
        plan, nFx_, nFu_, mtot, ca, c0 = prof.prep_inputs(B, dev, cfg)
        up = [t.double() for t in (*ca, *c0)]
        for phase in (0, 1):
            r64 = tree_qp_pl.make_phase(plan, cfg, nFx_, nFu_, mtot, phase)(*up)
            got = tree_qp_pl.phase_step(plan, cfg, nFx_, nFu_, mtot, phase)(*ca, *c0)
            ref = tree_qp_pl.make_phase(plan, cfg, nFx_, nFu_, mtot, phase)(*ca, *c0)
            e_k = (got.double() - r64).abs().max().item()
            e_p = (ref.double() - r64).abs().max().item()
            mag = r64.abs().max().item()
            bar = F32_ERR_RATIO * e_p + F32_FLOOR * mag
            line = {"phase": "k1_phases_vs_plain", "k1_phase": phase, "B": B,
                    "dtype": "float32", "err_vs_f64": {"kernel": e_k, "plain": e_p, "bar": bar}}
            if B == BENCH_B:
                g64 = tree_qp_pl.phase_step(plan, cfg, nFx_, nFu_, mtot, phase)(*up)
                scaled = ((g64 - r64).abs().max() / mag).item()
                line["float64"] = {"worst_scaled": scaled, "tol_scaled": F64_TOL}
            emit({**line, **card})
            if e_k > bar:
                raise AssertionError(f"K1 phase {phase} f32 kernel less accurate than its plain "
                                     f"version (B={B}): {e_k:.3e} > {bar:.3e}")
            if B == BENCH_B and not scaled <= F64_TOL:
                raise AssertionError(f"K1 phase {phase} kernel disagrees with its plain version "
                                     f"(f64, B={B}): {scaled:.3e} > {F64_TOL:.0e}")
        del up, ca, c0
    torch.cuda.empty_cache()

    # the profile path: every phase kernel, launched by the profile script
    # (phases 0 and 1 count as phase launches; phase 2 is the main kernel,
    # launched also by the one main-path step of the script's input prep)
    reps = 12
    runs = {2048: 8, BENCH_B: 3}
    K.phase_launches = K.launches = 0
    t = {B: prof.profile_phases(B, dev, reps, times) for B, times in runs.items()}
    launches, full_launches = K.phase_launches, K.launches
    expected = sum(2 * (1 + times * reps) for times in runs.values())
    full_expected = sum(cfg.iters + 1 + times * reps for times in runs.values())
    for B, tb in t.items():
        per = {k: v / reps for k, v in tb.items()}
        emit({"phase": "k1_phases", "B": B, "dtype": "float32", "reps": reps,
              "per_iter_ms": per, "linear_forward_ms": per["kkt1"] - per["factor"],
              "bookkeeping_second_solve_ms": per["full"] - per["kkt1"],
              "k1_kernel_time_ms_B32768": k1_ms, "summary": prof.summary_lines(B, reps, tb),
              **card})
    if full_launches != full_expected:
        raise AssertionError(f"K1 profile: {full_launches} full-iteration launches, expected "
                             f"{full_expected}")
    if launches != expected:
        raise AssertionError(f"K1 profile: {launches} phase-kernel launches, expected {expected}")

    # the kernels line's entry: phase 0 (the factor) at the profile's batch
    plan, nFx_, nFu_, mtot, ca, c0 = prof.prep_inputs(2048, dev, cfg)
    plain = tree_qp_pl.make_phase(plan, cfg, nFx_, nFu_, mtot, 0)
    plain_ms = cuda_ms(lambda: plain(*ca, *c0), reps=3)
    nbytes, flops = phase_cost(plan, nFx_, nFu_, 0, 2048)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS["float32"] * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    bounds = {}
    for B in runs:
        for ph in (0, 1):
            b_, f_ = phase_cost(plan, nFx_, nFu_, ph, B)
            bounds[f"B{B}_phase{ph}"] = max(b_ / H100_BYTES_PER_S, f_ / H100_FLOPS["float32"]) * 1e3
    emit({"phase": "k1_phases_bound", "bound_ms": bounds, "plain_ms_phase0_B2048": plain_ms,
          **card})
    return {"name": "tree_qp_phase", "route": "cuda",
            "source": "belief_planning_tpu_torch/csrc/tree_qp_ipm_iter.cu",
            "replaces": "scripts/profile_ipm_kernel.py:237",
            "launches": launches, "max_abs_err": max(errs.values()),
            "ms": t[2048]["factor"] / reps, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ---- slice 4: the per-tree IPM steps and the shared-row probe (K5) ---------------

# The pins' batches. The QP pin runs the main path's IPM-8 with 2 Gondzio
# correctors: at more iterations a few of 1024 lanes stall near gap 1e-8,
# where u is determined to no better than ~1e-6 and the two solvers' iterates
# part in u by 1e-7..1e-5 (as the reference's two solvers do). The CVaR
# pin's root-u bar (2e-2) is the reference's, set at its 4 lanes; late
# iterates of the overtake part by up to 1.4e-2 at 256 lanes (CPU, f64).
QP_PIN_B = 1024
CVAR_PIN_B = 64
# the per-tree CVaR steps at a quarter of the main paths' batch, to keep the
# script inside its time (at B=32768 a cold step took 22-31 s a configuration)
PER_TREE_CVAR_B = 8192


def run_shared_rows_phases(dev, card, K5):
    """K5 against its plain version, then the probe script's timing at the
    reference's default size and at the main path's width; returns K5's
    ``kernels`` entry."""
    from belief_planning_tpu_torch.ops.shared_rows import MODES, shared_rows, shared_rows_plain

    probe = load_script("torch_port_mxu_probe")
    inner, reps = 64, 8
    sizes = ((4096, 25), (BENCH_B, 97))      # the reference's default; B x the QP's totalu
    errs = {}
    for B, nodes in sizes:
        Fx, dx = probe.probe_inputs(B, nodes, dev)
        p64, cur64 = shared_rows_plain(Fx.double(), dx.double(), inner, return_cur=True)
        e_plain = (shared_rows_plain(Fx, dx, inner).double() - p64).abs().max().item()
        mag = p64.abs().max().item()
        # bf16 operands: each product's operands carry a relative error of
        # at most 2^-9, so every output is within 2^-7 · Σ_k |Fx[r,k]|·|cur[k]|
        bar16 = 2.0 ** -7 * torch.einsum("rk,nkb->nrb", Fx.double().abs(), cur64.abs())
        outs, line = {}, {"phase": "shared_rows_vs_plain", "B": B, "nodes": nodes,
                          "inner": inner, "plain_f32_err_vs_f64": e_plain}
        for mode in MODES:
            outs[mode] = shared_rows(Fx, dx, inner, mode)
            torch.cuda.synchronize()
            diff = (outs[mode].double() - p64).abs()
            if mode == "bf16":
                ratio = (diff / bar16).max().item()
                line[mode] = {"max_abs_err": diff.max().item(), "worst_err_over_bar": ratio,
                              "differs_from_fma": bool((outs[mode] != outs["fma"]).any())}
                ok = ratio <= 1.0 and line[mode]["differs_from_fma"]
            else:
                bar = F32_ERR_RATIO * e_plain + F32_FLOOR * mag
                line[mode] = {"max_abs_err": diff.max().item(), "bar": bar}
                ok = diff.max().item() <= bar
            errs[(B, mode)] = diff.max().item()
            if not ok:
                emit({**line, **card})
                raise AssertionError(f"K5 {mode} disagrees with its plain version (B={B}, "
                                     f"nodes={nodes}): {line[mode]}")
        k64 = shared_rows(Fx.double(), dx.double(), inner, "fma")
        line["fma_f64_scaled_err"] = ((k64 - p64).abs().max() / mag).item()
        emit({**line, **card})
        if not line["fma_f64_scaled_err"] <= F64_TOL:
            raise AssertionError(f"K5 fma in f64 disagrees with its plain version: "
                                 f"{line['fma_f64_scaled_err']:.3e}")
        del Fx, dx, p64, cur64, outs, k64, bar16

    # the probe's path: every launch of the three modes counted
    for m in MODES:
        K5.launches[m] = 0
    runs = {B: probe.probe(B, nodes, inner, reps, 128, dev) for B, nodes in sizes}
    launches = dict(K5.launches)
    for B, r in runs.items():
        emit({"phase": "shared_rows_time", "B": B, "nodes": r["nodes"], "inner": inner,
              "reps": reps, "tile": r["tile"], "useful_flops": r["useful_flops"],
              "modes": r["modes"], "summary": r["lines"], **card})
    if launches != {m: len(sizes) * (1 + reps) for m in MODES}:
        raise AssertionError(f"K5 probe: launches {launches}, expected {1 + reps} per mode "
                             "and size")
    Fx, dx = probe.probe_inputs(BENCH_B, 97, dev)
    plain_ms = cuda_ms(lambda: shared_rows_plain(Fx, dx, inner), reps=2)
    full = runs[BENCH_B]["modes"]
    emit({"phase": "shared_rows_plain_time", "B": BENCH_B, "nodes": 97, "plain_ms": plain_ms,
          **card})
    return {"name": "shared_rows_probe", "route": "cuda",
            "source": "belief_planning_tpu_torch/csrc/shared_rows_probe.cu",
            "replaces": "scripts/mxu_probe.py:92",
            "launches": sum(launches.values()), "max_abs_err": errs[(BENCH_B, "fma")],
            "ms": full["fma"]["ms"], "plain_ms": plain_ms, "bound_ms": full["fma"]["bound_ms"],
            "bound_by": full["fma"]["bound_by"], "library_ms": None,
            "modes": {m: {"launches": launches[m], "ms": full[m]["ms"],
                          "bound_ms": full[m]["bound_ms"], "bound_by": full[m]["bound_by"],
                          "max_abs_err": errs[(BENCH_B, m)]} for m in MODES}}


def run_per_tree_phases(dev, card, K, K2):
    """The per-tree IPM steps: the QP's and the CVaR's main paths in f32 at
    B=32768, and the pins of the fused kernels K1 and K2 (in f64) against them."""
    from belief_planning_tpu_torch.controllers.branch_mpc import (
        make_branch_mpc_batched_step,
        make_branch_mpc_step,
    )
    from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_step
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve
    from belief_planning_tpu_torch.solvers.cvar_pl import cvar_ipm_solve_pl
    from belief_planning_tpu_torch.solvers.layout import _from_bl, _to_bl
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the solvers' einsums must run in full f32")
    f32, f64 = torch.float32, torch.float64

    def timed_step(run):
        """``run()`` → ``(carry, result)``, timed on the host up to ``uPred``
        on the host; returns ``(carry, result, seconds)``."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c_, r_ = run()
        r_.uPred.cpu()
        return c_, r_, time.perf_counter() - t0

    # ---- the per-tree QP step at the bench config, f32, B=32768 ------------------
    pset, model, params = overtake_setup()
    ipm = QPIPMConfig()
    topo, init, step = make_branch_mpc_step(model, params, "prox", ipm=ipm)
    xs, zs, xRefs = (torch.as_tensor(a, dtype=f32, device=dev) for a in bench_states(BENCH_B))
    c, _ = step(init(BENCH_B, f32), xs, zs, xRefs, pset.params)          # cold step
    _, res, sec = timed_step(lambda: step(c, xs, zs, xRefs, pset.params))
    finite = all(bool(t.isfinite().all()) for t in (res.xPred, res.uPred, res.prim_res, res.gap))
    line = {"phase": "qp_ipm_main_path", "B": BENCH_B, "N": N, "NB": NB,
            "ipm_iters": ipm.iters, "gondzio": ipm.gondzio, "dtype": "float32",
            "step_ms": sec * 1e3, "solves_per_s": BENCH_B / sec, "finite": finite,
            "feasible_share": res.feasible.float().mean().item(),
            "prim_res_p50": float(res.prim_res.median()), "gap_p50": float(res.gap.median()),
            "max_abs_a": res.uPred[..., 0].abs().max().item(),
            "max_abs_r": res.uPred[..., 1].abs().max().item()}
    # where a step's time goes, profiled over 4 of its iterations (the trace
    # of a whole launch-bound step takes longer to read than the step)
    step_p = make_branch_mpc_step(model, params, "prox", ipm=QPIPMConfig(iters=4))[2]
    prof = profile_step(lambda: step_p(c, xs, zs, xRefs, pset.params)[1].uPred.cpu())
    emit({**line, "profile_4_iters": prof, **card})
    if not finite or tuple(res.uPred.shape) != (BENCH_B, topo.totalu, d):
        raise AssertionError("per-tree QP main path: non-finite outputs or wrong shape")
    del c, res
    torch.cuda.empty_cache()

    # ---- the QP pin: fused K1 in double against the per-tree step ------------------
    pin_ipm = QPIPMConfig(iters=8, gondzio=2)
    _, init, step = make_branch_mpc_step(model, params, "prox", ipm=pin_ipm)
    _, init_f, step_f = make_branch_mpc_batched_step(model, params, "prox", ipm=pin_ipm)
    xs, zs, xRefs = (torch.as_tensor(a, dtype=f64, device=dev) for a in bench_states(QP_PIN_B))
    outs = []
    K.launches = 0
    for st_, in_ in ((step, init), (step_f, init_f)):
        cc, seq = in_(QP_PIN_B, f64), []
        for _ in range(2):
            cc, r = st_(cc, xs, zs, xRefs, pset.params)
            seq.append((r.uPred, r.xPred))
        outs.append(seq)
    du = [(a[0] - b[0]).abs().max().item() for a, b in zip(*outs)]
    dx = [(a[1] - b[1]).abs().max().item() for a, b in zip(*outs)]
    emit({"phase": "qp_ipm_pin", "B": QP_PIN_B, "dtype": "float64",
          "ipm_iters": pin_ipm.iters, "gondzio": pin_ipm.gondzio, "steps": 2,
          "max_abs_du": du, "max_abs_dx": dx, "k1_launches": K.launches,
          "tol_du": 1e-7, "tol_dx": 1e-6, **card})
    if K.launches != 2 * pin_ipm.iters:
        raise AssertionError(f"QP pin: {K.launches} K1 launches, expected {2 * pin_ipm.iters}")
    if not (max(du) < 1e-7 and max(dx) < 1e-6):
        raise AssertionError(f"QP pin: fused K1 vs the per-tree step |du| {du}, |dx| {dx}")
    del outs

    # ---- the per-tree CVaR step, f32, per configuration ------------------------------
    cfg = CVaRIPMConfig(iters=40)
    for name in CVAR_CONFIGS:
        model_c, params_c, pset_c, _, ralpha, use_S = cvar_config(name)
        topo_c, _, init_c, step_c = make_cvar_mpc_step(model_c, params_c, ralpha, ipm=cfg,
                                                       use_S=use_S)
        xs, zs, xRefs, S, bx = cvar_states(name, PER_TREE_CVAR_B, dev, f32)
        kw = {} if S is None else dict(S=S, bx=bx)
        # one cold step, timed: at many seconds of about half a million small
        # device ops, a warm-up step would change nothing but the script's time
        c, res, sec = timed_step(lambda: step_c(init_c(PER_TREE_CVAR_B, f32), xs, zs, xRefs,
                                                pset_c.params, **kw))
        finite = all(bool(t.isfinite().all()) for t in (res.xPred, res.uPred, res.gap, res.J))
        line = {"phase": "cvar_ipm_main_path", "config": name, "B": PER_TREE_CVAR_B,
                "N": params_c.N, "NB": params_c.NB, "m": model_c.m, "ipm_iters": cfg.iters,
                "dtype": "float32",
                "step_ms": sec * 1e3, "solves_per_s": PER_TREE_CVAR_B / sec, "finite": finite,
                "gap_p50": float(res.gap.median()), "gap_max": float(res.gap.max()),
                "J_p50": float(res.J.median())}
        if name == "cvar_overtake":
            # where a step's time goes, profiled over 4 of its iterations
            _, _, _, step_p = make_cvar_mpc_step(model_c, params_c, ralpha,
                                                 ipm=CVaRIPMConfig(iters=4), use_S=use_S)
            line["profile_4_iters"] = profile_step(
                lambda: step_p(c, xs, zs, xRefs, pset_c.params, **kw)[1].uPred.cpu())
        emit({**line, **card})
        if not finite or tuple(res.uPred.shape) != (PER_TREE_CVAR_B, topo_c.totalu, d):
            raise AssertionError(f"per-tree CVaR main path ({name}): non-finite outputs or "
                                 "wrong shape")
        del c, res
        torch.cuda.empty_cache()

    # ---- the CVaR pin: fused K2 in double against cvar_ipm_solve ---------------------
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology

    pin_cfg = CVaRIPMConfig(iters=60)
    for name in CVAR_CONFIGS:
        model_c, params_c, pset_c, _, ralpha, use_S = cvar_config(name)
        tp = build_topology(params_c.N, params_c.NB, model_c.m, n, d)
        cplan = build_cvar_plan(tp)
        xs, zs, xRefs, S, bx = cvar_states(name, CVAR_PIN_B, dev, f64)
        ts = build_tree(model_c, tp, xs, zs,
                        torch.zeros(CVAR_PIN_B, tp.totalu, d, dtype=f64, device=dev),
                        cast_params(pset_c.params, f64, dev))
        floor = (torch.arange(CVAR_PIN_B, device=dev) % 2 == 0) if use_S else None
        p = params_c
        _, u, _, _, aux = cvar_ipm_solve(cplan, ts, p.Q, p.R, p.Qslack, xRefs, ralpha, p.Fx,
                                         p.bx if bx is None else bx, p.Fu, p.bu, xs, S=S,
                                         cfg=pin_cfg, dh0_floor=floor)
        bl = lambda a: None if a is None else _to_bl(a)
        K2.launches = 0
        _, u_bl, _, _, aux_pl = cvar_ipm_solve_pl(
            cplan, bl(ts.A), bl(ts.Bm), bl(ts.dh), bl(ts.h0), bl(ts.x_lin), bl(ts.u_lin),
            bl(ts.p), p.Q, p.R, p.Qslack, bl(xRefs), ralpha, p.Fx,
            p.bx if bx is None else bl(bx), p.Fu, p.bu, cfg=pin_cfg, S_bl=bl(S), dh0_floor=floor)
        g, g_pl = aux["gaps"][:, :10], aux_pl["gaps"].T[:, :10]
        ok10 = bool(torch.allclose(g, g_pl, rtol=1e-8, atol=1e-10))
        rel = ((g - g_pl).abs() / g_pl.abs()).amax(0).tolist()
        du0 = (u[:, 0] - _from_bl(u_bl)[:, 0]).abs().max().item()
        emit({"phase": "cvar_ipm_pin", "config": name, "B": CVAR_PIN_B, "dtype": "float64",
              "ipm_iters": pin_cfg.iters, "k2_launches": K2.launches,
              "gaps_first10_max_rel": rel, "gaps_first10_ok": ok10, "root_du": du0,
              "tol_root_du": 2e-2, **card})
        if K2.launches != pin_cfg.iters:
            raise AssertionError(f"CVaR pin ({name}): {K2.launches} K2 launches")
        if not (ok10 and du0 < 2e-2):
            raise AssertionError(f"CVaR pin ({name}): first 10 gaps ok={ok10}, root |du| {du0}")


# ---- slice 8: the quadruped on K1 and the merge episode on K2 -----------------

QUAD_N = 25
QUAD_B = 8192
QUAD_DIMS = ((3, 3, 1, 6), (3, 3, 0, 6))   # the solve's (one inert row), the rows alone
MERGE_EPISODE_B = 32768
MERGE_EPISODE_STEPS = 5


def quad_cons():
    """The quadruped demo's constants (``examples/main_quadruped.py:24-29``)."""
    from belief_planning_tpu_torch.utils.config import QuadConstants

    return QuadConstants(s1=2, s2=3, c2=0.5, alpha=1, R=1.2, vxm=0.2, vym=0.1, rm=0.5,
                         L1=0.5, W1=0.3, L2=1.0, W2=0.6, col_tol=0.2, col_alpha=5)


def quad_config():
    """The quadruped's reference configuration (``scripts/bench_configs.py:
    193-222``): ``(pset, model, params)``."""
    from belief_planning_tpu_torch.models.policies import quadruped_policy_set
    from belief_planning_tpu_torch.models.predictive import quadruped_model
    from belief_planning_tpu_torch.presets import init_quad_branch_mpc

    pset = quadruped_policy_set(0.2)
    model = quadruped_model(quad_cons(), pset, N=QUAD_N, dt=0.2)
    params = init_quad_branch_mpc(3, 3, QUAD_N, 2, np.array([5.0, 5.0, 0.0]), 0.2, 0.1, 0.5)
    return pset, model, params


def quad_states(B, seed=0):
    """States drawn as the reference's quadruped bench draws them."""
    rng = np.random.default_rng(seed)
    xs = np.array([0.0, 1.8, 0.0]) + rng.normal(0, 0.3, (B, 3))
    zs = np.array([2.5, 2.5, -np.pi / 2]) + rng.normal(0, 0.3, (B, 3))
    return xs, zs, np.tile(np.array([5.0, 5.0, 0.0]), (B, 1))


def quad_case(dev, B, dtype, cfg, nFx):
    """K1's inputs on the quadruped (tree build and cost in f64 on the card,
    cast to ``dtype``): ``nFx`` 1 is the solve's setup, whose empty Fx gets
    one inert row; 0 takes that row out again. Returns ``(plan, setup, step,
    plain, mtot)``, step and plain being the kernel's and the plain version's
    iteration at those rows."""
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers import tree_qp_pl
    from belief_planning_tpu_torch.solvers.layout import _to_bl, cost_to_bl
    from belief_planning_tpu_torch.solvers.tree_qp import assemble_stage_cost, build_stage_plan
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology

    pset, model, params = quad_config()
    topo = build_topology(QUAD_N, 2, model.m, 3, 3)
    plan = build_stage_plan(topo)
    f64 = torch.float64
    t = lambda a: torch.as_tensor(a, dtype=f64, device=dev)
    xs, zs, xRefs = quad_states(B)
    ts = build_tree(model, topo, t(xs), t(zs), torch.zeros(B, topo.totalu, 3, dtype=f64, device=dev),
                    cast_params(pset.params, f64, dev))
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR,
                               params.Qslack, t(xRefs), torch.zeros(B, 3, dtype=f64, device=dev))
    cast = lambda a: _to_bl(a.to(dtype))
    su = tree_qp_pl.setup_ipm(plan, cost_to_bl(type(cost)(*(c.to(dtype) for c in cost))),
                              cast(ts.A), cast(ts.Bm), cast(ts.dh), cast(ts.h0), params.Fx,
                              params.bx, params.Fu, params.bu, cast(ts.x_lin), cast(ts.u_lin),
                              cfg)
    if nFx == 0:
        rows = {"s", "sl1", "lam1", "sl3", "lam3", "b1"}
        one = lambda nm, c: c[:, :1].contiguous() if nm in rows else (c[:0] if nm == "Fx" else c)
        su = su._replace(
            const_args=[one(nm, c) for nm, c in zip(tree_qp_pl.CONST_ORDER, su.const_args)],
            carry0=tuple(one(nm, c) for nm, c in zip(tree_qp_pl.CARRY_ORDER, su.carry0)))
    mtot = float(topo.totalu * (2 * (nFx + 1) + 6))
    return (plan, su, tree_qp_pl.fused_iteration(plan, cfg, nFx, 6, mtot),
            tree_qp_pl.make_iteration(plan, cfg, nFx, 6, mtot), mtot)


def run_quadruped_phases(dev, card, K):
    """The quadruped slice: K1 at the quadruped's dims against its plain
    version (f64 at B=256, two carries; f32 at B=8192 and 256) and timed,
    the phase kernels (K4) at those dims, then the quadruped main path.
    Returns K1's entries for those instantiations."""
    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step
    from belief_planning_tpu_torch.solvers import tree_qp_pl
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    f32, f64 = torch.float32, torch.float64
    cfg = QPIPMConfig(iters=8, gondzio=2)
    entries = []
    for dims in QUAD_DIMS:
        nFx = dims[2]
        base = {"phase": "quad_kernel_vs_plain", "dims": list(dims), "N": QUAD_N}
        plan, su, step, plain, mtot = quad_case(dev, 256, f64, cfg, nFx)
        carry = su.carry0
        for it in (1, 5):
            hold_iteration(step, plain, su.const_args, carry,
                           {**base, "B": 256, "dtype": "float64", "iteration": it}, card)
            for _ in range(4):
                carry = plain(*su.const_args, *carry)[:tree_qp_pl.CARRY_FIELDS]
        for phase in (0, 1):
            got = tree_qp_pl.phase_step(plan, cfg, nFx, 6, mtot, phase)(*su.const_args, *su.carry0)
            ref = tree_qp_pl.make_phase(plan, cfg, nFx, 6, mtot, phase)(*su.const_args, *su.carry0)
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            emit({"phase": "quad_k1_phases_vs_plain", "dims": list(dims), "k1_phase": phase,
                  "B": 256, "dtype": "float64", "scaled_err": err, "tol_scaled": F64_TOL, **card})
            if not err <= F64_TOL:
                raise AssertionError(f"quadruped K1 phase {phase} {dims}: {err:.3e}")
        timing = {}
        for B, reps, plain_reps in ((QUAD_B, 10, 2), (256, 20, 3)):
            plan, su, step, plain, mtot = quad_case(dev, B, f32, cfg, nFx)
            err = hold_iteration(step, plain, su.const_args, su.carry0,
                                 {**base, "B": B, "dtype": "float32", "iteration": 1}, card)
            ms = cuda_ms(lambda: step(*su.const_args, *su.carry0), reps=reps)
            plain_ms = cuda_ms(lambda: plain(*su.const_args, *su.carry0), reps=plain_reps)
            t_bytes = iteration_bytes(su) / H100_BYTES_PER_S * 1e3
            t_ops = iteration_flops(plan, nFx, 6, cfg.gondzio, B) / H100_FLOPS["float32"] * 1e3
            kplan = K.plan(tree_qp_pl.kernel_ints(plan, cfg, nFx, 6), B, f32, dev.index)
            timing[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                             bound_by="bytes" if t_bytes >= t_ops else "operations",
                             max_abs_err=err, bytes=iteration_bytes(su),
                             flops=iteration_flops(plan, nFx, 6, cfg.gondzio, B),
                             trees_per_block=kplan["trees_per_block"],
                             blocks_per_sm=kplan["blocks_per_sm"], blocks=kplan["blocks"],
                             smem_bytes_per_block=kplan["smem_bytes"],
                             slot_bytes_per_tree=kplan["scratch_elems"] * 4
                             // (kplan["blocks"] * kplan["trees_per_block"]))
            del su
        emit({"phase": "quad_kernel_time", "dims": list(dims), "N": QUAD_N,
              "totalu": plan.topo.totalu, "dtype": "float32",
              **{f"B{B}": v for B, v in timing.items()}, **card})
        big = timing[QUAD_B]
        entries.append({"dims": list(dims), "B": QUAD_B, "ms": big["ms"],
                        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
                        "bound_by": big["bound_by"], "max_abs_err": big["max_abs_err"],
                        "ms_B256": timing[256]["ms"], "plain_ms_B256": timing[256]["plain_ms"],
                        "bound_ms_B256": timing[256]["bound_ms"]})
        torch.cuda.empty_cache()

    # ---- the quadruped main path: f32, B=8192 and the B=256 p50 -------------------
    pset, model, params = quad_config()
    topo, init, step = make_branch_mpc_batched_step(model, params, "prox", ipm=cfg)

    def drive(B, steps, dtype=f32, stepper=step, init_=init, device=dev):
        xs, zs, xRefs = (torch.as_tensor(a, dtype=dtype, device=device) for a in quad_states(B))
        carrys, res = stepper(init_(B, dtype), xs, zs, xRefs, pset.params)   # warm-up step
        res.uPred.cpu()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            _c, res = stepper(carrys, xs, zs, xRefs, pset.params)
            res.uPred.cpu()
            times.append(time.perf_counter() - t0)
        return res, times, (carrys, xs, zs, xRefs)

    steps = 5
    K.launches = 0
    K.dims_launches = {dm: 0 for dm in K.dims}
    res, times, warm = drive(QUAD_B, steps)
    launches = dict(K.dims_launches)
    u, feas = res.uPred, res.feasible
    finite = all(bool(t.isfinite().all()) for t in (res.xPred, res.uPred, res.slack, res.prim_res))
    uf = u[feas] if bool(feas.any()) else u[:0]
    worst = {"vx_min": uf[..., 0].min().item() if uf.numel() else 0.0,
             "vx_max": uf[..., 0].max().item() if uf.numel() else 0.0,
             "abs_vy_max": uf[..., 1].abs().max().item() if uf.numel() else 0.0,
             "abs_w_max": uf[..., 2].abs().max().item() if uf.numel() else 0.0}
    med = float(np.median(times))
    _, times256, warm256 = drive(256, 10)
    expected = cfg.iters * (steps + 1)
    line = {"phase": "quad_main_path", "B": QUAD_B, "N": QUAD_N, "NB": 2, "totalu": topo.totalu,
            "ipm_iters": cfg.iters, "gondzio": cfg.gondzio, "dtype": "float32",
            "steps_timed": steps, "step_ms_median": med * 1e3,
            "step_ms_all": [t * 1e3 for t in times], "solves_per_s": QUAD_B / med,
            "p50_ms_B256": float(np.median(times256)) * 1e3, "control_period_ms": 200.0,
            "launches_by_dims": {str(list(k)): v for k, v in launches.items()},
            "launches_expected": expected, "finite": finite,
            "feasible_share": feas.float().mean().item(), "feasible_inputs": worst,
            "prim_res_max": res.prim_res.max().item(), **card}
    for B, (carrys, xs, zs, xRefs) in ((QUAD_B, warm), (256, warm256)):
        line[f"profile_B{B}"] = profile_step(
            lambda: step(carrys, xs, zs, xRefs, pset.params)[1].uPred.cpu(), ("tree_qp_kernel",))
    emit(line)
    if not finite:
        raise AssertionError("quadruped main path: non-finite outputs")
    if launches[QUAD_DIMS[0]] != expected or sum(launches.values()) != expected:
        raise AssertionError(f"quadruped main path: K1 launches {launches}, expected {expected} "
                             f"at {QUAD_DIMS[0]}")
    # the input bounds vx ∈ [0, 0.2], |vy| ≤ 0.1, |ω| ≤ 0.5 within feas_tol on feasible lanes
    tol_b = 1e-3
    if (worst["vx_min"] < -tol_b or worst["vx_max"] > 0.2 + tol_b
            or worst["abs_vy_max"] > 0.1 + tol_b or worst["abs_w_max"] > 0.5 + tol_b):
        raise AssertionError(f"quadruped main path: feasible lanes outside the bounds: {worst}")
    if line["feasible_share"] < 0.5:
        raise AssertionError(f"quadruped main path: feasible share {line['feasible_share']:.3f}")
    entries[0]["launches"] = launches[QUAD_DIMS[0]]
    entries[1]["launches"] = launches[QUAD_DIMS[1]]
    entries[1]["path"] = "the iteration on the quadruped's own rows, called directly"
    del res, warm, warm256
    torch.cuda.empty_cache()

    # ---- the f64 path on the card against the same steps on the CPU -----------------
    _, cpu_init, cpu_step = make_branch_mpc_batched_step(model, params, "prox", ipm=cfg,
                                                         device="cpu")
    outs = {}
    for where, (st_, in_, dv) in {"cuda": (step, init, dev),
                                  "cpu": (cpu_step, cpu_init, torch.device("cpu"))}.items():
        xs, zs, xRefs = (torch.as_tensor(a, dtype=f64, device=dv) for a in quad_states(64))
        c = in_(64, f64)
        seq = []
        for _ in range(2):
            c, r = st_(c, xs, zs, xRefs, pset.params)
            seq.append((r.uPred.cpu(), r.xPred.cpu()))
        outs[where] = seq
    du = max((a[0] - b[0]).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    dx = max((a[1] - b[1]).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    emit({"phase": "quad_main_path_vs_cpu", "B": 64, "dtype": "float64", "steps": 2,
          "max_abs_du": du, "max_abs_dx": dx, "tol_du": 1e-7, "tol_dx": 1e-6, **card})
    if not (du < 1e-7 and dx < 1e-6):
        raise AssertionError(f"quadruped f64 main path on the card vs CPU: |du| {du:.3e}, "
                             f"|dx| {dx:.3e}")
    return entries


def run_merge_episode_phases(dev, card, K2):
    """The closed-loop merge episode (``envs/batched_merge.make_batched_merge_fused``,
    one batched CVaR step on K2 a world step): the card in f64 against the
    CPU's plain version over 3 steps at B=8 (IPM-8: late CVaR iterates are
    chaotic in the reference itself), then world-steps/s at B=32768, IPM-24,
    f32, over 5 warm steps."""
    from belief_planning_tpu_torch.envs.batched_merge import make_batched_merge_fused
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig

    f32, f64 = torch.float32, torch.float64
    model, params, pset, cons, ralpha, _ = cvar_config("cvar_merge")
    cfg8 = CVaRIPMConfig(iters=8, gondzio=2)
    trajs = {}
    for where in ("cuda", "cpu"):
        _, init_w, episode = make_batched_merge_fused(cons, model, params, pset.params, ralpha,
                                                      ipm=cfg8, dtype=f64,
                                                      device=dev if where == "cuda" else "cpu")
        _, traj = episode(init_w(8, seed=0), 3)
        trajs[where] = {k: v.cpu() for k, v in traj.items()}
    diff = {k: (trajs["cuda"][k].double() - trajs["cpu"][k].double()).abs().max().item()
            for k in ("u", "x", "z", "gap")}
    same_flags = torch.equal(trajs["cuda"]["merged"], trajs["cpu"]["merged"])
    emit({"phase": "merge_episode_vs_cpu", "B": 8, "N": params.N, "steps": 3, "dtype": "float64",
          "ipm_iters": cfg8.iters, "max_abs_diff": diff, "merged_equal": same_flags,
          "tol_u": 1e-7, "tol_x": 1e-7, **card})
    if not (diff["u"] < 1e-7 and diff["x"] < 1e-7 and diff["z"] < 1e-7 and same_flags):
        raise AssertionError(f"merge episode, card vs CPU: {diff}, merged equal {same_flags}")

    cfg = CVaRIPMConfig(iters=24, gondzio=2)
    _, init_w, episode = make_batched_merge_fused(cons, model, params, pset.params, ralpha,
                                                  ipm=cfg, dtype=f32)
    worlds, _ = episode(init_w(MERGE_EPISODE_B, seed=0), 1)           # the cold first step
    K2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worlds, traj = episode(worlds, MERGE_EPISODE_STEPS)
    u = traj["u"].cpu()
    sec = time.perf_counter() - t0
    finite = bool(u.isfinite().all()) and bool(traj["x"].isfinite().all())
    line = {"phase": "merge_episode", "B": MERGE_EPISODE_B, "N": params.N, "NB": params.NB,
            "ipm_iters": cfg.iters, "gondzio": cfg.gondzio, "dtype": "float32",
            "steps_timed": MERGE_EPISODE_STEPS, "seconds": sec,
            "world_steps_per_s": MERGE_EPISODE_B * MERGE_EPISODE_STEPS / sec,
            "step_ms": sec / MERGE_EPISODE_STEPS * 1e3, "k2_launches": K2.launches,
            "launches_expected": cfg.iters * MERGE_EPISODE_STEPS, "finite": finite,
            "merged_share": worlds.merged.float().mean().item(),
            "collided_share": worlds.collided.float().mean().item(),
            "gap_p50_last": float(traj["gap"][:, -1].median()), **card}
    emit(line)
    if not finite or K2.launches != cfg.iters * MERGE_EPISODE_STEPS:
        raise AssertionError(f"merge episode: finite {finite}, K2 launches {K2.launches}")
    return line

OVERTAKE_EPISODE_B = 32768
OVERTAKE_EPISODE_STEPS = 5
HOST_QP_STEPS = 5
HOST_MERGE_STEPS = 3


def run_overtake_episode_phases(dev, card, K):
    """The closed-loop overtake ensemble (``envs/batched_highway.
    make_batched_overtake_fused``, one batched QP step on K1 a world step,
    a lane-change target a world): the card in f64 against the CPU's plain
    version over 3 steps at B=8 with the same draws, then world-steps/s at
    B=32768, IPM-8 with 2 correctors, f32, over 5 warm steps, and one
    profiled world step. Returns the timed run's K1 launches."""
    from belief_planning_tpu_torch.envs.batched_highway import make_batched_overtake_fused
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    f32, f64 = torch.float32, torch.float64
    cons = overtake_cons()
    pset, model, params = overtake_setup()
    cfg = QPIPMConfig(iters=8, gondzio=2)
    steps, B = 3, 8
    draws = torch.rand((steps, B, 2), generator=torch.Generator().manual_seed(0), dtype=f64)
    trajs, worlds = {}, {}
    for where in ("cuda", "cpu"):
        _, init_w, episode = make_batched_overtake_fused(
            cons, model, params, "prox", ipm=cfg, dtype=f64,
            device=dev if where == "cuda" else "cpu")
        w0 = init_w(B, seed=0)
        K.launches = 0
        worlds[where], traj = episode(w0, steps, draws=draws)
        launches = K.launches
        trajs[where] = {k: v.cpu() for k, v in traj.items()}
        if where == "cuda":
            launches_card = launches
    diff = {k: (trajs["cuda"][k] - trajs["cpu"][k]).abs().max().item() for k in ("u", "x", "z")}
    same = {f: torch.equal(getattr(worlds["cuda"], f).cpu(), getattr(worlds["cpu"], f))
            for f in ("ego_lane", "obs_lane", "collided")}
    same["feasible"] = torch.equal(trajs["cuda"]["feasible"], trajs["cpu"]["feasible"])
    lc = (worlds["cuda"].lc_target.cpu() - worlds["cpu"].lc_target).abs().max().item()
    emit({"phase": "overtake_episode_vs_cpu", "B": B, "N": params.N, "NB": params.NB,
          "steps": steps, "dtype": "float64", "ipm_iters": cfg.iters, "max_abs_diff": diff,
          "lc_target_diff": lc, "equal": same, "k1_launches": launches_card,
          "launches_expected": cfg.iters * steps, "tol": 1e-7, **card})
    if not (max(diff.values()) < 1e-7 and lc < 1e-7 and all(same.values())
            and launches_card == cfg.iters * steps):
        raise AssertionError(f"overtake episode, card vs CPU: {diff}, equal {same}, "
                             f"K1 launches {launches_card}")

    Bt, T = OVERTAKE_EPISODE_B, OVERTAKE_EPISODE_STEPS
    _, init_w, episode = make_batched_overtake_fused(cons, model, params, "prox", ipm=cfg,
                                                     dtype=f32)
    w0 = init_w(Bt, seed=0)
    t0 = time.perf_counter()
    w1, _ = episode(w0, 1, seed=1)                                  # the cold first step
    _ = w1.x.cpu()
    cold_s = time.perf_counter() - t0
    K.launches = 0
    K.dims_launches = {dm: 0 for dm in K.dims}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worlds, traj = episode(w1, T, seed=2, t0=1)
    u = traj["u"].cpu()
    sec = time.perf_counter() - t0
    launches, by_dims = K.launches, dict(K.dims_launches)
    finite = bool(u.isfinite().all()) and bool(traj["x"].isfinite().all())
    feas = traj["feasible"].float()
    line = {"phase": "overtake_episode", "B": Bt, "N": params.N, "NB": params.NB,
            "ipm_iters": cfg.iters, "gondzio": cfg.gondzio, "dtype": "float32",
            "steps_timed": T, "seconds": sec, "world_steps_per_s": Bt * T / sec,
            "step_ms": sec / T * 1e3, "cold_step_s": cold_s, "k1_launches": launches,
            "launches_by_dims": {str(list(k)): v for k, v in by_dims.items()},
            "launches_expected": cfg.iters * T, "finite": finite,
            "feasible_share": feas.mean().item(), "feasible_share_last": feas[:, -1].mean().item(),
            "collided_share": worlds.collided.float().mean().item(),
            # obstacles whose lane intent moved (rolls at steps 0 and 10), and the
            # worlds whose lane-change target or obstacle lane moved in the timed steps
            "lane_intent_share": (worlds.obs_des_y != w0.obs_des_y).float().mean().item(),
            "retargeted_share": (worlds.lc_target != w1.lc_target).any(dim=1).float().mean().item(),
            "obs_lane_changed_share": (worlds.obs_lane != w1.obs_lane).float().mean().item(),
            "max_abs_a": u[..., 0].abs().max().item(), "max_abs_r": u[..., 1].abs().max().item(),
            **card}
    draws1 = torch.rand((Bt, 2), generator=torch.Generator().manual_seed(3), dtype=f64).to(dev)
    line["profile"] = profile_step(lambda: episode.step_once(worlds, T + 1, draws1)[1]["u"].cpu(),
                                   ("tree_qp_kernel",))
    emit(line)
    if not finite or launches != cfg.iters * T or by_dims.get(K.dims[0]) != launches:
        raise AssertionError(f"overtake episode: finite {finite}, K1 launches {launches} "
                             f"({by_dims}), expected {cfg.iters * T} at {K.dims[0]}")
    if line["feasible_share"] < 0.5:
        raise AssertionError(f"overtake episode: feasible share {line['feasible_share']:.3f}")
    del worlds, traj, w0, w1
    torch.cuda.empty_cache()
    return launches


def run_host_loop_phases(dev, card, K):
    """The host environments with the single-tree controllers, card against
    CPU in f64: ``HighwayEnv`` + ``BranchMPCProx`` (the overtake demo's N=8,
    NB=2, IPM-8 with 2 correctors) for 10 steps, and ``HighwayMergeEnv`` +
    ``BranchMPCCVaR`` (the merge demo's N=40, NB=1, ``use_S``, IPM-8 with 2
    correctors) for 3 steps. Their solves run each tree's IPM in plain
    PyTorch, so K1 is not launched."""
    from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx
    from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR
    from belief_planning_tpu_torch.envs.highway import HighwayEnv, highway_sim
    from belief_planning_tpu_torch.envs.merge import HighwayMergeEnv, merge_ref_lines
    from belief_planning_tpu_torch.models.policies import merge_policy_set
    from belief_planning_tpu_torch.models.predictive import merge_model
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    cons = overtake_cons()
    pset, model, params = overtake_setup()
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    # the merge demo: the main road's model drives the controller, the ramp's
    # model (its policies follow the ramp's heading) the ramp's vehicles
    mmodel, mparams, mpset, mcons, ralpha, _ = cvar_config("cvar_merge")
    ramp_pset = merge_policy_set(mcons, 20.0, merge_ref_lines(2, 1, 50, 300, 0)[1])
    mmodels = [mmodel, merge_model(mcons, ramp_pset, N=mparams.N, dt=mmodel.dt)]
    mpsets = (mpset.params, ramp_pset.params)
    out, recs = {}, {}
    K.launches = 0
    for where in ("cuda", "cpu"):
        dv = dev if where == "cuda" else "cpu"
        mpc = BranchMPCProx(params, model, pset.params, ipm=QPIPMConfig(iters=8, gondzio=2),
                            device=dv)
        env = HighwayEnv(NV=2, mpc=mpc, cons=cons, lc_target=xRef, N_lane=4, seed=0)
        t0 = time.perf_counter()
        rec = highway_sim(env, HOST_QP_STEPS * model.dt)
        qp_s = (time.perf_counter() - t0) / HOST_QP_STEPS
        cmpc = BranchMPCCVaR(mparams, mmodel, mpset.params, ralpha=ralpha,
                             ipm=CVaRIPMConfig(iters=8, gondzio=2), use_S=True, device=dv)
        menv = HighwayMergeEnv(NV=2, N_lane=2, mpc=cmpc, models=mmodels,
                               policy_param_sets=list(mpsets), merge_lane=1, merge_s=50,
                               merge_R=300, merge_side=0, dt=mmodel.dt, cons=mcons)
        t0 = time.perf_counter()
        mrec = highway_sim(menv, HOST_MERGE_STEPS * mmodel.dt)
        merge_s = (time.perf_counter() - t0) / HOST_MERGE_STEPS
        recs[where] = (rec, mrec, env.lc_target.copy())
        out[where] = {"highway_s_per_step": qp_s, "merge_s_per_step": merge_s}
    (rc, mc, lcc), (rp, mp, lcp) = recs["cuda"], recs["cpu"]
    diff = {"highway_states": float(np.abs(rc[0] - rp[0]).max()),
            "highway_inputs": float(np.abs(rc[1] - rp[1]).max()),
            "merge_states": float(np.abs(mc[0] - mp[0]).max()),
            "merge_inputs": float(np.abs(mc[1] - mp[1]).max())}
    same = {"highway_backups": rc[3] == rp[3], "lc_target": bool(np.array_equal(lcc, lcp)),
            "merge_backups": mc[3] == mp[3]}
    line = {"phase": "highway_host_loop", "dtype": "float64", "highway_steps": HOST_QP_STEPS,
            "merge_steps": HOST_MERGE_STEPS, "N": params.N, "NB": params.NB,
            "merge_N": mparams.N, "ipm_iters": 8, "s_per_step": out, "max_abs_diff": diff,
            "equal": same, "highway_collision": rc[-1], "k1_launches": K.launches, "tol": 1e-7,
            **card}
    emit(line)
    if not (max(diff.values()) < 1e-7 and all(same.values())):
        raise AssertionError(f"host loops, card vs CPU: {diff}, equal {same}")
    if not (np.isfinite(rc[0]).all() and np.isfinite(mc[0]).all()):
        raise AssertionError("host loops: non-finite states")
    return line


# ---- slice 10: the tree-QP ADMM, the robust and HMM controllers, the host loops ----
# None of these paths runs a hand-written kernel (the reference's run no Pallas
# kernel either): each phase sets every kernel's launch counter to 0 just
# before its card side, reads them just after it, reports them and fails
# unless they stayed 0. Every phase runs alone in this process: the card side,
# then its CPU reference.
ADMM_MAIN_B = 4096
ADMM_MAIN_WARM = 3
ADMM_CPU_ROWS = 64          # trees of the card's f64 step also solved on the CPU
HMM_MAIN_B = 4096
HMM_MAIN_WARM = 5
ROBUST_IPM_STEPS, ROBUST_ADMM_STEPS = 2, 1
HMM_HOST_STEPS = 3
QUAD_HOST_STEPS = 1


class Launches:
    """Every kernel's launch counter: ``reset()``, then ``check(phase)``."""

    def __init__(self, K, K2, K3, K5):
        self.kernels = {"tree_qp_ipm_iter": K, "cvar_ipm_iter": K2, "proj_soc": K3,
                        "shared_rows_probe": K5}

    def reset(self):
        for k in self.kernels.values():
            k.launches = {m: 0 for m in k.launches} if isinstance(k.launches, dict) else 0
            if hasattr(k, "phase_launches"):
                k.phase_launches = 0

    def check(self, phase):
        got = {}
        for name, k in self.kernels.items():
            n_ = sum(k.launches.values()) if isinstance(k.launches, dict) else k.launches
            got[name] = n_ + getattr(k, "phase_launches", 0)
        if any(got.values()):
            raise AssertionError(f"{phase}: a kernel was launched on a plain path: {got}")
        return got


def per_tree_du(u32, u64):
    """Each tree's max |Δu| of an f32 result against the f64 one on the same
    states: its p50, p90 and max over the trees."""
    du = (u32.to(torch.float64) - u64).abs().reshape(u64.shape[0], -1).amax(1)
    q = torch.quantile(du, torch.tensor([0.5, 0.9], dtype=torch.float64))
    return {"p50": q[0].item(), "p90": q[1].item(), "max": du.max().item()}


def device_profile(run):
    """The device's busy time and idle share over one ``run()``, under
    ``torch.profiler`` with the CUDA activity alone (the CPU's hundreds of
    thousands of op events of a launch-bound step take longer to parse than
    the step), and the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            on_device[e.key] = (e.count, e.device_time_total / 1e3)
    busy = sum(t for _, t in on_device.values())
    top = sorted(on_device.items(), key=lambda kv: -kv[1][1])[:5]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "device_ops": sum(n_ for n_, _ in on_device.values()),
            "top_device_ms": [[k[:70], t, n_] for k, (n_, t) in top]}


def timed_steps(step, carrys, args, n):
    """``n`` warm steps, each timed up to the fetch of ``uPred`` to the host."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carrys, res = step(carrys, *args)
        _ = res.uPred.cpu()
        times.append(time.perf_counter() - t0)
    return carrys, res, times


def tree_admm_run(where):
    """``admm_solve`` on the overtake tree (N=8, NB=2), f64, B=8, from trees
    built on the CPU, at 2 iterations and at the entry's config: ``{name:
    (x, u, seconds)}``."""
    from belief_planning_tpu_torch.entry import flagship
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers.tree_qp import (
        ADMMConfig,
        admm_solve,
        assemble_stage_cost,
        build_stage_plan,
    )
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology

    f64 = torch.float64
    pset, model, params = overtake_setup()
    B = 8
    xs, zs, xRefs = (torch.as_tensor(a, dtype=f64) for a in bench_states(B, seed=5))
    topo = build_topology(N, NB, model.m, n, d)
    plan = build_stage_plan(topo)
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, d, dtype=f64),
                    cast_params(pset.params, f64, "cpu"))
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR, params.Qslack,
                               xRefs, torch.zeros(B, d, dtype=f64))
    mv = lambda a: a.to(where)
    out = {}
    for name, cfg in (("iters2", ADMMConfig(iters=2, rho_update_every=0, polish_iters=0)),
                      ("entry", flagship()[3])):
        t0 = time.perf_counter()
        x_, u_, *_ = admm_solve(plan, type(cost)(*map(mv, cost)), type(ts)(*map(mv, ts)),
                                params.Fx, params.bx, params.Fu, params.bu, mv(xs),
                                mv(torch.zeros(B, d, dtype=f64)), cfg, device=where)
        out[name] = (x_.cpu().numpy(), u_.cpu().numpy(), time.perf_counter() - t0)
    return out


def admm_step_cpu(states):
    """The ADMM branch-MPC step at the entry's config in f64 on the CPU, cold,
    on ``states = (xs, zs, xRefs)`` (numpy): ``uPred`` (numpy)."""
    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_step
    from belief_planning_tpu_torch.entry import flagship

    pset, model, params = overtake_setup()
    _, init, step = make_branch_mpc_step(model, params, "prox", solver="admm",
                                         admm=flagship()[3], device="cpu")
    st = [torch.as_tensor(a, dtype=torch.float64) for a in states]
    return step(init(st[0].shape[0], torch.float64), *st, pset.params)[1].uPred.numpy()


def _robust_mpcs(where):
    """The robust controllers of ``robust_host_loop`` (N=8, NB=2, f64 on
    ``where``): on the IPM-100 and on ``ADMMConfig()``."""
    from belief_planning_tpu_torch.controllers.robust_mpc import RobustMPC
    from belief_planning_tpu_torch.solvers.tree_qp import ADMMConfig
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    pset, model, params = overtake_setup()
    return (RobustMPC(params, model, pset.params, ipm=QPIPMConfig(iters=100), device=where),
            RobustMPC(params, model, pset.params, admm=ADMMConfig(), solver="admm",
                      device=where))


ROBUST_XREF = np.array([0.0, 1.8, 18.0, 0.0])


def robust_run(where, record=None):
    """``tests/test_robust_mpc.py``'s closed loop on ``where`` (f64):
    ``ROBUST_IPM_STEPS`` steps on the IPM-100, then ``ROBUST_ADMM_STEPS`` on
    ``ADMMConfig()`` from its carry. Each step's inputs ``(x, z, carry)``
    (numpy) are also appended to ``record`` before the step is solved.
    Returns the applied inputs, the feasible flags and s a step."""
    cons = overtake_cons()
    dt = overtake_setup()[1].dt
    f = lambda s_, u_: s_ + np.array([s_[2] * np.cos(s_[3]), s_[2] * np.sin(s_[3]),
                                      u_[0], u_[1]]) * dt
    mpcs = _robust_mpcs(where)
    x, z = np.array([0.0, 1.8, 20.0, 0.0]), np.array([10.0, 2.1, 16.0, 0.0])
    us, feas, secs = [], [], {}
    for name, mpc, steps in (("ipm", mpcs[0], ROBUST_IPM_STEPS),
                             ("admm", mpcs[1], ROBUST_ADMM_STEPS)):
        if name == "admm":
            mpc.carry = mpcs[0].carry
        t0 = time.perf_counter()
        for _ in range(steps):
            if record is not None:
                record.append((x.copy(), z.copy(), [a.cpu().numpy().copy() for a in mpc.carry]))
            u = np.asarray(mpc.solve(x, z, ROBUST_XREF))
            us.append(u)
            feas.append(mpc.feasible)
            x, z = f(x, u), f(z, np.array([0.0, -cons.Kpsi * z[3]]))
        secs[name] = (time.perf_counter() - t0) / steps
    return np.array(us), feas, secs


def robust_forced(record, where):
    """Each step of a :func:`robust_run` solved again on ``where`` from the
    state and carry in ``record``: the applied inputs, feasible flags and s
    a step."""
    mpcs = _robust_mpcs(where)
    us, feas, secs = [], [], {"ipm": 0.0, "admm": 0.0}
    for k, (x, z, carry) in enumerate(record):
        name = "ipm" if k < ROBUST_IPM_STEPS else "admm"
        mpc = mpcs[0] if name == "ipm" else mpcs[1]
        t0 = time.perf_counter()
        mpc.carry = type(mpc.carry)(*(torch.as_tensor(a, device=mpc.device) for a in carry))
        us.append(np.asarray(mpc.solve(x, z, ROBUST_XREF)))
        feas.append(mpc.feasible)
        secs[name] += time.perf_counter() - t0
    secs["ipm"] /= ROBUST_IPM_STEPS
    secs["admm"] /= ROBUST_ADMM_STEPS
    return np.array(us), feas, secs


def hmm_config(M=1, N=6):
    """The HMM bench's model and parameters (``scripts/bench_configs.py:235-290``)."""
    from belief_planning_tpu_torch.models import policies as P
    from belief_planning_tpu_torch.models.hmm import HMMPredictiveModel
    from belief_planning_tpu_torch.presets import init_mpc_params
    from belief_planning_tpu_torch.utils.config import HMMConstants

    cons = HMMConstants(am=6.0, rm=0.3)
    model = HMMPredictiveModel(nx=4, d=2, M=M, m=2, dt=0.1, cons=cons,
                               policy_fns=(P.maintain, P.brake),
                               policy_params=(P.MaintainParams(Kpsi=cons.Kpsi),
                                              P.brake_params_sim(cons.Kpsi)))
    params = init_mpc_params(4, 2, N, M, 2, ydes=1.8, vdes=15.0, am=6.0, rm=0.3, N_lane=6,
                             W=2.4)
    return model, params


def hmm_states(B, M=1, m=2, N=6, seed=0):
    """The HMM bench's states, drawn as it draws them (f64 numpy)."""
    rng = np.random.default_rng(seed)
    x0s = np.array([0.0, 1.8, 15.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    b0s = rng.uniform(0.2, 0.8, (B, M, m))
    b0s = b0s / b0s.sum(axis=2, keepdims=True)
    z = np.array([14.0, 1.8, 10.0, 0.0])
    steps = (np.arange(N) + 1)[None, :, None, None] * 0.1
    vels = np.stack([np.array([10., 0, 0, 0]), np.array([8., 0, 0, 0])])
    xbk = z[None, None, None, :] + steps * vels[None, None, :, :]
    xbackups = np.broadcast_to(xbk, (B, N, M * m, 4)).copy()
    xbackups += rng.normal(0, 0.1, xbackups.shape)
    xRef = np.concatenate([np.array([0., 1.8, 15., 0.]), np.zeros(M * m)])
    return x0s, b0s, xbackups, xRef


def hmm_small_run(where, B=8, steps=2):
    """The batched HMM step (IPM-8 with 2 correctors) in f64 at ``B`` of the
    bench's states, ``steps`` carried steps: ``uPred (steps, B, N, 2)``."""
    from belief_planning_tpu_torch.controllers.hmm_mpc import make_hmm_mpc_batched_step
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    model, params = hmm_config()
    _, init, bstep = make_hmm_mpc_batched_step(model, params, ipm=QPIPMConfig(iters=8, gondzio=2),
                                               device=where)
    args = [torch.as_tensor(a, dtype=torch.float64, device=where) for a in hmm_states(B)]
    c, seq = init(B, torch.float64), []
    for _ in range(steps):
        c, r = bstep(c, *args)
        seq.append(r.uPred.cpu().numpy())
    return np.stack(seq)


def hmm_host_run(where):
    """``HMMHighwayEnv`` + ``HMMMPC`` (``tests/test_hmm.py``'s env: NV=3,
    M=2, N=5, six lanes, seed 0) for ``HMM_HOST_STEPS`` steps: the states,
    beliefs and backups a step, the generator's next draw, s a step."""
    from belief_planning_tpu_torch.controllers.hmm_mpc import HMMMPC
    from belief_planning_tpu_torch.envs.hmm_highway import HMMHighwayEnv

    model, params = hmm_config(M=2, N=5)
    env = HMMHighwayEnv(NV=3, mpc=HMMMPC(params, model, device=where), N_lane=6, seed=0)
    t0 = time.perf_counter()
    rec = []
    for t in range(HMM_HOST_STEPS):
        _, states = env.step(t)
        rec.append((np.array(states), env.b.copy(), [v.backupidx for v in env.veh_set]))
    return rec, env.rng.random(), (time.perf_counter() - t0) / HMM_HOST_STEPS


def quad_host_run(where):
    """``QuadEnv`` + ``BranchMPCProx`` at the demo's N=25, NB=2, dt = 0.2 (the
    default IPM), f64, ``QUAD_HOST_STEPS`` steps in each ``ref_mode``:
    ``{mode: (state_rec, backup choices, s a step)}``."""
    from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx
    from belief_planning_tpu_torch.envs.quadruped import QuadEnv, robot_sim

    pset, model, params = quad_config()
    mpc = BranchMPCProx(params, model, pset.params, device=where)
    out = {}
    for mode in ("default", "ros"):
        mpc.carry = mpc._init_carry(1, torch.float64)
        t0 = time.perf_counter()
        rec = robot_sim(QuadEnv(NR=2, mpc=mpc, x_des=np.array([5., -3., 0.]), cons=quad_cons(),
                                ref_mode=mode), QUAD_HOST_STEPS * model.dt)
        out[mode] = (rec[0], rec[3], (time.perf_counter() - t0) / QUAD_HOST_STEPS)
    return out


def run_tree_admm_vs_cpu(dev, card, L):
    """``tree_admm_vs_cpu``: :func:`tree_admm_run` on the card against the CPU
    (``admm_solve``, f64, B=8, identical trees)."""
    from belief_planning_tpu_torch.entry import flagship

    admm = flagship()[3]
    L.reset()
    card_out = tree_admm_run(dev)
    launches = L.check("tree_admm_vs_cpu")
    cpu_out = tree_admm_run("cpu")
    diffs = {name: {"u": float(np.abs(card_out[name][1] - cpu_out[name][1]).max()),
                    "x": float(np.abs(card_out[name][0] - cpu_out[name][0]).max()), "tol": tol}
             for name, tol in (("iters2", 1e-10), ("entry", 1e-7))}
    secs = {f"{name}_{w}_s": o[name][2] for name in ("iters2", "entry")
            for w, o in (("card", card_out), ("cpu", cpu_out))}
    emit({"phase": "tree_admm_vs_cpu", "B": 8, "N": N, "NB": NB, "m": 3,
          "dtype": "float64", "entry_admm": {"rho": admm.rho, "iters": admm.iters,
                                             "rho_update_every": admm.rho_update_every,
                                             "polish_iters": admm.polish_iters},
          "max_abs_diff": diffs, "seconds": secs, "launches": launches,
          **card})
    if not (diffs["iters2"]["u"] < 1e-10 and diffs["iters2"]["x"] < 1e-10
            and diffs["entry"]["u"] < 1e-7):
        raise AssertionError(f"tree ADMM, card vs CPU: {diffs}")


def run_admm_main_path(dev, card, L):
    """``admm_main_path``: ``make_branch_mpc_step(solver="admm")`` at the
    entry's config, f32, B=4096: a cold step, warm steps with the duals
    carried, a profiled one, f32 against f64 on the card, the card's f64
    against the CPU on the first trees; then ``entry()``'s step."""
    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_step
    from belief_planning_tpu_torch.entry import entry, flagship

    f32, f64 = torch.float32, torch.float64
    pset, model, params = overtake_setup()
    admm = flagship()[3]
    L.reset()
    Bm = ADMM_MAIN_B
    st = [torch.as_tensor(a) for a in bench_states(Bm, seed=0)]
    out = {}
    for dt_ in (f32, f64):
        _, init, step = make_branch_mpc_step(model, params, "prox", solver="admm", admm=admm,
                                             device=dev)
        args = [a.to(dev, dt_) for a in st]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, r = step(init(Bm, dt_), *args, pset.params)
        out[dt_] = dict(u=r.uPred.cpu(), cold_s=time.perf_counter() - t0, step=step, args=args,
                        c=c)
    o = out[f32]
    run = lambda c_, *a: o["step"](c_, *a, pset.params)
    c, res, times = timed_steps(run, o["c"], o["args"], ADMM_MAIN_WARM)
    prof = device_profile(lambda: run(c, *o["args"])[1].uPred.cpu())
    fn, eargs = entry(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ue = fn(*eargs).cpu()
    entry_s = time.perf_counter() - t0
    launches = L.check("admm_main_path")
    k = ADMM_CPU_ROWS
    u_cpu = admm_step_cpu([a[:k].numpy() for a in st])
    cpu_du = (out[f64]["u"][:k] - torch.as_tensor(u_cpu)).abs().max().item()
    prim = res.prim_res.float().cpu()
    step_s = float(np.median(times))
    finite = bool(res.uPred.isfinite().all()) and bool(o["u"].isfinite().all())
    line = {"phase": "admm_main_path", "B": Bm, "N": N, "NB": NB, "dtype": "float32",
            "admm_iters": admm.iters, "polish_iters": admm.polish_iters,
            "cold_step_s": o["cold_s"], "warm_steps": ADMM_MAIN_WARM, "step_ms": step_s * 1e3,
            "step_ms_each": [t * 1e3 for t in times], "solves_per_s": Bm / step_s,
            "prim_res_p50": prim.median().item(), "prim_res_max": prim.max().item(),
            "feasible_share": res.feasible.float().mean().item(),
            "f32_vs_f64_card_du": per_tree_du(o["u"], out[f64]["u"]),
            "f64_cold_step_s": out[f64]["cold_s"], "f64_card_vs_cpu_max_abs_du": cpu_du,
            "f64_card_vs_cpu_trees": k,
            "entry": {"shape": list(ue.shape), "finite": bool(ue.isfinite().all()),
                      "seconds": entry_s, "solver": "ipm, as the reference's entry"},
            "profile": prof, "launches": launches, **card}
    emit(line)
    if not (finite and cpu_du < 1e-7 and line["entry"]["finite"]):
        raise AssertionError(f"ADMM main path: finite {finite}, f64 card vs CPU {cpu_du}, "
                             f"entry finite {line['entry']['finite']}")
    del out, c, res, o
    torch.cuda.empty_cache()


def run_robust_host_loop(dev, card, L):
    """``robust_host_loop``: the closed loop on the CPU (:func:`robust_run`),
    then each of its steps solved again on the card from the same state and
    carry (:func:`robust_forced`). The loop amplifies rounding: one solve
    near the IPM's gap floor moves u by ~2e-8 for a 1e-15 change of its
    state, and the closed loop compounds it (``scripts/
    torch_port_robust_chaos.py``), so card and CPU are compared step by
    step, teacher-forced."""
    record = []
    up, fp, sp = robust_run("cpu", record)
    L.reset()
    uc, fc, sc = robust_forced(record, dev)
    launches = L.check("robust_host_loop")
    du = np.abs(uc - up).max(axis=1)
    emit({"phase": "robust_host_loop", "N": N, "NB": NB, "m": 3, "rows_a_stage": 4 + 3 ** NB,
          "dtype": "float64", "ipm_steps": ROBUST_IPM_STEPS, "ipm_iters": 100,
          "admm_steps": ROBUST_ADMM_STEPS, "admm": "ADMMConfig()", "teacher_forced": True,
          "s_per_step": {"card": sc, "cpu": sp}, "max_abs_du_per_step": du.tolist(),
          "max_abs_du": float(du.max()), "tol": 1e-7, "feasible": fc, "feasible_cpu": fp,
          "launches": launches, **card})
    if not (du.max() < 1e-7 and fc == fp):
        raise AssertionError(f"robust host loop, card vs CPU: |du| {du}, feasible {fc} {fp}")


def run_hmm_phases(dev, card, L):
    """``hmm_main_path`` (the batched step at the reference's bench, B=4096,
    IPM-8 with 2 correctors, f32: solves/s over warm steps, the feasible
    share, f32 against f64 on the card, a profiled step), ``hmm_vs_cpu``
    (f64, B=8, two carried steps), ``hmm_host_loop`` (:func:`hmm_host_run`,
    card against CPU)."""
    from belief_planning_tpu_torch.controllers.hmm_mpc import make_hmm_mpc_batched_step
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    f32, f64 = torch.float32, torch.float64
    model, params = hmm_config()
    ipm = QPIPMConfig(iters=8, gondzio=2)
    L.reset()
    st = hmm_states(HMM_MAIN_B)
    out = {}
    for dt_ in (f32, f64):
        _, init, bstep = make_hmm_mpc_batched_step(model, params, ipm=ipm, device=dev)
        args = [torch.as_tensor(a, dtype=dt_, device=dev) for a in st]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, r = bstep(init(HMM_MAIN_B, dt_), *args)
        out[dt_] = dict(u=r.uPred.cpu(), c=c, args=args, step=bstep,
                        cold_s=time.perf_counter() - t0)
    o = out[f32]
    c, res, times = timed_steps(o["step"], o["c"], o["args"], HMM_MAIN_WARM)
    prof = device_profile(lambda: o["step"](c, *o["args"])[1].uPred.cpu())
    launches = L.check("hmm_main_path")
    step_s = float(np.median(times))
    finite = bool(res.uPred.isfinite().all())
    emit({"phase": "hmm_main_path", "B": HMM_MAIN_B, "M": 1, "m": 2, "N": params.N,
          "ipm_iters": ipm.iters, "gondzio": ipm.gondzio, "dtype": "float32",
          "cold_step_s": o["cold_s"], "warm_steps": HMM_MAIN_WARM, "step_ms": step_s * 1e3,
          "step_ms_each": [t * 1e3 for t in times], "solves_per_s": HMM_MAIN_B / step_s,
          "feasible_share": res.feasible.float().mean().item(),
          "prim_res_p50": res.prim_res.float().median().item(),
          "f32_vs_f64_card_du": per_tree_du(o["u"], out[f64]["u"]),
          "f64_cold_step_s": out[f64]["cold_s"], "profile": prof, "launches": launches, **card})
    if not finite:
        raise AssertionError("HMM main path: non-finite inputs")
    del out, c, res, o
    torch.cuda.empty_cache()

    L.reset()
    u_card = hmm_small_run(dev)
    launches = L.check("hmm_vs_cpu")
    du = float(np.abs(u_card - hmm_small_run("cpu")).max())
    emit({"phase": "hmm_vs_cpu", "B": 8, "dtype": "float64", "steps": 2, "ipm_iters": ipm.iters,
          "max_abs_du": du, "tol": 1e-9, "launches": launches, **card})
    if not du < 1e-9:
        raise AssertionError(f"HMM step, card vs CPU: |du| {du}")

    L.reset()
    rc, dc, sc = hmm_host_run(dev)
    launches = L.check("hmm_host_loop")
    rp, dp, sp = hmm_host_run("cpu")
    diff = {"states": max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(rc, rp)),
            "beliefs": max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(rc, rp))}
    same = {"backups": [a[2] for a in rc] == [b[2] for b in rp], "next_draw": dc == dp}
    emit({"phase": "hmm_host_loop", "NV": 3, "M": 2, "N": 5, "steps": HMM_HOST_STEPS,
          "dtype": "float64", "s_per_step": {"card": sc, "cpu": sp}, "max_abs_diff": diff,
          "equal": same, "tol": {"states": 1e-7, "beliefs": 1e-9},
          "launches": launches, **card})
    if not (diff["states"] < 1e-7 and diff["beliefs"] < 1e-9 and all(same.values())):
        raise AssertionError(f"HMM host loop, card vs CPU: {diff}, equal {same}")


def run_quad_host_loop(dev, card, L):
    """``quad_host_loop``: :func:`quad_host_run` on the card against the CPU."""
    L.reset()
    oc = quad_host_run(dev)
    launches = L.check("quad_host_loop")
    op = quad_host_run("cpu")
    diff = {mode: float(np.abs(oc[mode][0] - op[mode][0]).max()) for mode in oc}
    same = {mode: oc[mode][1] == op[mode][1] for mode in oc}
    emit({"phase": "quad_host_loop", "N": QUAD_N, "NB": 2, "dt": 0.2, "steps": QUAD_HOST_STEPS,
          "dtype": "float64", "s_per_step": {f"{w}_{mode}": o[mode][2] for mode in oc
                                             for w, o in (("card", oc), ("cpu", op))},
          "max_abs_diff_states": diff, "equal_backups": same, "tol": 1e-7,
          "launches": launches, **card})
    if not (max(diff.values()) < 1e-7 and all(same.values())):
        raise AssertionError(f"quadruped host loop, card vs CPU: {diff}, equal {same}")


def run_slice10_phases(dev, card, L):
    """Slice 10's phases, one after another in this process: the two
    throughput phases first, then the comparisons and the host loops."""
    run_admm_main_path(dev, card, L)
    run_hmm_phases(dev, card, L)
    run_tree_admm_vs_cpu(dev, card, L)
    run_quad_host_loop(dev, card, L)
    run_robust_host_loop(dev, card, L)


# ---- slice 11: the rank-sharded ensembles, the branch-sharded tree KKT, dryrun ----
# Each phase spawns its own ranks (``parallel.launch.launch``): two gloo ranks
# sharing the one card (NCCL refuses two ranks on one device), or one NCCL
# rank. The rank functions below run in those processes (spawn imports them
# from this file); each resets K1's and K2's launch counters in its own
# process just before its timed run and reads them just after.
SHARD_B = 32768
SHARD_WARM = 3
SHARD_EPISODE_STEPS = 10
SHARD_CHECK_B = 1024
KKT_DIMS = (2, 5, 4, 4, 2)       # N, NB, m, n, d: m=4, NB=5, 1,024 leaf branches
KKT_T = 256
KKT_REPS = 3


def _k12():
    from belief_planning_tpu_torch.solvers import cvar_pl, tree_qp_pl

    return tree_qp_pl.KERNEL, cvar_pl.KERNEL


def _reset_launches():
    K, K2 = _k12()
    K.launches, K2.launches = 0, 0


def _launches():
    K, K2 = _k12()
    return {"tree_qp_ipm_iter": K.launches, "cvar_ipm_iter": K2.launches}


def _ensemble_case(kind, B, dtype):
    """``(model, params, pset, make_kw, states, step_kw)`` of a sharded
    ensemble phase on the CPU: the QP overtake (``bench.py``'s states) or
    the merge (its worlds, per-lane S and bx)."""
    if kind == "ipm":
        pset, model, params = overtake_setup()
        states = tuple(torch.as_tensor(a, dtype=dtype) for a in bench_states(B))
        return model, params, pset, {}, states, {}
    model, params, pset, _, ralpha, _ = cvar_config("cvar_merge")
    xs, zs, xRefs, S, bx = cvar_states("cvar_merge", B, torch.device("cpu"), dtype)
    return model, params, pset, {"ralpha": ralpha, "use_S": True}, (xs, zs, xRefs), \
        {"S": S, "bx": bx}


def _sharded_maker(kind):
    from belief_planning_tpu_torch.parallel import ensemble

    return {"ipm": ensemble.make_sharded_ipm_ensemble_step,
            "cvar": ensemble.make_sharded_cvar_ensemble_step}[kind]


def _one_process_maker(kind, model, params, make_kw, device):
    """The one-process step of a phase: ``(init(B, dtype), step)``."""
    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step
    from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    if kind == "ipm":
        return make_branch_mpc_batched_step(model, params, "prox",
                                            ipm=QPIPMConfig(iters=8, gondzio=2),
                                            device=device)[1:]
    return make_cvar_mpc_batched_step(model, params, make_kw["ralpha"],
                                      ipm=CVaRIPMConfig(iters=24, gondzio=2), use_S=True,
                                      device=device)[2:]


def _timed(run, n):
    """``n`` calls of ``run()``, each timed on the host clock from a
    synchronized card to the end of its work on the card; returns the last
    output and the seconds."""
    times, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def shard_ensemble_rank(device, kind):
    """A rank of ``ensemble_{kind}_sharded``: a cold step and SHARD_WARM
    timed warm steps at SHARD_B trees (f32, this rank's rows), a profiled
    step, then the f64 card check at SHARD_CHECK_B: this rank's ``uPred``
    over two steps against the one-process step on the card on the same
    rows."""
    from belief_planning_tpu_torch.parallel.ensemble import local_rows, make_mesh, shard_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((torch.distributed.get_world_size(),), ("dp",), device=device)
    f32, f64 = torch.float32, torch.float64
    model, params, pset, make_kw, states, step_kw = _ensemble_case(kind, SHARD_B, f32)
    _, init, step = _sharded_maker(kind)(model, params, mesh, **make_kw)
    args = shard_rows(mesh, states)
    kw = shard_rows(mesh, step_kw)
    c, u, _ = step(init(SHARD_B, f32), *args, pset.params, **kw)
    _ = u.cpu()                                                   # the cold step
    state = {"c": c}

    def warm():
        state["c"], u_, m_ = step(state["c"], *args, pset.params, **kw)
        return u_.cpu(), m_

    _reset_launches()
    (u, metrics), times = _timed(warm, SHARD_WARM)
    launches = _launches()
    prof = device_profile(warm)
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": torch.distributed.get_backend(), "rows": int(u.shape[0]),
           "times": times, "launches": launches, "finite": bool(u.isfinite().all()),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "device_busy_ms": prof["device_busy_ms"], "wall_ms_profiled": prof["wall_ms_profiled"],
           "device_idle_share": prof["device_idle_share"]}
    del state, args, kw
    torch.cuda.empty_cache()

    # the card check: f64, this rank's rows against the one-process step on
    # the whole batch. On the card the step's ops and kernels are per tree,
    # so a sub-batch rounds as the whole batch does (on the CPU it need not:
    # vector loops and their scalar tails round some elementwise ops apart,
    # and the merge's CVaR IPM-24 amplifies 2.5e-16 into 0.032)
    model, params, pset, make_kw, states, step_kw = _ensemble_case(kind, SHARD_CHECK_B, f64)
    _, init, step = _sharded_maker(kind)(model, params, mesh, **make_kw)
    rows = local_rows(mesh, SHARD_CHECK_B)
    args, kw = shard_rows(mesh, states), shard_rows(mesh, step_kw)
    init1, step1 = _one_process_maker(kind, model, params, make_kw, mesh.device)
    args1 = tuple(t.to(mesh.device) for t in states)
    kw1 = {k: v.to(mesh.device) for k, v in step_kw.items()}
    c, c1 = init(SHARD_CHECK_B, f64), init1(SHARD_CHECK_B, f64)
    diffs = []
    for _ in range(2):
        c, u, _ = step(c, *args, pset.params, **kw)
        c1, r1 = step1(c1, *args1, pset.params, **kw1)
        diffs.append((u - r1.uPred[rows]).abs().max().item())
    out["f64_check"] = {"B": SHARD_CHECK_B, "rows": [rows.start, rows.stop],
                        "max_abs_du_by_step": diffs}
    return out


def shard_episode_rank(device):
    """A rank of ``overtake_episode_sharded``: a cold world step, then
    SHARD_EPISODE_STEPS timed world steps on this rank's SHARD_B / W worlds,
    f32, IPM-8 with 2 correctors."""
    from belief_planning_tpu_torch.parallel.ensemble import (
        make_mesh,
        make_sharded_overtake_episode,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((torch.distributed.get_world_size(),), ("dp",), device=device)
    pset, model, params = overtake_setup()
    _, init_worlds, episode = make_sharded_overtake_episode(overtake_cons(), model, params, mesh)
    w0 = init_worlds(SHARD_B, seed=0)
    w1, _, _ = episode(w0, 1, seed=1)
    _ = w1.x.cpu()
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, traj, metrics = episode(w1, SHARD_EPISODE_STEPS, seed=2, t0=1)
    u = traj["u"].cpu()
    sec = time.perf_counter() - t0
    return {"rank": mesh.rank, "worlds": int(u.shape[0]), "seconds": sec,
            "launches": _launches(), "finite": bool(u.isfinite().all()),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "feasible_share_rank": traj["feasible"].float().mean().item()}


def kkt_case(device, T=KKT_T, seed=0):
    """The branch-sharded KKT's random blocks (the reference dryrun's
    recipe, ``__graft_entry__.py:140-162``) of the tree KKT_DIMS, f64,
    batch-last with T lanes, drawn on ``device`` from ``seed``."""
    from belief_planning_tpu_torch.solvers.tree_qp import build_stage_plan
    from belief_planning_tpu_torch.tree.topology import build_topology

    N_, NB_, m_, n_, d_ = KKT_DIMS
    topo = build_topology(N_, NB_, m_, n_, d_)
    tu, nl = topo.totalu, m_ ** NB_
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = torch.float64
    rnd = lambda *shape: torch.randn(shape, generator=g, dtype=f64, device=device)

    def sym(shape, dim, shift):
        M = 0.1 * rnd(*shape)
        eye = torch.eye(dim, dtype=f64, device=device)[:, :, None]
        return 0.5 * (M + M.transpose(-3, -2)) + shift * eye

    bl = dict(Qx2=sym((tu, n_, n_, T), n_, 2.0), Ru2=sym((tu, d_, d_, T), d_, 1.0),
              Dab2=0.05 * rnd(tu, d_, d_, T),
              A=torch.eye(n_, dtype=f64, device=device)[:, :, None] + 0.1 * rnd(tu, n_, n_, T),
              B=0.3 * rnd(tu, n_, d_, T), qx=rnd(tu, n_, T), qu=rnd(tu, d_, T),
              Pterm2=sym((nl, n_, n_, T), n_, 2.0), qterm=rnd(nl, n_, T))
    return build_stage_plan(topo), bl


def shard_kkt_rank(device):
    """A rank of ``tree_kkt_sharded``: the (1, W) mesh on ("dp", "mp"), the
    blocks cut to this rank, KKT_REPS timed solves; rank 0 returns the
    gathered result."""
    from belief_planning_tpu_torch.parallel.ensemble import make_mesh
    from belief_planning_tpu_torch.parallel.tree_shard import (
        LEAF_KEYS,
        LEVEL_KEYS,
        make_sharded_tree_kkt,
        split_ulevels,
    )
    from belief_planning_tpu_torch.solvers.tree_qp_pl import build_levels

    mesh = make_mesh((1, torch.distributed.get_world_size()), ("dp", "mp"), device=device)
    plan, bl = kkt_case(mesh.device)
    levels = build_levels(plan)
    solve = make_sharded_tree_kkt(plan, mesh)
    blocks = {k: split_ulevels(bl[k], levels) for k in LEVEL_KEYS}
    blocks.update({k: bl[k] for k in LEAF_KEYS})
    local = solve.shard(blocks)
    del bl, blocks
    local_bytes = sum(t.numel() * t.element_size() for k in LEVEL_KEYS for t in local[k]) \
        + sum(local[k].numel() * local[k].element_size() for k in LEAF_KEYS)
    (dx_l, du_l), times = _timed(lambda: solve(local), KKT_REPS)
    out = {"rank": mesh.rank, "shards": solve.shards, "ms": [t * 1e3 for t in times],
           "local_input_bytes": local_bytes, "launches": _launches()}
    dx, du = solve.gather(dx_l, du_l)
    if mesh.rank == 0:
        out["whole"] = ([t.cpu() for t in dx], [t.cpu() for t in du])
    return out


def run_sharded_ensemble_phase(dev, card, kind):
    """``ensemble_ipm_sharded`` (the QP overtake on K1, IPM-8 with 2
    correctors) or ``ensemble_cvar_sharded`` (the merge on K2, IPM-24 with 2
    correctors): SHARD_B trees as 2 gloo ranks on the card, each rank's and
    the aggregate solves/s beside the one-process step's in this process,
    and the f64 card check at SHARD_CHECK_B (≤ 1e-12)."""
    from belief_planning_tpu_torch.parallel.launch import launch

    f32 = torch.float32
    model, params, pset, make_kw, states, step_kw = _ensemble_case(kind, SHARD_B, f32)
    init1, step1 = _one_process_maker(kind, model, params, make_kw, dev)
    args = tuple(t.to(dev) for t in states)
    kw = {k: v.to(dev) for k, v in step_kw.items()}
    state = {"c": step1(init1(SHARD_B, f32), *args, pset.params, **kw)[0]}

    def warm():
        state["c"], r = step1(state["c"], *args, pset.params, **kw)
        return r.uPred.cpu()

    _, one_times = _timed(warm, SHARD_WARM)
    del state, args, kw
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(shard_ensemble_rank, 2, "gloo", str(dev), args=(kind,))
    launch_s = time.perf_counter() - t0
    iters = 8 if kind == "ipm" else 24
    kernel = "tree_qp_ipm_iter" if kind == "ipm" else "cvar_ipm_iter"
    lockstep = np.max([r["times"] for r in ranks], axis=0)     # each step ends in an all_reduce
    one_med = float(np.median(one_times))
    line = {"phase": f"ensemble_{kind}_sharded", "config": "qp_overtake" if kind == "ipm"
            else "cvar_merge", "B": SHARD_B, "ranks": 2, "backend": "gloo", "dtype": "float32",
            "steps_timed": SHARD_WARM, "ipm_iters": iters,
            "one_process": {"step_ms_median": one_med * 1e3,
                            "step_ms_all": [t * 1e3 for t in one_times],
                            "solves_per_s": SHARD_B / one_med},
            "aggregate_solves_per_s": SHARD_B / float(np.median(lockstep)),
            "aggregate_step_ms_median": float(np.median(lockstep)) * 1e3,
            "ranks_detail": [{"rank": r["rank"], "device": r["device"], "rows": r["rows"],
                              "step_ms_median": float(np.median(r["times"])) * 1e3,
                              "solves_per_s": r["rows"] / float(np.median(r["times"])),
                              "launches": r["launches"], "metrics": r["metrics"],
                              "device_busy_ms_profiled": r["device_busy_ms"],
                              "wall_ms_profiled": r["wall_ms_profiled"],
                              "device_idle_share": r["device_idle_share"],
                              "f64_check": r["f64_check"]} for r in ranks],
            # both ranks' kernels share the card over the profiled (lock-stepped)
            # step: 1 − their summed busy time over the wall bounds its idle
            # share from below (kernels time-sliced between the two contexts
            # count in both ranks' busy time)
            "device_idle_share_both_lower_bound": max(
                0.0, 1 - sum(r["device_busy_ms"] for r in ranks)
                / max(r["wall_ms_profiled"] for r in ranks)),
            "launch_seconds": launch_s, "tol_f64": 1e-12, **card}
    emit(line)
    want = iters * SHARD_WARM
    for r in ranks:
        if r["launches"][kernel] != want or not r["finite"]:
            raise AssertionError(f"{line['phase']}: rank {r['rank']} launched {kernel} "
                                 f"{r['launches'][kernel]} times (expected {want}), finite "
                                 f"{r['finite']}")
        if max(r["f64_check"]["max_abs_du_by_step"]) > 1e-12:
            raise AssertionError(f"{line['phase']}: rank {r['rank']} against the one-process "
                                 f"step: {r['f64_check']}")
    if ranks[0]["metrics"] != ranks[1]["metrics"]:
        raise AssertionError(f"{line['phase']}: the ranks' metrics differ")
    return [r["launches"][kernel] for r in ranks]


def run_sharded_episode_phase(dev, card):
    """``overtake_episode_sharded``: the closed-loop overtake at SHARD_B
    worlds as 2 gloo ranks, SHARD_EPISODE_STEPS warm world steps, beside the
    one-process episode in this process, with the reduced metrics."""
    from belief_planning_tpu_torch.envs.batched_highway import make_batched_overtake_fused
    from belief_planning_tpu_torch.parallel.launch import launch
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    pset, model, params = overtake_setup()
    _, init_w, episode = make_batched_overtake_fused(overtake_cons(), model, params, "prox",
                                                     ipm=QPIPMConfig(iters=8, gondzio=2),
                                                     device=dev)
    w1, _ = episode(init_w(SHARD_B, seed=0), 1, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, traj = episode(w1, SHARD_EPISODE_STEPS, seed=2, t0=1)
    _ = traj["u"].cpu()
    one_s = time.perf_counter() - t0
    del w1, traj
    torch.cuda.empty_cache()
    ranks = launch(shard_episode_rank, 2, "gloo", str(dev))
    sec = max(r["seconds"] for r in ranks)
    line = {"phase": "overtake_episode_sharded", "B": SHARD_B, "ranks": 2, "backend": "gloo",
            "dtype": "float32", "steps_timed": SHARD_EPISODE_STEPS, "ipm_iters": 8,
            "one_process_world_steps_per_s": SHARD_B * SHARD_EPISODE_STEPS / one_s,
            "aggregate_world_steps_per_s": SHARD_B * SHARD_EPISODE_STEPS / sec,
            "ranks_detail": [{k: v for k, v in r.items()} for r in ranks],
            "launches_expected": 8 * SHARD_EPISODE_STEPS, **card}
    emit(line)
    for r in ranks:
        if r["launches"]["tree_qp_ipm_iter"] != 8 * SHARD_EPISODE_STEPS or not r["finite"]:
            raise AssertionError(f"overtake_episode_sharded: rank {r['rank']}: {r}")
        if r["metrics"] != ranks[0]["metrics"]:
            raise AssertionError("overtake_episode_sharded: the ranks' metrics differ")
    m = ranks[0]["metrics"]
    if m["count"] != SHARD_B * SHARD_EPISODE_STEPS or m["feasible_frac"] < 0.5:
        raise AssertionError(f"overtake_episode_sharded: metrics {m}")
    return [r["launches"]["tree_qp_ipm_iter"] for r in ranks]


def helpers_whole_vs_halves(bl, levels, pr):
    """Each small-matrix product of ``pr`` (``tree_qp_pl.Products``) on each
    level's blocks, the whole batch against its two halves put together (the
    branch axis where the level has two or more branches, else the lane
    axis): the max |Δ| by product and level. ``FIXED_ORDER`` gives 0.0
    everywhere; a batched library product may round a batch of another count
    differently."""
    from belief_planning_tpu_torch.solvers.tree_qp_pl import _ublk

    out = {}
    for k, mt in enumerate(levels):
        A = _ublk(bl["A"], mt)[:, 0].contiguous()                       # (nb, n, n, T)
        v = _ublk(bl["qx"], mt)[:, 0].contiguous()                      # (nb, n, T)
        ax = 0 if A.shape[0] >= 2 else -1
        for nm, b_ in (("mm", A), ("mtm", A), ("mv", v), ("mtv", v)):
            fn = getattr(pr, nm)
            halves = [fn(a_, c_) for a_, c_ in zip(A.chunk(2, dim=ax), b_.chunk(2, dim=ax))]
            out.setdefault(nm, []).append((fn(A, b_) - torch.cat(halves, dim=ax)).abs().max().item())
    return out


def run_sharded_kkt_phase(dev, card):
    """``tree_kkt_sharded``: the m=4, NB=5 tree (1,024 leaf branches, N=2,
    n=4, d=2) at T=KKT_T in f64, mp=2 on 2 gloo ranks, against the
    unsharded level-blocked sweeps in this process with the same
    fixed-order products: the two must be equal (``torch.equal``), as on
    the CPU (``tests/test_torch_tree_shard.py``). Also reports each product
    at every level, the whole batch against its two halves, for the
    fixed-order products and the library ones of K1's and K2's plain
    versions (:func:`helpers_whole_vs_halves`)."""
    from belief_planning_tpu_torch.parallel.launch import launch
    from belief_planning_tpu_torch.solvers.tree_qp_pl import (
        FIXED_ORDER,
        LIBRARY,
        _factor_blocks,
        _forward_blocks,
        _linear_blocks,
        build_levels,
    )

    N_, NB_, m_, n_, d_ = KKT_DIMS
    plan, bl = kkt_case(dev)
    levels = build_levels(plan)
    in_bytes = sum(t.numel() * t.element_size() for t in bl.values())
    split = {name: helpers_whole_vs_halves(bl, levels, pr)
             for name, pr in (("fixed_order", FIXED_ORDER), ("library", LIBRARY))}

    def unsharded():
        pr = FIXED_ORDER
        K_l, Hinv_l, Acl_l = _factor_blocks(levels, bl["Qx2"], bl["Dab2"], bl["Ru2"],
                                            bl["Pterm2"], bl["A"], bl["B"], n_, d_, m_, pr)
        kff_l = _linear_blocks(levels, K_l, Hinv_l, Acl_l, bl["B"], bl["qx"], bl["qu"],
                               bl["qterm"], n_, d_, m_, pr)
        return _forward_blocks(levels, K_l, Acl_l, bl["B"], kff_l, n_, d_, m_, KKT_T, pr)

    (dx_ref, du_ref), one_times = _timed(unsharded, KKT_REPS)
    dx_ref, du_ref = dx_ref.cpu(), du_ref.cpu()
    out_bytes = (dx_ref.numel() + du_ref.numel()) * 8
    del bl
    torch.cuda.empty_cache()
    ranks = launch(shard_kkt_rank, 2, "gloo", str(dev))
    dx_l, du_l = ranks[0].pop("whole")
    flat = lambda ls: torch.cat([b.reshape((-1,) + b.shape[2:]) for b in ls], dim=0)
    dx, du = flat(dx_l), flat(du_l)
    equal = torch.equal(dx, dx_ref) and torch.equal(du, du_ref)
    line = {"phase": "tree_kkt_sharded", "N": N_, "NB": NB_, "m": m_, "n": n_, "d": d_,
            "leaf_branches": m_ ** NB_, "totalu": plan.topo.totalu, "T": KKT_T,
            "dtype": "float64", "mesh": {"dp": 1, "mp": 2}, "backend": "gloo",
            "input_bytes": in_bytes, "A_bytes": plan.topo.totalu * n_ * n_ * KKT_T * 8,
            "output_bytes": out_bytes,
            "one_process_ms": [t * 1e3 for t in one_times],
            "ranks_detail": ranks, "equal": equal,
            "max_abs_diff": max((dx - dx_ref).abs().max().item(),
                                (du - du_ref).abs().max().item()),
            "helpers_whole_vs_halves_by_level": split,
            "bound_ms_one_process": (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3, **card}
    emit(line)
    if not equal:
        raise AssertionError(f"tree_kkt_sharded: sharded and unsharded sweeps differ: max |Δ| "
                             f"{line['max_abs_diff']:.3e}")


def run_nccl_phase(dev, card):
    """``nccl_world1``: the QP ensemble on one NCCL rank, SHARD_B trees."""
    from belief_planning_tpu_torch.parallel.launch import launch

    (r,) = launch(shard_ensemble_rank, 1, "nccl", None, args=("ipm",))
    line = {"phase": "nccl_world1", "B": SHARD_B, "backend": r["backend"], "device": r["device"],
            "step_ms_median": float(np.median(r["times"])) * 1e3,
            "solves_per_s": SHARD_B / float(np.median(r["times"])),
            "launches": r["launches"], "metrics": r["metrics"], "f64_check": r["f64_check"],
            "device_idle_share": r["device_idle_share"], **card}
    emit(line)
    if (r["backend"] != "nccl" or r["launches"]["tree_qp_ipm_iter"] != 8 * SHARD_WARM
            or not r["finite"] or max(r["f64_check"]["max_abs_du_by_step"]) > 1e-12):
        raise AssertionError(f"nccl_world1: {line}")
    return r["launches"]["tree_qp_ipm_iter"]


def run_dryrun_phase(dev, card):
    """``dryrun_multichip(2)`` with 2 gloo ranks on the card."""
    from belief_planning_tpu_torch.entry import dryrun_multichip

    reports = dryrun_multichip(2, "gloo", str(dev))
    emit({"phase": "dryrun_multichip", "n_devices": 2, "reports": reports, **card})
    for r in reports:
        if r["launches"] != {"tree_qp_ipm_iter": 16, "cvar_ipm_iter": 12}:
            raise AssertionError(f"dryrun_multichip: rank {r['rank']} launches {r['launches']}")
    return reports


def run_slice11_phases(dev, card):
    """Slice 11's phases, one after another; returns the ranks' K1 and K2
    launches by path for the kernels line."""
    t0 = time.perf_counter()
    k1 = {"ensemble_ipm_sharded": run_sharded_ensemble_phase(dev, card, "ipm")}
    k2 = {"ensemble_cvar_sharded": run_sharded_ensemble_phase(dev, card, "cvar")}
    k1["overtake_episode_sharded"] = run_sharded_episode_phase(dev, card)
    run_sharded_kkt_phase(dev, card)
    k1["nccl_world1"] = run_nccl_phase(dev, card)
    reports = run_dryrun_phase(dev, card)
    k1["dryrun_multichip"] = [r["launches"]["tree_qp_ipm_iter"] for r in reports]
    k2["dryrun_multichip"] = [r["launches"]["cvar_ipm_iter"] for r in reports]
    emit({"phase": "slice11_seconds", "seconds": time.perf_counter() - t0, **card})
    return k1, k2


# ---- slice 12: cvar_ipm_solve's diagnostic options, the closed-loop parity episodes ----
DIAG_OPTIONS = {"resid_carried": dict(resid="carried"), "recovery_stable": dict(recovery="stable"),
                "neighborhood": dict(neighborhood=0.3), "split_step": dict(split_step=True),
                "recenter": dict(recenter=2, recenter_tol=0.5), "diag_extra": dict(diag_extra=True)}
# trees of the hard batch (of 32) whose first 10 iterations move least, on
# the CPU under every option, for a relative change of 2.2e-16 or 4.4e-16 of
# their tree (≤ 1.1e-11 of each field's magnitude); on the other trees the
# reference's own conditioning moves a field by up to 1e-8 that way
DIAG_TREES = (3, 6, 15, 17, 18, 22, 24, 28)
DIAG_ITERS = 10
DIAG_F32_B, DIAG_F32_ITERS = 32, 40
PARITY_STEPS = 10


def run_cvar_diag_options_phase(dev, card, L):
    """``cvar_diag_options``: each diagnostic option of ``cvar_ipm_solve`` on
    the hard cold-start batch of ``scripts/torch_port_cvar_f32_diag.py`` at
    the overtake's N=8, NB=2: in f64 on DIAG_TREES (B=8, 10 iterations) on
    the card against the same trees on the CPU (gaps, u, x and every
    diagnostic within 1e-10 of the field's magnitude), with the option shown
    to act; then once in f32 on the whole batch (B=32, 40 iterations), the
    final gap's p50 and max. No kernel runs (the per-tree IPM is plain
    PyTorch in both packages): every launch counter stays 0."""
    from belief_planning_tpu_torch.models.policies import cast_params
    from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology

    t0 = time.perf_counter()
    diag = load_script("torch_port_cvar_f32_diag")
    f64 = torch.float64
    _, pset, model, params = diag.overtake_setup()
    topo = build_topology(params.N, params.NB, model.m, params.n, params.d)
    cplan = build_cvar_plan(topo)
    xs, zs = (torch.as_tensor(a[list(DIAG_TREES)], dtype=f64) for a in diag.hard_batch(32))
    B = xs.shape[0]
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, params.d, dtype=f64),
                    cast_params(pset.params, f64, "cpu"))
    xRef = torch.as_tensor(diag.XREF, dtype=f64)

    def solve(opts, where):
        out = cvar_ipm_solve(cplan, ts, params.Q, params.R, params.Qslack, xRef, 0.9, params.Fx,
                             params.bx, params.Fu, params.bu, xs,
                             cfg=CVaRIPMConfig(iters=DIAG_ITERS, **opts), device=where)
        return on_cpu(out)

    L.reset()
    on_card = {name: solve(opts, dev) for name, opts in {"default": {}, **DIAG_OPTIONS}.items()}
    launches = L.check("cvar_diag_options")
    base = on_card["default"][4]
    results, worst = {}, 0.0
    for name, opts in DIAG_OPTIONS.items():
        c, p = on_card[name], solve(opts, "cpu")
        keys = sorted(p[4]["diag"])
        errs = scaled_err([c[4]["gaps"], c[1], c[0]] + [c[4]["diag"][k] for k in keys],
                          [p[4]["gaps"], p[1], p[0]] + [p[4]["diag"][k] for k in keys],
                          ["gaps", "u", "x"] + keys)
        field, (rel, _) = max(errs.items(), key=lambda kv: kv[1][0])
        acted = {"diag_extra": len(c[4]["diag"]) > len(base["diag"]),
                 "neighborhood": int(c[4].get("nbr_cuts", torch.zeros(1)).sum()) > 0,
                 "recenter": int(c[4].get("recenters", torch.zeros(1)).sum()) > 0
                 }.get(name, not torch.equal(c[4]["gaps"], base["gaps"]))
        results[name] = {"max_scaled_err": rel, "worst_field": field, "acted": acted,
                         "same_keys": set(c[4]["diag"]) == set(p[4]["diag"]),
                         "final_gap_p50_f64": c[4]["gaps"][:, -1].median().item()}
        worst = max(worst, rel)
    f64_s = time.perf_counter() - t0
    solve32 = diag.hard_batch_trees(DIAG_F32_B, torch.float32, dev)
    f32 = {}
    for name, opts in DIAG_OPTIONS.items():
        g = solve32(CVaRIPMConfig(iters=DIAG_F32_ITERS, **opts))[0]["gap"][:, -1]
        f32[name] = {"final_gap_p50": float(np.percentile(g, 50)), "final_gap_max": float(g.max()),
                     "finite": bool(np.isfinite(g).all())}
    emit({"phase": "cvar_diag_options", "N": params.N, "NB": params.NB, "trees": list(DIAG_TREES),
          "iters": DIAG_ITERS, "dtype": "float64", "tol": 1e-10, "options": results,
          "f32": {"B": DIAG_F32_B, "iters": DIAG_F32_ITERS, "by_option": f32},
          "launches": launches, "seconds_f64": f64_s, "seconds": time.perf_counter() - t0,
          **card})
    bad = [n_ for n_, r in results.items()
           if not (r["max_scaled_err"] <= 1e-10 and r["acted"] and r["same_keys"])]
    if bad or not all(r["finite"] for r in f32.values()):
        raise AssertionError(f"cvar_diag_options: {bad} {results} {f32}")


def on_cpu(out):
    """A solve's ``(x, u, s, r, aux)`` with every tensor on the CPU."""
    cpu = lambda v: v.cpu() if torch.is_tensor(v) else {k: cpu(w) for k, w in v.items()}
    return tuple(cpu(v) for v in out)


def run_parity_episode_phases(dev, card, K, K2):
    """``qp_parity_episode`` and ``cvar_parity_episode``: the closed-loop
    parity episodes of ``scripts/torch_port_f32_parity_episode.py`` and
    ``scripts/torch_port_cvar_parity_episode.py`` (the demo overtake, B=1)
    cut to PARITY_STEPS steps: the f64 loop (IPM-40 on K1's / K2's f64
    build), then the f32 and refine10 modes, each self-driven,
    teacher-forced on the f64 loop's states, and on its states and warm
    starts. Each mode's launches are read from K1's / K2's counter, set to 0
    just before the mode; the QP's refine10 deviation with states and warm
    starts forced (the per-step solver accuracy) is held at 1e-3
    (``BASELINE.md``). Returns the launches of each kernel over its episodes."""
    launches = {}
    for phase, name, kern, kw, per_step in (
            ("qp_parity_episode", "torch_port_f32_parity_episode", K, dict(control=False),
             {"f64": 40, "f32": 8, "refine10": 18}),
            ("cvar_parity_episode", "torch_port_cvar_parity_episode", K2, {},
             {"f64": 40, "f32": 24, "refine10": 34})):
        t0 = time.perf_counter()
        res = load_script(name).parity_episodes(dev, PARITY_STEPS, ["f32", "refine10"],
                                                kernel=kern, **kw)
        got = {"f64": res["f64_ref_launches"], "f32": res["f32"]["launches"],
               "refine10": res["refine10"]["launches"]}
        want = {m: PARITY_STEPS * n_ * (1 if m == "f64" else 3) for m, n_ in per_step.items()}
        line = {"phase": phase, "steps": PARITY_STEPS, "B": 1,
                "teacher_forced_max": {m: res[m]["teacher_forced"]["max_dev"]
                                       for m in ("f32", "refine10")},
                "teacher_forced_warm_max": {m: res[m]["teacher_forced_warm"]["max_dev"]
                                            for m in ("f32", "refine10")},
                "self_driven_max": {m: res[m]["closed_loop"]["max_dev"] for m in ("f32", "refine10")},
                "p50_ms": {"f64": res["f64_ref_p50_ms"], "f32": res["f32"]["p50_ms"],
                           "refine10": res["refine10"]["p50_ms"]},
                "launches": got, "launches_expected": want, "detail": res,
                "seconds": time.perf_counter() - t0, **card}
        emit(line)
        launches[phase] = sum(got.values())
        finite = all(np.isfinite(res[m][s]["max_dev"]) for m in ("f32", "refine10")
                     for s in ("closed_loop", "teacher_forced", "teacher_forced_warm"))
        if got != want or not finite:
            raise AssertionError(f"{phase}: launches {got} (expected {want}), finite {finite}")
        warm = res["refine10"]["teacher_forced_warm"]["max_dev"]
        if phase == "qp_parity_episode" and not warm <= 1e-3:
            raise AssertionError(f"{phase}: refine10 deviation, states and warm starts forced, "
                                 f"{warm:.3e} > 1e-3")
    return launches


def run_slice12_phases(dev, card, L):
    """Slice 12's phases; returns the parity episodes' K1 and K2 launches."""
    t0 = time.perf_counter()
    run_cvar_diag_options_phase(dev, card, L)
    launches = run_parity_episode_phases(dev, card, L.kernels["tree_qp_ipm_iter"],
                                         L.kernels["cvar_ipm_iter"])
    emit({"phase": "slice12_seconds", "seconds": time.perf_counter() - t0, **card})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import belief_planning_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the belief_planning_tpu_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step
    from belief_planning_tpu_torch.ops import shared_rows, soc
    from belief_planning_tpu_torch.solvers import cvar_pl, tree_qp_pl
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    card = {"card": name, "nvidia_smi": smi}
    emit({"phase": "device", **card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 1. build: every kernel source, one nvcc each, started together -----
    K = tree_qp_pl.KERNEL
    K2 = cvar_pl.KERNEL
    K3 = soc.KERNEL
    K5 = shared_rows.KERNEL
    errors = []

    def build(kernel):
        try:
            kernel.load_all() if kernel is K else kernel.load()
        except Exception as e:          # re-raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(k,)) for k in (K, K2, K3, K5)]
    t_build = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    build_wall = time.perf_counter() - t_build
    if errors:
        raise errors[0]
    emit({"phase": "build", "seconds": round(K.build_seconds, 3),
          "seconds_by_dims": {str(list(dm)): round(sec, 3) for dm, (_, sec) in K.builds.items()},
          "ptxas": ptxas_entries(K.build_log), "wall_seconds_all": round(build_wall, 3),
          **card})
    ptxas2 = [ln.strip() for ln in K2.build_log.splitlines()
              if "registers" in ln or "spill" in ln or "stack frame" in ln]
    emit({"phase": "build_cvar", "seconds": round(K2.build_seconds, 3), "ptxas": ptxas2,
          "wall_seconds_both": round(build_wall, 3), **card})
    emit({"phase": "build_soc", "seconds": round(K3.build_seconds, 3),
          "ptxas": ptxas_entries(K3.build_log), "wall_seconds_all": round(build_wall, 3), **card})
    emit({"phase": "build_shared_rows", "seconds": round(K5.build_seconds, 3),
          "ptxas": ptxas_entries(K5.build_log), "wall_seconds_all": round(build_wall, 3), **card})

    # ---- 2. kernel vs plain version on the card ----------------------------
    cfg = QPIPMConfig(iters=8, gondzio=2)

    def plain_step(plan):
        nFx, nFu = 4, 4
        mtot = float(plan.topo.totalu * (2 * (nFx + 1) + nFu))
        return tree_qp_pl.make_iteration(plan, cfg, nFx, nFu, mtot)

    def one_iteration(B, dtype, advance=0):
        plan, _, su = qp_case(dev, B, dtype, cfg)
        plain = plain_step(plan)
        carry = su.carry0
        for _ in range(advance):      # a later carry of the same solve (plain steps)
            carry = plain(*su.const_args, *carry)[:tree_qp_pl.CARRY_FIELDS]
        err = hold_iteration(su.step_fn, plain, su.const_args, carry,
                             {"phase": "kernel_vs_plain", "B": B, "dtype": str(dtype)[6:],
                              "iteration": advance + 1}, card)
        return plan, su, plain, carry, err

    one_iteration(256, torch.float64)
    one_iteration(256, torch.float64, advance=4)
    one_iteration(BENCH_B, torch.float64)
    plan, su, plain, carry, f32_err = one_iteration(BENCH_B, torch.float32)

    # full 8-iteration f64 solve: the kernel on the card, the plain version on the CPU
    plan64, _, su64 = qp_case(dev, 256, torch.float64, cfg)
    full = []
    for step, to in ((su64.step_fn, lambda t: t), (plain_step(plan64), lambda t: t.cpu())):
        c = tuple(to(t) for t in su64.carry0)
        ca = [to(t) for t in su64.const_args]
        for _ in range(cfg.iters):
            c = step(*ca, *c)[:tree_qp_pl.CARRY_FIELDS]
        full.append([t.cpu() for t in c])
    du = (full[0][1] - full[1][1]).abs().max().item()
    dx = (full[0][0] - full[1][0]).abs().max().item()
    emit({"phase": "kernel_vs_plain_solve", "B": 256, "dtype": "float64", "iters": cfg.iters,
          "max_abs_du": du, "max_abs_dx": dx, "plain_on": "cpu", **card})
    if not (du < 1e-7 and dx < 1e-6):
        raise AssertionError(f"8-iteration f64 solve: |du| {du:.3e}, |dx| {dx:.3e}")

    # kernel timing at the main path's shape (f32, B=32768), plain beside it
    k_ms = cuda_ms(lambda: su.step_fn(*su.const_args, *carry), reps=5)
    plain_ms = cuda_ms(lambda: plain(*su.const_args, *carry), reps=2)
    nbytes = iteration_bytes(su)
    flops = iteration_flops(plan, 4, 4, cfg.gondzio, BENCH_B)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS["float32"] * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    # the latency shape, B=256 (2 trees a block), held to the f32 bar first
    plan_s, su_s, plain_s, carry_s, _ = one_iteration(256, torch.float32)
    k_ms_256 = cuda_ms(lambda: su_s.step_fn(*su_s.const_args, *carry_s), reps=20)
    plain_ms_256 = cuda_ms(lambda: plain_s(*su_s.const_args, *carry_s), reps=3)
    bound_ms_256 = max(iteration_bytes(su_s) / H100_BYTES_PER_S,
                       iteration_flops(plan_s, 4, 4, cfg.gondzio, 256) / H100_FLOPS["float32"]) * 1e3
    ints = tree_qp_pl.kernel_ints(plan, cfg, 4, 4)
    kplan = K.plan(ints, BENCH_B, torch.float32, dev.index)
    kplan_256 = K.plan(ints, 256, torch.float32, dev.index)
    resident = kplan["trees_per_block"] * kplan["blocks_per_sm"]
    teams = kplan["blocks"] * kplan["trees_per_block"]
    emit({"phase": "kernel_time", "B": BENCH_B, "dtype": "float32", "ms": k_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": nbytes, "flops": flops, "ms_B256": k_ms_256,
          "plain_ms_B256": plain_ms_256, "bound_ms_B256": bound_ms_256,
          # the launch plan (a warp per tree, a persistent grid) and the working
          # set: shared memory a block, one scratch slot per resident team
          "trees_per_block": kplan["trees_per_block"], "blocks_per_sm": kplan["blocks_per_sm"],
          "resident_teams_per_sm": resident, "blocks": kplan["blocks"],
          "smem_bytes_per_block": kplan["smem_bytes"],
          "scratch_bytes": kplan["scratch_elems"] * 4,
          "slot_bytes_per_tree": kplan["scratch_elems"] * 4 // teams,
          "trees_per_block_B256": kplan_256["trees_per_block"], "blocks_B256": kplan_256["blocks"],
          **card})
    del su, carry, su64, su_s, carry_s

    # ---- 3. main path --------------------------------------------------------
    pset, model, params = overtake_setup()
    ipm = QPIPMConfig(iters=8, gondzio=2)
    topo, init_carry, step = make_branch_mpc_batched_step(model, params, "prox", ipm=ipm)
    f32 = torch.float32

    def drive(B, steps, dtype=f32, stepper=step, init=init_carry, device=dev):
        xs, zs, xRefs = (torch.as_tensor(a, dtype=dtype, device=device) for a in bench_states(B))
        carrys = init(B, dtype)
        carrys, res = stepper(carrys, xs, zs, xRefs, pset.params)     # warm-up step
        _ = res.uPred.cpu()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            _c, res = stepper(carrys, xs, zs, xRefs, pset.params)
            _ = res.uPred.cpu()
            times.append(time.perf_counter() - t0)
        return res, times

    steps = 5
    K.launches = 0
    res, times = drive(BENCH_B, steps)
    launches = K.launches
    u = res.uPred
    finite = all(bool(t.isfinite().all()) for t in (res.xPred, res.uPred, res.slack, res.prim_res))
    a_max = u[..., 0].abs().max().item()
    r_max = u[..., 1].abs().max().item()
    feas = res.feasible
    a_max_feas = u[feas][..., 0].abs().max().item() if bool(feas.any()) else 0.0
    r_max_feas = u[feas][..., 1].abs().max().item() if bool(feas.any()) else 0.0
    feasible_share = feas.float().mean().item()
    med = float(np.median(times))
    _, times256 = drive(256, 10)
    main = {"phase": "main_path", "B": BENCH_B, "N": N, "NB": NB, "ipm_iters": ipm.iters,
            "gondzio": ipm.gondzio, "dtype": "float32", "steps_timed": steps,
            "step_ms_median": med * 1e3, "step_ms_all": [t * 1e3 for t in times],
            "solves_per_s": BENCH_B / med, "p50_ms_B256": float(np.median(times256)) * 1e3,
            "launches": launches, "launches_expected": ipm.iters * (steps + 1),
            "finite": finite, "max_abs_a": a_max, "max_abs_r": r_max,
            "max_abs_a_feasible": a_max_feas, "max_abs_r_feasible": r_max_feas,
            "feasible_share": feasible_share,
            "prim_res_max": res.prim_res.max().item(), **card}
    emit(main)
    if not finite:
        raise AssertionError("main path: non-finite outputs")
    if launches != ipm.iters * (steps + 1):
        raise AssertionError(f"main path: {launches} kernel launches, expected "
                             f"{ipm.iters * (steps + 1)}")
    # The input bounds hold, within the controller's feasibility tolerance
    # (feas_tol = 1e-3), on every lane it reports feasible; the f32 IPM-8 leaves
    # a share of lanes above that residual (reported as feasible_share), as
    # the JAX package's f32 path does.
    tol_b = 1e-3
    if a_max_feas > 6.0 + tol_b or r_max_feas > 0.3 + tol_b:
        raise AssertionError(f"main path: feasible lanes outside the bounds |a|≤6, |r|≤0.3: "
                             f"{a_max_feas}, {r_max_feas}")
    if feasible_share < 0.5:
        raise AssertionError(f"main path: only {feasible_share:.3f} of lanes feasible")
    main_launches = launches

    # where a main-path step's time goes: one profiled warm-started step
    for B in (BENCH_B, 256):
        xs, zs, xRefs = (torch.as_tensor(a, dtype=f32, device=dev) for a in bench_states(B))
        carrys, _ = step(init_carry(B, f32), xs, zs, xRefs, pset.params)
        out = profile_step(lambda: step(carrys, xs, zs, xRefs, pset.params)[1].uPred.cpu())
        emit({"phase": "main_path_profile", "B": B, **out, **card})

    # the f64 path on the card against the same steps on the CPU (plain version)
    f64 = torch.float64
    _, cpu_init, cpu_step = make_branch_mpc_batched_step(model, params, "prox", ipm=ipm,
                                                                device="cpu")
    _, init64, step64 = make_branch_mpc_batched_step(model, params, "prox", ipm=ipm)
    outs = {}
    for where, (st_, in_, dv) in {"cuda": (step64, init64, dev),
                                  "cpu": (cpu_step, cpu_init, torch.device("cpu"))}.items():
        xs, zs, xRefs = (torch.as_tensor(a, dtype=f64, device=dv) for a in bench_states(64))
        c = in_(64, f64)
        seq = []
        for _ in range(2):
            c, r = st_(c, xs, zs, xRefs, pset.params)
            seq.append((r.uPred.cpu(), r.xPred.cpu()))
        outs[where] = seq
    du = max((a[0] - b[0]).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    dx = max((a[1] - b[1]).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    emit({"phase": "main_path_vs_cpu", "B": 64, "dtype": "float64", "steps": 2,
          "max_abs_du": du, "max_abs_dx": dx, **card})
    if not (du < 1e-7 and dx < 1e-6):
        raise AssertionError(f"f64 main path on the card vs CPU: |du| {du:.3e}, |dx| {dx:.3e}")

    # ---- 4. f64 restart through the double kernel ----------------------------
    _, init_r, step_r = make_branch_mpc_batched_step(model, params, "prox", ipm=ipm,
                                                     refine_f64=10)
    K.launches = 0
    res_r, times_r = drive(256, 1, stepper=step_r, init=init_r)
    emit({"phase": "refine_f64", "B": 256, "refine_iters": 10, "launches": K.launches,
          "launches_expected": 2 * (ipm.iters + 10),
          "finite": bool(res_r.uPred.isfinite().all()),
          "feasible_share": res_r.feasible.float().mean().item(),
          "prim_res_max": res_r.prim_res.max().item(), "step_ms": times_r[0] * 1e3, **card})
    if K.launches != 2 * (ipm.iters + 10) or not bool(res_r.uPred.isfinite().all()):
        raise AssertionError("refine_f64 step: wrong launch count or non-finite output")

    # ---- 5. the CVaR slice ----------------------------------------------------
    cvar_lines = run_cvar_phases(dev, card, K2)

    # ---- 6. the cone-ADMM slice (K3) and the K1 profile (K4) --------------------
    soc_line = run_admm_phases(dev, card, K3)
    phase_line = run_k1_phases(dev, card, K, k_ms)

    # ---- 8. slice 4: the shared-row probe (K5) and the per-tree IPM steps --------
    k5_line = run_shared_rows_phases(dev, card, K5)
    run_per_tree_phases(dev, card, K, K2)

    # ---- 9. slice 8: the quadruped on K1, the merge episode on K2 -----------------
    quad_entries = run_quadruped_phases(dev, card, K)
    run_merge_episode_phases(dev, card, K2)

    # ---- 10. slice 9: the overtake ensemble on K1, the host loops -----------------
    overtake_launches = run_overtake_episode_phases(dev, card, K)
    run_host_loop_phases(dev, card, K)

    # ---- 11. slice 10: the tree-QP ADMM, the robust and HMM paths (no kernel) -----
    t_slice10 = time.perf_counter()
    run_slice10_phases(dev, card, Launches(K, K2, K3, K5))
    emit({"phase": "slice10_seconds", "seconds": time.perf_counter() - t_slice10, **card})

    # ---- 12. slice 11: the rank-sharded ensembles, tree KKT and dryrun ------------
    k1_sharded, k2_sharded = run_slice11_phases(dev, card)

    # ---- 13. slice 12: the six options of cvar_ipm_solve, the parity episodes -----
    parity = run_slice12_phases(dev, card, Launches(K, K2, K3, K5))
    k1_sharded["qp_parity_episode"] = parity["qp_parity_episode"]
    k2_sharded["cvar_parity_episode"] = parity["cvar_parity_episode"]
    cvar_lines["launches_by_path"] = {"main_path": cvar_lines["launches"], **k2_sharded}

    # ---- 14. kernels line, card line, result ------------------------------------
    emit({"kernels": [{
        "name": "tree_qp_ipm_iter",
        "route": "cuda",
        "source": "belief_planning_tpu_torch/csrc/tree_qp_ipm_iter.cu",
        "replaces": "belief_planning_tpu/solvers/tree_qp_pl.py:825",
        "launches": main_launches,
        "max_abs_err": f32_err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "launches_by_path": {"main_path": main_launches, "quadruped": quad_entries[0]["launches"],
                             "overtake_episode": overtake_launches, **k1_sharded},
        "instantiations": [{"dims": list(K.dims[0]), "B": BENCH_B, "launches": main_launches,
                            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "max_abs_err": f32_err}, *quad_entries],
    }, cvar_lines, soc_line, phase_line, k5_line]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, **card})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
