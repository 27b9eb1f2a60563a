"""Where one K1 launch's time goes, phase by phase, on one CUDA card.

    python scripts/torch_port_qp_kernel_phases.py

Copies ``csrc/tree_qp_ipm_iter.cu`` into the git-ignored
``belief_planning_tpu_torch/_build/phases/`` with ``clock64()`` marks: in the
first round of block 0, around the block's staging in, its trees' run and
its staging out; inside the run of tree 0 (its team's lane 0), between the
phases of the iteration (the residuals, the factor, then per direction its
right-hand side, its sweep and its step rule; the carry update) or of the
profile's phase kernels 0 and 1. Builds the copy with nvcc, launches it on
``chip_smoke.py``'s f32 inputs (the QP overtake, IPM-8 with 2 Gondzio
correctors, first iteration) at B=1 (the tree alone on the card) and B=32768
(8 trees a block, one block an SM), the full iteration and phase kernels 0
and 1, and prints one JSON line each: the launch's ms (CUDA events) and the
SM cycles of every phase. The marks cost a few percent of a phase; compare
phases within one build.
"""

import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MARK = "if (bp_rec) { bp_dbg[bp_dbg_n++] = clock64(); }"
# (anchor, label): a mark goes after the anchor (each found once)
RUN = [("      residuals<false>();\n", "residuals"), ("      factor();\n", "factor"),
       ("        sweep(SL::Rdx, SL::Rdu, true, R);\n", "sweep"),
       ("    residuals<true>();\n", "residuals"), ("    factor();\n    const Rec", "factor"),
       ("    rhs<0>(R0, R0, T(0), T(0), T(0), T(0), T(0));\n", "rhs_pred"),
       ("    sweep(SL::Qe, SL::Qu, true, R0);\n", "sweep_pred"),
       ("    const Step<T> sa = step_of<false>(R0, true, R0);\n", "step_pred"),
       ("    rhs<1>(R0, R1, sigma * gap, T(0), T(0), T(0), T(0));\n", "rhs_corr"),
       ("    sweep(SL::Qe, SL::Qu, true, R1);\n", "sweep_corr"),
       ("    Step<T> cur = step_of<false>(R1, false, R1);\n", "step_corr"),
       ("      rhs<2>(Rc, Rd, T(0), ab, P.bmin * mu_t, hi, T(10) * hi);\n", "rhs_gondzio"),
       ("      sweep(SL::Qe, SL::Qu, false, Rd);\n", "sweep_gondzio"),
       ("      const Step<T> sc = step_of<true>(Rd, false, Rc);\n", "step_gondzio"),
       ("    update(ic ? R1 : R0, a);\n", "update")]
STAGE_IN = "    stage_in<T, NX, NU, NC, NF, PHASE>(P, Sblk, Fblk, permu, permx, base, nv, nT);\n"
RAN = "      team.template run<PHASE>(base + w);\n    }\n    __syncthreads();\n"
OUT = "      stage_out<T, NX, NU, NC, NF>(P, Sblk, permu, permx, base, nv, nT);\n      __syncthreads();\n"


def instrument(src: str) -> str:
    """The kernel source with the phase marks (asserts that every anchor is
    found once, so a changed source fails here, not silently)."""
    src = src.replace("namespace {\n", "namespace {\n__device__ long long bp_dbg[64];\n"
                      "__device__ int bp_dbg_n;\n", 1)
    run = "  __device__ __forceinline__ void run(long long t) {\n"
    assert src.count(run) == 1, run
    src = src.replace(run, run + "    const bool bp_rec = t == 0 && lane == 0;\n")
    for anchor, _ in RUN:
        assert src.count(anchor) == 1, anchor
        head, sep, tail = anchor.partition("\n")
        src = src.replace(anchor, head + " " + MARK + sep + tail)
    loop = "    const int nv = P.B - base < nT ? (int)(P.B - base) : nT;\n"
    for anchor in (loop, STAGE_IN, RAN, OUT):
        assert src.count(anchor) == 1, anchor
    src = src.replace(loop, loop + "    const bool bp_rec = base == 0 && threadIdx.x == 0;\n"
                      "    if (bp_rec) bp_dbg_n = 0;\n    " + MARK + "\n")
    src = src.replace(STAGE_IN, STAGE_IN + "    __syncthreads();\n    " + MARK + "\n")
    src = src.replace(RAN, RAN + "    " + MARK + "\n")
    src = src.replace(OUT, OUT + "      " + MARK + "\n")
    return src + ('\nextern "C" int bp_dbg_read(long long* out) {\n  int n;\n'
                  '  cudaMemcpyFromSymbol(&n, bp_dbg_n, sizeof(int));\n'
                  '  cudaMemcpyFromSymbol(out, bp_dbg, 64 * sizeof(long long));\n  return n;\n}\n')


def labels(phase, gondzio):
    """The marks' labels of one launch, in order."""
    inner = [lab for a, lab in RUN[:2]] + (["sweep"] if phase == 1 else []) + ["t0"] \
        if phase < 2 else [lab for _, lab in RUN[3:11]] \
        + [lab for _, lab in RUN[11:14]] * gondzio + ["update"]
    return ["stage_in"] + inner + ["run_end"] + (["stage_out"] if phase == 2 else [])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from belief_planning_tpu_torch.solvers import tree_qp_pl
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig
    from belief_planning_tpu_torch.utils.nvcc import BUILD_DIR

    src = instrument(tree_qp_pl.KERNEL_SOURCE.read_text())
    # phase kernels 0 / 1 end their run with the t0 sum; mark it
    t0 = "      if (lane == 0) P.gap[t] = T(t0);\n"
    assert src.count(t0) == 1
    src = src.replace(t0, "      " + MARK + "\n" + t0)
    out = BUILD_DIR / "phases" / "tree_qp_ipm_iter.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    kernel = tree_qp_pl.FusedIterationKernel(out)
    lib = kernel.load()
    lib.bp_dbg_read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}
    dev = torch.device("cuda", 0)
    cfg = QPIPMConfig(iters=8, gondzio=2)
    for B in (1, cs.BENCH_B):
        plan, _, su = cs.qp_case(dev, B, torch.float32, cfg)
        ints = tree_qp_pl.kernel_ints(plan, cfg, 4, 4)
        mtot = float(plan.topo.totalu * 14)
        kplan = kernel.plan(ints, B, torch.float32, dev.index)
        scratch = torch.empty(kplan["scratch_elems"], dtype=torch.float32, device=dev)
        for phase in (2, 0, 1):
            dbl = tree_qp_pl.kernel_scalars(cfg, mtot, torch.float32)
            if phase == 2:
                run = lambda: kernel.launch(ints, dbl, su.const_args, su.carry0, scratch)
            else:
                dbl[2] = tree_qp_pl.phase_w_max(cfg)
                run = lambda: kernel.launch_phase(phase, ints, dbl, su.const_args, su.carry0,
                                                  scratch)
            ms = cs.cuda_ms(run, 3)
            buf = (ctypes.c_longlong * 64)()
            n = lib.bp_dbg_read(buf)
            labs = labels(phase, cfg.gondzio)
            if n != len(labs) + 1:
                raise RuntimeError(f"{n} marks, expected {len(labs) + 1}")
            v = list(buf)[:n]
            cyc = {}
            for i, lab in enumerate(labs):
                cyc[lab] = cyc.get(lab, 0) + v[i + 1] - v[i]
            print(json.dumps({"phase": "qp_kernel_phases", "k1_phase": phase, "B": B,
                              "dtype": "float32", "ms": ms, "plan": kplan,
                              "cycles_total": v[-1] - v[0], "cycles": cyc, **card}), flush=True)
        del su, scratch
        torch.cuda.empty_cache()
    print(card["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
