"""Where one K2 launch's time goes, phase by phase, on one CUDA card.

    python scripts/torch_port_cvar_kernel_phases.py

Copies ``csrc/cvar_ipm_iter.cu`` into the git-ignored
``belief_planning_tpu_torch/_build/phases/`` with ``clock64()`` marks added
between the phases of one tree's iteration (``Team::run``: the residuals, the
factor, the predictor's right-hand side, its multi-column H0 solve split
into backward sweep, forward sweep, slack and risk columns, the cone sums,
the capacitance, the Woodbury update and finish, the affine gap; then per
direction the right-hand side, the H0 solve in the same four parts, the cone
sums, the Woodbury update, finish and the Gondzio accept; and the
backtracking gaps). Each mark follows a ``__syncwarp`` and is taken by lane
0 of tree 0, so it times that tree's team. Builds the copy with nvcc,
launches it at both CVaR configurations on ``chip_smoke.py``'s f32 inputs
(first iteration) at B=1 (the team alone on the card) and B=32768 (8 teams
an SM), and prints one JSON line each: the launch's ms (CUDA events) and the
SM cycles of every phase. The marks cost a few percent of a phase; compare
phases within one build.
"""

import ctypes
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MARK = "__syncwarp(); if (rec) { bp_dbg[bp_dbg_n++] = clock64(); }"
AFTER = ["    residuals();", "    factor();",
         "    set_rhs(RcSpec{0, &Da, T(0), T(0), T(0), T(0), T(0)});",
         "    h0_solve(true, R, oz);", "    gdot_cones(oz, R, gd, R);", "    capacitance();",
         "    const Step<T> sa = finish(Da, false, wb_correct(Da, oz, K, gd + K, R));",
         "    const T sigma = pmin(pmax(ratio * ratio * ratio, T(0)), T(1));",
         "    set_rhs(rs);", "    h0_solve(false, 1, od);",
         "    gdot_cones(od, 1, dq, 1);\n    const bool fin", "    const bool fin = wb_correct(D, od, 0, dq, 1);",
         "      const Step<T> sn = direction(Dnew, rs);",
         "        const Step<T> sc = add_into(Dnew, Dcur);", "    gap_at(Dc, cand, g3);"]
BEFORE = ["    // forward rollout from a zero root state -> x, u columns\n",
          "    // slack columns: s = (w1 rows(x) - qs) / kap, and",
          "    // risk columns: -(top-left block of the risk saddle's inverse) q\n"]
H0 = lambda p: [p + ".bwd", p + ".fwd", p + ".slack", p + ".risk"]
LABELS = ["residuals", "factor", "rhs_pred"] + H0("h0_multi") + [
    "cone_sums_multi", "capacitance", "woodbury+finish_pred", "gap_aff"]
for g in range(3):
    LABELS += [f"d{g}.rhs"] + H0(f"d{g}.h0") + [f"d{g}.cone_sums", f"d{g}.woodbury",
                                                  f"d{g}.finish"] + ([f"d{g}.accept"] if g else [])
LABELS += ["backtrack_gaps"]


def instrument(src: str) -> str:
    """The kernel source with the phase marks (asserts that every anchor is
    found once, so a changed source fails here, not silently)."""
    src = src.replace("namespace {\n", "namespace {\n__device__ long long bp_dbg[96];\n"
                      "__device__ int bp_dbg_n;\n", 1)
    src = src.replace("  int U, K, nrisk, nsgn, bdim, m;\n",
                      "  int U, K, nrisk, nsgn, bdim, m;\n  bool rec = false;\n", 1)
    run = "  __device__ __forceinline__ void run(int t) {\n"
    assert src.count(run) == 1, run
    src = src.replace(run, run + "    rec = (t == 0 && lane == 0);\n    if (rec) bp_dbg_n = 0;\n    "
                      + MARK + "\n")
    for line in AFTER:
        # the mark goes after the anchor's first line (an anchor may carry the
        # next line's start to be unique)
        assert src.count(line) == 1, line
        head, sep, tail = line.partition("\n")
        src = src.replace(line, head + " " + MARK + sep + tail)
    for line in BEFORE:
        assert src.count(line) == 1, line
        src = src.replace(line, "    " + MARK + "\n" + line)
    return src + ('\nextern "C" int bp_dbg_read(long long* out) {\n  int n;\n'
                  '  cudaMemcpyFromSymbol(&n, bp_dbg_n, sizeof(int));\n'
                  '  cudaMemcpyFromSymbol(out, bp_dbg, 96 * sizeof(long long));\n  return n;\n}\n')


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from belief_planning_tpu_torch.solvers import cvar_pl
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
    from belief_planning_tpu_torch.utils.nvcc import BUILD_DIR

    out = BUILD_DIR / "phases" / "cvar_ipm_iter.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(instrument(cvar_pl.KERNEL_SOURCE.read_text()))
    kernel = cvar_pl.FusedCVaRIterationKernel(out)
    lib = kernel.load()
    lib.bp_dbg_read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}
    dev = torch.device("cuda", 0)
    cfg = CVaRIPMConfig(iters=24, gondzio=2)
    for name in cs.CVAR_CONFIGS:
        for B in (1, cs.BENCH_B):
            cplan, su, _ = cs.cvar_case(name, dev, B, torch.float32, cfg)
            ints = cvar_pl.kernel_ints(cplan, cfg, su.dims)
            dbl = cvar_pl.kernel_scalars(cfg, su.dims, torch.float32, 0)
            scratch = torch.empty(kernel.plan(ints, B, torch.float32, dev.index)["scratch_elems"],
                                  dtype=torch.float32, device=dev)
            ms = cs.cuda_ms(lambda: kernel.launch(ints, dbl, su.in_args, su.carry0, scratch), 3)
            buf = (ctypes.c_longlong * 96)()
            n = lib.bp_dbg_read(buf)
            if n != len(LABELS) + 1:
                raise RuntimeError(f"{n} marks, expected {len(LABELS) + 1}")
            v = list(buf)[:n]
            print(json.dumps({"phase": "cvar_kernel_phases", "config": name, "B": B,
                              "dtype": "float32", "ms": ms, "cycles_total": v[-1] - v[0],
                              "cycles": {lab: v[i + 1] - v[i] for i, lab in enumerate(LABELS)},
                              **card}), flush=True)
            del su, scratch
            torch.cuda.empty_cache()
    print(card["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
