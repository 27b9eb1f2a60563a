"""K2 (``csrc/cvar_ipm_iter.cu``) against other builds of itself, on one
CUDA card, timed in turns.

    python scripts/torch_port_cvar_kernel_ab.py OTHER [OTHER ...]

Each OTHER is either a kernel source with the same C interface (the launch
plan query ``bp_cvar_iter_plan``), for example an earlier commit's, unpacked
with ``git archive <commit> belief_planning_tpu_torch/csrc/cvar_ipm_iter.cu``
into the git-ignored ``belief_planning_tpu_torch/_build/``; or the name of
one of ``VARIANTS``, the current source with a few constants changed,
written into ``_build/ab/<name>.cu``. Every source is built with nvcc (in
parallel). At three shapes, the inputs of ``chip_smoke.py``'s
``cvar_kernel_time`` (f32, cold start, first iteration): the merge
deployment and the CVaR overtake at B=32768, and the merge at B=256, each
build's launch (``FusedCVaRIterationKernel.launch``) is timed with CUDA
events in turns: the current source, the others, the others in reverse, the
current again (each a warm-up and then ``reps`` launches). Each other
build's outputs are compared with the current one's (max |other - current|
/ max |current| over the fields). Prints one JSON line for the builds (nvcc
seconds, ptxas lines), one a shape and other build (both launch plans, ms
in both turns, speedup of the current build), then the card's name and
power limit.
"""

import json
import os
import sys
import threading
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from belief_planning_tpu_torch.solvers import cvar_pl  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from belief_planning_tpu_torch.utils.nvcc import BUILD_DIR  # noqa: E402

SHAPES = (("cvar_merge", 32768, 5), ("cvar_overtake", 32768, 5), ("cvar_merge", 256, 20))
TEAMS = "constexpr int kMaxTeams = 8;"
BOUNDS = "__launch_bounds__(kMaxThreads, 1)"
# the current source with these (text, replacement) edits
VARIANTS = {
    # at most 4 trees a block, registers as now (2 blocks of 4 an SM fit 255)
    "teams4": [(TEAMS, "constexpr int kMaxTeams = 4;"),
               (BOUNDS, "__launch_bounds__(kMaxThreads, 2)")],
    # at most 4 trees a block, registers capped for 3 blocks an SM
    "teams4_blocks3": [(TEAMS, "constexpr int kMaxTeams = 4;"),
                       (BOUNDS, "__launch_bounds__(kMaxThreads, 3)")],
    # at most 6 trees a block, registers capped for 2 blocks an SM
    "teams6_blocks2": [(TEAMS, "constexpr int kMaxTeams = 6;"),
                       (BOUNDS, "__launch_bounds__(kMaxThreads, 2)")],
}


def source_of(other: str) -> Path:
    """The source file of OTHER (a path, or a variant written out)."""
    if other not in VARIANTS:
        return Path(other)
    src = cvar_pl.KERNEL_SOURCE.read_text()
    for old, new in VARIANTS[other]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {other}: {old!r} not found once in the source")
        src = src.replace(old, new)
    out = BUILD_DIR / "ab" / f"{other}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def main(others) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}
    kernels = {"current": cvar_pl.FusedCVaRIterationKernel()}
    kernels.update({o: cvar_pl.FusedCVaRIterationKernel(source_of(o)) for o in others})
    threads = [threading.Thread(target=k.load) for k in kernels.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for tag, k in kernels.items():
        if k._lib is None:
            raise RuntimeError(f"the build of {tag} failed")
    print(json.dumps({"phase": "build", **{f"{t}_seconds": round(k.build_seconds, 3)
                                           for t, k in kernels.items()},
                      **{f"{t}_ptxas": [ln.strip() for ln in k.build_log.splitlines()
                                        if "registers" in ln or "stack frame" in ln]
                         for t, k in kernels.items()}, **card}), flush=True)
    cfg = CVaRIPMConfig(iters=24, gondzio=2)
    turns = ["current", *others, *reversed(others), "current"]
    for name, B, reps in SHAPES:
        cplan, su, _ = cs.cvar_case(name, dev, B, torch.float32, cfg)
        ints = cvar_pl.kernel_ints(cplan, cfg, su.dims)
        dbl = cvar_pl.kernel_scalars(cfg, su.dims, torch.float32, 0)
        plans, scratch = {}, {}
        for t, k in kernels.items():
            plans[t] = k.plan(ints, B, torch.float32, dev.index)
            scratch[t] = torch.empty(plans[t]["scratch_elems"], dtype=torch.float32, device=dev)

        def run(t):
            return kernels[t].launch(ints, dbl, su.in_args, su.carry0, scratch[t])

        ms = {t: [] for t in kernels}
        for t in turns:
            ms[t].append(cs.cuda_ms(lambda: run(t), reps))
        ref = run("current")
        for o in others:
            got = run(o)
            diff = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                       for a, b in zip(got, ref))
            print(json.dumps({"phase": "cvar_kernel_ab", "config": name, "B": B,
                              "dtype": "float32", "reps": reps, "other": o,
                              "plan_current": plans["current"], "plan_other": plans[o],
                              "current_ms": ms["current"], "other_ms": ms[o],
                              "speedup_of_current": sum(ms[o]) / sum(ms["current"]),
                              "max_scaled_diff": diff, **card}), flush=True)
        del su, scratch, ref
        torch.cuda.empty_cache()
    print(card["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
