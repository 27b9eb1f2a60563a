"""K2 (``csrc/cvar_ipm_iter.cu``) or K1 (``csrc/tree_qp_ipm_iter.cu``, with
its profile phases) against other builds of itself, on one CUDA card, timed
in turns.

    python scripts/torch_port_cvar_kernel_ab.py [--kernel cvar|qp] OTHER [OTHER ...]

Each OTHER is either a kernel source with the same C interface, for example
an earlier commit's, unpacked with ``git archive <commit>
belief_planning_tpu_torch/csrc/<source>`` into the git-ignored
``belief_planning_tpu_torch/_build/``; or the name of one of ``VARIANTS``
(K2) / ``QP_VARIANTS`` (K1), the current source with a few constants
changed, written into ``_build/ab/<name>.cu``. A K2 source must have the
launch plan query ``bp_cvar_iter_plan``; a K1 source may have its launch
plan query ``bp_tree_qp_iter_plan`` or, as before it, the scratch query
``bp_tree_qp_iter_scratch`` (elements a tree). Every source is built with
nvcc (in parallel). Each build's launch is timed with CUDA events in turns:
the current source, the others, the others in reverse, the current again
(each a warm-up and then ``reps`` launches), at these shapes. K2 (the
default): the inputs of ``chip_smoke.py``'s ``cvar_kernel_time`` (f32, cold
start, first iteration): the merge deployment and the CVaR overtake at
B=32768, and the merge at B=256. K1: the inputs of ``kernel_time`` (the QP
overtake, f32, IPM-8 with 2 Gondzio correctors, cold start) at B=32768 and
B=256, then the profile's phase kernels 0 and 1 on
``scripts/torch_port_profile_ipm_kernel.py``'s inputs at B=2048 and
B=32768. Each other build's outputs are compared with the current one's
(max |other - current| / max |current| over the fields). Prints one JSON
line for the builds (nvcc seconds, ptxas lines), one a shape and other build
(both launch plans, ms in both turns, speedup of the current build), then
the card's name and power limit.
"""

import ctypes
import json
import os
import sys
import threading
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from belief_planning_tpu_torch.solvers import cvar_pl, tree_qp_pl  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig  # noqa: E402
from belief_planning_tpu_torch.utils.nvcc import BUILD_DIR, build_shared_library  # noqa: E402

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


QP_TEAM = "constexpr int kTeam = 32;"
QP_VARIANTS = {
    # a team of 16 lanes, two trees a warp
    "team16": [(QP_TEAM, "constexpr int kTeam = 16;")],
}
QP_SHAPES = ((32768, 5), (256, 20))
QP_PHASE_SHAPES = ((2048, 12), (32768, 12))


def source_of(other: str, kernel: str = "cvar") -> Path:
    """The source file of OTHER (a path, or a variant written out)."""
    variants = VARIANTS if kernel == "cvar" else QP_VARIANTS
    if other not in variants:
        return Path(other)
    base = cvar_pl.KERNEL_SOURCE if kernel == "cvar" else tree_qp_pl.KERNEL_SOURCE
    src = base.read_text()
    for old, new in variants[other]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {other}: {old!r} not found once in the source")
        src = src.replace(old, new)
    out = BUILD_DIR / "ab" / f"{other}{'' if kernel == 'cvar' else '_qp'}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


class QPBuild:
    """A build of a K1 source: its launch plan (or, for a source before the
    plan query, its scratch elements a tree) and its launches."""

    def __init__(self, source: Path):
        self.source = Path(source)
        self.build_log, self.build_seconds, self._lib = "", 0.0, None

    def load(self):
        path, self.build_log, self.build_seconds = build_shared_library(self.source)
        lib = ctypes.CDLL(str(path))
        if hasattr(lib, "bp_tree_qp_iter_plan"):
            tree_qp_pl.bind_kernel_library(lib)
        else:
            for name in ("bp_tree_qp_iter_f32", "bp_tree_qp_iter_f64"):
                getattr(lib, name).argtypes = [
                    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p]
            for name in ("bp_tree_qp_phase_f32", "bp_tree_qp_phase_f64"):
                getattr(lib, name).argtypes = [
                    ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p]
            lib.bp_tree_qp_iter_scratch.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.bp_tree_qp_iter_scratch.restype = ctypes.c_longlong
        self._lib = lib

    def scratch(self, ints, B, dev):
        """(plan or scratch elements a tree, f32 scratch tensor) for B trees."""
        lib = self._lib
        if hasattr(lib, "bp_tree_qp_iter_plan"):
            plan = tree_qp_pl.kernel_plan(lib, ints, B, torch.float32, dev.index)
            return plan, torch.empty(plan["scratch_elems"], dtype=torch.float32, device=dev)
        elems = lib.bp_tree_qp_iter_scratch((ctypes.c_int * len(ints))(*ints))
        return {"scratch_elems_per_tree": elems}, torch.empty((elems, B), dtype=torch.float32,
                                                              device=dev)

    def launch(self, phase, ints, dbl, consts, carry, scratch):
        """The iteration (phase None: new carry and gap) or phase kernel 0 / 1 (t0)."""
        x_c = carry[0]
        gap = torch.empty((1, x_c.shape[-1]), dtype=x_c.dtype, device=x_c.device)
        if phase is None:
            outs = [torch.empty_like(c) for c in carry]
            ptrs = [t.data_ptr() for t in (*consts, *carry, *outs, gap, scratch)]
            fn, lead = self._lib.bp_tree_qp_iter_f32, ()
        else:
            outs = []
            ptrs = [t.data_ptr() for t in (*consts, *carry)] + [0] * len(carry) \
                + [gap.data_ptr(), scratch.data_ptr()]
            fn, lead = self._lib.bp_tree_qp_phase_f32, (ctypes.c_int(phase),)
        tree_qp_pl.FusedIterationKernel._call(fn, lead, "tree_qp A/B", ints, dbl, ptrs, x_c)
        return (*outs, gap)


def qp_main(others, dev, card) -> int:
    """K1 and its phase kernels: the current source against OTHERS, in turns."""
    builds = {"current": QPBuild(tree_qp_pl.KERNEL_SOURCE)}
    builds.update({o: QPBuild(source_of(o, "qp")) for o in others})
    threads = [threading.Thread(target=b.load) for b in builds.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for tag, b in builds.items():
        if b._lib is None:
            raise RuntimeError(f"the build of {tag} failed")
    print(json.dumps({"phase": "build", **{f"{t}_seconds": round(b.build_seconds, 3)
                                           for t, b in builds.items()},
                      **{f"{t}_ptxas": [ln.strip() for ln in b.build_log.splitlines()
                                        if "registers" in ln or "stack frame" in ln
                                        or "spill" in ln]
                         for t, b in builds.items()}, **card}), flush=True)
    turns = ["current", *others, *reversed(others), "current"]
    prof = cs.load_script("torch_port_profile_ipm_kernel")
    cases = [(None, B, reps) for B, reps in QP_SHAPES] + \
        [(ph, B, reps) for B, reps in QP_PHASE_SHAPES for ph in (0, 1)]
    for phase, B, reps in cases:
        if phase is None:
            cfg = QPIPMConfig(iters=8, gondzio=2)
            plan, _, su = cs.qp_case(dev, B, torch.float32, cfg)
            consts, carry, nFx, nFu = su.const_args, su.carry0, 4, 4
            mtot = float(plan.topo.totalu * (2 * (nFx + 1) + nFu))
            dbl = tree_qp_pl.kernel_scalars(cfg, mtot, torch.float32)
        else:
            cfg = QPIPMConfig(iters=12)
            plan, nFx, nFu, mtot, consts, carry = prof.prep_inputs(B, dev, cfg)
            dbl = tree_qp_pl.kernel_scalars(cfg, mtot, torch.float32)
            dbl[2] = tree_qp_pl.phase_w_max(cfg)
        ints = tree_qp_pl.kernel_ints(plan, cfg, nFx, nFu)
        plans, scratch = {}, {}
        for t, b in builds.items():
            plans[t], scratch[t] = b.scratch(ints, B, dev)

        def run(t):
            return builds[t].launch(phase, ints, dbl, consts, carry, scratch[t])

        ms = {t: [] for t in builds}
        for t in turns:
            ms[t].append(cs.cuda_ms(lambda: run(t), reps))
        ref = run("current")
        for o in others:
            got = run(o)
            diff = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                       for a, b in zip(got, ref))
            print(json.dumps({"phase": "qp_kernel_ab", "k1_phase": 2 if phase is None else phase,
                              "B": B, "dtype": "float32", "reps": reps, "other": o,
                              "plan_current": plans["current"], "plan_other": plans[o],
                              "current_ms": ms["current"], "other_ms": ms[o],
                              "speedup_of_current": sum(ms[o]) / sum(ms["current"]),
                              "max_scaled_diff": diff, **card}), flush=True)
        del consts, carry, scratch, ref
        torch.cuda.empty_cache()
    print(card["nvidia_smi"], flush=True)
    return 0


def main(others) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}
    if others and others[0] == "--kernel":
        kernel, others = others[1], others[2:]
        if kernel == "qp":
            return qp_main(others, dev, card)
        if kernel != "cvar":
            raise ValueError(f"--kernel {kernel}: expected cvar or qp")
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
