"""The shared-row contraction probe on the card: the port's counterpart of
``scripts/mxu_probe.py``. Does a Hopper tensor core beat CUDA-core FMAs for
the IPM's shared-left-operand contraction ``Fx @ dx`` (``Fx (4, 4)`` shared
by every lane, ``dx`` lane-major, K = 4, N = 4)?

The kernel (``csrc/shared_rows_probe.cu``, wrapped by
``belief_planning_tpu_torch.ops.shared_rows``) chains ``inner`` products of
every node and lane in one launch, three ways: CUDA-core f32 FMAs (the
reference's VPU broadcast-sum), a one-pass bf16 ``mma.sync`` (its default
MXU dot) and three TF32 ``mma.sync`` passes (its HIGHEST MXU dot). Each mode
is launched once to warm up, then ``PROBE_REPS`` times in a row, timed with
CUDA events; the result is ms per launch. Inputs are drawn from numpy seed 0
as the reference draws them. Needs a CUDA card:

    python scripts/torch_port_mxu_probe.py

Env: PROBE_T (128, lanes a block), PROBE_NODES (25), PROBE_INNER (64),
PROBE_REPS (8), PROBE_B (4096).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks at its full 700 W power limit: HBM3 bandwidth,
# the f32 rate outside the tensor cores, and the dense tensor-core rates
H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fma": 67e12, "bf16": 989e12, "3xtf32": 495e12}


def probe_inputs(B, nodes, dev, seed=0):
    """``Fx (4, 4)`` and ``dx (nodes, 4, B)`` in f32, drawn as the reference draws them."""
    rng = np.random.default_rng(seed)
    Fx = torch.as_tensor(rng.normal(size=(4, 4)), dtype=torch.float32, device=dev)
    dx = torch.as_tensor(rng.normal(size=(nodes, 4, B)), dtype=torch.float32, device=dev)
    return Fx, dx


def useful_flops(B, nodes, inner):
    """The products' multiply-adds (2 each), as the reference counts them."""
    return 2.0 * nodes * 4 * 4 * B * inner


def bound(mode, B, nodes, inner):
    """``(ms, "bytes" | "operations")``: Fx and dx read once and out written
    once at the HBM rate, against the useful flops at the unit's dense peak;
    the larger. The useful flops are the same for every mode: the padding
    and the three passes of ``3xtf32`` are the formulation's cost, not work
    the function needs."""
    t_bytes = (16 + 2 * nodes * 4 * B) * 4 / H100_BYTES_PER_S * 1e3
    t_ops = useful_flops(B, nodes, inner) / PEAK_FLOPS[mode] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_mode(Fx, dx, inner, mode, reps, tile):
    """Milliseconds per launch over ``reps`` launches after one warm-up."""
    from belief_planning_tpu_torch.ops.shared_rows import shared_rows

    out = shared_rows(Fx, dx, inner, mode, tile)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        shared_rows(Fx, dx, inner, mode, tile)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, out


def probe(B=4096, nodes=25, inner=64, reps=8, tile=128, dev=None):
    """Time the three modes on seeded inputs; returns a dict per mode
    (``ms``, ``tflops``, ``bound_ms``, ``bound_by``, ``err_vs_fma``) and the
    reference's summary ``lines``."""
    dev = dev if dev is not None else torch.device("cuda", 0)
    Fx, dx = probe_inputs(B, nodes, dev)
    flops = useful_flops(B, nodes, inner)
    res, outs = {}, {}
    for mode in ("fma", "bf16", "3xtf32"):
        ms, outs[mode] = time_mode(Fx, dx, inner, mode, reps, tile)
        b_ms, b_by = bound(mode, B, nodes, inner)
        res[mode] = {"ms": ms, "tflops": flops / ms / 1e9, "bound_ms": b_ms, "bound_by": b_by,
                     "share_of_bound": b_ms / ms,
                     "err_vs_fma": (outs[mode] - outs["fma"]).abs().max().item()}
    t_fma, t_hi = res["fma"]["ms"], res["3xtf32"]["ms"]
    lines = [
        f"shapes: Fx(4,4) @ dx(4,{tile}) x {nodes} nodes x {inner} inner x "
        f"{-(-B // tile)} tiles",
        f"CUDA-core FMA:            {t_fma:8.3f} ms  ({res['fma']['tflops']:.3f} TFLOP/s)  "
        f"[exact f32]",
        f"tensor core bf16 mma:     {res['bf16']['ms']:8.3f} ms  err vs FMA "
        f"{res['bf16']['err_vs_fma']:.2e}  <- solver-fatal precision",
        f"tensor core 3xTF32 mma:   {t_hi:8.3f} ms  err vs FMA "
        f"{res['3xtf32']['err_vs_fma']:.2e}",
        f"=> f32-grade tensor core is {t_fma / t_hi:.2f}x the FMA formulation "
        f"({'WINS' if t_hi < t_fma * 0.97 else 'no win'})",
    ]
    return {"B": B, "nodes": nodes, "inner": inner, "reps": reps, "tile": tile,
            "useful_flops": flops, "modes": res, "lines": lines}


def main():
    if not torch.cuda.is_available():
        print("torch_port_mxu_probe: needs a CUDA card", file=sys.stderr)
        return 2
    env = lambda k, v: int(os.environ.get(k, v))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = probe(B=env("PROBE_B", "4096"), nodes=env("PROBE_NODES", "25"),
                inner=env("PROBE_INNER", "64"), reps=env("PROBE_REPS", "8"),
                tile=env("PROBE_T", "128"))
    for line in out["lines"]:
        print(line, flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "lines"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
