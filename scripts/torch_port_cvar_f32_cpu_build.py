"""The CVaR kernel's f32 accuracy bar, rehearsed on the CPU.

Builds ``csrc/cvar_ipm_iter.cu`` with g++ (CUDA emulated with threads, as
``tests/test_torch_cvar_kernel_cpu_build.py`` does; FMA contraction allowed,
as nvcc does), runs one f32 iteration at both chip configurations at B lanes
from a cold start on an emulated card of SMS SMs (default 1; 132, an H100's,
gives B=256 the card's 2 trees a block), and prints per configuration and field the kernel's and
the plain f32 version's max error against the plain version in f64 on the
same upcast inputs, and the bar ``2 × plain + 1e-6 × magnitude`` that
``chip_smoke.py`` holds the kernel to on the card.

    python scripts/torch_port_cvar_f32_cpu_build.py [B] [kernel source] [SMS]
"""

import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from belief_planning_tpu_torch.solvers import cvar_pl  # noqa: E402
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig  # noqa: E402
from tests.test_torch_cvar_kernel_cpu_build import build_cpu_kernel, run_cpu_kernel  # noqa: E402


def main(B=4096, source=cvar_pl.KERNEL_SOURCE, sms=1):
    torch.set_num_threads(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as d:
        lib = build_cpu_kernel(Path(d), Path(source).read_text(),
                               ("-O2", "-ffp-contract=fast", "-march=native"))
        cfg = CVaRIPMConfig(iters=24, gondzio=2)
        names = cvar_pl.CARRY_ORDER + ["gap"]
        for name in cs.CVAR_CONFIGS:
            cplan, su, plain = cs.cvar_case(name, torch.device("cpu"), B, torch.float32, cfg)
            got = run_cpu_kernel(lib, cplan, cfg, su, 0, su.carry0, device=sms - 1)
            ref = plain(*su.in_args, 0, *su.carry0)
            ref64 = plain(*[t.double() for t in su.in_args], 0,
                          *[t.double() for t in su.carry0])
            fields = {}
            for nm, g, r, r64 in zip(names, got, ref, ref64):
                e_k = (g.double() - r64).abs().max().item()
                e_p = (r.double() - r64).abs().max().item()
                fields[nm] = {"kernel": e_k, "plain": e_p,
                              "bar": 2 * e_p + 1e-6 * r64.abs().max().item()}
            print(json.dumps({"config": name, "B": B, "worst_kernel_over_bar": max(
                v["kernel"] / v["bar"] for v in fields.values()), "fields": fields}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4096,
         sys.argv[2] if len(sys.argv) > 2 else cvar_pl.KERNEL_SOURCE,
         int(sys.argv[3]) if len(sys.argv) > 3 else 1)
