"""The CVaR slice of the PyTorch port against the JAX reference, on the CPU,
at the two configurations ``chip_smoke.py`` drives: the merge deployment
(N=40, NB=1, m=2, per-lane ramp S and bx, worlds drawn as the reference's
``init_worlds`` from numpy seed 0) and the CVaR overtake (N=8, NB=2, m=3,
``bench_cvar.py``'s states), IPM-24 with 2 Gondzio correctors, two
warm-started receding-horizon steps on the same states, in f32 and in f64.

Prints one JSON line per configuration and dtype: the reference's own gap
distribution (p50, p90, max) at each step, the port's on the CPU, max
|Δu0| and |Δu|, and the number of lanes whose u differs by more than 1e-7. The reference's f32 gap p50 is the yardstick for the port's f32
gap p50 on the card.

    JAX_PLATFORMS=cpu python scripts/torch_port_parity_cvar.py [B] [config ...]
"""

import json
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from belief_planning_tpu.controllers.cvar_mpc import make_cvar_mpc_batched_step as j_make  # noqa: E402
from belief_planning_tpu.models.policies import highway_policy_set as j_highway_set  # noqa: E402
from belief_planning_tpu.models.policies import merge_policy_set as j_merge_set  # noqa: E402
from belief_planning_tpu.models.predictive import highway_model as j_highway_model  # noqa: E402
from belief_planning_tpu.models.predictive import merge_model as j_merge_model  # noqa: E402
from belief_planning_tpu.presets import init_branch_mpc as j_init_params  # noqa: E402
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig  # noqa: E402
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants  # noqa: E402
from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step  # noqa: E402
from belief_planning_tpu_torch.convert import convert, convert_cvar_ipm_config  # noqa: E402
from belief_planning_tpu_torch.models import policies as tpol  # noqa: E402
from belief_planning_tpu_torch.models.predictive import highway_model, merge_model  # noqa: E402
from chip_smoke import cvar_states  # noqa: E402


def _jax_config(name):
    if name == "cvar_merge":
        cons = JBranchConstants(am=7.0)
        pset = j_merge_set(cons, 20.0, None)
        model = j_merge_model(cons, pset, N=40, dt=0.1)
        params = j_init_params(4, 2, 40, 1, np.array([0.5, 1.8, 15.0, 0.0]), am=7.0, rm=0.3,
                               N_lane=2, W=cons.W)
        return cons, pset, model, params, 0.1
    cons = JBranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                            J_c=20, s_c=1, ylb=0., yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = j_highway_set(cons, xt)
    model = j_highway_model(cons, pset, N=8, dt=0.1)
    params = j_init_params(4, 2, 8, 2, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    return cons, pset, model, params, 0.9


def _pct(g):
    g = np.asarray(g, np.float64)
    return {"p50": float(np.median(g)), "p90": float(np.percentile(g, 90)),
            "max": float(g.max())}


def main(B=256, names=("cvar_merge", "cvar_overtake"), steps=2):
    for name in names:
        cons, pset, model, params, ralpha = _jax_config(name)
        use_S = name == "cvar_merge"
        jcfg = JCVaRIPMConfig(iters=24, gondzio=2)
        tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
        fns = (tpol.maintain_track_v, tpol.brake) if use_S else \
            (tpol.maintain, tpol.brake, tpol.lane_change)
        tmodel = (merge_model if use_S else highway_model)(
            tcons, tpol.PolicySet(fns=fns, params=tpp), N=params.N, dt=0.1)
        for dtype in (torch.float32, torch.float64):
            jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
            xs, zs, xRefs, S, bx = cvar_states(name, B, torch.device("cpu"), dtype)
            kw = {} if S is None else dict(S=S, bx=bx)
            jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
            _, _, jinit, jstep = j_make(model, params, ralpha, ipm=jcfg, use_pallas=False,
                                        use_S=use_S)
            jstep = jax.jit(jstep)
            _, _, tinit, tstep = make_cvar_mpc_batched_step(
                tmodel, tparams, ralpha, ipm=convert_cvar_ipm_config(jcfg), use_S=use_S,
                device="cpu")
            jc = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jinit(jdt))
            tc = tinit(B, dtype)
            line = {"config": name, "dtype": str(dtype)[6:], "B": B, "steps": []}
            for k in range(steps):
                jc, jr = jstep(jc, jnp.asarray(xs.numpy()), jnp.asarray(zs.numpy()),
                               jnp.asarray(xRefs.numpy()), pset.params, **jkw)
                tc, tr = tstep(tc, xs, zs, xRefs, tpp, **kw)
                du = np.abs(np.asarray(jr.uPred) - tr.uPred.numpy())
                line["steps"].append({
                    "step": k + 1, "jax_gap": _pct(jr.gap), "port_cpu_gap": _pct(tr.gap.numpy()),
                    "max_abs_du0": float(np.abs(np.asarray(jr.uPred)[:, 0]
                                                - tr.uPred.numpy()[:, 0]).max()),
                    "max_abs_du": float(du.max()),
                    "lanes_du_over_1e-7": int((du.reshape(B, -1).max(1) > 1e-7).sum())})
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    args = sys.argv[1:]
    main(int(args[0]) if args else 256, tuple(args[1:]) or ("cvar_merge", "cvar_overtake"))
