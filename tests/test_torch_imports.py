"""The port stands alone: no file of ``belief_planning_tpu_torch`` (nor
``chip_smoke.py`` or the card's profile script) imports ``jax``, ``jaxlib``
or ``belief_planning_tpu``; importing the package loads no jax; and its entry
points run on CUDA unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "belief_planning_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "belief_planning_tpu"}

torch.set_num_threads(1)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "scripts" / "torch_port_profile_ipm_kernel.py",
                                        ROOT / "scripts" / "torch_port_mxu_probe.py",
                                        ROOT / "scripts" / "torch_port_cvar_kernel_ab.py",
                                        ROOT / "scripts" / "torch_port_cvar_kernel_phases.py",
                                        ROOT / "scripts" / "torch_port_cvar_f32_diag.py",
                                        ROOT / "scripts" / "torch_port_f32_parity_episode.py",
                                        ROOT / "scripts" / "torch_port_cvar_parity_episode.py",
                                        ROOT / "scripts" / "torch_port_plain_products.py",
                                        ROOT / "scripts" / "torch_port_cvar_option_spread.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_hard_oracle_script_imports_only_the_oracle():
    """The one script that takes the reference's f64 oracle imports nothing
    else of the JAX package (the oracle is NumPy and SciPy only)."""
    path = ROOT / "scripts" / "torch_port_cvar_hard_oracle.py"
    mods = {n.module for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.ImportFrom) and n.module}
    assert not (_imported_roots(path) & {"jax", "jaxlib"})
    assert {m for m in mods if m.split(".")[0] == "belief_planning_tpu"} == {
        "belief_planning_tpu.oracle.reference_cvar", "belief_planning_tpu.oracle.reference_tree"}


def test_import_loads_no_jax():
    mods = sorted("belief_planning_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
                  for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'belief_planning_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def _factory_args():
    from belief_planning_tpu_torch.models.policies import highway_policy_set
    from belief_planning_tpu_torch.models.predictive import highway_model
    from belief_planning_tpu_torch.presets import init_branch_mpc
    from belief_planning_tpu_torch.utils.config import BranchConstants

    cons = BranchConstants()
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    model = highway_model(cons, highway_policy_set(cons, xRef), N=3, dt=0.1)
    return model, init_branch_mpc(4, 2, 3, 1, xRef, am=6.0, rm=0.3, N_lane=4, W=cons.W)


def test_entry_point_defaults_to_cuda():
    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step

    model, params = _factory_args()
    if torch.cuda.is_available():
        _, init, _ = make_branch_mpc_batched_step(model, params)
        assert init(2).u_lin.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_branch_mpc_batched_step(model, params)
    _, init, _ = make_branch_mpc_batched_step(model, params, device="cpu")
    assert init(2).u_lin.device.type == "cpu"


def test_cvar_entry_point_defaults_to_cuda():
    from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step
    from belief_planning_tpu_torch.models.policies import merge_policy_set
    from belief_planning_tpu_torch.models.predictive import merge_model
    from belief_planning_tpu_torch.presets import init_branch_mpc
    from belief_planning_tpu_torch.utils.config import BranchConstants

    cons = BranchConstants(am=7.0)
    model = merge_model(cons, merge_policy_set(cons, 20.0, None), N=3, dt=0.1)
    params = init_branch_mpc(4, 2, 3, 1, np.array([0.5, 1.8, 15.0, 0.0]), am=7.0, rm=0.3,
                             N_lane=2, W=cons.W)
    if torch.cuda.is_available():
        _, _, init, _ = make_cvar_mpc_batched_step(model, params, 0.1, use_S=True)
        assert init(2).u_lin.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_cvar_mpc_batched_step(model, params, 0.1, use_S=True)
    _, _, init, _ = make_cvar_mpc_batched_step(model, params, 0.1, use_S=True, device="cpu")
    assert init(2).u_lin.device.type == "cpu"


def test_cvar_solve_defaults_to_cuda():
    from belief_planning_tpu_torch.models.policies import cast_params, highway_policy_set
    from belief_planning_tpu_torch.models.predictive import highway_model
    from belief_planning_tpu_torch.presets import init_branch_mpc
    from belief_planning_tpu_torch.solvers.cvar import CVaRConfig, build_cvar_plan, cvar_solve
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology
    from belief_planning_tpu_torch.utils.config import BranchConstants

    cons = BranchConstants()
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xRef)
    model = highway_model(cons, pset, N=3, dt=0.1)
    params = init_branch_mpc(4, 2, 3, 1, xRef, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    topo = build_topology(3, 1, model.m, 4, 2)
    x = torch.tensor([[0.0, 1.8, 20.0, 0.0]], dtype=torch.float64)
    z = torch.tensor([[9.0, 1.8, 17.0, 0.0]], dtype=torch.float64)
    ts = build_tree(model, topo, x, z, torch.zeros(1, topo.totalu, 2, dtype=torch.float64),
                    cast_params(pset.params, torch.float64, "cpu"))
    args = (build_cvar_plan(topo), ts, params.Q, params.R, params.Qslack, params.xRef, 0.9,
            params.Fx, params.bx, params.Fu, params.bu, x)
    cfg = CVaRConfig(iters=1)
    if torch.cuda.is_available():
        assert cvar_solve(*args, cfg=cfg)[1].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            cvar_solve(*args, cfg=cfg)
    assert cvar_solve(*args, cfg=cfg, device="cpu")[1].device.type == "cpu"


def test_per_tree_steps_default_to_cuda():
    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_step
    from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_step

    model, params = _factory_args()
    for make, extra in ((make_branch_mpc_step, ()), (make_cvar_mpc_step, (0.9,))):
        if torch.cuda.is_available():
            assert make(model, params, *extra)[-2](2).u_lin.is_cuda
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make(model, params, *extra)
        assert make(model, params, *extra, device="cpu")[-2](2).u_lin.device.type == "cpu"


def test_ipm_solvers_default_to_cuda():
    from belief_planning_tpu_torch.models.policies import cast_params, highway_policy_set
    from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve
    from belief_planning_tpu_torch.solvers.tree_qp import assemble_stage_cost, build_stage_plan
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig, qp_ipm_solve
    from belief_planning_tpu_torch.tree.engine import build_tree
    from belief_planning_tpu_torch.tree.topology import build_topology
    from belief_planning_tpu_torch.utils.config import BranchConstants

    model, params = _factory_args()
    topo = build_topology(3, 1, model.m, 4, 2)
    f64 = torch.float64
    x = torch.tensor([[0.0, 1.8, 20.0, 0.0]], dtype=f64)
    z = torch.tensor([[9.0, 1.8, 17.0, 0.0]], dtype=f64)
    pset = highway_policy_set(BranchConstants(), np.array([0.5, 1.8, 15.0, 0.0]))
    ts = build_tree(model, topo, x, z, torch.zeros(1, topo.totalu, 2, dtype=f64),
                    cast_params(pset.params, f64, "cpu"))
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR, params.Qslack,
                               x, torch.zeros(1, 2, dtype=f64))
    p = params
    calls = [
        lambda **kw: qp_ipm_solve(build_stage_plan(topo), cost, ts, p.Fx, p.bx, p.Fu, p.bu, x,
                                  torch.zeros(1, 2, dtype=f64), QPIPMConfig(iters=1), **kw)[1],
        lambda **kw: cvar_ipm_solve(build_cvar_plan(topo), ts, p.Q, p.R, p.Qslack, p.xRef, 0.9,
                                    p.Fx, p.bx, p.Fu, p.bu, x, cfg=CVaRIPMConfig(iters=1),
                                    **kw)[1],
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
        assert call(device="cpu").device.type == "cpu"


def _hmm_args():
    from belief_planning_tpu_torch.models import policies as pol
    from belief_planning_tpu_torch.models.hmm import HMMPredictiveModel
    from belief_planning_tpu_torch.presets import init_mpc_params
    from belief_planning_tpu_torch.utils.config import HMMConstants

    cons = HMMConstants()
    model = HMMPredictiveModel(nx=4, d=2, M=1, m=2, dt=0.1, cons=cons,
                               policy_fns=(pol.maintain, pol.brake),
                               policy_params=(pol.MaintainParams(Kpsi=0.1),
                                              pol.brake_params_sim(0.1)))
    return model, init_mpc_params(4, 2, 4, 1, 2, ydes=1.8, vdes=15.0, am=6.0, rm=0.3,
                                  N_lane=6, W=2.4)


def _slice10_factories():
    from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx, make_branch_mpc_step
    from belief_planning_tpu_torch.controllers.hmm_mpc import (
        HMMMPC,
        make_hmm_mpc_batched_step,
        make_hmm_mpc_step,
    )
    from belief_planning_tpu_torch.controllers.robust_mpc import RobustMPC, make_robust_mpc_step
    from belief_planning_tpu_torch.entry import entry
    from belief_planning_tpu_torch.models.policies import highway_policy_set
    from belief_planning_tpu_torch.utils.config import BranchConstants

    pp = highway_policy_set(BranchConstants(), np.array([0.5, 1.8, 15.0, 0.0])).params
    return {
        "admm_step": lambda **kw: make_branch_mpc_step(*_factory_args(), solver="admm", **kw)[1](1),
        "BranchMPCProx_admm": lambda **kw: BranchMPCProx(*_factory_args()[::-1], pp,
                                                         solver="admm", **kw).carry,
        "robust_step": lambda **kw: make_robust_mpc_step(*_factory_args(), **kw)[1](1),
        "RobustMPC": lambda **kw: RobustMPC(*_factory_args()[::-1], pp, **kw).carry,
        "hmm_step": lambda **kw: make_hmm_mpc_step(*_hmm_args(), **kw)[1](1),
        "hmm_batched_step": lambda **kw: make_hmm_mpc_batched_step(*_hmm_args(), **kw)[1](1),
        "HMMMPC": lambda **kw: HMMMPC(*_hmm_args()[::-1], **kw).carry,
        "entry": lambda **kw: entry(**kw)[1][1],
    }


@pytest.mark.parametrize("name", ["admm_step", "BranchMPCProx_admm", "robust_step", "RobustMPC",
                                  "hmm_step", "hmm_batched_step", "HMMMPC", "entry"])
def test_slice10_entry_points_default_to_cuda(name):
    """The ADMM step, the robust and HMM controllers and ``entry()``: CUDA
    unless the caller passes ``device="cpu"``."""
    make = _slice10_factories()[name]
    first = lambda out: out if torch.is_tensor(out) else out[0]
    if torch.cuda.is_available():
        assert first(make()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert first(make(device="cpu")).device.type == "cpu"


def _slice11_calls():
    from belief_planning_tpu_torch.controllers.branch_mpc import MPCCarry
    from belief_planning_tpu_torch.entry import dryrun_multichip
    from belief_planning_tpu_torch.examples import main_branch, main_quadruped
    from belief_planning_tpu_torch.parallel.launch import launch
    from belief_planning_tpu_torch.utils.checkpoint import load_carry

    carry = MPCCarry(u_lin=torch.zeros(1, 2), p=torch.zeros(1, 1), old_input=torch.zeros(1, 2),
                     initialized=torch.zeros(1, dtype=torch.bool))
    return {
        "launch": lambda: launch(print, 2),
        "dryrun_multichip": lambda: dryrun_multichip(2),
        "load_carry": lambda: load_carry("unused.npz", carry),
        "sim_overtake": lambda: main_branch.sim_overtake(T=0.1),
        "sim_merge": lambda: main_branch.sim_merge(T=0.1),
        "quadruped_main": lambda: main_quadruped.main(T=0.2),
    }


@pytest.mark.parametrize("name", ["launch", "dryrun_multichip", "load_carry", "sim_overtake",
                                  "sim_merge", "quadruped_main"])
def test_slice11_entry_points_default_to_cuda(name):
    """The launcher (rank r on ``cuda:r``), ``dryrun_multichip``,
    ``load_carry`` and the examples run on CUDA unless the caller passes a
    device: without one they raise before any work (the card's side is
    ``chip_smoke.py``'s)."""
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only machine's refusal; the card runs these in chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        _slice11_calls()[name]()
