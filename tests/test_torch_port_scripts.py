"""CPU smoke runs of the port's diagnostic and parity scripts, each through
its ``main`` with ``--device cpu`` at a small size (N=3, NB=1 trees, B ≤ 4,
2 iterations or 2 closed-loop steps), checking the lines each prints:

- ``torch_port_cvar_f32_diag.py``: the refinement run's summary and its
  per-iteration rows, with the extended family diagnostics;
- ``torch_port_cvar_hard_oracle.py``: each lane's u0 error against the f64
  oracle and the error percentiles, with split steps and the neighbourhood
  search on;
- ``torch_port_f32_parity_episode.py`` and ``torch_port_cvar_parity_episode.py``:
  the JSON line, one mode against the f64 loop (the QP's parity-grade
  ``refine10``, within 1e-3 with states and warm starts forced; the CVaR's
  ``f32``), finite and, on the CPU, with no kernel launches counted;
- the four study scripts, ``torch_port_qp_iter_study.py`` (the iterations ×
  correctors table against the oracle), ``torch_port_cvar_iter_study.py``
  (the warm-started errors along the oracle's trajectory),
  ``torch_port_cvar_f32_study.py`` (the cold and warm gaps and their
  ``.npz``) and ``torch_port_cvar_f32_parity.py`` (the four modes' lines and
  the error table against the f64 reference);
- ``torch_port_cvar_overtake_gate_diag.py``: the gate's per-step series and
  its ``.npz``;
- ``torch_port_merge_gate.py``'s oracle retry rule (``solve_oracle``), on a
  stand-in oracle: a QCQP that ends ``optimal`` is kept, any other end is
  solved again from the oracle as it stood, at the retry budget.

The scripts import no JAX; neither does this file."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def load_script(name, monkeypatch):
    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(name, monkeypatch, capsys, env, args=()):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    load_script(name, monkeypatch).main([*args, "--device", "cpu"])
    return capsys.readouterr().out.splitlines()


def test_cvar_f32_diag(monkeypatch, capsys):
    out = run_script("torch_port_cvar_f32_diag", monkeypatch, capsys,
                     dict(CVAR_N="3", CVAR_NB="1", CVAR_B="4", CVAR_ITERS="2", CVAR_REFINES="1",
                          CVAR_FAMDIAG="1", CVAR_RESID="carried", CVAR_GONDZIO="2"))
    assert out[0].startswith("refine=1  final gap p50 ") and out[0].endswith("u finite True")
    assert out[1].startswith("  it  0  gap ") and " prim1 " in out[1] and " rq " in out[1]
    assert " a1s " in out[2] and " cmax " in out[2]
    assert "nfin p50 0" in out[3] and "finK 1" in out[3]


def test_cvar_hard_oracle(monkeypatch, capsys):
    out = run_script("torch_port_cvar_hard_oracle", monkeypatch, capsys,
                     dict(CVAR_N="3", CVAR_NB="1", CVAR_B="2", CVAR_ITERS="2", CVAR_SPLIT="1",
                          CVAR_NBR="0.3"))
    lanes = [ln for ln in out if ln.startswith("lane ")]
    assert len(lanes) == 2 and all("oracle[optimal" in ln for ln in lanes)
    assert "split=True nbr=0.3" in out[-2]
    p50, p90, mx = (float(v) for v in out[-1].split()[3::2])
    assert np.isfinite(mx) and 0.0 <= p50 <= p90 <= mx


@pytest.mark.parametrize("name, mode", [("torch_port_f32_parity_episode", "refine10"),
                                        ("torch_port_cvar_parity_episode", "f32")])
def test_parity_episode(monkeypatch, capsys, name, mode):
    out = run_script(name, monkeypatch, capsys,
                     dict(EP_N="3", EP_NB="1", EP_STEPS="2", EP_MODES=mode, EP_CONTROL="0"))
    res = json.loads(out[-1])
    assert res["device"] == "cpu" and res["steps"] == 2 and set(res) >= {mode, "f64_ref_p50_ms"}
    r = res[mode]
    for series in ("closed_loop", "teacher_forced", "teacher_forced_warm"):
        assert np.isfinite(r[series]["max_dev"]) and r[series]["p50_dev"] <= r[series]["max_dev"]
    if mode == "refine10":
        # on the f64 loop's states and warm starts the parity-grade mode
        # solves the same programs as the loop
        assert r["teacher_forced_warm"]["max_dev"] < 1e-3
    assert r["launches"] is None and np.isfinite(r["p50_ms"])


def test_qp_iter_study(monkeypatch, capsys):
    out = run_script("torch_port_qp_iter_study", monkeypatch, capsys,
                     dict(QP_N="3", QP_NB="1", QP_ITER_LIST="2,8", QP_GONDZIO_LIST="0,2"),
                     args=["2"])
    assert out[0] == "closed-loop overtake, 2 steps, N=3 NB=1; gate 1e-3"
    rows = [re.fullmatch(r"iters= +(\d+) gondzio=(\d)  max\|du\|=(\S+) (PASS|fail)", ln)
            for ln in out[1:]]
    assert all(rows) and [r.group(1, 2) for r in rows] == [("2", "0"), ("8", "0"), ("2", "2"),
                                                            ("8", "2")]
    errs = {r.group(1, 2): float(r.group(3)) for r in rows}
    assert all(np.isfinite(list(errs.values())))
    assert all((r.group(4) == "PASS") == (errs[r.group(1, 2)] < 1e-3) for r in rows)
    # the bench config passes the gate at this size; two iterations do not
    assert errs["8", "2"] < 1e-3 < errs["2", "0"]


def test_cvar_iter_study(monkeypatch, capsys):
    out = run_script("torch_port_cvar_iter_study", monkeypatch, capsys,
                     dict(CVAR_N="3", CVAR_NB="1", STEPS="2", CVAR_ITER_LIST="2,12",
                          CVAR_GONDZIO="2"))
    rows = [ln for ln in out if ln.startswith("iters ")]
    assert [r.split()[1] for r in rows] == ["2", "12"]
    for r in rows:
        errs = [float(v) for v in r.split("per-step err")[1].split("max")[0].split()]
        assert len(errs) == 2 and float(r.split()[-1]) == pytest.approx(max(errs), rel=1e-2)
    assert float(rows[1].split()[-1]) < float(rows[0].split()[-1])


def test_cvar_f32_study(monkeypatch, capsys, tmp_path):
    out_path = tmp_path / "study.npz"
    out = run_script("torch_port_cvar_f32_study", monkeypatch, capsys,
                     dict(CVAR_N="3", CVAR_NB="1", CVAR_B="4", CVAR_ITERS="2", CVAR_REFINE="0,1",
                          CVAR_OUT=str(out_path)))
    assert [ln.split()[0] for ln in out] == ["tag=cpu_f32_r0_i2", "gap", "gap", "wrote",
                                             "tag=cpu_f32_r1_i2", "gap", "gap", "wrote"]
    for r in (0, 1):
        with np.load(tmp_path / f"study_cpu_f32_r{r}_i2.npz") as z:
            assert set(z.files) == {"u_cold", "gap_cold", "u_warm", "gap_warm"}
            assert z["u_cold"].shape == z["u_warm"].shape and z["u_cold"].shape[0] == 4
            assert np.isfinite(z["u_warm"]).all() and z["gap_cold"].shape == (4,)


def test_cvar_f32_parity(monkeypatch, capsys):
    out = run_script("torch_port_cvar_f32_parity", monkeypatch, capsys,
                     dict(CVAR_N="3", CVAR_NB="1", CVAR_B="4", CVAR_REPS="1", CVAR_REF_ITERS="2",
                          CVAR_SOLVE_ITERS="2", CVAR_REFINE="2", CVAR_REFINE2="2",
                          CVAR_TIGHT_GAP="1e9"))
    assert [ln.split("]")[0] for ln in out[:4]] == ["[ref", "[f32", "[refine2", "[refine2g4"]
    assert out[5].startswith("u0 error vs f64-2+g2 reference") and out[5].endswith(
        "cold 4/4, warm 4/4")
    for ln, tag in zip(out[6:], ("f32", "refine2", "refine2g4")):
        assert ln.split()[0] == tag and ln.count(" max ") == 2, ln


def test_cvar_overtake_gate_diag(monkeypatch, capsys, tmp_path):
    out_path = tmp_path / "diag.npz"
    out = run_script("torch_port_cvar_overtake_gate_diag", monkeypatch, capsys,
                     dict(CVAR_N="3", CVAR_NB="1", CVAR_DIAG_OUT=str(out_path)),
                     args=["2", "2", "2"])
    assert [ln.split("=")[0] for ln in out[:2]] == ["t", "t"] and "o[optimal" in out[0]
    assert out[-2].startswith("max err ") and out[-1] == f"wrote {out_path}"
    with np.load(out_path) as z:
        assert z["err"].shape == (2,) and z["xo"].shape == (2, 4)
        # the first step is cold: its forced twin is the free solve
        assert z["err_forced"][0] == z["err"][0] and np.isfinite(z["e_gap"]).all()


class _StandInOracle:
    """An oracle whose solves end with the given statuses in turn; it
    records each solve's budget."""

    def __init__(self, ends):
        self.ends, self.budgets = list(ends), []

    def solve(self, x, z, xRef=None, S=None, Fx=None, bx=None, tol=None, max_iter=None):
        self.budgets.append(max_iter)
        kind, status = self.ends.pop(0)
        self.solution = kind(status)
        return np.full(2, float(max_iter))


@pytest.mark.parametrize("first, retried", [(("qcqp", "optimal"), False),
                                            (("qcqp", "max_iter"), True),
                                            (("admm", "optimal"), True)])
def test_merge_gate_oracle_retry(monkeypatch, first, retried):
    from types import SimpleNamespace

    from belief_planning_tpu.oracle.qcqp import QCQPSolution

    mg = load_script("torch_port_merge_gate", monkeypatch)
    kinds = {"qcqp": lambda st: QCQPSolution(*[None] * 5, status=st, gap=0.0),
             "admm": lambda st: SimpleNamespace(status=st)}
    oracle = _StandInOracle([(kinds[first[0]], first[1]), (kinds["qcqp"], "optimal")])
    prog = dict(x=np.zeros(4), z=np.zeros(4), xRef=None, S=None, Fx=None, bx=None)
    solved, u, again = mg.solve_oracle(oracle, prog, 800, retry_iters=3000)
    assert again is retried
    # a retry solves from a copy taken before the first solve: its only solve is the retry's
    assert solved.budgets == ([3000] if retried else [800]) and u[0] == solved.budgets[-1]
    assert (solved is oracle) is not retried and oracle.budgets == [800]
