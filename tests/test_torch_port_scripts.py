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
  ``f32``), finite and, on the CPU, with no kernel launches counted.

The scripts import no JAX; neither does this file."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def run_script(name, monkeypatch, capsys, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
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
