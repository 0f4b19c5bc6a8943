"""The port's validation runs (``pylamp_tpu_torch/models/validate_*.py``)
on the CPU:

- each module's configuration equals its JAX script's, field by field
  (the initial-condition callables compared on sample points).  The
  configurations are rebuilt here from ``pylamp_tpu.models.benchmarks``
  with each script's overrides: the scripts set ``jax.config`` and the
  compile cache when imported;
- Blankenbach 1a and van Keken at 16^2, f64: 5 steps of the module's
  ``Run`` against a loop of the JAX ``make_step`` on the same
  configuration from the same seeded state (every field and marker within
  1e-10 relative after each step), and the module's command line for the
  same 5 steps (its Nu / v_rms, or v_rms series, within 1e-10 of the
  reference's);
- a run whose Stokes solve does not converge, or whose step drops a
  marker, stops there, writes the summary of its steps and exits
  non-zero (``--allow-drops`` counts the drops instead); a run on the
  card without one exits non-zero.

The reference's runs are computed once per module (fixtures).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict

from pylamp_tpu.models import benchmarks as jb
from pylamp_tpu.models.config import SolverConfig as JSolverConfig
from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.step import make_step as jax_make_step
from pylamp_tpu_torch.bridge import state_to_numpy
from pylamp_tpu_torch.models import (
    validate_blankenbach,
    validate_blankenbach_2a,
    validate_fk_lid,
    validate_van_keken,
    validation,
)
from pylamp_tpu_torch.models.benchmarks import nusselt_top, vrms_box

N = 16
STEPS = 5


def _script_configs(nx):
    """The JAX scripts' configurations (scripts/validate_*.py), rebuilt."""
    bb = jb.blankenbach_case1a(nx=nx, ny=nx, max_steps=100000, max_time=0.25)
    bb = dataclasses.replace(bb, solver=JSolverConfig(
        stokes_tol=1e-8, stokes_restart=30, stokes_maxiter=150,
        energy_tol=1e-10))
    vk = jb.rt_van_keken(nx=nx, ny=nx, max_steps=10**9)
    vk = dataclasses.replace(
        vk, physics=dataclasses.replace(vk.physics, reseed_min_per_cell=2),
        solver=JSolverConfig(stokes_tol=1e-8, stokes_restart=40,
                             stokes_maxiter=200),
        time=dataclasses.replace(vk.time, courant=0.5, dt_max=2.0))
    b2 = jb.fk_stagnant_lid(nx=nx, ny=nx, Ra_top=1e4, visc_contrast=1e3,
                            max_steps=10**9, max_time=0.2)
    b2 = dataclasses.replace(b2, solver=JSolverConfig(
        stokes_tol=1e-8, stokes_restart=40, stokes_maxiter=300,
        energy_tol=1e-10))
    fk = jb.fk_stagnant_lid(nx=nx, ny=nx, max_steps=10**9, max_time=2.0)
    fk = dataclasses.replace(fk, solver=JSolverConfig(
        stokes_tol=1e-8, stokes_restart=40, stokes_maxiter=200))
    return {"blankenbach": bb, "van_keken": vk, "blankenbach_2a": b2,
            "fk_lid": fk}


PORT_CONFIGS = {
    "blankenbach": validate_blankenbach.config,
    "van_keken": validate_van_keken.config,
    "blankenbach_2a": validate_blankenbach_2a.config,
    "fk_lid": validate_fk_lid.config,
}


@pytest.mark.parametrize("nx", (16, 64, 512))
@pytest.mark.parametrize("name", sorted(PORT_CONFIGS))
def test_config_matches_script(name, nx):
    ref = _script_configs(nx)[name]
    got = jax_config(PORT_CONFIGS[name](nx))
    xs, ys = np.meshgrid(np.linspace(0.0, ref.lx, 37),
                         np.linspace(0.0, ref.ly, 29))
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if callable(b):
            np.testing.assert_array_equal(a(xs, ys), b(xs, ys),
                                          err_msg=f.name)
        else:
            assert a == b, f.name


def _reference(name):
    """The JAX package's seeded f64 state after each of STEPS steps (path-
    keyed arrays) with Nu (Blankenbach) and v_rms."""
    jcfg = _script_configs(N)[name]
    jg, jt, st = jax_build(jcfg, dtype=jnp.float64)
    step = jax.jit(jax_make_step(jg, jcfg, jt))
    out = []
    for _ in range(STEPS):
        st, diag = step(st)
        assert bool(diag["stokes_converged"])
        out.append((jax_state_dict(st), float(jb.nusselt_top(st.T, jg)),
                    float(jb.vrms_box(st.vx, st.vy))))
    return out


@pytest.fixture(scope="module")
def references():
    return {name: _reference(name) for name in ("blankenbach", "van_keken")}


@pytest.mark.parametrize("name", ("blankenbach", "van_keken"))
def test_run_matches_reference_steps(references, name):
    cfg = PORT_CONFIGS[name](N)
    r = validation.Run(cfg, torch.float64, "cpu")
    for ref, nu, vr in references[name]:
        r.step()
        got = state_to_numpy(r.state)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            if v.dtype.kind == "f":
                scale = max(float(np.max(np.abs(v))), 1e-300)
                err = float(np.max(np.abs(got[k] - v))) / scale
                assert err <= 1e-10, (k, err)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert abs(float(vrms_box(r.state.vx, r.state.vy)) - vr) <= 1e-10 * vr
        if name == "blankenbach":
            assert abs(float(nusselt_top(r.state.T, r.grid)) - nu) \
                <= 1e-10 * nu
    rec = r.record()
    assert rec["device"] == "cpu" and rec["dtype"] == "float64"
    assert rec["krylov_per_step"] > 0
    # an f64 state on the CPU: the wrappers' plain versions, no launch
    assert rec["kernel_launches_per_step"] == {}


def test_blankenbach_command_line(references, tmp_path):
    out = tmp_path / "bb.json"
    validate_blankenbach.main(["--out", str(out), "--nx", str(N),
                               "--device", "cpu", "--x64", "--max-steps",
                               str(STEPS)])
    s = json.loads(out.read_text())["summary"]
    _, nu, vr = references["blankenbach"][-1]
    assert s["steps"] == STEPS and s["capped"] and s["all_converged"]
    assert abs(s["nu_top"] - nu) <= 1e-10 * nu
    assert abs(s["vrms"] - vr) <= 1e-10 * vr
    assert s["nu_ref"] == jb.BLANKENBACH_1A_NU
    assert s["vrms_ref"] == jb.BLANKENBACH_1A_VRMS


def test_van_keken_command_line(references, tmp_path):
    out = tmp_path / "vk.json"
    validate_van_keken.main(["--out", str(out), "--nx", str(N), "--device",
                             "cpu", "--x64", "--max-steps", str(STEPS)])
    d = json.loads(out.read_text())
    ref = [vr for _, _, vr in references["van_keken"]]
    got = [p["vrms"] for p in d["series"]]
    assert [p["step"] for p in d["series"]] == list(range(1, STEPS + 1))
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    s = d["summary"]
    assert s["vrms_peak"] == max(got) and s["steps"] == STEPS
    assert s["capped"] and s["all_converged"]


def _dropping(monkeypatch):
    """Every step of a Run reports 3 dropped markers."""
    init = validation.Run.__init__

    def dropping_init(self, *a):
        init(self, *a)
        inner = self._step

        def step(state):
            state, diag = inner(state)
            return state, {**diag, "markers_dropped": 3}

        self._step = step

    monkeypatch.setattr(validation.Run, "__init__", dropping_init)


@pytest.mark.parametrize("fault", ("diverged", "dropped"))
def test_failed_step_exits_non_zero(fault, monkeypatch, tmp_path):
    config = validate_fk_lid.config
    if fault == "diverged":
        def config_(nx, max_time):
            cfg = config(nx, max_time)
            return dataclasses.replace(cfg, solver=dataclasses.replace(
                cfg.solver, stokes_restart=2, stokes_maxiter=2))

        monkeypatch.setattr(validate_fk_lid, "config", config_)
    else:
        _dropping(monkeypatch)
    out = tmp_path / "fk.json"
    with pytest.raises(SystemExit) as e:
        validate_fk_lid.main(["--out", str(out), "--nx", "16", "--device",
                              "cpu", "--max-steps", "3"])
    why = "did not converge" if fault == "diverged" else "3 markers dropped"
    assert e.value.code not in (0, None) and why in str(e.value.code)
    # the run stops at its first step and still writes that step's summary
    s = json.loads(out.read_text())["summary"]
    assert s["steps"] == 1 and why in s["failure"]
    assert s["all_converged"] == (fault == "dropped")
    assert s["markers_dropped"] == (3 if fault == "dropped" else 0)


def test_allow_drops_counts_them(monkeypatch, tmp_path):
    _dropping(monkeypatch)
    out = tmp_path / "fk.json"
    validate_fk_lid.main(["--out", str(out), "--nx", "16", "--device", "cpu",
                          "--max-steps", "3", "--allow-drops"])
    s = json.loads(out.read_text())["summary"]
    assert s["steps"] == 3 and s["failure"] is None and s["capped"]
    assert s["markers_dropped"] == 9 and s["first_drop_step"] == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device exists")
def test_card_run_without_card_exits_non_zero(tmp_path):
    with pytest.raises(SystemExit) as e:
        validate_blankenbach_2a.main(["--out", str(tmp_path / "x.json")])
    assert e.value.code not in (0, None)
