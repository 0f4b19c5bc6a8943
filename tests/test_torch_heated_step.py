"""Port vs reference: the thermal path of the step on the CPU.

The FK stagnant lid at 32^2 with the bench solver preset and the
reference's four thermal switches, set as tests/test_heating.py sets the
first two: shear and adiabatic heating, subgrid diffusion (d = 1, Gerya's
value) and reseeding at 10 markers per cell (one more than the preset's initial
count, so every step spawns), with dt capped (DT_MAX below).  Two variants: the
preset's walls with the Jacobi energy preconditioner, and periodic side
walls (velocity and thermal) with the energy multigrid and flexible CG.

- the reference builds the state in f64 and takes 3 steps; the port takes
  the same steps from the bridged state: velocities within 1e-7 max|v|,
  grid and marker temperatures and marker positions within 1e-7, valid
  slots and materials equal, Krylov counts +-1, spawned markers counted
  alike;
- the card's path on the CPU: an f32 state through the kernel wrappers'
  plain versions (kernel 2 with the rho0*alpha stream) and the
  mixed-precision solves converges and stays finite;
- the heated step on the in-process 4x2 mesh (explicit halo: m2g_halo,
  reseed_halo, the per-shard transfer with rho0*alpha, the energy MG
  through the halo operators) against the single-device heated step;
- the sharded layout (``shard_state``): the in-process 4x2 mesh with
  explicit halos takes the reference's three steps of each variant on
  the sharded state, from the same bridged state, at the bars above (the
  periodic one through the marker engine's wrap-around exchange and the
  periodic block forms);
- ``_check_slice`` accepts the four switches and the energy multigrid
  with each smoother and the BFBT Schur surrogate, and refuses an
  unknown preconditioner.

The reference compiles each f64 step once per module (a fixture).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict

from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.step import make_step as jax_make_step
from pylamp_tpu_torch.bridge import state_from_numpy
from pylamp_tpu_torch.core.bc import ThermalBC, VelocityBCs
from pylamp_tpu_torch.markers.kernels import m2g
from pylamp_tpu_torch.models.benchmarks import (
    fk_bench_config,
    fk_stagnant_lid,
)
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import _check_slice, make_step
from pylamp_tpu_torch.parallel.mesh import make_mesh

N = 32
STEPS = 3
# one more than the initial markers_per_cell_dim^2 = 9: every cell spawns
RESEED = 10
# the FK preset puts Ra = 100 into rho0 * alpha, so adiabatic heating is
# 100 T vy; at 32^2 the diffusion cap allows dt ~ 5e-3 and T runs away
# within 2 steps (1024^2 steps are ~1000x shorter).  This cap keeps the
# heating to ~10 % of T per step over 3 steps, and markers still cross
# cells.
DT_MAX = 1e-4


def heated(cfg, energy_preconditioner="jacobi"):
    """The reference's thermal switches on ``cfg``, with dt capped at
    DT_MAX."""
    return dataclasses.replace(
        cfg, time=dataclasses.replace(cfg.time, dt_max=DT_MAX),
        physics=dataclasses.replace(
            cfg.physics, shear_heating=True, adiabatic_heating=True,
            subgrid_diffusion_d=1.0, reseed_min_per_cell=RESEED),
        solver=dataclasses.replace(
            cfg.solver, energy_preconditioner=energy_preconditioner))


def _T_periodic(x, y):
    """The FK initial perturbation with period lx = 1 in x."""
    return y + 0.05 * np.cos(2.0 * np.pi * x) * np.sin(np.pi * y)


def periodic(cfg):
    """``cfg`` with periodic side walls, velocity and thermal, and an
    initial temperature that is periodic in x."""
    per = ThermalBC("periodic", 0.0)
    phys = cfg.physics
    return dataclasses.replace(
        cfg, T_of=_T_periodic, physics=dataclasses.replace(
            phys, velocity_bcs=VelocityBCs(left="periodic", right="periodic"),
            thermal_bcs=dataclasses.replace(phys.thermal_bcs, left=per,
                                            right=per)))


CFGS = {"wall": heated(fk_bench_config(N)),
        "periodic": heated(periodic(fk_stagnant_lid(N, N)), "mg")}


def _reference(cfg):
    import jax.numpy as jnp

    jcfg = jax_config(cfg)
    jgrid, jtable, st = jax_build(jcfg, dtype=jnp.float64)
    d0 = jax_state_dict(st)
    step = jax.jit(jax_make_step(jgrid, jcfg, jtable))
    out = []
    for _ in range(STEPS):
        st, diag = step(st)
        out.append((jax_state_dict(st),
                    {k: np.asarray(v) for k, v in diag.items()}))
    return d0, out


def _port(cfg, d0):
    grid, table, _ = build(cfg, dtype=torch.float64, device="cpu")
    step = make_step(grid, cfg, table)
    st = state_from_numpy(d0, device="cpu")
    out = []
    for _ in range(STEPS):
        st, diag = step(st)
        out.append((st, diag))
    return out


@pytest.fixture(scope="module", params=sorted(CFGS))
def runs(request):
    cfg = CFGS[request.param]
    d0, ref = _reference(cfg)
    return cfg, d0, ref, _port(cfg, d0)


@pytest.mark.parametrize("k", range(STEPS))
def test_heated_step_f64_matches_reference(runs, k):
    cfg, _, ref_out, port_out = runs
    ref, rdiag = ref_out[k]
    st, diag = port_out[k]
    vmax = float(np.max(np.abs(ref["state.vy"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-7 * vmax, name
    for name, got in (("T", st.T), ("markers.T", st.markers.T),
                      ("markers.x", st.markers.x),
                      ("markers.y", st.markers.y)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-7, name
    for name in ("markers.valid", "markers.mat"):
        np.testing.assert_array_equal(
            getattr(st.markers, name.split(".")[1]).numpy(),
            ref[f"state.{name}"])
    for it in ("stokes_iterations", "energy_iterations"):
        assert abs(diag[it] - int(rdiag[it])) <= 1, it
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == int(rdiag["markers_dropped"]) == 0
    assert int(diag["marker_count"]) == int(rdiag["marker_count"])


def test_heated_run_spawns(runs):
    """Reseeding spawned in the run: the valid markers after the last step
    outnumber the count the step took before reseeding."""
    _, _, ref_out, port_out = runs
    st, diag = port_out[-1]
    ref, _ = ref_out[-1]
    assert int(st.markers.total()) > int(diag["marker_count"])
    assert int(st.markers.total()) == int(np.sum(ref["state.markers.valid"]))


def test_sharded_heated_steps_match_reference(runs):
    """The port's in-process sharded step (every rank's code path) against
    the reference's three f64 steps."""
    from pylamp_tpu_torch.bridge import sharded_from_numpy, sharded_to_numpy

    cfg, d0, ref_out, _ = runs
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, explicit_halo=True))
    grid, table, _ = build(cfg, dtype=torch.float64, device="cpu")
    mesh = make_mesh(8)
    step = make_step(grid, cfg, table, mesh=mesh)
    st = sharded_from_numpy(d0, mesh, device="cpu")
    for (ref, rdiag) in ref_out:
        st, diag = step(st)
        got = sharded_to_numpy(st, mesh)
        vmax = float(np.max(np.abs(ref["state.vy"])))
        for name in ("vx", "vy"):
            err = float(np.max(np.abs(got[f"state.{name}"]
                                      - ref[f"state.{name}"])))
            assert err <= 1e-7 * vmax, name
        for name in ("T", "markers.T", "markers.x", "markers.y"):
            err = float(np.max(np.abs(got[f"state.{name}"]
                                      - ref[f"state.{name}"])))
            assert err <= 1e-7, name
        for name in ("markers.valid", "markers.mat"):
            np.testing.assert_array_equal(got[f"state.{name}"],
                                          ref[f"state.{name}"])
        for it in ("stokes_iterations", "energy_iterations"):
            assert abs(diag[it] - int(rdiag[it])) <= 1, it
        assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
        assert int(diag["markers_dropped"]) == int(rdiag["markers_dropped"])
        # the same markers before reseeding, and the same spawned
        assert int(diag["marker_count"]) == int(rdiag["marker_count"])
        assert int(np.sum(got["state.markers.valid"])) == int(
            np.sum(ref["state.markers.valid"])) > int(diag["marker_count"])


def test_mixed_heated_step_f32(runs):
    """The card's path on the CPU: f32 markers through kernel 2's plain
    version with the rho0*alpha stream and the mixed-precision solves."""
    cfg, d0, ref_out, _ = runs
    ref, _ = ref_out[0]
    grid, table, _ = build(cfg, dtype=torch.float32, device="cpu")
    st = state_from_numpy(d0, device="cpu", dtype=torch.float32)
    st, diag = make_step(grid, cfg, table)(st)
    assert st.vx.dtype == torch.float32
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    for v in (st.vx, st.vy, st.T, st.markers.T, st.markers.x):
        assert bool(torch.isfinite(v).all())
    vmax = float(np.max(np.abs(ref["state.vy"])))
    err = float(np.max(np.abs(st.vy.double().numpy() - ref["state.vy"])))
    assert err <= 1e-4 * vmax


def test_heated_mesh_step_matches_single_device():
    """The heated step on the in-process 4x2 mesh with explicit halos (f64,
    the plain versions of kernels 8-12) against the single-device heated
    step, with the energy multigrid through the halo operators."""
    cfg = CFGS["wall"]
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, energy_preconditioner="mg"))
    cfg_h = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, explicit_halo=True))
    grid, table, st0 = build(cfg, dtype=torch.float64, device="cpu")
    st, diag = make_step(grid, cfg_h, table, mesh=make_mesh(8))(st0)
    st1, diag1 = make_step(grid, cfg, table)(st0)
    vmax = float(torch.max(torch.abs(st1.vy)))
    for name in ("vx", "vy"):
        err = float(torch.max(torch.abs(getattr(st, name)
                                        - getattr(st1, name))))
        assert err <= 1e-7 * vmax, name
    for name in ("x", "y", "T"):
        err = float(torch.max(torch.abs(getattr(st.markers, name)
                                        - getattr(st1.markers, name))))
        assert err <= 1e-7, name
    assert torch.equal(st.markers.valid, st1.markers.valid)
    assert torch.equal(st.markers.mat, st1.markers.mat)
    assert float(torch.max(torch.abs(st.T - st1.T))) <= 1e-7
    assert abs(diag["stokes_iterations"] - diag1["stokes_iterations"]) <= 1
    assert abs(diag["energy_iterations"] - diag1["energy_iterations"]) <= 1


def test_ra_stream_from_the_transfer(monkeypatch):
    """With adiabatic heating the fused transfer carries c_ra, and the step
    takes rho0*alpha from it: the f32 step asks kernel 2's wrapper for the
    stream on every step."""
    cfg = CFGS["wall"]
    grid, table, st = build(cfg, dtype=torch.float32, device="cpu")
    seen = []
    plain = m2g.m2g_fused_plain

    def spy(*a, **kw):
        out = plain(*a, **kw)
        seen.append("c_ra" in out)
        return out

    monkeypatch.setattr(m2g, "m2g_fused_plain", spy)
    make_step(grid, cfg, table)(st)
    assert seen == [True]


def test_check_slice_accepts_the_thermal_path():
    cfg = CFGS["wall"]
    _check_slice(cfg)
    _check_slice(CFGS["periodic"])
    for smoother in ("line", "line_y", "line_x"):  # ported with lines.py
        _check_slice(dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, energy_preconditioner="mg",
            energy_mg_smoother=smoother)))
    _check_slice(dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, schur="wbfbt")))  # ported with solvers/bfbt.py
    with pytest.raises(ValueError):
        _check_slice(dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, preconditioner="ilu")))


def test_fk_heated_config():
    """The profiler's and chip check's heated FK: the bench preset with the
    four thermal switches and nothing else changed."""
    from pylamp_tpu_torch.models.profile import CONFIGS, fk_heated_config

    base = fk_bench_config(64)
    for cfg, pre in ((fk_heated_config(64), "jacobi"),
                     (CONFIGS["fk_heated_mg"](64), "mg")):
        phys = cfg.physics
        assert phys.shear_heating and phys.adiabatic_heating
        assert phys.subgrid_diffusion_d == 1.0
        assert phys.reseed_min_per_cell == 2
        assert cfg.solver == dataclasses.replace(
            base.solver, energy_preconditioner=pre)
        assert dataclasses.replace(
            phys, shear_heating=False, adiabatic_heating=False,
            subgrid_diffusion_d=0.0, reseed_min_per_cell=0) == base.physics
        _check_slice(cfg)
