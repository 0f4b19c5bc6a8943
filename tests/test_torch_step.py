"""Port vs reference: the whole FK timestep (the ported slice) on the CPU.

The JAX package builds the FK stagnant-lid state at 32^2 with the bench
solver preset (``fk_bench_config`` values) in f64; the state is bridged
into the port through the checkpoint's path-keyed arrays, and both
packages take 2 steps:

- velocities within 1e-6 max|v| (the precedent of
  tests/test_lam_warmstart.py), grid and marker temperatures and marker
  positions within 1e-7 (unit domain: a 1e-6 velocity difference moves a
  marker ~1.6e-8 in a Courant-0.5 step at 32^2), Krylov counts +-1;
- the port's mixed-precision path alone (f32 state, f32 inner solves
  under f64 refinement, the path the card runs): one step converges to
  1e-8 with velocities within 1e-4 max|v| of the reference's f64 step
  (the f32 marker->grid transfer rounds the viscosity field).

f64 keeps the reference's compile short (its mixed-precision step takes
minutes to compile on a CPU).
"""
import jax
import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict

from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.step import make_step as jax_make_step
from pylamp_tpu_torch.bridge import state_from_numpy
from pylamp_tpu_torch.models.benchmarks import fk_bench_config
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step

N = 32
STEPS = 2
CFG = fk_bench_config(N)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's initial state (as path-keyed arrays) and its
    states + diagnostics after each of STEPS f64 steps."""
    import jax.numpy as jnp

    jcfg = jax_config(CFG)
    jgrid, jtable, st = jax_build(jcfg, dtype=jnp.float64)
    d0 = jax_state_dict(st)
    step = jax.jit(jax_make_step(jgrid, jcfg, jtable))
    out = []
    for _ in range(STEPS):
        st, diag = step(st)
        out.append((jax_state_dict(st),
                    {k: np.asarray(v) for k, v in diag.items()}))
    return d0, out


@pytest.fixture(scope="module")
def port_run(reference):
    d0, _ = reference
    grid, table, _ = build(CFG, dtype=torch.float64, device="cpu")
    step = make_step(grid, CFG, table)
    st = state_from_numpy(d0, device="cpu")
    out = []
    for _ in range(STEPS):
        st, diag = step(st)
        out.append((st, diag))
    return out


def test_build_matches_reference(reference):
    """The port's own numpy seeding gives the reference's initial state."""
    d0, _ = reference
    _, _, st = build(CFG, dtype=torch.float64, device="cpu")
    got = state_from_numpy(d0, device="cpu")
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(st.markers, f), getattr(got.markers, f)), f
    for f in ("eta_s", "eta_n", "T"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   getattr(got, f).numpy(), rtol=1e-13)


@pytest.mark.parametrize("k", range(STEPS))
def test_step_f64_matches_reference(reference, port_run, k):
    ref, rdiag = reference[1][k]
    st, diag = port_run[k]
    vmax = float(np.max(np.abs(ref["state.vx"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-6 * vmax, name
    for name, got in (("T", st.T), ("markers.x", st.markers.x),
                      ("markers.y", st.markers.y),
                      ("markers.T", st.markers.T)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-7, name
    for name in ("markers.valid", "markers.mat"):
        np.testing.assert_array_equal(
            getattr(st.markers, name.split(".")[1]).numpy(),
            ref[f"state.{name}"])
    assert abs(diag["stokes_iterations"] - int(rdiag["stokes_iterations"])) <= 1
    assert abs(diag["energy_iterations"] - int(rdiag["energy_iterations"])) <= 1
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == int(rdiag["markers_dropped"]) == 0
    assert int(diag["marker_count"]) == int(rdiag["marker_count"])
    np.testing.assert_allclose(float(diag["dt"]), float(rdiag["dt"]),
                               rtol=1e-6)


def test_mixed_step_f32(reference):
    """The card's path on the CPU: f32 state through the kernel wrappers'
    plain versions and the mixed-precision solves."""
    d0, out = reference
    ref, _ = out[0]
    grid, table, _ = build(CFG, dtype=torch.float32, device="cpu")
    st = state_from_numpy(d0, device="cpu", dtype=torch.float32)
    st, diag = make_step(grid, CFG, table)(st)
    assert st.vx.dtype == torch.float32
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    vmax = float(np.max(np.abs(ref["state.vx"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.double().numpy()
                                  - ref[f"state.{name}"])))
        assert err <= 1e-4 * vmax, name
