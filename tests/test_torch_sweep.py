"""Port vs reference: the batched parameter sweep (``models/sweep.py``) on
the CPU, Blankenbach 1a at 16^2 in f64 over Ra in {1e4, 1e5}, 2 steps, the
solver of ``tests/test_sweep.py`` (Stokes 1e-10, energy 1e-12).

- The JAX package's vmapped ``make_sweep_step`` (one compile for the
  module) from the port's built states, which cross through the
  checkpoint's path-keyed arrays (the port's build is the reference's:
  ``tests/test_torch_step.py``).  Each port member is held to the JAX
  sweep's member at ``tests/test_torch_step.py``'s f64 bars (velocities
  1e-6 of max|v|, T and marker positions 1e-7, Krylov and energy
  iterations +-1, dt and time to 1e-6 relative).
- Each port member equals the port's own solo step with its table bit
  for bit, Krylov counts included; a changed ``params`` row steers the
  next call; ``stack_states`` / ``unstack_state`` round-trip both marker
  engines; ``stack_tables`` refuses mismatched tables.

Run as a script, this file compares the JAX sweep's members with each
member's jitted solo ``make_step`` (the reference's own contract):
``python tests/test_torch_sweep.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict

from pylamp_tpu.core.grid import StaggeredGrid as JStaggeredGrid
from pylamp_tpu.markers.bucket import BucketedMarkers as JBucketedMarkers
from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.state import ModelState as JModelState
from pylamp_tpu.models.sweep import make_sweep_step as jax_make_sweep_step
from pylamp_tpu.models.sweep import stack_states as jax_stack_states
from pylamp_tpu.models.sweep import unstack_state as jax_unstack_state
from pylamp_tpu.physics.materials import MaterialTable as JMaterialTable
from pylamp_tpu_torch.bridge import (
    GRID_FIELDS,
    MARKER_FIELDS,
    state_leaves,
    state_to_numpy,
)
from pylamp_tpu_torch.models.benchmarks import blankenbach_case1a
from pylamp_tpu_torch.models.config import SolverConfig
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.models.sweep import (
    make_sweep_step,
    stack_states,
    stack_tables,
    unstack_state,
)
from pylamp_tpu_torch.physics.materials import MaterialTable

RAS = (1e4, 1e5)
STEPS = 2
V_TOL = 1e-6  # of max|v|
X_TOL = 1e-7  # T and marker positions (unit box)


def _cfg(Ra):
    cfg = blankenbach_case1a(nx=16, ny=16, Ra=Ra, max_steps=STEPS)
    return dataclasses.replace(
        cfg, solver=SolverConfig(stokes_tol=1e-10, energy_tol=1e-12))


CFGS = [_cfg(Ra) for Ra in RAS]


def _jax_state(state):
    """A port ModelState (bucket markers) as the JAX package's."""
    d = state_to_numpy(state)
    markers = JBucketedMarkers(**{f: jnp.asarray(d[f"state.markers.{f}"])
                                  for f in MARKER_FIELDS})
    return JModelState(markers=markers, **{
        f: jnp.asarray(d[f"state.{f}"]) for f in GRID_FIELDS
        if f"state.{f}" in d})


def _jax_sweep():
    """The JAX package's configurations and its jitted vmapped sweep step
    with its params."""
    jcfgs = [jax_config(c) for c in CFGS]
    c = jcfgs[0]
    sweep, params = jax_make_sweep_step(
        JStaggeredGrid(nx=c.nx, ny=c.ny, lx=c.lx, ly=c.ly), c,
        [JMaterialTable(j.physics.materials) for j in jcfgs])
    return jcfgs, sweep, params


@pytest.fixture(scope="module")
def initial():
    """The port's grid, tables and initial states (f64, CPU)."""
    built = [build(c, dtype=torch.float64, device="cpu") for c in CFGS]
    return built[0][0], [b[1] for b in built], [b[2] for b in built]


@pytest.fixture(scope="module")
def reference(initial):
    """After each JAX sweep step from the initial states: each member's
    state (path-keyed arrays) and the stacked diagnostics."""
    _, sweep, params = _jax_sweep()
    batched = jax_stack_states([_jax_state(st) for st in initial[2]])
    out = []
    for _ in range(STEPS):
        batched, diag = sweep(batched, params)
        out.append(([jax_state_dict(jax_unstack_state(batched, i))
                     for i in range(len(RAS))],
                    {k: np.asarray(v) for k, v in diag.items()}))
    return out


@pytest.fixture(scope="module")
def port(initial):
    """The port's sweep from the initial states: (grid, tables, initial
    states, [(batched state, diag batch) per step], sweep step, params)."""
    grid, tables, states = initial
    sweep, params = make_sweep_step(grid, CFGS[0], tables)
    batched, out = stack_states(states), []
    for _ in range(STEPS):
        batched, diag = sweep(batched, params)
        out.append((batched, diag))
    return grid, tables, states, out, sweep, params


def _solo(grid, table, state, steps=STEPS):
    step = make_step(grid, CFGS[0], table)
    out = []
    for _ in range(steps):
        state, diag = step(state)
        out.append((state, diag))
    return out


def _assert_equal(a, b):
    a, b = state_leaves(a), state_leaves(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("k", range(STEPS))
@pytest.mark.parametrize("i", range(len(RAS)))
def test_sweep_member_matches_reference(reference, port, i, k):
    ref, rdiag = reference[k][0][i], reference[k][1]
    batched, diag = port[3][k]
    st = unstack_state(batched, i)
    vmax = float(np.max(np.abs(ref["state.vx"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= V_TOL * vmax, name
    for name, got in (("T", st.T), ("markers.x", st.markers.x),
                      ("markers.y", st.markers.y),
                      ("markers.T", st.markers.T)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= X_TOL, name
    for name in ("markers.valid", "markers.mat"):
        np.testing.assert_array_equal(
            getattr(st.markers, name.split(".")[1]).numpy(),
            ref[f"state.{name}"])
    for key in ("stokes_iterations", "energy_iterations"):
        assert tuple(diag[key].shape) == (len(RAS),)
        assert abs(int(diag[key][i]) - int(rdiag[key][i])) <= 1, key
    assert diag["stokes_converged"][i]
    assert diag["stokes_residual_rel"][i] <= 1e-8
    assert int(diag["markers_dropped"][i]) == int(rdiag["markers_dropped"][i]) == 0
    np.testing.assert_allclose(float(diag["dt"][i]), float(rdiag["dt"][i]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(st.time), float(ref["state.time"]),
                               rtol=1e-6)


@pytest.mark.parametrize("i", range(len(RAS)))
def test_sweep_member_equals_solo_step(port, i):
    """Member i is its own solo step with its table, bit for bit in every
    leaf, with the same Krylov and energy iterations."""
    grid, tables, states, out, _, _ = port
    for k, (st, diag) in enumerate(_solo(grid, tables[i], states[i])):
        batched, bdiag = out[k]
        _assert_equal(unstack_state(batched, i), st)
        for key in ("stokes_iterations", "energy_iterations"):
            assert int(bdiag[key][i]) == diag[key], key


def test_params_steer_next_call(port):
    """A changed params row steers the next call: member 1 with alpha
    halved equals the solo step with a table of halved alpha, member 0
    stays its own solo step; the call leaves its input batch as it was
    (each member steps from a view of it)."""
    grid, tables, states, _, sweep, params = port
    steered = {k: v.clone() for k, v in params.items()}
    steered["alpha"][1] *= 0.5
    batch = stack_states(states)
    batched, _ = sweep(batch, steered)
    _assert_equal(batch, stack_states(states))
    halved = MaterialTable(
        [dataclasses.replace(m, alpha=0.5 * m.alpha)
         for m in CFGS[1].physics.materials])
    _assert_equal(unstack_state(batched, 1),
                  _solo(grid, halved, states[1], 1)[0][0])
    _assert_equal(unstack_state(batched, 0),
                  _solo(grid, tables[0], states[0], 1)[0][0])


@pytest.mark.parametrize("engine", ["bucket", "flat"])
def test_stack_round_trip(engine):
    """stack_states / unstack_state round-trip every leaf of either marker
    engine (mg_lam included where the preconditioner has one)."""
    states = [build(dataclasses.replace(c, nx=8, ny=8, marker_engine=engine),
                    dtype=torch.float64, device="cpu")[2] for c in CFGS]
    states[1] = states[1].replace(T=states[1].T + 1.0)
    batched = stack_states(states)
    for k, v in state_leaves(batched).items():
        assert v.shape[0] == len(states), k
    for i, st in enumerate(states):
        got = unstack_state(batched, i)
        assert type(got.markers) is type(st.markers)
        _assert_equal(got, st)


def test_stack_tables_rejects_mismatched_materials():
    mats = CFGS[0].physics.materials
    t1 = stack_tables([MaterialTable(mats)])
    assert tuple(t1["rho0"].shape) == (1, 1) and t1["rho0"].dtype == torch.float64
    with pytest.raises(ValueError, match="same number of materials"):
        stack_tables([MaterialTable(mats), MaterialTable(mats + mats)])
    other_law = (dataclasses.replace(mats[0], viscosity="frank_kamenetskii"),)
    with pytest.raises(ValueError, match="same viscosity laws"):
        stack_tables([MaterialTable(mats), MaterialTable(other_law)])


def _reference_contract():
    """The JAX sweep's members against each member's jitted solo
    ``make_step`` from the same state: max |dT|, max |dvx| / max |vx| and
    both iteration counts per member and step."""
    from pylamp_tpu.models.step import make_step as jax_make_step

    jcfgs, sweep, params = _jax_sweep()
    built = [jax_build(c, dtype=jnp.float64) for c in jcfgs]
    batched = jax_stack_states([b[2] for b in built])
    solos = [(jax.jit(jax_make_step(built[0][0], jcfgs[0], b[1])), b[2])
             for b in built]
    for k in range(STEPS):
        batched, bdiag = sweep(batched, params)
        for i, (step, st) in enumerate(solos):
            st, diag = step(st)
            solos[i] = (step, st)
            got = jax_unstack_state(batched, i)
            vmax = float(jnp.max(jnp.abs(st.vx)))
            print(f"step {k + 1} Ra {RAS[i]:.0e}: "
                  f"max|dT| {float(jnp.max(jnp.abs(got.T - st.T))):.2e}, "
                  f"max|dvx|/max|vx| "
                  f"{float(jnp.max(jnp.abs(got.vx - st.vx))) / vmax:.2e}; "
                  f"sweep Stokes {int(bdiag['stokes_iterations'][i])}, "
                  f"energy {int(bdiag['energy_iterations'][i])}; solo "
                  f"Stokes {int(diag['stokes_iterations'])}, energy "
                  f"{int(diag['energy_iterations'])}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _reference_contract()
