"""Port vs reference on a stretched grid: the whole step on the CPU.

- FK stagnant lid at 32x24 with y edges geometric 4x and x edges refined
  in a band (4x), with shear and adiabatic heating, subgrid diffusion and
  reseeding: the JAX package builds the state in f64 and takes 2 steps
  (Chebyshev MG with power-iteration bounds on the non-uniform levels,
  semicoarsening, the per-stream marker transfers); the port
  builds the same initial state itself (the same seeding) and takes the
  same 2 steps from the bridged state.  Velocities within 1e-7 max|v|,
  T within 1e-7, marker positions within 1e-7 of the box, the Krylov
  counts within +-2, the carried power-iteration bounds within 1e-7;
- the bridge carries the stretched state (its power-iteration bounds in
  ``mg_lam`` included) to and from the checkpoint format unchanged;
- the port's step on explicit uniform edges equals its uniform step from
  the same markers (tests/test_stretched.py:542): the stretched branch of
  every phase against the uniform one;
- the same stretched configuration with ``explicit_halo=True`` on the
  in-process 4x2 mesh runs on the global tensors (every halo gate refuses
  a non-uniform grid, as in the reference): against the JAX single-device
  step at this file's bars and the port's own single-device step to 1e-12;
  the marker-halo gate refuses periodic side walls, and the per-shard
  smoother refuses them with ``ValueError``.

The reference compiles its f64 step once per module (a fixture).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict

from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.step import make_step as jax_make_step
from pylamp_tpu_torch.bridge import state_from_numpy, state_to_numpy
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import (
    StaggeredGrid,
    geometric_edges,
    refined_band_edges,
)
from pylamp_tpu_torch.models.benchmarks import falling_block, fk_stagnant_lid
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step, marker_halo_gate
from pylamp_tpu_torch.ops.kernels import cheb_block
from pylamp_tpu_torch.parallel.mesh import make_mesh

NX, NY, STEPS = 32, 24, 2
_BASE = fk_stagnant_lid(nx=NX, ny=NY, max_steps=STEPS)
CFG = dataclasses.replace(
    _BASE, x_edges=refined_band_edges(NX, _BASE.lx, 0.5 * _BASE.lx,
                                      0.3 * _BASE.lx, 4.0),
    y_edges=geometric_edges(NY, _BASE.ly, 4.0),
    # the thermal switches: the per-stream rho0 * alpha and H transfers,
    # the stretched strain rate, subgrid diffusion's one-stream transfers
    # and reseeding in each cell's own spacing
    physics=dataclasses.replace(
        _BASE.physics, shear_heating=True, adiabatic_heating=True,
        subgrid_diffusion_d=1.0, reseed_min_per_cell=2))


@pytest.fixture(scope="module")
def reference():
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


@pytest.fixture(scope="module")
def mesh_run(reference):
    """The port's f64 steps with ``explicit_halo=True`` on the 4x2 mesh
    from the reference's initial state."""
    d0, _ = reference
    cfg = dataclasses.replace(CFG, solver=dataclasses.replace(
        CFG.solver, explicit_halo=True))
    grid, table, _ = build(cfg, dtype=torch.float64, device="cpu")
    step = make_step(grid, cfg, table, mesh=make_mesh(8))
    st = state_from_numpy(d0, device="cpu")
    out = []
    for _ in range(STEPS):
        st, diag = step(st)
        out.append((st, diag))
    return out


def test_build_matches_reference(reference):
    """The stretched seeding and the initial per-stream interpolation."""
    d0, _ = reference
    _, _, st = build(CFG, dtype=torch.float64, device="cpu")
    got = state_from_numpy(d0, device="cpu")
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(st.markers, f), getattr(got.markers, f)), f
    for f in ("eta_s", "eta_n", "T"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   getattr(got, f).numpy(), rtol=1e-13)
    assert st.mg_lam.shape == got.mg_lam.shape


@pytest.mark.parametrize("k", range(STEPS))
def test_step_f64_matches_reference(reference, port_run, k):
    _assert_matches_reference(*reference[1][k], *port_run[k])


@pytest.mark.parametrize("k", range(STEPS))
def test_mesh_step_f64_matches_reference(reference, mesh_run, k):
    """With explicit_halo on the 4x2 mesh, against the JAX single-device
    stretched step at the single-device step's bars."""
    _assert_matches_reference(*reference[1][k], *mesh_run[k])


def _assert_matches_reference(ref, rdiag, st, diag):
    vmax = float(np.max(np.abs(ref["state.vy"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-7 * vmax, name
    for name, got in (("T", st.T), ("markers.x", st.markers.x),
                      ("markers.y", st.markers.y), ("markers.T",
                                                    st.markers.T)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-7, name
    for name in ("markers.valid", "markers.mat"):
        np.testing.assert_array_equal(
            getattr(st.markers, name.split(".")[1]).numpy(),
            ref[f"state.{name}"])
    np.testing.assert_allclose(st.mg_lam.numpy(), ref["state.mg_lam"],
                               rtol=1e-7)
    assert abs(diag["stokes_iterations"]
               - int(rdiag["stokes_iterations"])) <= 2
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == int(rdiag["markers_dropped"]) == 0
    assert int(diag["marker_count"]) == int(rdiag["marker_count"])
    np.testing.assert_allclose(float(diag["dt"]), float(rdiag["dt"]),
                               rtol=1e-6)


def test_bridge_round_trip(reference, port_run):
    """The checkpoint format carries a stretched state unchanged, its
    power-iteration bounds included; the port's stepped state has the
    reference's keys and shapes."""
    ref, _ = reference[1][-1]
    back = state_to_numpy(state_from_numpy(ref, device="cpu"))
    assert set(back) == set(ref)
    for key, a in ref.items():
        np.testing.assert_array_equal(back[key], a, key)
    assert np.all(ref["state.mg_lam"] > 0)
    mine = state_to_numpy(port_run[-1][0])
    assert {k: v.shape for k, v in mine.items()} == {
        k: v.shape for k, v in ref.items()}


def test_uniform_edges_step_equals_uniform_step():
    """Explicit uniform edges take every stretched branch (per-stream
    transfers, windowed locates, variable-spacing operators, power
    bounds) and must give the uniform step's result from the same
    markers."""
    base = falling_block(nx=16, ny=16, max_steps=2)
    edges = tuple(np.linspace(0.0, 1.0, 17))
    g_u, table, st0 = build(base, dtype=torch.float64, device="cpu")
    g_s = StaggeredGrid(nx=16, ny=16, lx=1.0, ly=1.0, x_edges=edges,
                        y_edges=edges)
    cfg_s = dataclasses.replace(base, x_edges=edges, y_edges=edges)
    results = []
    for grid, cfg in ((g_u, base), (g_s, cfg_s)):
        step = make_step(grid, cfg, table)
        state = st0
        for _ in range(2):
            state, diag = step(state)
            assert diag["stokes_converged"]
            assert int(diag["markers_dropped"]) == 0
        results.append(state)
    a, b = results
    scale = float(torch.max(torch.abs(a.vy)))
    assert scale > 0
    for f in ("vx", "vy"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   getattr(a, f).numpy(), atol=1e-9 * scale)
    ax = np.sort(a.markers.x[a.markers.valid].numpy())
    bx = np.sort(b.markers.x[b.markers.valid].numpy())
    np.testing.assert_allclose(bx, ax, atol=1e-12)


@pytest.mark.parametrize("k", range(STEPS))
def test_stretched_mesh_step_equals_single_device(port_run, mesh_run, k):
    """On a stretched grid the explicit-halo mesh step runs the global code
    of the single-device step: every field and marker within 1e-12."""
    (a, da), (b, db) = port_run[k], mesh_run[k]
    for f in ("vx", "vy", "p", "T"):
        x, y = getattr(a, f), getattr(b, f)
        scale = max(float(torch.max(torch.abs(x))), 1.0)
        assert float(torch.max(torch.abs(x - y))) <= 1e-12 * scale, f
    for f in ("x", "y", "T"):
        x, y = getattr(a.markers, f), getattr(b.markers, f)
        assert float(torch.max(torch.abs(x - y))) <= 1e-12, f
    for f in ("mat", "valid"):
        assert torch.equal(getattr(a.markers, f), getattr(b.markers, f)), f
    assert da["stokes_iterations"] == db["stokes_iterations"]


def test_periodic_walls_refused_on_the_mesh_paths():
    """The marker-halo gate keeps the markers global under periodic side
    walls (the reference's ``not periodic``), and the per-shard smoother
    refuses them: the reference keeps it off there."""
    grid = StaggeredGrid(nx=32, ny=32, lx=1.0, ly=1.0)
    mesh = make_mesh(8)
    assert marker_halo_gate(grid, mesh, False) is mesh
    assert marker_halo_gate(grid, mesh, True) is None
    assert marker_halo_gate(grid, None, False) is None
    bcs = VelocityBCs(left="periodic", right="periodic")
    h, by, bx, S = 2, 8, 8, 8
    R, C = by + 2 * h, bx + 2 * h
    z = torch.zeros
    prep = cheb_block.BlockSmootherPrep(
        es_v=z((S, R + 1, C + 1)), en_v=z((S, R, C)), flags=z((S, 4)),
        coeffs=z((h, 2)), kb=z(1), h=h, by=by, bx=bx)
    frames = (z((S, R, C + 1)), z((S, R + 1, C)), z((S, R, C + 1)),
              z((S, R + 1, C)))
    with pytest.raises(ValueError, match="periodic"):
        cheb_block.cheb_block_cuda(*frames, prep, grid, bcs, 1)
