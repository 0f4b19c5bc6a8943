"""Port vs reference and vs the assembled-matrix oracle: the flat marker
engine's whole step and the block-Jacobi Stokes preconditioner, on the CPU.

- ``make_block_jacobi_preconditioner``'s M(r) against the JAX package's
  at 1e-12 on a uniform, a periodic free-slip (the vx mean projected out)
  and a stretched grid;
- the twin of tests/test_model_e2e.py's oracle test: the falling block at
  16^2, flat markers, ``preconditioner="jacobi"``, 3 f64 steps of the port
  against a reference-style step that solves Stokes with
  tests/oracle/stokes_oracle.py's assembled matrix + ``spsolve`` and moves
  the markers with the port's own transfers: that test's bars (velocities
  within 1e-7 max|vy|, markers within 1e-8 of the box);
- the same 3 steps against the JAX flat step from the bridged state, and
  Blankenbach 1a at 16^2 with flat markers, block Jacobi and reseeding
  below 2 markers per cell (from a state with 16 cells emptied, so that
  markers move) for 2 steps: every field and marker within 1e-10;
- the flat stretched step of tests/test_stretched.py:320-377: the
  falling block on a refined-band grid (its default MG solver with
  power-iteration bounds) for 3 steps against the JAX step (velocities
  within 1e-7 max|v|, markers within 1e-7, Krylov within +-2), and the
  port's step on explicit uniform edges against its uniform step from
  one hand-built marker set (that test's bars);
- a flat state through ``bridge.py`` and ``io/checkpoint.py`` in both
  directions, and ``save_fields`` writing every flat marker;
- importing the new modules in a fresh interpreter loads no ``jax``.

The reference's states are computed once per module (fixtures).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict, jax_vbcs, rel, t

from pylamp_tpu.core import grid as jgrid
from pylamp_tpu.io import checkpoint as jcheckpoint
from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.step import make_step as jax_make_step
from pylamp_tpu.solvers import stokes_solver as jstokes
from pylamp_tpu_torch.bridge import state_from_numpy, state_to_numpy
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid, refined_band_edges
from pylamp_tpu_torch.io import checkpoint
from pylamp_tpu_torch.io.output import save_fields
from pylamp_tpu_torch.markers.advect import advect_rk4
from pylamp_tpu_torch.markers.interp import markers_to_grid
from pylamp_tpu_torch.markers.state import MarkerState
from pylamp_tpu_torch.models.benchmarks import (
    blankenbach_case1a,
    falling_block,
)
from pylamp_tpu_torch.models.config import SolverConfig
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.state import zero_state
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.physics.materials import MaterialTable
from pylamp_tpu_torch.solvers.stokes_solver import (
    make_block_jacobi_preconditioner,
)

from tests.oracle.stokes_oracle import StokesOracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
# tests/test_model_e2e.py's configuration
FB = dataclasses.replace(
    falling_block(nx=16, ny=16, max_steps=STEPS), marker_engine="flat",
    solver=SolverConfig(stokes_tol=1e-11, stokes_restart=60,
                        stokes_maxiter=4000, preconditioner="jacobi"))
BB = dataclasses.replace(
    blankenbach_case1a(nx=16, ny=16), marker_engine="flat",
    physics=dataclasses.replace(blankenbach_case1a(16).physics,
                                reseed_min_per_cell=2),
    solver=SolverConfig(stokes_tol=1e-11, stokes_restart=60,
                        stokes_maxiter=4000, preconditioner="jacobi"))
STRETCHED = dataclasses.replace(
    falling_block(nx=16, ny=16, max_steps=STEPS), marker_engine="flat",
    x_edges=refined_band_edges(16, 1.0, 0.5, 0.5, 3.0),
    y_edges=refined_band_edges(16, 1.0, 0.3, 0.4, 3.0))
FLAT_KEYS = ("state.markers.x", "state.markers.y", "state.markers.mat",
             "state.markers.T")


def _jax_state(template, d):
    """A JAX ModelState of ``template``'s structure from path-keyed arrays."""
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(d[k]) for k in jax_state_dict(template)])


def _jax_run(cfg, steps, edit=None):
    """The JAX package's initial state (``edit``-ed: a function of the
    path-keyed arrays) and its state + diagnostics after each of
    ``steps`` f64 flat steps (path-keyed numpy arrays)."""
    jcfg = jax_config(cfg)
    jg, jt, st = jax_build(jcfg, dtype=jnp.float64)
    d0 = jax_state_dict(st)
    if edit is not None:
        d0 = edit(d0)
        st = _jax_state(st, d0)
    step = jax.jit(jax_make_step(jg, jcfg, jt))
    out = []
    for _ in range(steps):
        st, diag = step(st)
        out.append((jax_state_dict(st),
                    {k: np.asarray(v) for k, v in diag.items()}))
    return d0, out


def _port_run(cfg, d0, steps):
    grid, table, _ = build(cfg, dtype=torch.float64, device="cpu")
    step = make_step(grid, cfg, table)
    st = state_from_numpy(d0, device="cpu")
    out = []
    for _ in range(steps):
        st, diag = step(st)
        out.append((state_to_numpy(st), diag))
    return out


@pytest.fixture(scope="module")
def fb_reference():
    return _jax_run(FB, STEPS)


@pytest.fixture(scope="module")
def fb_port(fb_reference):
    return _port_run(FB, fb_reference[0], STEPS)


# -- the block-Jacobi preconditioner ------------------------------------------

@pytest.mark.parametrize("kind", ("walls", "periodic", "stretched"))
def test_block_jacobi_apply(kind):
    edges = {}
    if kind == "stretched":
        edges = dict(x_edges=refined_band_edges(16, 1.2, 0.5, 0.4, 3.0),
                     y_edges=refined_band_edges(12, 1.0, 0.3, 0.4, 4.0))
    grid = StaggeredGrid(nx=16, ny=12, lx=1.2, ly=1.0, **edges)
    jg = jgrid.StaggeredGrid(nx=16, ny=12, lx=1.2, ly=1.0, **edges)
    bcs = (VelocityBCs(left="periodic", right="periodic")
           if kind == "periodic" else VelocityBCs(top="no_slip"))
    rng = np.random.default_rng(11)
    eta_s = np.exp(rng.normal(size=grid.shape_corner))
    eta_n = np.exp(rng.normal(size=grid.shape_center))
    r = [rng.normal(size=s) for s in (grid.shape_vx, grid.shape_vy,
                                      grid.shape_center)]
    kcont, kbnd = 1.7, 2.3
    M = make_block_jacobi_preconditioner(t(eta_s), t(eta_n), grid,
                                         t(kcont), t(kbnd), bcs=bcs)
    jM = jstokes.make_block_jacobi_preconditioner(
        jnp.asarray(eta_s), jnp.asarray(eta_n), jg, jnp.asarray(kcont),
        jnp.asarray(kbnd), bcs=jax_vbcs(bcs))
    got = M(tuple(t(a) for a in r))
    ref = jM(tuple(jnp.asarray(a) for a in r))
    for g, w in zip(got, ref):
        assert rel(g, w) <= 1e-12
    if kind == "periodic":  # free slip top and bottom: vx mean removed
        assert abs(float(torch.mean(got[0][:, :-1]))) <= 1e-14


# -- the assembled-matrix oracle ----------------------------------------------

def _oracle_step(state, grid, cfg, table):
    """One step the reference's way: the port's transfers and RK4, Stokes
    from the oracle's assembled matrix and ``spsolve``."""
    m = state.markers
    phys = cfg.physics
    rho_m = table.density(m.mat, m.T)
    eta_m = torch.clamp(table.viscosity_of(m.mat, m.T), phys.eta_min,
                        phys.eta_max)
    eta_s, _ = markers_to_grid(m.x, m.y, eta_m, grid, "corner", phys.eta_avg)
    eta_n, _ = markers_to_grid(m.x, m.y, eta_m, grid, "center", phys.eta_avg)
    rho_vy, _ = markers_to_grid(m.x, m.y, rho_m, grid, "vy", "arithmetic")
    oracle = StokesOracle(grid.nx, grid.ny, grid.lx, grid.ly,
                          jax_vbcs(phys.velocity_bcs))
    vx, vy, p = oracle.solve(eta_s.numpy(), eta_n.numpy(),
                             np.zeros(grid.shape_vx), rho_vy.numpy(),
                             phys.gx, phys.gy)
    vx, vy = t(vx), t(vy)
    dt = cfg.time.courant * torch.minimum(grid.dx / torch.max(torch.abs(vx)),
                                          grid.dy / torch.max(torch.abs(vy)))
    px, py = advect_rk4(m.x, m.y, vx, vy, dt, grid, phys.velocity_bcs)
    return state.replace(markers=m.replace(x=px, y=py), vx=vx, vy=vy,
                         p=t(p), dt=dt)


def test_falling_block_step_matches_oracle():
    grid, table, state0 = build(FB, dtype=torch.float64, device="cpu")
    assert isinstance(state0.markers, MarkerState)
    step = make_step(grid, FB, table)
    ours = ref = state0
    for _ in range(STEPS):
        ours, diag = step(ours)
        assert diag["stokes_converged"]
        ref = _oracle_step(ref, grid, FB, table)
    vscale = float(torch.max(torch.abs(ref.vy)))
    np.testing.assert_allclose(ours.vx.numpy(), ref.vx.numpy(),
                               atol=1e-7 * vscale)
    np.testing.assert_allclose(ours.vy.numpy(), ref.vy.numpy(),
                               atol=1e-7 * vscale)
    np.testing.assert_allclose(ours.markers.x.numpy(),
                               ref.markers.x.numpy(), atol=1e-8 * grid.lx)
    np.testing.assert_allclose(ours.markers.y.numpy(),
                               ref.markers.y.numpy(), atol=1e-8 * grid.ly)
    blk = state0.markers.mat == 1  # the dense block sinks (y down)
    assert float(ours.markers.y[blk].mean()) > float(
        state0.markers.y[blk].mean())


# -- the port's flat step against the JAX flat step ---------------------------

def test_flat_build_matches_reference(fb_reference):
    _, _, st = build(FB, dtype=torch.float64, device="cpu")
    got = state_to_numpy(st)
    d0 = fb_reference[0]
    assert sorted(got) == sorted(d0)
    for k in FLAT_KEYS:
        np.testing.assert_array_equal(got[k], d0[k], err_msg=k)
    for k in ("state.eta_s", "state.eta_n", "state.T"):
        np.testing.assert_allclose(got[k], d0[k], rtol=1e-13)


@pytest.mark.parametrize("i", range(STEPS))
def test_flat_step_matches_reference(fb_reference, fb_port, i):
    ref, rdiag = fb_reference[1][i]
    got, diag = fb_port[i]
    assert diag["stokes_converged"] and bool(rdiag["stokes_converged"])
    assert "markers_dropped" not in diag
    for k in ("state.vx", "state.vy", "state.p", "state.eta_s",
              "state.eta_n", "state.dt", "state.time", *FLAT_KEYS):
        assert rel(got[k], ref[k]) <= 1e-10, k
    np.testing.assert_array_equal(got["state.markers.mat"],
                                  ref["state.markers.mat"])


def _empty_cells(d):
    """The markers of cells 6-9 x 6-9 moved 4 cells right: 16 empty cells
    for ``reseed_starved`` to fill from the 16 doubled ones."""
    d = dict(d)
    x, y = d["state.markers.x"].copy(), d["state.markers.y"]
    i, j = (x * 16).astype(int), (y * 16).astype(int)
    sel = (i >= 6) & (i <= 9) & (j >= 6) & (j <= 9)
    x[sel] += 4 / 16
    d["state.markers.x"] = x
    return d


def test_flat_heated_reseeded_step_matches_reference():
    """Blankenbach 1a with flat markers: the energy phase's per-stream
    transfers, the marker T update and ``reseed_starved`` in the step."""
    d0, ref = _jax_run(BB, 2, edit=_empty_cells)
    got = _port_run(BB, d0, 2)
    x0, x1 = d0["state.markers.x"], ref[0][0]["state.markers.x"]
    assert np.sum(np.abs(x1 - x0) > 0.1 / 16) >= 16  # reseeding moved them
    for (g, gd), (r, rd) in zip(got, ref):
        assert gd["stokes_converged"]
        assert int(gd["energy_iterations"]) == int(rd["energy_iterations"])
        for k in ("state.vx", "state.vy", "state.p", "state.T", *FLAT_KEYS):
            assert rel(g[k], r[k]) <= 1e-10, k
        np.testing.assert_array_equal(g["state.markers.mat"],
                                      r["state.markers.mat"])


# -- stretched grids (tests/test_stretched.py:320-377) ------------------------

def test_flat_stretched_step_matches_reference():
    d0, ref = _jax_run(STRETCHED, STEPS)
    got = _port_run(STRETCHED, d0, STEPS)
    for (g, gd), (r, rd) in zip(got, ref):
        assert gd["stokes_converged"]
        assert abs(int(gd["stokes_iterations"])
                   - int(rd["stokes_iterations"])) <= 2
        for k in ("state.vx", "state.vy"):
            assert rel(g[k], r[k]) <= 1e-7, k
        for k in ("state.markers.x", "state.markers.y"):
            assert float(np.max(np.abs(g[k] - r[k]))) <= 1e-7, k
    vy, y = got[-1][0]["state.vy"], got[-1][0]["state.markers.y"]
    assert vy.max() > 0 and np.isfinite(vy).all()
    assert (y >= 0).all() and (y <= 1.0).all()


def _cell_markers(grid, material_of, m=2):
    """m x m markers at fixed fractions of every cell (the same physical
    positions for any grid object with the same edges)."""
    frac = (np.arange(m) + 0.5) / m
    xe, ye = grid.x_corner, grid.y_corner
    xs = xe[:-1][None, :, None, None] + frac[None, None, None, :] * np.diff(
        xe)[None, :, None, None]
    ys = ye[:-1][:, None, None, None] + frac[None, None, :, None] * np.diff(
        ye)[:, None, None, None]
    x = np.broadcast_to(xs, (grid.ny, grid.nx, m, m)).ravel()
    y = np.broadcast_to(ys, (grid.ny, grid.nx, m, m)).ravel()
    return MarkerState(x=t(x), y=t(y), mat=t(material_of(x, y)),
                       T=torch.zeros(x.shape, dtype=torch.float64))


def test_flat_uniform_edges_step_equals_uniform_step():
    base = dataclasses.replace(falling_block(nx=16, ny=16, max_steps=2),
                               marker_engine="flat")
    xe = tuple(np.linspace(0.0, 1.0, 17))
    results = []
    for cfg in (base, dataclasses.replace(base, x_edges=xe, y_edges=xe)):
        grid = StaggeredGrid(nx=cfg.nx, ny=cfg.ny, lx=cfg.lx, ly=cfg.ly,
                             x_edges=cfg.x_edges, y_edges=cfg.y_edges)
        table = MaterialTable(cfg.physics.materials)
        state = zero_state(grid, _cell_markers(grid, cfg.material_of),
                           torch.float64, device="cpu")
        step = make_step(grid, cfg, table)
        for _ in range(2):
            state, diag = step(state)
        assert diag["stokes_converged"]
        results.append(state)
    a, b = results
    scale = float(torch.max(torch.abs(a.vy)))
    assert scale > 0
    np.testing.assert_allclose(b.vy.numpy(), a.vy.numpy(), atol=1e-9 * scale)
    np.testing.assert_allclose(b.vx.numpy(), a.vx.numpy(), atol=1e-9 * scale)
    np.testing.assert_allclose(b.markers.x.numpy(), a.markers.x.numpy(),
                               atol=1e-12)


# -- bridge, checkpoints, field dumps -----------------------------------------

def test_flat_checkpoint_both_ways(fb_reference, fb_port, tmp_path):
    """A JAX flat checkpoint loads into the port and a port flat checkpoint
    into the JAX package, every leaf bit for bit."""
    jcfg = jax_config(FB)
    jg, jt, jst = jax_build(jcfg, dtype=jnp.float64)
    grid, table, st = build(FB, dtype=torch.float64, device="cpu")
    # JAX -> port: the reference's state after step 1
    ref = fb_reference[1][0][0]
    jstate = _jax_state(jst, ref)
    jcheckpoint.save_checkpoint(str(tmp_path / "jax.npz"), jstate,
                                extra={"step": 1})
    got, extra = checkpoint.load_checkpoint(str(tmp_path / "jax.npz"), st)
    assert isinstance(got.markers, MarkerState) and int(extra["step"]) == 1
    for k, v in state_to_numpy(got).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    # port -> JAX: the port's state after step 2
    mine = state_from_numpy(fb_port[1][0], device="cpu")
    checkpoint.save_checkpoint(str(tmp_path / "port.npz"), mine)
    back, _ = jcheckpoint.load_checkpoint(str(tmp_path / "port.npz"), jst)
    back = jax_state_dict(back)
    assert sorted(back) == sorted(fb_port[1][0])
    for k, v in fb_port[1][0].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    save_fields(str(tmp_path / "fields.npz"), mine, grid)
    with np.load(tmp_path / "fields.npz") as z:
        np.testing.assert_array_equal(z["marker_x"],
                                      fb_port[1][0]["state.markers.x"])
        assert z["marker_mat"].size == mine.markers.n


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import pylamp_tpu_torch.markers.state, "
            "pylamp_tpu_torch.markers.seed, pylamp_tpu_torch.markers.interp,"
            " pylamp_tpu_torch.markers.advect, "
            "pylamp_tpu_torch.markers.reseed, "
            "pylamp_tpu_torch.solvers.stokes_solver, "
            "pylamp_tpu_torch.models.step, pylamp_tpu_torch.models.setup, "
            "pylamp_tpu_torch.models.validate_blankenbach, "
            "pylamp_tpu_torch.models.validate_van_keken, "
            "pylamp_tpu_torch.models.validate_blankenbach_2a, "
            "pylamp_tpu_torch.models.validate_fk_lid\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'pylamp_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={**os.environ, "PYTHONPATH": REPO})
