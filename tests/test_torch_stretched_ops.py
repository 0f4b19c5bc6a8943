"""Port vs reference on stretched grids: the grid, the operators and the
line solves on the CPU.

Same seeded numpy inputs through pylamp_tpu (JAX) and pylamp_tpu_torch, in
f64, on grids whose x edges are geometric (3x) and y edges refined in a
band (4x), as tests/test_stretched.py builds them:

- the grid: edges, spacings, coordinates and ``coarsen`` (each axis
  alone and both) exactly equal, validation errors as the reference's;
- the Stokes operator, rhs (moving no-slip walls), velocity diagonals,
  pressure gradient, shear stress and strain-rate invariant, and the
  energy operator, rhs (Neumann fluxes) and diagonal, at 1e-12 relative;
- ``tridiag_pcr``, ``momentum_line_coeffs`` and ``stencil_line_coeffs``
  on both axes at 1e-12, and the line coefficients refusing periodic
  walls.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_tbcs, jax_vbcs, rel, t

from pylamp_tpu.core import grid as jgrid
from pylamp_tpu.ops import energy as jenergy
from pylamp_tpu.ops import stokes as jstokes
from pylamp_tpu.solvers import energy_solver as jenergy_solver
from pylamp_tpu.solvers import lines as jlines
from pylamp_tpu.solvers import mg as jmg
from pylamp_tpu.solvers import stokes_solver as jstokes_solver
from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import (
    StaggeredGrid,
    geometric_edges,
    refined_band_edges,
)
from pylamp_tpu_torch.ops import energy, stokes
from pylamp_tpu_torch.solvers import energy_solver, lines, mg, stokes_solver

NX, NY, LX, LY = 20, 16, 1.7, 0.9
XE = geometric_edges(NX, LX, 3.0)
YE = refined_band_edges(NY, LY, 0.3 * LY, 0.3 * LY, 4.0)
GRID = StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY, x_edges=XE, y_edges=YE)
JGRID = jgrid.StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY, x_edges=XE,
                            y_edges=YE)
VBCS = VelocityBCs(top="no_slip", bottom="free_slip", left="no_slip",
                   right="free_slip", vt_top=0.7, vt_left=-0.4)
TOL = 1e-12


def _fields(seed, grid=GRID):
    rng = np.random.default_rng(seed)
    return dict(
        vx=rng.standard_normal(grid.shape_vx),
        vy=rng.standard_normal(grid.shape_vy),
        p=rng.standard_normal(grid.shape_center),
        eta_s=np.exp(rng.standard_normal(grid.shape_corner)),
        eta_n=np.exp(rng.standard_normal(grid.shape_center)),
        rho_vx=rng.uniform(1.0, 2.0, grid.shape_vx),
        rho_vy=rng.uniform(1.0, 2.0, grid.shape_vy),
        T=rng.standard_normal(grid.shape_corner),
        k=np.exp(rng.standard_normal(grid.shape_corner)),
        rc=np.exp(rng.standard_normal(grid.shape_corner)),
        H=rng.standard_normal(grid.shape_corner),
    )


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        assert rel(g, w) <= tol


def test_grid_matches_reference():
    for a, b in ((GRID.dxs, JGRID.dxs), (GRID.dys, JGRID.dys),
                 (GRID.x_center, JGRID.x_center),
                 (GRID.y_center, JGRID.y_center)):
        np.testing.assert_array_equal(a, b)
    assert (GRID.dx_min, GRID.dy_min) == (JGRID.dx_min, JGRID.dy_min)
    assert not GRID.uniform
    for loc in ("corner", "center", "vx", "vy"):
        for a, b in zip(GRID.coords(loc), JGRID.coords(loc)):
            np.testing.assert_array_equal(a, b)
    for cx, cy in ((True, True), (True, False), (False, True)):
        g, jg = GRID.coarsen(cx, cy), JGRID.coarsen(cx, cy)
        assert (g.nx, g.ny, g.x_edges, g.y_edges) == (
            jg.nx, jg.ny, jg.x_edges, jg.y_edges)
        assert GRID.coarsen(cx, cy) is g  # one instance per axes
    with pytest.raises(ValueError):
        GRID.dx
    with pytest.raises(ValueError):
        StaggeredGrid(nx=4, ny=4, lx=1.0, ly=1.0,
                      x_edges=(0, 0.5, 0.4, 0.8, 1.0))
    with pytest.raises(ValueError):
        StaggeredGrid(nx=4, ny=4, lx=1.0, ly=1.0, y_edges=(0, 0.5, 1.0))
    u = StaggeredGrid(nx=4, ny=4, lx=1.0, ly=1.0)
    assert u.uniform and u.dx == 0.25 and u.dx_min == 0.25
    assert geometric_edges(9, 2.0, 5.0) == jgrid.geometric_edges(9, 2.0, 5.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_stokes_operator_rhs_diagonals(seed):
    f = _fields(seed)
    jv = jax_vbcs(VBCS)
    want = jstokes.stokes_operator(
        jnp.asarray(f["vx"]), jnp.asarray(f["vy"]), jnp.asarray(f["p"]),
        jnp.asarray(f["eta_s"]), jnp.asarray(f["eta_n"]), JGRID, jv,
        kcont=3.0, kbnd=9.0)
    got = stokes.stokes_operator(t(f["vx"]), t(f["vy"]), t(f["p"]),
                                 t(f["eta_s"]), t(f["eta_n"]), GRID, VBCS,
                                 kcont=3.0, kbnd=9.0)
    _close(got, want)
    want = jstokes.stokes_rhs(
        jnp.asarray(f["rho_vx"]), jnp.asarray(f["rho_vy"]), 0.3, 1.0, JGRID,
        jv, kbnd=9.0, dtype=jnp.float64, eta_s=jnp.asarray(f["eta_s"]))
    got = stokes.stokes_rhs(t(f["rho_vx"]), t(f["rho_vy"]), 0.3, 1.0, GRID,
                            VBCS, kbnd=9.0, dtype=torch.float64,
                            eta_s=t(f["eta_s"]))
    _close(got, want)
    want = jstokes_solver.velocity_diagonals(
        jnp.asarray(f["eta_s"]), jnp.asarray(f["eta_n"]), JGRID, 9.0, bcs=jv)
    got = stokes_solver.velocity_diagonals(t(f["eta_s"]), t(f["eta_n"]),
                                           GRID, 9.0, bcs=VBCS)
    _close(got, want)
    want = jmg._pressure_gradient(jnp.asarray(f["p"]), JGRID, jnp.float64,
                                  bcs=jv)
    got = mg._pressure_gradient(t(f["p"]), GRID, torch.float64, bcs=VBCS)
    _close(got, want)
    # the shear stress and the strain-rate invariant (shear heating)
    from pylamp_tpu.ops.stretched import shear_stress_xy_stretched as jsxy

    from pylamp_tpu_torch.ops.stretched import shear_stress_xy_stretched

    want = jsxy(jnp.asarray(f["vx"]), jnp.asarray(f["vy"]),
                jnp.asarray(f["eta_s"]), JGRID, jv)
    got = shear_stress_xy_stretched(t(f["vx"]), t(f["vy"]), t(f["eta_s"]),
                                    GRID, VBCS)
    assert rel(got, want) <= TOL
    want = jstokes.strain_rate_ii(jnp.asarray(f["vx"]), jnp.asarray(f["vy"]),
                                  JGRID, jv)
    got = stokes.strain_rate_ii(t(f["vx"]), t(f["vy"]), GRID, VBCS)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("k_avg", ["arithmetic", "harmonic"])
@pytest.mark.parametrize("top_kind", ["dirichlet", "neumann"])
def test_energy_operator_rhs_diagonal(k_avg, top_kind):
    f = _fields(2)
    tb = ThermalBCs(top=ThermalBC(top_kind, 0.5 if top_kind == "neumann"
                                  else 0.0),
                    bottom=ThermalBC("dirichlet", 1.0),
                    left=ThermalBC("neumann", 0.2),
                    right=ThermalBC("neumann", -0.3))
    jt = jax_tbcs(tb)
    j = {k: jnp.asarray(f[k]) for k in ("T", "k", "rc", "H")}
    want = jenergy.energy_operator(j["T"], j["k"], j["rc"], JGRID, jt,
                                   kbnd=5.0, k_avg=k_avg)
    got = energy.energy_operator(t(f["T"]), t(f["k"]), t(f["rc"]), GRID, tb,
                                 kbnd=5.0, k_avg=k_avg)
    assert rel(got, want) <= TOL
    want = jenergy.energy_rhs(j["T"], j["k"], j["rc"], j["H"], JGRID, jt,
                              kbnd=5.0, k_avg=k_avg)
    got = energy.energy_rhs(t(f["T"]), t(f["k"]), t(f["rc"]), t(f["H"]),
                            GRID, tb, kbnd=5.0, k_avg=k_avg)
    assert rel(got, want) <= TOL
    want = jenergy_solver.energy_diagonal(j["k"], j["rc"], JGRID, jt, 5.0,
                                          k_avg)
    got = energy_solver.energy_diagonal(t(f["k"]), t(f["rc"]), GRID, tb, 5.0,
                                        k_avg)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("n", [1, 2, 7, 33])
@pytest.mark.parametrize("axis", [0, 1])
def test_tridiag_pcr(n, axis):
    rng = np.random.default_rng(n)
    shape = (n, 5) if axis == 0 else (5, n)
    a, c, d = (rng.standard_normal(shape) for _ in range(3))
    b = np.abs(a) + np.abs(c) + rng.uniform(0.5, 1.5, shape)
    want = jlines.tridiag_pcr(*(jnp.asarray(v) for v in (a, b, c, d)),
                              axis=axis)
    got = lines.tridiag_pcr(t(a), t(b), t(c), t(d), axis=axis)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_line_coeffs(stretched, axis):
    """The momentum-stencil line coefficients, and the energy operator's
    probe-extracted ones."""
    grid, jg = (GRID, JGRID) if stretched else (
        StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY),
        jgrid.StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY))
    f = _fields(3, grid)
    want = jlines.momentum_line_coeffs(
        jnp.asarray(f["eta_s"]), jnp.asarray(f["eta_n"]), jg,
        jax_vbcs(VBCS), axis)
    got = lines.momentum_line_coeffs(t(f["eta_s"]), t(f["eta_n"]), grid,
                                     VBCS, axis)
    _close(got, want)
    tb = ThermalBCs(top=ThermalBC("dirichlet", 0.0),
                    bottom=ThermalBC("dirichlet", 1.0))
    jt = jax_tbcs(tb)
    want = jlines.stencil_line_coeffs(
        lambda v: jenergy.energy_operator(v, jnp.asarray(f["k"]),
                                          jnp.asarray(f["rc"]), jg, jt,
                                          kbnd=5.0),
        grid.shape_corner, axis, jnp.float64)
    got = lines.stencil_line_coeffs(
        lambda v: energy.energy_operator(v, t(f["k"]), t(f["rc"]), grid, tb,
                                         kbnd=5.0),
        grid.shape_corner, axis, torch.float64, "cpu")
    _close(got, want)


def test_line_smoother_rejects_periodic():
    grid = StaggeredGrid(nx=8, ny=8, lx=1.0, ly=1.0)
    with pytest.raises(ValueError, match="periodic"):
        lines.momentum_line_coeffs(
            torch.ones(grid.shape_corner), torch.ones(grid.shape_center),
            grid, VelocityBCs(left="periodic", right="periodic"), 0)
