"""Port vs reference: the heating terms of the energy equation
(``physics/heating.py``) and the strain-rate invariant they use
(``ops/stokes.py strain_rate_ii``), in f64 on the CPU.

Seeded numpy velocities, viscosities, temperatures and rho0*alpha fields
on a 24x16 grid go through both packages under free-slip, no-slip and
periodic side walls: every output within 1e-12 max|err| / max|ref|.  The
reference's two analytic cases are mirrored: simple shear vx = y gives
H_s = eta in the interior, and downward flow at T > 0 heats by
rho0 alpha T g vy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.ops.stokes import strain_rate_ii as jstrain_rate_ii
from pylamp_tpu.physics import heating as jheating
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.stokes import strain_rate_ii
from pylamp_tpu_torch.physics.heating import (
    adiabatic_heating,
    shear_heating,
)

NX, NY = 24, 16
GRID = StaggeredGrid(nx=NX, ny=NY, lx=1.5, ly=1.0)
JGRID = JGrid(nx=NX, ny=NY, lx=1.5, ly=1.0)
BCS = {
    "free_slip": VelocityBCs(),
    "no_slip": VelocityBCs(top="no_slip", bottom="no_slip", left="no_slip",
                           right="no_slip"),
    "periodic": VelocityBCs(left="periodic", right="periodic"),
}


def _fields(seed, periodic):
    rng = np.random.default_rng(seed)
    vx = rng.standard_normal(GRID.shape_vx)
    if periodic:
        vx[:, -1] = vx[:, 0]  # one seam node
    vy = rng.standard_normal(GRID.shape_vy)
    eta_n = np.exp(rng.standard_normal(GRID.shape_center))
    T = rng.uniform(0.0, 1.0, GRID.shape_corner)
    ra = rng.uniform(1.0, 5.0, GRID.shape_corner)
    return vx, vy, eta_n, T, ra


@pytest.mark.parametrize("walls", sorted(BCS))
def test_heating_matches_reference(walls):
    bcs = BCS[walls]
    jbcs = jax_vbcs(bcs)
    vx, vy, eta_n, T, ra = _fields(7, walls == "periodic")
    got = strain_rate_ii(t(vx), t(vy), GRID, bcs)
    ref = jstrain_rate_ii(jnp.asarray(vx), jnp.asarray(vy), JGRID, jbcs)
    assert got.shape == GRID.shape_center
    assert rel(got, ref) <= 1e-12
    got = shear_heating(t(vx), t(vy), t(eta_n), GRID, bcs)
    ref = jheating.shear_heating(jnp.asarray(vx), jnp.asarray(vy),
                                 jnp.asarray(eta_n), JGRID, jbcs)
    assert got.shape == GRID.shape_corner
    assert rel(got, ref) <= 1e-12
    got = adiabatic_heating(t(T), t(ra), t(vy), 9.81, GRID)
    ref = jheating.adiabatic_heating(jnp.asarray(T), jnp.asarray(ra),
                                     jnp.asarray(vy), 9.81, JGRID)
    assert got.shape == GRID.shape_corner
    assert rel(got, ref) <= 1e-12


def test_shear_heating_uniform_shear():
    """vx = y (simple shear): e_xy = 1/2, e_xx = 0 -> H_s = 4 eta / 4 =
    eta in the interior (the free-slip ghosts flatten the gradient at the
    walls)."""
    grid = StaggeredGrid(nx=8, ny=8, lx=1.0, ly=1.0)
    y = (torch.arange(grid.ny, dtype=torch.float64) + 0.5) * grid.dy
    vx = y[:, None].expand(grid.shape_vx).clone()
    vy = torch.zeros(grid.shape_vy, dtype=torch.float64)
    eta_n = torch.full(grid.shape_center, 3.0, dtype=torch.float64)
    hs = shear_heating(vx, vy, eta_n, grid, VelocityBCs()).numpy()
    np.testing.assert_allclose(hs[2:-2, 2:-2], 3.0, rtol=1e-10)


def test_adiabatic_heating_sign():
    """Downward motion (vy > 0, y down) with T > 0 heats."""
    grid = StaggeredGrid(nx=6, ny=6, lx=1.0, ly=1.0)
    T = torch.full(grid.shape_corner, 2.0, dtype=torch.float64)
    ra = torch.full(grid.shape_corner, 5.0, dtype=torch.float64)
    vy = torch.full(grid.shape_vy, 0.1, dtype=torch.float64)
    ha = adiabatic_heating(T, ra, vy, 9.81, grid).numpy()
    np.testing.assert_allclose(ha, 5.0 * 2.0 * 9.81 * 0.1, rtol=1e-12)
