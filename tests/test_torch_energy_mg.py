"""Port vs reference: the energy multigrid and flexible CG, f64 on the CPU.

- ``krylov.fcg`` against the JAX package's ``fcg`` on one seeded SPD
  problem with a Jacobi preconditioner: the same iterates within 1e-12
  and the same iteration count;
- the corner-lattice transfers (``prolong_corner``, ``restrict_corner``,
  walls, periodic seam columns, one semi-coarsened axis): within 1e-14;
- ``solve_energy(..., preconditioner="mg")`` against the reference's on
  the problem of tests/test_energy_mg.py at 32^2 (variable conductivity, a
  non-conductive start, diffusion dominated), walls and periodic side
  walls: T within 1e-8, iterations +-1;
- ``solve_energy_mixed`` with the multigrid (f32 inner FCG under f64
  refinement, the card's path) converges to the f64 solution within 1e-8;
- the multigrid beats Jacobi on iterations at 64^2;
- the line smoothers: one V-cycle of each against the reference's;
- the sharded layout: one V-cycle on the blocks of the in-process 4x2 mesh
  (levels 32^2 to 8^2 in block form, 4^2 and 2^2 replicated) from a
  seeded residual against the reference's and the port's global V-cycle,
  within 1e-12 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_tbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.solvers import energy_mg as jemg
from pylamp_tpu.solvers import krylov as jkrylov
from pylamp_tpu.solvers.energy_solver import solve_energy as jsolve_energy
from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.solvers import energy_mg, krylov
from pylamp_tpu_torch.solvers.energy_solver import (
    solve_energy,
    solve_energy_mixed,
)

BCS = {
    "wall": ThermalBCs(top=ThermalBC("dirichlet", 0.0),
                       bottom=ThermalBC("dirichlet", 1.0),
                       left=ThermalBC("neumann", 0.0),
                       right=ThermalBC("neumann", 0.0)),
    "periodic": ThermalBCs(top=ThermalBC("dirichlet", 0.0),
                           bottom=ThermalBC("dirichlet", 1.0),
                           left=ThermalBC("periodic", 0.0),
                           right=ThermalBC("periodic", 0.0)),
}


def test_fcg_matches_reference():
    rng = np.random.default_rng(0)
    n = 40
    a = rng.standard_normal((n, n))
    A = a @ a.T + n * np.eye(n)  # SPD
    b = rng.standard_normal(n)
    d = np.diag(A)
    x, info = krylov.fcg(lambda v: t(A) @ v, t(b),
                         torch.zeros(n, dtype=torch.float64),
                         M=lambda r: r / t(d), tol=1e-10)
    jx, jinfo = jax.jit(lambda bb: jkrylov.fcg(
        lambda v: jnp.asarray(A) @ v, bb, jnp.zeros(n),
        M=lambda r: r / jnp.asarray(d), tol=1e-10))(jnp.asarray(b))
    assert info.converged and bool(jinfo.converged)
    assert info.iterations == int(jinfo.iterations)
    assert rel(x, jx) <= 1e-12
    np.testing.assert_allclose(A @ x.numpy(), b, atol=1e-8)


@pytest.mark.parametrize("periodic_x", [False, True])
@pytest.mark.parametrize("cx,cy", [(True, True), (True, False),
                                   (False, True)])
def test_corner_transfers_match_reference(periodic_x, cx, cy):
    rng = np.random.default_rng(1)
    coarse = rng.standard_normal((9 if cy else 17, 9 if cx else 17))
    fine = rng.standard_normal((17, 17))
    got = energy_mg.prolong_corner(t(coarse), cx=cx, cy=cy)
    ref = jemg.prolong_corner(jnp.asarray(coarse), cx=cx, cy=cy)
    assert got.shape == ref.shape and rel(got, ref) <= 1e-14
    got = energy_mg.restrict_corner(t(fine), periodic_x, cx=cx, cy=cy)
    ref = jemg.restrict_corner(jnp.asarray(fine), periodic_x, cx=cx, cy=cy)
    assert got.shape == ref.shape and rel(got, ref) <= 1e-14


def _problem(n):
    """tests/test_energy_mg.py's problem: k with a x4 Gaussian contrast, a
    non-conductive start (periodic in x), rho*Cp/dt = 1e-3 (diffusion
    dominated)."""
    grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
    ny1, nx1 = grid.shape_corner
    y = np.linspace(0.0, 1.0, ny1)[:, None]
    x = np.linspace(0.0, 1.0, nx1)[None, :]
    k = 1.0 + 3.0 * np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.05)
    T0 = y + 0.3 * np.sin(2 * np.pi * x) * np.sin(np.pi * y)
    rc = np.full_like(T0, 1e-3)
    return grid, k, T0, rc, np.zeros_like(T0)


@pytest.mark.parametrize("walls", ["wall", "periodic"])
def test_solve_energy_mg_matches_reference(walls):
    bcs = BCS[walls]
    grid, k, T0, rc, H = _problem(32)
    jgrid = JGrid(nx=32, ny=32, lx=1.0, ly=1.0)
    ref = jax.jit(lambda *a: jsolve_energy(
        *a, jgrid, jax_tbcs(bcs), tol=1e-10, preconditioner="mg"))(
        *(jnp.asarray(a) for a in (T0, k, rc, H)))
    got = solve_energy(t(T0), t(k), t(rc), t(H), grid, bcs, tol=1e-10,
                       preconditioner="mg")
    assert got.info.converged and bool(ref.info.converged)
    assert abs(got.info.iterations - int(ref.info.iterations)) <= 1
    assert float(np.max(np.abs(got.T.numpy() - np.asarray(ref.T)))) <= 1e-8
    # the f32 inner FCG under f64 refinement reaches the same solution
    mixed = solve_energy_mixed(t(T0).float(), t(k).float(), t(rc).float(),
                               t(H).float(), grid, bcs, tol=1e-10,
                               preconditioner="mg")
    assert mixed.info.converged
    assert float(torch.max(torch.abs(mixed.T - got.T))) <= 1e-8


def test_mg_beats_jacobi():
    bcs = BCS["wall"]
    grid, k, T0, rc, H = _problem(64)
    args = [t(a) for a in (T0, k, rc, H)]
    jac = solve_energy(*args, grid, bcs, tol=1e-10)
    mg = solve_energy(*args, grid, bcs, tol=1e-10, preconditioner="mg")
    assert jac.info.converged and mg.info.converged
    assert mg.info.iterations < 0.5 * jac.info.iterations, (
        mg.info.iterations, jac.info.iterations)
    assert float(torch.max(torch.abs(mg.T - jac.T))) <= 1e-8


def test_line_smoothers_wait():
    """The line smoothers (once refused until solvers/lines.py was
    ported): one V-cycle of each against the reference's on the uniform
    wall problem, within 1e-12; x lines refuse periodic side walls, as the
    reference's do."""
    bcs = BCS["wall"]
    grid, k, T0, rc, H = _problem(16)
    jgrid = JGrid(nx=16, ny=16, lx=1.0, ly=1.0)
    r = np.sin(3.0 * T0) + 0.1
    for smoother in ("line", "line_y", "line_x"):
        got = energy_mg.make_energy_mg_preconditioner(
            t(k), t(rc), grid, bcs, 1.0, smoother=smoother)(t(r))
        ref = jax.jit(lambda k, rc, r: jemg.make_energy_mg_preconditioner(
            k, rc, jgrid, jax_tbcs(bcs), 1.0, smoother=smoother)(r))(
                jnp.asarray(k), jnp.asarray(rc), jnp.asarray(r))
        assert rel(got, ref) <= 1e-12
    for smoother in ("line", "line_x"):
        with pytest.raises(ValueError, match="periodic"):
            energy_mg.make_energy_mg_preconditioner(
                t(k), t(rc), grid, BCS["periodic"], 1.0, smoother=smoother)


def test_sharded_vcycle_matches_reference():
    from pylamp_tpu_torch.parallel.blocks import Blocks
    from pylamp_tpu_torch.parallel.mesh import Mesh

    bcs = BCS["wall"]
    grid, k, T0, rc, H = _problem(32)
    jgrid = JGrid(nx=32, ny=32, lx=1.0, ly=1.0)
    rc = rc + 40.0 * T0  # a variable rho*Cp/dt
    r = np.random.default_rng(20).standard_normal(k.shape)
    mesh = Mesh(4, 2)

    def sh(a):
        return Blocks.split(t(a), "corner", mesh)

    got = energy_mg.make_energy_mg_preconditioner(
        sh(k), sh(rc), grid, bcs, 2.5, halo_mesh=mesh)(sh(r))
    assert isinstance(got, Blocks)
    got = got.gather()
    glob = energy_mg.make_energy_mg_preconditioner(
        t(k), t(rc), grid, bcs, 2.5)(t(r))
    ref = jax.jit(lambda k, rc, r: jemg.make_energy_mg_preconditioner(
        k, rc, jgrid, jax_tbcs(bcs), 2.5)(r))(
            jnp.asarray(k), jnp.asarray(rc), jnp.asarray(r))
    assert rel(got, ref) <= 1e-12
    assert rel(got, glob) <= 1e-12
    assert rel(glob, ref) <= 1e-12
