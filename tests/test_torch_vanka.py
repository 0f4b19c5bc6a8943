"""Port vs reference: the coupled Braess-Sarazin multigrid
(solvers/vanka.py, ``preconditioner="vanka"``).

On the reference's own test problem (tests/test_vanka.py ``_sharp_problem``:
a cell-sharp 1e6 viscosity jump, random buoyancy) at 16^2, f64:

- ``restrict_p`` / ``prolong_p`` exactly equal to the reference's;
- ``momentum_diagonals_bc`` under free and no slip, and one
  ``make_vanka_mg_preconditioner`` apply with two cycles (the second on
  the first's residual) on two levels (the solve below runs one cycle on
  the full hierarchy): 1e-12 relative;
- ``solve_stokes`` with it (restart 60, tol 1e-8, the reference test's
  settings): the first restart cycle ends after the same Krylov count +-2
  as the reference's, both at a true relative residual within 1.5x the
  tolerance (the cycle stops on its Givens estimate; the true residual
  then sits at the rounding floor of the 1e6-contrast solve), and the
  port's full solve converges.  The full solves' totals are not compared:
  the port's first cycle ends at 0.998e-8 and converges (33), while the
  reference's ends at 1.048e-8 or 1.131e-8 (two XLA compilations of the
  same solve), just above the tolerance, and runs a second cycle (44);
- the step refuses ``mg_semicoarsen`` with Vanka (ValueError), as the
  reference's.

The JAX references are computed once per module (one jitted function).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_vanka import _sharp_problem
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.solvers import vanka as jvanka
from pylamp_tpu.solvers.stokes_solver import solve_stokes as j_solve_stokes
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.models.benchmarks import falling_block
from pylamp_tpu_torch.models.step import make_step_phases
from pylamp_tpu_torch.physics.materials import MaterialTable
from pylamp_tpu_torch.solvers import vanka
from pylamp_tpu_torch.solvers.stokes_solver import solve_stokes

N = 16
RESTART = 60
KCONT, KBND = 2.0, 5.0
SLIPS = {slip: VelocityBCs(top=slip, bottom=slip, left=slip, right=slip)
         for slip in ("free_slip", "no_slip")}


def _problem():
    jgrid, _, *arrays = _sharp_problem(nx=N)
    grid = StaggeredGrid(nx=N, ny=N, lx=jgrid.lx, ly=jgrid.ly)
    return grid, jgrid, [np.asarray(a) for a in arrays]


def _residual():
    rng = np.random.default_rng(1)
    grid, _, _ = _problem()
    return (rng.normal(size=grid.shape_vx), rng.normal(size=grid.shape_vy),
            rng.normal(size=grid.shape_center))


@pytest.fixture(scope="module")
def reference():
    grid, jgrid, arrays = _problem()
    r = _residual()

    def run(es, en, rvx, rvy, r):
        out = {}
        for slip, bcs in SLIPS.items():
            out[f"diag_{slip}"] = jvanka.momentum_diagonals_bc(
                es, en, jgrid, jax_vbcs(bcs), KBND)
        out["M"] = jvanka.make_vanka_mg_preconditioner(
            es, en, jgrid, KCONT, KBND, bcs=jax_vbcs(VelocityBCs()),
            levels=2, cycles=2)(r)
        # one restart cycle (maxiter 1 stops after the first cycle)
        sol = j_solve_stokes(
            es, en, rvx, rvy, 0.0, 1.0, jgrid, jax_vbcs(VelocityBCs()),
            tol=1e-8, restart=RESTART, maxiter=1,
            make_preconditioner=partial(jvanka.make_vanka_mg_preconditioner,
                                        cycles=1, pre_smooth=2,
                                        post_smooth=2))
        out["cycle"] = (sol.info.iterations, sol.info.residual,
                        sol.info.bnorm)
        return out

    return jax.jit(run)(*(jnp.asarray(a) for a in arrays),
                        tuple(jnp.asarray(a) for a in r))


def test_pressure_transfers_exact():
    rng = np.random.default_rng(0)
    f, c = rng.normal(size=(16, 24)), rng.normal(size=(8, 12))
    jr, jp = jax.jit(lambda f_, c_: (jvanka.restrict_p(f_),
                                     jvanka.prolong_p(c_)))(
        jnp.asarray(f), jnp.asarray(c))
    np.testing.assert_array_equal(vanka.restrict_p(t(f)).numpy(),
                                  np.asarray(jr))
    np.testing.assert_array_equal(vanka.prolong_p(t(c)).numpy(),
                                  np.asarray(jp))


@pytest.mark.parametrize("slip", list(SLIPS))
def test_momentum_diagonals_bc(reference, slip):
    grid, _, (es, en, _, _) = _problem()
    got = vanka.momentum_diagonals_bc(t(es), t(en), grid, SLIPS[slip], KBND)
    for g, r in zip(got, reference[f"diag_{slip}"]):
        assert rel(g, r) <= 1e-12


def test_preconditioner_apply(reference):
    grid, _, (es, en, _, _) = _problem()
    M = vanka.make_vanka_mg_preconditioner(t(es), t(en), grid, KCONT, KBND,
                                           bcs=VelocityBCs(), levels=2,
                                           cycles=2)
    z = M(tuple(t(a) for a in _residual()))
    for g, r in zip(z, reference["M"]):
        assert rel(g, r) <= 1e-12
    assert abs(float(torch.mean(z[2]))) <= 1e-12 * float(
        torch.max(torch.abs(z[2])))


def test_solve_krylov_count(reference):
    grid, _, arrays = _problem()
    es, en, rvx, rvy = (t(a) for a in arrays)
    mk = partial(vanka.make_vanka_mg_preconditioner, cycles=1, pre_smooth=2,
                 post_smooth=2)

    def solve(maxiter):
        return solve_stokes(es, en, rvx, rvy, 0.0, 1.0, grid, VelocityBCs(),
                            tol=1e-8, restart=RESTART, maxiter=maxiter,
                            make_preconditioner=mk)

    j_it, j_res, j_bnorm = (float(a) for a in reference["cycle"])
    cycle = solve(1).info
    assert abs(cycle.iterations - int(j_it)) <= 2
    assert cycle.residual / cycle.bnorm <= 1.5e-8
    assert j_res / j_bnorm <= 1.5e-8
    full = solve(1500).info
    assert full.converged and full.residual / full.bnorm <= 1e-8


def test_semicoarsen_refused():
    cfg = falling_block(nx=16, ny=16)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, preconditioner="vanka", mg_semicoarsen=2.0))
    grid = StaggeredGrid(nx=16, ny=16, lx=cfg.lx, ly=cfg.ly)
    with pytest.raises(ValueError, match="semicoarsen"):
        make_step_phases(grid, cfg, MaterialTable(cfg.physics.materials))
