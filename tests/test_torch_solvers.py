"""Port vs reference: the velocity multigrid, the Stokes FGMRES solve and
the energy CG solve, f64 on the CPU.

Inputs: the FK stagnant-lid state at 32^2 (the port's ``build`` seeds it
with numpy exactly like the reference) with the bench solver preset
(restart 12, 2 V-cycles, degree-4 Chebyshev).  One V-cycle and the full
block preconditioner agree with the reference to 1e-12 relative; the
solves take the same iteration counts (+-1) and agree to well inside
their tolerance.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_tbcs, jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.solvers import energy_solver as jenergy
from pylamp_tpu.solvers import mg as jmg
from pylamp_tpu.solvers import scaling as jscaling
from pylamp_tpu.solvers import stokes_solver as jstokes
from pylamp_tpu_torch.models.benchmarks import fk_bench_config
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.solvers import energy_solver, mg, scaling, stokes_solver

N = 32
CFG = fk_bench_config(N)
VBC = CFG.physics.velocity_bcs
SEMI = CFG.solver.mg_semicoarsen
JGRID = JGrid(nx=N, ny=N, lx=1.0, ly=1.0)
MG_KW = dict(pre_smooth=4, post_smooth=4, semicoarsen=SEMI)
JMG_KW = dict(MG_KW, use_pallas=False, use_pallas_smoother=False,
              use_pallas_coarse=False)


@pytest.fixture(scope="module")
def fk():
    """(grid, eta_s, eta_n, T, rho_vy) as numpy, from the port's f64 build."""
    grid, _, st = build(CFG, dtype=torch.float64, device="cpu")
    T = st.T.numpy()
    rho_vy = 100.0 * (1.0 - 0.5 * (T[:, :-1] + T[:, 1:]))
    return grid, st.eta_s.numpy(), st.eta_n.numpy(), T, rho_vy


@jax.jit
def _jax_lams(eta_s, eta_n):
    _, jkbnd = jscaling.stokes_scales(
        jscaling.characteristic_viscosity(eta_n), JGRID)
    return jkbnd, jmg.estimate_mg_lambdas(eta_s, eta_n, JGRID, jax_vbcs(VBC),
                                          jkbnd, semicoarsen=SEMI,
                                          mode="gershgorin")


def _lams(eta_s, eta_n, grid):
    _, kbnd = scaling.stokes_scales(
        scaling.characteristic_viscosity(t(eta_n)), grid)
    lam = mg.estimate_mg_lambdas(t(eta_s), t(eta_n), grid, VBC, kbnd,
                                 semicoarsen=SEMI, mode="gershgorin")
    return (kbnd, lam), _jax_lams(jnp.asarray(eta_s), jnp.asarray(eta_n))


def test_coarsening_plan_levels(fk):
    grid = fk[0]
    plan = mg.coarsening_plan(grid, 0, semi_threshold=SEMI)
    assert plan == jmg.coarsening_plan(JGRID, 0, semi_threshold=SEMI)
    assert len(plan) + 1 == 4  # 32 -> 16 -> 8 -> 4


def test_gershgorin_lambdas(fk):
    grid, eta_s, eta_n, _, _ = fk
    (_, lam), (_, jlam) = _lams(eta_s, eta_n, grid)
    assert rel(lam, jlam) <= 1e-13


@pytest.mark.parametrize("emit", [False, True])
def test_vcycle_f64(fk, emit):
    """One V-cycle of the velocity MG (+ its emitted residual)."""
    grid, eta_s, eta_n, _, _ = fk
    (kbnd, lam), (jkbnd, jlam) = _lams(eta_s, eta_n, grid)
    rng = np.random.default_rng(11)
    rx = rng.standard_normal(grid.shape_vx)
    ry = rng.standard_normal(grid.shape_vy)
    jcycle = jmg.make_velocity_mg(jnp.asarray(eta_s), jnp.asarray(eta_n),
                                  JGRID, jax_vbcs(VBC), jkbnd, lam_max=jlam,
                                  **JMG_KW)
    ref = jax.jit(partial(jcycle, emit=emit))(jnp.asarray(rx), jnp.asarray(ry))
    cycle = mg.make_velocity_mg(t(eta_s), t(eta_n), grid, VBC, kbnd,
                                lam_max=lam, **MG_KW)
    got = cycle(t(rx), t(ry), emit=emit)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12


def test_block_preconditioner_f64(fk):
    """M(r) of the full system: mass Schur + 2 V-cycles."""
    grid, eta_s, eta_n, _, _ = fk
    (kbnd, lam), (jkbnd, jlam) = _lams(eta_s, eta_n, grid)
    kcont, _ = scaling.stokes_scales(
        scaling.characteristic_viscosity(t(eta_n)), grid)
    jkcont, _ = jscaling.stokes_scales(
        jscaling.characteristic_viscosity(jnp.asarray(eta_n)), JGRID)
    rng = np.random.default_rng(12)
    r = [rng.standard_normal(s) for s in (grid.shape_vx, grid.shape_vy,
                                          grid.shape_center)]
    jM = jmg.make_mg_preconditioner(jnp.asarray(eta_s), jnp.asarray(eta_n),
                                    JGRID, jkcont, jkbnd, bcs=jax_vbcs(VBC),
                                    cycles=2, lam_max=jlam, **JMG_KW)
    ref = jax.jit(jM)(tuple(jnp.asarray(a) for a in r))
    M = mg.make_mg_preconditioner(t(eta_s), t(eta_n), grid, kcont, kbnd,
                                  bcs=VBC, cycles=2, lam_max=lam, **MG_KW)
    got = M(tuple(t(a) for a in r))
    for g, rr in zip(got, ref):
        assert rel(g, rr) <= 1e-12


def test_solve_stokes_f64(fk):
    """The bench-preset FGMRES(12) + MG solve at 32^2 FK: same Krylov count
    (+-1), converged to 1e-8, solutions within 1e-6 relative."""
    grid, eta_s, eta_n, _, rho_vy = fk
    (_, lam), (_, jlam) = _lams(eta_s, eta_n, grid)
    rho_vx = np.zeros(grid.shape_vx)
    jmk = partial(jmg.make_mg_preconditioner, cycles=2, lam_max=jlam,
                  **JMG_KW)
    jsolve = jax.jit(lambda es, en, rx, ry: jstokes.solve_stokes(
        es, en, rx, ry, 0.0, 1.0, JGRID, jax_vbcs(VBC), tol=1e-8, restart=12,
        maxiter=250, make_preconditioner=jmk))
    ref = jsolve(*(jnp.asarray(a) for a in (eta_s, eta_n, rho_vx, rho_vy)))
    mk = partial(mg.make_mg_preconditioner, cycles=2, lam_max=lam, **MG_KW)
    got = stokes_solver.solve_stokes(
        t(eta_s), t(eta_n), t(rho_vx), t(rho_vy), 0.0, 1.0, grid, VBC,
        tol=1e-8, restart=12, maxiter=250, make_preconditioner=mk)
    assert got.info.converged and bool(ref.info.converged)
    assert abs(got.info.iterations - int(ref.info.iterations)) <= 1
    vmax = float(jnp.max(jnp.abs(ref.vx)))
    for g, r in ((got.vx, ref.vx), (got.vy, ref.vy)):
        assert float(np.max(np.abs(g.numpy() - np.asarray(r)))) <= 1e-6 * vmax
    assert rel(got.p, ref.p) <= 1e-6


def test_solve_energy_f64(fk):
    """Jacobi-CG energy solve: same iteration count, T within 1e-10."""
    grid, _, _, T, _ = fk
    tbc = CFG.physics.thermal_bcs
    k = np.ones(grid.shape_corner)
    rc = np.full(grid.shape_corner, 0.01 / 5e-4)
    H = np.zeros(grid.shape_corner)
    ref = jax.jit(lambda *a: jenergy.solve_energy(
        *a, JGRID, jax_tbcs(tbc), tol=1e-10, maxiter=2000))(
        *(jnp.asarray(a) for a in (T, k, rc, H)))
    got = energy_solver.solve_energy(t(T), t(k), t(rc), t(H), grid, tbc,
                                     tol=1e-10, maxiter=2000)
    assert got.info.iterations == int(ref.info.iterations)
    assert rel(got.T, ref.T) <= 1e-10
