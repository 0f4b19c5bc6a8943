"""Port vs reference on stretched grids: the multigrid preconditioners.

One application of each preconditioner to the same seeded f64 residual,
through pylamp_tpu (JAX) and pylamp_tpu_torch, at 1e-12 relative, on a
16x16 unit box with a y axis geometric 8x and an x axis refined in a band,
so that ``mg_semicoarsen = 2`` coarsens y alone first, then both axes:

- the Stokes MG (``make_mg_preconditioner``, one V-cycle of degree 2)
  with each smoother: Chebyshev with power-iteration bounds (the
  reference's choice on non-uniform levels: ``estimate_mg_lambdas`` in
  Gershgorin mode falls back to power iteration there, and those bounds
  are checked too), point Jacobi and the three line smoothers;
- the energy MG with the Chebyshev smoother and each line smoother.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_helpers import jax_tbcs, jax_vbcs, rel, t

from pylamp_tpu.core import grid as jgrid
from pylamp_tpu.solvers import energy_mg as jenergy_mg
from pylamp_tpu.solvers import mg as jmg
from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import (
    StaggeredGrid,
    geometric_edges,
    refined_band_edges,
)
from pylamp_tpu_torch.solvers import energy_mg, mg

N, LX, LY = 16, 1.0, 1.0
XE = refined_band_edges(N, LX, 0.5 * LX, 0.4 * LX, 2.0)
YE = geometric_edges(N, LY, 8.0)
GRID = StaggeredGrid(nx=N, ny=N, lx=LX, ly=LY, x_edges=XE, y_edges=YE)
JGRID = jgrid.StaggeredGrid(nx=N, ny=N, lx=LX, ly=LY, x_edges=XE,
                            y_edges=YE)
VBCS = VelocityBCs(top="no_slip", bottom="free_slip")
SEMI = 2.0
TOL = 1e-12


def _inputs(seed):
    rng = np.random.default_rng(seed)
    eta_s = np.exp(rng.standard_normal(GRID.shape_corner))
    eta_n = np.exp(rng.standard_normal(GRID.shape_center))
    r = tuple(rng.standard_normal(s) for s in
              (GRID.shape_vx, GRID.shape_vy, GRID.shape_center))
    return eta_s, eta_n, r


def test_plan_semicoarsens():
    plan = mg.coarsening_plan(GRID, 0, semi_threshold=SEMI)
    assert plan == jmg.coarsening_plan(JGRID, 0, semi_threshold=SEMI)
    assert plan == [(False, True), (True, True)]


def test_power_lambdas_on_stretched_levels():
    eta_s, eta_n, _ = _inputs(0)
    jv = jax_vbcs(VBCS)
    es, en = jnp.asarray(eta_s), jnp.asarray(eta_n)
    want = jax.jit(lambda es, en: jmg.estimate_mg_lambdas(
        es, en, JGRID, jv, 7.0, semicoarsen=SEMI, mode="gershgorin"))(es, en)
    got = mg.estimate_mg_lambdas(t(eta_s), t(eta_n), GRID, VBCS, 7.0,
                                 semicoarsen=SEMI, mode="gershgorin")
    assert rel(got, want) <= TOL
    hint = np.asarray(want) * 1.2
    want = jax.jit(lambda es, en, h: jmg.estimate_mg_lambdas(
        es, en, JGRID, jv, 7.0, semicoarsen=SEMI, hint=h))(
            es, en, jnp.asarray(hint))
    got = mg.estimate_mg_lambdas(t(eta_s), t(eta_n), GRID, VBCS, 7.0,
                                 semicoarsen=SEMI, hint=t(hint))
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("smoother",
                         ["chebyshev", "jacobi", "line", "line_y", "line_x"])
def test_stokes_mg_preconditioner(smoother):
    eta_s, eta_n, r = _inputs(1)
    kw = dict(cycles=1, pre_smooth=2, post_smooth=2, smoother=smoother,
              omega=0.6, semicoarsen=SEMI)

    @jax.jit
    def apply_ref(es, en, r):
        return jmg.make_mg_preconditioner(
            es, en, JGRID, 3.0, 7.0, bcs=jax_vbcs(VBCS), use_pallas=False,
            use_pallas_smoother=False, use_pallas_coarse=False, **kw)(r)

    want = apply_ref(jnp.asarray(eta_s), jnp.asarray(eta_n),
                     tuple(jnp.asarray(a) for a in r))
    M = mg.make_mg_preconditioner(t(eta_s), t(eta_n), GRID, 3.0, 7.0,
                                  bcs=VBCS, **kw)
    got = M(tuple(t(a) for a in r))
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("smoother", ["chebyshev", "line", "line_y",
                                      "line_x"])
def test_energy_mg_preconditioner(smoother):
    rng = np.random.default_rng(2)
    k = np.exp(rng.standard_normal(GRID.shape_corner))
    rc = np.exp(rng.standard_normal(GRID.shape_corner))
    r = rng.standard_normal(GRID.shape_corner)
    tb = ThermalBCs(top=ThermalBC("dirichlet", 0.0),
                    bottom=ThermalBC("dirichlet", 1.0))
    kw = dict(smoother=smoother, omega=0.7, semicoarsen=SEMI)
    want = jax.jit(lambda k, rc, r: jenergy_mg.make_energy_mg_preconditioner(
        k, rc, JGRID, jax_tbcs(tb), 40.0, **kw)(r))(
            jnp.asarray(k), jnp.asarray(rc), jnp.asarray(r))
    got = energy_mg.make_energy_mg_preconditioner(
        t(k), t(rc), GRID, tb, 40.0, **kw)(t(r))
    assert rel(got, want) <= TOL
