"""Port vs reference under periodic side walls: the tensor modules on the CPU.

Same seeded numpy inputs through pylamp_tpu (JAX) and pylamp_tpu_torch, in
f64, at 1e-12 relative (the bar of tests/test_torch_ops.py):

- the Stokes operator and rhs under the half-row seam convention, and
  ``velocity_diagonals``' seam diagonal;
- the four MG transfers (each combination of coarsened axes), the
  periodic pressure gradient, and the transfers' adjointness
  <P c, f> = 4 <c, R f> (tests/test_periodic_stokes.py);
- the periodic thermal operator, rhs and Jacobi diagonal;
- ``_sign`` raising ``ValueError`` on a periodic wall, as the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_tbcs, jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.ops import energy as jenergy
from pylamp_tpu.ops import stokes as jstokes
from pylamp_tpu.solvers import energy_solver as jenergy_solver
from pylamp_tpu.solvers import mg as jmg
from pylamp_tpu.solvers import stokes_solver as jstokes_solver
from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops import energy, stokes
from pylamp_tpu_torch.solvers import energy_solver, mg, stokes_solver

NX, NY, LX, LY = 24, 16, 1.5, 1.0
GRID = StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY)
JGRID = JGrid(nx=NX, ny=NY, lx=LX, ly=LY)
VBCS = {slip: VelocityBCs(top=slip, bottom="free_slip", left="periodic",
                          right="periodic")
        for slip in ("free_slip", "no_slip")}
TBCS = ThermalBCs(left=ThermalBC("periodic"), right=ThermalBC("periodic"))


def _fields(seed):
    """f64 fields in the seam conventions: vx, eta_s and rho_vx equal in
    columns 0 and nx."""
    rng = np.random.default_rng(seed)

    def seam(a):
        a[:, -1] = a[:, 0]
        return a

    return dict(
        vx=seam(rng.standard_normal(GRID.shape_vx)),
        vy=rng.standard_normal(GRID.shape_vy),
        p=rng.standard_normal(GRID.shape_center),
        eta_s=seam(np.exp(rng.standard_normal(GRID.shape_corner))),
        eta_n=np.exp(rng.standard_normal(GRID.shape_center)),
        rho_vx=seam(rng.uniform(1.0, 2.0, GRID.shape_vx)),
        rho_vy=rng.uniform(1.0, 2.0, GRID.shape_vy),
    )


@pytest.mark.parametrize("slip", sorted(VBCS))
def test_stokes_operator_rhs_and_diagonals(slip):
    bcs = VBCS[slip]
    f = _fields(1)
    kcont, kbnd = 3.5, 7.5
    ref = jstokes.stokes_operator(
        *(jnp.asarray(f[k]) for k in ("vx", "vy", "p", "eta_s", "eta_n")),
        JGRID, jax_vbcs(bcs), kcont=kcont, kbnd=kbnd)
    got = stokes.stokes_operator(
        *(t(f[k]) for k in ("vx", "vy", "p", "eta_s", "eta_n")), GRID, bcs,
        kcont=kcont, kbnd=kbnd)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12
    assert torch.equal(got[0][:, 0], got[0][:, -1])  # the seam half row

    ref = jstokes.stokes_rhs(jnp.asarray(f["rho_vx"]), jnp.asarray(f["rho_vy"]),
                             0.3, 1.0, JGRID, jax_vbcs(bcs), kbnd=kbnd,
                             dtype=jnp.float64)
    got = stokes.stokes_rhs(t(f["rho_vx"]), t(f["rho_vy"]), 0.3, 1.0, GRID,
                            bcs, kbnd=kbnd, dtype=torch.float64)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12

    ref = jstokes_solver.velocity_diagonals(
        jnp.asarray(f["eta_s"]), jnp.asarray(f["eta_n"]), JGRID, kbnd,
        bcs=jax_vbcs(bcs))
    got = stokes_solver.velocity_diagonals(t(f["eta_s"]), t(f["eta_n"]),
                                           GRID, kbnd, bcs=bcs)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12
    assert stokes_solver.vx_nullspace(bcs) == (slip == "free_slip")


@pytest.mark.parametrize("cx,cy", [(True, True), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("slip", sorted(VBCS))
def test_mg_transfers(slip, cx, cy):
    """prolong / restrict on both lattices and the seam pressure gradient,
    under full and semi-coarsening."""
    bcs, jbcs = VBCS[slip], jax_vbcs(VBCS[slip])
    rng = np.random.default_rng(2)
    fine = GRID
    coarse = fine.coarsen(cx, cy)
    c_vx = rng.standard_normal(coarse.shape_vx)
    c_vx[:, -1] = c_vx[:, 0]
    f_vx = rng.standard_normal(fine.shape_vx)
    c_vy = rng.standard_normal(coarse.shape_vy)
    f_vy = rng.standard_normal(fine.shape_vy)
    for port_fn, jax_fn, a in ((mg.prolong_vx, jmg.prolong_vx, c_vx),
                               (mg.restrict_vx, jmg.restrict_vx, f_vx),
                               (mg.prolong_vy, jmg.prolong_vy, c_vy),
                               (mg.restrict_vy, jmg.restrict_vy, f_vy)):
        ref = jax_fn(jnp.asarray(a), jbcs, cx=cx, cy=cy)
        got = port_fn(t(a), bcs, cx=cx, cy=cy)
        assert tuple(got.shape) == tuple(ref.shape)
        assert rel(got, ref) <= 1e-12, port_fn.__name__
    zp = rng.standard_normal(fine.shape_center)
    ref = jmg._pressure_gradient(jnp.asarray(zp), JGRID, jnp.float64,
                                 bcs=jbcs)
    got = mg._pressure_gradient(t(zp), GRID, torch.float64, bcs=bcs)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12


@pytest.mark.parametrize("slip", sorted(VBCS))
def test_mg_transfer_adjointness(slip):
    """<P c, f> == 4 <c, R f> in the mixed (solution-like, residual-like)
    pairing of the seam-duplicated vx lattice, and plainly on vy."""
    bcs = VBCS[slip]
    rng = np.random.default_rng(3)
    c = rng.standard_normal((8, 9))
    c[:, -1] = c[:, 0]  # solution-like: equal seam columns
    f = rng.standard_normal((16, 17))
    f[:, 0] = f[:, -1] = 0.5 * f[:, 0]  # residual-like: equal halves
    lhs = float(torch.sum(mg.prolong_vx(t(c), bcs) * t(f)))
    rhs = 4.0 * float(torch.sum(t(c) * mg.restrict_vx(t(f), bcs)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    c2, f2 = rng.standard_normal((9, 8)), rng.standard_normal((17, 16))
    lhs = float(torch.sum(mg.prolong_vy(t(c2), bcs) * t(f2)))
    rhs = 4.0 * float(torch.sum(t(c2) * mg.restrict_vy(t(f2), bcs)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("k_avg", ["arithmetic", "harmonic"])
def test_energy_operator_rhs_and_diagonal(k_avg):
    rng = np.random.default_rng(4)

    def seam(a):
        a[:, -1] = a[:, 0]
        return a

    T = seam(rng.standard_normal(GRID.shape_corner))
    k = seam(np.exp(rng.standard_normal(GRID.shape_corner)))
    rc = seam(np.exp(rng.standard_normal(GRID.shape_corner)))
    H = seam(rng.standard_normal(GRID.shape_corner))
    kbnd = 5.0
    jt = jax_tbcs(TBCS)
    ref = jenergy.energy_operator(jnp.asarray(T), jnp.asarray(k),
                                  jnp.asarray(rc), JGRID, jt, kbnd=kbnd,
                                  k_avg=k_avg)
    got = energy.energy_operator(t(T), t(k), t(rc), GRID, TBCS, kbnd=kbnd,
                                 k_avg=k_avg)
    assert rel(got, ref) <= 1e-12
    ref = jenergy.energy_rhs(jnp.asarray(T), jnp.asarray(k), jnp.asarray(rc),
                             jnp.asarray(H), JGRID, jt, kbnd=kbnd,
                             k_avg=k_avg)
    got = energy.energy_rhs(t(T), t(k), t(rc), t(H), GRID, TBCS, kbnd=kbnd,
                            k_avg=k_avg)
    assert rel(got, ref) <= 1e-12
    ref = jenergy_solver.energy_diagonal(jnp.asarray(k), jnp.asarray(rc),
                                         JGRID, jt, kbnd, k_avg)
    got = energy_solver.energy_diagonal(t(k), t(rc), GRID, TBCS, kbnd, k_avg)
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("wall", ["left", "right"])
def test_periodic_wall_has_no_ghost_sign(wall):
    """As the reference: a periodic wall raises ValueError for its ghost
    sign (every periodic path wraps instead of asking for it)."""
    bcs = VBCS["free_slip"]
    with pytest.raises(ValueError, match="periodic"):
        getattr(bcs, f"s_{wall}")
    assert bcs.s_top == 1.0
    with pytest.raises(ValueError):
        VelocityBCs(left="periodic", right="periodic", vn_left=1.0)
