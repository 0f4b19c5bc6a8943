"""Port vs reference: the weighted-BFBT Schur surrogate (solvers/bfbt.py).

- the cell-centred transfers: prolongation and 4x restriction adjoint to
  1e-12, constants preserved exactly both ways (the reference's
  tests/test_bfbt.py), and both equal to the reference's to 1e-15;
- the pressure Poisson operator: the constant nullspace exactly, SPSD,
  symmetric to 1e-9 (the reference's bars), its apply and diagonal equal
  to the reference's to 1e-12;
- ``make_pressure_poisson_mg`` and ``make_bfbt_schur`` on the reference's
  sharp three-layer sticky-air field at 32x16: 1e-12 relative in f64; in
  f32 within 5e-4 of the reference's f64 result (max |diff| over max |ref|,
  the bar the reference's tests/test_bfbt.py holds its own f32 form to);
- one ``make_mg_preconditioner(schur="wbfbt")`` apply on that field (a
  two-level velocity V-cycle with the Chebyshev bounds given), against
  the reference's: 1e-12 relative in f64.  Its pressure block is the
  reference's w-BFBT apply in the mean-zero gauge, which is what the f64
  ``make_bfbt_schur`` case is held to (the apply's own mean is at the
  rounding level: its last Poisson solve is projected to mean zero);
- the w-BFBT apply reads nothing back to the host (no ``.item()``, no
  ``.tolist()``, no bool of a tensor) and refuses a stretched grid.

The JAX references are computed once per module (one jitted function).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_bfbt import _sticky_eta
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.solvers import bfbt as jbfbt
from pylamp_tpu.solvers.mg import (
    make_mg_preconditioner as j_make_mg_preconditioner,
)
from pylamp_tpu.solvers.scaling import characteristic_viscosity as j_char
from pylamp_tpu.solvers.scaling import stokes_scales as j_scales
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.solvers import bfbt
from pylamp_tpu_torch.solvers.mg import make_mg_preconditioner
from pylamp_tpu_torch.solvers.scaling import (
    characteristic_viscosity,
    stokes_scales,
)

NX, NY, LX, LY = 32, 16, 2.8e6, 8.0e5
GRID = StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY)
JGRID = JGrid(nx=NX, ny=NY, lx=LX, ly=LY)
BCS = VelocityBCs()
F32_BAR = 5e-4
MG_ARGS = dict(schur="wbfbt", schur_poisson_iters=3, levels=2)
LAM = 3.0  # the Gershgorin bound of D^-1 A on both velocity levels


def _inputs():
    rng = np.random.default_rng(3)
    es, en = (np.asarray(a) for a in _sticky_eta(JGRID))
    return (es, en, rng.standard_normal(GRID.shape_center),
            (rng.standard_normal(GRID.shape_vx),
             rng.standard_normal(GRID.shape_vy)))


@pytest.fixture(scope="module")
def reference():
    """The reference's Poisson V-cycle, its wbfbt MG preconditioner apply
    and that apply's pressure block (the w-BFBT apply, mean-zero), f64."""
    es, en, rc, r = _inputs()

    def run(es_, en_, rc_, r_):
        ec = j_char(en_)
        kcont, kbnd = j_scales(ec, JGRID)
        z = j_make_mg_preconditioner(
            es_, en_, JGRID, kcont, kbnd, bcs=jax_vbcs(BCS),
            lam_max=jnp.full((2,), LAM, jnp.float64), **MG_ARGS)(r_)
        return jbfbt.make_pressure_poisson_mg(en_, JGRID, ec)(rc_), z[2], z

    return jax.jit(run)(*(jnp.asarray(a) for a in (es, en, rc)),
                        tuple(jnp.asarray(a) for a in r)
                        + (jnp.asarray(rc),))


def _port(dtype):
    es, en, rc, r = _inputs()
    es, en, rc = t(es, dtype), t(en, dtype), t(rc, dtype)
    ec = characteristic_viscosity(en)
    kcont, kbnd = stokes_scales(ec, GRID)
    r = tuple(t(a, dtype) for a in r) + (rc,)
    return es, en, rc, r, ec, kcont, kbnd


def test_center_transfers_adjoint_and_constant():
    rng = np.random.default_rng(0)
    c, f = rng.standard_normal((8, 12)), rng.standard_normal((16, 24))
    pc, rf = bfbt.prolong_center(t(c)), bfbt.restrict_center(t(f))
    lhs = float(torch.vdot(pc.reshape(-1), t(f).reshape(-1)))
    rhs = float(torch.vdot(t(c).reshape(-1), 4.0 * rf.reshape(-1)))
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))
    one = torch.ones
    assert float(torch.max(torch.abs(
        bfbt.prolong_center(one((8, 12), dtype=torch.float64)) - 1.0))) == 0.0
    assert float(torch.max(torch.abs(
        bfbt.restrict_center(one((16, 24), dtype=torch.float64)) - 1.0))) == 0.0
    jpc, jrf = jax.jit(lambda c_, f_: (jbfbt.prolong_center(c_),
                                       jbfbt.restrict_center(f_)))(
        jnp.asarray(c), jnp.asarray(f))
    assert rel(pc, jpc) <= 1e-15
    assert rel(rf, jrf) <= 1e-15


def test_poisson_operator_spsd_symmetric_nullspace():
    grid = StaggeredGrid(nx=24, ny=16, lx=1.0, ly=1.0)
    rng = np.random.default_rng(1)
    eta = np.exp(rng.standard_normal((16, 24)) * 3.0)
    z, w = rng.standard_normal((16, 24)), rng.standard_normal((16, 24))
    eta_char = float(np.exp(np.mean(np.log(eta))))
    cx, cy = bfbt.face_coeffs(t(eta), eta_char)
    Kz = bfbt.poisson_apply(t(z), cx, cy, grid)
    Kw = bfbt.poisson_apply(t(w), cx, cy, grid)
    assert float(torch.max(torch.abs(bfbt.poisson_apply(
        torch.ones_like(t(z)), cx, cy, grid)))) == 0.0
    assert float(torch.vdot(t(z).reshape(-1), Kz.reshape(-1))) > 0.0
    assert abs(float(torch.vdot(t(w).reshape(-1), Kz.reshape(-1))
                     - torch.vdot(t(z).reshape(-1), Kw.reshape(-1)))) < 1e-9
    jgrid = JGrid(nx=24, ny=16, lx=1.0, ly=1.0)

    def jref(eta_, z_):
        jcx, jcy = jbfbt.face_coeffs(eta_, eta_char)
        return (jbfbt.poisson_apply(z_, jcx, jcy, jgrid),
                jbfbt.poisson_diag(jcx, jcy, jgrid))

    jKz, jdiag = jax.jit(jref)(jnp.asarray(eta), jnp.asarray(z))
    assert rel(Kz, jKz) <= 1e-12
    assert rel(bfbt.poisson_diag(cx, cy, grid), jdiag) <= 1e-12
    assert bfbt.num_levels(GRID) == jbfbt._num_levels(JGRID)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_poisson_mg_and_schur_match_reference(reference, dtype):
    """The pressure-Poisson V-cycle and the w-BFBT apply on the sharp
    field: 1e-12 in f64, F32_BAR in f32."""
    es, en, rc, _, ec, kcont, kbnd = _port(dtype)
    bar = 1e-12 if dtype == torch.float64 else F32_BAR
    z = bfbt.make_pressure_poisson_mg(en, GRID, ec)(rc)
    s = bfbt.make_bfbt_schur(es, en, GRID, BCS, kcont, kbnd, ec,
                             poisson_iters=3)(rc)
    assert z.dtype == s.dtype == dtype
    assert rel(z, reference[0]) <= bar
    # the mean-zero gauge (module docstring)
    assert rel(s - torch.mean(s), reference[1]) <= bar


def test_mg_preconditioner_wbfbt_matches_reference(reference):
    """One ``make_mg_preconditioner(schur="wbfbt")`` apply (velocity
    V-cycle after the w-BFBT pressure block), f64: 1e-12."""
    es, en, _, r, _, kcont, kbnd = _port(torch.float64)
    z = make_mg_preconditioner(
        es, en, GRID, kcont, kbnd, bcs=BCS,
        lam_max=torch.full((2,), LAM, dtype=torch.float64), **MG_ARGS)(r)
    for g, ref in zip(z, reference[2]):
        assert rel(g, ref) <= 1e-12


def test_wbfbt_reads_nothing_to_the_host(monkeypatch):
    """Building and applying the surrogate makes no host read; a stretched
    grid is refused."""
    es, en, rc, _, ec, kcont, kbnd = _port(torch.float64)

    def refuse(*a, **k):
        raise AssertionError("host read in the w-BFBT apply")

    for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    S = bfbt.make_bfbt_schur(es, en, GRID, BCS, kcont, kbnd, ec)
    S(rc)
    monkeypatch.undo()
    stretched = StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY,
                              y_edges=np.linspace(0.0, LY, NY + 1) ** 1.5
                              / LY ** 0.5)
    with pytest.raises(ValueError, match="stretched"):
        bfbt.make_bfbt_schur(es, en, stretched, BCS, kcont, kbnd, ec)
