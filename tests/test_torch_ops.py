"""Port vs reference: matrix-free operators (ops/stokes.py, ops/energy.py,
solvers/scaling.py) and the saddle kernel's plain version.

Same numpy inputs through pylamp_tpu (JAX) and pylamp_tpu_torch: f64
operators agree to 1e-12 relative (the bar tests/test_operators.py holds
against the scipy oracle); the saddle wrapper's plain version in f32
agrees with the JAX jnp operator to 1e-6 relative (f32 rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_tbcs, jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.ops import energy as jenergy
from pylamp_tpu.ops import stokes as jstokes
from pylamp_tpu.solvers import scaling as jscaling
from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops import energy, stokes
from pylamp_tpu_torch.ops.kernels import saddle
from pylamp_tpu_torch.solvers import scaling

NX, NY, LX, LY = 32, 24, 1.3, 1.0
GRID = StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY)
JGRID = JGrid(nx=NX, ny=NY, lx=LX, ly=LY)

VBCS = {
    "free_slip": VelocityBCs(),
    "mixed": VelocityBCs(top="no_slip", right="no_slip"),
    "moving_lid": VelocityBCs(top="no_slip", bottom="no_slip", left="no_slip",
                              right="no_slip", vt_top=0.7, vn_left=0.2,
                              vn_bottom=-0.1),
}
TBCS = {
    "default": ThermalBCs(),
    "fluxes": ThermalBCs(left=ThermalBC("neumann", 0.3),
                         right=ThermalBC("dirichlet", 0.5),
                         bottom=ThermalBC("neumann", -1.2)),
}


def _fields(seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    g = GRID
    return dict(
        vx=rng.standard_normal(g.shape_vx).astype(dtype),
        vy=rng.standard_normal(g.shape_vy).astype(dtype),
        p=rng.standard_normal(g.shape_center).astype(dtype),
        eta_s=np.exp(rng.uniform(-4, 4, g.shape_corner)).astype(dtype),
        eta_n=np.exp(rng.uniform(-4, 4, g.shape_center)).astype(dtype),
        rho_vx=rng.uniform(1, 2, g.shape_vx).astype(dtype),
        rho_vy=rng.uniform(1, 2, g.shape_vy).astype(dtype),
        T=rng.uniform(0, 1, g.shape_corner).astype(dtype),
        k=rng.uniform(0.5, 2, g.shape_corner).astype(dtype),
        rc=rng.uniform(10, 20, g.shape_corner).astype(dtype),
        H=rng.uniform(0, 1, g.shape_corner).astype(dtype),
    )


@pytest.mark.parametrize("bname", sorted(VBCS))
def test_stokes_operator_f64(bname):
    f = _fields(0)
    bcs = VBCS[bname]
    args = ("vx", "vy", "p", "eta_s", "eta_n")
    ref = jstokes.stokes_operator(*(jnp.asarray(f[a]) for a in args), JGRID,
                                  jax_vbcs(bcs), kcont=3.5, kbnd=70.0)
    got = stokes.stokes_operator(*(t(f[a]) for a in args), GRID, bcs,
                                 kcont=3.5, kbnd=70.0)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12


@pytest.mark.parametrize("bname", sorted(VBCS))
def test_stokes_rhs_f64(bname):
    f = _fields(1)
    bcs = VBCS[bname]
    ref = jstokes.stokes_rhs(jnp.asarray(f["rho_vx"]), jnp.asarray(f["rho_vy"]),
                             0.3, 9.8, JGRID, jax_vbcs(bcs), kbnd=70.0,
                             dtype=jnp.float64, eta_s=jnp.asarray(f["eta_s"]))
    got = stokes.stokes_rhs(t(f["rho_vx"]), t(f["rho_vy"]), 0.3, 9.8, GRID,
                            bcs, kbnd=70.0, dtype=torch.float64,
                            eta_s=t(f["eta_s"]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12 * float(np.max(np.abs(r)) or 1))


def test_stokes_scales_f64():
    eta_n = _fields(2)["eta_n"]
    ref = jscaling.stokes_scales(jscaling.characteristic_viscosity(
        jnp.asarray(eta_n)), JGRID)
    got = scaling.stokes_scales(scaling.characteristic_viscosity(t(eta_n)),
                                GRID)
    for g, r in zip(got, ref):
        assert abs(float(g) - float(r)) <= 1e-12 * abs(float(r))


@pytest.mark.parametrize("k_avg", ["arithmetic", "harmonic"])
@pytest.mark.parametrize("tname", sorted(TBCS))
def test_energy_operator_rhs_f64(tname, k_avg):
    f = _fields(3)
    bcs = TBCS[tname]
    ref_op = jenergy.energy_operator(
        jnp.asarray(f["T"]), jnp.asarray(f["k"]), jnp.asarray(f["rc"]), JGRID,
        jax_tbcs(bcs), kbnd=40.0, k_avg=k_avg)
    got_op = energy.energy_operator(t(f["T"]), t(f["k"]), t(f["rc"]), GRID,
                                    bcs, kbnd=40.0, k_avg=k_avg)
    assert rel(got_op, ref_op) <= 1e-12
    ref_b = jenergy.energy_rhs(
        jnp.asarray(f["T"]), jnp.asarray(f["k"]), jnp.asarray(f["rc"]),
        jnp.asarray(f["H"]), JGRID, jax_tbcs(bcs), kbnd=40.0, k_avg=k_avg)
    got_b = energy.energy_rhs(t(f["T"]), t(f["k"]), t(f["rc"]), t(f["H"]),
                              GRID, bcs, kbnd=40.0, k_avg=k_avg)
    assert rel(got_b, ref_b) <= 1e-12


@pytest.mark.parametrize("bname", sorted(VBCS))
def test_saddle_plain_f32(bname):
    """The saddle wrapper on CPU tensors (its plain version) in f32 against
    the JAX jnp operator in f32."""
    f = _fields(4, np.float32)
    bcs = VBCS[bname]
    args = ("vx", "vy", "p", "eta_s", "eta_n")
    kcont, kbnd = np.float32(3.5), np.float32(70.0)
    ref = jstokes.stokes_operator(*(jnp.asarray(f[a]) for a in args), JGRID,
                                  jax_vbcs(bcs), kcont=jnp.float32(kcont),
                                  kbnd=jnp.float32(kbnd))
    prep = saddle.prep_saddle(t(f["eta_s"]), t(f["eta_n"]),
                              torch.tensor(kcont), torch.tensor(kbnd))
    n0 = saddle.launches
    got = saddle.saddle_apply(t(f["vx"]), t(f["vy"]), t(f["p"]), prep, GRID,
                              bcs)
    assert saddle.launches == n0  # CPU tensors take the plain version
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert rel(g, r) <= 1e-6
