"""Port vs reference under periodic side walls: the plain versions of
kernels 1, 7, 2, 3 and 4 against the JAX package's Pallas kernels in
interpret mode, on the CPU, at the shapes and bars of the reference's own
periodic kernel tests:

- kernels 1 and 7 (saddle and momentum apply) as tests/test_pallas_stokes.py,
  f32, 1e-5 max|ref|, on seam-consistent fields;
- kernel 2 (m2g) as tests/test_m2g_kernel.py, f32, 2e-5 max|ref| per stream,
  the seam columns of the nx+1-wide lattices equal;
- kernel 3 (RK4 advection) as tests/test_advect_kernel.py, f32, 5e-6, with
  a drift that carries seam markers across the seam;
- kernel 4 (rebucket) as tests/test_rebucket_kernel.py: identical slot for
  slot, with markers pushed across the seam.

Inputs are seeded numpy arrays given to both packages.  The marker kernels
all run at (8, 128, 3): interpret-mode calls of different shapes in one
process can abort (tests/test_rebucket_kernel.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.markers import bucket as jbucket
from pylamp_tpu.markers.pallas.advect_kernel import advect_rk4_pallas
from pylamp_tpu.markers.pallas.m2g_kernel import m2g_fused_pallas
from pylamp_tpu.markers.pallas.rebucket_kernel import rebucket_pallas
from pylamp_tpu.models.config import PhysicsConfig as JPhysics
from pylamp_tpu.ops.pallas.stokes_kernel import (
    momentum_apply_pallas,
    saddle_apply_pallas,
)
from pylamp_tpu.physics.materials import Material as JMaterial
from pylamp_tpu.physics.materials import MaterialTable as JTable
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
from pylamp_tpu_torch.models.config import PhysicsConfig
from pylamp_tpu_torch.ops.kernels import momentum, saddle
from pylamp_tpu_torch.physics.materials import Material, MaterialTable

F32 = torch.float32
FIELDS = ("x", "y", "mat", "T", "valid")


def _vbcs(slip="free_slip"):
    return VelocityBCs(top=slip, bottom="free_slip", left="periodic",
                       right="periodic")


def _stokes_fields(grid, seed):
    """f32 fields in the seam conventions (vx and eta_s equal in columns 0
    and nx), as tests/test_pallas_stokes.py draws them."""
    rng = np.random.default_rng(seed)
    vx = rng.normal(size=grid.shape_vx).astype(np.float32)
    vx[:, -1] = vx[:, 0]
    eta_s = np.exp(rng.normal(size=grid.shape_corner)).astype(np.float32)
    eta_s[:, -1] = eta_s[:, 0]
    vy = rng.normal(size=grid.shape_vy).astype(np.float32)
    eta_n = np.exp(rng.normal(size=grid.shape_center)).astype(np.float32)
    p = rng.normal(size=grid.shape_center).astype(np.float32)
    return vx, vy, p, eta_s, eta_n


def _close(got, ref, bar):
    ref = np.asarray(ref, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - ref))
    return err <= bar * max(np.max(np.abs(ref)), 1e-300)


@pytest.mark.parametrize("slip", ["free_slip", "no_slip"])
@pytest.mark.parametrize("nx,ny,br", [(16, 16, 8), (24, 32, 16)])
def test_saddle_and_momentum_plain_vs_pallas(slip, nx, ny, br):
    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.3, ly=0.9)
    jgrid = JGrid(nx=nx, ny=ny, lx=1.3, ly=0.9)
    bcs = _vbcs(slip)
    vx, vy, p, eta_s, eta_n = _stokes_fields(grid, 11 + nx)
    kcont, kbnd = 3.5, 7.5
    j = [jnp.asarray(a) for a in (vx, vy, p, eta_s, eta_n)]
    ref = saddle_apply_pallas(*j, jgrid, jax_vbcs(bcs), kcont, kbnd,
                              block_rows=br, interpret=True)
    prep = saddle.prep_saddle(t(eta_s), t(eta_n), kcont, kbnd)
    n0 = saddle.launches
    got = saddle.saddle_apply(t(vx), t(vy), t(p), prep, grid, bcs)
    assert saddle.launches == n0  # CPU tensors: the plain version
    for g, r in zip(got, ref):
        assert _close(g.numpy(), r, 1e-5)
    assert torch.equal(got[0][:, 0], got[0][:, -1])

    ref = momentum_apply_pallas(j[0], j[1], j[3], j[4], jgrid, jax_vbcs(bcs),
                                kbnd, block_rows=br, interpret=True)
    mprep = momentum.prep_momentum(t(eta_s), t(eta_n), kbnd)
    got = momentum.momentum_apply_kernel(t(vx), t(vy), mprep, grid, bcs)
    for g, r in zip(got, ref):
        assert _close(g.numpy(), r, 1e-5)


# -- the marker kernels at (8, 128, 3) --------------------------------------

NY, NX, K = 8, 128, 3
GRID = StaggeredGrid(nx=NX, ny=NY, lx=1.0, ly=0.5)
JGRID = JGrid(nx=NX, ny=NY, lx=1.0, ly=0.5)


def _markers(seed, lo=0.001, hi=0.999, fill=0.8):
    """f32 markers jittered in their cells (offsets in [lo, hi) cells),
    three materials, a fraction ``fill`` valid."""
    rng = np.random.default_rng(seed)
    shape = (NY, NX, K)
    ci = np.arange(NX)[None, :, None]
    cj = np.arange(NY)[:, None, None]
    x = ((ci + rng.uniform(lo, hi, shape)) * GRID.dx).astype(np.float32)
    y = ((cj + rng.uniform(lo, hi, shape)) * GRID.dy).astype(np.float32)
    return dict(x=x, y=y, T=rng.uniform(0.1, 1.0, shape).astype(np.float32),
                mat=rng.integers(0, 3, shape).astype(np.int32),
                valid=rng.uniform(size=shape) < fill)


def _both(arrays):
    return (jbucket.BucketedMarkers(**{f: jnp.asarray(arrays[f])
                                       for f in FIELDS}),
            BucketedMarkers(**{f: t(arrays[f]) for f in FIELDS}))


MATERIALS = (
    dict(name="a", rho0=3300.0, alpha=2.5e-5, T_ref=0.2, eta0=1e21,
         viscosity="frank_kamenetskii", fk_gamma=6.9, k=3.0, cp=1250.0,
         H=2e-8),
    dict(name="b", rho0=3200.0, eta0=1e19, k=100.0, cp=1000.0),
    dict(name="c", rho0=3350.0, eta0=1e23, k=3.3, cp=1200.0, H=1e-9),
)


def test_m2g_plain_vs_pallas():
    jbm, bm = _both(_markers(13))
    mats = tuple(Material(**m) for m in MATERIALS)
    jmats = tuple(JMaterial(**m) for m in MATERIALS)
    kw = dict(eta_avg="geometric", eta_min=1e18, eta_max=1e24, gx=0.0,
              gy=9.81)
    phys = PhysicsConfig(materials=mats, **kw)
    ref = m2g_fused_pallas(jbm, JGRID, JTable(jmats),
                           JPhysics(materials=jmats, **kw), with_energy=True,
                           interpret=True, periodic_x=True)
    n0 = m2g.launches
    got = m2g.m2g_fused(bm, GRID, MaterialTable(mats), phys, with_energy=True,
                        periodic_x=True)
    assert m2g.launches == n0
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _close(got[k].numpy(), ref[k], 2e-5), k
    for k in ("c_w", "c_eta", "c_T", "c_k", "c_rhocp", "c_H"):
        assert torch.equal(got[k][:, 0], got[k][:, -1]), k


@pytest.mark.parametrize("drift", [1.0, -1.0])
def test_advect_plain_vs_pallas(drift):
    """Seam-consistent vx with a uniform drift, so seam markers cross the
    seam (both ways over the two cases)."""
    jbm, bm = _both(_markers(11))
    rng = np.random.default_rng(12)
    vx = (rng.normal(size=GRID.shape_vx) * 0.3 + drift).astype(np.float32)
    vx[:, -1] = vx[:, 0]
    vy = rng.normal(size=GRID.shape_vy).astype(np.float32)
    vmax = max(np.abs(vx).max(), np.abs(vy).max())
    dt = np.float32(0.4 * min(GRID.dx, GRID.dy) / vmax)
    bcs = _vbcs()
    ref = advect_rk4_pallas(jbm, jnp.asarray(vx), jnp.asarray(vy), dt, JGRID,
                            jax_vbcs(bcs), stage_reach=1, interpret=True)
    got = advect.advect_rk4_fused(bm, t(vx), t(vy), torch.tensor(dt), GRID,
                                  bcs, stage_reach=1)
    crossed = np.abs(got.x.numpy() - bm.x.numpy()) > 0.5 * GRID.lx
    assert np.any(crossed & bm.valid.numpy())
    assert _close(got.x.numpy(), ref.x, 5e-6)
    assert _close(got.y.numpy(), ref.y, 5e-6)


def test_rebucket_plain_vs_pallas():
    """Markers displaced by up to a cell, the seam columns' pushed across
    the seam (wrapped positions): identical slot for slot, same drops."""
    arrays = _markers(9, lo=-0.999, hi=1.999, fill=0.7)
    x = np.clip(arrays["x"], 1e-9, GRID.lx - 1e-9)
    col = np.arange(NX)[None, :, None]
    x = np.where(col == 0, (x - 1.5 * GRID.dx) % GRID.lx, x)
    x = np.where(col == NX - 1, (x + 1.5 * GRID.dx) % GRID.lx, x)
    arrays["x"] = x.astype(np.float32)
    arrays["y"] = np.clip(arrays["y"], 1e-9, GRID.ly - 1e-9).astype(np.float32)
    jbm, bm = _both(arrays)
    ref, rdrop = rebucket_pallas(jbm, JGRID, interpret=True, periodic_x=True)
    n0 = rebucket.launches
    got, drop = rebucket.rebucket_fused(bm, GRID, periodic_x=True)
    assert rebucket.launches == n0
    assert int(drop) == int(rdrop)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    # the plain version is the reference's own tensor rebucket too
    xla, xdrop = jbucket.rebucket(jbm, JGRID, periodic_x=True)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(xla, f)))
    assert int(xdrop) == int(drop)
    with pytest.raises(ValueError, match="nx >= 3"):
        rebucket.rebucket_fused(
            dataclasses.replace(bm, **{f: getattr(bm, f)[:, :2]
                                       for f in FIELDS}),
            StaggeredGrid(nx=2, ny=NY, lx=1.0, ly=0.5), periodic_x=True)
