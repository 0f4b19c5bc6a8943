"""Port vs reference under periodic side walls: the bucket marker engine on
the CPU, following tests/test_periodic_markers.py.

Seam-biased f64 markers (drawn with numpy, bucketed by the JAX package's
``bucket_from_flat``) go through both packages:

- marker -> grid on every lattice and averaging mode, and the raw sums of
  kernel 2's plain version: 1e-12 relative, equal seam columns;
- a uniform marker value interpolates to itself at every node that has
  weight, the seam included (partition of unity across the seam);
- grid -> marker on every lattice: 1e-12;
- RK4 advection with flow through the seam, both stage reaches: 1e-12;
- rebucketing after it: identical slot for slot, nothing dropped, every
  marker in its owning column.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.markers import bucket as jbucket
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers import bucket
from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
from pylamp_tpu_torch.models.config import PhysicsConfig
from pylamp_tpu_torch.physics.materials import Material, MaterialTable

NX, NY, LX, LY = 12, 10, 1.2, 1.0
GRID = StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY)
JGRID = JGrid(nx=NX, ny=NY, lx=LX, ly=LY)
K = 48  # seam-biased sets pack ~30 markers a cell near the seam
BCS = VelocityBCs(left="periodic", right="periodic")
FIELDS = ("x", "y", "mat", "T", "valid")
LOCS = ("corner", "center", "vx", "vy")


def _markers(n=700, seed=5):
    """(JAX, port) bucketed markers, biased toward the seam."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, n)
    x = np.where(u < 0.5, u * 0.1, 1.0 - (u - 0.5) * 0.1) * LX
    y = rng.uniform(1e-6, LY - 1e-6, n)
    mat = rng.integers(0, 3, n).astype(np.int32)
    T = np.exp(rng.normal(size=n))
    jbm = jbucket.bucket_from_flat(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(mat), jnp.asarray(T), JGRID, K)
    return jbm, bucket.BucketedMarkers(**{f: t(getattr(jbm, f))
                                          for f in FIELDS})


@pytest.fixture(scope="module")
def seam_markers():
    return _markers()


@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("mode", ["arithmetic", "geometric"])
def test_m2g_vs_reference(seam_markers, loc, mode):
    jbm, bm = seam_markers
    vals = torch.where(bm.valid, torch.exp(torch.sin(bm.x * 7)
                                           + torch.cos(bm.y * 5)), 1.0)
    ref, rw = jbucket.bucket_markers_to_grid(jbm, jnp.asarray(vals.numpy()),
                                             JGRID, loc, mode,
                                             periodic_x=True)
    got, gw = bucket.bucket_markers_to_grid(bm, vals, GRID, loc, mode,
                                            periodic_x=True)
    assert rel(gw, rw) <= 1e-12
    assert rel(got, ref) <= 1e-12
    if got.shape[1] == NX + 1:
        assert torch.equal(got[:, 0], got[:, -1])


def test_m2g_fused_plain_sums(seam_markers):
    """Kernel 2's plain version: the raw weighted sums of every stream are
    the reference transfer's field x weight, seam columns equal."""
    jbm, bm = seam_markers
    mats = (Material(rho0=3.0, alpha=0.1, eta0=2.0, k=1.5, cp=0.5, H=0.2),
            Material(rho0=2.0, eta0=5.0, viscosity="frank_kamenetskii",
                     fk_gamma=2.0, k=1.0, cp=1.0),
            Material(rho0=1.0, eta0=0.5, k=2.0, cp=2.0))
    table = MaterialTable(mats)
    phys = PhysicsConfig(materials=mats, gx=0.5, gy=1.0, eta_avg="geometric")
    out = m2g.m2g_fused_plain(bm, GRID, table, phys, with_energy=True,
                              periodic_x=True)
    eta = torch.clamp(table.viscosity_of(bm.mat, bm.T), phys.eta_min,
                      phys.eta_max)
    for loc, w, name, vals, mode in (
            ("corner", "c_w", "c_eta", eta, "geometric"),
            ("center", "n_w", "n_eta", eta, "geometric"),
            ("vy", "vy_w", "vy_rho", table.density(bm.mat, bm.T),
             "arithmetic"),
            ("vx", "vx_w", "vx_rho", table.density(bm.mat, bm.T),
             "arithmetic"),
            ("corner", "c_w", "c_T", bm.T, "arithmetic")):
        ref, rw = jbucket.bucket_markers_to_grid(
            jbm, jnp.asarray(vals.numpy()), JGRID, loc, mode, periodic_x=True)
        ref = np.asarray(ref)
        if mode == "geometric":
            ref = np.log(ref)
        assert rel(out[w], rw) <= 1e-12, w
        assert rel(out[name], np.where(np.asarray(rw) > 0,
                                       ref * np.asarray(rw), 0.0)) <= 1e-12
        if out[name].shape[1] == NX + 1:
            assert torch.equal(out[name][:, 0], out[name][:, -1])


@pytest.mark.parametrize("loc", LOCS)
def test_m2g_uniform_is_exact(loc):
    jbm, bm = _markers(n=NX * NY * 8, seed=3)
    vals = torch.where(bm.valid, torch.tensor(3.7, dtype=torch.float64), 1.0)
    field, w = bucket.bucket_markers_to_grid(bm, vals, GRID, loc,
                                             periodic_x=True)
    np.testing.assert_allclose(field[w > 0].numpy(), 3.7, rtol=1e-12)


@pytest.mark.parametrize("loc", LOCS)
def test_g2m_vs_reference(seam_markers, loc):
    jbm, bm = seam_markers
    rng = np.random.default_rng(17)
    fu = rng.normal(size=(GRID.shape(loc)[0], NX))
    field = fu if GRID.shape(loc)[1] == NX else np.concatenate(
        [fu, fu[:, :1]], axis=1)
    ref = jbucket.bucket_grid_to_markers(jnp.asarray(field), jbm.x, jbm.y,
                                         jbm.valid, JGRID, loc,
                                         periodic_x=True)
    got = bucket.bucket_grid_to_markers(t(field), bm.x, bm.y, bm.valid, GRID,
                                        loc, periodic_x=True)
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("reach", [1, 2])
def test_advect_and_rebucket_through_seam(reach):
    """A periodic field with flow through the seam: RK4 positions at
    1e-12, then the rebucket identical slot for slot with nothing dropped
    and every marker in its owning column."""
    jbm, bm = _markers(n=400, seed=23)
    yv, xv = JGRID.coords("vx")
    vx = 0.3 * GRID.dx * (1.5 + np.sin(2 * np.pi * np.meshgrid(xv, yv)[0]
                                       / LX))
    yw, xw = JGRID.coords("vy")
    Xw, Yw = np.meshgrid(xw, yw)
    vy = 0.2 * GRID.dy * np.cos(2 * np.pi * Xw / LX) * np.sin(np.pi * Yw / LY)
    vy[0, :] = vy[-1, :] = 0.0
    dt = 1.0 if reach == 2 else 0.5
    ref = jbucket.bucket_advect_rk4(jbm, jnp.asarray(vx), jnp.asarray(vy),
                                    jnp.asarray(dt), JGRID, jax_vbcs(BCS),
                                    stage_reach=reach)
    n0 = advect.launches
    got = advect.advect_rk4_fused(bm, t(vx), t(vy),
                                  torch.tensor(dt, dtype=torch.float64),
                                  GRID, BCS, stage_reach=reach)
    assert advect.launches == n0
    assert rel(got.x, ref.x) <= 1e-12 and rel(got.y, ref.y) <= 1e-12
    assert float(got.x.min()) >= 0.0 and float(got.x.max()) < LX
    crossed = (got.x - bm.x).abs() > 0.5 * LX
    assert int(torch.sum(crossed & bm.valid)) > 0

    jnew, jdrop = jbucket.rebucket(ref, JGRID, periodic_x=True)
    new, drop = rebucket.rebucket_fused(got, GRID, periodic_x=True)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      np.asarray(getattr(jnew, f)))
    assert int(drop) == int(jdrop) == 0
    assert int(new.total()) == int(bm.total())
    _, ci, _ = torch.nonzero(new.valid, as_tuple=True)
    owner = torch.clamp((new.x[new.valid] / GRID.dx).long(), 0, NX - 1)
    assert torch.equal(ci, owner)
