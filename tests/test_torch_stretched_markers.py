"""Port vs reference on stretched grids: the bucket marker engine on the CPU.

Markers are m x m jittered per cell in each cell's own coordinates (as
setup seeds a stretched grid) on a 20x16 grid with geometric x edges (3x)
and y edges refined in a band (4x); some sit exactly on cell edges.  The
same markers go through pylamp_tpu (JAX) and pylamp_tpu_torch:

- ``bucket_from_flat``: identical buckets;
- marker -> grid on all four lattices (arithmetic and geometric means) and
  grid -> marker on all four (in-cell and displaced positions), f64, 1e-12
  relative;
- RK4 advection (stage reach 1 and 2), f64, 1e-12 relative;
- ``rebucket`` of the advected markers slot for slot identical with equal
  drop counts (f64 and f32), and ``bucket_reseed`` identical in x, y,
  material and validity, with T within 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.core import grid as jgrid
from pylamp_tpu.markers import bucket as jbucket
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import (
    StaggeredGrid,
    geometric_edges,
    refined_band_edges,
)
from pylamp_tpu_torch.markers import bucket

NX, NY, LX, LY = 20, 16, 1.7, 0.9
XE = geometric_edges(NX, LX, 3.0)
YE = refined_band_edges(NY, LY, 0.3 * LY, 0.3 * LY, 4.0)
GRID = StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY, x_edges=XE, y_edges=YE)
JGRID = jgrid.StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY, x_edges=XE,
                            y_edges=YE)
FIELDS = ("x", "y", "mat", "T", "valid")
VBCS = VelocityBCs(top="no_slip", left="no_slip")
LOCS = ("corner", "center", "vx", "vy")


def _flat(seed=0, m=3):
    """Jittered m x m markers per cell in the cell's own coordinates, a
    few moved exactly onto interior edges."""
    rng = np.random.default_rng(seed)
    frac = (np.arange(m) + 0.5) / m
    fx = frac[None, None, None, :] + rng.uniform(
        -0.25, 0.25, (NY, NX, m, m)) / m
    fy = frac[None, None, :, None] + rng.uniform(
        -0.25, 0.25, (NY, NX, m, m)) / m
    x = (GRID.x_corner[:-1][None, :, None, None]
         + fx * GRID.dxs[None, :, None, None]).ravel()
    y = (GRID.y_corner[:-1][:, None, None, None]
         + fy * GRID.dys[:, None, None, None]).ravel()
    on_edge = rng.choice(x.size, 40, replace=False)
    x[on_edge[:20]] = GRID.x_corner[rng.integers(1, NX, 20)]
    y[on_edge[20:]] = GRID.y_corner[rng.integers(1, NY, 20)]
    mat = rng.integers(0, 3, x.size).astype(np.int32)
    T = rng.uniform(0.0, 1.0, x.size)
    return x, y, mat, T


def _both(dtype=np.float64, capacity=18, seed=0):
    x, y, mat, T = _flat(seed)
    jbm = jbucket.bucket_from_flat(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(mat),
        jnp.asarray(T, dtype), JGRID, capacity)
    pbm = bucket.bucket_from_flat(t(x.astype(dtype)), t(y.astype(dtype)),
                                  t(mat), t(T.astype(dtype)), GRID, capacity)
    return jbm, pbm


def _equal(pbm, jbm):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pbm, f).numpy(),
                                      np.asarray(getattr(jbm, f)), f)


def test_bucket_from_flat_equal():
    jbm, pbm = _both()
    _equal(pbm, jbm)


@pytest.mark.parametrize("loc", LOCS)
def test_m2g_g2m(loc):
    jbm, pbm = _both()
    vals = np.random.default_rng(1).uniform(0.5, 2.0, pbm.x.shape)
    for mode in ("arithmetic", "geometric"):
        want = jbucket.bucket_markers_to_grid(jbm, jnp.asarray(vals), JGRID,
                                              loc, mode)
        got = bucket.bucket_markers_to_grid(pbm, t(vals), GRID, loc, mode)
        for g, w in zip(got, want):
            assert rel(g, w) <= 1e-12
    field = np.random.default_rng(2).standard_normal(GRID.shape(loc))
    # in-cell positions (reach 1), then displaced up to ~0.9 cell (reach 2)
    rng = np.random.default_rng(3)
    dx = rng.uniform(-0.9, 0.9, pbm.x.shape) * GRID.dx_min
    dy = rng.uniform(-0.9, 0.9, pbm.x.shape) * GRID.dy_min
    for reach, px, py in ((1, np.asarray(jbm.x), np.asarray(jbm.y)),
                          (2, np.clip(np.asarray(jbm.x) + dx, 0, LX),
                           np.clip(np.asarray(jbm.y) + dy, 0, LY))):
        want = jbucket.bucket_grid_to_markers(
            jnp.asarray(field), jnp.asarray(px), jnp.asarray(py), jbm.valid,
            JGRID, loc, reach=reach)
        got = bucket.bucket_grid_to_markers(t(field), t(px), t(py),
                                            pbm.valid, GRID, loc,
                                            reach=reach)
        assert rel(got, want) <= 1e-12


def _velocities(seed, dtype):
    """Velocities that move a marker up to ~0.45 of the smallest cell in
    dt = 1."""
    rng = np.random.default_rng(seed)
    vx = rng.uniform(-0.45, 0.45, GRID.shape_vx) * GRID.dx_min
    vy = rng.uniform(-0.45, 0.45, GRID.shape_vy) * GRID.dy_min
    return vx.astype(dtype), vy.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_advect_rebucket(dtype):
    """RK4 at both stage reaches (f64; f32 at reach 2, the card's dtype, to
    its rounding), rebucket of the reference's advected markers, and (f64)
    a tight capacity that drops markers: the same ones."""
    jbm, pbm = _both(dtype)
    vx, vy = _velocities(4, dtype)
    f64 = dtype == np.float64
    for reach in (1, 2) if f64 else (2,):
        jadv = jbucket.bucket_advect_rk4(jbm, jnp.asarray(vx), jnp.asarray(vy),
                                         1.0, JGRID, jax_vbcs(VBCS),
                                         stage_reach=reach)
        padv = bucket.bucket_advect_rk4(pbm, t(vx), t(vy), 1.0, GRID, VBCS,
                                        stage_reach=reach)
        tol = 1e-12 if f64 else 1e-6
        assert rel(padv.x, jadv.x) <= tol
        assert rel(padv.y, jadv.y) <= tol
    capacities = (18, 10) if f64 else (18,)
    for cap in capacities:
        jm = jbucket.BucketedMarkers(**{f: getattr(jadv, f)[..., :cap]
                                        for f in FIELDS})
        jnew, jdrop = jbucket.rebucket(jm, JGRID)
        new, drop = bucket.rebucket(bucket.BucketedMarkers(
            **{f: t(getattr(jm, f)) for f in FIELDS}), GRID)
        _equal(new, jnew)
        assert int(drop) == int(jdrop)
    assert int(drop) > 0 or not f64


def test_reseed():
    jbm, pbm = _both(capacity=12)
    # starve a block of cells
    keep = np.ones(pbm.x.shape, bool)
    keep[3:7, 4:9, 2:] = False
    keep[10:12, 15:18, :] = False
    jbm = jbm.replace(valid=jbm.valid & jnp.asarray(keep))
    pbm = pbm.replace(valid=pbm.valid & torch.from_numpy(keep))
    T_grid = np.random.default_rng(5).uniform(0, 1, GRID.shape_corner)
    want = jbucket.bucket_reseed(jbm, jnp.asarray(T_grid), JGRID,
                                 min_per_cell=6, n_materials=3)
    got = bucket.bucket_reseed(pbm, t(T_grid), GRID, min_per_cell=6,
                               n_materials=3)
    assert int(got.valid.sum()) > int(pbm.valid.sum())
    for f in ("x", "y", "mat", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert rel(got.T, want.T) <= 1e-12
