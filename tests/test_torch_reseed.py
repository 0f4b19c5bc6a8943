"""Port vs reference: marker reseeding and the one-stream explicit-halo
transfer, on the CPU.

- ``bucket.bucket_reseed`` against the JAX package's on seeded states with
  starved cells (a third of the slots valid, three materials), walls and
  periodic side walls, f32 and f64: x, y, mat and valid identical, T within
  1e-12 max|err| / max|ref| in f64 and 1e-6 in f32;
- a majority tie (two materials with equal 3x3 counts) goes to the lower
  material id in both packages, as ``jnp.argmax``;
- healthy cells are left untouched (the no-op case);
- ``halo_markers.reseed_halo`` on the in-process 4x2 mesh is bit-identical
  to ``bucket_reseed``, and on sharded markers (each shard spawning on its
  own cells) to the global-layout call, slot for slot;
- ``halo_markers.m2g_halo`` (subgrid diffusion's transfer on the mesh)
  against ``bucket_markers_to_grid`` on every lattice and averaging mode:
  within 1e-12 relative, the weights within 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.markers import bucket as jbucket
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import (
    BucketedMarkers,
    bucket_markers_to_grid,
    bucket_reseed,
)
from pylamp_tpu_torch.parallel.halo_markers import m2g_halo, reseed_halo
from pylamp_tpu_torch.parallel.mesh import make_mesh

FIELDS = ("x", "y", "mat", "T", "valid")
NMAT = 3
NY, NX, K = 16, 24, 8
GRID = StaggeredGrid(nx=NX, ny=NY, lx=1.5, ly=1.0)
JGRID = JGrid(nx=NX, ny=NY, lx=1.5, ly=1.0)


def _markers(grid, K, seed, fill=0.35, dtype=np.float64):
    """Markers jittered in their cells, materials in blobs of 4x4 cells
    (so majorities vary), a fraction ``fill`` of the slots valid: many
    cells below any minimum of a few markers."""
    rng = np.random.default_rng(seed)
    shape = (grid.ny, grid.nx, K)
    cj = np.arange(grid.ny)[:, None, None]
    ci = np.arange(grid.nx)[None, :, None]
    x = (ci + rng.uniform(0.01, 0.99, shape)) * grid.dx
    y = (cj + rng.uniform(0.01, 0.99, shape)) * grid.dy
    blob = rng.integers(0, NMAT, (grid.ny // 4 + 1, grid.nx // 4 + 1))
    mat = np.where(rng.uniform(size=shape) < 0.8,
                   blob[cj // 4, ci // 4], rng.integers(0, NMAT, shape))
    valid = rng.uniform(size=shape) < fill
    return dict(x=x.astype(dtype), y=y.astype(dtype),
                T=rng.uniform(0.0, 1.0, shape).astype(dtype),
                mat=np.where(valid, mat, 0).astype(np.int32), valid=valid)


def _both(arrays):
    return (jbucket.BucketedMarkers(**{f: jnp.asarray(arrays[f])
                                       for f in FIELDS}),
            BucketedMarkers(**{f: t(arrays[f]) for f in FIELDS}))


def _T_grid(grid, seed, dtype):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, grid.shape_corner).astype(dtype)


@pytest.mark.parametrize("periodic_x", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reseed_matches_reference(periodic_x, dtype):
    arrays = _markers(GRID, K, 3, dtype=dtype)
    jbm, bm = _both(arrays)
    Tg = _T_grid(GRID, 4, dtype)
    ref = jbucket.bucket_reseed(jbm, jnp.asarray(Tg), JGRID, min_per_cell=4,
                                n_materials=NMAT, periodic_x=periodic_x)
    got = bucket_reseed(bm, t(Tg), GRID, min_per_cell=4, n_materials=NMAT,
                        periodic_x=periodic_x)
    assert int(got.total()) > int(bm.total())  # it spawned
    for f in ("x", "y", "mat", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    assert got.x.dtype == bm.x.dtype
    bar = 1e-12 if dtype == np.float64 else 1e-6
    assert rel(got.T, np.asarray(ref.T)) <= bar


def test_reseed_majority_tie():
    """Cell (1, 1) is empty; its 3x3 neighbourhood holds 2 markers of
    material 2 and 2 of material 1: the tie goes to material 1."""
    grid = StaggeredGrid(nx=4, ny=4, lx=1.0, ly=1.0)
    jgrid = JGrid(nx=4, ny=4, lx=1.0, ly=1.0)
    shape = (4, 4, 4)
    x = np.zeros(shape)
    y = np.zeros(shape)
    mat = np.zeros(shape, np.int32)
    valid = np.zeros(shape, bool)
    for (j, i), m in (((0, 0), 2), ((0, 2), 2), ((2, 0), 1), ((2, 2), 1)):
        x[j, i, 0] = (i + 0.5) * grid.dx
        y[j, i, 0] = (j + 0.5) * grid.dy
        mat[j, i, 0] = m
        valid[j, i, 0] = True
    arrays = dict(x=x, y=y, T=np.zeros(shape), mat=mat, valid=valid)
    jbm, bm = _both(arrays)
    Tg = _T_grid(grid, 5, np.float64)
    ref = jbucket.bucket_reseed(jbm, jnp.asarray(Tg), jgrid, min_per_cell=1,
                                n_materials=NMAT)
    got = bucket_reseed(bm, t(Tg), grid, min_per_cell=1, n_materials=NMAT)
    assert bool(got.valid[1, 1, 0]) and int(got.mat[1, 1, 0]) == 1
    for f in ("x", "y", "mat", "valid", "T"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)


def test_reseed_noop_when_healthy():
    arrays = _markers(GRID, K, 6, fill=1.0)
    _, bm = _both(arrays)
    got = bucket_reseed(bm, t(_T_grid(GRID, 7, np.float64)), GRID,
                        min_per_cell=K, n_materials=NMAT)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(bm, f)), f


# -- the explicit-halo forms on the in-process 4x2 mesh ----------------------------

N = 32
MGRID = StaggeredGrid(nx=N, ny=N, lx=1.2, ly=1.0)
MESH = make_mesh(8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reseed_halo_equals_bucket_reseed(dtype):
    _, bm = _both(_markers(MGRID, 6, 8, dtype=dtype))
    Tg = t(_T_grid(MGRID, 9, dtype))
    got = reseed_halo(bm, Tg, MGRID, min_per_cell=3, n_materials=NMAT,
                      mesh=MESH)
    ref = bucket_reseed(bm, Tg, MGRID, min_per_cell=3, n_materials=NMAT)
    assert int(ref.total()) > int(bm.total())
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reseed_halo_sharded_equals_global(dtype):
    from pylamp_tpu_torch.parallel.blocks import Blocks

    _, bm = _both(_markers(MGRID, 6, 12, dtype=dtype))
    Tg = t(_T_grid(MGRID, 13, dtype))
    ref = reseed_halo(bm, Tg, MGRID, min_per_cell=3, n_materials=NMAT,
                      mesh=MESH)
    sharded = BucketedMarkers(**{f: Blocks.split(getattr(bm, f), "center",
                                                 MESH) for f in FIELDS})
    got = reseed_halo(sharded, Blocks.split(Tg, "corner", MESH), MGRID,
                      min_per_cell=3, n_materials=NMAT, mesh=MESH)
    assert int(ref.total()) > int(bm.total())
    for f in FIELDS:
        assert isinstance(getattr(got, f), Blocks), f
        assert torch.equal(getattr(got, f).gather(), getattr(ref, f)), f


@pytest.mark.parametrize("loc", ["corner", "center", "vx", "vy"])
@pytest.mark.parametrize("mode", ["arithmetic", "geometric", "harmonic"])
def test_m2g_halo_matches_bucket(loc, mode):
    arrays = _markers(MGRID, 6, 10, fill=0.7)
    _, bm = _both(arrays)
    vals = t(np.random.default_rng(11).uniform(0.5, 2.0, arrays["x"].shape))
    got, gw = m2g_halo(bm, vals, MGRID, loc, mode, MESH)
    ref, rw = bucket_markers_to_grid(bm, vals, MGRID, loc, mode)
    assert got.shape == ref.shape == MGRID.shape(loc)
    assert rel(gw, rw.numpy()) <= 1e-12
    assert rel(got, ref.numpy()) <= 1e-12
