"""The launch plans and host-side checks of kernels 1 and 4 on the CPU:
``markers/kernels/rebucket.py rebucket_plan`` (the strips and row chunks
of csrc/rebucket.cu, its shared memory and resident blocks) and the checks
``ops/kernels/saddle.py prep_saddle`` makes once per solve, which the
per-call path of the saddle kernel relies on."""
import numpy as np
import pytest
import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.markers.kernels import rebucket
from pylamp_tpu_torch.ops.kernels import saddle

torch.set_num_threads(1)

SHAPES = [(1024, 1024), (256, 1024), (13, 17), (37, 23), (65, 33), (3, 3),
          (2, 2), (31, 97)]


@pytest.mark.parametrize("K", [1, 9, 18, 32, 33, 64])
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_rebucket_plan_covers_every_cell_once(ny, nx, K):
    """Every target cell lies in exactly one block; blocks are at most the
    plan's tx x rows, none is empty, and the grid is the plan's."""
    plan = rebucket.rebucket_plan(ny, nx, K)
    hits = np.zeros((ny, nx), np.int32)
    blocks = 0
    for j0, rows, i0, cols in plan.extents(ny, nx):
        assert 0 < rows <= plan.rows and 0 < cols <= plan.tx
        hits[j0:j0 + rows, i0:i0 + cols] += 1
        blocks += 1
    assert (hits == 1).all()
    assert blocks == plan.nstrips * plan.nchunks
    assert plan.smem == rebucket.smem_bytes(plan.tx, K)


@pytest.mark.parametrize("K", [1, 9, 18, 32, 33, 64, 100, 200, 500, 800])
def test_rebucket_plan_fits_shared_memory(K):
    """Every plan's block fits the 227 KB a block may use; up to K = 200
    at least two blocks stay resident per SM."""
    plan = rebucket.rebucket_plan(64, 64, K)
    assert plan.smem <= rebucket.SMEM_BLOCK_MAX
    assert rebucket.blocks_per_sm(plan.smem) >= (2 if K <= 200 else 1)


def test_rebucket_plan_fk_1024_k18():
    """FK 1024^2 x K18: 32 x 32 blocks of 32 columns by 32 rows, 56 KB
    each: shared memory for 4 resident per SM (at least 2, as the design
    asks)."""
    plan = rebucket.rebucket_plan(1024, 1024, 18)
    assert (plan.tx, plan.rows, plan.nstrips, plan.nchunks) == (32, 32, 32, 32)
    assert rebucket.blocks_per_sm(plan.smem) == 4
    assert plan.smem == 57136


@pytest.mark.parametrize("tx,K", [(32, 18), (16, 64), (1, 1), (8, 100)])
def test_rebucket_smem_counts_every_buffer(tx, K):
    """The layout's bytes: four ring rows of (tx + 2) K slots at 17 bytes
    (x, y, T, mat, the valid byte or code) plus 9 masks of ceil(K / 32)
    words per cell, two mover counts and up to 3 lead bytes per run, and
    the output row of tx K slots at 16 bytes plus 10 ints per target and
    one per warp."""
    s = (tx + 2) * K
    masks = 36 * -(-K // 32) * (tx + 2) + 8
    lower = rebucket.RING * (17 * s + masks) + 16 * tx * K + 40 * tx
    slack = rebucket.RING * 24 + 4 * rebucket.THREADS // 32
    assert lower <= rebucket.smem_bytes(tx, K) <= lower + slack


def test_rebucket_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        rebucket.rebucket_plan(8, 8, 1200)


def test_rebucket_cuda_refuses_cpu_tensors():
    """The kernel path raises on CPU markers (no fallback inside it); the
    fused entry point takes the plain version for them."""
    g = torch.Generator().manual_seed(0)
    shape = (5, 6, 4)
    bm = BucketedMarkers(x=torch.rand(shape, generator=g),
                         y=torch.rand(shape, generator=g),
                         mat=torch.zeros(shape, dtype=torch.int32),
                         T=torch.rand(shape, generator=g),
                         valid=torch.ones(shape, dtype=torch.bool))
    grid = StaggeredGrid(nx=6, ny=5, lx=1.0, ly=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        rebucket.rebucket_cuda(bm, grid)
    n0 = rebucket.launches
    new, dropped = rebucket.rebucket_fused(bm, grid)
    assert rebucket.launches == n0 and dropped.dtype == torch.int64


def _visc(ny, nx):
    g = torch.Generator().manual_seed(ny * 100 + nx)
    return (torch.rand((ny + 1, nx + 1), generator=g) + 0.5,
            torch.rand((ny, nx), generator=g) + 0.5)


@pytest.mark.parametrize("which", ["eta_s", "eta_n"])
@pytest.mark.parametrize("fault", ["dtype", "noncontiguous", "ndim"])
def test_prep_saddle_rejects_bad_viscosity(which, fault):
    """The checks that left the per-call path: a wrong dtype, a
    non-contiguous or a non-2-D viscosity raises in prep_saddle."""
    eta = dict(zip(("eta_s", "eta_n"), _visc(6, 9)))
    t = eta[which]
    if fault == "dtype":
        t = t.double()
    elif fault == "noncontiguous":
        t = t.t().contiguous().t()
    else:
        t = t[None]
    eta[which] = t
    with pytest.raises(ValueError, match=which):
        saddle.prep_saddle(eta["eta_s"], eta["eta_n"], 3.5, 70.0)


@pytest.mark.parametrize("shape", [(6, 9), (8, 10), (7, 9)])
def test_prep_saddle_rejects_mismatched_lattices(shape):
    """eta_s must be the corner lattice of eta_n: (ny + 1, nx + 1)."""
    eta_s = torch.rand(shape)
    eta_n = torch.rand((6, 9))
    with pytest.raises(ValueError, match="corner lattice"):
        saddle.prep_saddle(eta_s, eta_n, 3.5, 70.0)


def test_prep_saddle_keeps_the_viscosities_and_scales():
    """A valid prep holds the very tensors it was given (no copy) and
    (kbnd, kcont) as one f32 pair; the CPU apply is the plain version."""
    eta_s, eta_n = _visc(6, 9)
    prep = saddle.prep_saddle(eta_s, eta_n, torch.tensor(3.5),
                              torch.tensor(70.0))
    assert prep.eta_s is eta_s and prep.eta_n is eta_n
    assert prep.kk.tolist() == [70.0, 3.5]
    grid = StaggeredGrid(nx=9, ny=6, lx=1.5, ly=1.0)
    g = torch.Generator().manual_seed(7)
    u = [torch.rand(s, generator=g)
         for s in (grid.shape_vx, grid.shape_vy, grid.shape_center)]
    n0 = saddle.launches
    got = saddle.saddle_apply(*u, prep, grid, VelocityBCs())
    ref = saddle.saddle_apply_plain(*u, prep, grid, VelocityBCs())
    assert saddle.launches == n0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_saddle_cuda_refuses_a_cpu_prep():
    """The kernel path raises on a prep that does not lie on the card,
    before any launch (no fallback inside it)."""
    eta_s, eta_n = _visc(6, 9)
    prep = saddle.prep_saddle(eta_s, eta_n, 3.5, 70.0)
    grid = StaggeredGrid(nx=9, ny=6, lx=1.5, ly=1.0)
    u = [torch.zeros(s) for s in (grid.shape_vx, grid.shape_vy,
                                  grid.shape_center)]
    with pytest.raises(ValueError, match="CUDA"):
        saddle.saddle_apply_cuda(*u, prep, grid, VelocityBCs())
