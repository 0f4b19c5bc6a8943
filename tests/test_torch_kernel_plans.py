"""The launch plans and host-side checks of kernels 1-4 and 7-12 on the
CPU: ``markers/kernels/rebucket.py rebucket_plan`` (the strips and row
chunks of csrc/rebucket.cu, its shared memory and resident blocks, and
the same plan on each shard's block for csrc/rebucket_block.cu),
``markers/kernels/m2g.py m2g_plan`` (the node strips, node-row chunks and
slot units of csrc/m2g.cu), ``markers/kernels/advect.py advect_plan`` (the
cell tiles and rounds of csrc/advect.cu), the checks
``ops/kernels/saddle.py prep_saddle`` makes once per solve, which the
per-call path of the saddle kernel relies on, ``saddle.tile_plan`` (the
tiles of csrc/saddle_tile.cuh, kernels 1 and 7) and
``ops/kernels/cheb.py block_tile_plan`` (kernel 8's tiles of each shard's
block), ``ops/kernels/saddle_block.py tile_plan`` (kernel 9's), and
kernels 2's and 3's plans on each shard's block for kernels 10 and 11
(``markers/kernels/m2g_block.py block_plan`` and ``frame_blocks``,
``advect_plan`` on (by, bx)) with the windows ``advect_block.cut_windows``
cuts for kernel 11's checks against kernel 3."""
import numpy as np
import pytest
import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
from pylamp_tpu_torch.ops.kernels import cheb, cheb_block, momentum, saddle

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


# -- kernel 2 (m2g) and kernel 3 (advect) -----------------------------------------

PLAN_KS = [1, 9, 18, 32, 33, 64]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("K", PLAN_KS)
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_m2g_plan_covers_every_node_once(ny, nx, K, periodic):
    """Every node of the (ny + 1) x (nx + 1) index space (nx columns with
    periodic side walls: column 0's thread writes the seam column) lies in
    exactly one block; blocks are at most the plan's tx x rows, none is
    empty; the slot units cover the K slots of a cell once, each at most
    32 slots (one mask word) and kc."""
    plan = m2g.m2g_plan(ny, nx, K, m2g.FLAG_PERIODIC if periodic else 0)
    nxn = nx if periodic else nx + 1
    hits = np.zeros((ny + 1, nxn), np.int32)
    blocks = 0
    for j0, rows, i0, cols in plan.extents(ny, nx, periodic):
        assert 0 < rows <= plan.rows and 0 < cols <= plan.tx
        hits[j0:j0 + rows, i0:i0 + cols] += 1
        blocks += 1
    assert (hits == 1).all()
    assert blocks == plan.nstrips * plan.nchunks
    slots = np.zeros(K, np.int32)
    for first, count in plan.slot_units(K):
        assert 0 < count <= plan.kc <= 32
        slots[first:first + count] += 1
    assert (slots == 1).all()
    assert plan.smem == m2g.smem_bytes(plan.tx, plan.kc)
    assert plan.threads == 3 * plan.tx * plan.split
    assert plan.threads % 32 == 0


@pytest.mark.parametrize("K", PLAN_KS)
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_advect_plan_covers_every_cell_once(ny, nx, K):
    """Every cell lies in exactly one tile; tiles are at most ty x tx; a
    round holds a whole number of thread passes and at most CAP slots."""
    plan = advect.advect_plan(ny, nx, K)
    hits = np.zeros((ny, nx), np.int32)
    blocks = 0
    for j0, rows, i0, cols in plan.extents(ny, nx):
        assert 0 < rows <= plan.ty and 0 < cols <= plan.tx
        hits[j0:j0 + rows, i0:i0 + cols] += 1
        blocks += 1
    assert (hits == 1).all()
    assert blocks == plan.ntx * plan.nty
    assert plan.cap % advect.THREADS == 0
    assert advect.THREADS <= plan.cap <= advect.CAP
    assert plan.smem == advect.smem_bytes(plan.ty, plan.tx, plan.cap)


@pytest.mark.parametrize("K", [1, 9, 18, 32, 33, 64, 100, 200, 500, 800])
def test_m2g_and_advect_plans_fit_shared_memory(K):
    """Every plan's block fits the 227 KB a block may use, with at least
    two blocks resident per SM as far as shared memory and threads go."""
    plan = m2g.m2g_plan(64, 64, K)
    assert plan.smem + m2g.SMEM_STATIC <= rebucket.SMEM_BLOCK_MAX
    assert m2g.blocks_per_sm(plan.smem, plan.threads) >= 2
    aplan = advect.advect_plan(64, 64, K)
    assert aplan.smem + advect.SMEM_STATIC <= rebucket.SMEM_BLOCK_MAX
    assert advect.blocks_per_sm(aplan.smem) >= 2


def test_m2g_and_advect_plans_fk_1024_k18():
    """FK 1024^2 x K18: kernel 2 in 33 x 33 blocks of 32 node columns, two
    threads a node (192 threads), two 9-slot units a cell row, 47 KB each
    (room for 4 per SM, as the kernel's registers); kernel 3 in 32 x
    342 tiles of 3 x 32 cells, one round of 1,792 slots, 24 KB each."""
    plan = m2g.m2g_plan(1024, 1024, 18)
    assert (plan.tx, plan.rows, plan.kc, plan.units, plan.split) == (
        32, 32, 9, 2, 2)
    assert (plan.nstrips, plan.nchunks, plan.smem) == (33, 33, 47760)
    assert m2g.blocks_per_sm(plan.smem, plan.threads) >= 2
    assert m2g.m2g_plan(1024, 1024, 18, m2g.FLAG_PERIODIC).nstrips == 32
    aplan = advect.advect_plan(1024, 1024, 18)
    assert (aplan.ty, aplan.tx, aplan.cap, aplan.ntx, aplan.nty) == (
        3, 32, 1792, 32, 342)
    assert advect.blocks_per_sm(aplan.smem) >= 2


@pytest.mark.parametrize("tx,kc", [(32, 9), (32, 16), (1, 1), (32, 32)])
def test_m2g_smem_counts_every_buffer(tx, kc):
    """The layout's bytes: three units of tx + 2 cells, each cell 12 words
    a slot (4 landed streams, an 8-word record) at an odd stride, its
    valid bytes with up to 3 bytes of lead, and 6 slot masks; each unit's
    buffer a multiple of 16 bytes (the records' alignment)."""
    cells = tx + 2
    lower = 3 * cells * (48 * kc + (kc + 3) + 24)
    smem = m2g.smem_bytes(tx, kc)
    assert smem % 48 == 0
    assert lower <= smem <= lower + 3 * cells * (48 + 8) + 3 * 15


@pytest.mark.parametrize("ty,tx,cap", [(3, 32, 1792), (1, 32, 2048),
                                       (8, 1, 256)])
def test_advect_smem_counts_every_buffer(ty, tx, cap):
    """Two velocity windows of the tile and MARGIN nodes around it, and a
    list of cap live slots (x, y, code)."""
    win = (ty + 2 * advect.MARGIN) * (tx + 2 * advect.MARGIN)
    assert advect.smem_bytes(ty, tx, cap) == 8 * win + 12 * cap


def test_m2g_and_advect_plans_refuse_what_they_cannot_index():
    with pytest.raises(ValueError, match="31 bits"):
        m2g.m2g_plan(4096, 4096, 200)
    with pytest.raises(ValueError, match="K = 4000"):
        advect.advect_plan(8, 8, 4000)


def _cpu_markers(shape=(5, 6, 4)):
    g = torch.Generator().manual_seed(0)
    return BucketedMarkers(x=torch.rand(shape, generator=g),
                           y=torch.rand(shape, generator=g),
                           mat=torch.zeros(shape, dtype=torch.int32),
                           T=torch.rand(shape, generator=g),
                           valid=torch.ones(shape, dtype=torch.bool))


def test_m2g_and_advect_cuda_refuse_cpu_tensors():
    """The kernel paths raise on CPU markers (no fallback inside them); the
    fused entry points take the plain versions for them."""
    from pylamp_tpu_torch.models.benchmarks import fk_stagnant_lid
    from pylamp_tpu_torch.physics.materials import MaterialTable

    bm = _cpu_markers()
    grid = StaggeredGrid(nx=6, ny=5, lx=1.0, ly=1.0)
    cfg = fk_stagnant_lid(nx=6, ny=5)
    table = MaterialTable(cfg.physics.materials)
    with pytest.raises(ValueError, match="CUDA"):
        m2g.m2g_fused_cuda(bm, grid, table, cfg.physics, with_energy=True)
    vx = torch.zeros(grid.shape_vx)
    vy = torch.zeros(grid.shape_vy)
    with pytest.raises(ValueError, match="CUDA"):
        advect.advect_rk4_cuda(bm, vx, vy, 0.1, grid, VelocityBCs())
    n2, n3 = m2g.launches, advect.launches
    out = m2g.m2g_fused(bm, grid, table, cfg.physics, with_energy=True)
    moved = advect.advect_rk4_fused(bm, vx, vy, 0.1, grid, VelocityBCs())
    assert (m2g.launches, advect.launches) == (n2, n3)
    assert "c_T" in out and moved.x.shape == bm.x.shape


# -- kernel 7 (momentum) and kernel 8 (cheb_block) ----------------------------

@pytest.mark.parametrize("ny,nx", [(256, 1024), (128, 512), (333, 517)])
def test_momentum_tile_plan_covers_every_point_once(ny, nx):
    """Kernel 7's tiles (kernel 1's) cover the (ny+1, nx+1) points once,
    each at most 16 x 32; a branch-free tile's staged frame lies inside the
    level and its points off the Dirichlet lines, and the levels the inner
    FGMRES applies it on are mostly branch-free tiles."""
    plan = saddle.tile_plan(ny, nx)
    hits = np.zeros((ny + 1, nx + 1), np.int32)
    free = 0
    for j0, rows, i0, cols, interior in plan.extents(ny, nx):
        assert 0 < rows <= saddle.TILE_Y and 0 < cols <= saddle.TILE_X
        hits[j0:j0 + rows, i0:i0 + cols] += 1
        if interior:
            assert j0 - 1 >= 0 and j0 + rows <= ny - 1
            assert i0 - 1 >= 0 and i0 + cols <= nx - 1
            free += 1
    assert (hits == 1).all()
    assert free > plan.nty * plan.ntx // 2


def _fk_mesh_blocks(n, my, mx):
    """The (by, bx) blocks of the FK n^2 levels that kernel 8 smooths on a
    my x mx mesh (the 4x2 mesh: 256x512 down to 8x16 at n = 1024)."""
    from pylamp_tpu_torch.models.benchmarks import fk_bench_config
    from pylamp_tpu_torch.parallel.halo_smoother import (
        halo_smoother_eligible,
    )
    from pylamp_tpu_torch.parallel.mesh import Mesh
    from pylamp_tpu_torch.solvers import mg

    s = fk_bench_config(n).solver
    g = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
    grids = [g]
    for step in mg.coarsening_plan(g, s.mg_levels,
                                   semi_threshold=s.mg_semicoarsen):
        grids.append(grids[-1].coarsen(*step))
    deg = max(s.mg_pre_smooth, s.mg_post_smooth)
    mesh = Mesh(my, mx)
    return [(g.ny // my, g.nx // mx) for g in grids
            if halo_smoother_eligible(g, mesh, VelocityBCs(), torch.float32,
                                      deg, True)], deg


@pytest.mark.parametrize("n,my,mx", [(1024, 4, 2), (1024, 2, 2),
                                     (68, 2, 2)])
def test_block_tile_plan_covers_every_block_once(n, my, mx):
    """Kernel 8's tiles cover each shard's central by x bx block once on
    every level it smooths (degree + residual and degree), each at most
    (ty + 1) x 33 points, the loaded region within the threads' points and
    the shared memory within a block's budget."""
    blocks, deg = _fk_mesh_blocks(n, my, mx)
    if (n, my, mx) == (1024, 4, 2):
        assert blocks == [(256, 512), (128, 256), (64, 128), (32, 64),
                          (16, 32), (8, 16)]
    assert blocks
    for by, bx in blocks:
        for he in (deg + 1, deg):
            plan = cheb.block_tile_plan(by, bx, he, my * mx)
            seen = np.zeros((by, bx), np.int32)
            for r0, rows, c0, cols in plan.extents(by - 1, bx - 1):
                assert 1 <= rows <= plan.ty + 1
                assert 1 <= cols <= cheb.TILE_X + 1
                seen[r0:r0 + rows, c0:c0 + cols] += 1
            assert (seen == 1).all()
            assert plan.smem <= cheb.SMEM_PER_BLOCK


@pytest.mark.parametrize("he", range(1, 8))
def test_block_tile_plan_fits_at_every_depth(he):
    """At each depth 1-7 and tile height every tile's loaded region fits
    the threads' fixed points and a block's shared memory, and the plan
    spreads the small levels' shards over more blocks than 32-row tiles."""
    for ty in cheb.TILE_ROWS:
        loaded = (ty + 1 + 2 * he) * (cheb.TILE_X + 1 + 2 * he)
        nq = -(-(cheb.TILE_X + 1 + 2 * he) ** 2 // cheb.THREADS)
        assert loaded <= nq * cheb.THREADS
        assert cheb.PLANES * 4 * loaded <= cheb.SMEM_PER_BLOCK
    for by, bx in ((256, 512), (64, 128), (8, 16), (34, 34)):
        plan = cheb.block_tile_plan(by, bx, he, 8)
        assert plan.smem == cheb.PLANES * 4 * (plan.ty + 1 + 2 * he) * (
            cheb.TILE_X + 1 + 2 * he)
        assert plan.smem <= cheb.SMEM_PER_BLOCK
    small = cheb.block_tile_plan(64, 128, he, 8)
    assert small.nty * small.ntx > 2 * 4


def test_momentum_and_cheb_block_cuda_refuse_cpu_tensors():
    """The kernel paths of kernels 7 and 8 raise on CPU tensors before any
    launch (no fallback inside them); their entry points take the plain
    versions for them."""
    from pylamp_tpu_torch.parallel import halo_smoother as hs
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    grid = StaggeredGrid(nx=32, ny=32, lx=1.0, ly=1.0)
    eta_s, eta_n = _visc(32, 32)
    vx, vy = torch.zeros(grid.shape_vx), torch.zeros(grid.shape_vy)
    prep = momentum.prep_momentum(eta_s, eta_n, 70.0)
    with pytest.raises(ValueError, match="CUDA"):
        momentum.momentum_apply_cuda(vx, vy, prep, grid, VelocityBCs())
    mesh = make_mesh(8)
    bprep = hs.prep_halo_smoother(eta_s, eta_n, grid, mesh, 3, 70.0, 1.0)
    frames = hs.smoother_frames(vx, vy, vx, vy, VelocityBCs(), mesh, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cheb_block.cheb_block_cuda(*frames, bprep, grid, VelocityBCs(), 2,
                                   False, True)
    n7, n8 = momentum.launches, cheb_block.launches
    momentum.momentum_apply_kernel(vx, vy, prep, grid, VelocityBCs())
    cheb_block.cheb_block(*frames, bprep, grid, VelocityBCs(), 2, False, True)
    assert (momentum.launches, cheb_block.launches) == (n7, n8)


# -- kernel 9 (saddle_block) and kernel 12 (rebucket_block) -------------------

@pytest.mark.parametrize("by,bx", [(256, 512), (64, 128), (21, 38), (8, 16)])
def test_saddle_block_tile_plan_covers_every_point_once(by, bx):
    """Kernel 9's tiles (blockIdx.z the shard, the same tiles on each)
    cover every own point (r, c) of every shard once, each at most 16 x 32;
    a branch-free tile is full and its staged frame (extended rows r0 ..
    r0 + 17, columns c0 .. c0 + 33; es_ext from (r0, c0)) lies in the
    extended blocks; only the ragged last row and column of tiles bound
    their loads, and at the mesh's 256x512 blocks none does."""
    from pylamp_tpu_torch.ops.kernels import saddle_block

    S = 8
    plan = saddle_block.tile_plan(by, bx)
    hits = np.zeros((S, by, bx), np.int32)
    for s in range(S):
        for r0, rows, c0, cols, full in plan.extents(by, bx):
            assert 0 < rows <= saddle.TILE_Y and 0 < cols <= saddle.TILE_X
            hits[s, r0:r0 + rows, c0:c0 + cols] += 1
            if full:
                assert r0 + saddle.TILE_Y + 1 <= by + 1
                assert c0 + saddle.TILE_X + 1 <= bx + 1
            else:
                assert (r0 + rows == by) or (c0 + cols == bx)
    assert (hits == 1).all()
    partial_tiles = sum(not full for *_, full in plan.extents(by, bx))
    if by % saddle.TILE_Y == 0 and bx % saddle.TILE_X == 0:
        assert partial_tiles == 0
    else:
        assert partial_tiles > 0


@pytest.mark.parametrize("n,shards,K", [(1024, 8, 18), (40, 4, 18),
                                        (90, 4, 9), (36, 9, 33)])
def test_rebucket_block_plan_covers_every_cell_once(n, shards, K):
    """Kernel 12's launch over blocks (rebucket_plan on each shard's (by,
    bx), blockIdx.z the shard) writes every own cell of every shard once,
    at the mesh's 256x512 blocks (1,024 blocks, as kernel 4 at 1024^2),
    at 20x20 blocks narrower than one strip and at 45x45 blocks whose
    width is no multiple of the strip; every block's source rows (one
    above and below its chunk) and halo columns lie in the shard's
    extended block, and its global cells in the domain."""
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(shards)
    by, bx = n // mesh.my, n // mesh.mx
    plan = rebucket.rebucket_plan(by, bx, K)
    bases = mesh.bases(by, bx).numpy()
    hits = np.zeros((n, n), np.int32)
    blocks = 0
    for s, (row_base, col_base) in enumerate(bases):
        for r0, rows, c0, cols in plan.extents(by, bx):
            blocks += 1
            j_lo, i0 = row_base + r0, col_base + c0
            hits[j_lo:j_lo + rows, i0:i0 + cols] += 1
            # extended rows and columns of the sources (global - base + 1)
            assert 0 <= j_lo - 1 - row_base + 1
            assert j_lo + rows - row_base + 1 <= by + 1
            assert 0 <= i0 - 1 - col_base + 1
            assert i0 + cols - col_base + 1 <= bx + 1
    assert (hits == 1).all()
    assert blocks == shards * plan.nstrips * plan.nchunks
    if (n, shards, K) == (1024, 8, 18):
        assert (plan.tx, plan.rows, blocks) == (32, 32, 1024)
    if bx < plan.tx:
        assert plan.nstrips == 1


@pytest.mark.parametrize("K", [1, 9, 18, 33, 64, 100])
def test_rebucket_block_plan_fits_shared_memory(K):
    """At the mesh's 256x512 and 20x20 blocks every plan's block fits the
    227 KB a block may use, with two blocks resident per SM, and the
    per-shard marker gate admits these K at the mesh's blocks (the repack
    takes K <= 993 and the gate routes larger K to the plain version)."""
    from pylamp_tpu_torch.parallel.halo_markers import block_kernel_eligible

    for by, bx in ((256, 512), (20, 20)):
        plan = rebucket.rebucket_plan(by, bx, K)
        assert plan.smem == rebucket.smem_bytes(plan.tx, K)
        assert plan.smem <= rebucket.SMEM_BLOCK_MAX
        assert rebucket.blocks_per_sm(plan.smem) >= 2
    assert block_kernel_eligible(256, 512, K)
    assert block_kernel_eligible(256, 512, 993)
    assert not block_kernel_eligible(256, 512, 994)
    assert not rebucket.repack_fits(994)


def test_block_kernels_cuda_refuse_cpu_tensors():
    """The kernel paths of kernels 9 and 12 raise on CPU tensors before any
    launch (no fallback inside them); their entry points take the plain
    versions for them."""
    from pylamp_tpu_torch.markers.kernels import rebucket_block
    from pylamp_tpu_torch.ops.kernels import saddle_block
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    S, by, bx, K = 4, 8, 16, 3
    g = torch.Generator().manual_seed(12)
    ext = torch.rand((S, by + 2, bx + 2), generator=g)
    es = torch.rand((S, by + 1, bx + 1), generator=g) + 0.5
    with pytest.raises(ValueError, match="CUDA"):
        saddle_block.saddle_block_cuda(ext, ext, ext, es, ext, 0.1, 0.2)
    grid = StaggeredGrid(nx=2 * bx, ny=2 * by, lx=1.0, ly=1.0)
    shape = (S, by + 2, bx + 2, K)
    xe, ye, Te = (torch.rand(shape, generator=g) for _ in range(3))
    me = torch.zeros(shape, dtype=torch.int32)
    ve = torch.ones(shape, dtype=torch.bool)
    bases = make_mesh(S).bases(by, bx)
    with pytest.raises(ValueError, match="CUDA"):
        rebucket_block.rebucket_block_cuda(xe, ye, Te, me, ve, grid, bases)
    n9, n12 = saddle_block.launches, rebucket_block.launches
    out = saddle_block.saddle_block(ext, ext, None, es, ext, 0.1, 0.2)
    new, arrivals = rebucket_block.rebucket_block(xe, ye, Te, me, ve, grid,
                                                  bases)
    assert (saddle_block.launches, rebucket_block.launches) == (n9, n12)
    assert len(out) == 2 and arrivals.shape == (S, by, bx)


# -- kernel 10 (m2g_block) and kernel 11 (advect_block) -----------------------

# (ny, nx, my, mx): the 4x2 mesh's 256x512 blocks of FK 1024^2, the 2x2
# mesh's 20x20 blocks of 40^2 (narrower than one strip) and 24x33 blocks
# whose bx + 1 = 34 node columns are no multiple of the 32-column strip
BLOCK_MESHES = [(1024, 1024, 4, 2), (40, 40, 2, 2), (48, 66, 2, 2)]


def _mesh_blocks(ny, nx, my, mx):
    from pylamp_tpu_torch.parallel.mesh import Mesh

    by, bx = ny // my, nx // mx
    return my * mx, by, bx, Mesh(my, mx).bases(by, bx)


@pytest.mark.parametrize("ny,nx,my,mx", BLOCK_MESHES + [(40, 80, 2, 4)])
def test_m2g_block_plan_periodic_ring(ny, nx, my, mx):
    """Kernel 10p's blocks (``frame_blocks(periodic_x=True)``): the same
    blocks as kernel 10's, each streaming the whole ring's cell columns,
    unclamped at the x seam (col_base - 1 .. col_base + bx, wrapped where
    read), so every frame node a shard keeps under periodic walls (its own
    columns) gets its three cell columns; the frame's last column, which
    the caller takes from column 0's owner, does not."""
    from pylamp_tpu_torch.markers.kernels import m2g_block

    S, by, bx, bases = _mesh_blocks(ny, nx, my, mx)
    plan = m2g_block.block_plan(S, by, bx, 18)
    walls = list(m2g_block.frame_blocks(plan, by, bx, bases, ny, nx))
    ring = list(m2g_block.frame_blocks(plan, by, bx, bases, ny, nx, True))
    assert [b[:7] for b in ring] == [b[:7] for b in walls]
    for s, j_lo, j_hi, i0, txe, r_lo, r_hi, c_lo, c_hi in ring:
        cb = int(bases[s, 1])
        assert (c_lo, c_hi) == (cb - 1, cb + bx)
        for I in range(i0, i0 + txe):
            assert (c_lo <= I - 1 and I + 1 <= c_hi) == (I < cb + bx)


@pytest.mark.parametrize("ny,nx,my,mx", BLOCK_MESHES)
def test_m2g_block_plan_covers_every_frame_node_once(ny, nx, my, mx):
    """Kernel 10's launch (kernel 2's plan on each shard's (by + 1) x
    (bx + 1) node frame, every shard's last strip last) writes every frame
    node of every shard once; each block streams cell rows inside the shard's ring
    and the domain, every node's first and last cell rows lie among them
    (a frame row on the ring's edge completes at the ring's last row), and
    a node the caller keeps (own rows and columns, the last shard's seam)
    gets all of its cells.  At 256x512 x K18: 17 x 9 x 8 = 1,224 blocks."""
    from pylamp_tpu_torch.markers.kernels import m2g_block

    S, by, bx, bases = _mesh_blocks(ny, nx, my, mx)
    plan = m2g_block.block_plan(S, by, bx, 18)
    hits = np.zeros((S, by + 1, bx + 1), np.int32)
    blocks, sizes = 0, []
    for s, j_lo, j_hi, i0, txe, r_lo, r_hi, c_lo, c_hi in (
            m2g_block.frame_blocks(plan, by, bx, bases, ny, nx)):
        rb, cb = bases[s].tolist()
        blocks += 1
        sizes.append((j_hi - j_lo, txe))
        assert 0 < j_hi - j_lo <= plan.rows and 0 < txe <= plan.tx
        hits[s, j_lo - rb:j_hi - rb, i0 - cb:i0 + txe - cb] += 1
        assert max(rb - 1, 0) == r_lo and r_hi == min(rb + by, ny - 1)
        assert max(cb - 1, 0) == c_lo and c_hi == min(cb + bx, nx - 1)
        r_first, r_last = max(j_lo - 1, r_lo), min(j_hi, r_hi)
        for J in range(j_lo, j_hi):
            assert r_first <= max(J - 1, r_lo) <= min(J + 1, r_hi) <= r_last
            kept = J < rb + by or J == ny
            if kept:  # every cell row that reaches the node is streamed
                assert r_first <= max(J - 1, 0) and min(J + 1, ny - 1) <= r_hi
        for I in range(i0, i0 + txe):
            if I < cb + bx or I == nx:  # every cell column is in the ring
                assert c_lo <= max(I - 1, 0) and min(I + 1, nx - 1) <= c_hi
    assert (hits == 1).all()
    assert blocks == S * plan.nstrips * plan.nchunks
    if (by, bx) == (256, 512):
        assert (plan.nstrips, plan.nchunks, blocks) == (17, 9, 1224)
        assert (plan.kc, plan.units, plan.threads) == (9, 2, 192)
        # the one-column strips last (the 32 slots of 528 that the 1,024
        # full blocks leave in their second round take them); before them
        # only full blocks and one-row chunks
        assert sizes[-72:] == ([(32, 1)] * 8 + [(1, 1)]) * 8
        assert sorted(set(sizes[:-72])) == [(1, 32), (32, 32)]
        assert sizes.count((32, 32)) == 1024


@pytest.mark.parametrize("ny,nx,my,mx", BLOCK_MESHES)
def test_advect_block_plan_covers_every_cell_once(ny, nx, my, mx):
    """Kernel 11's launch (kernel 3's tiles on each shard's by x bx block,
    blockIdx.z the shard) advects every own cell of every shard once, and
    every node that a marker's shift window reaches at stage reach 1 or 2
    lies in its tile's staged window (the tile and MARGIN nodes around it)
    and in the shard's exchanged window (R nodes before the block, R + 1
    after).  At 256x512 x K18: 16 x 86 x 8 = 11,008 tiles of 3 x 32
    cells, the last tile row of a shard one cell row."""
    S, by, bx, bases = _mesh_blocks(ny, nx, my, mx)
    plan = advect.advect_plan(by, bx, 18)
    hits = np.zeros((ny, nx), np.int32)
    blocks = 0
    for rb, cb in bases.tolist():
        for r0, rows, c0, cols in plan.extents(by, bx):
            blocks += 1
            cj0, ci0 = rb + r0, cb + c0
            hits[cj0:cj0 + rows, ci0:ci0 + cols] += 1
            for R in (1, 2):
                # nodes [cell - R, cell + R + 1] of the tile's cells
                lo_r, hi_r = cj0 - R, cj0 + rows - 1 + R + 1
                lo_c, hi_c = ci0 - R, ci0 + cols - 1 + R + 1
                assert cj0 - advect.MARGIN <= lo_r
                assert hi_r < cj0 + plan.ty + advect.MARGIN
                assert ci0 - advect.MARGIN <= lo_c
                assert hi_c < ci0 + plan.tx + advect.MARGIN
                assert rb - R <= lo_r and hi_r <= rb + by + R
                assert cb - R <= lo_c and hi_c <= cb + bx + R
    assert (hits == 1).all()
    assert blocks == S * plan.ntx * plan.nty
    if (by, bx) == (256, 512):
        assert (plan.ty, plan.tx, plan.cap, blocks) == (3, 32, 1792, 11008)
        assert 256 - (plan.nty - 1) * plan.ty == 1


@pytest.mark.parametrize("K", [1, 9, 18, 33, 64])
def test_block_marker_plans_fit_shared_memory(K):
    """At the 4x2 mesh's 256x512 and the 2x2 mesh's 20x20 blocks, kernels
    10 and 11 keep their siblings' plans: each block fits the 227 KB a
    block may use, with two blocks resident per SM as far as shared memory
    and threads go (kernel 10 at K18: four, as kernel 2)."""
    from pylamp_tpu_torch.markers.kernels import m2g_block

    for S, by, bx in ((8, 256, 512), (4, 20, 20)):
        plan = m2g_block.block_plan(S, by, bx, K)
        assert plan == m2g.m2g_plan(by, bx, K)
        assert plan.smem + m2g.SMEM_STATIC <= rebucket.SMEM_BLOCK_MAX
        assert m2g.blocks_per_sm(plan.smem, plan.threads) >= (
            4 if K == 18 else 2)
        aplan = advect.advect_plan(by, bx, K)
        assert aplan.smem == advect.smem_bytes(aplan.ty, aplan.tx, aplan.cap)
        assert aplan.smem + advect.SMEM_STATIC <= rebucket.SMEM_BLOCK_MAX
        assert advect.blocks_per_sm(aplan.smem) >= 2


def test_m2g_block_plan_refuses_what_it_cannot_index():
    from pylamp_tpu_torch.markers.kernels import m2g_block

    with pytest.raises(ValueError, match="31 bits"):
        m2g_block.block_plan(16, 1024, 1024, 128)


@pytest.mark.parametrize("R", [1, 2])
def test_cut_windows_are_the_exchanged_windows(R):
    """The windows cut from the whole padded lattices (the inputs on which
    kernel 11 is held to kernel 3) are the windows the halo exchange gives
    on the 4x2 mesh, with no-slip and free-slip walls."""
    from pylamp_tpu_torch.markers.bucket import padded_velocities
    from pylamp_tpu_torch.markers.kernels.advect_block import cut_windows
    from pylamp_tpu_torch.parallel.halo_markers import velocity_windows
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    grid = StaggeredGrid(nx=32, ny=32, lx=1.0, ly=1.0)
    mesh = make_mesh(8)
    rng = np.random.default_rng(131 + R)
    vx = torch.tensor(rng.uniform(-1, 1, grid.shape_vx), dtype=torch.float32)
    vy = torch.tensor(rng.uniform(-1, 1, grid.shape_vy), dtype=torch.float32)
    bcs = VelocityBCs(top="no_slip", right="no_slip", vt_top=0.3)
    by, bx = grid.ny // mesh.my, grid.nx // mesh.mx
    cut = cut_windows(*padded_velocities(vx, vy, bcs), mesh.bases(by, bx),
                      by, bx, R)
    for a, b in zip(velocity_windows(vx, vy, grid, bcs, mesh, R), cut):
        assert a.shape == (8, by + 2 * R + 1, bx + 2 * R + 1)
        assert torch.equal(a, b)


def test_m2g_and_advect_block_cuda_refuse_cpu_tensors():
    """The kernel paths of kernels 10 and 11 raise on CPU tensors before
    any launch (no fallback inside them); their entry points take the
    plain versions for them."""
    from pylamp_tpu_torch.markers.kernels import advect_block, m2g_block
    from pylamp_tpu_torch.models.benchmarks import fk_stagnant_lid
    from pylamp_tpu_torch.parallel.mesh import make_mesh
    from pylamp_tpu_torch.physics.materials import MaterialTable

    S, by, bx, K = 4, 8, 16, 3
    g = torch.Generator().manual_seed(13)
    grid = StaggeredGrid(nx=2 * bx, ny=2 * by, lx=1.0, ly=1.0)
    cfg = fk_stagnant_lid(nx=2 * bx, ny=2 * by)
    table = MaterialTable(cfg.physics.materials)
    shape = (S, by + 2, bx + 2, K)
    xe, ye, Te = (torch.rand(shape, generator=g) for _ in range(3))
    me = torch.zeros(shape, dtype=torch.int32)
    ve = torch.ones(shape, dtype=torch.bool)
    bases = make_mesh(S).bases(by, bx)
    with pytest.raises(ValueError, match="CUDA"):
        m2g_block.m2g_fused_block_cuda(xe, ye, Te, me, ve, grid, table,
                                       cfg.physics, bases, True)
    own = [a[:, 1:-1, 1:-1].contiguous() for a in (xe, ye, ve)]
    win = torch.zeros((S, by + 3, bx + 3))
    with pytest.raises(ValueError, match="CUDA"):
        advect_block.advect_block_cuda(*own, win, win, 0.1, grid, bases, 1)
    n10, n11 = m2g_block.launches, advect_block.launches
    out = m2g_block.m2g_fused_block(xe, ye, Te, me, ve, grid, table,
                                    cfg.physics, bases, True)
    nx_b, _ = advect_block.advect_block(*own, win, win, 0.1, grid, bases, 1)
    assert (m2g_block.launches, advect_block.launches) == (n10, n11)
    assert out["c_w"].shape == (S, by + 1, bx + 1)
    assert nx_b.shape == own[0].shape
