"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small odd shapes and several configurations (chip_smoke.py covers the
FK 1024^2 x K18 and sticky-air 1024x256 shapes; the fused smoother is also
checked here at 1024^2 and at depth 7 on the sticky-air levels, the
momentum kernel at the sticky-air levels, and the marker kernels on a 4:1
grid in SI units).

These tests need an NVIDIA GPU with nvcc: they carry the ``cuda`` marker
and skip without a card.  On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
from pylamp_tpu_torch.models.benchmarks import fk_stagnant_lid, sticky_air
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.ops.kernels import cheb, momentum, saddle
from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
from pylamp_tpu_torch.solvers import mg, scaling
from pylamp_tpu_torch.physics.materials import Material, MaterialTable

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)  # as tests/torch_helpers.py: one CPU thread

BCS = [VelocityBCs(), VelocityBCs(top="no_slip", left="no_slip"),
       VelocityBCs(top="no_slip", bottom="no_slip", left="no_slip",
                   right="no_slip", vt_top=0.3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card with "
                    "-m cuda)")
    return torch.device("cuda")


def _rel(got, ref):
    """max |got - ref| / max |ref| (the max |got - ref| itself where ref is
    all zero)."""
    err = float(torch.max(torch.abs(got.double() - ref.double())))
    scale = float(torch.max(torch.abs(ref.double())))
    return err / scale if scale > 0 else err


def _markers(nx, ny, dev, mats=1):
    cfg = fk_stagnant_lid(nx=nx, ny=ny)
    if mats > 1:
        cfg = dataclasses.replace(
            cfg,
            physics=dataclasses.replace(
                cfg.physics, materials=cfg.physics.materials * mats),
            material_of=lambda x, y: (x > 0.37).astype(np.int32) + (y > 0.6))
    _, _, st = build(cfg, dtype=torch.float32, device=dev)
    return st.markers


SADDLE_SHAPES = [(23, 37), (129, 257), (256, 1024), (1024, 256)]


@pytest.mark.parametrize("ny,nx", SADDLE_SHAPES)
@pytest.mark.parametrize("bcs", BCS)
def test_saddle_kernel(dev, bcs, ny, nx):
    """Kernel 1 at shapes that straddle its 16 x 32 tiles (ragged edge
    tiles, a one-point last tile row or column), under every BC set:
    within 1e-5 of max |ref| per output, a rerun bit-identical."""
    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.6, ly=1.0)
    rng = np.random.default_rng(1 + nx)

    def r(shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                            device=dev)

    vx, vy, p = r(grid.shape_vx), r(grid.shape_vy), r(grid.shape_center)
    eta_s = torch.exp(r(grid.shape_corner, -4, 4))
    eta_n = torch.exp(r(grid.shape_center, -4, 4))
    prep = saddle.prep_saddle(eta_s, eta_n, torch.tensor(3.5, device=dev),
                              torch.tensor(70.0, device=dev))
    n0 = saddle.launches
    got = saddle.saddle_apply(vx, vy, p, prep, grid, bcs)
    assert saddle.launches == n0 + 1
    ref = saddle.saddle_apply_plain(vx, vy, p, prep, grid, bcs)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 1e-5
    for g, a in zip(got, saddle.saddle_apply(vx, vy, p, prep, grid, bcs)):
        assert torch.equal(g, a)


def test_saddle_wrapper_checks(dev):
    """Kernel 1's thin launch path: one prep applied under another BC set
    or grid rebuilds its launch arguments (each result that of its own
    BCs); a wrong shape, dtype or non-contiguous vector raises, and so
    does a prep whose viscosities are not the grid's."""
    grid = StaggeredGrid(nx=37, ny=23, lx=1.6, ly=1.0)
    rng = np.random.default_rng(5)

    def r(shape):
        return torch.tensor(rng.uniform(-1, 1, shape), dtype=torch.float32,
                            device=dev)

    u = [r(grid.shape_vx), r(grid.shape_vy), r(grid.shape_center)]
    prep = saddle.prep_saddle(torch.exp(r(grid.shape_corner)),
                              torch.exp(r(grid.shape_center)), 3.5, 70.0)
    for bcs in (*BCS, BCS[0]):
        got = saddle.saddle_apply(*u, prep, grid, bcs)
        ref = saddle.saddle_apply_plain(*u, prep, grid, bcs)
        for g, rf in zip(got, ref):
            assert _rel(g, rf) <= 1e-5
    bad = {"shape": r((23, 37)), "dtype": u[0].double(),
           "noncontiguous": r((38, 23)).t()}
    for vx in bad.values():
        with pytest.raises(ValueError, match="vx"):
            saddle.saddle_apply(vx, u[1], u[2], prep, grid, BCS[0])
    other = StaggeredGrid(nx=36, ny=23, lx=1.6, ly=1.0)
    with pytest.raises(ValueError, match="eta_n"):
        saddle.saddle_apply(*u, prep, other, BCS[0])


@pytest.mark.parametrize("mats,eta_avg", [(1, "geometric"), (3, "harmonic"),
                                          (3, "arithmetic")])
def test_m2g_kernel(dev, mats, eta_avg):
    bm = _markers(20, 14, dev, mats=mats)
    table = MaterialTable([
        Material(rho0=100.0, alpha=1.0, eta0=1.0,
                 viscosity="frank_kamenetskii", fk_gamma=9.2, k=1.0, cp=0.01),
        Material(rho0=90.0, alpha=0.5, eta0=10.0, k=2.0, cp=0.02, H=1.5),
        Material(rho0=80.0, alpha=0.2, T_ref=0.5, eta0=3.0,
                 viscosity="arrhenius", E_act=3.0, k=0.5, cp=0.03),
    ][:max(mats, 1)])
    cfg = fk_stagnant_lid(nx=20, ny=14)
    phys = dataclasses.replace(cfg.physics, gx=0.4, eta_avg=eta_avg)
    grid = StaggeredGrid(nx=20, ny=14, lx=1.0, ly=1.0)
    got = m2g.m2g_fused(bm, grid, table, phys, with_energy=True)
    ref = m2g.m2g_fused_plain(bm, grid, table, phys, with_energy=True)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, k


@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("bcs", BCS)
def test_advect_kernel(dev, reach, bcs):
    bm = _markers(24, 18, dev)
    grid = StaggeredGrid(nx=24, ny=18, lx=1.0, ly=1.0)
    rng = np.random.default_rng(2)
    vx = torch.tensor(rng.uniform(-1, 1, grid.shape_vx), dtype=torch.float32,
                      device=dev)
    vy = torch.tensor(rng.uniform(-1, 1, grid.shape_vy), dtype=torch.float32,
                      device=dev)
    dt = torch.tensor(0.45 * reach * grid.dx, device=dev)
    got = advect.advect_rk4_fused(bm, vx, vy, dt, grid, bcs, reach)
    ref = advect.advect_rk4_plain(bm, vx, vy, dt, grid, bcs, reach)
    # displacements (what the kernel computes), not positions: a marker
    # moves ~0.02 here, so a whole-position bar would hide a stage error
    assert _rel(got.x - bm.x, ref.x - bm.x) <= 1e-4
    assert _rel(got.y - bm.y, ref.y - bm.y) <= 1e-4


REBUCKET_CAPACITIES = [1, 9, 18, 32, 33]


def _rebucket_markers(ny, nx, K, dev, seed, periodic=False):
    """Seeded (ny, nx, K) markers as advection leaves them: each slot in
    its own cell, displaced by up to 0.95 of a cell, about half of them
    valid; a sixth of the coordinates exactly on a cell edge (k dx in f32);
    every valid marker of the 3x3 neighbourhood of the middle cell moved
    into that cell (more arrivals than slots, so drops for K < 9 * 0.55 K);
    x clipped to [0, lx] (walls) or wrapped into [0, lx) with the seam
    placements 0, -1e-7, 1e-7 (column 0) and lx - 1e-7, lx (column nx - 1)
    kept unwrapped (periodic)."""
    from pylamp_tpu_torch.markers.bucket import wrap_x

    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.0, ly=1.0)
    rng = np.random.default_rng(seed)
    shape = (ny, nx, K)
    dx, dy = np.float32(grid.dx), np.float32(grid.dy)
    cj, ci = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    cj, ci = cj[..., None], ci[..., None]
    x = ((ci + rng.uniform(0, 1, shape) + rng.uniform(-0.95, 0.95, shape))
         * dx).astype(np.float32)
    y = ((cj + rng.uniform(0, 1, shape) + rng.uniform(-0.95, 0.95, shape))
         * dy).astype(np.float32)
    valid = rng.uniform(size=shape) < 0.55
    for a, c, d in ((x, ci, dx), (y, cj, dy)):
        edge = rng.uniform(size=shape) < 1 / 6
        k = (c + rng.integers(0, 2, shape)).astype(np.float32)
        a[edge] = (k * d)[edge]
    mj, mi = ny // 2, nx // 2
    hood = (slice(max(mj - 1, 0), mj + 2), slice(max(mi - 1, 0), mi + 2))
    x[hood] = ((mi + rng.uniform(0, 1, x[hood].shape)) * dx).astype(np.float32)
    y[hood] = ((mj + rng.uniform(0, 1, y[hood].shape)) * dy).astype(np.float32)
    valid[hood] = True
    y = np.clip(y, 0.0, np.float32(grid.ly))
    mat = rng.integers(0, 3, shape).astype(np.int32)
    T = rng.standard_normal(shape).astype(np.float32)
    x = torch.tensor(x, device=dev)
    if periodic:
        x = wrap_x(x, grid.lx)
        seam = [(0, 0.0), (0, -1e-7), (0, 1e-7), (nx - 1, grid.lx - 1e-7),
                (nx - 1, grid.lx)]
        for s, (col, v) in enumerate(seam):
            if s % 3 < K:
                x[:, col, s % 3] = v
    else:
        x = torch.clamp(x, 0.0, grid.lx)
    bm = BucketedMarkers(
        x=x.contiguous(), y=torch.tensor(y, device=dev),
        mat=torch.tensor(mat, device=dev), T=torch.tensor(T, device=dev),
        valid=torch.tensor(valid, device=dev))
    return bm, grid


def _same_rebucket(got, ref):
    (gm, gd), (rm, rd) = got, ref
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(gm, f), getattr(rm, f)), f
    assert gd.dtype == torch.int64 and gd.dim() == 0
    assert int(gd) == int(rd)


@pytest.mark.parametrize("capacity", REBUCKET_CAPACITIES)
@pytest.mark.parametrize("ny,nx", [(13, 17), (37, 23), (65, 33), (70, 100)])
def test_rebucket_kernel(dev, ny, nx, capacity):
    """Kernel 4 at shapes that are no multiple of its 32-column strips or
    32-row chunks (one strip wide; a one-column last strip; a one-row last
    chunk), K from 1 to 33 (one ballot and two per source cell), markers
    on exact cell edges and a crowded neighbourhood: identical slot for
    slot to the plain version with the same drop count, a rerun too."""
    moved, grid = _rebucket_markers(ny, nx, capacity, dev, 3 + capacity)
    n0 = rebucket.launches
    got = rebucket.rebucket_fused(moved, grid)
    assert rebucket.launches == n0 + 1
    _same_rebucket(got, rebucket.rebucket_plain(moved, grid))
    if capacity <= 9:
        assert int(got[1]) > 0
    _same_rebucket(got, rebucket.rebucket_fused(moved, grid))


def _level_problem(ny, nx, dev, seed):
    """Seeded f32 level data: viscosities spanning ~e^+-8, kbnd and lambda
    as the solve computes them, residuals and a start iterate."""
    grid = StaggeredGrid(nx=nx, ny=ny, lx=nx / ny, ly=1.0)
    rng = np.random.default_rng(seed)

    def r(shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, device=dev)

    es, en = torch.exp(r(grid.shape_corner, 2.0)), torch.exp(r(grid.shape_center, 2.0))
    _, kbnd = scaling.stokes_scales(scaling.characteristic_viscosity(en), grid)
    return grid, es, en, kbnd, r


@pytest.mark.parametrize("zero_init,emit", [(False, False), (False, True),
                                            (True, False), (True, True)])
@pytest.mark.parametrize("iters", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
@pytest.mark.parametrize("ny,nx", [(16, 256), (1024, 1024)])
def test_cheb_kernel(dev, ny, nx, bc, iters, zero_init, emit):
    """Degrees 1-5 with and without the emitted residual: a halo one ring
    short passes at degree 1 and fails at degree 4."""
    bcs = VelocityBCs(top=bc, bottom=bc, left=bc, right=bc)
    grid, es, en, kbnd, r = _level_problem(ny, nx, dev, 21 + iters)
    lam = mg.gershgorin_lambda(es, en, grid, bcs, kbnd)
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    if zero_init:
        ex = torch.zeros(grid.shape_vx, device=dev)
        ey = torch.zeros(grid.shape_vy, device=dev)
    else:
        ex, ey = r(grid.shape_vx), r(grid.shape_vy)
    prep = cheb.prep_smoother(es, en, grid, bcs, kbnd, lam, iters + emit)
    n0 = cheb.launches
    got = cheb.chebyshev_smooth(ex, ey, rx, ry, prep, grid, bcs, iters,
                                zero_init, emit)
    assert cheb.launches == n0 + 1
    ref = cheb.chebyshev_smooth_plain(ex, ey, rx, ry, es, en, grid, bcs, kbnd,
                                      lam, iters, zero_init, emit)
    assert len(got) == len(ref)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 2e-5


@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
@pytest.mark.parametrize("n", [64, 128])
def test_coarse_vcycle_kernel(dev, n, bc):
    bcs = VelocityBCs(top=bc, bottom=bc, left=bc, right=bc)
    grid, es, en, kbnd, r = _level_problem(n, n, dev, 31)
    plan, grids, etas, kbnds = mg._hierarchy(es, en, grid, kbnd, 0, 2.0)
    lam = mg.estimate_mg_lambdas(es, en, grid, bcs, kbnd, semicoarsen=2.0,
                                 mode="gershgorin")
    prep = cvk.CoarseVcyclePrep(grids, etas, kbnds, lam, bcs, 4, 4, 32)
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    n0 = cvk.launches
    got = cvk.coarse_vcycle(rx, ry, prep)
    assert cvk.launches == n0 + 1
    ref = cvk.coarse_vcycle_plain(rx, ry, prep)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 2e-5
    # the scratch is reused: a second call gives the same answer
    again = cvk.coarse_vcycle(rx, ry, prep)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_cheb_and_coarse_wrappers_raise(dev):
    """CPU, f64 and non-contiguous inputs raise; nothing falls back."""
    bcs = VelocityBCs()
    grid, es, en, kbnd, r = _level_problem(16, 256, dev, 41)
    lam = mg.gershgorin_lambda(es, en, grid, bcs, kbnd)
    prep = cheb.prep_smoother(es, en, grid, bcs, kbnd, lam, 5)
    ex, ey, rx, ry = (r(grid.shape_vx), r(grid.shape_vy), r(grid.shape_vx),
                      r(grid.shape_vy))
    ny, nx = grid.ny, grid.nx
    strided = torch.zeros((nx + 1, ny), device=dev).t()  # (ny, nx+1) view
    bad = [(ex.cpu(), ey, rx, ry), (ex.double(), ey, rx, ry),
           (ex, ey, strided, ry)]
    for args in bad:
        with pytest.raises(ValueError):
            cheb.chebyshev_smooth_cuda(*args, prep, grid, bcs, 4)
    with pytest.raises(ValueError):  # deeper than the prepped halo
        cheb.chebyshev_smooth_cuda(ex, ey, rx, ry, prep, grid, bcs, 5,
                                   emit_residual=True)

    g64, es, en, kbnd, r = _level_problem(64, 64, dev, 42)
    _, grids, etas, kbnds = mg._hierarchy(es, en, g64, kbnd, 0, 2.0)
    lam = mg.estimate_mg_lambdas(es, en, g64, bcs, kbnd, semicoarsen=2.0,
                                 mode="gershgorin")
    prep = cvk.CoarseVcyclePrep(grids, etas, kbnds, lam, bcs, 4, 4, 32)
    rx, ry = r(g64.shape_vx), r(g64.shape_vy)
    strided = torch.zeros((65, 64), device=dev).t()
    for args in ((rx.cpu(), ry), (rx.double(), ry), (strided, ry)):
        with pytest.raises(ValueError):
            cvk.coarse_vcycle_cuda(*args, prep)


@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
@pytest.mark.parametrize("ny,nx", [(256, 1024), (128, 512), (1024, 1024),
                                   (23, 37), (333, 517), (16, 32), (17, 33),
                                   (15, 31), (2, 2)])
def test_momentum_kernel(dev, ny, nx, bc):
    """Kernel 7 at the sticky-air levels it takes, at 1024^2 and at shapes
    no tile divides (one tile exactly, one point row and column over, one
    under, the smallest grid); the bar of the TPU kernel's test."""
    bcs = VelocityBCs(top=bc, bottom="free_slip", left="no_slip", right=bc)
    grid, es, en, kbnd, r = _level_problem(ny, nx, dev, 51)
    vx, vy = r(grid.shape_vx), r(grid.shape_vy)
    prep = momentum.prep_momentum(es, en, kbnd)
    n0 = momentum.launches
    got = momentum.momentum_apply_kernel(vx, vy, prep, grid, bcs)
    assert momentum.launches == n0 + 1
    ref = momentum.momentum_apply_plain(vx, vy, es, en, grid, bcs, kbnd)
    for g, rf in zip(got, ref):
        assert g.shape == rf.shape
        assert _rel(g, rf) <= 1e-5
    # through the MG dispatcher on an eligible level
    if mg._pallas_eligible(grid, torch.float32):
        out = mg.momentum_apply(vx, vy, es, en, grid, bcs, kbnd,
                                use_pallas=True, prepped=prep)
        assert momentum.launches == n0 + 2
        for o, g in zip(out, got):
            assert torch.equal(o, g)


def test_momentum_wrapper_raises(dev):
    """CPU, f64 and non-contiguous inputs raise; nothing falls back."""
    bcs = VelocityBCs()
    grid, es, en, kbnd, r = _level_problem(128, 512, dev, 52)
    vx, vy = r(grid.shape_vx), r(grid.shape_vy)
    prep = momentum.prep_momentum(es, en, kbnd)
    strided = torch.zeros((grid.nx + 1, grid.ny), device=dev).t()
    for args in ((vx.cpu(), vy), (vx.double(), vy), (strided, vy),
                 (vx, vy[:-1])):
        with pytest.raises(ValueError):
            momentum.momentum_apply_cuda(*args, prep, grid, bcs)


@pytest.mark.parametrize("zero_init", [True, False])
@pytest.mark.parametrize("ny,nx", [(256, 1024), (128, 512), (64, 256)])
def test_cheb_kernel_depth7(dev, ny, nx, zero_init):
    """The sticky-air sweep: degree 6 with the emitted residual, the
    deepest halo (h = 7), on the three levels it takes, with a 1e4 contrast
    of cell-sharp viscosity layers."""
    bcs = VelocityBCs()
    grid, es, en, kbnd, r = _level_problem(ny, nx, dev, 61)
    es, en = _layered(grid, es, en)
    lam = mg.gershgorin_lambda(es, en, grid, bcs, kbnd)
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    ex = torch.zeros_like(rx) if zero_init else r(grid.shape_vx)
    ey = torch.zeros_like(ry) if zero_init else r(grid.shape_vy)
    assert cheb.smoother_eligible(grid, torch.float32, 6, True)
    prep = cheb.prep_smoother(es, en, grid, bcs, kbnd, lam, 7)
    got = cheb.chebyshev_smooth(ex, ey, rx, ry, prep, grid, bcs, 6,
                                zero_init, True)
    ref = cheb.chebyshev_smooth_plain(ex, ey, rx, ry, es, en, grid, bcs, kbnd,
                                      lam, 6, zero_init, True)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 2e-5


def _layered(grid, es, en):
    """Viscosities with three cell-sharp horizontal layers (1e-2, 1e2, 1 of
    the random field), the sticky-air structure."""
    def layers(a):
        rows = torch.arange(a.shape[0], device=a.device)[:, None]
        scale = torch.where(rows < a.shape[0] // 5, 1e-2,
                            torch.where(rows < 2 * a.shape[0] // 5, 1e2, 1.0))
        return (a * scale).contiguous()
    return layers(es), layers(en)


@pytest.mark.parametrize("ny,nx", [(32, 128), (16, 64)])
def test_coarse_vcycle_sticky_air(dev, ny, nx):
    """Kernel 6 on a 4:1 hierarchy from the sticky-air fusion start (and
    one level below it) at the preset's degree 6 and coarse_iters 32, with
    eta capped at 1e2 around each level's geometric mean and power-iteration
    bounds."""
    bcs = VelocityBCs()
    grid, es, en, kbnd, r = _level_problem(ny, nx, dev, 71)
    es, en = _layered(grid, es, en)
    _, grids, etas, kbnds = mg._hierarchy(es, en, grid, kbnd, 0, 2.0)
    assert all(g.nx == 4 * g.ny for g in grids)
    etas = [etas[0]] + [(mg._cap_eta(a, 1e2), mg._cap_eta(b, 1e2))
                        for a, b in etas[1:]]
    lam = mg.estimate_mg_lambdas(es, en, grid, bcs, kbnd, semicoarsen=2.0)
    prep = cvk.CoarseVcyclePrep(grids, etas, kbnds, lam, bcs, 6, 6, 32)
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    got = cvk.coarse_vcycle(rx, ry, prep)
    ref = cvk.coarse_vcycle_plain(rx, ry, prep)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 2e-5


def test_marker_kernels_sticky_air_si(dev):
    """Kernels 1-4 on a 4:1 grid in SI units (sticky-air 256x64, K = 18,
    positions up to 2.8e6 m, eta 1e19-1e23): m2g with and without the
    energy streams, RK4 advection at half a cell per step, rebucket
    bit-identical, the saddle apply at the SI viscosities."""
    cfg = sticky_air(256, 64)
    grid, table, st = build(cfg, dtype=torch.float32, device=dev)
    bm, phys, vbc = st.markers, cfg.physics, cfg.physics.velocity_bcs
    assert bm.x.shape == (64, 256, 18)
    for with_energy in (False, True):
        got = m2g.m2g_fused(bm, grid, table, phys, with_energy=with_energy)
        ref = m2g.m2g_fused_plain(bm, grid, table, phys,
                                  with_energy=with_energy)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert _rel(got[k], ref[k]) <= 1e-5, k
    rng = np.random.default_rng(81)
    vscale = 1e-9  # m/s, about 3 cm/yr
    vx = torch.tensor(rng.uniform(-1, 1, grid.shape_vx) * vscale,
                      dtype=torch.float32, device=dev)
    vy = torch.tensor(rng.uniform(-1, 1, grid.shape_vy) * vscale,
                      dtype=torch.float32, device=dev)
    dt = torch.tensor(0.45 * min(grid.dx, grid.dy) / vscale, device=dev)
    moved = advect.advect_rk4_fused(bm, vx, vy, dt, grid, vbc, 1)
    ref = advect.advect_rk4_plain(bm, vx, vy, dt, grid, vbc, 1)
    assert _rel(moved.x - bm.x, ref.x - bm.x) <= 1e-4
    assert _rel(moved.y - bm.y, ref.y - bm.y) <= 1e-4
    (gm, gd), (rm, rd) = (rebucket.rebucket_fused(moved, grid),
                          rebucket.rebucket_plain(moved, grid))
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(gm, f), getattr(rm, f)), f
    assert int(gd) == int(rd)
    es, en = st.eta_s.float(), st.eta_n.float()
    kcont, kbnd = scaling.stokes_scales(scaling.characteristic_viscosity(en),
                                        grid)
    prep = saddle.prep_saddle(es, en, kcont, kbnd)
    u = [torch.tensor(rng.standard_normal(sh) * sc, dtype=torch.float32,
                      device=dev)
         for sh, sc in ((grid.shape_vx, vscale), (grid.shape_vy, vscale),
                        (grid.shape_center, 1e7))]
    got = saddle.saddle_apply(*u, prep, grid, vbc)
    ref = saddle.saddle_apply_plain(*u, prep, grid, vbc)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 1e-5


# -- the per-shard kernels (8-12) of the explicit-halo mesh path --------------

@pytest.mark.parametrize("with_p", [True, False])
@pytest.mark.parametrize("S,by,bx", [(8, 256, 512), (8, 128, 256),
                                     (8, 21, 38), (8, 24, 40), (8, 17, 33),
                                     (8, 20, 64), (8, 32, 40), (9, 64, 128),
                                     (9, 21, 38)])
def test_saddle_block_kernel(dev, S, by, bx, with_p):
    """Kernel 9 in both forms on the shards' extended blocks, at the 4x2
    blocks of FK 1024^2 and 512^2, at odd shapes whose last row or column
    of 16 x 32 tiles is partial (21x38, 24x40 and 17x33 in both
    dimensions, 20x64 in y only, 32x40 in x only) and on a 3x3 mesh; a
    rerun bit-identical."""
    from pylamp_tpu_torch.ops.kernels import saddle_block

    gen = torch.Generator(device=dev).manual_seed(91)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ext = (S, by + 2, bx + 2)
    vx, vy, en = r(*ext), r(*ext), torch.exp(2.0 * r(*ext))
    es = torch.exp(2.0 * r(S, by + 1, bx + 1))
    p = r(*ext) if with_p else None
    n0 = saddle_block.launches
    got = saddle_block.saddle_block(vx, vy, p, es, en, 1 / bx, 1 / by, 3.5)
    assert saddle_block.launches == n0 + 1
    ref = saddle_block.saddle_block_plain(vx, vy, p, es, en, 1 / bx, 1 / by,
                                          3.5)
    assert len(got) == len(ref) == (3 if with_p else 2)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 1e-5
    for g, a in zip(got, saddle_block.saddle_block(vx, vy, p, es, en, 1 / bx,
                                                   1 / by, 3.5)):
        assert torch.equal(g, a)


@pytest.mark.parametrize("zero_init", [True, False])
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
@pytest.mark.parametrize("n,mesh_n", [(1024, 8), (512, 8), (256, 8),
                                      (68, 4), (384, 9), (256, 16)])
def test_cheb_block_kernel(dev, n, mesh_n, bc, zero_init):
    """Kernel 8 (degree 4 + the emitted residual, h = 5) on the frames of
    the FK levels 1024-256 on the 4x2 mesh (corner and edge shards), of an
    odd 2x2 level (34x34 blocks) and of 3x3 and 4x4 meshes (interior
    shards: the branch-free path on whole shards): against its plain
    version on the same frames, and the whole explicit-halo sweep against
    the single-device plain sweep."""
    from pylamp_tpu_torch.ops.kernels import cheb_block
    from pylamp_tpu_torch.parallel import halo_smoother as hs
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_n)
    bcs = VelocityBCs(top=bc, bottom="free_slip", left=bc, right="no_slip")
    grid, es, en, kbnd, r = _level_problem(n, n, dev, 93)
    lam = mg.gershgorin_lambda(es, en, grid, bcs, kbnd)
    deg = 4
    assert hs.halo_smoother_eligible(grid, mesh, bcs, torch.float32, deg,
                                     emit_residual=True)
    prep = hs.prep_halo_smoother(es, en, grid, mesh, deg + 1, kbnd, lam)
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    ex = torch.zeros_like(rx) if zero_init else r(grid.shape_vx)
    ey = torch.zeros_like(ry) if zero_init else r(grid.shape_vy)
    frames = hs.smoother_frames(ex, ey, rx, ry, bcs, mesh, prep.h)
    n0 = cheb_block.launches
    got = cheb_block.cheb_block(*frames, prep, grid, bcs, deg, zero_init, True)
    assert cheb_block.launches == n0 + 1
    ref = cheb_block.cheb_block_plain(*frames, prep, grid, bcs, deg,
                                      zero_init, True)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 2e-5
    whole = hs.chebyshev_smooth_halo(ex, ey, rx, ry, grid, bcs, kbnd, lam,
                                     deg, mesh, prep, zero_init, True)
    single = cheb.chebyshev_smooth_plain(ex, ey, rx, ry, es, en, grid, bcs,
                                         kbnd, lam, deg, zero_init, True)
    for g, rf in zip(whole, single):
        assert _rel(g, rf) <= 2e-5


@pytest.mark.parametrize("depth", range(1, 8))
@pytest.mark.parametrize("n,mesh_n,extra", [(96, 9, 0), (128, 16, 0),
                                            (256, 8, 0), (96, 9, 2),
                                            (72, 4, 1)])
def test_cheb_block_kernel_depths(dev, depth, n, mesh_n, extra):
    """Kernel 8 at every depth 1-7 (zero and non-zero start, with and
    without the emitted residual) on meshes with corner, edge and interior
    shards, on frames ``extra`` rings deeper than the sweep (the load is
    offset into them): against its plain version, and a rerun
    bit-identical.  The random e^+-8 field at every depth (the mesh smooths
    FK levels; sticky air's layered field never runs there), and each
    output held to 2e-5 of the plain version or to f32 rounding
    (_f32_agrees), as test_cheb_kernel_periodic holds kernel 5: at depth 7
    the emitted residual of kernels 5 and 8 alike can part from the f32
    plain version by ~2e-5 where that version is itself ~1e-5 off an f64
    evaluation."""
    from pylamp_tpu_torch.ops.kernels import cheb_block
    from pylamp_tpu_torch.parallel import halo_smoother as hs
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_n)
    bcs = BCS[2]
    grid, es, en, kbnd, r = _level_problem(n, n, dev, 120 + depth)
    lam = mg.gershgorin_lambda(es, en, grid, bcs, kbnd)
    h = depth + extra
    prep = hs.prep_halo_smoother(es, en, grid, mesh, h, kbnd, lam)
    prep64 = dataclasses.replace(prep, es_v=prep.es_v.double(),
                                 en_v=prep.en_v.double(),
                                 coeffs=prep.coeffs.double(),
                                 kb=prep.kb.double())
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    start = {True: (torch.zeros_like(rx), torch.zeros_like(ry)),
             False: (r(grid.shape_vx), r(grid.shape_vy))}
    for emit in (False, True):
        iters = depth - emit
        if iters < 1:
            continue
        for zero_init in (True, False):
            frames = hs.smoother_frames(*start[zero_init], rx, ry, bcs, mesh,
                                        h)
            got = cheb_block.cheb_block_cuda(*frames, prep, grid, bcs, iters,
                                             zero_init, emit)
            ref = cheb_block.cheb_block_plain(*frames, prep, grid, bcs, iters,
                                              zero_init, emit)
            ref64 = cheb_block.cheb_block_plain(
                *(f.double() for f in frames), prep64, grid, bcs, iters,
                zero_init, emit)
            for g, rf, r64 in zip(got, ref, ref64):
                assert _f32_agrees(g, rf, r64, 2e-5), (emit, zero_init)
            again = cheb_block.cheb_block_cuda(*frames, prep, grid, bcs,
                                               iters, zero_init, emit)
            for g, a in zip(got, again):
                assert torch.equal(g, a)


def _mesh_markers(nx, ny, dev, mesh):
    """Built FK markers on the card, displaced by up to 0.45 cells, split
    over ``mesh``: the global state and its per-shard blocks."""
    from pylamp_tpu_torch.parallel.halo_markers import BLK3

    bm = _markers(nx, ny, dev)
    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.0, ly=1.0)
    by, bx = ny // mesh.my, nx // mesh.mx
    ext = [mesh.flat(mesh.ext1(mesh.split(a, BLK3), nd=3))
           for a in (bm.x, bm.y, bm.T, bm.mat, bm.valid)]
    return bm, grid, ext, mesh.bases(by, bx, device=dev)


@pytest.mark.parametrize("n,mesh_n", [(1024, 8), (40, 4)])
def test_m2g_block_kernel(dev, n, mesh_n):
    """Kernel 10 on the extended blocks of the FK markers (K = 18) at the
    4x2 blocks of 1024^2 and an odd 2x2 mesh (20x20 blocks), against its
    plain version on the whole frames (the partial last row and column
    included); and the halo transfer bit-identical to kernel 2 on every
    stream (kernel 2's body in the same order)."""
    from pylamp_tpu_torch.markers.kernels import m2g_block
    from pylamp_tpu_torch.parallel.halo_markers import m2g_fused_halo
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_n)
    cfg = fk_stagnant_lid(nx=n, ny=n)
    bm, grid, ext, bases = _mesh_markers(n, n, dev, mesh)
    table = MaterialTable(cfg.physics.materials)
    n0 = m2g_block.launches
    got = m2g_block.m2g_fused_block(*ext, grid, table, cfg.physics, bases,
                                    with_energy=True)
    assert m2g_block.launches == n0 + 1
    ref = m2g_block.m2g_fused_block_plain(*ext, grid, table, cfg.physics,
                                          bases, with_energy=True)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, k
    halo = m2g_fused_halo(bm, grid, table, cfg.physics, mesh, True)
    glob = m2g.m2g_fused(bm, grid, table, cfg.physics, with_energy=True)
    assert sorted(halo) == sorted(glob)
    for k in glob:
        assert torch.equal(halo[k], glob[k]), k


@pytest.mark.parametrize("streams", [("fk", 0.0, False), ("fk", 0.4, True),
                                     ("three", 0.4, True)],
                         ids=lambda s: f"{s[0]}-gx{s[1]}-ra{s[2]:d}")
@pytest.mark.parametrize("K", [1, 9, 33])
@pytest.mark.parametrize("ny,nx,my,mx", [(48, 66, 2, 2), (72, 72, 3, 3)])
def test_m2g_block_kernel_odd(dev, ny, nx, my, mx, K, streams):
    """Kernel 10 on seeded markers (_synthetic_markers: off their cells, on
    cell and domain edges, a full cell, an empty tile) at 24x33 blocks
    (bx + 1 = 34 node columns, no multiple of the strip) and at the 3x3
    mesh's 24x24 blocks (interior shards), K 1, 9 and 33 (one to three
    units a cell row), with and without the vx streams and rho0 * alpha:
    within 1e-5 of its plain version per stream on the whole frames, and
    the halo transfer bit-identical to kernel 2."""
    from pylamp_tpu_torch.markers.kernels import m2g_block
    from pylamp_tpu_torch.parallel.halo_markers import (
        _ext_blocks,
        m2g_fused_halo,
    )
    from pylamp_tpu_torch.parallel.mesh import Mesh

    name, gx, with_ra = streams
    mesh = Mesh(my, mx)
    bm, grid = _synthetic_markers(ny, nx, K, dev, 521 + K, False)
    cfg = fk_stagnant_lid(nx=nx, ny=ny)
    table = (MaterialTable(RA_TABLE) if name == "three"
             else MaterialTable(cfg.physics.materials))
    if name == "fk":
        bm = bm.replace(mat=torch.zeros_like(bm.mat))
    phys = dataclasses.replace(cfg.physics, gx=gx)
    by, bx = ny // my, nx // mx
    ext = _ext_blocks(mesh, bm.x, bm.y, bm.T, bm.mat, bm.valid)
    bases = mesh.bases(by, bx, device=dev)
    kw = dict(with_energy=True, with_ra=with_ra)
    got = m2g_block.m2g_fused_block(*ext, grid, table, phys, bases, **kw)
    ref = m2g_block.m2g_fused_block_plain(*ext, grid, table, phys, bases,
                                          **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, k
    halo = m2g_fused_halo(bm, grid, table, phys, mesh, **kw)
    glob = m2g.m2g_fused(bm, grid, table, phys, **kw)
    assert sorted(halo) == sorted(glob)
    for k in glob:
        assert torch.equal(halo[k], glob[k]), k


@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("n,mesh_n", [(1024, 8), (40, 4)])
def test_advect_block_kernel(dev, n, mesh_n, reach):
    """Kernel 11 on the FK markers with random velocities, the windows the
    halo engine exchanges, against its plain version and the halo advection
    against kernel 3; and on windows cut from kernel 3's padded lattices,
    bit-identical to kernel 3."""
    from pylamp_tpu_torch.markers.kernels import advect_block
    from pylamp_tpu_torch.parallel.halo_markers import advect_rk4_halo
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_n)
    bm, grid, _, _ = _mesh_markers(n, n, dev, mesh)
    bcs = VelocityBCs(top="no_slip", right="no_slip")
    rng = np.random.default_rng(95)
    vx = torch.tensor(rng.uniform(-1, 1, grid.shape_vx), dtype=torch.float32,
                      device=dev)
    vy = torch.tensor(rng.uniform(-1, 1, grid.shape_vy), dtype=torch.float32,
                      device=dev)
    dt = torch.tensor(0.45 * reach * grid.dx, device=dev)
    n0 = advect_block.launches
    got = advect_rk4_halo(bm, vx, vy, dt, grid, bcs, mesh, reach, True)
    assert advect_block.launches == n0 + 1
    plain = advect_rk4_halo(bm, vx, vy, dt, grid, bcs, mesh, reach, False)
    glob = advect.advect_rk4_fused(bm, vx, vy, dt, grid, bcs, reach)
    for ref in (plain, glob):
        for g, rf, s in ((got.x, ref.x, bm.x), (got.y, ref.y, bm.y)):
            assert _disp_rel(g, rf, s) <= 1e-4
    # fed the windows cut from kernel 3's own padded lattices, kernel 11
    # gives kernel 3's new positions bit for bit (one body, one RK4)
    cut = _cut_advect(bm, vx, vy, dt, grid, bcs, mesh, reach)
    assert torch.equal(cut.x, glob.x) and torch.equal(cut.y, glob.y)


def _cut_advect(bm, vx, vy, dt, grid, bcs, mesh, reach):
    """Kernel 11 on every shard's windows cut from the padded lattices
    that kernel 3 samples, gathered into the global layout."""
    from pylamp_tpu_torch.markers.bucket import padded_velocities
    from pylamp_tpu_torch.markers.kernels import advect_block
    from pylamp_tpu_torch.parallel.halo_markers import BLK3

    by, bx = grid.ny // mesh.my, grid.nx // mesh.mx
    bases = mesh.bases(by, bx, device=vx.device)
    vx_p, vy_p = padded_velocities(vx.float(), vy.float(), bcs)
    wins = advect_block.cut_windows(vx_p, vy_p, bases, by, bx, reach)
    own = [mesh.flat(mesh.split(a, BLK3)) for a in (bm.x, bm.y, bm.valid)]
    ox, oy = advect_block.advect_block_cuda(*own, *wins, dt, grid, bases,
                                            reach)
    return bm.replace(x=mesh.gather(mesh.unflat(ox), BLK3),
                      y=mesh.gather(mesh.unflat(oy), BLK3))


@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("K", [1, 9, 33])
@pytest.mark.parametrize("ny,nx,my,mx", [(48, 66, 2, 2), (72, 72, 3, 3)])
def test_advect_block_kernel_odd(dev, ny, nx, my, mx, K, reach):
    """Kernel 11 on seeded markers (_synthetic_markers) with seeded
    velocities at 24x33 and the 3x3 mesh's 24x24 blocks, K 1, 9 and 33,
    both stage reaches: on windows cut from kernel 3's padded lattices
    bit-identical to kernel 3, and through the halo advection within the
    displacement bar of the plain version."""
    from pylamp_tpu_torch.parallel.halo_markers import advect_rk4_halo
    from pylamp_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(my, mx)
    bm, grid = _synthetic_markers(ny, nx, K, dev, 601 + K, False)
    bcs = VelocityBCs(top="no_slip", left="no_slip")
    rng = np.random.default_rng(611 + K + reach)
    vx = torch.tensor(rng.uniform(-0.3, 0.3, grid.shape_vx),
                      dtype=torch.float32, device=dev)
    vy = torch.tensor(rng.uniform(-0.5, 0.5, grid.shape_vy),
                      dtype=torch.float32, device=dev)
    dt = torch.tensor(0.45 * reach * grid.dx, device=dev)
    glob = advect.advect_rk4_fused(bm, vx, vy, dt, grid, bcs, reach)
    cut = _cut_advect(bm, vx, vy, dt, grid, bcs, mesh, reach)
    assert torch.equal(cut.x, glob.x) and torch.equal(cut.y, glob.y)
    got = advect_rk4_halo(bm, vx, vy, dt, grid, bcs, mesh, reach, True)
    ref = advect_rk4_halo(bm, vx, vy, dt, grid, bcs, mesh, reach, False)
    assert _disp_rel(got.x, ref.x, bm.x) <= 1e-4
    assert _disp_rel(got.y, ref.y, bm.y) <= 1e-4


def _disp_rel(got, ref, start):
    """Displacement error beyond one f32 spacing of the position (both
    sides round start + displacement last), over max |displacement|: at
    1024^2 a marker moves ~6e-4, so one spacing of a position near 1 is
    ~1e-4 of it."""
    top = torch.maximum(torch.abs(got), torch.abs(ref))
    spacing = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
    excess = torch.clamp(torch.abs(got.double() - ref.double())
                         - spacing.double(), min=0.0)
    return float(torch.max(excess)) / float(
        torch.max(torch.abs(ref.double() - start.double())))


@pytest.mark.parametrize("capacity", [18, 9, 1, 33, 64])
@pytest.mark.parametrize("n,mesh_n", [(1024, 8), (40, 4), (72, 9)])
def test_rebucket_block_kernel(dev, n, mesh_n, capacity):
    """Kernel 12 bit-identical to its plain version, arrivals included, and
    the halo rebucket to kernel 4 with the same drops, with markers
    displaced across the seams: at the 4x2 blocks of FK 1024^2, at 20x20
    and 24x24 blocks narrower than one 32-column strip (2x2 and 3x3
    meshes), and at K 1, 9, 18, 33 and 64 (the FK markers' 18 slots cut,
    or padded with empty slots); capacities 9 and 1 force overflow
    drops."""
    from pylamp_tpu_torch.markers.kernels import rebucket_block
    from pylamp_tpu_torch.parallel.halo_markers import BLK3, rebucket_halo
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_n)
    bm = _markers(n, n, dev)
    grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
    gen = torch.Generator(device=dev).manual_seed(97)
    dx = (torch.rand(bm.x.shape, generator=gen, device=dev) - 0.5) * 1.9 * grid.dx
    dy = (torch.rand(bm.x.shape, generator=gen, device=dev) - 0.5) * 1.9 * grid.dy
    def cap(a):
        """a cut to ``capacity`` slots, or padded with empty ones"""
        pad = capacity - a.shape[-1]
        if pad <= 0:
            return a[..., :capacity].contiguous()
        return torch.cat([a, torch.zeros(a.shape[:-1] + (pad,),
                                         dtype=a.dtype, device=dev)], -1)

    moved = BucketedMarkers(
        x=cap(torch.clamp(bm.x + dx, 1e-6, 1 - 1e-6)),
        y=cap(torch.clamp(bm.y + dy, 1e-6, 1 - 1e-6)),
        mat=cap(bm.mat), T=cap(bm.T), valid=cap(bm.valid))
    by, bx = n // mesh.my, n // mesh.mx
    ext = [mesh.flat(mesh.ext1(mesh.split(a, BLK3), nd=3))
           for a in (moved.x, moved.y, moved.T, moved.mat, moved.valid)]
    bases = mesh.bases(by, bx, device=dev)
    n0 = rebucket_block.launches
    got, ga = rebucket_block.rebucket_block(*ext, grid, bases)
    assert rebucket_block.launches == n0 + 1
    ref, ra = rebucket_block.rebucket_block_plain(*ext, grid, bases)
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(ga, ra)
    (hm, hd), (gm, gd) = (rebucket_halo(moved, grid, mesh),
                          rebucket.rebucket_fused(moved, grid))
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(hm, f), getattr(gm, f)), f
    assert int(hd) == int(gd)
    if capacity <= 9:
        assert int(gd) > 0


# -- the periodic forms of kernels 10-12 (port-only) -------------------------

def _wrapped_disp_rel(got, ref, start, lx):
    """``_disp_rel`` of positions that wrap with period ``lx``: the
    difference taken to the nearest period first."""
    d = got.double() - ref.double()
    d = d - lx * torch.round(d / lx)
    return _disp_rel(ref + d.to(ref.dtype), ref, start)


@pytest.mark.parametrize("ny,nx,my,mx,K", [(1024, 1024, 4, 2, 18),
                                           (48, 66, 2, 2, 9),
                                           (72, 72, 3, 3, 33),
                                           (40, 80, 2, 4, 1)])
def test_periodic_block_kernels(dev, ny, nx, my, mx, K):
    """Kernels 10p, 11p and 12p on the ring-exchanged blocks of periodic
    seeded markers (_synthetic_markers: seam placements at 0, +-1e-7 and
    lx - 1e-7, lx) at the 4x2 blocks of 1024^2, at 24x33, at the 3x3
    mesh's 24x24 blocks and on a ring of four (2x4): each within its
    plain version's bar, its periodic launch counted; the halo transfer
    bit-identical to kernel 2p on every stream; kernel 11p on windows cut
    from kernel 3p's wrapped planes bit-identical to kernel 3p at reach 1
    and 2 (the exchanged windows equal those cuts); the halo rebucket
    slot for slot kernel 4p's, with the same drops."""
    from pylamp_tpu_torch.markers.bucket import padded_velocities, wrap_x
    from pylamp_tpu_torch.markers.kernels import (
        advect_block,
        m2g_block,
        rebucket_block,
    )
    from pylamp_tpu_torch.parallel.halo_markers import (
        BLK3,
        _ext_blocks,
        advect_rk4_halo,
        m2g_fused_halo,
        rebucket_halo,
        velocity_windows,
    )
    from pylamp_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(my, mx)
    bm, grid = _synthetic_markers(ny, nx, K, dev, 707 + K, True)
    by, bx = ny // my, nx // mx
    bases = mesh.bases(by, bx, device=dev)
    cfg = fk_stagnant_lid(nx=nx, ny=ny)
    table = MaterialTable(RA_TABLE)
    phys = dataclasses.replace(cfg.physics, gx=0.4)
    kw = dict(with_energy=True, with_ra=True, periodic_x=True)
    # kernel 10p
    ext = _ext_blocks(mesh, bm.x, bm.y, bm.T, bm.mat, bm.valid,
                      periodic_x=True)
    n0 = m2g_block.launches_periodic
    got = m2g_block.m2g_fused_block(*ext, grid, table, phys, bases, **kw)
    assert m2g_block.launches_periodic == n0 + 1
    ref = m2g_block.m2g_fused_block_plain(*ext, grid, table, phys, bases,
                                          **kw)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, k
    halo = m2g_fused_halo(bm, grid, table, phys, mesh, True, True, True,
                          True)
    glob = m2g.m2g_fused(bm, grid, table, phys, True, True, True)
    assert sorted(halo) == sorted(glob)
    for k in glob:
        assert torch.equal(halo[k], glob[k]), k
    # kernel 11p: markers in their cells (the rebucketed ones), seam-equal
    # vx
    bcs = _periodic_bcs("no_slip")
    own, _ = rebucket.rebucket_fused(bm, grid, True)
    rng = np.random.default_rng(717 + K)
    vx = torch.tensor(rng.uniform(-0.5, 0.5, grid.shape_vx),
                      dtype=torch.float32, device=dev)
    vx[:, -1] = vx[:, 0]
    vy = torch.tensor(rng.uniform(-0.5, 0.5, grid.shape_vy),
                      dtype=torch.float32, device=dev)
    for reach in (1, 2):
        dt = torch.tensor(0.45 * reach * grid.dx, device=dev)
        vx_p, vy_p = advect.wrapped_planes(
            *padded_velocities(vx, vy, bcs), nx)
        wins = advect_block.cut_windows(vx_p, vy_p, bases, by, bx, reach,
                                        advect.PADW)
        for w, c in zip(velocity_windows(vx, vy, grid, bcs, mesh, reach),
                        wins):
            assert torch.equal(w, c), reach
        blocks = [mesh.flat(mesh.split(a, BLK3))
                  for a in (own.x, own.y, own.valid)]
        n0 = advect_block.launches_periodic
        ox, oy = advect_block.advect_block(*blocks, *wins, dt, grid, bases,
                                           reach, True)
        assert advect_block.launches_periodic == n0 + 1
        ref3 = advect.advect_rk4_fused(own, vx, vy, dt, grid, bcs, reach)
        assert torch.equal(mesh.gather(mesh.unflat(ox), BLK3), ref3.x)
        assert torch.equal(mesh.gather(mesh.unflat(oy), BLK3), ref3.y)
        plain = advect_rk4_halo(own, vx, vy, dt, grid, bcs, mesh, reach,
                                False)
        assert _wrapped_disp_rel(ref3.x, plain.x, own.x, grid.lx) <= 1e-4
        assert _disp_rel(ref3.y, plain.y, own.y) <= 1e-4
    # kernel 12p: the markers moved by up to 0.95 cells, x wrapped
    gen = torch.Generator(device=dev).manual_seed(727 + K)
    shift = (torch.rand(own.x.shape, generator=gen, device=dev) - 0.5) * 1.9
    moved = own.replace(x=wrap_x(own.x + shift * grid.dx, grid.lx))
    ext = _ext_blocks(mesh, moved.x, moved.y, moved.T, moved.mat,
                      moved.valid, periodic_x=True)
    n0 = rebucket_block.launches_periodic
    got, ga = rebucket_block.rebucket_block(*ext, grid, bases, True)
    assert rebucket_block.launches_periodic == n0 + 1
    ref, ra = rebucket_block.rebucket_block_plain(*ext, grid, bases)
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(ga, ra)
    (hm, hd), (gm, gd) = (rebucket_halo(moved, grid, mesh, True, True),
                          rebucket.rebucket_fused(moved, grid, True))
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(hm, f), getattr(gm, f)), f
    assert int(hd) == int(gd)


def test_block_wrappers_raise(dev):
    """CPU, f64 and non-contiguous inputs raise; nothing falls back."""
    from pylamp_tpu_torch.ops.kernels import saddle_block

    S, by, bx = 8, 16, 32
    ext = torch.zeros((S, by + 2, bx + 2), device=dev)
    es = torch.ones((S, by + 1, bx + 1), device=dev)
    strided = torch.zeros((S, bx + 2, by + 2), device=dev).transpose(1, 2)
    for vx in (ext.cpu(), ext.double(), strided):
        with pytest.raises(ValueError):
            saddle_block.saddle_block_cuda(vx, ext, ext, es, ext, 0.1, 0.1)


# kernel 5 where its tilings break: the smallest eligible level, ragged ny
# and nx, the FK (512^2, 256^2) and sticky-air (1024x256, 512x128, 256x64)
# level shapes; 256x1024 and 512^2 have interior tiles, the rest edge
# tiles only
TILING_SHAPES = [(8, 256), (40, 300), (72, 520), (256, 256), (512, 512),
                 (256, 1024), (128, 512), (64, 256)]


@pytest.mark.parametrize("depth", range(1, 8))
@pytest.mark.parametrize("ny,nx", TILING_SHAPES)
def test_cheb_kernel_tilings(dev, ny, nx, depth):
    """Every depth 1-7 in each form (zero and non-zero start, with and
    without the emitted residual) against the plain version, and a rerun
    bit-identical.  Depth 7 on the layered viscosities of the sticky-air
    sweep (as test_cheb_kernel_depth7), shallower sweeps on the random
    e^+-8 field (as test_cheb_kernel)."""
    bcs = BCS[1]
    grid, es, en, kbnd, r = _level_problem(ny, nx, dev, 81 + depth)
    if depth == 7:
        es, en = _layered(grid, es, en)
    lam = mg.gershgorin_lambda(es, en, grid, bcs, kbnd)
    prep = cheb.prep_smoother(es, en, grid, bcs, kbnd, lam, depth)
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    start = {True: (torch.zeros_like(rx), torch.zeros_like(ry)),
             False: (r(grid.shape_vx), r(grid.shape_vy))}
    for emit in (False, True):
        iters = depth - emit
        if iters < 1:
            continue
        for zero_init in (True, False):
            ex, ey = start[zero_init]
            got = cheb.chebyshev_smooth_cuda(ex, ey, rx, ry, prep, grid, bcs,
                                             iters, zero_init, emit)
            ref = cheb.chebyshev_smooth_plain(ex, ey, rx, ry, es, en, grid,
                                              bcs, kbnd, lam, iters,
                                              zero_init, emit)
            for g, rf in zip(got, ref):
                assert _rel(g, rf) <= 2e-5, (emit, zero_init)
            again = cheb.chebyshev_smooth_cuda(ex, ey, rx, ry, prep, grid,
                                               bcs, iters, zero_init, emit)
            for g, a in zip(got, again):
                assert torch.equal(g, a)


def _coarse_prep(ny, nx, dev, seed, bcs, deg, layered=False, nlev=None):
    grid, es, en, kbnd, r = _level_problem(ny, nx, dev, seed)
    if layered:
        es, en = _layered(grid, es, en)
    _, grids, etas, kbnds = mg._hierarchy(es, en, grid, kbnd, 0, 2.0)
    if layered:
        etas = [etas[0]] + [(mg._cap_eta(a, 1e2), mg._cap_eta(b, 1e2))
                            for a, b in etas[1:]]
    lam = mg.estimate_mg_lambdas(es, en, grid, bcs, kbnd, semicoarsen=2.0,
                                 mode="gershgorin")
    n = nlev or len(grids)
    prep = cvk.CoarseVcyclePrep(grids[:n], etas[:n], kbnds[:n], lam[:n], bcs,
                                deg, deg, 32)
    return grid, prep, r


@pytest.mark.parametrize("nlev", [2, 3, 4, 5, 6])
def test_coarse_vcycle_levels(dev, nlev):
    """Kernel 6 from 128^2 with 2-6 levels (the split 128^2 and 64^2
    levels, then CTA 0's), and a rerun bit-identical."""
    grid, prep, r = _coarse_prep(128, 128, dev, 91, BCS[1], 4, nlev=nlev)
    assert prep.nlev == nlev and prep.plans[0].split
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    got = cvk.coarse_vcycle(rx, ry, prep)
    ref = cvk.coarse_vcycle_plain(rx, ry, prep)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 2e-5
    again = cvk.coarse_vcycle(rx, ry, prep)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("n", [80, 96, 112])
def test_coarse_vcycle_gated_starts(dev, n):
    """Kernel 6 from the starts the fusion gate moves to where a cluster
    cannot hold the first level below the cutoff (FK at nx = 640, 384 and
    448 fuse from 80^2, 96^2 and 112^2; 112^2's 56^2 level is split for its
    point count): within the bar of the plain version, rerun bit-identical."""
    grid, prep, r = _coarse_prep(n, n, dev, 95, BCS[1], 4)
    assert prep.plans[0].split and prep.smem <= cvk.SMEM_PER_BLOCK
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    got = cvk.coarse_vcycle(rx, ry, prep)
    ref = cvk.coarse_vcycle_plain(rx, ry, prep)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 2e-5
    again = cvk.coarse_vcycle(rx, ry, prep)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_coarse_vcycle_preps_interleaved(dev):
    """Back-to-back calls on one prep, and two preps (FK 128^2, sticky-air
    128x32 with capped 1e4 jumps) interleaved on one stream: each call
    gives its own answer, bit for bit on a repeat."""
    g_a, a, r_a = _coarse_prep(128, 128, dev, 92, BCS[0], 4)
    g_b, b, r_b = _coarse_prep(32, 128, dev, 93, BCS[0], 6, layered=True)
    rhs_a = [(r_a(g_a.shape_vx), r_a(g_a.shape_vy)) for _ in range(2)]
    rhs_b = (r_b(g_b.shape_vx), r_b(g_b.shape_vy))
    first = [cvk.coarse_vcycle(*rhs_a[0], a), cvk.coarse_vcycle(*rhs_b, b),
             cvk.coarse_vcycle(*rhs_a[1], a), cvk.coarse_vcycle(*rhs_a[1], a)]
    second = [cvk.coarse_vcycle(*rhs_a[0], a), cvk.coarse_vcycle(*rhs_b, b)]
    refs = [cvk.coarse_vcycle_plain(*rhs_a[0], a),
            cvk.coarse_vcycle_plain(*rhs_b, b),
            cvk.coarse_vcycle_plain(*rhs_a[1], a)]
    for got, ref in zip(first, refs + refs[2:]):
        for g, rf in zip(got, ref):
            assert _rel(g, rf) <= 2e-5
    for x, y in zip(first[:2] + first[2:3], second + first[3:]):
        for g, h in zip(x, y):
            assert torch.equal(g, h)


def test_redesigned_kernels_fit_without_spills(dev):
    """Kernels 5 and 8 at every depth and tile height, kernel 6 at the FK
    128^2 and sticky-air 128x32 plans, kernels 1, 4, 7 and 9 in both forms,
    kernels 10, 11 and 12 at their plans at the 4x2 blocks: no local
    memory (spills), kernels 5 and 8 with 16 warps resident per SM, one
    cluster of kernel 6 resident, kernel 6's static shared memory the
    planner's SMEM_STATIC, kernels 4 and 10-12's dynamic shared memory
    their plans', kernels 10 and 11 with at least their siblings' (2 and
    3) resident blocks per SM; kernels 10-12 in their periodic forms too
    (11p against 3p; 10p against its launch bounds' 3 blocks)."""
    from pylamp_tpu_torch.markers.kernels import (
        advect_block,
        m2g_block,
        rebucket_block,
    )
    from pylamp_tpu_torch.ops.kernels import cheb_block, saddle_block

    for he in range(1, 8):
        for ty in cheb.TILE_ROWS:
            for periodic in (False, True):
                info = cheb.kernel_info(he, ty, periodic)
                assert info["local_bytes"] == 0, (he, ty, periodic, info)
                assert info["blocks_per_sm"] * info["threads"] >= 512, info
            info = cheb_block.kernel_info(he, ty)
            assert info["local_bytes"] == 0, (he, ty, info)
            assert info["blocks_per_sm"] * info["threads"] >= 512, info
    for ny, nx in ((128, 128), (32, 128)):
        _, prep, _ = _coarse_prep(ny, nx, dev, 94, BCS[0], 4)
        info = cvk.kernel_info(prep)
        assert info["local_bytes"] == 0 and info["clusters"] >= 1, info
        assert info["static_smem"] == cvk.SMEM_STATIC, info
        assert info["cluster"] == cvk.CLUSTER, info
    # kernel 1 (tiled saddle stencil) and kernel 4 (row-streamed repack)
    # in both forms, kernel 4 at the plans of K up to 100 (two blocks
    # resident per SM, as rebucket_plan promises)
    for periodic in (False, True):
        for kernel in (saddle, momentum):
            info = kernel.kernel_info(periodic)
            assert info["local_bytes"] == 0, (kernel.__name__, info)
            assert info["blocks_per_sm"] * info["threads"] >= 1024, info
        for K in (1, 9, 18, 32, 33, 64, 100):
            plan = rebucket.rebucket_plan(1024, 1024, K)
            info = rebucket.kernel_info(K, plan.tx, periodic)
            assert info["local_bytes"] == 0, (K, info)
            assert info["dynamic_smem"] == plan.smem, (K, info)
            assert info["blocks_per_sm"] >= 2, (K, info)
    # kernel 9 (kernel 1's tile on the shards' blocks) in both forms and
    # kernel 12 (kernel 4's repack) at the plans of the 4x2 blocks, two
    # blocks resident per SM as rebucket_plan promises
    for with_p in (True, False):
        info = saddle_block.kernel_info(with_p)
        assert info["local_bytes"] == 0, ("saddle_block", with_p, info)
        assert info["blocks_per_sm"] * info["threads"] >= 1024, info
    for K in (1, 9, 18, 32, 33, 64, 100):
        plan = rebucket.rebucket_plan(256, 512, K)
        for periodic in (False, True):
            info = rebucket_block.kernel_info(K, plan.tx, periodic)
            assert info["local_bytes"] == 0, ("rebucket_block", K, info)
            assert info["dynamic_smem"] == plan.smem, (K, info)
            assert info["blocks_per_sm"] >= 2, (K, periodic, info)
    # kernel 10 (kernel 2's gather) in both instantiations and kernel 11
    # (kernel 3's tiles) at the plans of the 4x2 blocks, each against its
    # sibling's occupancy at the sibling's FK plan
    for K in (1, 9, 18, 33, 64):
        plan = m2g_block.block_plan(8, 256, 512, K)
        sib = m2g.m2g_plan(1024, 1024, K)
        for flags in (m2g.FLAG_ENERGY, m2g.FLAG_ENERGY | m2g.FLAG_RA,
                      m2g.FLAG_ENERGY | m2g.FLAG_PERIODIC,
                      m2g.FLAG_ENERGY | m2g.FLAG_RA | m2g.FLAG_PERIODIC):
            info = m2g_block.kernel_info(plan, flags)
            ref = m2g.kernel_info(sib, flags)
            assert info["local_bytes"] == 0, ("m2g_block", K, flags, info)
            assert info["dynamic_smem"] == plan.smem, (K, flags, info)
            if flags & m2g.FLAG_PERIODIC:  # 10p: its launch bounds' 3
                assert info["blocks_per_sm"] >= min(
                    ref["blocks_per_sm"], m2g_block.BLOCKS_PER_SM_PERIODIC)
            else:
                assert info["blocks_per_sm"] >= ref["blocks_per_sm"], (
                    K, flags, info, ref)
        aplan = advect.advect_plan(256, 512, K)
        for periodic in (False, True):
            info = advect_block.kernel_info(aplan, periodic)
            ref = advect.kernel_info(advect.advect_plan(1024, 1024, K),
                                     periodic)
            assert info["local_bytes"] == 0, ("advect_block", K, info)
            assert info["dynamic_smem"] == aplan.smem, (K, info)
            assert info["blocks_per_sm"] >= ref["blocks_per_sm"], (
                K, periodic, info, ref)


# -- the periodic forms of kernels 1-5 and 7 ----------------------------------

def _periodic_bcs(bc):
    return VelocityBCs(top=bc, bottom="free_slip", left="periodic",
                       right="periodic")


def _seam_consistent(*arrays):
    """Column nx := column 0 of each (ny+1, nx+1) or (ny, nx+1) array, as
    the periodic multigrid keeps vx, rx and eta_s."""
    for a in arrays:
        a[:, -1] = a[:, 0]
    return arrays


@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
@pytest.mark.parametrize("ny,nx", [(5, 3), (23, 4), (16, 256), (21, 256),
                                   (23, 37), (129, 257), (256, 1024),
                                   (1024, 256), (17, 33), (15, 31),
                                   (333, 517)])
def test_saddle_and_momentum_kernels_periodic(dev, ny, nx, bc):
    """Kernels 1 and 7 in their periodic forms at the narrowest widths and
    at ragged ny, against the plain versions (any input: the seam row reads
    column 0's neighbourhood and vx column nx as ops/stokes.py does); the
    two seam columns bit-identical, a rerun bit-identical."""
    bcs = _periodic_bcs(bc)
    grid, es, en, kbnd, r = _level_problem(ny, nx, dev, 101 + nx)
    vx, vy, p = r(grid.shape_vx), r(grid.shape_vy), r(grid.shape_center)
    prep = saddle.prep_saddle(es, en, torch.tensor(3.5, device=dev), kbnd)
    n0, p0 = saddle.launches, saddle.launches_periodic
    got = saddle.saddle_apply(vx, vy, p, prep, grid, bcs)
    assert (saddle.launches, saddle.launches_periodic) == (n0 + 1, p0 + 1)
    ref = saddle.saddle_apply_plain(vx, vy, p, prep, grid, bcs)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 1e-5
    assert torch.equal(got[0][:, 0], got[0][:, -1])
    for g, a in zip(got, saddle.saddle_apply(vx, vy, p, prep, grid, bcs)):
        assert torch.equal(g, a)

    mprep = momentum.prep_momentum(es, en, kbnd)
    n0, p0 = momentum.launches, momentum.launches_periodic
    got = momentum.momentum_apply_kernel(vx, vy, mprep, grid, bcs)
    assert (momentum.launches, momentum.launches_periodic) == (n0 + 1, p0 + 1)
    ref = momentum.momentum_apply_plain(vx, vy, es, en, grid, bcs, kbnd)
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 1e-5
    assert torch.equal(got[0][:, 0], got[0][:, -1])
    for g, a in zip(got, momentum.momentum_apply_kernel(vx, vy, mprep, grid,
                                                        bcs)):
        assert torch.equal(g, a)


@pytest.mark.parametrize("depth", range(1, 8))
@pytest.mark.parametrize("ny,nx", [(64, 256), (128, 512), (256, 256)])
def test_cheb_kernel_periodic(dev, ny, nx, depth):
    """Kernel 5's periodic form at every depth 1-7, zero and non-zero
    start, with and without the emitted residual, on levels whose seam
    tiles include tiles interior in y: against the plain version (2e-5),
    the seam columns of every output bit-identical, a rerun bit-identical.
    The random e^+-8 field at every depth, as test_cheb_kernel.  At depth
    7 with a non-zero start the emitted residual of the wall form and of
    this one alike can differ from the plain version by ~2e-5 at an
    interior point, where the f32 plain version is itself 4e-5 off an f64
    evaluation: such an output is held to f32 rounding instead
    (_f32_agrees)."""
    bcs = _periodic_bcs("no_slip")
    grid, es, en, kbnd, r = _level_problem(ny, nx, dev, 111 + depth)
    (es,) = _seam_consistent(es.clone())
    lam = mg.gershgorin_lambda(es, en, grid, bcs, kbnd)
    prep = cheb.prep_smoother(es, en, grid, bcs, kbnd, lam, depth)
    rx, ry = r(grid.shape_vx), r(grid.shape_vy)
    _seam_consistent(rx)
    start = {True: (torch.zeros_like(rx), torch.zeros_like(ry)),
             False: (_seam_consistent(r(grid.shape_vx))[0],
                     r(grid.shape_vy))}
    for emit in (False, True):
        iters = depth - emit
        if iters < 1:
            continue
        for zero_init in (True, False):
            ex, ey = start[zero_init]
            p0 = cheb.launches_periodic
            got = cheb.chebyshev_smooth(ex, ey, rx, ry, prep, grid, bcs,
                                        iters, zero_init, emit)
            assert cheb.launches_periodic == p0 + 1
            ref = cheb.chebyshev_smooth_plain(ex, ey, rx, ry, es, en, grid,
                                              bcs, kbnd, lam, iters,
                                              zero_init, emit)
            f64 = [a.double() for a in (ex, ey, rx, ry, es, en, kbnd, lam)]
            ref64 = cheb.chebyshev_smooth_plain(*f64[:6], grid, bcs, *f64[6:],
                                                iters, zero_init, emit)
            for g, rf, r64 in zip(got, ref, ref64):
                assert _f32_agrees(g, rf, r64, 2e-5), (emit, zero_init)
            for g in got[::2]:  # ex' and, with emit, rx - A ex'
                assert torch.equal(g[:, 0], g[:, -1])
            again = cheb.chebyshev_smooth(ex, ey, rx, ry, prep, grid, bcs,
                                          iters, zero_init, emit)
            for g, a in zip(got, again):
                assert torch.equal(g, a)


def _f32_agrees(got, ref, ref64, bar):
    """The kernel within ``bar`` of its f32 plain version or, where f32
    rounding alone parts them, no farther from an f64 evaluation of the
    plain version than twice the f32 plain version is."""
    return _rel(got, ref) <= bar or _rel(got, ref64) <= 2 * _rel(ref, ref64)


def _seam_markers(nx, ny, dev):
    """falling_block_periodic's f32 markers with slots moved onto the seam:
    x = 0, -eps and +eps in the cells of column 0, lx - eps and lx in those
    of column nx - 1 (eps = 1e-7 of the unit box)."""
    from pylamp_tpu_torch.models.benchmarks import falling_block_periodic

    cfg = falling_block_periodic(nx=nx, ny=ny)
    grid, table, st = build(cfg, dtype=torch.float32, device=dev)
    bm = st.markers
    x = bm.x.clone()
    eps = 1e-7
    for s, v in enumerate((0.0, -eps, eps)):
        x[:, 0, s] = v
    for s, v in enumerate((grid.lx - eps, grid.lx)):
        x[:, -1, s] = v
    return cfg, grid, table, bm.replace(x=x.contiguous())


@pytest.mark.parametrize("with_energy", [False, True])
@pytest.mark.parametrize("ny,nx", [(14, 24), (8, 3)])
def test_m2g_kernel_periodic(dev, ny, nx, with_energy):
    """Kernel 2's periodic form on markers on and around the seam, against
    the plain version; the corner and vx seam columns bit-identical, a
    rerun bit-identical."""
    cfg, grid, table, bm = _seam_markers(nx, ny, dev)
    phys = dataclasses.replace(cfg.physics, gx=0.4)  # with the vx streams
    p0 = m2g.launches_periodic
    got = m2g.m2g_fused(bm, grid, table, phys, with_energy, periodic_x=True)
    assert m2g.launches_periodic == p0 + 1
    ref = m2g.m2g_fused_plain(bm, grid, table, phys, with_energy,
                              periodic_x=True)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, k
        if got[k].shape[1] == nx + 1:
            assert torch.equal(got[k][:, 0], got[k][:, -1]), k
    again = m2g.m2g_fused(bm, grid, table, phys, with_energy, periodic_x=True)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def _wrapped_step(got, ref, x0, lx):
    """Displacements of two wrapped positions from x0, each taken into
    [-lx/2, lx/2)."""
    def d(x):
        return torch.remainder(x - x0 + 0.5 * lx, lx) - 0.5 * lx
    return d(got), d(ref)


@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_advect_kernel_periodic(dev, reach, bc):
    """Kernel 3's periodic form with a drift that carries the markers
    near the seam across it, both ways: displacements against the plain
    version (1e-4), every x in [0, lx], a rerun bit-identical."""
    bcs = _periodic_bcs(bc)
    _, grid, _, bm = _seam_markers(24, 18, dev)
    rng = np.random.default_rng(121 + reach)
    for drift in (0.7, -0.7):
        vx = torch.tensor(drift + rng.uniform(-0.3, 0.3, grid.shape_vx),
                          dtype=torch.float32, device=dev)
        vx[:, -1] = vx[:, 0]
        vy = torch.tensor(rng.uniform(-1, 1, grid.shape_vy),
                          dtype=torch.float32, device=dev)
        dt = torch.tensor(0.45 * reach * grid.dx, device=dev)
        p0 = advect.launches_periodic
        got = advect.advect_rk4_fused(bm, vx, vy, dt, grid, bcs, reach)
        assert advect.launches_periodic == p0 + 1
        ref = advect.advect_rk4_plain(bm, vx, vy, dt, grid, bcs, reach)
        crossed = (got.x - bm.x).abs() > 0.5 * grid.lx
        assert int(torch.sum(crossed & bm.valid)) > 0
        gdx, rdx = _wrapped_step(got.x, ref.x, bm.x, grid.lx)
        assert _rel(gdx, rdx) <= 1e-4
        assert _rel(got.y - bm.y, ref.y - bm.y) <= 1e-4
        assert float(got.x.min()) >= 0.0 and float(got.x.max()) <= grid.lx
        again = advect.advect_rk4_fused(bm, vx, vy, dt, grid, bcs, reach)
        assert torch.equal(got.x, again.x) and torch.equal(got.y, again.y)


@pytest.mark.parametrize("periodic", [False, True])
def test_rebucket_kernel_unaligned_streams(dev, periodic):
    """Streams that start inside their allocation (views at an offset of
    one slot: the valid words and the streams at another alignment than
    a fresh tensor's) are repacked as fresh ones are: identical slot for
    slot to the plain version, same drop count."""
    moved, grid = _rebucket_markers(37, 23, 9, dev, 77, periodic)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    odd = moved.replace(x=shifted(moved.x), y=shifted(moved.y),
                        T=shifted(moved.T), mat=shifted(moved.mat),
                        valid=shifted(moved.valid))
    assert odd.x.data_ptr() % 16 and odd.x.is_contiguous()
    _same_rebucket(rebucket.rebucket_fused(odd, grid, periodic_x=periodic),
                   rebucket.rebucket_plain(moved, grid, periodic_x=periodic))


@pytest.mark.parametrize("capacity", REBUCKET_CAPACITIES)
@pytest.mark.parametrize("ny,nx", [(13, 17), (6, 3), (3, 3), (37, 23),
                                   (65, 33)])
def test_rebucket_kernel_periodic(dev, ny, nx, capacity):
    """Kernel 4's periodic form: markers displaced by up to a cell and
    wrapped (as advection leaves them), with the seam placements, exact
    cell edges and a crowded neighbourhood of _rebucket_markers, at the
    narrowest widths (3 columns: both halo columns wrap onto the strip)
    and at shapes that straddle strips and chunks: repacked identically
    slot for slot to the plain version with the same drop count; a rerun
    bit-identical."""
    moved, grid = _rebucket_markers(ny, nx, capacity, dev, 131 + capacity,
                                    periodic=True)
    p0 = rebucket.launches_periodic
    got = rebucket.rebucket_fused(moved, grid, periodic_x=True)
    assert rebucket.launches_periodic == p0 + 1
    _same_rebucket(got, rebucket.rebucket_plain(moved, grid, periodic_x=True))
    if capacity <= 9:
        assert int(got[1]) > 0
    _same_rebucket(got, rebucket.rebucket_fused(moved, grid, periodic_x=True))


# -- the rho0 * alpha stream of kernels 2 and 10 ----------------------------------

RA_TABLE = [
    Material(rho0=100.0, alpha=1.0, eta0=1.0, viscosity="frank_kamenetskii",
             fk_gamma=9.2, k=1.0, cp=0.01),
    Material(rho0=90.0, alpha=0.5, eta0=10.0, k=2.0, cp=0.02, H=1.5),
    Material(rho0=80.0, alpha=0.2, T_ref=0.5, eta0=3.0,
             viscosity="arrhenius", E_act=3.0, k=0.5, cp=0.03),
]


def _ra_case(periodic, ny, nx, dev):
    """(grid, table, physics, markers) of kernel 2's rho0 * alpha checks:
    walls on three-material FK markers, or periodic walls on markers on
    and around the seam (their ids mapped onto the three materials)."""
    if periodic:
        cfg, grid, _, bm = _seam_markers(nx, ny, dev)
        cells = torch.arange(bm.mat.numel(), device=dev).view(bm.mat.shape)
        bm = bm.replace(mat=(cells % 3).to(torch.int32))
    else:
        cfg = fk_stagnant_lid(nx=nx, ny=ny)
        grid = StaggeredGrid(nx=nx, ny=ny, lx=1.0, ly=1.0)
        bm = _markers(nx, ny, dev, mats=3)
    phys = dataclasses.replace(cfg.physics, gx=0.4)  # with the vx streams
    return grid, MaterialTable(RA_TABLE), phys, bm


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ny,nx", [(14, 24), (8, 3), (33, 65)])
def test_m2g_kernel_ra(dev, periodic, ny, nx):
    """Kernel 2 with the rho0 * alpha stream, wall and periodic forms (the
    periodic one on seam placements), against the plain version; every
    other stream bit-identical to the kernel without the stream, the seam
    columns equal, a rerun bit-identical."""
    grid, table, phys, bm = _ra_case(periodic, ny, nx, dev)
    r0 = m2g.launches_ra
    got = m2g.m2g_fused(bm, grid, table, phys, True, periodic, with_ra=True)
    assert m2g.launches_ra == r0 + 1
    ref = m2g.m2g_fused_plain(bm, grid, table, phys, True, periodic,
                              with_ra=True)
    base = m2g.m2g_fused(bm, grid, table, phys, True, periodic)
    assert m2g.launches_ra == r0 + 1
    assert sorted(got) == sorted(ref) == sorted([*base, "c_ra"])
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, k
    for k in base:
        assert torch.equal(got[k], base[k]), k
    if periodic:
        assert torch.equal(got["c_ra"][:, 0], got["c_ra"][:, -1])
    again = m2g.m2g_fused(bm, grid, table, phys, True, periodic, with_ra=True)
    for k in got:
        assert torch.equal(got[k], again[k]), k


@pytest.mark.parametrize("n,mesh_n", [(1024, 8), (40, 4)])
def test_m2g_block_kernel_ra(dev, n, mesh_n):
    """Kernel 10 with the rho0 * alpha stream on the extended blocks of the
    FK markers, against its plain version, a rerun bit-identical; and the
    halo transfer bit-identical to kernel 2's on every stream, c_ra
    included."""
    from pylamp_tpu_torch.markers.kernels import m2g_block
    from pylamp_tpu_torch.parallel.halo_markers import m2g_fused_halo
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_n)
    cfg = fk_stagnant_lid(nx=n, ny=n)
    bm, grid, ext, bases = _mesh_markers(n, n, dev, mesh)
    table = MaterialTable(cfg.physics.materials)
    r0 = m2g_block.launches_ra
    got = m2g_block.m2g_fused_block(*ext, grid, table, cfg.physics, bases,
                                    with_energy=True, with_ra=True)
    assert m2g_block.launches_ra == r0 + 1
    ref = m2g_block.m2g_fused_block_plain(*ext, grid, table, cfg.physics,
                                          bases, with_energy=True,
                                          with_ra=True)
    assert "c_ra" in got and sorted(got) == sorted(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, k
    again = m2g_block.m2g_fused_block(*ext, grid, table, cfg.physics, bases,
                                      with_energy=True, with_ra=True)
    for k in got:
        assert torch.equal(got[k], again[k]), k
    halo = m2g_fused_halo(bm, grid, table, cfg.physics, mesh, True,
                          with_ra=True)
    glob = m2g.m2g_fused(bm, grid, table, cfg.physics, with_energy=True,
                         with_ra=True)
    assert "c_ra" in halo and sorted(halo) == sorted(glob)
    for k in glob:
        assert torch.equal(halo[k], glob[k]), k


def test_m2g_kernels_fit_without_spills(dev):
    """Every instantiation of kernels 2 and 10 (wall and periodic, with and
    without the rho0 * alpha accumulator) keeps its sums in registers: no
    spill stores or loads in the ptxas report of the build."""
    from pylamp_tpu_torch import cuda_build

    rows = [r for r in cuda_build.ptxas_summary()
            if r["source"] in ("m2g.cu", "m2g_block.cu")]
    assert len(rows) == 8, rows  # 4 of kernel 2, 4 of kernel 10 (10p)
    for r in rows:
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r


# -- kernels 2 and 3 on synthetic markers (the row-streamed m2g gather and the
# tiled RK4 on live slots) ------------------------------------------------------

SYNTH_FORMS = [(13, 17, False), (37, 23, False), (65, 33, False), (3, 3, True),
               (6, 3, True)]
SYNTH_KS = [1, 9, 18, 32, 33]


def _synthetic_markers(ny, nx, K, dev, seed, periodic):
    """_rebucket_markers' seeded markers (about half valid, not a prefix of
    each cell; displaced up to 0.95 of a cell out of their cell; a sixth
    of the coordinates on exact cell edges; x and y clipped onto the
    domain edges, or x wrapped with the seam placements) plus a full cell
    (every slot of cell (ny // 2, nx // 2) valid) and an empty tile (the
    first two cell rows without a valid slot)."""
    bm, grid = _rebucket_markers(ny, nx, K, dev, seed, periodic)
    valid = bm.valid.clone()
    valid[ny // 2, nx // 2, :] = True
    if ny > 2:
        valid[:2] = False
    return bm.replace(valid=valid.contiguous()), grid


# (table, gx, with_energy, with_ra): the FK table (one material, no H) and
# RA_TABLE (three materials, H on one); without and with the vx streams
M2G_STREAMS = [("fk", 0.0, False, False), ("fk", 0.4, True, False),
               ("three", 0.4, True, False), ("three", 0.0, True, True),
               ("three", 0.4, True, True)]


@pytest.mark.parametrize("streams", M2G_STREAMS,
                         ids=lambda s: f"{s[0]}-gx{s[1]}-E{s[2]:d}-ra{s[3]:d}")
@pytest.mark.parametrize("K", SYNTH_KS)
@pytest.mark.parametrize("ny,nx,periodic", SYNTH_FORMS)
def test_m2g_kernel_synthetic(dev, ny, nx, periodic, K, streams):
    """Kernel 2 (every instantiation: walls and periodic, with and without
    rho0 * alpha) at shapes that straddle its 32-column strips and 32-row
    chunks and at the narrowest periodic widths, K from 1 to 33 (one unit
    a cell row, or two and three), on markers off their cells, on cell and
    domain edges, a full cell and an empty tile, with every stream set:
    within 1e-5 of the plain version per stream, the seam columns equal,
    a rerun bit-identical."""
    name, gx, with_energy, with_ra = streams
    bm, grid = _synthetic_markers(ny, nx, K, dev, 211 + K, periodic)
    cfg = fk_stagnant_lid(nx=nx, ny=ny)
    table = (MaterialTable(RA_TABLE) if name == "three"
             else MaterialTable(cfg.physics.materials))
    if name == "fk":
        bm = bm.replace(mat=torch.zeros_like(bm.mat))
    phys = dataclasses.replace(cfg.physics, gx=gx)
    kw = dict(with_energy=with_energy, periodic_x=periodic, with_ra=with_ra)
    n0, r0 = m2g.launches, m2g.launches_ra
    got = m2g.m2g_fused(bm, grid, table, phys, **kw)
    assert m2g.launches == n0 + 1 and m2g.launches_ra == r0 + with_ra
    ref = m2g.m2g_fused_plain(bm, grid, table, phys, **kw)
    assert sorted(got) == sorted(ref)
    assert ("vx_w" in got) == (gx != 0.0) and ("c_ra" in got) == with_ra
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, k
        if periodic and got[k].shape[1] == nx + 1:
            assert torch.equal(got[k][:, 0], got[k][:, -1]), k
    again = m2g.m2g_fused(bm, grid, table, phys, **kw)
    for k in got:
        assert torch.equal(got[k], again[k]), k


@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("K", SYNTH_KS)
@pytest.mark.parametrize("ny,nx,periodic", SYNTH_FORMS)
def test_advect_kernel_synthetic(dev, ny, nx, periodic, K, reach):
    """Kernel 3 in both forms on the same markers with seeded velocities
    (periodic: a drift that carries markers across the seam), both stage
    reaches: the displacement within 1e-4 of the plain version beyond one
    f32 spacing of the position, empty slots exactly the plain version's
    (clipped or wrapped), every x in [0, lx] (periodic), a rerun
    bit-identical."""
    bm, grid = _synthetic_markers(ny, nx, K, dev, 307 + K, periodic)
    bcs = (_periodic_bcs("no_slip") if periodic
           else VelocityBCs(top="no_slip", left="no_slip"))
    rng = np.random.default_rng(401 + K + reach)
    vx = torch.tensor((0.7 if periodic else 0.0)
                      + rng.uniform(-0.3, 0.3, grid.shape_vx),
                      dtype=torch.float32, device=dev)
    if periodic:
        vx[:, -1] = vx[:, 0]
    vy = torch.tensor(rng.uniform(-0.5, 0.5, grid.shape_vy),
                      dtype=torch.float32, device=dev)
    dt = torch.tensor(0.45 * reach * grid.dx, device=dev)
    n0 = advect.launches
    got = advect.advect_rk4_fused(bm, vx, vy, dt, grid, bcs, reach)
    assert advect.launches == n0 + 1
    ref = advect.advect_rk4_plain(bm, vx, vy, dt, grid, bcs, reach)
    empty = ~bm.valid
    assert torch.equal(got.x[empty], ref.x[empty])
    assert torch.equal(got.y[empty], ref.y[empty])
    if periodic:
        gx_, rx_ = _wrapped_step(got.x, ref.x, bm.x, grid.lx)
        assert _rel(gx_, rx_) <= 1e-4
        assert float(got.x.min()) >= 0.0 and float(got.x.max()) <= grid.lx
    else:
        assert _disp_rel(got.x, ref.x, bm.x) <= 1e-4
    assert _disp_rel(got.y, ref.y, bm.y) <= 1e-4
    again = advect.advect_rk4_fused(bm, vx, vy, dt, grid, bcs, reach)
    assert torch.equal(got.x, again.x) and torch.equal(got.y, again.y)


def test_m2g_and_advect_kernels_fit_without_spills(dev):
    """Kernels 2 and 3, every instantiation, at the plans of K 1-64: no
    local memory (spills), the plan's dynamic shared memory, at least two
    blocks resident per SM (kernel 2 at FK 1024^2 x K18: four, the
    registers' limit), and no spill in the ptxas report of advect.cu."""
    from pylamp_tpu_torch import cuda_build

    for K in (1, 9, 18, 32, 33, 64):
        plan = m2g.m2g_plan(1024, 1024, K)
        for flags in (m2g.FLAG_ENERGY, m2g.FLAG_ENERGY | m2g.FLAG_RA,
                      m2g.FLAG_PERIODIC,
                      m2g.FLAG_PERIODIC | m2g.FLAG_ENERGY | m2g.FLAG_RA):
            info = m2g.kernel_info(plan, flags)
            assert info["local_bytes"] == 0, (K, flags, info)
            assert info["dynamic_smem"] == plan.smem, (K, flags, info)
            assert info["blocks_per_sm"] >= (4 if K == 18 else 2), (K, info)
        aplan = advect.advect_plan(1024, 1024, K)
        for periodic in (False, True):
            info = advect.kernel_info(aplan, periodic)
            assert info["local_bytes"] == 0, (K, info)
            assert info["dynamic_smem"] == aplan.smem, (K, info)
            assert info["blocks_per_sm"] >= 2, (K, info)
    rows = [r for r in cuda_build.ptxas_summary()
            if r["source"] == "advect.cu"]
    assert len(rows) == 2, rows
    for r in rows:
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r
