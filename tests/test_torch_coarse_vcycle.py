"""Port vs reference: the fused coarse sub-V-cycle's plain version
(ops/kernels/coarse_vcycle.py) against the JAX package's Pallas kernel
(``coarse_vcycle_pallas``, interpret mode on the CPU) on the same level
data, and the fusion start against the JAX function.

A 64^2 hierarchy fuses from 32^2 (32, 16, 8, 4).  Both packages get the
same f32 viscosities, kbnd and lambda per level and the same seeded
residual; the bar is 2e-5 max|ref|, the bar of tests/test_coarse_vcycle.py
(the reference applies its transfers as matrix products, which sum in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, t

import pylamp_tpu.ops.pallas.coarse_vcycle_kernel as jcvk
from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.solvers import mg as jmg
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
from pylamp_tpu_torch.solvers import mg, scaling

F32 = torch.float32


def _hierarchy(n, bcs, seed=9):
    grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
    rng = np.random.default_rng(seed)
    es = t(np.exp(2 * rng.standard_normal(grid.shape_corner)), F32)
    en = t(np.exp(2 * rng.standard_normal(grid.shape_center)), F32)
    _, kbnd = scaling.stokes_scales(scaling.characteristic_viscosity(en), grid)
    plan, grids, etas, kbnds = mg._hierarchy(es, en, grid, kbnd, 0, 2.0)
    lam = mg.estimate_mg_lambdas(es, en, grid, bcs, kbnd, semicoarsen=2.0,
                                 mode="gershgorin")
    return plan, grids, etas, kbnds, lam, rng


@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_plain_matches_pallas_kernel(bc):
    bcs = VelocityBCs(top=bc, bottom=bc, left=bc, right=bc)
    plan, grids, etas, kbnds, lam, rng = _hierarchy(64, bcs)
    fs = cvk.coarse_fuse_start(grids, plan, bcs, F32, "chebyshev", False,
                               False)
    assert fs == 1 and grids[fs].nx == 32
    g0 = grids[fs]
    rx = rng.standard_normal(g0.shape_vx)
    ry = rng.standard_normal(g0.shape_vy)

    jprep = jcvk.CoarseVcyclePrep(
        [JGrid(nx=g.nx, ny=g.ny, lx=1.0, ly=1.0) for g in grids[fs:]],
        [(jnp.asarray(es.numpy()), jnp.asarray(en.numpy()))
         for es, en in etas[fs:]],
        [float(k) for k in kbnds[fs:]], jnp.asarray(lam[fs:].numpy()),
        jax_vbcs(bcs), 4, 4, 32)
    ref = jcvk.coarse_vcycle_pallas(jnp.asarray(rx, jnp.float32),
                                    jnp.asarray(ry, jnp.float32), jprep,
                                    interpret=True)
    prep = cvk.CoarseVcyclePrep(grids[fs:], etas[fs:], kbnds[fs:], lam[fs:],
                                bcs, 4, 4, 32)
    n0 = cvk.launches
    got = cvk.coarse_vcycle(t(rx, F32), t(ry, F32), prep)
    assert cvk.launches == n0  # CPU tensors: the plain version
    assert torch.equal(got[0], cvk.coarse_vcycle_plain(t(rx, F32),
                                                       t(ry, F32), prep)[0])
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float64)
        err = np.max(np.abs(g.double().numpy() - r))
        assert err <= 2e-5 * np.max(np.abs(r))


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_fuse_start_matches_reference(n):
    bcs = VelocityBCs()
    grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
    jgrid = JGrid(nx=n, ny=n, lx=1.0, ly=1.0)
    plan = mg.coarsening_plan(grid, 0, semi_threshold=2.0)
    jplan = jmg.coarsening_plan(jgrid, 0, semi_threshold=2.0)
    assert plan == jplan
    grids, jgrids = [grid], [jgrid]
    for step in plan:
        grids.append(grids[-1].coarsen(*step))
        jgrids.append(jgrids[-1].coarsen(*step))
    for dt, jdt in ((F32, jnp.float32), (torch.float64, jnp.float64)):
        for opts in ((False, False), (True, False), (False, True)):
            got = cvk.coarse_fuse_start(grids, plan, bcs, dt, "chebyshev",
                                        *opts)
            ref = jcvk.coarse_fuse_start(jgrids, jplan, jax_vbcs(bcs), jdt,
                                         "chebyshev", *opts)
            assert got == ref
    fs = cvk.coarse_fuse_start(grids, plan, bcs, F32, "chebyshev", False,
                               False)
    assert grids[fs].nx == 128 if n >= 256 else grids[fs].nx == 32


def _bench_hierarchy(preset, nx=1024):
    """(grids, plan, fusion start, the reference's fusion start) of the
    FK nx^2 or sticky-air nx x max(nx // 4, 64) solve (shapes only)."""
    from pylamp_tpu_torch.models.benchmarks import (
        fk_bench_config,
        sticky_air_bench_config,
    )
    cfg = (fk_bench_config if preset == "fk" else sticky_air_bench_config)(nx)
    grid = StaggeredGrid(nx=cfg.nx, ny=cfg.ny, lx=cfg.lx, ly=cfg.ly)
    jgrid = JGrid(nx=cfg.nx, ny=cfg.ny, lx=cfg.lx, ly=cfg.ly)
    s = cfg.solver
    plan = mg.coarsening_plan(grid, s.mg_levels,
                              semi_threshold=s.mg_semicoarsen)
    grids, jgrids = [grid], [jgrid]
    for step in plan:
        grids.append(grids[-1].coarsen(*step))
        jgrids.append(jgrids[-1].coarsen(*step))
    bcs = cfg.physics.velocity_bcs
    fs = cvk.coarse_fuse_start(grids, plan, bcs, F32, "chebyshev", False,
                               False)
    jfs = jcvk.coarse_fuse_start(jgrids, plan, jax_vbcs(bcs), jnp.float32,
                                 "chebyshev", False, False)
    return grids, plan, fs, jfs


def _fused_levels(preset):
    """The levels the fused coarse V-cycle owns in the FK 1024^2 and the
    sticky-air 1024x256 solves (shapes only)."""
    grids, _, fs, _ = _bench_hierarchy(preset)
    return grids[fs:]


@pytest.mark.parametrize("nx", [256, 384, 512, 640, 768, 1024, 2048])
@pytest.mark.parametrize("preset", ["fk", "sticky_air"])
def test_fuse_start_fits_a_cluster(preset, nx):
    """The fusion gate on every size the bench presets take: the port fuses
    from the reference's start where one cluster holds the levels from
    there (every sticky-air size, FK at 256, 512, 1024, 2048), and otherwise
    from the first level below it that fits (FK 384 and 768 from 96^2, 640
    from 80^2); cluster_plan holds the levels it fuses."""
    grids, plan, fs, jfs = _bench_hierarchy(preset, nx)
    assert jfs is not None and fs is not None and fs >= jfs
    assert cvk.cluster_plan(grids[fs:]) is not None
    for l in range(jfs, fs):  # the levels skipped do not fit
        assert cvk.cluster_plan(grids[l:]) is None
    expect = {384: 96, 640: 80, 768: 96}.get(nx) if preset == "fk" else None
    if expect is None:
        assert fs == jfs
    else:
        assert (grids[fs].ny, grids[fs].nx) == (expect, expect)


@pytest.mark.parametrize("preset,start,cluster", [("fk", (128, 128), 8),
                                                  ("sticky_air", (32, 128), 8)])
def test_cluster_plan(preset, start, cluster):
    """csrc/coarse_vcycle.cu's cluster plan on both hierarchies: every
    point row of a split level owned by exactly one CTA, each strip's ghost
    rows owned by its neighbours, the small levels in CTA 0 with whole
    warps, and the levels' planes disjoint within a CTA's 227 KB."""
    grids = _fused_levels(preset)
    assert (grids[0].ny, grids[0].nx) == start
    plans, smem = cvk.cluster_plan(grids)
    cl = cvk.CLUSTER
    assert cl == cluster and smem <= cvk.SMEM_PER_BLOCK
    end = 0
    for g, p in zip(grids, plans):
        R, W = g.ny + 1, g.nx + 1
        assert p.split == (R >= cl and (
            max(g.ny, g.nx) >= cvk.SPLIT_MIN
            or R * W > cvk.MAX_POINTS_PER_THREAD * cvk.THREADS))
        assert p.lo[0] == 0 and p.lo[-1] == R and len(p.lo) == cl + 1
        owners = np.zeros(R, np.int32)
        for s in range(cl):
            a, b = p.lo[s], p.lo[s + 1]
            owners[a:b] += 1
            if p.split:
                assert 1 <= b - a <= p.rows - 2
                # the ghost rows a - 1 and b: a neighbour's edge rows
                if a > 0:
                    assert p.lo[s - 1] <= a - 1 < a
                if b < R:
                    assert b < p.lo[s + 2]
            else:
                assert (a, b) == ((0, R) if s == 0 else (R, R))
        assert (owners == 1).all()
        if p.split:  # the kernel's closed form of a row's owner
            for j in range(R):
                s = ((j + 1) * cl - 1) // R
                assert p.lo[s] <= j < p.lo[s + 1]
        own = max(b - a for a, b in zip(p.lo, p.lo[1:]))
        assert p.rows == own + 2
        assert p.nthr % 32 == 0 and 32 <= p.nthr <= cvk.THREADS
        assert -(-own * W // p.nthr) <= cvk.MAX_POINTS_PER_THREAD
        assert p.off >= end and p.off % 4 == 0
        end = p.off + cvk.LEVEL_PLANES * p.rows * W
    assert 4 * end <= smem
    # the coarsest level (32 iterations) runs on at most three warps
    assert plans[-1].nthr <= 96
