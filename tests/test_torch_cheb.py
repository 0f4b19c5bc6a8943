"""Port vs reference: the fused Chebyshev smoother's plain version
(ops/kernels/cheb.py) against the JAX package's Pallas kernel
(``chebyshev_smooth_pallas``, interpret mode on the CPU), its level gate,
and the MG preconditioner with the fused switches on and off.

Inputs are seeded numpy arrays given to both packages in f32; the bar is
2e-5 max|ref| per output, the bar of tests/test_cheb_kernel.py (the kernel
reassociates the recurrence).  On a CPU tensor the port's MG takes the
plain version on every branch, so its output with ``use_pallas_smoother``
and ``use_pallas_coarse`` on is bit-identical to the output with them off.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.ops.pallas import cheb_kernel as jcheb
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels import cheb
from pylamp_tpu_torch.solvers import mg, scaling

F32 = torch.float32


def _bcs(bc):
    return VelocityBCs(top=bc, bottom=bc, left=bc, right=bc)


@pytest.mark.parametrize("iters,zero_init,emit", [
    (4, True, True), (4, False, False), (1, False, False), (3, True, True)])
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_plain_matches_pallas_kernel(iters, zero_init, emit, bc):
    grid = StaggeredGrid(nx=256, ny=16, lx=2.0, ly=1.0)
    bcs = _bcs(bc)
    rng = np.random.default_rng(7)
    eta_s = np.exp(rng.standard_normal(grid.shape_corner) * 2.0)
    eta_n = np.exp(rng.standard_normal(grid.shape_center) * 2.0)
    rx = rng.standard_normal(grid.shape_vx)
    ry = rng.standard_normal(grid.shape_vy)
    if zero_init:
        ex, ey = np.zeros(grid.shape_vx), np.zeros(grid.shape_vy)
    else:
        ex = rng.standard_normal(grid.shape_vx)
        ey = rng.standard_normal(grid.shape_vy)
    kbnd, lam = 7.5, 3.7
    arrays = (ex, ey, rx, ry, eta_s, eta_n)

    ref = jcheb.chebyshev_smooth_pallas(
        *(jnp.asarray(a, jnp.float32) for a in arrays),
        JGrid(nx=256, ny=16, lx=2.0, ly=1.0), jax_vbcs(bcs), kbnd,
        jnp.asarray(lam, jnp.float32), iters, zero_init=zero_init,
        block_rows=8, interpret=True, emit_residual=emit)
    tex, tey, trx, try_, tes, ten = (t(a, F32) for a in arrays)
    got = cheb.chebyshev_smooth_plain(
        tex, tey, trx, try_, tes, ten, grid, bcs, kbnd,
        torch.tensor(lam, dtype=F32), iters, zero_init=zero_init,
        emit_residual=emit)
    assert len(got) == len(ref) == (4 if emit else 2)
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float64)
        err = np.max(np.abs(g.double().numpy() - r))
        assert err <= 2e-5 * np.max(np.abs(r))
    # the wrapper takes the plain version on CPU tensors
    prep = cheb.prep_smoother(tes, ten, grid, bcs, kbnd,
                              torch.tensor(lam, dtype=F32), iters + emit)
    n0 = cheb.launches
    out = cheb.chebyshev_smooth(tex, tey, trx, try_, prep, grid, bcs, iters,
                                zero_init, emit)
    assert cheb.launches == n0
    for o, g in zip(out, got):
        assert torch.equal(o, g)


def test_chebyshev_coeffs_match_reference():
    lam = np.array([3.7, 2.9, 3.05], np.float32)
    ref = np.stack([np.asarray(jcheb.chebyshev_coeffs(jnp.asarray(v), 6))
                    for v in lam])
    got = cheb.chebyshev_coeffs(torch.tensor(lam), 6)
    assert got.shape == (3, 6, 2) and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert torch.equal(cheb.chebyshev_coeffs(torch.tensor(lam[1]), 6), got[1])


def _reference_shape_rule(g, iters, emit):
    """The JAX gate without its platform test (it returns False on the
    CPU): a supported halo depth and a block height its VMEM model fits."""
    h = jcheb._pick_h(iters + (1 if emit else 0))
    return (h is not None and iters >= 1 and g.nx >= 256
            and jcheb._pick_block_rows(g.ny, g.nx, h,
                                       n_out=4 if emit else 2) is not None)


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_smoother_gate_picks_reference_levels(n):
    grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
    plan = mg.coarsening_plan(grid, 0, semi_threshold=2.0)
    grids = [grid]
    for step in plan:
        grids.append(grids[-1].coarsen(*step))
    for deg in (3, 4, 6, 7):
        for emit in (False, True):
            got = [cheb.smoother_eligible(g, F32, deg, emit) for g in grids]
            ref = [_reference_shape_rule(JGrid(nx=g.nx, ny=g.ny, lx=1.0,
                                               ly=1.0), deg, emit)
                   for g in grids]
            assert got == ref, (deg, emit)
    # the bench preset (degree 4): 1024, 512 and 256 fuse, with the residual
    fused = [g.nx for g in grids if cheb.smoother_eligible(g, F32, 4, True)]
    assert fused == [m for m in (1024, 512, 256) if m <= n]
    assert not cheb.smoother_eligible(grid, torch.float64, 4)


@pytest.mark.parametrize("n,cycles", [(256, 2), (64, 1)])
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_preconditioner_bit_identical_with_fused_flags(monkeypatch, n,
                                                      cycles, bc):
    """CPU f32: the fused switches change nothing (every wrapper takes its
    plain version), with one and two V-cycles; the fused branches are
    taken (256^2: the smoother on level 0 and the coarse cycle from 128^2;
    64^2: the coarse cycle from 32^2)."""
    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk

    calls = {"smooth": 0, "coarse": 0}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cheb, "chebyshev_smooth",
                        counted("smooth", cheb.chebyshev_smooth))
    monkeypatch.setattr(cvk, "coarse_vcycle",
                        counted("coarse", cvk.coarse_vcycle))
    grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
    bcs = _bcs(bc)
    rng = np.random.default_rng(5)
    es = t(np.exp(2 * rng.standard_normal(grid.shape_corner)), F32)
    en = t(np.exp(2 * rng.standard_normal(grid.shape_center)), F32)
    kcont, kbnd = scaling.stokes_scales(scaling.characteristic_viscosity(en),
                                        grid)
    lam = mg.estimate_mg_lambdas(es, en, grid, bcs, kbnd, semicoarsen=2.0,
                                 mode="gershgorin")
    r = tuple(t(rng.standard_normal(s), F32)
              for s in (grid.shape_vx, grid.shape_vy, grid.shape_center))
    outs = [mg.make_mg_preconditioner(
        es, en, grid, kcont, kbnd, bcs=bcs, cycles=cycles, pre_smooth=4,
        post_smooth=4, semicoarsen=2.0, lam_max=lam,
        use_pallas_smoother=on, use_pallas_coarse=on)(r) for on in (True, False)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert calls["coarse"] == cycles
    assert calls["smooth"] == (2 * cycles if n == 256 else 0)


def _bench_levels(cfg, grid):
    """The MG level grids of a bench preset's solve (shapes only)."""
    s = cfg.solver
    grids = [grid]
    for step in mg.coarsening_plan(grid, s.mg_levels,
                                   semi_threshold=s.mg_semicoarsen):
        grids.append(grids[-1].coarsen(*step))
    return grids, max(s.mg_pre_smooth, s.mg_post_smooth)


@pytest.mark.parametrize("preset", ["fk", "sticky_air"])
def test_tile_plan_covers_each_point_once(preset):
    """csrc/cheb.cu's per-level tile plan on the levels the fused sweep
    takes in the FK 1024^2 and sticky-air 1024x256 solves, at the depths
    they run (degree + residual, degree): every point of the (ny+1, nx+1)
    point space in exactly one tile, the loaded region within the
    kernel's threads and the shared memory within a block's budget."""
    from pylamp_tpu_torch.models.benchmarks import (
        fk_bench_config,
        sticky_air_bench_config,
    )
    if preset == "fk":
        cfg, grid = fk_bench_config(1024), StaggeredGrid(nx=1024, ny=1024,
                                                         lx=1.0, ly=1.0)
        want = [(1024, 1024), (512, 512), (256, 256)]
    else:
        cfg = sticky_air_bench_config(1024)
        grid = StaggeredGrid(nx=1024, ny=256, lx=4.0, ly=1.0)
        want = [(256, 1024), (128, 512), (64, 256)]
    grids, deg = _bench_levels(cfg, grid)
    levels = [g for g in grids if cheb.smoother_eligible(g, F32, deg, True)]
    assert [(g.ny, g.nx) for g in levels] == want
    blocks = []
    for g in levels:
        for he in (deg + 1, deg):
            plan = cheb.tile_plan(g.ny, g.nx, he)
            seen = np.zeros((g.ny + 1, g.nx + 1), np.int32)
            for r0, rows, c0, cols in plan.extents(g.ny, g.nx):
                assert 1 <= rows <= plan.ty + 1 and 1 <= cols <= cheb.TILE_X + 1
                seen[r0:r0 + rows, c0:c0 + cols] += 1
            assert (seen == 1).all()
            loaded = (plan.ty + 1 + 2 * he) * (cheb.TILE_X + 1 + 2 * he)
            assert loaded <= plan.nq * cheb.THREADS
            assert plan.smem <= cheb.SMEM_PER_BLOCK
            if he == deg + 1:
                blocks.append(plan.nty * plan.ntx)
    # the smallest level spreads over more blocks than 32x32 tiles give
    g = levels[-1]
    assert blocks[-1] > -(-g.ny // 32) * -(-g.nx // 32)


@pytest.mark.parametrize("ny,nx,he", [(8, 256, 7), (40, 300, 3),
                                      (333, 517, 5), (16, 256, 1)])
def test_tile_plan_ragged_levels(ny, nx, he):
    """Ragged and the smallest eligible levels: one tile per point."""
    plan = cheb.tile_plan(ny, nx, he)
    seen = np.zeros((ny + 1, nx + 1), np.int32)
    for r0, rows, c0, cols in plan.extents(ny, nx):
        seen[r0:r0 + rows, c0:c0 + cols] += 1
    assert (seen == 1).all()
    assert plan.smem <= cheb.SMEM_PER_BLOCK
