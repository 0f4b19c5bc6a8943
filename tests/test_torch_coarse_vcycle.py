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
