"""Port vs reference under periodic side walls: the fused Chebyshev
smoother's plain version (kernel 5's, ops/kernels/cheb.py) against the JAX
package's ``chebyshev_smooth_pallas`` in interpret mode, on the CPU.

The cases, shape (256 x 16), seam-consistent inputs and bar (2e-5 max|ref|
per output) are those of tests/test_cheb_kernel.py
test_fused_smoother_periodic.  The seam columns of the smoothed vx (and of
the emitted residual) stay identical, and the port's MG keeps the fused
switches' result on the CPU: with every switch on and off, the periodic
preconditioner is bit-identical.
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


@pytest.mark.parametrize("iters,zero_init,emit", [
    (3, False, False), (3, True, False), (1, False, False), (5, True, False),
    (7, False, False), (2, True, True), (4, False, True)])
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_plain_matches_pallas_kernel(iters, zero_init, emit, bc):
    grid = StaggeredGrid(nx=256, ny=16, lx=2.0, ly=1.0)
    bcs = VelocityBCs(top=bc, bottom=bc, left="periodic", right="periodic")
    rng = np.random.default_rng(17)
    eta_s = np.exp(rng.standard_normal(grid.shape_corner) * 2.0)
    eta_s[:, -1] = eta_s[:, 0]
    eta_n = np.exp(rng.standard_normal(grid.shape_center) * 2.0)
    rx = rng.standard_normal(grid.shape_vx)
    rx[:, -1] = rx[:, 0]
    ry = rng.standard_normal(grid.shape_vy)
    if zero_init:
        ex, ey = np.zeros(grid.shape_vx), np.zeros(grid.shape_vy)
    else:
        ex = rng.standard_normal(grid.shape_vx)
        ex[:, -1] = ex[:, 0]
        ey = rng.standard_normal(grid.shape_vy)
    kbnd, lam = 7.5, 3.7
    arrays = (ex, ey, rx, ry, eta_s, eta_n)

    ref = jcheb.chebyshev_smooth_pallas(
        *(jnp.asarray(a, jnp.float32) for a in arrays),
        JGrid(nx=256, ny=16, lx=2.0, ly=1.0), jax_vbcs(bcs), kbnd,
        jnp.asarray(lam, jnp.float32), iters, zero_init=zero_init,
        block_rows=8, interpret=True, emit_residual=emit)
    tex, tey, trx, try_, tes, ten = (t(a, F32) for a in arrays)
    prep = cheb.prep_smoother(tes, ten, grid, bcs, kbnd,
                              torch.tensor(lam, dtype=F32), iters + emit)
    n0 = cheb.launches
    got = cheb.chebyshev_smooth(tex, tey, trx, try_, prep, grid, bcs, iters,
                                zero_init, emit)
    assert cheb.launches == n0  # CPU tensors: the plain version
    assert len(got) == len(ref) == (4 if emit else 2)
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float64)
        err = np.max(np.abs(g.double().numpy() - r))
        assert err <= 2e-5 * np.max(np.abs(r))
    for g in got[::2]:  # ex' and, with emit, rx - A ex'
        assert torch.equal(g[:, 0], g[:, -1])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_periodic_preconditioner_same_with_fused_flags(use_pallas):
    """On CPU tensors the periodic MG takes the plain versions on every
    branch: the preconditioner's output is bit-identical with the kernel
    switches on and off, and its vx seam columns stay equal."""
    grid = StaggeredGrid(nx=256, ny=256, lx=1.0, ly=1.0)
    bcs = VelocityBCs(left="periodic", right="periodic")
    rng = np.random.default_rng(19)
    es = np.exp(rng.standard_normal(grid.shape_corner))
    es[:, -1] = es[:, 0]
    es, en = t(es, F32), t(np.exp(rng.standard_normal(grid.shape_center)), F32)
    kcont, kbnd = scaling.stokes_scales(scaling.characteristic_viscosity(en),
                                        grid)
    r = [t(rng.standard_normal(s), F32)
         for s in (grid.shape_vx, grid.shape_vy, grid.shape_center)]
    r[0][:, 0] = r[0][:, -1] = 0.5 * r[0][:, 0]
    outs = [mg.make_mg_preconditioner(
        es, en, grid, kcont, kbnd, bcs=bcs, pre_smooth=3, post_smooth=3,
        semicoarsen=2.0, use_pallas=use_pallas and on,
        use_pallas_smoother=on, use_pallas_coarse=on)(tuple(r))
        for on in (False, True)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(outs[1][0][:, 0], outs[1][0][:, -1])
