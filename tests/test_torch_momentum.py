"""Port vs reference: the MG momentum apply (kernel 7).

The plain version ``ops/kernels/momentum.py momentum_apply_plain`` against
the JAX package's Pallas kernel ``momentum_apply_pallas`` (interpret mode
on the CPU) and its jnp operator ``_momentum_apply``, at the shapes and
block heights of tests/test_pallas_stokes.py, in f32 with that test's bar
1e-5 max|ref| (the kernel sums in another order).  The wrapper and the MG
dispatcher take the plain version on CPU tensors, and the dispatcher's
level gate picks the reference's levels.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.ops.pallas.stokes_kernel import momentum_apply_pallas
from pylamp_tpu.solvers import mg as jmg
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels import momentum
from pylamp_tpu_torch.solvers import mg

F32 = torch.float32


def _problem(nx, ny, slip, seed):
    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.3, ly=0.9)
    bcs = VelocityBCs(top=slip, bottom="free_slip", left="no_slip",
                      right=slip)
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=grid.shape_vx), rng.normal(size=grid.shape_vy),
              np.exp(rng.normal(size=grid.shape_corner)),
              np.exp(rng.normal(size=grid.shape_center)))
    return grid, bcs, tuple(a.astype(np.float32) for a in arrays)


@pytest.mark.parametrize("slip", ["free_slip", "no_slip"])
@pytest.mark.parametrize("nx,ny,br", [(16, 16, 8), (24, 32, 16)])
def test_plain_matches_reference(slip, nx, ny, br):
    grid, bcs, arrays = _problem(nx, ny, slip, 11 + nx)
    kbnd = 7.5
    jgrid, jbcs = JGrid(nx=nx, ny=ny, lx=1.3, ly=0.9), jax_vbcs(bcs)
    jarrays = [jnp.asarray(a) for a in arrays]
    pallas = momentum_apply_pallas(*jarrays, jgrid, jbcs, kbnd,
                                   block_rows=br, interpret=True)
    jnp_ref = jmg._momentum_apply(*jarrays, jgrid, jbcs, kbnd)
    got = momentum.momentum_apply_plain(*(t(a) for a in arrays), grid, bcs,
                                        kbnd)
    for ref in (pallas, jnp_ref):
        for g, r in zip(got, ref):
            r = np.asarray(r, np.float64)
            assert g.dtype == F32 and g.shape == r.shape
            err = np.max(np.abs(g.double().numpy() - r))
            assert err <= 1e-5 * np.max(np.abs(r))


@pytest.mark.parametrize("slip", ["free_slip", "no_slip"])
def test_wrapper_and_dispatcher_take_plain_on_cpu(slip):
    """On CPU tensors the wrapper and the MG dispatcher return the plain
    version's result bit for bit and launch nothing; ``prep_momentum``
    keeps kbnd as a 1-element f32 tensor for the kernel, and the dispatcher
    refuses an eligible level without it."""
    grid, bcs, arrays = _problem(256, 128, slip, 3)  # an eligible level
    vx, vy, es, en = (t(a) for a in arrays)
    kbnd = torch.tensor(7.5, dtype=F32)
    ref = momentum.momentum_apply_plain(vx, vy, es, en, grid, bcs, kbnd)
    prep = momentum.prep_momentum(es, en, kbnd)
    assert prep.kb.shape == (1,) and prep.kb.dtype == F32
    n0 = momentum.launches
    outs = [momentum.momentum_apply_kernel(vx, vy, prep, grid, bcs),
            mg.momentum_apply(vx, vy, es, en, grid, bcs, kbnd,
                              use_pallas=True, prepped=prep),
            mg.momentum_apply(vx, vy, es, en, grid, bcs, kbnd)]
    with pytest.raises(ValueError):
        mg.momentum_apply(vx, vy, es, en, grid, bcs, kbnd, use_pallas=True)
    assert momentum.launches == n0
    for out in outs:
        for o, r in zip(out, ref):
            assert torch.equal(o, r)


def test_gate_picks_reference_levels(monkeypatch):
    """At the sticky-air 1024x256 hierarchy (and the FK 1024^2 one) the
    port's gate takes the levels the reference's takes on its chip: f32,
    ny % 128 == 0, nx >= 256 -- 1024x256 and 512x128.  The reference's gate
    also asks for a TPU, so its device list is stood in for here."""
    monkeypatch.setattr(
        jax, "devices", lambda *a: [types.SimpleNamespace(platform="tpu")])
    for nx, ny, lx, ly in ((1024, 256, 2.8e6, 8.0e5), (1024, 1024, 1.0, 1.0)):
        grid = StaggeredGrid(nx=nx, ny=ny, lx=lx, ly=ly)
        jgrid = JGrid(nx=nx, ny=ny, lx=lx, ly=ly)
        plan = mg.coarsening_plan(grid, 0, semi_threshold=2.0)
        assert plan == jmg.coarsening_plan(jgrid, 0, semi_threshold=2.0)
        grids, jgrids = [grid], [jgrid]
        for step in plan:
            grids.append(grids[-1].coarsen(*step))
            jgrids.append(jgrids[-1].coarsen(*step))
        for dt, jdt in ((F32, jnp.float32), (torch.float64, jnp.float64)):
            got = [mg._pallas_eligible(g, dt) for g in grids]
            assert got == [jmg._pallas_eligible(g, jdt) for g in jgrids]
        taken = [(g.ny, g.nx) for g in grids if mg._pallas_eligible(g, F32)]
        if ny == 256:
            assert taken == [(256, 1024), (128, 512)]
