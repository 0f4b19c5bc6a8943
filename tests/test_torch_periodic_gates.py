"""Where each periodic kernel form launches: the port's level gates against
the reference's on the FK 1024^2, periodic falling-block 1024^2 and
sticky-air 1024x256 hierarchies (shapes only, on the CPU).

- ``cheb.smoother_eligible`` (kernel 5) against the reference's
  ``cheb_kernel.smoother_eligible`` shape rule without its platform test,
  as tests/test_torch_cheb.py holds it;
- ``mg._pallas_eligible`` (kernel 7) against the reference's, its device
  list stood in for by a TPU;
- ``coarse_vcycle.coarse_fuse_start`` (kernel 6) against the reference's.

Neither of the first two gates reads the walls, so under periodic side
walls they take the same levels as without them; kernel 6's refuses
periodic walls, in the port as in the reference.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from torch_helpers import jax_vbcs

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.ops.pallas import cheb_kernel as jcheb
from pylamp_tpu.ops.pallas import coarse_vcycle_kernel as jcvk
from pylamp_tpu.solvers import mg as jmg
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.models.benchmarks import (
    falling_block_periodic_config,
    fk_bench_config,
    sticky_air_bench_config,
)
from pylamp_tpu_torch.ops.kernels import cheb
from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
from pylamp_tpu_torch.solvers import mg

F32 = torch.float32
PERIODIC = VelocityBCs(left="periodic", right="periodic")
CONFIGS = {"fk": fk_bench_config, "periodic": falling_block_periodic_config,
           "sticky_air": sticky_air_bench_config}


def _hierarchy(name):
    cfg = CONFIGS[name](1024)
    s = cfg.solver
    grid = StaggeredGrid(nx=cfg.nx, ny=cfg.ny, lx=cfg.lx, ly=cfg.ly)
    jgrid = JGrid(nx=cfg.nx, ny=cfg.ny, lx=cfg.lx, ly=cfg.ly)
    plan = mg.coarsening_plan(grid, s.mg_levels,
                              semi_threshold=s.mg_semicoarsen)
    assert plan == jmg.coarsening_plan(jgrid, s.mg_levels,
                                       semi_threshold=s.mg_semicoarsen)
    grids, jgrids = [grid], [jgrid]
    for step in plan:
        grids.append(grids[-1].coarsen(*step))
        jgrids.append(jgrids[-1].coarsen(*step))
    return cfg, plan, grids, jgrids


def _reference_smoother_rule(g, iters, emit):
    """The reference's kernel 5 gate without its platform test."""
    h = jcheb._pick_h(iters + (1 if emit else 0))
    return (h is not None and iters >= 1 and g.nx >= 256
            and jcheb._pick_block_rows(g.ny, g.nx, h,
                                       n_out=4 if emit else 2) is not None)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gates_pick_reference_levels(name, monkeypatch):
    monkeypatch.setattr(
        jax, "devices", lambda *a: [types.SimpleNamespace(platform="tpu")])
    cfg, plan, grids, jgrids = _hierarchy(name)
    deg = max(cfg.solver.mg_pre_smooth, cfg.solver.mg_post_smooth)
    for emit in (False, True):
        got = [cheb.smoother_eligible(g, F32, deg, emit) for g in grids]
        assert got == [_reference_smoother_rule(g, deg, emit)
                       for g in jgrids], emit
    got = [mg._pallas_eligible(g, F32) for g in grids]
    assert got == [jmg._pallas_eligible(g, jnp.float32) for g in jgrids]

    fused = [(g.ny, g.nx) for g in grids
             if cheb.smoother_eligible(g, F32, deg, True)]
    momentum = [(g.ny, g.nx) for g in grids if mg._pallas_eligible(g, F32)]
    if name == "sticky_air":
        assert momentum == [(256, 1024), (128, 512)]
    else:  # kernels 5 and 7 take the same levels: 1024^2, 512^2, 256^2
        assert fused == momentum == [(1024, 1024), (512, 512), (256, 256)]

    bcs = cfg.physics.velocity_bcs
    assert bcs.periodic_x == (name == "periodic")
    for vbcs in {bcs, PERIODIC, VelocityBCs()}:
        fs = cvk.coarse_fuse_start(grids, plan, vbcs, F32, "chebyshev",
                                   False, False)
        jfs = jcvk.coarse_fuse_start(jgrids, plan, jax_vbcs(vbcs),
                                     jnp.float32, "chebyshev", False, False)
        assert fs == jfs
        assert (fs is None) == vbcs.periodic_x


def test_periodic_partner_config():
    """The periodic preset's partner differs only in use_pallas and
    use_pallas_smoother; both keep the reference preset's solver values."""
    cfg = falling_block_periodic_config(1024)
    partner = falling_block_periodic_config(1024, fused_smoother=False)
    assert cfg.solver.stokes_tol == 1e-8 and cfg.nx == cfg.ny == 1024
    assert dataclasses.replace(partner.solver, use_pallas=False,
                               use_pallas_smoother=True) == cfg.solver
    assert partner.solver.use_pallas and not partner.solver.use_pallas_smoother
    assert 2 * cfg.markers_per_cell_dim ** 2 == 18
