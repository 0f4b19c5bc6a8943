"""The kernel gates on a stretched grid, on the CPU.

Every kernel divides by the scalar dx, dy, so the reference turns each one
off on a non-uniform grid (models/step.py m2g, advect and rebucket gates,
mg.py _pallas_eligible, stokes_kernel.saddle_apply_eligible,
cheb_kernel.smoother_eligible, coarse_vcycle_kernel.coarse_fuse_start).
Here every kernel entry point that ``make_step_phases`` can reach is
wrapped to record its calls (their CUDA launchers raise): one f32 step
with the mixed-precision solve on a 32x32 FK grid with y edges geometric
4x must reach none of them, and the same step on the uniform grid must
still reach the wrappers whose gates hold at 32^2 (the transfers,
advection, rebucket, saddle apply and coarse sub-V-cycle; the fused
smoother and the momentum kernel take larger levels).  Also
``saddle_apply_eligible``'s cases, and the stretched configurations.
"""
import dataclasses

import pytest
import torch
import torch_helpers  # noqa: F401  (one torch thread)

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid, geometric_edges
from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
from pylamp_tpu_torch.models import step as step_mod
from pylamp_tpu_torch.models.benchmarks import fk_bench_config
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.ops.kernels import cheb, momentum, saddle
from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
from pylamp_tpu_torch.ops.kernels.saddle import saddle_apply_eligible

N = 32
# (module, wrapper) of every entry point; the wrappers a CPU step reaches
# where its gate holds, and their CUDA launchers, which it never may
WRAPPERS = ((step_mod, "m2g_fused"), (step_mod, "advect_rk4_fused"),
            (step_mod, "rebucket_fused"), (saddle, "saddle_apply"),
            (momentum, "momentum_apply_kernel"), (cheb, "chebyshev_smooth"),
            (cheb, "prep_smoother"), (cvk, "coarse_vcycle"))
LAUNCHERS = ((m2g, "m2g_fused_cuda"), (advect, "advect_rk4_cuda"),
             (rebucket, "rebucket_cuda"), (saddle, "saddle_apply_cuda"),
             (momentum, "momentum_apply_cuda"),
             (cheb, "chebyshev_smooth_cuda"), (cvk, "coarse_vcycle_cuda"))
UNIFORM_REACHED = {"m2g_fused", "advect_rk4_fused", "rebucket_fused",
                   "saddle_apply", "coarse_vcycle"}


def _config(stretched: bool):
    cfg = fk_bench_config(N)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, use_pallas=True))
    if stretched:
        cfg = dataclasses.replace(cfg, y_edges=geometric_edges(N, cfg.ly,
                                                               4.0))
    return cfg


@pytest.mark.parametrize("stretched", [True, False])
def test_kernel_gates(monkeypatch, stretched):
    reached = []

    def record(name, fn):
        def wrapper(*args, **kwargs):
            reached.append(name)
            return fn(*args, **kwargs)
        return wrapper

    def refuse(name):
        def launcher(*args, **kwargs):
            raise AssertionError(f"{name} launched on the CPU")
        return launcher

    for mod, name in WRAPPERS:
        monkeypatch.setattr(mod, name, record(name, getattr(mod, name)))
    for mod, name in LAUNCHERS:
        monkeypatch.setattr(mod, name, refuse(name))
    cfg = _config(stretched)
    grid, table, state = build(cfg, dtype=torch.float32, device="cpu")
    assert grid.uniform is not stretched
    state, diag = step_mod.make_step(grid, cfg, table)(state)
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    assert bool(torch.isfinite(state.vy).all())
    if stretched:
        assert reached == []
        assert bool((state.mg_lam > 0).all())  # power-iteration bounds
    else:
        assert set(reached) == UNIFORM_REACHED


def test_saddle_apply_eligible():
    walls, periodic = VelocityBCs(), VelocityBCs(left="periodic",
                                                 right="periodic")
    uniform = StaggeredGrid(nx=8, ny=8, lx=1.0, ly=1.0)
    stretched = StaggeredGrid(nx=8, ny=8, lx=1.0, ly=1.0,
                              y_edges=geometric_edges(8, 1.0, 3.0))
    f32, f64 = torch.float32, torch.float64
    assert saddle_apply_eligible(uniform, f32, walls)
    assert saddle_apply_eligible(uniform, f32, periodic)
    assert not saddle_apply_eligible(uniform, f64, walls)
    assert not saddle_apply_eligible(stretched, f32, walls)


def test_stretched_configs():
    """``fk_stretched_bench_config`` is ``bench.py --stretch-y 8``: the FK
    bench preset with geometric y edges and nothing else changed; its
    line-smoother partner changes the three smoother fields only."""
    from pylamp_tpu.core.grid import geometric_edges as jgeometric_edges
    from pylamp_tpu_torch.models.benchmarks import fk_stretched_bench_config
    from pylamp_tpu_torch.models.profile import (
        CONFIGS,
        fk_stretched_line_config,
    )

    def plain(c):  # the fields, without the set-up closures
        return dataclasses.replace(c, material_of=None, T_of=None)

    base, cfg = fk_bench_config(64), fk_stretched_bench_config(64)
    assert cfg.y_edges == jgeometric_edges(64, base.ly, 8.0)
    assert plain(dataclasses.replace(cfg, y_edges=None)) == plain(base)
    line = fk_stretched_line_config(64)
    assert plain(line) == plain(dataclasses.replace(
        cfg, solver=dataclasses.replace(
            cfg.solver, mg_smoother="line", energy_preconditioner="mg",
            energy_mg_smoother="line")))
    assert plain(CONFIGS["fk_stretched_line"](64)) == plain(line)
    assert plain(CONFIGS["fk_stretched"](64)) == plain(cfg)
