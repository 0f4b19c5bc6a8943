"""Port vs reference: the MG's scaled transfers and line-search damping,
and every solver option through ``make_step``.

- ``make_velocity_mg`` with ``scaled_transfers``, with ``ls_damp`` and
  with both (both also with the emitted residual), one V-cycle at 32^2 on
  a log-normal viscosity field, f64, on three levels with 8 coarse sweeps
  and the Chebyshev bounds given (the Gershgorin bound 3 on every level):
  1e-12 relative to the reference's;
- the card's form on the CPU: f32 at 256x128 (two levels, 8 coarse
  sweeps) with both options and ``use_pallas`` / ``use_pallas_smoother``,
  so that the level-0 sweeps go through the fused smoother's wrapper and
  the line search's momentum applies through the momentum kernel's
  (their plain versions on CPU tensors; spies count the calls), within
  1e-4 of the same V-cycle in f64 (max |diff| over max |ref|; the f64
  form is the one held to the reference above);
- ``make_step`` builds and takes one falling-block 16^2 f64 step with
  each of ``schur="wbfbt"``, ``preconditioner="vanka"`` (with
  ``mg_semicoarsen=0``: the step refuses semicoarsening with Vanka, as
  the reference's), ``mg_scaled_transfers`` and ``mg_ls_damp``, converged to 1e-8 with no
  marker dropped, velocities within 1e-6 max|vy| of the default solver's
  step (each solve meets the 1e-8 gate; the options change the path, not
  the solution);
- the fused coarse sub-V-cycle's gate refuses either option.

The JAX references are computed once per module (one jitted function).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.solvers.mg import make_velocity_mg as j_make_velocity_mg
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.models.benchmarks import falling_block
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.ops.kernels import cheb, momentum
from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
from pylamp_tpu_torch.solvers import mg

BCS = VelocityBCs(top="no_slip")
KBND = 7.0
OPTIONS = {"scaled": (True, False), "ls_damp": (False, True),
           "both": (True, True)}
SHAPES = {"f64": (32, 32), "f32": (256, 128)}
LEVELS = {"f64": 3, "f32": 2}
COARSE_ITERS = 8
LAM = 3.0  # the Gershgorin bound of D^-1 A (solvers/mg.py gershgorin_lambda)
STEP_OPTIONS = {
    "wbfbt": dict(schur="wbfbt"),
    "vanka": dict(preconditioner="vanka", mg_semicoarsen=0.0),
    "scaled_transfers": dict(mg_scaled_transfers=True),
    "ls_damp": dict(mg_ls_damp=True),
}


def _mg_args(key, xp, dtype):
    """The keyword arguments both packages' make_velocity_mg take here."""
    return dict(levels=LEVELS[key], coarse_iters=COARSE_ITERS,
                lam_max=xp.full((LEVELS[key],), LAM, dtype=dtype))


def _problem(key):
    nx, ny = SHAPES[key]
    grid = StaggeredGrid(nx=nx, ny=ny, lx=nx / ny, ly=1.0)
    jgrid = JGrid(nx=nx, ny=ny, lx=nx / ny, ly=1.0)
    rng = np.random.default_rng(40)
    return grid, jgrid, (np.exp(2.0 * rng.normal(size=grid.shape_corner)),
                         np.exp(2.0 * rng.normal(size=grid.shape_center)),
                         rng.normal(size=grid.shape_vx),
                         rng.normal(size=grid.shape_vy))


@pytest.fixture(scope="module")
def reference():
    out = {}
    _, jgrid, arrays = _problem("f64")

    def run64(es, en, rx, ry):
        res = {}
        for name, (st, ls) in OPTIONS.items():
            V = j_make_velocity_mg(es, en, jgrid, jax_vbcs(BCS), KBND,
                                   scaled_transfers=st, ls_damp=ls,
                                   **_mg_args("f64", jnp, jnp.float64))
            res[name] = V(rx, ry)
        res["both_emit"] = V(rx, ry, emit=True)
        return res

    out["f64"] = jax.jit(run64)(*(jnp.asarray(a) for a in arrays))
    return out


@pytest.mark.parametrize("option,emit", [(o, False) for o in OPTIONS]
                         + [("both", True)])
def test_vcycle_matches_reference(reference, option, emit):
    grid, _, arrays = _problem("f64")
    es, en, rx, ry = (t(a) for a in arrays)
    st, ls = OPTIONS[option]
    V = mg.make_velocity_mg(es, en, grid, BCS, KBND, scaled_transfers=st,
                            ls_damp=ls,
                            **_mg_args("f64", torch, torch.float64))
    ref = reference["f64"][f"{option}_emit" if emit else option]
    got = V(rx, ry, emit=emit)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12


def test_vcycle_f32_through_kernel_wrappers(monkeypatch):
    grid, _, arrays = _problem("f32")
    ref = mg.make_velocity_mg(*(t(a) for a in arrays[:2]), grid, BCS, KBND,
                              scaled_transfers=True, ls_damp=True,
                              **_mg_args("f32", torch, torch.float64))(
        *(t(a) for a in arrays[2:]))
    es, en, rx, ry = (t(a, torch.float32) for a in arrays)
    calls = {"cheb": 0, "momentum": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cheb, "chebyshev_smooth",
                        spy("cheb", cheb.chebyshev_smooth))
    monkeypatch.setattr(momentum, "momentum_apply_kernel",
                        spy("momentum", momentum.momentum_apply_kernel))
    V = mg.make_velocity_mg(es, en, grid, BCS, torch.tensor(KBND),
                            scaled_transfers=True, ls_damp=True,
                            use_pallas=True, use_pallas_smoother=True,
                            **_mg_args("f32", torch, torch.float32))
    got = V(rx, ry)
    assert calls["cheb"] > 0 and calls["momentum"] > 0
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert rel(g, r.numpy()) <= 1e-4


STEP_CFG = dataclasses.replace(
    falling_block(nx=16, ny=16, max_steps=1),
    solver=dataclasses.replace(falling_block().solver, stokes_tol=1e-8,
                               stokes_maxiter=400))


@pytest.fixture(scope="module")
def base_step():
    """The built 16^2 f64 state and the default solver's step from it."""
    grid, table, st0 = build(STEP_CFG, dtype=torch.float64, device="cpu")
    return grid, table, st0, make_step(grid, STEP_CFG, table)(st0)[0]


@pytest.mark.parametrize("option", list(STEP_OPTIONS))
def test_step_with_option(base_step, option):
    grid, table, st0, base = base_step
    opt = dataclasses.replace(STEP_CFG, solver=dataclasses.replace(
        STEP_CFG.solver, **STEP_OPTIONS[option]))
    st, diag = make_step(grid, opt, table)(st0)
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    vmax = float(torch.max(torch.abs(base.vy)))
    for a, b in ((st.vx, base.vx), (st.vy, base.vy)):
        assert float(torch.max(torch.abs(a - b))) <= 1e-6 * vmax


def test_coarse_fusion_refuses_the_options():
    grid = StaggeredGrid(nx=512, ny=512, lx=1.0, ly=1.0)
    plan = mg.coarsening_plan(grid)
    grids = [grid]
    for step in plan:
        grids.append(grids[-1].coarsen(*step))
    args = (grids, plan, BCS, torch.float32, "chebyshev")
    assert cvk.coarse_fuse_start(*args, False, False) is not None
    for st, ls in OPTIONS.values():
        assert cvk.coarse_fuse_start(*args, st, ls) is None
