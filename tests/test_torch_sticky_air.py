"""Port vs reference: the sticky-air path (BASELINE config 5), f64 on the
CPU unless stated.

Inputs: the sticky-air viscosity field at 64x16 (SI units, three
materials, a cell-sharp contrast of 1e4-1e5) from the port's ``build``,
which seeds it exactly like the reference, and seeded numpy vectors.

- the augmented Lagrangian (``solvers/al.py``): <= 1e-12 relative;
- power-iteration Chebyshev bounds, fresh and warm-started from a hint:
  <= 1e-10 relative; the eta-capped coarse hierarchy: <= 1e-12;
- one V-cycle with its own power bounds on the capped hierarchy, and the
  preset's block preconditioner (AL gamma 10, 16-iteration inner FGMRES at
  3e-3, eta cap 1e2), and the same with the flexible-CG inner solve:
  <= 1e-8 relative;
- the level gates at 1024x256: kernel 5 at depth 7 and kernel 6's fusion
  start pick the reference's levels (kernel 7's gate:
  tests/test_torch_momentum.py);
- two ``sticky_air(64, 16)`` steps through the bridge: velocities within
  1e-6 max|v|, markers within 1e-7 of the domain, outer Krylov counts +-1
  (the bars of tests/test_torch_step.py); and the port's mixed-precision
  step (the card's path) converging to 1e-8 within 1e-4 max|v| of the
  reference's f64 step.

The JAX functions compile once per module (module-scoped fixtures); f64
keeps the reference's step compile short.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict, jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.step import make_step as jax_make_step
from pylamp_tpu.ops import stokes as jstokes_ops
from pylamp_tpu.ops.pallas import cheb_kernel as jcheb
from pylamp_tpu.ops.pallas import coarse_vcycle_kernel as jcvk
from pylamp_tpu.solvers import al as jal
from pylamp_tpu.solvers import mg as jmg
from pylamp_tpu.solvers import scaling as jscaling
from pylamp_tpu_torch.bridge import state_from_numpy
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.models.benchmarks import sticky_air
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.ops import stokes as stokes_ops
from pylamp_tpu_torch.ops.kernels import cheb
from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
from pylamp_tpu_torch.solvers import al, mg, scaling

NX, NY = 64, 16
CFG = sticky_air(NX, NY, max_steps=10)
SOLVER = CFG.solver
VBC = CFG.physics.velocity_bcs
JVBC = jax_vbcs(VBC)
LX, LY = CFG.lx, CFG.ly
JGRID = JGrid(nx=NX, ny=NY, lx=LX, ly=LY)
SEMI = SOLVER.mg_semicoarsen
DEG = SOLVER.mg_pre_smooth
GAMMA = SOLVER.stokes_al_gamma
CAP = SOLVER.mg_eta_cap
STEPS = 2
# the preset's MG options, without the reference's kernels (its CPU path)
MG_KW = dict(pre_smooth=DEG, post_smooth=DEG, semicoarsen=SEMI)
JMG_KW = dict(MG_KW, use_pallas=False, use_pallas_smoother=False,
              use_pallas_coarse=False)


@pytest.fixture(scope="module")
def field():
    """(grid, eta_s, eta_n) numpy f64 and the scales (kcont, kbnd) of both
    packages."""
    grid, _, st = build(CFG, dtype=torch.float64, device="cpu")
    es, en = st.eta_s.numpy(), st.eta_n.numpy()
    kcont, kbnd = scaling.stokes_scales(
        scaling.characteristic_viscosity(t(en)), grid)
    jk = jscaling.stokes_scales(
        jscaling.characteristic_viscosity(jnp.asarray(en)), JGRID)
    return grid, es, en, (kcont, kbnd), jk


def _vectors(grid, seed, n=3):
    rng = np.random.default_rng(seed)
    shapes = (grid.shape_vx, grid.shape_vy, grid.shape_center)[:n]
    return [rng.standard_normal(s) for s in shapes]


def test_al_matches_reference(field):
    grid, es, en, (kcont, kbnd), (jkcont, jkbnd) = field
    assert float(kcont) == pytest.approx(float(jkcont), rel=1e-12)
    vx, vy, p = _vectors(grid, 1)
    gd = al.make_grad_div(t(en), grid, VBC, GAMMA, torch.float64)
    jgd = jal.make_grad_div(jnp.asarray(en), JGRID, JVBC, GAMMA,
                            jnp.float64)
    for g, r in zip(gd(t(vx), t(vy)), jgd(jnp.asarray(vx), jnp.asarray(vy))):
        assert rel(g, r) <= 1e-12

    op = al.augment_saddle_op(
        lambda u: stokes_ops.stokes_operator(*u, t(es), t(en), grid, VBC,
                                             kcont=kcont, kbnd=kbnd), gd)
    jop = jal.augment_saddle_op(
        lambda u: jstokes_ops.stokes_operator(
            *u, jnp.asarray(es), jnp.asarray(en), JGRID, JVBC, kcont=jkcont,
            kbnd=jkbnd), jgd)
    got = op((t(vx), t(vy), t(p)))
    ref = jax.jit(jop)(tuple(jnp.asarray(a) for a in (vx, vy, p)))
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12

    b = _vectors(grid, 2)
    got = al.augment_rhs(tuple(t(a) for a in b), t(en), grid, VBC, GAMMA,
                         kcont, torch.float64)
    ref = jal.augment_rhs(tuple(jnp.asarray(a) for a in b), jnp.asarray(en),
                          JGRID, JVBC, GAMMA, jkcont, jnp.float64)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12


@jax.jit
def _jax_power(es, en, kbnd, hint):
    return (jmg.estimate_mg_lambdas(es, en, JGRID, JVBC, kbnd,
                                    semicoarsen=SEMI),
            jmg.estimate_mg_lambdas(es, en, JGRID, JVBC, kbnd,
                                    semicoarsen=SEMI, hint=hint))


def test_power_lambdas(field):
    """Fresh (12 iterations per level) and warm-started from a hint whose
    level 1 is unset (12 iterations there, 2 on the others, floored at
    0.995x the hint)."""
    grid, es, en, (_, kbnd), (_, jkbnd) = field
    fresh = mg.estimate_mg_lambdas(t(es), t(en), grid, VBC, kbnd,
                                   semicoarsen=SEMI)
    hint = 1.02 * fresh
    hint[1] = 0.0
    warm = mg.estimate_mg_lambdas(t(es), t(en), grid, VBC, kbnd,
                                  semicoarsen=SEMI, hint=hint)
    jfresh, jwarm = _jax_power(jnp.asarray(es), jnp.asarray(en), jkbnd,
                               jnp.asarray(hint.numpy()))
    assert fresh.shape == (3,)  # 64x16 -> 32x8 -> 16x4
    assert rel(fresh, jfresh) <= 1e-10
    assert rel(warm, jwarm) <= 1e-10
    # the floor holds on the hinted levels
    assert float(warm[0]) >= 0.995 * float(hint[0])


@pytest.mark.parametrize("cap", [CAP, 10.0])
def test_capped_hierarchy(field, cap):
    """Each coarse level clipped to +-cap around its geometric mean (the
    reference's expression on its own coarsening); the fine level never.
    The preset's cap and a tighter one, which clips this field's coarse
    viscosities."""
    grid, es, en, (_, kbnd), _ = field
    _, grids, etas, _ = mg._hierarchy(t(es), t(en), grid, kbnd, 0, SEMI)
    plan = jmg.coarsening_plan(JGRID, 0, semi_threshold=SEMI)
    jetas = [(jnp.asarray(es), jnp.asarray(en))]
    for cx, cy in plan:
        jetas.append(jmg.coarsen_eta(*jetas[-1], cx=cx, cy=cy))

    def jcap(a):
        gm = jnp.exp(jnp.mean(jnp.log(a)))
        return jnp.clip(a, gm / cap, gm * cap)

    assert len(etas) == len(jetas) == 3
    clipped = False
    for l, ((a, b), (ja, jb)) in enumerate(zip(etas, jetas)):
        if l > 0:
            ca, cb = mg._cap_eta(a, cap), mg._cap_eta(b, cap)
            clipped |= not (torch.equal(ca, a) and torch.equal(cb, b))
            a, b, ja, jb = ca, cb, jcap(ja), jcap(jb)
        for g, r in ((a, ja), (b, jb)):
            assert g.shape == r.shape
            assert rel(g, r) <= 1e-12
    if cap == 10.0:
        assert clipped


def test_vcycle_power_lambda_capped(field):
    """make_velocity_mg(lam_max=None): its own power bounds (through the
    momentum dispatcher, on the capped hierarchy) and one V-cycle."""
    grid, es, en, (_, kbnd), (_, jkbnd) = field
    rx, ry = _vectors(grid, 3, n=2)
    jcycle = jmg.make_velocity_mg(jnp.asarray(es), jnp.asarray(en), JGRID,
                                  JVBC, jkbnd, eta_cap=CAP, **JMG_KW)
    ref = jax.jit(jcycle)(jnp.asarray(rx), jnp.asarray(ry))
    cycle = mg.make_velocity_mg(t(es), t(en), grid, VBC, kbnd, eta_cap=CAP,
                                **MG_KW)
    for g, r in zip(cycle(t(rx), t(ry)), ref):
        assert rel(g, r) <= 1e-10


def test_preconditioner_al_inner_fgmres(field):
    """The preset's block preconditioner on one seeded residual: (1 + gamma)
    mass Schur, 16-iteration inner FGMRES on A + gamma D^T eta D at 3e-3
    preconditioned by the capped V-cycle, power bounds."""
    grid, es, en, (kcont, kbnd), (jkcont, jkbnd) = field
    lam = mg.estimate_mg_lambdas(t(es), t(en), grid, VBC, kbnd,
                                 semicoarsen=SEMI)
    jlam = jnp.asarray(lam.numpy())
    kw = dict(velocity_inner_iters=SOLVER.mg_velocity_inner_iters,
              velocity_inner_tol=SOLVER.mg_velocity_inner_tol, eta_cap=CAP,
              al_gamma=GAMMA)
    r = _vectors(grid, 4)
    jM = jmg.make_mg_preconditioner(jnp.asarray(es), jnp.asarray(en), JGRID,
                                    jkcont, jkbnd, bcs=JVBC, lam_max=jlam,
                                    **kw, **JMG_KW)
    ref = jax.jit(jM)(tuple(jnp.asarray(a) for a in r))
    M = mg.make_mg_preconditioner(t(es), t(en), grid, kcont, kbnd, bcs=VBC,
                                  lam_max=lam, **kw, **MG_KW)
    got = M(tuple(t(a) for a in r))
    for g, rr in zip(got, ref):
        assert rel(g, rr) <= 1e-8
    # the flexible-CG inner velocity solve, as the reference's
    jM = jmg.make_mg_preconditioner(jnp.asarray(es), jnp.asarray(en), JGRID,
                                    jkcont, jkbnd, bcs=JVBC, lam_max=jlam,
                                    velocity_inner_method="fcg", **kw,
                                    **JMG_KW)
    ref = jax.jit(jM)(tuple(jnp.asarray(a) for a in r))
    M = mg.make_mg_preconditioner(t(es), t(en), grid, kcont, kbnd, bcs=VBC,
                                  lam_max=lam, velocity_inner_method="fcg",
                                  **kw, **MG_KW)
    for g, rr in zip(M(tuple(t(a) for a in r)), ref):
        assert rel(g, rr) <= 1e-8


def test_gates_at_1024x256():
    """Kernel 5 at depth 7 (degree 6 + the emitted residual) takes
    1024x256, 512x128 and 256x64 as the reference's shape rule does, and
    kernel 6's fusion starts at 128x32 in both packages."""
    grid = StaggeredGrid(nx=1024, ny=256, lx=LX, ly=LY)
    jgrid = JGrid(nx=1024, ny=256, lx=LX, ly=LY)
    plan = mg.coarsening_plan(grid, 0, semi_threshold=SEMI)
    assert plan == jmg.coarsening_plan(jgrid, 0, semi_threshold=SEMI)
    grids, jgrids = [grid], [jgrid]
    for step in plan:
        grids.append(grids[-1].coarsen(*step))
        jgrids.append(jgrids[-1].coarsen(*step))
    assert len(grids) == 7
    for emit in (True, False):
        got = [cheb.smoother_eligible(g, torch.float32, DEG, emit)
               for g in grids]
        h = jcheb._pick_h(DEG + (1 if emit else 0))
        ref = [h is not None and g.nx >= 256
               and jcheb._pick_block_rows(g.ny, g.nx, h,
                                          n_out=4 if emit else 2) is not None
               for g in jgrids]
        assert got == ref
    fused = [(g.ny, g.nx) for g in grids
             if cheb.smoother_eligible(g, torch.float32, DEG, True)]
    assert fused == [(256, 1024), (128, 512), (64, 256)]
    fs = cvk.coarse_fuse_start(grids, plan, VBC, torch.float32, "chebyshev",
                               False, False)
    jfs = jcvk.coarse_fuse_start(jgrids, plan, JVBC, jnp.float32,
                                 "chebyshev", False, False)
    assert fs == jfs == 3 and (grids[fs].ny, grids[fs].nx) == (32, 128)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's initial sticky-air state (path-keyed arrays) and
    its states + diagnostics after each of STEPS f64 steps."""
    jcfg = jax_config(CFG)
    jgrid, jtable, st = jax_build(jcfg, dtype=jnp.float64)
    d0 = jax_state_dict(st)
    step = jax.jit(jax_make_step(jgrid, jcfg, jtable))
    out = []
    for _ in range(STEPS):
        st, diag = step(st)
        out.append((jax_state_dict(st),
                    {k: np.asarray(v) for k, v in diag.items()}))
    return d0, out


@pytest.fixture(scope="module")
def port_run(reference):
    d0, _ = reference
    grid, table, _ = build(CFG, dtype=torch.float64, device="cpu")
    step = make_step(grid, CFG, table)
    st = state_from_numpy(d0, device="cpu")
    out = []
    for _ in range(STEPS):
        st, diag = step(st)
        out.append((st, diag))
    return out


@pytest.mark.parametrize("k", range(STEPS))
def test_step_f64_matches_reference(reference, port_run, k):
    ref, rdiag = reference[1][k]
    st, diag = port_run[k]
    vmax = float(np.max(np.abs(ref["state.vx"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-6 * vmax, name
    for name, got, size in (("markers.x", st.markers.x, LX),
                            ("markers.y", st.markers.y, LY)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-7 * size, name
    for name in ("markers.valid", "markers.mat"):
        np.testing.assert_array_equal(
            getattr(st.markers, name.split(".")[1]).numpy(),
            ref[f"state.{name}"])
    assert abs(diag["stokes_iterations"] - int(rdiag["stokes_iterations"])) <= 1
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == int(rdiag["markers_dropped"]) == 0
    np.testing.assert_allclose(float(diag["dt"]), float(rdiag["dt"]),
                               rtol=1e-6)
    # the power bounds carried to the next step (refreshed on step 0,
    # reused on step 1)
    np.testing.assert_allclose(st.mg_lam.numpy(), ref["state.mg_lam"],
                               rtol=1e-10)


def test_mixed_step_f32(reference):
    """The card's path on the CPU: f32 state, the AL-augmented mixed solve
    with the momentum dispatcher on (its plain version on CPU tensors)."""
    d0, out = reference
    ref, _ = out[0]
    grid, table, _ = build(CFG, dtype=torch.float32, device="cpu")
    st = state_from_numpy(d0, device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(
        CFG, solver=dataclasses.replace(SOLVER, use_pallas=True))
    st, diag = make_step(grid, cfg, table)(st)
    assert st.vx.dtype == torch.float32
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    vmax = float(np.max(np.abs(ref["state.vx"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.double().numpy()
                                  - ref[f"state.{name}"])))
        assert err <= 1e-4 * vmax, name


def test_surface_amplitude_matches_reference_script(reference):
    """The relaxation diagnostic of ``python -m
    pylamp_tpu_torch.models.validate_sticky_air`` against the reference's
    ``scripts/validate_sticky_air.py surface_amplitude`` on the same
    initial f64 state (the reference sums the rock fraction in f32, the
    port in the state's dtype: f32 rounding sets the bar)."""
    import importlib.util
    import os

    from pylamp_tpu_torch.models.validate_sticky_air import surface_amplitude

    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "validate_sticky_air.py")
    spec = importlib.util.spec_from_file_location("_validate_sticky_air",
                                                  path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    d0, _ = reference
    jgrid, _, jst = jax_build(jax_config(CFG), dtype=jnp.float64)
    ref_amp, ref_iface = script.surface_amplitude(jst, jgrid)
    grid, _, _ = build(CFG, dtype=torch.float64, device="cpu")
    amp, iface = surface_amplitude(state_from_numpy(d0, device="cpu"), grid)
    assert amp == pytest.approx(ref_amp, rel=1e-6)
    np.testing.assert_allclose(iface, ref_iface, rtol=0, atol=1e-7 * LY)
