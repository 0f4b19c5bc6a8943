"""Port vs reference under periodic side walls: the whole step on the CPU.

- ``falling_block_periodic`` at 32^2: the JAX package builds the state in
  f64 and takes 3 steps; the port takes the same 3 steps from the bridged
  state (and builds the same initial state itself).  Velocities within
  1e-7 max|v|, marker positions within 1e-7 (the unit box), the same
  Krylov counts +-1, every step converged with nothing dropped;
- the card's path on the CPU: an f32 state through the kernel wrappers'
  plain versions and the mixed-precision solve, one step within 1e-4
  max|v| of the reference's f64 step;
- exact discrete translation invariance of the port's step at 16^2
  (tests/test_periodic_e2e.py), on the port alone: rolling the material
  pattern by k cells rolls every output by k cells;
- the seam-straddling block sinks with its fastest flow at the seam;
- the explicit-halo mesh under periodic walls: the first step with
  ``explicit_halo`` on the in-process 4x2 mesh, from the bridged state,
  within 1e-8 max|vy| of the reference's step, with the same Krylov count
  +-2.

The reference compiles its f64 step once per module (a fixture).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict

from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.step import make_step as jax_make_step
from pylamp_tpu_torch.bridge import state_from_numpy
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.models.benchmarks import falling_block_periodic
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.state import zero_state
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.parallel.mesh import make_mesh
from pylamp_tpu_torch.physics.materials import MaterialTable

N = 32
STEPS = 3
CFG = falling_block_periodic(nx=N, ny=N)


@pytest.fixture(scope="module")
def reference():
    import jax.numpy as jnp

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


def test_build_matches_reference(reference):
    """The periodic initial interpolation: the port's own build gives the
    reference's markers and grid mirrors."""
    d0, _ = reference
    _, _, st = build(CFG, dtype=torch.float64, device="cpu")
    got = state_from_numpy(d0, device="cpu")
    for f in ("x", "y", "mat", "T", "valid"):
        assert torch.equal(getattr(st.markers, f), getattr(got.markers, f)), f
    for f in ("eta_s", "eta_n", "T"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   getattr(got, f).numpy(), rtol=1e-13)
    assert torch.equal(st.eta_s[:, 0], st.eta_s[:, -1])


@pytest.mark.parametrize("k", range(STEPS))
def test_step_f64_matches_reference(reference, port_run, k):
    ref, rdiag = reference[1][k]
    st, diag = port_run[k]
    vmax = float(np.max(np.abs(ref["state.vy"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-7 * vmax, name
    for name, got in (("markers.x", st.markers.x),
                      ("markers.y", st.markers.y)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-7, name
    for name in ("markers.valid", "markers.mat"):
        np.testing.assert_array_equal(
            getattr(st.markers, name.split(".")[1]).numpy(),
            ref[f"state.{name}"])
    assert abs(diag["stokes_iterations"] - int(rdiag["stokes_iterations"])) <= 1
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == int(rdiag["markers_dropped"]) == 0
    assert int(diag["marker_count"]) == int(rdiag["marker_count"])
    np.testing.assert_allclose(float(diag["dt"]), float(rdiag["dt"]),
                               rtol=1e-6)
    x = st.markers.x[st.markers.valid]
    assert float(x.min()) >= 0.0 and float(x.max()) < CFG.lx
    assert torch.equal(st.vx[:, 0], st.vx[:, -1])


def test_mesh_step_matches_reference(reference):
    """The periodic explicit-halo mesh step (ring exchanges, seam rows;
    the markers on the global tensors) against the reference's
    single-device step 1: velocities within 1e-8 max|vy|, Krylov +-2."""
    d0, out = reference
    ref, rdiag = out[0]
    cfg = dataclasses.replace(CFG, solver=dataclasses.replace(
        CFG.solver, explicit_halo=True))
    grid, table, _ = build(cfg, dtype=torch.float64, device="cpu")
    st, diag = make_step(grid, cfg, table, mesh=make_mesh(8))(
        state_from_numpy(d0, device="cpu"))
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    vmax = float(np.max(np.abs(ref["state.vy"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.numpy() - ref[f"state.{name}"])))
        assert err <= 1e-8 * vmax, name
    assert abs(diag["stokes_iterations"] - int(rdiag["stokes_iterations"])) <= 2


def test_block_sinks_at_the_seam(port_run):
    st, _ = port_run[-1]
    peak_col = int(torch.argmax(st.vy)) % N
    assert peak_col <= 3 or peak_col >= N - 4, peak_col


def test_mixed_step_f32(reference):
    """The card's path on the CPU: f32 state through the kernel wrappers'
    plain versions and the mixed-precision solve."""
    d0, out = reference
    ref, _ = out[0]
    grid, table, _ = build(CFG, dtype=torch.float32, device="cpu")
    st = state_from_numpy(d0, device="cpu", dtype=torch.float32)
    st, diag = make_step(grid, CFG, table)(st)
    assert st.vx.dtype == torch.float32
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    vmax = float(np.max(np.abs(ref["state.vy"])))
    for name, got in (("vx", st.vx), ("vy", st.vy)):
        err = float(np.max(np.abs(got.double().numpy()
                                  - ref[f"state.{name}"])))
        assert err <= 1e-4 * vmax, name
    assert torch.equal(st.vx[:, 0], st.vx[:, -1])


def _cell_markers(grid, pattern, per_cell=4, K=8):
    """Slot s of every cell at the same sub-cell offset: an integer-cell
    roll of the material pattern is an exact translation of the markers."""
    ny, nx = grid.ny, grid.nx
    offs = [(0.25, 0.25), (0.75, 0.25), (0.25, 0.75), (0.75, 0.75)]
    x, y = np.zeros((ny, nx, K)), np.zeros((ny, nx, K))
    valid = np.zeros((ny, nx, K), bool)
    for s, (ox, oy) in enumerate(offs[:per_cell]):
        x[:, :, s] = (np.arange(nx)[None, :] + ox) * grid.dx
        y[:, :, s] = (np.arange(ny)[:, None] + oy) * grid.dy
        valid[:, :, s] = True
    mat = np.where(valid, pattern[:, :, None], 0).astype(np.int32)
    return BucketedMarkers(x=torch.tensor(x), y=torch.tensor(y),
                           mat=torch.tensor(mat),
                           T=torch.zeros((ny, nx, K), dtype=torch.float64),
                           valid=torch.tensor(valid))


def test_step_translation_invariance():
    cfg = falling_block_periodic(nx=16, ny=16, max_steps=2)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, stokes_tol=1e-10, stokes_maxiter=600))
    grid = StaggeredGrid(nx=cfg.nx, ny=cfg.ny, lx=cfg.lx, ly=cfg.ly)
    step = make_step(grid, cfg, MaterialTable(cfg.physics.materials))
    pat = np.zeros((grid.ny, grid.nx), np.int32)  # a block across the seam
    pat[6:10, :2] = 1
    pat[6:10, -2:] = 1
    k = 5

    def run(pattern):
        _, _, st0 = build(cfg, dtype=torch.float64, device="cpu")
        state = zero_state(grid, _cell_markers(grid, pattern),
                           torch.float64, n_mg_levels=st0.mg_lam.shape[0])
        for _ in range(2):
            state, diag = step(state)
        assert diag["stokes_converged"]
        assert int(diag["markers_dropped"]) == 0
        return state

    s0, s1 = run(pat), run(np.roll(pat, k, axis=1))
    scale = float(torch.max(torch.abs(s0.vy)))
    assert scale > 0

    def rolled(a):
        return np.roll(a.numpy(), k, axis=1)

    np.testing.assert_allclose(s1.vy.numpy(), rolled(s0.vy),
                               atol=1e-8 * scale)
    np.testing.assert_allclose(s1.vx[:, :-1].numpy(), rolled(s0.vx[:, :-1]),
                               atol=1e-8 * scale)
    np.testing.assert_allclose(s1.p.numpy(), rolled(s0.p),
                               atol=1e-7 * float(torch.max(torch.abs(s0.p))))
    x0 = np.sort(s0.markers.x[s0.markers.valid].numpy())
    x1 = np.sort(s1.markers.x[s1.markers.valid].numpy())
    np.testing.assert_allclose(x1, np.sort((x0 + k * grid.dx) % grid.lx),
                               atol=1e-10 * grid.lx)
