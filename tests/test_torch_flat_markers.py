"""Port vs reference: the flat marker engine's functions on the CPU.

The same numpy markers (made from a seed) go through pylamp_tpu (JAX, f64)
and pylamp_tpu_torch on three 16x12 grids: uniform walls, periodic side
walls and a stretched grid (geometric x edges 3x, y edges refined in a
band 4x, a few markers exactly on interior edges):

- ``markers_to_grid`` on every lattice in every averaging mode, field and
  weight sum within 1e-12 relative; its sorted segment sum bit-identical
  on a rerun;
- ``grid_to_markers`` on every lattice and ``advect_rk4`` (walls with a
  moving no-slip lid, periodic, stretched) within 1e-12 relative;
- ``reseed_starved`` identical marker for marker (x, y, material and T)
  on fields with empty cells and tied counts, uniform, periodic and
  stretched;
- ``seed_markers`` without jitter equal to the reference's lattice;
- the flat engine's marker -> grid fields against the bucket engine's
  from the same FK 64^2 markers, port alone (the two sum each node in
  another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.core import grid as jgrid
from pylamp_tpu.markers import advect as jadvect
from pylamp_tpu.markers import interp as jinterp
from pylamp_tpu.markers import reseed as jreseed
from pylamp_tpu.markers import seed as jseed
from pylamp_tpu.markers.state import MarkerState as JMarkerState
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import (
    StaggeredGrid,
    geometric_edges,
    refined_band_edges,
)
from pylamp_tpu_torch.markers import advect, interp, reseed, seed
from pylamp_tpu_torch.markers.state import MarkerState

NX, NY, LX, LY = 16, 12, 1.3, 1.0
XE = geometric_edges(NX, LX, 3.0)
YE = refined_band_edges(NY, LY, 0.4 * LY, 0.3 * LY, 4.0)
KINDS = ("walls", "periodic", "stretched")
LOCS = ("corner", "center", "vx", "vy")
MODES = ("arithmetic", "geometric", "harmonic")
VBCS = {
    "walls": VelocityBCs(top="no_slip", vt_top=0.3, left="no_slip"),
    "periodic": VelocityBCs(left="periodic", right="periodic"),
    "stretched": VelocityBCs(bottom="no_slip"),
}


def _grids(kind):
    edges = dict(x_edges=XE, y_edges=YE) if kind == "stretched" else {}
    return (StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY, **edges),
            jgrid.StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY, **edges))


def _markers(kind, seed_=0, n=3000):
    """Random markers in the box (periodic: some just either side of the
    seam; stretched: 40 exactly on interior edges), positive values."""
    grid = _grids(kind)[0]
    rng = np.random.default_rng(seed_)
    x = rng.uniform(1e-9, LX - 1e-9, n)
    y = rng.uniform(1e-9, LY - 1e-9, n)
    if kind == "periodic":
        x[:50] = rng.uniform(0.0, 0.02, 50)
        x[50:100] = LX - rng.uniform(1e-9, 0.02, 50)
    if kind == "stretched":
        x[:20] = grid.x_corner[rng.integers(1, NX, 20)]
        y[20:40] = grid.y_corner[rng.integers(1, NY, 20)]
    vals = rng.uniform(0.5, 2.0, n)
    return x, y, vals


@pytest.fixture(scope="module")
def m2g_reference():
    """The reference's (field, wsum) for every grid x lattice x mode."""
    out = {}
    for kind in KINDS:
        _, jg = _grids(kind)
        x, y, v = _markers(kind)
        for loc in LOCS:
            for mode in MODES:
                f, w = jinterp.markers_to_grid(
                    jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), jg, loc,
                    mode, periodic_x=kind == "periodic")
                out[kind, loc, mode] = (np.asarray(f), np.asarray(w))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("kind", KINDS)
def test_markers_to_grid(m2g_reference, kind, loc, mode):
    grid, _ = _grids(kind)
    x, y, v = _markers(kind)
    f, w = interp.markers_to_grid(t(x), t(y), t(v), grid, loc, mode,
                                  periodic_x=kind == "periodic")
    rf, rw = m2g_reference[kind, loc, mode]
    assert f.shape == rf.shape and f.dtype == torch.float64
    assert rel(w, rw) <= 1e-12
    assert rel(f, rf) <= 1e-12
    again = interp.markers_to_grid(t(x), t(y), t(v), grid, loc, mode,
                                   periodic_x=kind == "periodic")
    assert torch.equal(f, again[0]) and torch.equal(w, again[1])


def test_markers_to_grid_f32_accumulates_in_f32():
    """An f32 field sums in f32, as the reference's scatter under x64."""
    grid, jg = _grids("walls")
    x, y, v = (a.astype(np.float32) for a in _markers("walls"))
    f, w = interp.markers_to_grid(t(x), t(y), t(v), grid, "corner")
    rf, rw = jinterp.markers_to_grid(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(v), jg, "corner")
    assert f.dtype == torch.float32 and np.asarray(rf).dtype == np.float32
    assert rel(f, rf) <= 1e-6 and rel(w, rw) <= 1e-6


def test_segment_sum_matches_index_add():
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 50, 700))
    vals = torch.from_numpy(rng.normal(size=(700, 2)))
    want = torch.zeros(57, 2, dtype=torch.float64).index_add_(0, idx, vals)
    got = interp.segment_sum(idx, vals, 57)
    assert torch.allclose(got, want, rtol=1e-13, atol=1e-13)
    assert torch.equal(got[50:], torch.zeros(7, 2, dtype=torch.float64))


@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("kind", KINDS)
def test_grid_to_markers(kind, loc):
    grid, jg = _grids(kind)
    x, y, _ = _markers(kind, seed_=1)
    field = np.random.default_rng(2).normal(size=grid.shape(loc))
    if kind == "periodic" and grid.shape(loc)[1] == NX + 1:
        field[:, -1] = field[:, 0]
    got = interp.grid_to_markers(t(field), t(x), t(y), grid, loc,
                                 periodic_x=kind == "periodic")
    ref = jinterp.grid_to_markers(jnp.asarray(field), jnp.asarray(x),
                                  jnp.asarray(y), jg, loc,
                                  periodic_x=kind == "periodic")
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_advect_rk4(kind):
    grid, jg = _grids(kind)
    x, y, _ = _markers(kind, seed_=3)
    rng = np.random.default_rng(5)
    vx = rng.normal(size=grid.shape_vx) * 0.05
    vy = rng.normal(size=grid.shape_vy) * 0.05
    if kind == "periodic":
        vx[:, -1] = vx[:, 0]
    dt = 0.4 * min(grid.dx_min, grid.dy_min) / 0.2
    bcs = VBCS[kind]
    got = advect.advect_rk4(t(x), t(y), t(vx), t(vy), t(dt), grid,
                            bcs)
    ref = jadvect.advect_rk4(jnp.asarray(x), jnp.asarray(y), jnp.asarray(vx),
                             jnp.asarray(vy), jnp.asarray(dt), jg,
                             jax_vbcs(bcs))
    for g, r, p in zip(got, ref, (x, y)):
        assert rel(g - t(p), np.asarray(r) - p) <= 1e-12
        assert float(torch.max(torch.abs(g - t(np.asarray(r))))) <= 1e-14
    if kind == "periodic":
        assert float(got[0].min()) >= 0.0 and float(got[0].max()) < LX


def _clustered(kind, seed_=0):
    """Markers crowded into the left part of the grid: the right columns
    are empty or starved, many cells tie in count; 3 materials."""
    grid = _grids(kind)[0]
    rng = np.random.default_rng(seed_)
    n = 6 * NX * NY
    x = np.concatenate([rng.uniform(0.0, 0.55 * LX, n - 200),
                        rng.uniform(0.55 * LX, LX, 200)])
    y = rng.uniform(1e-9, LY - 1e-9, n)
    if kind == "stretched":
        x[:10] = grid.x_corner[rng.integers(1, NX // 2, 10)]
    mat = rng.integers(0, 3, n).astype(np.int32)
    T = rng.uniform(0.0, 1.0, n)
    return x, y, mat, T


@pytest.mark.parametrize("max_moves", (256, 40))
@pytest.mark.parametrize("kind", KINDS)
def test_reseed_starved_marker_for_marker(kind, max_moves):
    grid, jg = _grids(kind)
    x, y, mat, T = _clustered(kind)
    T_grid = np.random.default_rng(7).uniform(0.0, 1.0, grid.shape_corner)
    periodic = kind == "periodic"
    got = reseed.reseed_starved(
        MarkerState(x=t(x), y=t(y), mat=t(mat), T=t(T)), t(T_grid), grid,
        n_materials=3, min_per_cell=2, max_moves=max_moves,
        periodic_x=periodic)
    ref = jreseed.reseed_starved(
        JMarkerState(x=jnp.asarray(x), y=jnp.asarray(y),
                     mat=jnp.asarray(mat), T=jnp.asarray(T)),
        jnp.asarray(T_grid), jg, n_materials=3, min_per_cell=2,
        max_moves=max_moves, periodic_x=periodic)
    moved = int(np.sum(np.asarray(ref.x) != x))
    assert moved > 0
    for f in ("x", "y", "mat", "T"):
        r = np.asarray(getattr(ref, f))
        g = getattr(got, f).numpy()
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)


def test_reseed_tied_counts_pick_reference_donors():
    """Every cell holds 3 markers but one is empty: the donors tie, so the
    move goes to the reference's (first-ranked) donor cell."""
    grid, jg = _grids("walls")
    cx, cy = np.meshgrid((np.arange(NX) + 0.5) * grid.dx,
                         (np.arange(NY) + 0.5) * grid.dy)
    x = np.repeat(cx.ravel(), 3) + np.tile([-0.2, 0.0, 0.2], NX * NY) * grid.dx
    y = np.repeat(cy.ravel(), 3)
    keep = np.ones(x.size, bool)
    keep[3 * 37: 3 * 38] = False  # cell 37 empty
    x, y = x[keep], y[keep]
    mat = (np.arange(x.size) % 2).astype(np.int32)
    T = np.linspace(0.0, 1.0, x.size)
    T_grid = np.zeros(grid.shape_corner)
    kw = dict(n_materials=2, min_per_cell=1, max_moves=8)
    got = reseed.reseed_starved(
        MarkerState(x=t(x), y=t(y), mat=t(mat), T=t(T)), t(T_grid), grid,
        **kw)
    ref = jreseed.reseed_starved(
        JMarkerState(x=jnp.asarray(x), y=jnp.asarray(y),
                     mat=jnp.asarray(mat), T=jnp.asarray(T)),
        jnp.asarray(T_grid), jg, **kw)
    changed = np.flatnonzero(np.asarray(ref.x) != x)
    assert changed.size == 1
    for f in ("x", "y", "mat", "T"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))


def test_seed_markers_lattice():
    grid, jg = _grids("walls")
    x, y = seed.seed_markers(grid, 3, device="cpu")
    rx, ry = jseed.seed_markers(jg, 3)
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    jx, jy = seed.seed_markers(grid, 3, rng=np.random.default_rng(0),
                               device="cpu")
    sub = LX / (3 * NX)
    assert float(torch.max(torch.abs(jx - x))) <= 0.25 * sub + 1e-15
    assert float(jx.min()) > 0 and float(jx.max()) < LX


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flat_matches_bucket_interp(dtype):
    """The two engines' marker -> grid fields from the same FK 64^2
    markers (``fk_bench_config``: geometric eta): eta on corners and
    centers, rho on the vy lattice, T on the corners, each within 64 ulp
    of the dtype pointwise.  They differ only in the order of each node's
    sum (the flat engine's sorted segments, the bucket engine's slots);
    the geometric mean's exp of a log sum takes the most.  ``-s`` prints
    the errors."""
    from pylamp_tpu_torch.markers.bucket import flatten
    from pylamp_tpu_torch.models.benchmarks import fk_bench_config
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step_phases

    dt = getattr(torch, dtype)
    cfg = fk_bench_config(64)
    grid, table, st_b = build(cfg, dtype=dt, device="cpu")
    x, y, mat, T, valid = flatten(st_b.markers)
    st_f = st_b.replace(markers=MarkerState(x=x[valid], y=y[valid],
                                            mat=mat[valid], T=T[valid]))
    fb = make_step_phases(grid, cfg, table).interp(st_b)
    ff = make_step_phases(grid, dataclasses.replace(cfg, marker_engine="flat"),
                          table).interp(st_f)
    T_f, w = interp.markers_to_grid(st_f.markers.x, st_f.markers.y,
                                    st_f.markers.T, grid, "corner",
                                    "arithmetic")
    T_f = torch.where(w > 0, T_f, st_f.T)
    eps = torch.finfo(dt).eps
    for name, a, b in (("eta_s", fb.eta_s, ff.eta_s),
                       ("eta_n", fb.eta_n, ff.eta_n),
                       ("rho_vy", fb.rho_vy, ff.rho_vy),
                       ("T", fb.T_old_g, T_f)):
        a, b = a.double(), b.double()
        ulps = float(torch.max(torch.abs(a - b) / torch.clamp(
            torch.abs(b), min=torch.finfo(dt).tiny))) / eps
        print(f"{dtype} {name}: max rel {rel(a, b):.3e} (of max|field|), "
              f"pointwise {ulps:.1f} ulp")
        assert ulps <= 64, name
