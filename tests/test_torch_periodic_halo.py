"""Port vs reference: the explicit-halo mesh under periodic side walls.

The port's in-process 4x2 mesh (``make_mesh(8)``) against the JAX package,
inputs numpy from a seed:

- ``stokes_operator_halo`` (the full and the momentum-only form, free and
  no slip, 8x16 blocks) and ``energy_operator_halo`` in f64 against the
  reference's single-device periodic ``stokes_operator`` /
  ``energy_operator``: 1e-12 relative; the momentum-only form equals the
  full form's momentum rows at p = 0 exactly;
- one case each against the reference's own explicit-halo operators
  (jitted shard_map on its 8-virtual-device mesh; the Stokes one on 4x32
  blocks): 1e-12 relative;
- the periodic falling block at 32^2, one f64 step with ``explicit_halo``
  on the mesh against the port's single-device step: velocities, T and
  marker positions within 1e-8 max(|vy|, 1), the bar of the reference's
  dryrun (d), and the same Krylov count (the mesh step against the JAX step is
  tests/test_torch_periodic_step.py's, which compiles that step once);
- ``python -m pylamp_tpu_torch.parallel.dryrun`` sub-check (d) on the CPU;
- the explicit-halo marker engine's wrap-around exchange (port-only: the
  reference has no such path and keeps the markers on the global
  tensors): the velocity windows equal windows cut from kernel 3p's
  wrapped padded lattices, and every transfer, the advection, the
  rebucket and the reseeding on the ring-exchanged blocks equal the
  global engine's periodic forms bit for bit, markers across the seam
  included (on the 4x2 mesh, a ring of two, and on 2x4, a ring of four);
- the sharded layout: the in-process periodic falling-block step on the
  sharded state (4x2 and 2x4) holds the global-layout mesh step at 1e-12
  relative, with the vx seam columns equal, valid slots and materials
  equal, the same Krylov count and no leaf beyond its block.

The JAX references are computed once per module (fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_tbcs, jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.ops.energy import energy_operator as j_energy_operator
from pylamp_tpu.ops.stokes import stokes_operator as j_stokes_operator
from pylamp_tpu.parallel.halo_ops import (
    energy_operator_halo as j_energy_operator_halo,
)
from pylamp_tpu.parallel.halo_ops import (
    stokes_operator_halo as j_stokes_operator_halo,
)
from pylamp_tpu.parallel.mesh import make_mesh as j_make_mesh
from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.models.benchmarks import falling_block_periodic
from pylamp_tpu_torch.models.config import SolverConfig
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.parallel.halo_markers import velocity_windows
from pylamp_tpu_torch.parallel.halo_ops import (
    energy_operator_halo,
    halo_eligible,
    stokes_operator_halo,
)
from pylamp_tpu_torch.parallel.mesh import Mesh, make_mesh

MESH = make_mesh(8)
VBCS = {slip: VelocityBCs(top=slip, bottom=slip, left="periodic",
                          right="periodic")
        for slip in ("free_slip", "no_slip")}
TBCS = {top: ThermalBCs(top=ThermalBC(top, 0.0),
                        bottom=ThermalBC("dirichlet", 1.0),
                        left=ThermalBC("periodic", 0.0),
                        right=ThermalBC("periodic", 0.0))
        for top in ("dirichlet", "neumann")}
SHAPE = (32, 32, 1.5)  # 8x16 blocks on the 4x2 mesh
HALO_SHAPE = (64, 16, 1.0)  # 4x32 blocks
KCONT, KBND = 2.3, 4.1
# dryrun (d): the falling block with the reference's f64 dryrun solver
STEP_CFG = dataclasses.replace(
    falling_block_periodic(nx=32, ny=32, max_steps=1),
    solver=SolverConfig(precision="f64", stokes_tol=1e-10,
                        stokes_restart=40, stokes_maxiter=400, mg_levels=2,
                        explicit_halo=True))


def _stokes_args(grid, seed):
    """Random fields, equal in the duplicated seam columns (vx, eta_s)."""
    rng = np.random.default_rng(seed)
    es = np.exp(rng.normal(size=grid.shape_corner))
    es[:, -1] = es[:, 0]
    vx = rng.normal(size=grid.shape_vx)
    vx[:, -1] = vx[:, 0]
    return (vx, rng.normal(size=grid.shape_vy),
            rng.normal(size=grid.shape_center), es,
            np.exp(rng.normal(size=grid.shape_center)))


def _energy_args(grid, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=grid.shape_corner),
            rng.uniform(0.5, 3.0, size=grid.shape_corner),
            rng.uniform(5.0, 50.0, size=grid.shape_corner))


def _grids(nx, ny, ly):
    return (StaggeredGrid(nx=nx, ny=ny, lx=1.0, ly=ly),
            JGrid(nx=nx, ny=ny, lx=1.0, ly=ly))


@pytest.fixture(scope="module")
def operator_refs():
    """The reference's single-device periodic operators on every case, and
    its explicit-halo operators (jitted) on one case each."""
    _, jg = _grids(*SHAPE)
    _, jge = _grids(32, 16, 0.5)

    def single(sargs, eargs):
        out = {f"stokes_{slip}": j_stokes_operator(
            *sargs, jg, jax_vbcs(bcs), KCONT, KBND)
            for slip, bcs in VBCS.items()}
        for top, tbcs in TBCS.items():
            for k_avg in ("arithmetic", "harmonic"):
                out[f"energy_{top}_{k_avg}"] = j_energy_operator(
                    *eargs, jge, jax_tbcs(tbcs), kbnd=17.0, k_avg=k_avg)
        return out

    refs = jax.jit(single)(
        tuple(jnp.asarray(a) for a in _stokes_args(jg, 0)),
        tuple(jnp.asarray(a) for a in _energy_args(jge, 7)))
    jm = j_make_mesh(8)
    _, jg = _grids(*HALO_SHAPE)
    args = _stokes_args(jg, 1)
    refs["stokes_halo"] = jax.jit(lambda *a: j_stokes_operator_halo(
        *a, jg, jax_vbcs(VBCS["no_slip"]), jm, KCONT, KBND))(
        *(jnp.asarray(a) for a in args))
    _, jg = _grids(32, 16, 0.5)
    args = _energy_args(jg, 7)
    refs["energy_halo"] = jax.jit(lambda *a: j_energy_operator_halo(
        *a, jg, jax_tbcs(TBCS["dirichlet"]), jm, kbnd=17.0,
        k_avg="harmonic"))(*(jnp.asarray(a) for a in args))
    return refs


@pytest.mark.parametrize("slip", list(VBCS))
def test_stokes_operator_halo_periodic(operator_refs, slip):
    """f64, free and no slip: 1e-12 against the reference's single-device
    periodic operator; the momentum-only form equals the full form's
    momentum rows at p = 0."""
    grid, _ = _grids(*SHAPE)
    assert halo_eligible(grid, MESH)
    bcs = VBCS[slip]
    args = [t(a) for a in _stokes_args(grid, 0)]
    got = stokes_operator_halo(*args, grid, bcs, MESH, KCONT, KBND)
    for g, r in zip(got, operator_refs[f"stokes_{slip}"]):
        assert rel(g, r) <= 1e-12
    mom = stokes_operator_halo(args[0], args[1], None, *args[3:], grid, bcs,
                               MESH, KCONT, KBND)
    assert mom[2] is None
    at_zero = stokes_operator_halo(args[0], args[1], torch.zeros_like(args[2]),
                                   *args[3:], grid, bcs, MESH, KCONT, KBND)
    for z, m in zip(at_zero[:2], mom[:2]):
        assert torch.equal(z, m)


@pytest.mark.parametrize("k_avg", ["arithmetic", "harmonic"])
@pytest.mark.parametrize("top", list(TBCS))
def test_energy_operator_halo_periodic(operator_refs, top, k_avg):
    """f64, Dirichlet and Neumann top, both face averages: 1e-12 against
    the reference's single-device periodic operator (the seam column, the
    bottom row and the corner node included)."""
    grid, _ = _grids(32, 16, 0.5)
    got = energy_operator_halo(*(t(a) for a in _energy_args(grid, 7)), grid,
                               TBCS[top], MESH, kbnd=17.0, k_avg=k_avg)
    assert rel(got, operator_refs[f"energy_{top}_{k_avg}"]) <= 1e-12


def test_periodic_operators_vs_reference_halo(operator_refs):
    """The reference's own explicit-halo operators (jitted shard_map on
    the 8-device mesh): no slip on 4x32 blocks, harmonic faces: 1e-12."""
    grid, _ = _grids(*HALO_SHAPE)
    got = stokes_operator_halo(*(t(a) for a in _stokes_args(grid, 1)), grid,
                               VBCS["no_slip"], MESH, KCONT, KBND)
    for g, r in zip(got, operator_refs["stokes_halo"]):
        assert rel(g, r) <= 1e-12
    grid, _ = _grids(32, 16, 0.5)
    got = energy_operator_halo(*(t(a) for a in _energy_args(grid, 7)), grid,
                               TBCS["dirichlet"], MESH, kbnd=17.0,
                               k_avg="harmonic")
    assert rel(got, operator_refs["energy_halo"]) <= 1e-12


def test_periodic_mesh_step():
    """The 32^2 periodic mesh step in f64: velocities, T and marker
    positions within 1e-8 max(|vy|, 1) of the port's single-device step
    from the same built state, converged with nothing dropped, the same
    Krylov count, the seam columns of vx equal."""
    grid, table, st0 = build(STEP_CFG, dtype=torch.float64, device="cpu")
    st, diag = make_step(grid, STEP_CFG, table, mesh=MESH)(st0)
    one, one_diag = make_step(grid, STEP_CFG, table)(st0)
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    bar = 1e-8 * max(float(torch.max(torch.abs(one.vy))), 1.0)
    for a, b in ((st.vx, one.vx), (st.vy, one.vy), (st.T, one.T),
                 (st.markers.x, one.markers.x),
                 (st.markers.y, one.markers.y)):
        assert float(torch.max(torch.abs(a - b))) <= bar
    assert diag["stokes_iterations"] == one_diag["stokes_iterations"]
    assert torch.equal(st.vx[:, 0], st.vx[:, -1])


def test_dryrun_periodic_cpu(capsys):
    """Sub-check (d) of the dry run passes on the CPU."""
    from pylamp_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(8, "cpu", checks="d")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK on cpu" in out and "periodic_halo@1e-8" in out


MESHES = {"4x2": MESH, "2x4": Mesh(2, 4)}


@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_periodic_velocity_windows(mesh, reach):
    """The wrap-around exchange's velocity windows (free and no slip) equal
    windows cut from the globally wrapped padded lattices, kernel 3p's
    planes (``advect.wrapped_planes``)."""
    from pylamp_tpu_torch.markers.bucket import padded_velocities
    from pylamp_tpu_torch.markers.kernels.advect import PADW, wrapped_planes
    from pylamp_tpu_torch.markers.kernels.advect_block import cut_windows

    m = MESHES[mesh]
    grid = StaggeredGrid(nx=32, ny=32, lx=1.0, ly=1.0)
    by, bx = grid.ny // m.my, grid.nx // m.mx
    rng = np.random.default_rng(31 + reach)
    vx = t(rng.normal(size=grid.shape_vx))
    vx[:, -1] = vx[:, 0]
    vy = t(rng.normal(size=grid.shape_vy))
    for bcs in VBCS.values():
        got = velocity_windows(vx, vy, grid, bcs, m, reach)
        want = cut_windows(*wrapped_planes(*padded_velocities(vx, vy, bcs),
                                           grid.nx),
                           m.bases(by, bx), by, bx, reach, PADW)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.fixture(scope="module")
def periodic_markers():
    """The periodic falling block's f64 markers at 32^2 and seeded
    velocities (vx seam-equal) and corner temperatures."""
    cfg = falling_block_periodic(nx=32, ny=32)
    grid, table, st = build(cfg, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    vx = t(rng.uniform(-1, 1, grid.shape_vx))
    vx[:, -1] = vx[:, 0]
    vy = t(rng.uniform(-1, 1, grid.shape_vy))
    T = t(rng.uniform(0, 1, grid.shape_corner))
    T[:, -1] = T[:, 0]
    return cfg, grid, table, st.markers, vx, vy, T


def _same_markers(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("x", "y", "T", "mat", "valid"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_periodic_marker_halo_engine(periodic_markers, mesh):
    """The wrap-around marker engine on the ring-exchanged blocks (the
    plain versions of kernels 10p-12p) against the global engine's periodic
    forms, bit for bit: the fused transfer (energy streams; also of the
    advected markers, before the rebucket, up to a cell out of their
    cells), the one-stream transfer on every lattice, the RK4 advection at
    reach 1 and 2 (markers cross the seam), the sampling, the rebucket and
    the reseeding."""
    from pylamp_tpu_torch.markers import bucket
    from pylamp_tpu_torch.markers.kernels.m2g import m2g_fused_plain
    from pylamp_tpu_torch.parallel import halo_markers as hm

    m = MESHES[mesh]
    cfg, grid, table, bm, vx, vy, T = periodic_markers
    bcs = cfg.physics.velocity_bcs
    got = hm.m2g_fused_halo(bm, grid, table, cfg.physics, m, True,
                            kernel=False, periodic_x=True)
    want = m2g_fused_plain(bm, grid, table, cfg.physics, with_energy=True,
                           periodic_x=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for loc in ("corner", "vx", "vy", "center"):
        got = hm.m2g_halo(bm, bm.T, grid, loc, "arithmetic", m, True)
        want = bucket.bucket_markers_to_grid(bm, bm.T, grid, loc,
                                             periodic_x=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), loc
    for reach in (1, 2):
        dt = 0.45 * reach * grid.dx
        moved = hm.advect_rk4_halo(bm, vx, vy, dt, grid, bcs, m, reach,
                                   kernel=False)
        want = bucket.bucket_advect_rk4(bm, vx, vy, dt, grid, bcs, reach)
        assert _same_markers(moved, want)
        assert int(torch.sum(torch.abs(want.x - bm.x) > 0.5)) > 0  # seam
        # markers up to a cell out of their cells reach the seam column
        # from both sides: its strip is column 0's sums
        got = hm.m2g_fused_halo(moved, grid, table, cfg.physics, m, True,
                                kernel=False, periodic_x=True)
        ref = m2g_fused_plain(want, grid, table, cfg.physics,
                              with_energy=True, periodic_x=True)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (reach, k)
        assert torch.equal(
            hm.g2m_halo(T, want.x, want.y, bm.valid, grid, "corner", m,
                        periodic_x=True),
            bucket.bucket_grid_to_markers(T, want.x, want.y, bm.valid, grid,
                                          "corner", periodic_x=True))
        new, dropped = hm.rebucket_halo(want, grid, m, kernel=False,
                                        periodic_x=True)
        ref, ref_dropped = bucket.rebucket(want, grid, periodic_x=True)
        assert _same_markers(new, ref)
        assert int(dropped) == int(ref_dropped)
        assert _same_markers(
            hm.reseed_halo(new, T, grid, 12, 2, m, periodic_x=True),
            bucket.bucket_reseed(ref, T, grid, 12, 2, periodic_x=True))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_periodic_step_matches_global(mesh):
    """The periodic falling block at 32^2 in f64 (dryrun (d)'s solver) on
    the in-process mesh: the sharded layout's step against the global
    layout's, 1e-12 relative; the vx seam columns equal, valid slots and
    materials equal, the same Krylov count, no leaf beyond its block."""
    from pylamp_tpu_torch.bridge import oversized_leaves
    from pylamp_tpu_torch.parallel.mesh import shard_state, unshard_state

    m = MESHES[mesh]
    grid, table, st0 = build(STEP_CFG, dtype=torch.float64, device="cpu")
    step = make_step(grid, STEP_CFG, table, mesh=m)
    want, wdiag = step(st0)
    sh, diag = step(shard_state(st0, m))
    assert oversized_leaves(sh, grid, m) == {}
    got = unshard_state(sh, m)
    for f in ("vx", "vy", "p", "eta_s", "eta_n"):
        a, b = getattr(got, f), getattr(want, f)
        assert float(torch.max(torch.abs(a - b))) <= 1e-12 * float(
            torch.max(torch.abs(b))), f
    for f in ("x", "y"):
        a, b = getattr(got.markers, f), getattr(want.markers, f)
        assert float(torch.max(torch.abs(a - b))) <= 1e-12, f
    for f in ("valid", "mat"):
        assert torch.equal(getattr(got.markers, f), getattr(want.markers, f))
    assert torch.equal(got.vx[:, 0], got.vx[:, -1])
    assert diag["stokes_iterations"] == wdiag["stokes_iterations"]
    assert diag["stokes_converged"] and int(diag["markers_dropped"]) == 0
