"""Port vs reference: the in-process mesh engine and the explicit-halo
operators on the CPU.

The JAX package runs its ``shard_map`` bodies on the 8-virtual-device mesh
of tests/conftest.py (4x2, ``make_mesh(8)``); the port runs the same
bodies on its in-process 4x2 mesh.  Inputs are numpy from a seed:

- the exchange primitives (``from_prev`` / ``from_next`` with and without
  the ring wrap, ``psum``, the one-ring extension) and the split /
  reassembly by spec, exactly (they move data, no arithmetic);
- ``diffusion_apply_sharded`` (parallel/halo.py) to 1e-12 relative;
- ``stokes_operator_halo`` and ``energy_operator_halo`` in f64 to 1e-12
  relative against the reference's operators for every BC combination of
  tests/test_halo_ops.py (and against its explicit-halo operators, jitted,
  on one mixed-wall case each: its eager shard_map dispatch would take
  minutes), and the momentum-only form against the full one at p = 0
  exactly;
- the MG preconditioner with every apply on the explicit-halo path (and
  with coarse_replicate) against the single-device one, to 1e-10 relative
  (the reference's own bar for its halo V-cycle against GSPMD).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_tbcs, jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.ops.energy import energy_operator as j_energy_operator
from pylamp_tpu.ops.stokes import stokes_operator as j_stokes_operator
from pylamp_tpu.parallel.halo import (
    diffusion_apply_sharded as j_diffusion_apply_sharded,
)
from pylamp_tpu.parallel.halo import exchange_halo_2d as j_exchange_halo_2d
from pylamp_tpu.parallel.halo_ops import _from_next as j_from_next
from pylamp_tpu.parallel.halo_ops import _from_prev as j_from_prev
from pylamp_tpu.parallel.halo_ops import (
    energy_operator_halo as j_energy_operator_halo,
)
from pylamp_tpu.parallel.halo_ops import (
    stokes_operator_halo as j_stokes_operator_halo,
)
from pylamp_tpu.parallel.mesh import make_mesh as j_make_mesh
from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.parallel.halo import diffusion_apply_sharded
from pylamp_tpu_torch.parallel.halo_ops import (
    energy_operator_halo,
    halo_eligible,
    stokes_operator_halo,
)
from pylamp_tpu_torch.parallel.mesh import P, make_mesh

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP


@pytest.fixture(scope="module")
def meshes():
    jm, tm = j_make_mesh(8), make_mesh(8)
    assert (jm.shape["y"], jm.shape["x"]) == (tm.my, tm.mx) == (4, 2)
    return jm, tm


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.normal(size=shape)
    return rng.uniform(lo, hi, size=shape)


def test_split_gather_roundtrip(meshes):
    """Every spec splits and reassembles exactly, and P("y", "x") blocks
    are the reference's: block (i, j) is rows i*by.., cols j*bx.."""
    _, mesh = meshes
    a = torch.from_numpy(_rand((16, 12, 3), 0))
    b = mesh.split(a, P("y", "x", None))
    assert b.shape == (4, 2, 4, 6, 3)
    assert torch.equal(b[2, 1], a[8:12, 6:12])
    assert torch.equal(mesh.gather(b, P("y", "x", None)), a)
    col = a[:, :1, 0]
    s = mesh.split(col, P("y", None))
    assert s.shape == (4, 2, 4, 1) and torch.equal(s[1, 0], s[1, 1])
    assert torch.equal(mesh.gather(s, P("y", None)), col)
    row = a[:1, :, 0]
    s = mesh.split(row, P(None, "x"))
    assert s.shape == (4, 2, 1, 6) and torch.equal(s[0, 1], s[3, 1])
    assert torch.equal(mesh.gather(s, P(None, "x")), row)


@pytest.mark.parametrize("ring", [False, True])
def test_exchange_primitives_match_ppermute(meshes, ring):
    """from_prev / from_next along both axes (edge zeros or the ring wrap)
    and psum over one and both axes, against lax.ppermute / lax.psum in
    the reference's shard_map, on a (ny, nx) array with by != bx: the
    exchanges exactly, the sums to 1e-15 (summation order)."""
    jm, tm = meshes
    a = _rand((16, 12), 1)
    spec = JP("y", "x")

    def jbody(b):
        outs = []
        for axis, n in (("y", 4), ("x", 2)):
            outs.append(j_from_prev(b, axis, n, ring=ring))
            outs.append(j_from_next(b, axis, n, ring=ring))
        outs.append(jax.lax.psum(b, "x"))
        outs.append(jax.lax.psum(b, ("y", "x")))
        return tuple(outs)

    ref = shard_map(jbody, mesh=jm, in_specs=(spec,),
                    out_specs=(spec,) * 6)(jnp.asarray(a))
    b = tm.split(torch.from_numpy(a), P("y", "x"))
    got = []
    for axis in ("y", "x"):
        got.append(tm.from_prev(b, axis, ring=ring))
        got.append(tm.from_next(b, axis, ring=ring))
    got += [tm.psum(b, "x"), tm.psum(b, ("y", "x"))]
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(tm.gather(g, P("y", "x")).numpy(),
                                      np.asarray(r))
    for g, r in zip(got[4:], ref[4:]):
        assert rel(tm.gather(g, P("y", "x")), r) <= 1e-15


def test_exchange_halo_2d_and_diffusion(meshes):
    """The one-ring extension (stacked per shard) equals the reference's
    exchange_halo_2d, and the sharded diffusion apply its result."""
    jm, tm = meshes
    T, kx, ky = _rand((16, 12), 2), _rand((16, 12), 3, 0.5, 2.0), \
        _rand((16, 12), 4, 0.5, 2.0)
    spec = JP("y", "x")
    ref = shard_map(lambda b: j_exchange_halo_2d(b, jm), mesh=jm,
                    in_specs=(spec,), out_specs=spec)(jnp.asarray(T))
    got = tm.gather(tm.ext1(tm.split(torch.from_numpy(T), P("y", "x"))),
                    P("y", "x"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jax.jit(lambda *a: j_diffusion_apply_sharded(
        *a, 0.7, 0.1, 0.2, jm))(jnp.asarray(T), jnp.asarray(kx),
                                jnp.asarray(ky))
    got = diffusion_apply_sharded(t(T), t(kx), t(ky), 0.7, 0.1, 0.2, tm)
    assert rel(got, ref) <= 1e-12


VBC_CASES = [
    VelocityBCs(),
    VelocityBCs(top="no_slip", bottom="no_slip", left="no_slip",
                right="no_slip"),
    VelocityBCs(top="free_slip", bottom="no_slip", left="no_slip",
                right="free_slip"),
    VelocityBCs(top="no_slip", vt_top=1.5, bottom="free_slip"),
]


@pytest.mark.parametrize("nx,ny,ly", [(32, 32, 1.5), (64, 16, 1.0)])
@pytest.mark.parametrize("bcs", VBC_CASES,
                         ids=["free", "noslip", "mixed", "moving"])
def test_stokes_operator_halo(meshes, bcs, nx, ny, ly):
    """f64, every BC case, square and 4x32 blocks, against the reference's
    operator (1e-12); the momentum-only form (p=None) equals the full
    form's momentum rows at p = 0."""
    _, tm = meshes
    jgrid, grid = JGrid(nx=nx, ny=ny, lx=1.0, ly=ly), StaggeredGrid(
        nx=nx, ny=ny, lx=1.0, ly=ly)
    assert halo_eligible(grid, tm)
    args = _stokes_args(grid)
    kcont, kbnd = 2.3, 4.1
    ref = j_stokes_operator(*(jnp.asarray(a) for a in args), jgrid,
                            jax_vbcs(bcs), kcont, kbnd)
    got = stokes_operator_halo(*(t(a) for a in args), grid, bcs, tm, kcont,
                               kbnd)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12
    mom = stokes_operator_halo(t(args[0]), t(args[1]), None,
                               *(t(a) for a in args[3:]), grid, bcs, tm,
                               kcont, kbnd)
    assert mom[2] is None
    at_zero = stokes_operator_halo(
        t(args[0]), t(args[1]), torch.zeros(grid.shape_center,
                                            dtype=torch.float64),
        *(t(a) for a in args[3:]), grid, bcs, tm, kcont, kbnd)
    for z, m in zip(at_zero[:2], mom[:2]):
        assert torch.equal(z, m)


def _stokes_args(grid):
    return (_rand(grid.shape_vx, 0), _rand(grid.shape_vy, 1),
            _rand(grid.shape_center, 2), _rand(grid.shape_corner, 3, 0.5, 3),
            _rand(grid.shape_center, 4, 0.5, 3))


def test_stokes_operator_halo_vs_reference_halo(meshes):
    """The reference's own explicit-halo operator (jitted shard_map on the
    8-device mesh), mixed walls and 4x32 blocks: 1e-12."""
    jm, tm = meshes
    jgrid, grid = JGrid(nx=64, ny=16, lx=2.0, ly=1.0), StaggeredGrid(
        nx=64, ny=16, lx=2.0, ly=1.0)
    bcs = VBC_CASES[2]
    args = _stokes_args(grid)
    ref = jax.jit(lambda *a: j_stokes_operator_halo(
        *a, jgrid, jax_vbcs(bcs), jm, 0.7, 3.0))(
        *(jnp.asarray(a) for a in args))
    got = stokes_operator_halo(*(t(a) for a in args), grid, bcs, tm, 0.7, 3.0)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-12


TBC_CASES = [
    ThermalBCs(),
    ThermalBCs(top=ThermalBC("dirichlet", 0.0),
               bottom=ThermalBC("dirichlet", 1.0),
               left=ThermalBC("dirichlet", 0.3),
               right=ThermalBC("dirichlet", 0.7)),
    ThermalBCs(top=ThermalBC("neumann", 0.0), bottom=ThermalBC("neumann", 0.0),
               left=ThermalBC("neumann", 0.0),
               right=ThermalBC("neumann", 0.0)),
    ThermalBCs(top=ThermalBC("dirichlet", 0.0),
               bottom=ThermalBC("neumann", 0.0),
               left=ThermalBC("neumann", 0.0),
               right=ThermalBC("dirichlet", 1.0)),
]


def _energy_args(grid):
    return (_rand(grid.shape_corner, 20), _rand(grid.shape_corner, 21, 0.5, 3),
            _rand(grid.shape_corner, 22, 5.0, 50.0))


@pytest.mark.parametrize("k_avg", ["arithmetic", "harmonic"])
@pytest.mark.parametrize("tbcs", TBC_CASES,
                         ids=["default", "all_dir", "all_neu", "mixed"])
def test_energy_operator_halo(meshes, tbcs, k_avg):
    """f64, every BC case and both face averages against the reference's
    operator: 1e-12."""
    _, tm = meshes
    jgrid, grid = JGrid(nx=32, ny=16, lx=1.0, ly=0.5), StaggeredGrid(
        nx=32, ny=16, lx=1.0, ly=0.5)
    T, k, rc = _energy_args(grid)
    ref = j_energy_operator(jnp.asarray(T), jnp.asarray(k), jnp.asarray(rc),
                            jgrid, jax_tbcs(tbcs), kbnd=17.0, k_avg=k_avg)
    got = energy_operator_halo(t(T), t(k), t(rc), grid, tbcs, tm, kbnd=17.0,
                               k_avg=k_avg)
    assert rel(got, ref) <= 1e-12


def test_energy_operator_halo_vs_reference_halo(meshes):
    """The reference's own explicit-halo energy operator (jitted), mixed
    walls, harmonic faces: 1e-12."""
    jm, tm = meshes
    jgrid, grid = JGrid(nx=32, ny=16, lx=1.0, ly=0.5), StaggeredGrid(
        nx=32, ny=16, lx=1.0, ly=0.5)
    tbcs = TBC_CASES[3]
    T, k, rc = _energy_args(grid)
    ref = jax.jit(lambda *a: j_energy_operator_halo(
        *a, jgrid, jax_tbcs(tbcs), jm, kbnd=17.0, k_avg="harmonic"))(
        jnp.asarray(T), jnp.asarray(k), jnp.asarray(rc))
    got = energy_operator_halo(t(T), t(k), t(rc), grid, tbcs, tm, kbnd=17.0,
                               k_avg="harmonic")
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("coarse_replicate", [0, 8])
def test_mg_preconditioner_halo(meshes, coarse_replicate):
    """The V-cycle preconditioner with every apply on the explicit-halo
    path (coarse levels of at most ``coarse_replicate`` cells on the global
    tensors) equals the single-device one (held against the reference in
    tests/test_torch_solvers.py) to 1e-10, the reference's bar for its halo
    V-cycle against GSPMD; f64."""
    from pylamp_tpu_torch.solvers.mg import make_mg_preconditioner

    _, tm = meshes
    grid = StaggeredGrid(nx=32, ny=32, lx=1.0, ly=1.0)
    bcs = VelocityBCs(top="no_slip")
    es, en = t(_rand(grid.shape_corner, 40, 0.1, 10)), \
        t(_rand(grid.shape_center, 41, 0.1, 10))
    r = (t(_rand(grid.shape_vx, 42)), t(_rand(grid.shape_vy, 43)),
         t(_rand(grid.shape_center, 44)))
    z_ref = make_mg_preconditioner(es, en, grid, 0.8, 12.0, bcs=bcs)(r)
    z = make_mg_preconditioner(es, en, grid, 0.8, 12.0, bcs=bcs, halo_mesh=tm,
                               coarse_replicate=coarse_replicate)(r)
    for g, rf in zip(z, z_ref):
        assert rel(g, rf.numpy()) <= 1e-10
