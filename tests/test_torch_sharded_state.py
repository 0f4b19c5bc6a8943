"""The sharded layout (parallel/mesh.py ``shard_state``, parallel/blocks.py,
parallel/block_ops.py) on the CPU, FK 32^2 in f64:

- ``shard_state`` -> ``unshard_state`` is the identity on every leaf, on
  the in-process 4x2 mesh and on every rank of a 4-rank gloo world (2x2);
  no rank holds a leaf larger than its block;
- the port's per-leaf specs match the JAX package's ``state_shardings``
  on every dimension the reference shards;
- the mesh reductions (``tdot``, ``tnorm``, ``torch.max`` / ``sum`` /
  ``mean`` of a sharded field, the marker count) of every rank equal the
  in-process mesh's bit for bit, ``tdot`` / ``tnorm`` hold the global
  ``torch.vdot`` to 1e-15 relative, and a seam strip counts once;
- every block form of parallel/block_ops.py (the MG transfers, the
  viscosity coarsening, the momentum and energy diagonals, the rhs, the
  pressure gradient, the Gershgorin bound) gathers to its global
  function's result bit for bit, walled and under periodic side walls
  (on the 4x2 mesh, a ring of two, and on 2x4, a ring of four), the rhs
  also with moving no-slip walls and prescribed heat fluxes; the
  constant-vx projection holds the global one to 1e-15 relative (a mesh
  mean) with its seam columns equal;
- the block forms of the thermal path and the energy multigrid (strain
  rate, shear and adiabatic heating, the coefficient sampling, the corner
  transfers, each level's diagonal and mask, the reseeding majority and
  spawn) likewise, walled and periodic, and the energy multigrid's power
  bound to 1e-15 relative (mesh dots);
- the covered set: a distributed mesh refuses every configuration the
  sharded layout does not take (naming ROADMAP item 19c) and a global
  state, and takes the heated FK with either energy solve, periodic side
  walls, moving walls and a prescribed heat flux; the in-process mesh
  refuses a sharded state of a refused configuration;
- the FK with a moving no-slip top and with a prescribed flux on its left
  wall: one f64 step on the sharded layout against the global layout,
  both on the in-process 4x2 mesh, at 1e-12 relative.

The sharded step against the JAX package's and the port's global step,
and the 8-rank world, are in tests/test_torch_mesh_step.py; the sharded
torchrun run, its checkpoint and its resume in tests/test_torch_dist_mesh.py.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch_dist_workers as W

from pylamp_tpu_torch.bridge import state_to_numpy
from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.models import benchmarks as B
from pylamp_tpu_torch.models.setup import build, grid_and_table
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.ops.energy import energy_rhs
from pylamp_tpu_torch.ops.stokes import stokes_rhs
from pylamp_tpu_torch.parallel import block_ops
from pylamp_tpu_torch.parallel.blocks import Blocks
from pylamp_tpu_torch.parallel.dist import DistMesh, launch
from pylamp_tpu_torch.parallel.mesh import (
    Mesh,
    shard_state,
    state_specs,
    unshard_state,
)
from pylamp_tpu_torch.solvers import mg
from pylamp_tpu_torch.solvers.energy_solver import energy_diagonal
from pylamp_tpu_torch.solvers.stokes_solver import velocity_diagonals

torch.set_num_threads(1)
N = 32
CFG = W.fk_halo_config(N)
DEADLINE_S = 60.0


@pytest.fixture(scope="module")
def state0():
    """The built FK state with seeded velocities and pressure (built, they
    are zeros)."""
    _, _, st = build(CFG, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(19)
    return st.replace(**{f: torch.from_numpy(rng.standard_normal(
        tuple(getattr(st, f).shape))) for f in ("vx", "vy", "p")})


def test_shard_unshard_identity(state0):
    mesh = Mesh(4, 2)
    sh = shard_state(state0, mesh)
    assert isinstance(sh.vx, Blocks) and isinstance(sh.markers.x, Blocks)
    want = state_to_numpy(state0)
    got = state_to_numpy(unshard_state(sh, mesh))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_sharded_world_matches_in_process(state0):
    """A 4-rank gloo world (2x2): each rank's round trip and reductions
    against the in-process 2x2 mesh's, bit for bit."""
    d0 = state_to_numpy(state0)
    ref = W.sharded_checks(Mesh(2, 2), d0)
    ranks = launch(4, W.sharded_rank, d0, 2, 2, device="cpu",
                   timeout_s=DEADLINE_S)
    for rank, got in enumerate(ranks):
        keys = ref.keys() if rank == 0 else [
            k for k in ref if not k.startswith("state.")]
        assert sorted(got) == sorted(keys), rank
        # the largest piece a rank holds is its block of the markers (the
        # in-process mesh holds the four), and no piece of any leaf is
        # larger than its own lattice's block or strip
        assert 4 * int(got["held"]) == int(ref["held"]) == \
            N * N * state0.markers.capacity, rank
        assert int(got["oversized"]) == int(ref["oversized"]) == 0, rank
        for k in (k for k in keys if k != "held"):
            assert got[k].dtype == ref[k].dtype, (rank, k)
            assert torch.equal(got[k], ref[k]), (rank, k)
    for k, v in d0.items():  # the round trip, on rank 0
        np.testing.assert_array_equal(ranks[0][k].numpy(), v, err_msg=k)


def test_reductions_match_global(state0):
    got = W.sharded_checks(Mesh(4, 2), state_to_numpy(state0))
    u = [state0.vx, state0.vy, state0.p]
    dot = sum(torch.vdot(a.reshape(-1), a.reshape(-1)) for a in u)
    assert abs(float(got["tdot"]) - float(dot)) <= 1e-15 * float(dot)
    assert abs(float(got["tnorm"]) - float(torch.sqrt(dot))) \
        <= 1e-15 * float(torch.sqrt(dot))
    assert torch.equal(got["vmax"], torch.max(torch.abs(state0.vy)))
    assert abs(float(got["T_sum"]) - float(torch.sum(state0.T))) \
        <= 1e-15 * float(torch.sum(state0.T))
    assert int(got["count"]) == int(state0.markers.total())
    # the seam strips (last row and column of the corner lattice) hold
    # ny + nx + 1 nodes, each counted once though every shard of a mesh
    # row or column holds its strip
    assert float(got["seam_dot"]) == float(2 * N + 1)


def test_specs_match_reference(state0):
    """The reference's shardings of a state of the same leaves and shapes
    (its zero state: the specs read shapes only)."""
    import jax
    import jax.numpy as jnp

    from pylamp_tpu.core.grid import StaggeredGrid as JGrid
    from pylamp_tpu.io.checkpoint import _path_str
    from pylamp_tpu.markers.bucket import BucketedMarkers as JMarkers
    from pylamp_tpu.models.state import zero_state
    from pylamp_tpu.parallel.mesh import make_mesh, state_shardings

    m = state0.markers
    jmarkers = JMarkers(**{f: jnp.zeros(tuple(getattr(m, f).shape))
                           for f in ("x", "y", "mat", "T", "valid")})
    jst = zero_state(JGrid(nx=N, ny=N, lx=1.0, ly=1.0), jmarkers,
                     n_mg_levels=state0.mg_lam.shape[0])
    jspecs = {f"state.{_path_str(p)}": s.spec for p, s in
              jax.tree_util.tree_flatten_with_path(
                  state_shardings(make_mesh(8), jst))[0]}
    specs = state_specs(state0, Mesh(4, 2))
    assert specs.keys() == jspecs.keys()
    compared = 0
    for k, js in jspecs.items():
        spec = specs[k]
        mine = spec["I"] if isinstance(spec, dict) else spec
        for d, axis in enumerate(tuple(js)):
            if axis is not None:  # a dimension the reference shards
                assert mine[d] == axis, (k, d, mine, js)
                compared += 1
        if all(a is None for a in tuple(js)):
            assert isinstance(spec, dict) or spec == (), (k, spec)
    assert compared >= 16  # p, eta_n, markers (2 each), vx, vy (1 each)


def _fields(seed, grid, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return {loc: torch.from_numpy(rng.uniform(0.5, 2.0, grid.shape(loc)))
            .to(dtype) for loc in ("vx", "vy", "corner", "center")}


BLOCK_FORMS = ("restrict", "prolong", "coarsen_eta", "velocity_diagonals",
               "gershgorin", "pressure_gradient", "stokes_rhs",
               "energy_rhs", "energy_diagonal")
# periodic side walls (velocity and thermal; "_2x4": on the 2x4 mesh, a
# ring of four, else the 4x2 mesh's ring of two), moving no-slip walls
# (every wall at once) and prescribed heat fluxes (every wall, or with
# periodic sides the top and bottom)
PERIODIC_FORMS = tuple(f"{n}_periodic{m}" for n in (
    "restrict", "prolong", "velocity_diagonals", "gershgorin",
    "pressure_gradient", "stokes_rhs", "energy_rhs", "energy_diagonal")
    for m in ("", "_2x4"))
BC_FORMS = ("stokes_rhs_moving", "stokes_rhs_moving_periodic",
            "energy_rhs_flux", "energy_rhs_flux_harmonic",
            "energy_rhs_flux_periodic")
PER = ThermalBC("periodic", 0.0)


def _variant_bcs(variant):
    """(velocity BCs, thermal BCs) of a block-form case's variant."""
    from pylamp_tpu_torch.core.bc import VelocityBCs

    vbc = CFG.physics.velocity_bcs
    tbc = ThermalBCs(top=ThermalBC("dirichlet", 0.0),
                     bottom=ThermalBC("dirichlet", 1.0))
    if "periodic" in variant:
        vbc = VelocityBCs(top="no_slip", left="periodic", right="periodic")
        tbc = dataclasses.replace(tbc, left=PER, right=PER)
    if "moving" in variant:
        walls = ("top", "bottom") if "periodic" in variant else (
            "top", "bottom", "left", "right")
        vbc = dataclasses.replace(vbc, **{w: "no_slip" for w in walls}, **{
            f"vt_{w}": v for w, v in zip(walls, (0.7, -1.3, 2.1, -0.4))})
    if "flux" in variant:
        flux = {"top": 0.4, "bottom": -0.3, "left": 0.5, "right": 0.7}
        walls = ("top", "bottom") if "periodic" in variant else flux
        tbc = dataclasses.replace(tbc, **{
            w: ThermalBC("neumann", flux[w]) for w in walls})
    return vbc, tbc


@pytest.mark.parametrize("name", BLOCK_FORMS + PERIODIC_FORMS + BC_FORMS)
def test_block_forms_equal_global(name):
    """Each block form, gathered, against its global function on the same
    seeded inputs: bit for bit (the same arithmetic on the same values).
    The periodic cases' fields have equal seam columns, as the periodic
    step keeps them."""
    mesh = Mesh(2, 4) if name.endswith("_2x4") else Mesh(4, 2)
    grid = StaggeredGrid(nx=N, ny=N, lx=1.0, ly=1.0)
    coarse = grid.coarsen(True, True)
    cut = min((name.index(v) for v in ("_periodic", "_moving", "_flux")
               if v in name), default=len(name))
    name, variant = name[:cut], name[cut:]
    vbc, tbc = _variant_bcs(variant)
    g = _fields(19, grid)
    c = _fields(20, coarse)
    if "periodic" in variant:
        for f in (g, c):
            for loc in ("vx", "corner"):
                f[loc][:, -1] = f[loc][:, 0]
    kb = torch.tensor(3.5, dtype=torch.float64)
    k_avg = "harmonic" if "harmonic" in variant else "arithmetic"

    def sh(a, loc):
        return Blocks.split(a, loc, mesh)

    if name == "restrict":
        got = block_ops.restrict(sh(g["vx"], "vx"), sh(g["vy"], "vy"), vbc)
        want = (mg.restrict_vx(g["vx"], vbc), mg.restrict_vy(g["vy"], vbc))
    elif name == "prolong":
        got = block_ops.prolong(sh(c["vx"], "vx"), sh(c["vy"], "vy"), vbc)
        want = (mg.prolong_vx(c["vx"], vbc), mg.prolong_vy(c["vy"], vbc))
    elif name == "coarsen_eta":
        got = mg.coarsen_eta(sh(g["corner"], "corner"),
                             sh(g["center"], "center"))
        want = mg.coarsen_eta(g["corner"], g["center"])
    elif name == "velocity_diagonals":
        got = velocity_diagonals(sh(g["corner"], "corner"),
                                 sh(g["center"], "center"), grid, kb,
                                 bcs=vbc if variant else None)
        want = velocity_diagonals(g["corner"], g["center"], grid, kb, vbc)
    elif name == "gershgorin":
        got = (mg.gershgorin_lambda(sh(g["corner"], "corner"),
                                    sh(g["center"], "center"), grid, vbc, kb),)
        want = (mg.gershgorin_lambda(g["corner"], g["center"], grid, vbc,
                                     kb),)
    elif name == "pressure_gradient":
        got = mg._pressure_gradient(sh(g["center"], "center"), grid,
                                    torch.float64, bcs=vbc)
        want = mg._pressure_gradient(g["center"], grid, torch.float64, vbc)
    elif name == "stokes_rhs":
        es = g["corner"] + 0.5
        got = stokes_rhs(sh(g["vx"], "vx"), sh(g["vy"], "vy"), 0.3, 9.81,
                         grid, vbc, kbnd=kb, dtype=torch.float64,
                         eta_s=sh(es, "corner"))
        want = stokes_rhs(g["vx"], g["vy"], 0.3, 9.81, grid, vbc, kbnd=kb,
                          dtype=torch.float64, eta_s=es)
    elif name == "energy_rhs":
        rc = g["corner"] * 3.0
        k = g["corner"] + 0.25
        got = (energy_rhs(sh(g["corner"], "corner"), sh(k, "corner"),
                          sh(rc, "corner"), sh(g["corner"] - 1.0, "corner"),
                          grid, tbc, kbnd=kb, k_avg=k_avg),)
        want = (energy_rhs(g["corner"], k, rc, g["corner"] - 1.0, grid, tbc,
                           kbnd=kb, k_avg=k_avg),)
    else:
        rc = g["corner"] * 3.0
        got = (energy_diagonal(sh(g["corner"], "corner"), sh(rc, "corner"),
                               grid, tbc, kb, "arithmetic"),)
        want = (energy_diagonal(g["corner"], rc, grid, tbc, kb,
                                "arithmetic"),)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.gather() if isinstance(a, Blocks) else a
        assert a.shape == b.shape
        assert torch.equal(a, b), name


def test_project_vx_mean_blocks():
    """The constant-vx projection on blocks against the global one: the
    mean over columns 0 .. nx - 1 as a mesh mean (psum's shard order, not
    torch.mean's), so 1e-15 relative; the seam columns stay equal."""
    from pylamp_tpu_torch.solvers.stokes_solver import project_vx_mean

    grid = StaggeredGrid(nx=N, ny=N, lx=1.0, ly=1.0)
    vx = _fields(25, grid)["vx"]
    vx[:, -1] = vx[:, 0]
    want = project_vx_mean(vx)
    for mesh in (Mesh(4, 2), Mesh(2, 4)):
        got = project_vx_mean(Blocks.split(vx, "vx", mesh)).gather()
        assert float(torch.max(torch.abs(got - want))) <= 1e-15 * float(
            torch.max(torch.abs(vx)))
        assert torch.equal(got[:, 0], got[:, -1])


THERMAL_FORMS = ("strain_rate_ii", "shear_heating", "adiabatic_heating",
                 "sample_corner", "restrict_corner", "prolong_corner",
                 "level_diagonals", "level_masks", "majority", "spawn")
# under periodic side walls (velocity and thermal), on the 4x2 mesh
THERMAL_PERIODIC = tuple(f"{n}_periodic" for n in (
    "strain_rate_ii", "shear_heating", "adiabatic_heating",
    "restrict_corner", "prolong_corner", "level_diagonals", "level_masks",
    "majority"))


def _energy_levels(mesh, grid, k, rc, tbc, kb):
    """Each sharded level of the energy multigrid's hierarchy from the
    corner fields ``k``, ``rc``: (grid, kbnd, global k, global rc, sharded
    k, sharded rc), the coefficients sampled by the global slicing and by
    the block form (32^2 on the 4x2 mesh: 32^2, 16^2 and 8^2 stay
    sharded)."""
    from pylamp_tpu_torch.parallel.halo_ops import halo_eligible

    out = []
    kg, rg = k, rc
    ks, rs = Blocks.split(k, "corner", mesh), Blocks.split(rc, "corner", mesh)
    g = grid
    while halo_eligible(g, mesh):
        out.append((g, kb * (grid.dx * grid.dy) / (g.dx * g.dy), kg, rg, ks,
                    rs))
        g = g.coarsen(True, True)
        kg, rg = kg[::2, ::2], rg[::2, ::2]
        ks, rs = block_ops.sample_corner(ks), block_ops.sample_corner(rs)
    return out


@pytest.mark.parametrize("name", THERMAL_FORMS + THERMAL_PERIODIC)
def test_thermal_block_forms_equal_global(name):
    """The block forms of the thermal path and the energy multigrid,
    gathered, against their global functions on the same seeded inputs:
    bit for bit (periodic cases: the heating terms clamp at the x seam as
    the global ones do, the strain rate wraps vy's ghost columns, the
    restriction folds the seam columns, the majority reads the wrapped
    3x3 neighbourhood)."""
    from pylamp_tpu_torch.markers.bucket import (
        BucketedMarkers,
        material_histogram,
        reseed_spawn,
    )
    from pylamp_tpu_torch.ops.energy import _dirichlet_masks
    from pylamp_tpu_torch.ops.stokes import strain_rate_ii
    from pylamp_tpu_torch.physics.heating import (
        adiabatic_heating,
        shear_heating,
    )
    from pylamp_tpu_torch.solvers import energy_mg

    mesh = Mesh(4, 2)
    grid = StaggeredGrid(nx=N, ny=N, lx=1.0, ly=1.0)
    coarse = grid.coarsen(True, True)
    vbc = CFG.physics.velocity_bcs
    tbc = CFG.physics.thermal_bcs
    g = {loc: v - 1.25 for loc, v in _fields(21, grid).items()}
    c = _fields(22, coarse)
    kb = torch.tensor(3.5, dtype=torch.float64)
    periodic = name.endswith("_periodic")
    if periodic:
        from pylamp_tpu_torch.core.bc import VelocityBCs

        name = name[:-len("_periodic")]
        vbc = VelocityBCs(left="periodic", right="periodic")
        tbc = dataclasses.replace(tbc, left=PER, right=PER)
        for f in (g, c):
            for loc in ("vx", "corner"):
                f[loc][:, -1] = f[loc][:, 0]

    def sh(a, loc):
        return Blocks.split(a, loc, mesh)

    if name == "strain_rate_ii":
        got = (strain_rate_ii(sh(g["vx"], "vx"), sh(g["vy"], "vy"), grid,
                              vbc),)
        want = (strain_rate_ii(g["vx"], g["vy"], grid, vbc),)
    elif name == "shear_heating":
        eta = g["center"] + 2.0
        got = (shear_heating(sh(g["vx"], "vx"), sh(g["vy"], "vy"),
                             sh(eta, "center"), grid, vbc),)
        want = (shear_heating(g["vx"], g["vy"], eta, grid, vbc),)
    elif name == "adiabatic_heating":
        ra = g["corner"] * 3.0
        got = (adiabatic_heating(sh(g["corner"], "corner"), sh(ra, "corner"),
                                 sh(g["vy"], "vy"), 9.81, grid),)
        want = (adiabatic_heating(g["corner"], ra, g["vy"], 9.81, grid),)
    elif name == "sample_corner":
        got = (block_ops.sample_corner(sh(g["corner"], "corner")),)
        want = (g["corner"][::2, ::2],)
    elif name == "restrict_corner":
        got = (block_ops.restrict_corner(sh(g["corner"], "corner"),
                                         periodic),)
        want = (energy_mg.restrict_corner(g["corner"], periodic),)
    elif name == "prolong_corner":
        got = (block_ops.prolong_corner(sh(c["corner"], "corner")),)
        want = (energy_mg.prolong_corner(c["corner"]),)
    elif name in ("level_diagonals", "level_masks"):
        levels = _energy_levels(mesh, grid, g["corner"] + 2.0,
                                g["corner"] * 3.0 + 4.0, tbc, kb)
        assert len(levels) == 3
        got, want = [], []
        for lg, lkb, kg, rg, ks, rs in levels:
            got += [ks, rs]
            want += [kg, rg]
            if name == "level_diagonals":
                got.append(energy_diagonal(ks, rs, lg, tbc, lkb,
                                           "arithmetic"))
                want.append(energy_diagonal(kg, rg, lg, tbc, lkb,
                                            "arithmetic"))
            else:
                got.append(block_ops.dirichlet_masks(ks, tbc)[0])
                want.append(_dirichlet_masks(lg, tbc, kg.dtype, "cpu")[0])
    else:
        rng = np.random.default_rng(23)
        shape = (N, N, 6)
        valid = torch.from_numpy(rng.uniform(size=shape) < 0.3)
        mat = torch.from_numpy(rng.integers(0, 3, shape).astype(np.int32))
        pos = torch.from_numpy(rng.uniform(0.0, 1.0, shape))
        bm = BucketedMarkers(x=pos, y=pos.flip(0), mat=mat, T=pos * 2.0,
                             valid=valid)
        blocks = BucketedMarkers(**{f: sh(getattr(bm, f), "center").I
                                    for f in ("x", "y", "mat", "T",
                                              "valid")})
        hist = mesh.ext1(material_histogram(blocks, 3), nd=3,
                         ring_x=periodic)
        acc = sum(hist[..., 1 + a:9 + a, 1 + b:17 + b, :]
                  for a in (-1, 0, 1) for b in (-1, 0, 1))
        major = torch.argmax(acc, dim=-1).to(torch.int32)
        hist_g = material_histogram(bm, 3)
        if periodic:  # the wrapped columns, as bucket._shift3 reads them
            hist_g = torch.cat([hist_g[:, -1:], hist_g, hist_g[:, :1]], 1)
            hist_g = torch.nn.functional.pad(hist_g, (0, 0, 0, 0, 1, 1))
        else:
            hist_g = torch.nn.functional.pad(hist_g, (0, 0, 1, 1, 1, 1))
        major_g = torch.argmax(sum(
            hist_g[1 + a:N + 1 + a, 1 + b:N + 1 + b]
            for a in (-1, 0, 1) for b in (-1, 0, 1)), dim=-1).to(torch.int32)
        if name == "majority":
            got = (Blocks(mesh, "center", major),)
            want = (major_g,)
        else:
            f64 = torch.float64
            cells = ((mesh.axis_index("y", 3) * 8).to(f64)
                     + torch.arange(8, dtype=f64).view(8, 1, 1),
                     (mesh.axis_index("x", 3) * 16).to(f64)
                     + torch.arange(16, dtype=f64).view(1, 16, 1))
            got = tuple(Blocks(mesh, "center", a) for a in reseed_spawn(
                blocks, major, grid, 4, cells))
            want = reseed_spawn(bm, major_g, grid, 4)
            assert bool(want[0].any())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.gather() if isinstance(a, Blocks) else a
        assert a.shape == b.shape
        assert a.dtype == b.dtype
        assert torch.equal(a, b), name


def test_power_lambda_blocks_match_global():
    """The energy multigrid's power bound on blocks (the start vector from
    each node's global index, mesh dots) against the global one: 1e-15
    relative."""
    from pylamp_tpu_torch.ops.energy import energy_operator
    from pylamp_tpu_torch.solvers.energy_mg import _power_lambda_max

    mesh = Mesh(4, 2)
    grid = StaggeredGrid(nx=N, ny=N, lx=1.0, ly=1.0)
    tbc = CFG.physics.thermal_bcs
    f = _fields(24, grid)
    k, rc = f["corner"], f["corner"] * 40.0
    kb = torch.tensor(3.5, dtype=torch.float64)
    d = energy_diagonal(k, rc, grid, tbc, kb, "arithmetic")
    want = _power_lambda_max(lambda v: energy_operator(
        v, k, rc, grid, tbc, kbnd=kb) / d, k)
    ks, rs = (Blocks.split(a, "corner", mesh) for a in (k, rc))
    ds = energy_diagonal(ks, rs, grid, tbc, kb, "arithmetic")
    got = _power_lambda_max(lambda v: energy_operator(
        v, ks, rs, grid, tbc, kbnd=kb, halo_mesh=mesh) / ds, ks)
    start = block_ops.flat_index(ks).gather()
    assert torch.equal(start, torch.arange(k.numel()).reshape(k.shape))
    assert abs(float(got) - float(want)) <= 1e-15 * float(want)


def _refused(name):
    """A configuration outside the sharded layout's covered set."""
    fk = W.fk_halo_config(N)
    solver = fk.solver
    if name == "periodic":
        cfg = B.falling_block_periodic(nx=N, ny=N)
        return dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, explicit_halo=True))
    if name == "stretched":
        from pylamp_tpu_torch.core.grid import geometric_edges

        return dataclasses.replace(fk, y_edges=geometric_edges(N, 1.0, 4.0))
    if name == "flat":
        return dataclasses.replace(fk, marker_engine="flat")
    phys = fk.physics
    if name == "heat_flux":
        return dataclasses.replace(fk, physics=dataclasses.replace(
            phys, thermal_bcs=dataclasses.replace(
                phys.thermal_bcs, left=ThermalBC("neumann", 0.5))))
    if name == "moving_walls":
        return dataclasses.replace(fk, physics=dataclasses.replace(
            phys, velocity_bcs=dataclasses.replace(
                phys.velocity_bcs, top="no_slip", vt_top=1.0)))
    return dataclasses.replace(fk, solver=dataclasses.replace(solver, **{
        "stokes_jacobi": dict(preconditioner="jacobi"),
        "energy_mg_lines": dict(energy_preconditioner="mg",
                                energy_mg_smoother="line"),
        "wbfbt": dict(schur="wbfbt"),
        "vanka": dict(preconditioner="vanka", mg_semicoarsen=0.0),
        "sticky_air_al": dict(stokes_al_gamma=10.0,
                              mg_velocity_inner_iters=16),
    }[name]))


@pytest.mark.parametrize("name", ["stretched", "flat", "wbfbt", "vanka",
                                  "sticky_air_al", "stokes_jacobi",
                                  "energy_mg_lines"])
def test_distributed_mesh_refuses(name):
    cfg = _refused(name)
    grid, table = grid_and_table(cfg)
    with pytest.raises(ValueError, match="ROADMAP item 19c"):
        make_step(grid, cfg, table, mesh=DistMesh(4, 2, 0))


@pytest.mark.parametrize("name", ["periodic", "heat_flux", "moving_walls"])
def test_distributed_mesh_takes(name):
    """Periodic side walls (the falling block with explicit halos), a
    moving no-slip top and a prescribed flux on the left wall (the FK):
    the sharded layout takes each, and a step builds on a rank of the
    distributed 4x2 mesh."""
    from pylamp_tpu_torch.models.step import sharded_refusal

    cfg = _refused(name)
    grid, table = grid_and_table(cfg)
    mesh = DistMesh(4, 2, 1)
    assert sharded_refusal(grid, cfg, mesh) is None
    assert callable(make_step(grid, cfg, table, mesh=mesh))


@pytest.mark.parametrize("name", ["moving_walls", "heat_flux"])
def test_sharded_bc_step_matches_global(name):
    """One f64 step of the FK with a moving no-slip top (v_t = 1) or a
    prescribed flux of 0.5 on its left wall, on the sharded layout against
    the global layout, both on the in-process 4x2 mesh: 1e-12 relative,
    the same Krylov and CG counts, valid slots and materials equal."""
    cfg = _refused(name)
    grid, table, st0 = build(cfg, dtype=torch.float64, device="cpu")
    mesh = Mesh(4, 2)
    step = make_step(grid, cfg, table, mesh=mesh)
    want, wdiag = step(st0)
    got, diag = step(shard_state(st0, mesh))
    got = unshard_state(got, mesh)
    for f in ("vx", "vy", "p", "T", "eta_s", "eta_n"):
        a, b = getattr(got, f), getattr(want, f)
        assert float(torch.max(torch.abs(a - b))) <= 1e-12 * float(
            torch.max(torch.abs(b))), f
    for f in ("x", "y", "T"):
        a, b = getattr(got.markers, f), getattr(want.markers, f)
        assert float(torch.max(torch.abs(a - b))) <= 1e-12, f
    for f in ("valid", "mat"):
        assert torch.equal(getattr(got.markers, f), getattr(want.markers, f))
    for it in ("stokes_iterations", "energy_iterations"):
        assert diag[it] == wdiag[it], it


@pytest.mark.parametrize("pre", ["jacobi", "mg"])
def test_distributed_mesh_takes_the_heated_fk(pre):
    """The four thermal switches, with the Jacobi-CG energy solve or the
    energy multigrid with flexible CG, on a rank of the distributed 4x2
    mesh."""
    from pylamp_tpu_torch.models.profile import fk_heated_config
    from pylamp_tpu_torch.models.step import sharded_refusal

    cfg = fk_heated_config(N, pre)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, explicit_halo=True))
    grid, table = grid_and_table(cfg)
    mesh = DistMesh(4, 2, 3)
    assert sharded_refusal(grid, cfg, mesh) is None
    assert callable(make_step(grid, cfg, table, mesh=mesh))


def test_sharded_refusals_in_process_and_global_state(state0):
    """The in-process mesh refuses a sharded state of a configuration
    outside the covered set (its global state still steps), and a
    distributed mesh refuses a global state."""
    mesh = Mesh(4, 2)
    cfg = _refused("wbfbt")
    grid, table = grid_and_table(cfg)
    with pytest.raises(ValueError, match="ROADMAP item 19c"):
        make_step(grid, cfg, table, mesh=mesh)(shard_state(state0, mesh))
    grid, table = grid_and_table(CFG)
    with pytest.raises(TypeError, match="sharded layout"):
        make_step(grid, CFG, table, mesh=DistMesh(4, 2, 0))(state0)


# torch functions that read across nodes or have no node-by-node form:
# a sharded field refuses each rather than applying it block by block
ACROSS_NODES = {
    "select": lambda f: torch.select(f, 0, 0),
    "diff": torch.diff,
    "nansum": torch.nansum,
    "median": torch.median,
    "std": torch.std,
    "vector_norm": torch.linalg.vector_norm,
    "tril": torch.tril,
    "avg_pool2d": lambda f: torch.nn.functional.avg_pool2d(f, 2),
    "cumsum": lambda f: torch.cumsum(f, 0),
    "roll": lambda f: torch.roll(f, 1, 0),
}


@pytest.mark.parametrize("name", sorted(ACROSS_NODES))
def test_blocks_refuse_functions_across_nodes(state0, name):
    T = shard_state(state0, Mesh(4, 2)).T
    with pytest.raises(TypeError, match="node-by-node"):
        ACROSS_NODES[name](T)
    # a node-by-node function applies piece by piece
    got = torch.exp(torch.where(T > 0.5, T, 0.5 * T)).gather()
    assert torch.equal(got, torch.exp(torch.where(state0.T > 0.5, state0.T,
                                                  0.5 * state0.T)))


@pytest.mark.parametrize("leaf", ["replicated", "global_blocks"])
def test_oversized_leaves_catch_global_fields(state0, leaf):
    """``bridge.oversized_leaves`` bounds each piece by its own lattice:
    a sharded state is within bounds; a field kept whole, as a plain
    tensor or as pieces of the global size, is caught though it is
    smaller than the markers' block."""
    from pylamp_tpu_torch.bridge import oversized_leaves

    mesh = Mesh(4, 2)
    grid, _ = grid_and_table(CFG)
    sh = shard_state(state0, mesh)
    assert oversized_leaves(sh, grid, mesh) == {}
    if leaf == "replicated":
        bad, key = sh.replace(vx=state0.vx), "state.vx"
    else:
        whole = state0.p.expand(4, 2, N, N)
        bad, key = sh.replace(p=Blocks(mesh, "center", whole)), "state.p.I"
    assert state0.vx.numel() < N * N * state0.markers.capacity // 8
    assert list(oversized_leaves(bad, grid, mesh)) == [key]
