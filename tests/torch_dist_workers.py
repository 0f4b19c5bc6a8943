"""Rank-side functions of the distributed-mesh tests
(``parallel/dist.py launch`` runs them in spawned processes).

This module imports torch, numpy and the port only: a spawned rank loads
neither JAX nor the JAX package.  Each function takes the rank's device
first and returns CPU tensors or numpy arrays, which pickle back to the
test."""
import numpy as np
import torch

from pylamp_tpu_torch.parallel.mesh import NEXT, PREV, P

SPECS = {"yx": P("y", "x"), "y": P("y", None), "x": P(None, "x"), "r": P()}


def primitive_inputs(dtype):
    """Seeded global inputs of the primitive checks: an (8, 12) field and an
    (8, 12, 3) stream."""
    rng = np.random.default_rng(18)
    return (torch.from_numpy(rng.standard_normal((8, 12))).to(dtype),
            torch.from_numpy(rng.standard_normal((8, 12, 3))).to(dtype))


def primitives(mesh, dtype, device="cpu"):
    """Every mesh primitive on ``primitive_inputs``: a dict of results,
    block results with the mesh's leading (local) dimensions.  The same
    function runs on the in-process mesh and on each rank."""
    a, s = (t.to(device) for t in primitive_inputs(dtype))
    out = {}
    iy = mesh.axis_index("y", device=device)
    ix = mesh.axis_index("x", device=device)
    iy3 = mesh.axis_index("y", nd=3, device=device)
    out["axis_index_y"], out["axis_index_x"] = iy, ix
    out["axis_index_y3"] = iy3
    out["bases"] = mesh.bases(4, 6, device=device)
    out["wall_flags"] = mesh.wall_flags(device=device)
    # every shard's own values differ: a replicated axis's gather takes
    # shard 0 of it
    scale = (1.0 + iy + 10.0 * ix).to(dtype)
    blk = mesh.split(a, P("y", "x"))
    for name, spec in SPECS.items():
        if len(spec):
            split = mesh.split(a, spec)
            out[f"split_{name}"] = mesh._full(split)
            out[f"gather_{name}"] = mesh.gather(split, spec)
        else:  # P() passes a global argument through, takes shard (0, 0)
            out["split_r"] = mesh.split(a, spec)
            out["gather_r"] = mesh.gather(blk, spec)
        out[f"gather_scaled_{name}"] = mesh.gather(blk * scale, spec)
    blk3 = mesh.split(s, P("y", "x", None))
    for axis in ("y", "x"):
        for ring in (False, True):
            tag = f"{axis}_{'ring' if ring else 'edge'}"
            out[f"from_prev_{tag}"] = mesh.from_prev(blk, axis, ring)
            out[f"from_next_{tag}"] = mesh.from_next(blk3, axis, ring)
    got = mesh.exchange((blk[..., -2:, :], "y", PREV),
                        (blk3[..., :1, :, :], "y", NEXT),
                        (blk.to(torch.int64), "x", PREV, True),
                        (blk > 0, "x", NEXT))
    for k, g in enumerate(got):
        out[f"exchange_{k}"] = g
    for tag, axes in (("y", "y"), ("x", "x"), ("yx", ("y", "x"))):
        out[f"psum_{tag}"] = mesh.psum(blk * scale, axes)
        out[f"pmax_{tag}"] = mesh.pmax(blk * scale, axes)
    out["psum_many_0"], out["psum_many_1"] = mesh.psum_many(
        (blk3, "x"), ((blk > 0).to(torch.int64), ("y", "x")))
    out["exchange_diag_0"], out["exchange_diag_1"] = mesh.exchange(
        (blk[..., -1:, -2:], ("y", "x"), (PREV, NEXT)),
        (blk3[..., :2, :1, :], ("y", "x"), (NEXT, PREV), True))
    top, bottom = 2.0 * blk[..., :1, :], blk[..., -2:, :] - 1.0
    for ring in (False, True):
        tag = "ring" if ring else "edge"
        got = mesh.halos((blk, 1, 2, 2, 1, top, bottom, ring),
                         (blk, 2, 0, 0, 1, None, None, ring))
        for k, part in enumerate(p for field in got for p in field):
            if part is not None:
                out[f"halos_{tag}_{k}"] = part
        out[f"ext1_{tag}"] = mesh.ext1(blk, ring_x=ring)
        out[f"ext1_nd3_{tag}"] = mesh.ext1(blk3, nd=3, ring_x=ring)
    out["flat"] = mesh.flat(blk)
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def fail_rank(device, rank):
    """Raise on rank ``rank``; every other rank waits a minute (the launch
    must kill it)."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails")
    time.sleep(60)


def sleep_rank(device, seconds):
    import time

    time.sleep(seconds)


def primitives_rank(device, my, mx):
    """``primitives`` on this rank's distributed mesh, in f32 and f64."""
    from pylamp_tpu_torch.parallel.dist import DistMesh

    mesh = DistMesh.from_group(my, mx)
    return {str(dt): primitives(mesh, dt, device)
            for dt in (torch.float32, torch.float64)}


def fk_halo_config(n):
    """FK at n^2 with the bench solver preset and ``explicit_halo=True``
    (a config holds closures: each rank builds its own)."""
    import dataclasses

    from pylamp_tpu_torch.models.benchmarks import fk_bench_config

    cfg = fk_bench_config(n)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, explicit_halo=True))


def fk_heated_halo_config(n, energy_preconditioner="jacobi"):
    """``models.profile.fk_heated_config(n, energy_preconditioner)`` with
    ``explicit_halo=True`` and reseeding below 10 markers per cell (one
    more than the initial 9: every step spawns in every cell)."""
    import dataclasses

    from pylamp_tpu_torch.models.profile import fk_heated_config

    cfg = fk_heated_config(n, energy_preconditioner)
    return dataclasses.replace(
        cfg, physics=dataclasses.replace(cfg.physics, reseed_min_per_cell=10),
        solver=dataclasses.replace(cfg.solver, explicit_halo=True))


def periodic_halo_config(n):
    """The periodic falling block at n^2 with its preset solver and
    ``explicit_halo=True`` (``models.benchmarks.falling_block_periodic``)."""
    import dataclasses

    from pylamp_tpu_torch.models.benchmarks import falling_block_periodic

    cfg = falling_block_periodic(nx=n, ny=n, max_steps=1)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, explicit_halo=True))


def mesh_step_rank(device, d0, n, my, mx, d_periodic=None):
    """One f64 step of ``fk_halo_config(n)`` from the path-keyed state
    ``d0`` on this rank's distributed mesh, in the sharded layout: (rank
    0's gathered state as numpy, else None; diagnostics; whether the
    replicated scalars and strips agree on every rank; the leaves this
    rank holds, after sharding or after the step, beyond its block and
    strips of their own lattice (``bridge.oversized_leaves``); the step's
    seconds and collectives on this rank).  With ``d_periodic``, then one
    step of ``periodic_halo_config(n)`` from it on the same mesh: the two
    tuples."""
    from pylamp_tpu_torch.parallel.dist import DistMesh

    mesh = DistMesh.from_group(my, mx)
    fk = dist_step(fk_halo_config(n), mesh, d0, device)
    if d_periodic is None:
        return fk
    return fk, dist_step(periodic_halo_config(n), mesh, d_periodic, device)


def heated_step_rank(device, d0, n, my, mx):
    """``mesh_step_rank``'s results for one step of
    ``fk_heated_halo_config(n)`` (Jacobi-CG energy solve) and then one of
    its energy-multigrid variant, each from ``d0``, by variant name."""
    from pylamp_tpu_torch.parallel.dist import DistMesh

    mesh = DistMesh.from_group(my, mx)
    return {pre: dist_step(fk_heated_halo_config(n, pre), mesh, d0, device)
            for pre in ("jacobi", "mg")}


def dist_step(cfg, mesh, d0, device):
    """One step of ``cfg`` on the distributed ``mesh`` from ``d0``: the
    tuple ``mesh_step_rank`` returns."""
    import time

    from pylamp_tpu_torch.bridge import (
        oversized_leaves,
        sharded_from_numpy,
        sharded_to_numpy,
    )
    from pylamp_tpu_torch.models.setup import grid_and_table
    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel import dist
    from pylamp_tpu_torch.parallel.dist import replicas_agree

    grid, table = grid_and_table(cfg)
    st0 = sharded_from_numpy(d0, mesh, device=device)
    oversized = oversized_leaves(st0, grid, mesh)
    step = make_step(grid, cfg, table, mesh=mesh)
    dist.reset_rounds()
    t0 = time.perf_counter()
    st, diag = step(st0)
    stats = {"seconds": time.perf_counter() - t0, **dist.rounds}
    diag = {k: (v.item() if torch.is_tensor(v) else v)
            for k, v in diag.items()}
    oversized.update(oversized_leaves(st, grid, mesh))
    return (sharded_to_numpy(st, mesh, root=0), diag,
            replicas_agree(st, mesh), oversized, stats)


def sharded_checks(mesh, d0, device="cpu"):
    """The sharded layout's checks on one mesh, from the path-keyed state
    ``d0``: the shard / unshard round trip, the largest piece this
    process holds and the count of pieces beyond their own lattice's
    block and strips (``bridge.oversized_leaves``), and the mesh
    reductions (``tdot``,
    ``tnorm``, ``torch.max`` / ``sum`` / ``mean`` of sharded fields, a
    dot of a field that is nonzero on its seam strips only).  The same
    function runs on the in-process mesh and on each rank; returns a dict
    of CPU tensors (the round trip's leaves on the in-process mesh and on
    rank 0 only)."""
    from pylamp_tpu_torch.bridge import (
        oversized_leaves,
        sharded_from_numpy,
        sharded_to_numpy,
        state_leaves,
    )
    from pylamp_tpu_torch.models.setup import grid_and_table
    from pylamp_tpu_torch.parallel.blocks import Blocks
    from pylamp_tpu_torch.solvers.krylov import tdot, tnorm

    st = sharded_from_numpy(d0, mesh, device=device)
    out = {}
    leaves = state_leaves(st)
    out["held"] = torch.tensor(max(
        p.numel() for v in leaves.values()
        for p in (v.pieces().values() if isinstance(v, Blocks) else (v,))))
    grid, _ = grid_and_table(fk_halo_config(int(st.eta_n.shape[0])))
    out["oversized"] = torch.tensor(len(oversized_leaves(st, grid, mesh)))
    u = (st.vx, st.vy, st.p)
    out["tdot"] = tdot(u, u)
    out["tnorm"] = tnorm(u)
    out["vmax"] = torch.max(torch.abs(st.vy))
    out["T_sum"] = torch.sum(st.T)
    out["T_mean"] = torch.mean(st.T)
    out["count"] = torch.sum(st.markers.valid)
    # ones on the seam strips, zeros inside: each strip node counts once
    seam = st.T.map(torch.ones_like)
    seam.I = torch.zeros_like(seam.I)
    out["seam_dot"] = tdot(seam, seam)
    full = sharded_to_numpy(st, mesh, root=0)
    if full is not None:
        out.update({k: torch.from_numpy(v) for k, v in full.items()})
    return {k: v.detach().cpu() for k, v in out.items()}


def sharded_rank(device, d0, my, mx):
    """``sharded_checks`` on this rank's distributed mesh."""
    from pylamp_tpu_torch.parallel.dist import DistMesh

    return sharded_checks(DistMesh.from_group(my, mx), d0, device)
