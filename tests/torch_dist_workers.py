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


def mesh_step_rank(device, d0, n, my, mx):
    """One f64 step of ``fk_halo_config(n)`` from the path-keyed state
    ``d0`` on this rank's distributed mesh: (state as numpy, diagnostics,
    whether every rank holds the same state, the step's seconds and
    message rounds on this rank)."""
    import time

    from pylamp_tpu_torch.bridge import state_from_numpy, state_to_numpy
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel import dist
    from pylamp_tpu_torch.parallel.dist import DistMesh, replicas_agree

    cfg = fk_halo_config(n)
    grid, table, _ = build(cfg, dtype=torch.float64, device=device)
    st0 = state_from_numpy(d0, device=device)
    step = make_step(grid, cfg, table, mesh=DistMesh.from_group(my, mx))
    dist.rounds.update(p2p=0, all_gather=0)
    t0 = time.perf_counter()
    st, diag = step(st0)
    stats = {"seconds": time.perf_counter() - t0, **dist.rounds}
    diag = {k: (v.item() if torch.is_tensor(v) else v)
            for k, v in diag.items()}
    return state_to_numpy(st), diag, replicas_agree(st), stats
