"""Multi-shard dry run: the full timestep on the in-process mesh, or on a
distributed mesh of spawned ranks, each sub-check held against the
single-device step.

    python -m pylamp_tpu_torch.parallel.dryrun [--shards 8] [--device cpu]
    python -m pylamp_tpu_torch.parallel.dryrun --ranks 8 [--device cpu]
        [--backend gloo|nccl]

Port of ``pylamp_tpu/parallel/dryrun.py`` at the reference's own sizes (32^2
on the ``make_mesh(8)`` 4x2 mesh).  Of its four sub-checks:

  explicit_halo     (b) the explicit-halo operators, per-shard smoother and
                    marker halo engine with the per-shard kernels (on a CUDA
                    device; their plain versions on the CPU): falling block,
                    f32 state and solve, equal to the single-device step to
                    2e-4 max|vy|
  coarse_replicate  (c) MG coarse-level replication: Blankenbach case 1a in
                    f64 with ``mg_coarse_replicate=8``, equal to 1e-8
  periodic_halo     (d) periodic side walls through the explicit-halo
                    operators (ring exchanges, seam rows; in-process the
                    markers on the global tensors, on ranks the marker
                    engine's wrap-around exchange on each rank's blocks):
                    the periodic falling block in f64, equal to 1e-8

(a), the GSPMD default, has no separate port: without ``explicit_halo`` the
in-process mesh runs the single-device step on the global tensors, which
is what GSPMD computes, so the check would compare the step with itself.
For the same reason (c) runs with ``explicit_halo`` (the reference's runs
without): only the halo engine reads ``mg_coarse_replicate``.  It runs three
MG levels where the reference runs two, because at 32^2 two levels (32, 16)
leave no level of at most 8 cells to replicate.  (d) runs the reference's
f64 solver of (a)/(c) (two MG levels) with ``explicit_halo``.

``--ranks N`` runs the sub-checks (b), (c) and (d) on the distributed
mesh of ``parallel/dist.py`` (N ranks spawned by ``launch``, one shard
each; the backend by the device unless ``--backend`` names one, gloo ranks
may share a card) in the sharded layout: every rank shards the built
state, steps its blocks and holds the gathered result against the
single-device step at the same bars, the port's counterpart of the
reference's ``dryrun_multichip(8)`` on 8 real devices.

Runs on the card unless ``--device cpu``; prints one line per sub-check
and exits non-zero on any disagreement.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


def _assert_close(new, ref, diag, tag, tol, fields=("vx", "vy", "T")):
    if not diag["stokes_converged"]:
        raise AssertionError(f"[{tag}] sharded Stokes did not converge")
    vref = max(float(torch.max(torch.abs(ref.vy))), 1.0)
    for name in fields:
        a, b = getattr(new, name), getattr(ref, name)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"[{tag}] non-finite {name} in sharded step")
        err = float(torch.max(torch.abs(a.double() - b.double())))
        if not err <= tol * vref:
            raise AssertionError(
                f"[{tag}] sharded {name} deviates from single-device by "
                f"{err:.3e} (allowed {tol * vref:.3e})")
    return float(torch.max(torch.abs(new.vy.double() - ref.vy.double())))


def _run_pair(cfg, mesh, dtype, device):
    """One (single-device, sharded) step pair from the same built state:
    (sharded state, single-device state, sharded diag).  A distributed
    mesh steps the sharded layout and gathers the result."""
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel.mesh import shard_state, unshard_state

    grid, table, state0 = build(cfg, dtype=dtype, device=device)
    ref_state, _ = make_step(grid, cfg, table)(state0)
    if mesh.distributed:
        new, diag = make_step(grid, cfg, table, mesh=mesh)(
            shard_state(state0, mesh))
        return unshard_state(new, mesh), ref_state, diag
    new, diag = make_step(grid, cfg, table, mesh=mesh)(state0)
    return new, ref_state, diag


def dryrun_multichip(n_shards: int = 8, device="cuda", checks="bcd",
                     mesh=None):
    """The sub-checks ``checks`` on ``mesh`` (None: the in-process
    ``make_mesh(n_shards)``); prints the summary line (rank 0 of a
    distributed mesh) and returns it."""
    from pylamp_tpu_torch.models.benchmarks import (
        blankenbach_case1a,
        falling_block,
        falling_block_periodic,
    )
    from pylamp_tpu_torch.models.config import SolverConfig
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    if "a" in checks:
        raise ValueError("sub-check (a) is the single-device step by "
                         "construction on the in-process mesh (module "
                         "docstring)")
    if mesh is None:
        mesh = make_mesh(n_shards)
    lines = []
    if "b" in checks:
        cfg = falling_block(nx=32, ny=32, max_steps=1)
        cfg = dataclasses.replace(cfg, solver=SolverConfig(
            precision="f32", stokes_tol=1e-5, stokes_restart=40,
            stokes_maxiter=600, explicit_halo=True))
        new, ref, diag = _run_pair(cfg, mesh, torch.float32, device)
        err = _assert_close(new, ref, diag, "explicit_halo", 2e-4)
        lines.append(f"explicit_halo@2e-4 (max |dvy| {err:.3e}, Krylov "
                     f"{diag['stokes_iterations']})")
    if "c" in checks:
        # three levels (32, 16, 8): the 8^2 level, whose 2x4 blocks the
        # halo engine would take, runs on the global tensors instead
        cfg = blankenbach_case1a(nx=32, ny=32, max_steps=1)
        cfg = dataclasses.replace(cfg, solver=SolverConfig(
            precision="f64", stokes_tol=1e-10, stokes_restart=40,
            stokes_maxiter=400, mg_levels=3, mg_coarse_replicate=8,
            explicit_halo=True))
        new, ref, diag = _run_pair(cfg, mesh, torch.float64, device)
        err = _assert_close(new, ref, diag, "coarse_replicate", 1e-8)
        lines.append(f"coarse_replicate@1e-8 (max |dvy| {err:.3e}, Krylov "
                     f"{diag['stokes_iterations']})")
    if "d" in checks:
        cfg = falling_block_periodic(nx=32, ny=32, max_steps=1)
        cfg = dataclasses.replace(cfg, solver=SolverConfig(
            precision="f64", stokes_tol=1e-10, stokes_restart=40,
            stokes_maxiter=400, mg_levels=2, explicit_halo=True))
        new, ref, diag = _run_pair(cfg, mesh, torch.float64, device)
        err = _assert_close(new, ref, diag, "periodic_halo", 1e-8)
        lines.append(f"periodic_halo@1e-8 (max |dvy| {err:.3e}, Krylov "
                     f"{diag['stokes_iterations']})")
    kind = (f"{type(mesh).__name__} rank {mesh.rank}"
            if hasattr(mesh, "rank") else "in-process")
    line = (f"dryrun_multichip OK on {device}: {kind} mesh "
            f"{dict(y=mesh.my, x=mesh.mx)}, each sub-check == single-device "
            f"to its stated tolerance: " + ", ".join(lines))
    if mesh.lead:
        print(line)
    return line


def _dryrun_rank(device, n_shards, checks):
    """One rank of ``--ranks``: the sub-checks on its distributed mesh."""
    from pylamp_tpu_torch.parallel.dist import DistMesh
    from pylamp_tpu_torch.parallel.mesh import _factor2

    mesh = DistMesh.from_group(*_factor2(n_shards))
    return dryrun_multichip(n_shards, device.type, checks, mesh=mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=0,
                    help="run on a distributed mesh of this many spawned "
                         "ranks (one shard each) instead of in-process")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="with --ranks: nccl for cuda, gloo for cpu unless "
                         "named")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checks", default="bcd",
                    help="sub-checks to run, of 'bcd' (default: all)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("dryrun: no CUDA device (pass --device cpu for the CPU)")
    if args.ranks:
        from pylamp_tpu_torch.parallel.dist import launch

        launch(args.ranks, _dryrun_rank, args.ranks, args.checks,
               device=args.device, backend=args.backend, timeout_s=1800.0)
        print(f"dryrun_multichip OK on every one of the {args.ranks} ranks")
        return
    dryrun_multichip(args.shards, args.device, args.checks)


if __name__ == "__main__":
    main()
