"""Command-line entry point (port of ``pylamp_tpu/cli.py``).

    python -m pylamp_tpu_torch run <benchmark> [--nx N] [--steps N] [--out DIR]
                                               [--device cuda|cpu] ...
    python -m pylamp_tpu_torch plot DIR
    python -m pylamp_tpu_torch list

``run`` keeps every flag of the reference's.  Its ``--platform`` /
``--devices`` become ``--device``: the card by default, and the CPU only
when asked for (``run`` refuses to start on a machine without CUDA
otherwise).  ``--mesh YxX`` takes the in-process mesh of
``parallel/mesh.py`` (every shard on one card); under torchrun it takes
the distributed mesh of ``parallel/dist.py``, one shard per rank (Y * X
ranks; NCCL, one card a rank, for ``--device cuda``, gloo for ``cpu``):

    torchrun --nproc-per-node 8 -m pylamp_tpu_torch run fk_stagnant_lid \
        --nx 1024 --mesh 4x2 --out out/fk

Under torchrun every rank holds only its blocks of the state (the
sharded layout of ``parallel/mesh.py``, built or resumed on the host, so
no card holds a global field) and computes them; rank 0 gathers the
state for the files and alone writes them, and each metrics line carries
``"layout": "sharded"``.  A configuration the sharded layout does not
take yet (ROADMAP item 19c) is refused there.  ``--scan N`` runs N
steps per call of ``models/step.py make_multi_step`` (the reference's
chunked time loop; the host is still read within each step).  ``bench``
is refused: the port's benchmark entry waits for a later port PR.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def _parse_mesh(spec: str, device: str):
    """The mesh of ``--mesh``: "YxX" (e.g. "2x4") or a shard count (e.g.
    "8" -> near-square factorization, the reference's 4x2).  Without
    torchrun, the in-process mesh (every shard on one device); under
    torchrun (WORLD_SIZE > 1), this rank's distributed mesh, after joining
    the process group (NCCL for --device cuda, gloo for cpu): Y * X must
    equal the world size."""
    from pylamp_tpu_torch.parallel import dist
    from pylamp_tpu_torch.parallel.mesh import make_mesh, parse_mesh

    mesh = parse_mesh(spec) if "x" in spec.lower() else make_mesh(int(spec))
    world = dist.torchrun_world()
    if world == 1:
        return mesh
    if mesh.size != world:
        raise SystemExit(
            f"--mesh {spec}: needs {mesh.size} devices, have {world}")
    dist.init_from_env(device)
    return dist.DistMesh.from_group(mesh.my, mesh.mx)


BENCHMARKS = {
    "falling_block": "falling_block",
    "falling_block_periodic": "falling_block_periodic",
    "blankenbach": "blankenbach_case1a",
    "fk_stagnant_lid": "fk_stagnant_lid",
    "rt_van_keken": "rt_van_keken",
    "sticky_air": "sticky_air",
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pylamp_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a benchmark model")
    runp.add_argument("benchmark", choices=sorted(BENCHMARKS))
    runp.add_argument("--nx", type=int, default=None)
    runp.add_argument("--ny", type=int, default=None)
    runp.add_argument("--steps", type=int, default=None)
    runp.add_argument("--out", type=str, default=None)
    runp.add_argument("--checkpoint-every", type=int, default=0)
    runp.add_argument("--output-every", type=int, default=0)
    runp.add_argument("--plot-every", type=int, default=0,
                      help="write a quick-look figure every N steps")
    runp.add_argument("--profile-phases", action="store_true",
                      help="per-phase wall-clock (interp/stokes/energy/advect) "
                           "into metrics.jsonl")
    runp.add_argument("--scan", type=int, default=0, metavar="N",
                      help="run N steps per chunk: diagnostics read and "
                           "outputs written at chunk boundaries")
    runp.add_argument("--resume", type=str, default=None)
    runp.add_argument("--step-delay", type=float, default=0.0,
                      help="sleep this many seconds after each step "
                           "(widens the kill window for fault-injection "
                           "tests; no effect on the computed results)")
    runp.add_argument("--f32", action="store_true",
                      help="f32 state + mixed-precision solves (the default)")
    runp.add_argument("--x64", action="store_true",
                      help="full float64 state and solves")
    runp.add_argument("--stretch-x", type=float, default=0.0, metavar="R",
                      help="geometric grid stretching in x: last/first cell "
                           "width ratio R (> 1 refines toward x=0)")
    runp.add_argument("--stretch-y", type=float, default=0.0, metavar="R",
                      help="geometric grid stretching in y (> 1 refines "
                           "toward the top)")
    runp.add_argument("--mg-smoother", default=None,
                      choices=["chebyshev", "jacobi", "line", "line_y",
                               "line_x"],
                      help="multigrid V-cycle smoother (line relaxation "
                           "for anisotropic stretched grids)")
    runp.add_argument("--mesh", type=str, default=None, metavar="YxX",
                      help="run domain-decomposed over a YxX mesh (e.g. "
                           "4x2), or a shard count (e.g. 8) for a "
                           "near-square factorization: in-process on one "
                           "card, or under torchrun one shard per rank "
                           "(Y*X ranks)")
    runp.add_argument("--explicit-halo", dest="explicit_halo",
                      action="store_true", default=None,
                      help="the explicit-halo operators and per-shard "
                           "kernels (the default whenever --mesh is given)")
    runp.add_argument("--no-explicit-halo", dest="explicit_halo",
                      action="store_false",
                      help="under --mesh, run the step on the global "
                           "tensors")
    runp.add_argument("--coarse-replicate", type=int, default=None,
                      metavar="N",
                      help="keep MG levels with <= N cells on the global "
                           "tensors (default 16 under --mesh; 0 disables)")
    runp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                      help="run on the card (the default) or, when asked "
                           "for, on the CPU (the kernels' plain versions)")

    benchp = sub.add_parser("bench", help="the benchmark harness (refused: "
                                          "waits for a later port PR)")
    benchp.add_argument("--nx", type=int, default=1024)
    benchp.add_argument("--steps", type=int, default=5)

    plotp = sub.add_parser("plot", help="post-process an output directory "
                                        "(time series + final fields figure)")
    plotp.add_argument("out_dir", help="directory written by `run --out`")

    sub.add_parser("list", help="list available benchmark models")

    args = ap.parse_args(argv)

    if args.cmd == "list":
        for name in sorted(BENCHMARKS):
            print(name)
        return 0

    if args.cmd == "plot":
        import glob
        import os

        from pylamp_tpu_torch.io.output import plot_npz_fields, plot_timeseries

        metrics = os.path.join(args.out_dir, "metrics.jsonl")
        made = []
        if os.path.exists(metrics):
            if plot_timeseries(os.path.join(args.out_dir, "timeseries.png"), metrics):
                made.append("timeseries.png")
        fields = sorted(glob.glob(os.path.join(args.out_dir, "fields_*.npz")))
        if fields and plot_npz_fields(
                os.path.join(args.out_dir, "fields_final.png"), fields[-1]):
            made.append("fields_final.png")
        if not made:
            print(f"nothing to plot in {args.out_dir} (need metrics.jsonl or "
                  f"fields_*.npz; is matplotlib available?)")
            return 1
        print("wrote " + ", ".join(os.path.join(args.out_dir, m) for m in made))
        return 0

    if args.cmd == "bench":
        # bench.py is the JAX package's harness: the port does not start it
        raise SystemExit("bench: the port's benchmark entry (ROADMAP item 8) "
                         "waits for a later port PR")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run: no CUDA device (torch.cuda.is_available() is "
                         "False); pass --device cpu to run on the CPU")
    # --x64 selects a full-f64 state; --f32 (the default) an f32 state with
    # mixed-precision solves (f64 refinement around f32 inner solves)
    state_dtype = torch.float64 if args.x64 else torch.float32

    from pylamp_tpu_torch.models import benchmarks as B
    from pylamp_tpu_torch.models.driver import run_model

    factory = getattr(B, BENCHMARKS[args.benchmark])
    kw = {}
    if args.nx:
        kw["nx"] = args.nx
        kw["ny"] = args.ny or args.nx
    cfg = factory(**kw)
    if args.steps:
        cfg = dataclasses.replace(
            cfg, time=dataclasses.replace(cfg.time, max_steps=args.steps)
        )
    if args.stretch_x or args.stretch_y:
        from pylamp_tpu_torch.core.grid import geometric_edges

        kw2 = {}
        if args.stretch_x:
            kw2["x_edges"] = geometric_edges(cfg.nx, cfg.lx, args.stretch_x)
        if args.stretch_y:
            kw2["y_edges"] = geometric_edges(cfg.ny, cfg.ly, args.stretch_y)
        cfg = dataclasses.replace(cfg, **kw2)
    if args.mg_smoother:
        omega = 0.7 if args.mg_smoother.startswith("line") else 0.6
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, mg_smoother=args.mg_smoother, mg_omega=omega
            )
        )

    from pylamp_tpu_torch.parallel import dist

    mesh = None
    if dist.torchrun_world() > 1 and not args.mesh:
        raise SystemExit(f"run: under torchrun (WORLD_SIZE="
                         f"{dist.torchrun_world()}) --mesh YxX is needed, "
                         "Y * X = WORLD_SIZE")
    if args.mesh:
        mesh = _parse_mesh(args.mesh, args.device)
        # the explicit halo is the mesh's default, as in the reference;
        # --no-explicit-halo runs the step on the global tensors
        explicit = args.explicit_halo if args.explicit_halo is not None else True
        replicate = args.coarse_replicate if args.coarse_replicate is not None else 16
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, explicit_halo=explicit,
                mg_coarse_replicate=replicate,
            )
        )
    elif args.explicit_halo or args.coarse_replicate:
        print("warning: --explicit-halo/--coarse-replicate have no effect "
              "without --mesh", file=sys.stderr)

    try:
        state, diags, grid = run_model(
            cfg,
            out_dir=args.out,
            checkpoint_every=args.checkpoint_every,
            output_every=args.output_every,
            plot_every=args.plot_every,
            resume_from=args.resume,
            echo=True,
            profile_phases=args.profile_phases,
            scan_chunk=args.scan,
            dtype=state_dtype,
            step_delay=args.step_delay,
            mesh=mesh,
            device=args.device,
        )
    finally:
        dist.shutdown()
    if mesh is None or mesh.lead:
        print(f"done: {int(state.step)} steps, t={float(state.time):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
