"""Time-loop driver (port of ``pylamp_tpu/models/driver.py``): the step plus
checkpoint / output / metrics around it, divergence detection with a
stronger-solver retry.

Each line of ``metrics.jsonl`` holds the reference's keys for the same
record.  The port's step adds one of its own, ``energy_converged`` (the
energy solve's convergence flag), on models that solve for temperature."""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch

from pylamp_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pylamp_tpu_torch.io.logging import MetricsLogger
from pylamp_tpu_torch.io.output import save_fields
from pylamp_tpu_torch.models.config import ModelConfig
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step, sync_device


def run_model(
    cfg: ModelConfig,
    out_dir: str | None = None,
    checkpoint_every: int = 0,
    output_every: int = 0,
    plot_every: int = 0,
    resume_from: str | None = None,
    echo: bool = False,
    callback: Callable | None = None,
    on_divergence: str = "retry",
    profile_phases: bool = False,
    scan_chunk: int = 0,
    dtype=None,
    step_delay: float = 0.0,
    mesh=None,
    device="cuda",
):
    """Run the model for cfg.time.max_steps (or until max_time) on
    ``device`` (the card unless the caller asks for the CPU).

    ``dtype``: the state's torch dtype; None is float64, as in the
    reference with x64 on (its CLI always turns it on).  float32 runs the
    mixed-precision solves and, on the card, the CUDA kernels.

    ``mesh``: an in-process mesh (``parallel/mesh.py``) for a
    domain-decomposed run on one card: the step is built with it (the
    explicit-halo operators and per-shard kernels when
    ``SolverConfig.explicit_halo`` is set, the global tensors otherwise),
    and every metrics line carries ``"mesh": "YxX"``.

    ``on_divergence``: "retry" re-runs a non-converged step once with a
    stronger solver (4x maxiter, 2x restart, built at the first
    divergence) and sets ``diag["retried"]``; "warn" just records it.

    ``profile_phases``: run the per-phase-instrumented step
    (``make_phased_runner``: the device synchronized around interp /
    stokes / energy / advect) and emit ``phase_seconds`` into the metrics
    JSONL.

    ``plot_every``: write a quick-look figure (T, |v|, log eta) every N
    steps into ``out_dir``.

    ``step_delay``: > 0 sleeps that many seconds after each step — a
    fault-injection test hook that makes the between-steps kill window
    wide regardless of step speed.

    ``scan_chunk`` > 0 (the reference's ``lax.scan`` time loop) is
    refused: the port has no fused multi-step loop yet.

    Returns (final_state, diagnostics list, grid)."""
    if scan_chunk > 0 and profile_phases:
        raise ValueError("scan_chunk and profile_phases are mutually exclusive")
    if scan_chunk > 0:
        raise NotImplementedError(
            "scan_chunk (the fused multi-step loop, ROADMAP item 20) waits "
            "for a later port PR")
    mesh_tag = None
    if mesh is not None:
        if profile_phases:
            raise ValueError("profile_phases is single-device only "
                             "(per-phase host syncs would serialize the mesh)")
        mesh_tag = f"{mesh.my}x{mesh.mx}"

    grid, table, state = build(cfg, dtype=dtype or torch.float64,
                               device=device)
    if resume_from:
        state, _ = load_checkpoint(resume_from, template=state)

    if profile_phases:
        from pylamp_tpu_torch.models.step import make_phased_runner

        step = make_phased_runner(grid, cfg, table)
    else:
        step = make_step(grid, cfg, table, mesh=mesh)
    strong_step = None  # built lazily on first divergence

    logger = MetricsLogger(
        os.path.join(out_dir, "metrics.jsonl") if out_dir else None, echo=echo
    )

    def timed_step(fn, st):
        t0 = time.perf_counter()
        new_st, d = fn(st)
        sync_device(new_st.vx.device)
        return new_st, d, time.perf_counter() - t0

    diags = []
    tc = cfg.time
    while int(state.step) < tc.max_steps and float(state.time) < tc.max_time:
        new_state, diag, step_wall = timed_step(step, state)

        if not bool(diag["stokes_converged"]):
            if on_divergence == "retry":
                if strong_step is None:
                    strong_cfg = dataclasses.replace(
                        cfg,
                        solver=dataclasses.replace(
                            cfg.solver,
                            stokes_maxiter=4 * cfg.solver.stokes_maxiter,
                            stokes_restart=2 * cfg.solver.stokes_restart,
                        ),
                    )
                    strong_step = make_step(grid, strong_cfg, table,
                                            mesh=mesh)
                new_state, diag, _ = timed_step(strong_step, state)
                diag["retried"] = True
            if not bool(diag["stokes_converged"]):
                diag["warning"] = "stokes solver did not reach tolerance"
        if int(diag.get("markers_dropped", 0)) > 0:
            # capacity overflow bleeds compositional markers at convergent
            # interfaces — surface it instead of silently degrading
            diag["warning"] = (
                f"{int(diag['markers_dropped'])} markers dropped (bucket "
                f"capacity overflow) — raise ModelConfig.marker_capacity "
                f"(currently auto 2*markers_per_cell_dim^2) or enable reseeding"
            )
        state = new_state

        rec = {"step": int(state.step), "time": float(state.time),
               "step_wall_s": step_wall}
        if mesh_tag is not None:
            rec["mesh"] = mesh_tag
        rec.update(diag)
        logger.log(rec)
        diags.append(diag)

        if callback is not None:
            callback(state, diag)
        step_no = int(state.step)
        if out_dir and output_every and step_no % output_every == 0:
            save_fields(os.path.join(out_dir, f"fields_{step_no:06d}.npz"),
                        state, grid)
        if out_dir and plot_every and step_no % plot_every == 0:
            from pylamp_tpu_torch.io.output import plot_fields

            plot_fields(os.path.join(out_dir, f"fields_{step_no:06d}.png"),
                        state, grid)
        if out_dir and checkpoint_every and step_no % checkpoint_every == 0:
            save_checkpoint(os.path.join(out_dir, "checkpoint.npz"), state)
        if step_delay > 0:
            # test hook (fault injection): a deterministic-width window in
            # which a kill signal can land between steps, independent of how
            # fast the step itself runs
            time.sleep(step_delay)

    logger.close()
    return state, diags, grid
