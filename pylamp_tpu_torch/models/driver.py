"""Time-loop driver (port of ``pylamp_tpu/models/driver.py``): the step, or
chunks of steps (``scan_chunk``), plus checkpoint / output / metrics around
it, divergence detection with a stronger-solver retry.

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
from pylamp_tpu_torch.parallel.mesh import shard_state, unshard_state
from pylamp_tpu_torch.models.step import (
    make_multi_step,
    make_step,
    sync_device,
)


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
    shard: bool | None = None,
):
    """Run the model for cfg.time.max_steps (or until max_time) on
    ``device`` (the card unless the caller asks for the CPU).

    ``dtype``: the state's torch dtype; None is float64, as in the
    reference with x64 on (its CLI always turns it on).  float32 runs the
    mixed-precision solves and, on the card, the CUDA kernels.

    ``mesh``: an in-process mesh (``parallel/mesh.py``) for a
    domain-decomposed run on one card, or this rank's distributed mesh
    (``parallel/dist.py``): the step is built with it (the explicit-halo
    operators and per-shard kernels when ``SolverConfig.explicit_halo`` is
    set, the global tensors otherwise), and every metrics line carries
    ``"mesh": "YxX"``.  Under a distributed mesh every rank reads
    ``resume_from`` and computes, rank 0 alone writes metrics, dumps,
    figures and checkpoints, and the ranks meet at a barrier before the
    return.

    ``shard`` (default: under a distributed mesh, which takes nothing
    else) runs the sharded layout (``parallel/mesh.py shard_state``, the
    reference's ``shard_state``): the state is built, or resumed, on the
    host and each process moves only its blocks to ``device``; files
    gather the state to rank 0, which writes them in the one format; every
    metrics line carries ``"layout": "sharded"``.  The returned state is
    then sharded.

    ``on_divergence``: "retry" re-runs a non-converged step once with a
    stronger solver (4x maxiter, 2x restart, built at the first
    divergence) and sets ``diag["retried"]``; "warn" just records it.

    ``profile_phases``: run the per-phase-instrumented step
    (``make_phased_runner``: the device synchronized around interp /
    stokes / energy / advect) and emit ``phase_seconds`` into the metrics
    JSONL.

    ``plot_every``: write a quick-look figure (T, |v|, log eta) every N
    steps into ``out_dir``.

    ``step_delay``: > 0 sleeps that many seconds after each step (per-step
    loop only) — a fault-injection test hook that makes the between-steps
    kill window wide regardless of step speed.

    ``scan_chunk`` > 0 runs that many steps per call
    (``models/step.py make_multi_step``, the reference's ``lax.scan``
    chunks) and reads the diagnostics once per chunk (``_run_scanned``).
    Metrics stay per step; the loop condition is checked between chunks
    only (a chunk may overshoot ``max_steps`` or ``max_time``),
    checkpoint / output / plot cadences are rounded to chunk boundaries,
    and the divergence retry re-runs a whole chunk with the stronger
    solver.  Mutually exclusive with ``profile_phases``.

    Returns (final_state, diagnostics list, grid)."""
    if scan_chunk > 0 and profile_phases:
        raise ValueError("scan_chunk and profile_phases are mutually exclusive")
    mesh_tag = None
    lead = mesh is None or mesh.lead  # the process that writes files
    if mesh is not None:
        if profile_phases:
            raise ValueError("profile_phases is single-device only "
                             "(per-phase host syncs would serialize the mesh)")
        mesh_tag = f"{mesh.my}x{mesh.mx}"
    if shard is None:
        shard = mesh is not None and mesh.distributed
    if shard and mesh is None:
        raise ValueError("shard needs a mesh")

    # the sharded layout builds (and resumes) on the host: no card holds
    # a global field
    grid, table, state = build(cfg, dtype=dtype or torch.float64,
                               device="cpu" if shard else device)
    if resume_from:
        state, _ = load_checkpoint(resume_from, template=state)
    tags = {}
    if mesh_tag is not None:
        tags["mesh"] = mesh_tag
    if shard:
        state = shard_state(state, mesh, device=device)
        tags["layout"] = "sharded"
    files = _Files(out_dir, grid, checkpoint_every, output_every,
                   plot_every, mesh if shard else None, lead)

    if not lead:
        echo = False
    logger = MetricsLogger(
        os.path.join(out_dir, "metrics.jsonl") if out_dir and lead else None,
        echo=echo)
    if scan_chunk > 0:
        try:
            out = _run_scanned(cfg, grid, table, state, files, callback,
                               on_divergence, scan_chunk, logger,
                               mesh=mesh, tags=tags)
        finally:
            logger.close()
        if mesh is not None:
            mesh.barrier()
        return out

    if profile_phases:
        from pylamp_tpu_torch.models.step import make_phased_runner

        step = make_phased_runner(grid, cfg, table)
    else:
        step = make_step(grid, cfg, table, mesh=mesh)
    strong_step = None  # built lazily on first divergence

    diags = []
    tc = cfg.time
    while int(state.step) < tc.max_steps and float(state.time) < tc.max_time:
        new_state, diag, step_wall = _timed(step, state)

        if not bool(diag["stokes_converged"]):
            if on_divergence == "retry":
                if strong_step is None:
                    strong_step = make_step(grid, _strong(cfg), table,
                                            mesh=mesh)
                new_state, diag, _ = _timed(strong_step, state)
                diag["retried"] = True
        _warn(diag)
        state = new_state

        rec = {"step": int(state.step), "time": float(state.time),
               "step_wall_s": step_wall, **tags}
        rec.update(diag)
        logger.log(rec)
        diags.append(diag)

        if callback is not None:
            callback(state, diag)
        files.write(state, 1)
        if step_delay > 0:
            # test hook (fault injection): a deterministic-width window in
            # which a kill signal can land between steps, independent of how
            # fast the step itself runs
            time.sleep(step_delay)

    logger.close()
    if mesh is not None:
        mesh.barrier()
    return state, diags, grid


def _timed(fn, st):
    """``fn(st)`` and its wall seconds, the device synchronized."""
    t0 = time.perf_counter()
    new_st, d = fn(st)
    sync_device(new_st.vx.device)
    return new_st, d, time.perf_counter() - t0


def _strong(cfg: ModelConfig) -> ModelConfig:
    """The divergence retry's solver: 4x maxiter, 2x restart."""
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, stokes_maxiter=4 * cfg.solver.stokes_maxiter,
        stokes_restart=2 * cfg.solver.stokes_restart))


def _warn(diag):
    """A step's ``warning``: a solve short of its tolerance, or markers
    dropped (which wins)."""
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


@dataclasses.dataclass
class _Files:
    """The run's field dumps, figures and checkpoints: ``mesh`` set for
    the sharded layout, whose state every process gathers to rank 0 (one
    collective a field) when a file is due; the ``lead`` process
    writes."""

    out_dir: str | None
    grid: object
    checkpoint_every: int
    output_every: int
    plot_every: int
    mesh: object
    lead: bool

    def write(self, state, chunk: int):
        """The files due at ``state.step``: where ``step % every < chunk``
        (every ``every`` steps for chunk 1, the first chunk boundary at or
        past each multiple of ``every`` otherwise)."""
        if not self.out_dir:
            return
        s = int(state.step)
        due = [every and s % every < chunk for every in (
            self.output_every, self.plot_every, self.checkpoint_every)]
        if not any(due):
            return
        if self.mesh is not None:
            state = unshard_state(state, self.mesh, root=0)
        if not self.lead:
            return
        out_dir, grid = self.out_dir, self.grid
        if due[0]:
            save_fields(os.path.join(out_dir, f"fields_{s:06d}.npz"), state,
                        grid)
        if due[1]:
            from pylamp_tpu_torch.io.output import plot_fields

            plot_fields(os.path.join(out_dir, f"fields_{s:06d}.png"), state,
                        grid)
        if due[2]:
            save_checkpoint(os.path.join(out_dir, "checkpoint.npz"), state)


def _run_scanned(cfg, grid, table, state, files, callback, on_divergence,
                 scan_chunk, logger, mesh=None, tags=None):
    """The chunked time loop (port of the reference's ``_run_scanned``):
    ``scan_chunk`` steps per ``make_multi_step`` call, the loop condition,
    the retry, the callback and the outputs once per chunk.  Each step's
    record holds what the per-step loop writes for it (its ``time``
    accumulated in the state's dtype, as the step does), except
    ``step_wall_s``: the chunk's wall seconds over ``scan_chunk``."""
    multi = make_multi_step(grid, cfg, table, scan_chunk, mesh=mesh)
    strong_multi = None  # built lazily on first divergence

    diags = []
    tc = cfg.time
    while int(state.step) < tc.max_steps and float(state.time) < tc.max_time:
        new_state, chunk, chunk_wall = _timed(multi, state)
        if not chunk["stokes_converged"].all() and on_divergence == "retry":
            if strong_multi is None:
                strong_multi = make_multi_step(grid, _strong(cfg), table,
                                               scan_chunk, mesh=mesh)
            new_state, chunk, chunk_wall = _timed(strong_multi, state)

        base_step, t = int(state.step), state.time
        for i in range(scan_chunk):
            diag = {k: (v[i] if torch.is_tensor(v) else v[i].item())
                    for k, v in chunk.items()}
            _warn(diag)
            t = t + diag["dt"]
            rec = {"step": base_step + i + 1, "time": float(t),
                   "step_wall_s": chunk_wall / scan_chunk, **(tags or {})}
            rec.update(diag)
            logger.log(rec)
            diags.append(diag)
        state = new_state

        if callback is not None:
            callback(state, diags[-1])
        files.write(state, scan_chunk)

    return state, diags, grid
