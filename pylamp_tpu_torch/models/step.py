"""One model timestep (port of ``pylamp_tpu/models/step.py``):

    marker props -> marker->grid -> Stokes solve -> dt (Courant)
    -> implicit energy solve (+ shear / adiabatic heating) + marker T
    update (optional subgrid diffusion) -> RK4 advection -> rebucket
    (-> optional reseeding of starved cells)

Both marker engines step: the bucket engine (below) and the flat engine
(``markers/state.py MarkerState``, ``marker_engine="flat"``), which
interpolates stream by stream through ``markers/interp.py`` (no kernel:
the reference's flat engine has none), advects with ``markers/advect.py``
and reseeds by moving markers (``markers/reseed.py reseed_starved``); on a
mesh its markers stay on the global tensors, as the reference's.  The
Stokes preconditioner is the multigrid or, with
``preconditioner="jacobi"``, the block-Jacobi of the Stokes solver.

The step keeps the reference's static kernel gates: with an f32 state on a
uniform grid the marker->grid transfer, the advection and the rebucket run
through the kernel wrappers of ``markers/kernels`` (CUDA kernels on a CUDA
state, their plain versions on a CPU state), and the mixed-precision Stokes
solve applies its f32 outer operator through ``ops/kernels/saddle.py`` and
its MG preconditioner through the fused smoother and coarse sub-V-cycle
(``ops/kernels/cheb.py``, ``ops/kernels/coarse_vcycle.py``) and, with
``use_pallas``, the momentum kernel (``ops/kernels/momentum.py``).  The
augmented Lagrangian, the inner velocity FGMRES, the MG eta cap and
power-iteration Chebyshev bounds (the sticky-air preset) are ported, and
so are periodic side walls on one device: every phase and kernel takes
its wrapped form (the fused coarse sub-V-cycle stays off there, as in the
reference).  An f64
state takes the plain functions, as the reference's f64 state skips its
Pallas kernels.  A stretched grid fails every gate (the kernels divide by
the scalar dx, dy), as in the reference: it interpolates stream by stream
(``bucket_markers_to_grid``: eta on the corners and centers, rho on the
velocity lattices, and in the energy phase T, k, rho*Cp, H and rho0 *
alpha on the corners), and advects and rebuckets with the tensor
functions; the MG takes power-iteration Chebyshev bounds on its
non-uniform levels, refreshed every ``mg_lam_refresh_every`` steps, and
the Jacobi and line smoothers (``mg_smoother``, ``energy_mg_smoother``)
run on any grid.  Every solver option of the reference is ported: the
w-BFBT Schur surrogate (``schur="wbfbt"``, solvers/bfbt.py), the coupled
Braess-Sarazin multigrid (``preconditioner="vanka"``, solvers/vanka.py,
tensor code: no MG kernel runs under it), the MG's scaled transfers and
line-search damping (``mg_scaled_transfers``, ``mg_ls_damp``; the fused
coarse sub-V-cycle stays off under either, as in the reference).

``mesh`` (the in-process mesh of parallel/mesh.py, or a rank's
distributed mesh of parallel/dist.py) with ``SolverConfig.explicit_halo``
runs the step domain-decomposed (in-process: on one card):
every Stokes and energy operator apply through the explicit-halo operators
(the f32 outer applies through the per-shard saddle kernel), the MG levels
through the per-shard fused smoother, and the marker transfers, advection
and rebucket through the explicit-halo marker engine with its per-shard
kernels (parallel/halo_*.py); the single-device saddle, smoother and
coarse-cycle kernels are off there, as in the reference.  Under periodic
side walls the operators take their ring exchanges and seam rows (the
per-shard saddle kernel still runs each shard's stencil) and the
per-shard smoother stays off, as in the reference; on the global layout
the markers stay on the global tensors with the periodic forms of the
single-device marker kernels (the reference has no wrap-around path for
its marker engine), and on the sharded layout the engine's wrap-around
exchange keeps them on their shards with the periodic forms of the
per-shard kernels (10p-12p, port-only).  A stretched grid
on the mesh runs on the global tensors: every halo gate refuses a
non-uniform grid, as the reference's do.  The thermal
branches (shear and adiabatic heating, subgrid diffusion, reseeding, the
energy multigrid with flexible CG) run on every path; adiabatic heating's
rho0 * alpha corner field comes from the fused transfer's ``c_ra`` stream
(kernel 2, or kernel 10 on the mesh), and the one-stream transfers of
subgrid diffusion and the reseeding majority vote take the explicit-halo
engine on the mesh.  With
``explicit_halo=False`` a mesh changes nothing: the step runs on the global
tensors, the single-device step, which is what the reference's GSPMD
partitioning computes.

The step takes the state in either layout of parallel/mesh.py: global
tensors (the single-device step, and the in-process mesh for every
configuration), or sharded (``shard_state``: each shard its blocks of the
fields and the markers), which a distributed mesh requires.  On the
sharded layout every phase runs on the blocks: the marker engine keeps
each shard's markers, the solves run on the sharded vectors with mesh
dots, dt and the diagnostics are mesh reductions (``vmax`` and dt mesh
maxima, exact), and nothing is gathered but the replicated MG levels.  It
covers a uniform grid, walled or with periodic side walls, static or
moving walls, the bucket engine, the Chebyshev MG with the mass Schur
surrogate, and the energy solve with Jacobi-CG or the Chebyshev energy
multigrid with flexible CG, with the thermal switches: shear and
adiabatic heating (block forms in parallel/block_ops.py, rho0 * alpha
from kernel 10's stream), subgrid diffusion (the explicit-halo
one-stream transfers on the marker blocks), reseeding (each shard spawns
on its own cells) and prescribed heat fluxes (``sharded_refusal``);
anything else raises, naming ROADMAP item 19c.

``make_phased_runner`` is the same step with the device synchronized
around each phase, for the driver's ``profile_phases``;
``make_multi_step`` runs n steps in one call with stacked diagnostics,
for the driver's ``scan_chunk``.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import (
    BucketedMarkers,
    bucket_advect_rk4,
    bucket_grid_to_markers,
    bucket_markers_to_grid,
    bucket_reseed,
    rebucket,
)
from pylamp_tpu_torch.markers.advect import advect_rk4
from pylamp_tpu_torch.markers.interp import grid_to_markers, markers_to_grid
from pylamp_tpu_torch.markers.kernels.advect import advect_rk4_fused
from pylamp_tpu_torch.markers.kernels.m2g import m2g_fused, m2g_fused_plain
from pylamp_tpu_torch.markers.kernels.rebucket import rebucket_fused
from pylamp_tpu_torch.markers.reseed import reseed_starved
from pylamp_tpu_torch.markers.state import MarkerState
from pylamp_tpu_torch.models.config import ModelConfig
from pylamp_tpu_torch.models.state import ModelState
from pylamp_tpu_torch.parallel import block_ops
from pylamp_tpu_torch.parallel.blocks import Blocks
from pylamp_tpu_torch.parallel.blocks import zeros as zeros_blocks
from pylamp_tpu_torch.parallel.mesh import is_sharded
from pylamp_tpu_torch.parallel.halo_markers import (
    advect_rk4_halo,
    block_kernel_eligible,
    g2m_halo,
    halo_markers_eligible,
    m2g_fused_halo,
    m2g_halo,
    rebucket_halo,
    reseed_halo,
)
from pylamp_tpu_torch.physics.heating import adiabatic_heating, shear_heating
from pylamp_tpu_torch.physics.materials import MaterialTable
from pylamp_tpu_torch.solvers.energy_solver import (
    solve_energy,
    solve_energy_mixed,
)
from pylamp_tpu_torch.solvers.mg import (
    estimate_mg_lambdas,
    make_mg_preconditioner,
)
from pylamp_tpu_torch.solvers.scaling import (
    characteristic_viscosity,
    stokes_scales,
)
from pylamp_tpu_torch.solvers.stokes_solver import (
    solve_stokes,
    solve_stokes_mixed,
)
from pylamp_tpu_torch.solvers.vanka import make_vanka_mg_preconditioner


class InterpOut(NamedTuple):
    """Marker->grid phase products consumed by the later phases."""

    eta_s: Any
    eta_n: Any
    rho_vx: Any
    rho_vy: Any
    k_m: Any  # marker conductivity (dt cap)
    rhocp_m: Any  # marker rho*Cp
    H_m: Any = None  # marker heating (the per-stream energy fields)
    T_old_g: Any = None
    k_g: Any = None
    rhocp_g: Any = None
    H_g: Any = None
    ra_g: Any = None  # rho0 * alpha on the corner lattice (adiabatic heating)


class StepPhases(NamedTuple):
    interp: Callable  # (state) -> InterpOut
    stokes: Callable  # (state, InterpOut) -> (vx, vy, p, diag)
    energy: Callable  # (state, InterpOut, vx, vy, dt) -> (markers, T_new, diag)
    advect: Callable  # (markers, vx, vy, dt, T_new) -> (markers, diag)
    timestep: Callable  # (vx, vy, k_m, rhocp_m) -> dt


def _check_slice(cfg: ModelConfig):
    """Raise on a configuration the step does not know."""
    solver = cfg.solver
    if solver.preconditioner not in ("mg", "jacobi", "vanka"):
        raise ValueError(f"unknown preconditioner {solver.preconditioner!r}")


def marker_halo_gate(grid: StaggeredGrid, halo_mesh, periodic: bool,
                     sharded: bool = False):
    """The mesh of the explicit-halo marker engine, or None where the
    markers run on the global tensors: no explicit-halo mesh, blocks the
    engine does not take (a stretched grid among them), as in the
    reference, or periodic side walls on the global layout (the
    reference's engine has no wrap-around exchange; the port's global
    layout keeps the markers on the global tensors with the periodic forms
    of kernels 2-4).  On the sharded layout (``sharded``) periodic side
    walls take the engine's wrap-around exchange (kernels 10p-12p), so
    that each shard keeps only its own markers: port-only, as no reference
    path shards the markers under periodic walls."""
    if halo_mesh is None or (periodic and not sharded) \
            or not halo_markers_eligible(grid, halo_mesh):
        return None
    return halo_mesh


def sharded_refusal(grid: StaggeredGrid, cfg: ModelConfig, mesh):
    """Why the sharded layout does not take ``cfg`` on ``mesh`` (None
    where it does): its covered set is a uniform grid, walled or with
    periodic side walls, static or moving walls, the bucket engine, the
    Chebyshev MG with the mass Schur surrogate and Gershgorin bounds, full
    coarsening, and the energy solve (Jacobi-CG, or the Chebyshev energy
    multigrid with flexible CG) with shear and adiabatic heating, subgrid
    diffusion, reseeding and prescribed heat fluxes.  The rest is ROADMAP
    item 19c."""
    from pylamp_tpu_torch.solvers.mg import coarsening_plan

    phys, solver = cfg.physics, cfg.solver
    energy_mg = phys.solve_energy and solver.energy_preconditioner == "mg"
    reasons = (
        (not solver.explicit_halo, "explicit_halo off"),
        (not grid.uniform, "a stretched grid"),
        (cfg.marker_engine != "bucket", "flat markers"),
        (grid.uniform and not halo_markers_eligible(grid, mesh),
         "blocks that do not divide the grid into 4x4 cells or more"),
        (solver.preconditioner == "vanka", "the Vanka multigrid"),
        (solver.preconditioner != "mg" or solver.mg_smoother != "chebyshev",
         f"the {solver.preconditioner}/{solver.mg_smoother} preconditioner"),
        (solver.schur != "mass", "the w-BFBT Schur surrogate"),
        (solver.stokes_al_gamma > 0 or solver.mg_velocity_inner_iters > 0
         or solver.mg_eta_cap > 0, "the sticky-air augmented Lagrangian"),
        (solver.mg_scaled_transfers or solver.mg_ls_damp,
         "scaled MG transfers / line-search damping"),
        (solver.mg_lam_mode != "gershgorin",
         "power-iteration Chebyshev bounds"),
        (grid.uniform and any(step != (True, True) for levels in (
            solver.mg_levels, *((0,) if energy_mg else ()))
            for step in coarsening_plan(
                grid, levels, semi_threshold=solver.mg_semicoarsen)),
         "semicoarsening"),
        (energy_mg and solver.energy_mg_smoother != "chebyshev",
         "the energy multigrid's line smoothers"),
    )
    for refused, what in reasons:
        if refused:
            return (f"the sharded layout does not take {what} yet "
                    "(ROADMAP item 19c)")
    return None


def _marker_mean(markers, vals):
    if isinstance(markers, MarkerState):
        return torch.mean(vals)
    w = markers.valid
    return (torch.sum(torch.where(w, vals, 0.0))
            / torch.clamp(torch.sum(w.to(vals.dtype)), min=1.0))


def make_step_phases(grid: StaggeredGrid, cfg: ModelConfig,
                     table: MaterialTable, mesh=None) -> StepPhases:
    """``mesh``: the mesh of a domain-decomposed run, in-process or this
    rank's distributed one (module docstring); the gates read its global
    shape (``my``, ``mx``)."""
    phys, solver, tc = cfg.physics, cfg.solver, cfg.time
    vbc, tbc = phys.velocity_bcs, phys.thermal_bcs
    if tc.courant > 1.0:
        # the 3x3 rebucketing and the RK4 shift windows assume markers
        # move at most one cell per step
        raise ValueError("TimeConfig.courant must be <= 1")
    _check_slice(cfg)
    periodic = vbc.periodic_x
    if phys.solve_energy and periodic != tbc.periodic_x:
        raise ValueError(
            "periodic side walls must be set on BOTH the velocity and "
            "thermal BCs (the domain either wraps in x or it doesn't)")
    if not grid.uniform and periodic:
        raise ValueError("periodic side walls need a uniform grid")

    # the sharded layout's covered set: a distributed mesh runs nothing
    # else; the in-process mesh checks it when it is handed a sharded state
    refusal = None if mesh is None else sharded_refusal(grid, cfg, mesh)
    if refusal is not None and mesh.distributed:
        raise ValueError(refusal)

    # explicit halo exchanges for the operator applies, and the marker halo
    # engine where the bucket blocks are eligible
    halo_mesh = mesh if (mesh is not None and solver.explicit_halo) else None

    def marker_mesh(m):
        """The explicit-halo marker engine's mesh for markers ``m`` (on the
        sharded layout under periodic walls too), or None."""
        return marker_halo_gate(grid, halo_mesh, periodic,
                                isinstance(m.x, Blocks))

    # the per-shard marker kernels' shape gate
    marker_blocks = (halo_mesh is not None and block_kernel_eligible(
        grid.ny // halo_mesh.my, grid.nx // halo_mesh.mx))
    # the fused transfer's rho0 * alpha stream
    with_ra = phys.adiabatic_heating and phys.solve_energy

    # the one-stream marker transfers (subgrid diffusion, marker T update):
    # the flat engine's, or the explicit-halo engine under the marker halo
    # mesh
    def _disp_m2g(m, vals, loc, mode):
        if isinstance(m, MarkerState):
            return markers_to_grid(m.x, m.y, vals, grid, loc, mode,
                                   periodic_x=periodic)
        if marker_mesh(m) is not None:
            return m2g_halo(m, vals, grid, loc, mode, halo_mesh, periodic)
        return bucket_markers_to_grid(m, vals, grid, loc, mode,
                                      periodic_x=periodic)

    def _disp_g2m(m, field, loc):
        if isinstance(m, MarkerState):
            return grid_to_markers(field, m.x, m.y, grid, loc,
                                   periodic_x=periodic)
        if marker_mesh(m) is not None:
            return g2m_halo(field, m.x, m.y, m.valid, grid, loc, halo_mesh,
                            periodic_x=periodic)
        return bucket_grid_to_markers(field, m.x, m.y, m.valid, grid, loc,
                                      periodic_x=periodic)

    def _disp_interp_fb(m, vals, loc, mode, fallback):
        field, wsum = _disp_m2g(m, vals, loc, mode)
        return torch.where(wsum > 0, field, fallback)

    # preconditioner="jacobi": the solver's default block-Jacobi
    make_precond = None
    if solver.preconditioner == "mg":
        make_precond = partial(
            make_mg_preconditioner,
            levels=solver.mg_levels,
            cycles=solver.mg_cycles,
            pre_smooth=solver.mg_pre_smooth,
            post_smooth=solver.mg_post_smooth,
            smoother=solver.mg_smoother,
            omega=solver.mg_omega,
            scaled_transfers=solver.mg_scaled_transfers,
            ls_damp=solver.mg_ls_damp,
            semicoarsen=solver.mg_semicoarsen,
            schur=solver.schur,
            schur_poisson_iters=solver.schur_poisson_iters,
            velocity_inner_iters=solver.mg_velocity_inner_iters,
            velocity_inner_tol=solver.mg_velocity_inner_tol,
            eta_cap=solver.mg_eta_cap,
            al_gamma=solver.stokes_al_gamma,
            halo_mesh=halo_mesh,
            coarse_replicate=solver.mg_coarse_replicate,
        )
    elif solver.preconditioner == "vanka":
        if solver.mg_semicoarsen > 0:
            # the Vanka hierarchy coarsens both axes: a stretched or
            # anisotropic grid would lose the semicoarsening remedy
            raise ValueError(
                "preconditioner='vanka' does not support mg_semicoarsen "
                "(full coarsening only); use preconditioner='mg' with "
                "mg_semicoarsen, or mg_smoother='line' for anisotropic "
                "cells")
        make_precond = partial(
            make_vanka_mg_preconditioner,
            levels=solver.mg_levels,
            cycles=solver.mg_cycles,
            pre_smooth=solver.mg_pre_smooth,
            post_smooth=solver.mg_post_smooth,
        )

    def _mixed(dtype):
        return solver.precision == "mixed" or (
            solver.precision == "auto" and dtype == torch.float32)

    def _kernels(dtype):
        """The reference's static kernel gate: f32 on a uniform grid (every
        kernel divides by the scalar dx, dy).  Under the explicit-halo mesh
        the same switches select the per-shard kernels."""
        return dtype == torch.float32 and grid.uniform

    # ---- phase 1: marker rheology + marker -> grid ------------------------
    def interp(state: ModelState) -> InterpOut:
        if is_sharded(state):
            if refusal is not None:
                raise ValueError(refusal)
        elif mesh is not None and mesh.distributed:
            raise TypeError("a distributed mesh steps the sharded layout "
                            "only (parallel/mesh.py shard_state)")
        m = state.markers
        dtype = m.x.dtype
        rho_m = table.density(m.mat, m.T)
        k_m = table.conductivity(m.mat, dtype)
        rhocp_m = table.rho_cp(m.mat, m.T)
        kern = solver.use_pallas_m2g and _kernels(dtype)
        if not grid.uniform or isinstance(m, MarkerState):
            return _interp_streams(m, rho_m, k_m, rhocp_m, state)
        if marker_mesh(m) is not None:
            out = m2g_fused_halo(m, grid, table, phys, halo_mesh,
                                 with_energy=phys.solve_energy,
                                 with_ra=with_ra,
                                 kernel=kern and marker_blocks,
                                 periodic_x=periodic)
        else:
            m2g = m2g_fused if kern else m2g_fused_plain
            out = m2g(m, grid, table, phys, with_energy=phys.solve_energy,
                      periodic_x=periodic, with_ra=with_ra)
        return _interp_fused(m, rho_m, k_m, rhocp_m, state, out)

    def _interp_streams(m, rho_m, k_m, rhocp_m, state) -> InterpOut:
        """The reference's per-stream transfers (the flat engine's path, and
        the bucket engine's wherever the fused transfer's gate fails): eta
        on the corners and centers, rho on the velocity lattices; the
        energy phase interpolates its corner fields itself."""
        eta_m = torch.clamp(table.viscosity_of(m.mat, m.T), phys.eta_min,
                            phys.eta_max)
        eta_s = _disp_interp_fb(m, eta_m, "corner", phys.eta_avg, state.eta_s)
        eta_n = _disp_interp_fb(m, eta_m, "center", phys.eta_avg, state.eta_n)
        rho_mean = _marker_mean(m, rho_m)
        rho_vy = _disp_interp_fb(m, rho_m, "vy", "arithmetic", rho_mean)
        if phys.gx != 0.0:
            rho_vx = _disp_interp_fb(m, rho_m, "vx", "arithmetic", rho_mean)
        else:
            rho_vx = torch.zeros(grid.shape_vx, dtype=m.x.dtype,
                                 device=m.x.device)
        return InterpOut(eta_s, eta_n, rho_vx, rho_vy, k_m, rhocp_m,
                         table.heating(m.mat, m.x.dtype))

    def _interp_fused(m, rho_m, k_m, rhocp_m, state, out) -> InterpOut:
        """Grid fields from the raw weighted sums (shared by the kernel and
        its plain version); starved nodes keep their fallback."""
        dtype = m.x.dtype

        def mean_of(wv, w, fallback):
            return torch.where(w > 0, wv / torch.where(w == 0, 1.0, w),
                               fallback)

        def eta_of(wv, w, fallback):
            mean = wv / torch.where(w == 0, 1.0, w)
            if phys.eta_avg == "geometric":
                mean = torch.exp(mean)
            elif phys.eta_avg == "harmonic":
                mean = 1.0 / torch.where(mean == 0, 1.0, mean)
            return torch.where(w > 0, mean, fallback)

        eta_s = eta_of(out["c_eta"], out["c_w"], state.eta_s)
        eta_n = eta_of(out["n_eta"], out["n_w"], state.eta_n)
        rho_vy = mean_of(out["vy_rho"], out["vy_w"], _marker_mean(m, rho_m))
        if phys.gx != 0.0:
            rho_vx = mean_of(out["vx_rho"], out["vx_w"],
                             _marker_mean(m, rho_m))
        elif isinstance(eta_n, Blocks):
            rho_vx = zeros_blocks(eta_n.mesh, "vx", eta_n)
        else:
            rho_vx = torch.zeros(grid.shape_vx, dtype=dtype,
                                 device=m.x.device)

        T_old_g = k_g = rhocp_g = H_g = ra_g = None
        if phys.solve_energy:
            cw = out["c_w"]
            T_old_g = mean_of(out["c_T"], cw, state.T)
            k_g = mean_of(out["c_k"], cw, _marker_mean(m, k_m))
            rhocp_g = mean_of(out["c_rhocp"], cw, _marker_mean(m, rhocp_m))
            if "c_H" in out:
                H_g = mean_of(out["c_H"], cw,
                              torch.zeros((), dtype=dtype, device=m.x.device))
            elif isinstance(cw, Blocks):
                H_g = zeros_blocks(cw.mesh, "corner", cw)
            else:
                H_g = torch.zeros(grid.shape_corner, dtype=dtype,
                                  device=m.x.device)
            if with_ra:  # rho0 * alpha: adiabatic heating's coefficient
                ra_m = (table._select(table.rho0, m.mat, dtype)
                        * table._select(table.alpha, m.mat, dtype))
                ra_g = mean_of(out["c_ra"], cw, _marker_mean(m, ra_m))
        return InterpOut(eta_s, eta_n, rho_vx, rho_vy, k_m, rhocp_m, None,
                         T_old_g, k_g, rhocp_g, H_g, ra_g)

    def mg_lambdas(state: ModelState, io: InterpOut, wdtype):
        """Per-level Chebyshev bounds for this step's solve, warm-started
        across steps through ``state.mg_lam``: the Gershgorin bound every
        step (uniform grids), or power iteration refreshed every
        ``mg_lam_refresh_every`` steps (and while the carried bound is
        unset), the carried bound otherwise.  The power mode's decision
        reads the host once per step.  None without a carried bound or a
        Chebyshev smoother: make_velocity_mg then runs its own power
        iteration (Chebyshev) or needs none."""
        if (solver.mg_smoother != "chebyshev" or state.mg_lam is None
                or state.mg_lam.shape[0] == 0):
            return None
        es_w, en_w = io.eta_s.to(wdtype), io.eta_n.to(wdtype)
        _, kbnd_w = stokes_scales(characteristic_viscosity(en_w), grid)
        if solver.mg_lam_mode == "gershgorin" and grid.uniform:
            return estimate_mg_lambdas(
                es_w, en_w, grid, vbc, kbnd_w, levels=solver.mg_levels,
                semicoarsen=solver.mg_semicoarsen, mode="gershgorin",
                coarse_replicate=solver.mg_coarse_replicate)
        hint = state.mg_lam.to(wdtype)
        step_h, hint0 = torch.stack(
            [state.step.to(torch.float64), hint[0].to(torch.float64)]).tolist()
        if step_h % solver.mg_lam_refresh_every == 0 or hint0 <= 0:
            return estimate_mg_lambdas(
                es_w, en_w, grid, vbc, kbnd_w, levels=solver.mg_levels,
                semicoarsen=solver.mg_semicoarsen, hint=state.mg_lam)
        return hint

    # ---- phase 2: Stokes solve (warm-started) ------------------------------
    def stokes(state: ModelState, io: InterpOut):
        dtype = state.markers.x.dtype
        mixed = _mixed(dtype)
        lam_new = None
        mk = make_precond
        if solver.preconditioner == "mg":
            lam_new = mg_lambdas(state, io,
                                 torch.float32 if mixed else dtype)
            kern = _kernels(dtype)
            mk = partial(make_precond, lam_max=lam_new,
                         use_pallas=solver.use_pallas and kern,
                         use_pallas_smoother=(solver.use_pallas_smoother
                                              and kern),
                         use_pallas_coarse=solver.use_pallas_coarse and kern)
        x0 = (state.vx, state.vy, state.p)
        if mixed:
            sol = solve_stokes_mixed(
                io.eta_s, io.eta_n, io.rho_vx, io.rho_vy, phys.gx, phys.gy,
                grid, vbc, tol=solver.stokes_tol, inner_tol=solver.inner_tol,
                restart=solver.stokes_restart, maxiter=solver.stokes_maxiter,
                max_refinements=solver.max_refinements, x0=x0,
                make_preconditioner=mk,
                use_pallas_apply=solver.use_pallas_apply,
                al_gamma=solver.stokes_al_gamma, halo_mesh=halo_mesh)
        else:
            # as in the reference: the plain-precision solve takes no
            # al_gamma, so an AL-built preconditioner wraps the
            # un-augmented operator here
            sol = solve_stokes(
                io.eta_s, io.eta_n, io.rho_vx, io.rho_vy, phys.gx, phys.gy,
                grid, vbc, tol=solver.stokes_tol,
                restart=solver.stokes_restart, maxiter=solver.stokes_maxiter,
                x0=x0, make_preconditioner=mk, halo_mesh=halo_mesh)
        vx, vy, p = sol.vx.to(dtype), sol.vy.to(dtype), sol.p.to(dtype)
        tiny = torch.finfo(torch.float64 if mixed else dtype).tiny
        diag = {
            "stokes_iterations": sol.info.iterations,
            "stokes_residual": sol.info.residual,
            "stokes_residual_rel": sol.info.residual
            / max(sol.info.bnorm, tiny),
            "stokes_converged": sol.info.converged,
            "vmax": torch.maximum(torch.max(torch.abs(vx)),
                                  torch.max(torch.abs(vy))),
            "vrms": block_ops.vrms(vx, vy) if isinstance(vx, Blocks)
            else torch.sqrt(torch.mean(
                (0.5 * (vx[:, 1:] + vx[:, :-1])) ** 2
                + (0.5 * (vy[1:, :] + vy[:-1, :])) ** 2)),
        }
        if lam_new is not None:
            # carried into the next ModelState by make_step
            diag["_mg_lam"] = lam_new.to(state.mg_lam.dtype)
        return vx, vy, p, diag

    # ---- dt selection (Courant + optional diffusion cap) --------------------
    def timestep(vx, vy, k_m, rhocp_m):
        dtype = vx.dtype
        vxmax = torch.max(torch.abs(vx))
        vymax = torch.max(torch.abs(vy))
        big = torch.tensor(torch.finfo(dtype).max / 4, dtype=dtype,
                           device=vx.device)
        dt_adv = tc.courant * torch.minimum(
            torch.where(vxmax > 0, grid.dx_min / vxmax, big),
            torch.where(vymax > 0, grid.dy_min / vymax, big),
        )
        dt = torch.clamp(dt_adv, max=tc.dt_max)
        if tc.dt_diff_factor != float("inf") and phys.solve_energy:
            kappa_max = torch.max(k_m / rhocp_m)
            dt_diff = (tc.dt_diff_factor * min(grid.dx_min, grid.dy_min) ** 2
                       / kappa_max)
            dt = torch.minimum(dt, dt_diff)
        return torch.clamp(dt, min=tc.dt_min)

    # ---- phase 3: energy solve + marker temperature update ------------------
    def energy(state: ModelState, io: InterpOut, vx, vy, dt):
        m = state.markers
        dtype = m.x.dtype
        diag: Dict[str, Any] = {}
        if not phys.solve_energy:
            return m, state.T, diag
        ra_g = io.ra_g
        if io.T_old_g is not None:  # from the fused transfer
            T_old, k_g, rhocp_g, H_g = io.T_old_g, io.k_g, io.rhocp_g, io.H_g
        else:  # stream by stream (flat markers, a stretched grid)
            def corner(vals, fallback):
                return _disp_interp_fb(m, vals, "corner", "arithmetic",
                                       fallback)

            T_old = corner(m.T, state.T)
            k_g = corner(io.k_m, _marker_mean(m, io.k_m))
            rhocp_g = corner(io.rhocp_m, _marker_mean(m, io.rhocp_m))
            H_g = corner(io.H_m, torch.zeros((), dtype=dtype,
                                             device=m.x.device))
            if phys.adiabatic_heating:
                ra_m = (table._select(table.rho0, m.mat, dtype)
                        * table._select(table.alpha, m.mat, dtype))
                ra_g = corner(ra_m, _marker_mean(m, ra_m))
        if phys.shear_heating:
            H_g = H_g + shear_heating(vx, vy, io.eta_n, grid, vbc)
        if phys.adiabatic_heating:
            H_g = H_g + adiabatic_heating(T_old, ra_g, vy, phys.gy, grid)
        solve = solve_energy_mixed if _mixed(dtype) else solve_energy
        esol = solve(T_old, k_g, rhocp_g / dt, H_g, grid, tbc,
                     tol=solver.energy_tol, maxiter=solver.energy_maxiter,
                     k_avg=phys.k_face_avg,
                     preconditioner=solver.energy_preconditioner,
                     halo_mesh=halo_mesh,
                     mg_smoother=solver.energy_mg_smoother,
                     mg_omega=solver.mg_omega,
                     mg_semicoarsen=solver.mg_semicoarsen)
        T_new = esol.T.to(dtype)
        if phys.subgrid_diffusion_d > 0.0:
            # Gerya-style subgrid diffusion: relax marker T toward the old
            # grid T on the cell-diffusion timescale, then remap only the
            # remaining part of dT
            T_node_at_m = _disp_g2m(m, T_old, "corner")
            t_diff = io.rhocp_m / (
                io.k_m * (2.0 / grid.dx_min ** 2 + 2.0 / grid.dy_min ** 2))
            relax = 1.0 - torch.exp(-phys.subgrid_diffusion_d * dt / t_diff)
            dT_sub_m = (T_node_at_m - m.T) * relax
            dT_sub_g, wsub = _disp_m2g(m, dT_sub_m, "corner", "arithmetic")
            dT_sub_g = torch.where(wsub > 0, dT_sub_g, 0.0)
            dT_rem = (T_new - T_old) - dT_sub_g
            T_m = m.T + dT_sub_m + _disp_g2m(m, dT_rem, "corner")
        else:
            T_m = m.T + _disp_g2m(m, T_new - T_old, "corner")
        diag["energy_iterations"] = esol.info.iterations
        diag["energy_converged"] = esol.info.converged
        diag["T_mean"] = torch.mean(T_new)
        return m.replace(T=T_m), T_new, diag

    def advect_flat(markers, vx, vy, dt, T_new):
        """RK4 on the flat markers, then (optionally) markers moved into
        starved cells; the flat engine drops none and reports nothing."""
        px, py = advect_rk4(markers.x, markers.y, vx, vy, dt, grid, vbc)
        markers = markers.replace(x=px, y=py)
        if phys.reseed_min_per_cell > 0:
            markers = reseed_starved(
                markers, T_new, grid, n_materials=len(table),
                min_per_cell=phys.reseed_min_per_cell,
                max_moves=phys.reseed_max_moves, periodic_x=periodic)
        return markers, {}

    # ---- phase 4: advect markers + re-bucket --------------------------------
    def advect(markers, vx, vy, dt, T_new):
        if isinstance(markers, MarkerState):
            return advect_flat(markers, vx, vy, dt, T_new)
        dtype = markers.x.dtype
        moving_walls = any(
            getattr(vbc, f) != 0.0
            for f in ("vt_top", "vt_bottom", "vt_left", "vt_right"))
        # Courant <= 0.5 (and static walls) bounds every RK stage
        # displacement to half a cell
        reach = 1 if (tc.courant <= 0.5 and tc.dt_min == 0.0
                      and not moving_walls) else 2
        kern = _kernels(dtype)
        mh = marker_mesh(markers)
        if mh is not None:
            markers = advect_rk4_halo(
                markers, vx, vy, dt, grid, vbc, mh, stage_reach=reach,
                kernel=solver.use_pallas_advect and kern and marker_blocks)
            # the per-shard repack's gate also takes the capacity
            markers, dropped = rebucket_halo(
                markers, grid, mh,
                kernel=kern and block_kernel_eligible(
                    grid.ny // mh.my, grid.nx // mh.mx, markers.capacity),
                periodic_x=periodic)
        else:
            if solver.use_pallas_advect and kern:
                markers = advect_rk4_fused(markers, vx, vy, dt, grid, vbc,
                                           stage_reach=reach)
            else:
                markers = bucket_advect_rk4(markers, vx, vy, dt, grid, vbc,
                                            stage_reach=reach)
            if kern:
                markers, dropped = rebucket_fused(markers, grid, periodic)
            else:
                markers, dropped = rebucket(markers, grid, periodic)
        # the count after rebucket, before reseeding (as the reference)
        diag = {"markers_dropped": dropped, "marker_count": markers.total()}
        if phys.reseed_min_per_cell > 0:
            if mh is not None:
                markers = reseed_halo(
                    markers, T_new, grid,
                    min_per_cell=phys.reseed_min_per_cell,
                    n_materials=len(table), mesh=mh, periodic_x=periodic)
            else:
                markers = bucket_reseed(
                    markers, T_new, grid,
                    min_per_cell=phys.reseed_min_per_cell,
                    n_materials=len(table), periodic_x=periodic)
        return markers, diag

    return StepPhases(interp, stokes, energy, advect, timestep)


def _call(name: str, fn: Callable, *args):
    return fn(*args)


def run_step(ph: StepPhases, state: ModelState, timed: Callable = _call
             ) -> Tuple[ModelState, Dict[str, Any]]:
    """One step composed from its phases.  ``timed(name, fn, *args)`` makes
    each phase call (``models/profile.py`` passes one that times them)."""
    io = timed("interp", ph.interp, state)
    vx, vy, p, diag = timed("stokes", ph.stokes, state, io)
    mg_lam = diag.pop("_mg_lam", state.mg_lam)
    dt = timed("timestep", ph.timestep, vx, vy, io.k_m, io.rhocp_m)
    diag["dt"] = dt
    markers, T_new, ediag = timed("energy", ph.energy, state, io, vx, vy, dt)
    diag.update(ediag)
    markers, adiag = timed("advect", ph.advect, markers, vx, vy, dt, T_new)
    diag.update(adiag)
    new_state = state.replace(
        markers=markers, vx=vx, vy=vy, p=p, T=T_new,
        eta_s=io.eta_s, eta_n=io.eta_n,
        time=state.time + dt, step=state.step + 1, dt=dt, mg_lam=mg_lam)
    return new_state, diag


def make_step(grid: StaggeredGrid, cfg: ModelConfig, table: MaterialTable,
              mesh=None):
    """The production step: ``step(state) -> (new_state, diag)``; ``mesh``
    as in ``make_step_phases``."""
    return partial(run_step, make_step_phases(grid, cfg, table, mesh=mesh))


def stack_diags(diags):
    """Per-step (or per-member) diagnostics stacked key by key along a new
    leading axis: tensor values with ``torch.stack`` on their device, the
    host's Python scalars (Krylov counts, residuals, convergence flags)
    as numpy arrays, so that stacking reads nothing from the device and
    ``v[i]`` is again the value one step returned."""
    return {k: (torch.stack([d[k] for d in diags]) if torch.is_tensor(
                diags[0][k]) else np.array([d[k] for d in diags]))
            for k in diags[0]}


def make_multi_step(grid: StaggeredGrid, cfg: ModelConfig,
                    table: MaterialTable, n_steps: int, mesh=None):
    """``n_steps`` production steps in one call (the reference's
    ``lax.scan`` time loop): ``multi(state) -> (state, diags)``, every diag
    value stacked with a leading ``(n_steps,)`` axis (``stack_diags``), so
    that the driver's metrics stay per step.  ``mesh`` as in ``make_step``.

    This is a plain loop over ``make_step``: the host is still read inside
    each step (once per Krylov iteration), and removing those reads is
    ROADMAP item 20.  What it gives is the call, the stacking and a result
    equal bit for bit to ``n_steps`` single steps."""
    step = make_step(grid, cfg, table, mesh=mesh)

    def multi(state: ModelState):
        diags = []
        for _ in range(n_steps):
            state, diag = step(state)
            diags.append(diag)
        return state, stack_diags(diags)

    return multi


def sync_device(device):
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the phases the driver reports in diag["phase_seconds"], as the reference
TIMED_PHASES = ("interp", "stokes", "energy", "advect")


def make_phased_runner(grid: StaggeredGrid, cfg: ModelConfig,
                       table: MaterialTable):
    """Per-phase-instrumented step for profiling.

    Returns ``run(state) -> (new_state, diag)``: ``run_step`` with the
    state's device synchronized before and after each of the phases
    interp, stokes, energy and advect, whose wall-clock seconds it adds
    as ``diag["phase_seconds"]``.  It computes exactly what ``make_step``
    computes (the same phase closures); only for measurement: the syncs
    cost a few ms/step."""
    from pylamp_tpu_torch.utils.profiling import phase

    ph = make_step_phases(grid, cfg, table)

    def run(state: ModelState):
        secs: Dict[str, float] = {}
        device = state.vx.device

        def timed(name, fn, *args):
            if name not in TIMED_PHASES:
                return fn(*args)
            sync_device(device)
            t0 = time.perf_counter()
            with phase(name):
                out = fn(*args)
                sync_device(device)
            secs[name] = time.perf_counter() - t0
            return out

        new_state, diag = run_step(ph, state, timed)
        diag["phase_seconds"] = secs
        return new_state, diag

    return run
