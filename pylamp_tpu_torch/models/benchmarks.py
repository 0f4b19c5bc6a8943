"""Benchmark model configurations and diagnostics.

Port of ``pylamp_tpu/models/benchmarks.py``: its six presets, the
falling block and Blankenbach case 1a (BASELINE configs 1 and 2, the
reference's multi-device dryrun configurations), the falling block with
periodic side walls (``falling_block_periodic``), the Frank-Kamenetskii
stagnant lid (unit box, kappa = 1, eta_ref = 1, DT = 1; rho0*alpha = Ra
with g = 1), the van Keken Rayleigh-Taylor instability (BASELINE config
4) and the sticky-air free surface (BASELINE config 5, SI units), and the
standard diagnostics (Nusselt number, v_rms) used to compare against
published community values.  Beside them, the configurations ``python
bench.py`` builds, switch for switch: ``fk_bench_config`` (its default),
``sticky_air_bench_config`` (``--benchmark sticky_air``) and
``fk_stretched_bench_config`` (``--stretch-y 8``), and
``falling_block_periodic_config``, the periodic preset at nx^2 that the
port's chip check and profiler run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import geometric_edges
from pylamp_tpu_torch.models.config import (
    ModelConfig,
    PhysicsConfig,
    SolverConfig,
    TimeConfig,
)
from pylamp_tpu_torch.physics.materials import Material

KYR = 3.15576e10  # seconds


# -- diagnostics --------------------------------------------------------------

def _wall_gradient_coeffs(h1, h2):
    """2nd-order one-sided derivative coefficients at the wall node for
    node gaps h1 (wall->next) and h2 (next->third)."""
    c0 = -(2.0 * h1 + h2) / (h1 * (h1 + h2))
    c1 = (h1 + h2) / (h1 * h2)
    c2 = -h1 / (h2 * (h1 + h2))
    return c0, c1, c2


def _x_average(f, grid):
    """Trapezoid average of a corner-row quantity over x (stretched-aware)."""
    if grid.uniform:
        w = torch.ones(grid.nx + 1, dtype=f.dtype, device=f.device)
        w[0] = w[-1] = 0.5
        return torch.sum(f * w) / grid.nx
    dxs = torch.as_tensor(grid.dxs, dtype=f.dtype, device=f.device)
    return torch.sum(0.5 * (f[:-1] + f[1:]) * dxs) / grid.lx


def nusselt_top(T, grid):
    """Nu = <dT/dy> at the top wall (y points DOWN, T=0 top / T=1 bottom on
    the unit box, so the conductive profile T=y gives Nu = 1).  One-sided
    2nd-order difference on corner nodes (nonuniform coefficients on a
    stretched grid), trapezoid in x."""
    h1, h2 = float(grid.dys[0]), float(grid.dys[1])
    c0, c1, c2 = _wall_gradient_coeffs(h1, h2)
    dTdy = c0 * T[0, :] + c1 * T[1, :] + c2 * T[2, :]
    return _x_average(dTdy, grid)


def nusselt_bottom(T, grid):
    """Nu at the bottom wall (equals nusselt_top in steady state)."""
    h1, h2 = float(grid.dys[-1]), float(grid.dys[-2])
    c0, c1, c2 = _wall_gradient_coeffs(h1, h2)
    dTdy = -(c0 * T[-1, :] + c1 * T[-2, :] + c2 * T[-3, :])
    return _x_average(dTdy, grid)


def vrms_box(vx, vy):
    """Volume RMS velocity on cell centers."""
    vxc = 0.5 * (vx[:, 1:] + vx[:, :-1])
    vyc = 0.5 * (vy[1:, :] + vy[:-1, :])
    return torch.sqrt(torch.mean(vxc ** 2 + vyc ** 2))


def falling_block(nx=64, ny=64, eta_block=1.0, rho_block=2.0, max_steps=20):
    """Isoviscous dense block sinking in a unit box (BASELINE config 1)."""
    ambient = Material(name="ambient", rho0=1.0, eta0=1.0,
                       viscosity="constant")
    block = Material(name="block", rho0=rho_block, eta0=eta_block,
                     viscosity="constant")

    def material_of(x, y):
        return ((np.abs(x - 0.5) < 0.15)
                & (np.abs(y - 0.25) < 0.15)).astype(np.int32)

    return ModelConfig(
        nx=nx, ny=ny, lx=1.0, ly=1.0,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(ambient, block),
            velocity_bcs=VelocityBCs(),
            solve_energy=False,
            eta_avg="geometric",
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps),
        material_of=material_of,
        name="falling_block",
    )


def falling_block_periodic(nx=64, ny=64, eta_block=1.0, rho_block=2.0,
                           max_steps=20):
    """Falling block with PERIODIC side walls, centered ON the seam (x = 0
    == x = lx): the block is split across the two array edges and must sink
    as one coherent body through the wrap-around."""
    ambient = Material(name="ambient", rho0=1.0, eta0=1.0,
                       viscosity="constant")
    block = Material(name="block", rho0=rho_block, eta0=eta_block,
                     viscosity="constant")

    def material_of(x, y):
        dxp = np.abs(x - 0.0)
        dxp = np.minimum(dxp, 1.0 - dxp)  # periodic x-distance to the seam
        return ((dxp < 0.15) & (np.abs(y - 0.25) < 0.15)).astype(np.int32)

    return ModelConfig(
        nx=nx, ny=ny, lx=1.0, ly=1.0,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(ambient, block),
            velocity_bcs=VelocityBCs(left="periodic", right="periodic"),
            thermal_bcs=ThermalBCs(
                left=ThermalBC("periodic", 0.0),
                right=ThermalBC("periodic", 0.0)),
            solve_energy=False,
            eta_avg="geometric",
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps),
        material_of=material_of,
        name="falling_block_periodic",
    )


def falling_block_periodic_config(nx: int = 1024,
                                  fused_smoother: bool = True
                                  ) -> ModelConfig:
    """``falling_block_periodic`` at nx^2 with its own SolverConfig (Stokes
    tolerance 1e-8, K = 18 slots for 9 markers a cell).
    ``fused_smoother=False`` is its partner: ``use_pallas=True,
    use_pallas_smoother=False``, whose MG smoother runs as tensor code with
    the momentum applies of the eligible levels through the momentum
    kernel."""
    cfg = falling_block_periodic(nx=nx, ny=nx, max_steps=10**9)
    if fused_smoother:
        return cfg
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, use_pallas=True, use_pallas_smoother=False))


def blankenbach_case1a(nx=64, ny=64, Ra=1e4, max_steps=2000, max_time=0.25):
    """Isoviscous convection at Ra = 1e4 (BASELINE config 2): rho =
    Ra (1 - T), rho0 cp = 1 and k = 1 (kappa = 1), free slip everywhere,
    Dirichlet top/bottom and insulating sides."""
    mat = Material(name="fluid", rho0=Ra, alpha=1.0, T_ref=0.0, eta0=1.0,
                   viscosity="constant", k=1.0, cp=1.0 / Ra)

    def T_of(x, y):
        # conductive profile + single-mode perturbation to seed the cell
        return y + 0.05 * np.cos(np.pi * x) * np.sin(np.pi * y)

    return ModelConfig(
        nx=nx, ny=ny, lx=1.0, ly=1.0,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(mat,),
            velocity_bcs=VelocityBCs(),
            thermal_bcs=ThermalBCs(
                top=ThermalBC("dirichlet", 0.0),
                bottom=ThermalBC("dirichlet", 1.0),
                left=ThermalBC("neumann", 0.0),
                right=ThermalBC("neumann", 0.0),
            ),
            solve_energy=True,
            subgrid_diffusion_d=0.0,
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps, max_time=max_time,
                        dt_diff_factor=5.0),
        T_of=T_of,
        name="blankenbach_1a",
    )


def fk_stagnant_lid(nx=64, ny=64, Ra_top=100.0, visc_contrast=1e4,
                    max_steps=3000, max_time=1.0):
    """T-dependent viscosity convection, eta = exp(-gamma T) with
    gamma = ln(visc_contrast): with Ra(top) = 100 and contrast 1e4 the flow
    convects under a stagnant lid."""
    gamma = float(np.log(visc_contrast))
    mat = Material(
        name="fk_fluid", rho0=Ra_top, alpha=1.0, T_ref=0.0,
        eta0=1.0, viscosity="frank_kamenetskii", fk_gamma=gamma,
        k=1.0, cp=1.0 / Ra_top,
    )

    def T_of(x, y):
        return y + 0.05 * np.cos(np.pi * x) * np.sin(np.pi * y)

    return ModelConfig(
        nx=nx, ny=ny, lx=1.0, ly=1.0,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(mat,),
            velocity_bcs=VelocityBCs(),
            thermal_bcs=ThermalBCs(
                top=ThermalBC("dirichlet", 0.0),
                bottom=ThermalBC("dirichlet", 1.0),
            ),
            solve_energy=True,
            subgrid_diffusion_d=0.0,
            eta_min=np.exp(-gamma) * 1e-3,
            eta_max=1e3,
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps, max_time=max_time,
                        dt_diff_factor=5.0),
        T_of=T_of,
        name="fk_stagnant_lid",
    )


def rt_van_keken(nx=512, ny=512, eta_ratio=1.0, max_steps=200):
    """Isothermal compositional RT after van Keken et al. (1997): buoyant
    layer (thickness 0.2) under a denser fluid in a 0.9142 x 1 box, cosine
    interface perturbation (BASELINE config 4)."""
    lam = 0.9142
    heavy = Material(name="heavy", rho0=1.0, eta0=1.0, viscosity="constant")
    light = Material(name="light", rho0=0.0, eta0=eta_ratio,
                     viscosity="constant")

    def material_of(x, y):
        interface = 0.8 + 0.02 * np.cos(np.pi * x / lam)
        return (y > interface).astype(np.int32)

    return ModelConfig(
        nx=nx, ny=ny, lx=lam, ly=1.0,
        markers_per_cell_dim=4,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(heavy, light),
            velocity_bcs=VelocityBCs(top="no_slip", bottom="no_slip"),
            solve_energy=False,
            eta_avg="geometric",
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps),
        material_of=material_of,
        name="rt_van_keken",
    )


# the benchmark harness's FK solver preset (bench.py, no arguments):
# restart 12 + two V-cycles + degree-4 Chebyshev, 1e-8 Stokes / 1e-10
# energy tolerances
BENCH_SOLVER = dict(
    stokes_tol=1e-8,
    stokes_restart=12,
    stokes_maxiter=250,
    mg_cycles=2,
    mg_pre_smooth=4,
    mg_post_smooth=4,
    energy_tol=1e-10,
)


def fk_bench_config(nx: int = 1024, fused_smoother: bool = True
                    ) -> ModelConfig:
    """The FK stagnant-lid benchmark at nx^2 with the bench solver preset:
    the JAX bench configuration exactly (fused Chebyshev smoother and coarse
    sub-V-cycle on).  ``fused_smoother=False`` sets
    ``use_pallas_smoother=False``, the configuration whose MG smoother runs
    as plain tensor code (the reference's mesh and vmap path)."""
    cfg = fk_stagnant_lid(nx=nx, ny=nx, max_steps=10**9)
    extra = {} if fused_smoother else dict(use_pallas_smoother=False)
    return dataclasses.replace(
        cfg, solver=SolverConfig(**BENCH_SOLVER, **extra))


def fk_stretched_bench_config(nx: int = 1024, ratio: float = 8.0
                              ) -> ModelConfig:
    """``python bench.py --stretch-y 8`` at nx^2: ``fk_bench_config(nx)``
    with y edges in geometric progression, the last cell ``ratio`` times
    the first (refined toward the top, the lid's boundary layer), built as
    bench.py:163-169 builds it.  The solver is the bench preset's:
    Chebyshev MG, semicoarsening at 2, power-iteration bounds on the
    non-uniform levels."""
    cfg = fk_bench_config(nx)
    return dataclasses.replace(
        cfg, y_edges=geometric_edges(cfg.ny, cfg.ly, ratio))


def sticky_air(nx=1024, ny=256, max_steps=50):
    """Crameri et al. (2012)-style free-surface relaxation: cosine topography
    on a high-viscosity lithosphere over mantle, with a weak low-density
    'sticky air' layer approximating the free surface.  SI units.  The
    solver preset is the reference's tuned sharp-contrast one:
    augmented-Lagrangian gamma = 10 with a 16-iteration inner velocity
    FGMRES (tol 3e-3), degree-6 Chebyshev with power-iteration bounds, the
    coarse-level eta cap 1e2 and FGMRES restart 60."""
    lx, ly = 2.8e6, 8.0e5  # m
    d_air, d_lith = 1.5e5, 1.0e5
    topo_amp, topo_lam = 7.0e3, 2.8e6

    air = Material(name="air", rho0=0.0, eta0=1e19, viscosity="constant",
                   k=100.0, cp=1000.0)
    lith = Material(name="lithosphere", rho0=3300.0, eta0=1e23,
                    viscosity="constant", k=3.0, cp=1000.0)
    mantle = Material(name="mantle", rho0=3300.0, eta0=1e21,
                      viscosity="constant", k=3.0, cp=1000.0)

    def material_of(x, y):
        surface = d_air - topo_amp * np.cos(2.0 * np.pi * x / topo_lam)
        m = np.full(x.shape, 2, np.int32)  # mantle
        m = np.where(y < surface + d_lith, 1, m)  # lithosphere
        m = np.where(y < surface, 0, m)  # air
        return m

    return ModelConfig(
        nx=nx, ny=ny, lx=lx, ly=ly,
        markers_per_cell_dim=3,
        physics=PhysicsConfig(
            gx=0.0, gy=9.81,
            materials=(air, lith, mantle),
            velocity_bcs=VelocityBCs(),
            solve_energy=False,
            eta_avg="geometric",
            eta_min=1e18, eta_max=1e24,
        ),
        solver=SolverConfig(stokes_tol=1e-8, stokes_restart=60,
                            stokes_maxiter=3000,
                            mg_pre_smooth=6, mg_post_smooth=6,
                            mg_lam_mode="power",
                            mg_eta_cap=1e2,
                            stokes_al_gamma=10.0,
                            mg_velocity_inner_iters=16,
                            mg_velocity_inner_tol=3e-3),
        # dt <= ~1 kyr: free-surface stability
        time=TimeConfig(courant=0.25, max_steps=max_steps, dt_max=KYR),
        material_of=material_of,
        name="sticky_air",
    )


def sticky_air_bench_config(nx: int = 1024, use_pallas: bool = True
                            ) -> ModelConfig:
    """The sticky-air benchmark of ``python bench.py --benchmark sticky_air
    --solver use_pallas=true`` at nx x max(nx // 4, 64): the preset with
    Stokes tolerance 1e-8 and the ``use_pallas`` override (the MG momentum
    kernel).  ``use_pallas=False`` is the same configuration with the
    momentum applies as plain tensor code."""
    cfg = sticky_air(nx=nx, ny=max(nx // 4, 64), max_steps=10**9)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, stokes_tol=1e-8, use_pallas=use_pallas))
