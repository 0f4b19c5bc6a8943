"""Benchmark model configurations.

Port of the Frank-Kamenetskii stagnant-lid preset of
``pylamp_tpu/models/benchmarks.py`` (unit box, kappa = 1, eta_ref = 1,
DT = 1; rho0*alpha = Ra with g = 1), plus ``fk_bench_config``: the
configuration ``python bench.py`` runs by default, switch for switch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from pylamp_tpu_torch.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.models.config import (
    ModelConfig,
    PhysicsConfig,
    SolverConfig,
    TimeConfig,
)
from pylamp_tpu_torch.physics.materials import Material


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
