"""Model configuration tree.

Port of ``pylamp_tpu/models/config.py``: the same dataclasses with the same
field names and defaults, so one set of values drives both packages
(``dataclasses.asdict`` of one feeds the other's constructor).

The ``use_pallas_*`` switches keep their names.  In this package they
select the hand-written Hopper CUDA kernels that replace the Pallas TPU
kernels of the same role:

- ``use_pallas_apply``: FGMRES outer saddle apply (ops/kernels/saddle.py)
- ``use_pallas_m2g``: fused marker->grid transfer (markers/kernels/m2g.py)
- ``use_pallas_advect``: fused RK4 advection (markers/kernels/advect.py)
- ``use_pallas_smoother``: fused Chebyshev sweep on the MG levels with
  nx >= 256 (ops/kernels/cheb.py)
- ``use_pallas_coarse`` (with ``use_pallas_smoother``): the MG levels below
  256 cells as one fused sub-V-cycle (ops/kernels/coarse_vcycle.py)
- ``use_pallas`` (default False, as in the reference): the MG momentum
  applies on levels with ny % 128 == 0 and nx >= 256
  (ops/kernels/momentum.py)

Rebucketing always takes its kernel (markers/kernels/rebucket.py) where the
static gates hold, as in the reference.  With ``explicit_halo`` and a mesh
(``models.step.make_step(..., mesh=...)``) the same switches select the
per-shard kernels of the explicit-halo path: ``use_pallas_apply`` the
per-shard saddle stencil, ``use_pallas_smoother`` the per-shard fused
sweep, ``use_pallas_m2g`` / ``use_pallas_advect`` the per-shard marker
transfer and advection; ``mg_coarse_replicate`` keeps the coarse levels on
the global tensors.  The step passes every switch on
only for an f32 state, as the reference gates its kernels on f32.
``pallas_interpret`` has no port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from pylamp_tpu_torch.core.bc import ThermalBCs, VelocityBCs
from pylamp_tpu_torch.physics.materials import Material


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    gx: float = 0.0
    gy: float = 9.81  # y points down
    materials: Sequence[Material] = (Material(),)
    velocity_bcs: VelocityBCs = VelocityBCs()
    thermal_bcs: ThermalBCs = ThermalBCs()
    eta_min: float = 1e-12
    eta_max: float = 1e30
    eta_avg: str = "geometric"
    k_face_avg: str = "arithmetic"
    solve_energy: bool = True
    shear_heating: bool = False
    adiabatic_heating: bool = False
    subgrid_diffusion_d: float = 0.0
    reseed_min_per_cell: int = 0
    reseed_max_moves: int = 256


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # "auto": f32 state -> mixed (f32 inner solves + f64 refinement),
    # f64 state -> plain f64 solves; "f32"/"f64"/"mixed" force a mode
    precision: str = "auto"
    inner_tol: float = 1e-4
    max_refinements: int = 6
    stokes_tol: float = 1e-8
    stokes_restart: int = 25
    stokes_maxiter: int = 2000
    preconditioner: str = "mg"
    mg_levels: int = 0
    mg_cycles: int = 1
    mg_pre_smooth: int = 3
    mg_post_smooth: int = 3
    mg_smoother: str = "chebyshev"
    mg_omega: float = 0.6
    mg_lam_mode: str = "gershgorin"
    mg_lam_refresh_every: int = 8
    mg_scaled_transfers: bool = False
    mg_ls_damp: bool = False
    mg_semicoarsen: float = 2.0
    schur: str = "mass"
    schur_poisson_iters: int = 3
    stokes_al_gamma: float = 0.0
    mg_velocity_inner_iters: int = 0
    mg_velocity_inner_tol: float = 3e-2
    mg_eta_cap: float = 0.0
    mg_coarse_replicate: int = 0
    explicit_halo: bool = False
    use_pallas: bool = False
    use_pallas_smoother: bool = True
    use_pallas_coarse: bool = True
    use_pallas_m2g: bool = True
    use_pallas_advect: bool = True
    use_pallas_apply: bool = True
    pallas_interpret: bool = False
    energy_tol: float = 1e-10
    energy_maxiter: int = 2000
    energy_preconditioner: str = "jacobi"
    energy_mg_smoother: str = "chebyshev"


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    courant: float = 0.5
    dt_max: float = float("inf")
    dt_min: float = 0.0
    dt_diff_factor: float = float("inf")
    max_steps: int = 100
    max_time: float = float("inf")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    nx: int = 64
    ny: int = 64
    lx: float = 1.0
    ly: float = 1.0
    x_edges: tuple | None = None
    y_edges: tuple | None = None
    markers_per_cell_dim: int = 3
    marker_engine: str = "bucket"
    marker_capacity: int = 0  # 0 = auto: 2 * markers_per_cell_dim^2
    seed: int = 0
    physics: PhysicsConfig = PhysicsConfig()
    solver: SolverConfig = SolverConfig()
    time: TimeConfig = TimeConfig()
    # initial conditions, evaluated on the host with numpy at setup:
    # material_of(x, y) -> int array; T_of(x, y) -> float array
    material_of: Callable | None = None
    T_of: Callable | None = None
    name: str = "model"
