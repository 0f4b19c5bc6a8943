"""Full model state: markers + last grid solution + clock (port of
``pylamp_tpu/models/state.py``).  Scalars (time, step, dt) are 0-d
tensors on the state's device, so a step never syncs the host for them.

The same dataclass holds the sharded layout (``parallel/mesh.py
shard_state``): each field then a ``parallel/blocks.py Blocks`` (this
process's block and seam strips; vx, vy, p, T, eta_s, eta_n on their
lattices), each marker stream a (by, bx, K) block, and the scalars and
``mg_lam`` replicated tensors."""
from __future__ import annotations

import dataclasses

import torch

from pylamp_tpu_torch.core.grid import StaggeredGrid


@dataclasses.dataclass
class ModelState:
    # markers.bucket.BucketedMarkers or markers.state.MarkerState (flat)
    markers: object
    vx: torch.Tensor
    vy: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor  # corner-node temperature
    eta_s: torch.Tensor
    eta_n: torch.Tensor
    time: torch.Tensor  # 0-d
    step: torch.Tensor  # 0-d int32
    dt: torch.Tensor  # 0-d, last dt taken
    # per-MG-level Chebyshev lambda_max bounds (None without a
    # Chebyshev-MG Stokes preconditioner)
    mg_lam: torch.Tensor | None = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def zero_state(grid: StaggeredGrid, markers, dtype=torch.float64,
               n_mg_levels: int = 0, device=None) -> ModelState:
    kw = dict(dtype=dtype, device=device)
    return ModelState(
        markers=markers,
        vx=torch.zeros(grid.shape_vx, **kw),
        vy=torch.zeros(grid.shape_vy, **kw),
        p=torch.zeros(grid.shape_center, **kw),
        T=torch.zeros(grid.shape_corner, **kw),
        eta_s=torch.ones(grid.shape_corner, **kw),
        eta_n=torch.ones(grid.shape_center, **kw),
        time=torch.zeros((), **kw),
        step=torch.zeros((), dtype=torch.int32, device=device),
        dt=torch.zeros((), **kw),
        mg_lam=torch.zeros((n_mg_levels,), **kw) if n_mg_levels > 0 else None,
    )
