"""Flat marker state (port of ``pylamp_tpu/markers/state.py``): markers as
(N,) tensors of a fixed capacity N, the reference's own layout (one column
per property, no insertion or removal during a run)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MarkerState:
    x: torch.Tensor  # (N,)
    y: torch.Tensor  # (N,)
    mat: torch.Tensor  # (N,) int32 material id
    T: torch.Tensor  # (N,) temperature

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
