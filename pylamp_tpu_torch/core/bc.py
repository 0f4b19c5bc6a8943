"""Boundary-condition descriptors (static configuration).

Port of ``pylamp_tpu/core/bc.py`` with the same fields, so one set of
values drives both packages.  Periodic side walls wrap: vx columns 0 and
nx are one physical node (its momentum row is emitted half into each
column, which keeps the operator symmetric), and a periodic wall has no
ghost sign.
"""
from __future__ import annotations

import dataclasses

FREE_SLIP = "free_slip"
NO_SLIP = "no_slip"
PERIODIC = "periodic"

DIRICHLET = "dirichlet"
NEUMANN = "neumann"


@dataclasses.dataclass(frozen=True)
class VelocityBCs:
    """Per-wall velocity BC: "free_slip" or "no_slip" (ghost = s * first
    interior, s = +1 / -1), prescribed normal (``vn_*``) and tangential
    (``vt_*``, no-slip walls only) wall velocities."""

    top: str = FREE_SLIP
    bottom: str = FREE_SLIP
    left: str = FREE_SLIP
    right: str = FREE_SLIP
    vn_top: float = 0.0
    vn_bottom: float = 0.0
    vn_left: float = 0.0
    vn_right: float = 0.0
    vt_top: float = 0.0
    vt_bottom: float = 0.0
    vt_left: float = 0.0
    vt_right: float = 0.0

    def __post_init__(self):
        if (self.left == PERIODIC) != (self.right == PERIODIC):
            raise ValueError(
                "periodic side BCs must be set on BOTH left and right")
        if self.top == PERIODIC or self.bottom == PERIODIC:
            raise ValueError(
                "periodic BCs are supported on the side walls only")
        if self.periodic_x and (self.vn_left != 0.0 or self.vn_right != 0.0
                                or self.vt_left != 0.0
                                or self.vt_right != 0.0):
            raise ValueError(
                "periodic side walls take no prescribed velocities")

    @property
    def periodic_x(self) -> bool:
        return self.left == PERIODIC

    def _sign(self, wall: str) -> float:
        kind = getattr(self, wall)
        if kind == FREE_SLIP:
            return 1.0
        if kind == NO_SLIP:
            return -1.0
        if kind == PERIODIC:
            raise ValueError(
                f"wall {wall!r} is periodic: it has no ghost sign "
                "(use the wrap-around stencil path)")
        raise ValueError(f"unknown velocity BC {kind!r} on wall {wall!r}")

    @property
    def s_top(self):
        return self._sign("top")

    @property
    def s_bottom(self):
        return self._sign("bottom")

    @property
    def s_left(self):
        return self._sign("left")

    @property
    def s_right(self):
        return self._sign("right")


@dataclasses.dataclass(frozen=True)
class ThermalBC:
    """One wall: kind in {"dirichlet", "neumann", "periodic"};
    value = T or outward flux gradient dT/dn."""

    kind: str = NEUMANN
    value: float = 0.0


@dataclasses.dataclass(frozen=True)
class ThermalBCs:
    top: ThermalBC = ThermalBC(DIRICHLET, 0.0)
    bottom: ThermalBC = ThermalBC(DIRICHLET, 1.0)
    left: ThermalBC = ThermalBC(NEUMANN, 0.0)
    right: ThermalBC = ThermalBC(NEUMANN, 0.0)

    def __post_init__(self):
        if (self.left.kind == PERIODIC) != (self.right.kind == PERIODIC):
            raise ValueError(
                "periodic thermal BCs must be set on BOTH left and right")
        if self.top.kind == PERIODIC or self.bottom.kind == PERIODIC:
            raise ValueError("periodic thermal BCs are side-wall only")

    @property
    def periodic_x(self) -> bool:
        return self.left.kind == PERIODIC
