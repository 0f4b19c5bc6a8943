"""Fully staggered 2-D finite-difference grid (uniform spacing).

Port of ``pylamp_tpu/core/grid.py``.  Same axis convention: index
``[j, i]`` = (row, col) = (y, x), y points down, x is the contiguous axis.

Sub-grid layouts for an ``ny x nx``-cell domain:

- corner nodes ``(ny+1, nx+1)``: eta_s, T, k, rho*Cp
- cell centers ``(ny, nx)``: p, eta_n
- vx nodes ``(ny, nx+1)``; vy nodes ``(ny+1, nx)``

Only uniform grids are ported; stretched edges raise.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StaggeredGrid:
    """Uniform staggered grid. ``nx, ny`` = number of CELLS."""

    nx: int
    ny: int
    lx: float
    ly: float
    x_edges: tuple | None = None
    y_edges: tuple | None = None

    def __post_init__(self):
        if self.nx < 2 or self.ny < 2:
            raise ValueError("grid needs at least 2x2 cells")
        if self.x_edges is not None or self.y_edges is not None:
            raise NotImplementedError(
                "stretched grids wait for a later port PR")

    uniform = True

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def dx_min(self) -> float:
        return self.lx / self.nx

    @property
    def dy_min(self) -> float:
        return self.ly / self.ny

    @property
    def shape_corner(self):
        return (self.ny + 1, self.nx + 1)

    @property
    def shape_center(self):
        return (self.ny, self.nx)

    @property
    def shape_vx(self):
        return (self.ny, self.nx + 1)

    @property
    def shape_vy(self):
        return (self.ny + 1, self.nx)

    def shape(self, loc: str):
        return {
            "corner": self.shape_corner,
            "center": self.shape_center,
            "vx": self.shape_vx,
            "vy": self.shape_vy,
        }[loc]

    def origin(self, loc: str):
        """Position (y, x) of node [0, 0] of a sub-grid."""
        if loc == "corner":
            return (0.0, 0.0)
        if loc == "center":
            return (0.5 * self.dy, 0.5 * self.dx)
        if loc == "vx":
            return (0.5 * self.dy, 0.0)
        if loc == "vy":
            return (0.0, 0.5 * self.dx)
        raise ValueError(f"unknown sub-grid location {loc!r}")

    def coarsen(self, cx: bool = True, cy: bool = True) -> "StaggeredGrid":
        """The 2x-coarser grid along the selected axes (even counts)."""
        if not (cx or cy):
            raise ValueError("coarsen needs at least one axis")
        if (cx and self.nx % 2) or (cy and self.ny % 2):
            raise ValueError("coarsen needs an even cell count on each "
                             "coarsened axis")
        return StaggeredGrid(
            nx=self.nx // 2 if cx else self.nx,
            ny=self.ny // 2 if cy else self.ny,
            lx=self.lx, ly=self.ly,
        )
