"""Dense bucketed marker engine.

Port of ``pylamp_tpu/markers/bucket.py``: markers live in a dense
(ny, nx, K) layout bucketed by their owning grid cell, empty slots masked
by ``valid``.  The functions here are the plain PyTorch versions; the
step runs the CUDA kernels in ``markers/kernels/`` where their static
gates hold, and these are what those kernels are checked against.

- marker -> grid (``bucket_markers_to_grid``) keeps the reference's
  dense-shift structure (9 cell offsets x 4 bilinear corners, masked
  K-reductions), so its summation order matches the reference's;
- grid -> marker sampling and RK4 advection gather the 4 bilinear nodes
  directly, masked to the reference's (2 reach + 2)^2 shift window;
- ``rebucket`` repacks every bucket from its 3x3 neighbourhood in the
  reference's insertion order ((a, b) slab-major, slot-minor) by a prefix
  sum over the candidates; the result is identical slot for slot;
- ``bucket_reseed`` refills starved cells with the reference's spawn rule
  (3x3 material majority, golden-ratio sub-cell offsets, T from the grid).

With ``periodic_x`` every x neighbourhood wraps with period nx: node
columns of the marker->grid sums (lattices with a duplicated seam column
re-emit the seam sum in both), the sampled lattice columns, the advected
x (wrapped into [0, lx)) and the rebucket's 3x3 exchange.

On a stretched grid a position's node interval is found by the
reference's windowed locate (``_axis_locate``): the interval lies within a
small static window of offsets from the marker's bucket cell, and is
counted by comparisons against per-cell node rows (device tensors cached
on the grid), so a marker exactly on an edge lands in the reference's
cell; the slot positions of reseeding sit in each cell's own spacing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid

ARITHMETIC = "arithmetic"
GEOMETRIC = "geometric"
HARMONIC = "harmonic"

OFFSETS = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))


@dataclasses.dataclass
class BucketedMarkers:
    """Markers bucketed by owning grid cell: all tensors (ny, nx, K)."""

    x: torch.Tensor
    y: torch.Tensor
    mat: torch.Tensor  # int32
    T: torch.Tensor
    valid: torch.Tensor  # bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self):
        return torch.sum(self.valid, dim=-1)

    def total(self):
        return torch.sum(self.valid)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _cell_iota(shape, device):
    """(cj, ci) bucket-cell indices broadcastable against (ny, nx, K)."""
    ny, nx = shape[0], shape[1]
    cj = torch.arange(ny, device=device, dtype=torch.int64).view(ny, 1, 1)
    ci = torch.arange(nx, device=device, dtype=torch.int64).view(1, nx, 1)
    return cj, ci


# -- construction ------------------------------------------------------------------

def bucket_from_flat(x, y, mat, T, grid: StaggeredGrid, capacity: int):
    """One-time setup conversion of flat (N,) markers: stable sort by cell,
    rank within cell, scatter into the first ``capacity`` slots."""
    ny, nx = grid.ny, grid.nx
    dev = x.device
    if grid.uniform:
        j, i = target_cells(x, y, grid)
    else:  # the reference's setup search over the edges (marker dtype)
        def search(edges, pos, n):
            e = torch.as_tensor(edges, dtype=pos.dtype, device=dev)
            return torch.clamp(torch.searchsorted(e, pos, right=True) - 1,
                               0, n - 1)

        j, i = search(grid.y_corner, y, ny), search(grid.x_corner, x, nx)
    cid = j.to(torch.int64) * nx + i.to(torch.int64)
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    seg_start = torch.searchsorted(
        cid_s, torch.arange(nx * ny, device=dev, dtype=torch.int64))
    rank = torch.arange(x.shape[0], device=dev) - seg_start[cid_s]
    keep = rank < capacity
    flat_idx = (cid_s * capacity + rank)[keep]

    def fill(vals, dtype):
        out = torch.zeros(ny * nx * capacity, dtype=dtype, device=dev)
        out[flat_idx] = vals[order][keep].to(dtype)
        return out.reshape(ny, nx, capacity)

    valid = torch.zeros(ny * nx * capacity, dtype=torch.bool, device=dev)
    valid[flat_idx] = True
    return BucketedMarkers(
        x=fill(x, x.dtype), y=fill(y, y.dtype), mat=fill(mat, torch.int32),
        T=fill(T, T.dtype), valid=valid.reshape(ny, nx, capacity))


def flatten(bm: BucketedMarkers):
    """(x, y, mat, T, valid) as flat tensors in ``reshape(-1)`` order (for
    IO/diagnostics)."""
    return (bm.x.reshape(-1), bm.y.reshape(-1), bm.mat.reshape(-1),
            bm.T.reshape(-1), bm.valid.reshape(-1))


# -- local coordinates on a target sub-lattice ----------------------------------------

def _locate_table(grid: StaggeredGrid, name: str, nodes, ncells: int,
                  rlo: int, rhi: int, dtype, device):
    """The windowed locate's operands for one axis's ``nodes`` (f64 numpy),
    cached on the grid: the shifted node rows ``rows[r - rlo - 1][i] =
    nodes[i + r]`` for r in (rlo, rhi] (-inf below the array, +inf above,
    so out-of-range comparisons resolve the right way) and the nodes
    themselves, in ``dtype`` on ``device``."""
    key = ("locate", name, rlo, rhi, dtype, torch.device(device))
    cache = grid.tensor_cache
    if key not in cache:
        nodes = np.asarray(nodes, np.float64)
        m = nodes.shape[0]
        idx = np.arange(rlo + 1, rhi + 1)[:, None] + np.arange(ncells)
        rows = np.where(idx < 0, -np.inf, np.where(
            idx > m - 1, np.inf, nodes[np.clip(idx, 0, m - 1)]))
        cache[key] = (torch.from_numpy(rows).to(dtype=dtype, device=device),
                      torch.from_numpy(nodes).to(dtype=dtype, device=device))
    return cache[key]


def _axis_locate(pos, grid: StaggeredGrid, name: str, nodes, rlo: int,
                 rhi: int, axis: int):
    """The reference's windowed locate on a stretched axis: positions
    (ny, nx, K) whose node interval i0 (nodes[i0] <= pos < nodes[i0 + 1])
    lies within [rlo, rhi] of their bucket index along ``axis``.  Returns
    (i0 clipped to [0, len(nodes) - 2], local coordinate t in [0, 1]).
    The interval is counted by comparisons; its end points are then read
    at i0 (the reference selects them from the same rows, the same
    values)."""
    ncells = pos.shape[axis]
    rows, nodes_t = _locate_table(grid, name, nodes, ncells, rlo, rhi,
                                  pos.dtype, pos.device)
    shape = [1, 1, 1]
    shape[axis] = ncells
    base = torch.arange(ncells, device=pos.device).view(shape)
    i0 = torch.full(pos.shape, rlo, dtype=torch.int64, device=pos.device)
    i0 = i0 + base
    for row in rows:
        i0 = i0 + (pos >= row.view(shape))
    i0 = torch.clamp(i0, 0, nodes_t.shape[0] - 2)
    lo, hi = nodes_t[i0], nodes_t[i0 + 1]
    return i0, torch.clamp((pos - lo) / (hi - lo), 0.0, 1.0)


def _stretched_locate(px, py, grid: StaggeredGrid, loc: str,
                      window: int = 1):
    """(j0, i0, ty, tx) of positions on the ``loc`` lattice of a stretched
    grid: node intervals at edges are the bucket cell (offset 0), at
    centers offset -1 or 0, each widened by ``window - 1`` cells for
    displaced (RK4 stage) positions."""
    ys, xs = grid.coords(loc)
    w = window
    xlo, xhi = (-(w - 1), w - 1) if loc in ("corner", "vx") else (-w, w - 1)
    ylo, yhi = (-(w - 1), w - 1) if loc in ("corner", "vy") else (-w, w - 1)
    i0, tx = _axis_locate(px, grid, f"x_{loc}", xs, xlo, xhi, axis=1)
    j0, ty = _axis_locate(py, grid, f"y_{loc}", ys, ylo, yhi, axis=0)
    return j0, i0, ty, tx


def _lattice_local(bm_x, bm_y, grid: StaggeredGrid, loc: str,
                   periodic_x: bool = False):
    """Per-marker (o_j, o_i, ty, tx): the ``loc``-lattice cell containing
    the marker starts at bucket-cell offset (o_j, o_i); (ty, tx) in [0, 1]
    are its local coordinates (clamped to the lattice; ``periodic_x``: no
    x clamp, the node columns wrap where the sums land)."""
    cj, ci = _cell_iota(bm_x.shape, bm_x.device)
    if not grid.uniform:
        if periodic_x:
            raise ValueError("periodic side walls need a uniform grid")
        j0, i0, ty, tx = _stretched_locate(bm_x, bm_y, grid, loc)
        return j0 - cj, i0 - ci, ty, tx
    oy, ox = grid.origin(loc)
    ny_n, nx_n = grid.shape(loc)
    fx = (bm_x - ox) / grid.dx
    fy = (bm_y - oy) / grid.dy
    i0 = torch.floor(fx)
    if not periodic_x:
        i0 = torch.clamp(i0, 0, nx_n - 2)
    i0 = i0.to(torch.int64)
    j0 = torch.clamp(torch.floor(fy), 0, ny_n - 2).to(torch.int64)
    tx = torch.clamp(fx - i0, 0.0, 1.0)
    ty = torch.clamp(fy - j0, 0.0, 1.0)
    return j0 - cj, i0 - ci, ty, tx


def _corners(ty, tx):
    """The 4 bilinear corners (dj, di, weight) in the reference's order."""
    return (
        (0, 0, (1.0 - ty) * (1.0 - tx)),
        (0, 1, (1.0 - ty) * tx),
        (1, 0, ty * (1.0 - tx)),
        (1, 1, ty * tx),
    )


# -- marker -> grid -------------------------------------------------------------------

def m2g_sums(bm: BucketedMarkers, values, grid: StaggeredGrid, loc: str,
             periodic_x: bool = False):
    """Raw weighted sums on the ``loc`` lattice: returns (sum w,
    [sum w * v for v in values]).  ``values`` are (ny, nx, K) tensors
    already sanitized on empty slots.  Cell (j, i) contributes to node
    (j + a, i + b) for the 9 offsets (a, b) in {-1, 0, 1}^2 (``periodic_x``:
    node column (i + b) mod nx, and an nx+1-wide lattice carries the seam
    sum in both seam columns)."""
    ny, nx = grid.ny, grid.nx
    ny_n, nx_n = grid.shape(loc)
    o_j, o_i, ty, tx = _lattice_local(bm.x, bm.y, grid, loc, periodic_x)
    corners = _corners(ty, tx)
    vmask = bm.valid
    dtype = bm.x.dtype
    field_w = torch.zeros((ny_n, nx if periodic_x else nx_n), dtype=dtype,
                          device=bm.x.device)
    fields_wv = [torch.zeros_like(field_w) for _ in values]
    zero = torch.zeros((ny, nx), dtype=dtype, device=bm.x.device)
    for a, b in OFFSETS:
        s_w = zero
        s_wv = [zero for _ in values]
        for dj, di, w in corners:
            sel = (o_j + dj == a) & (o_i + di == b) & vmask
            wm = torch.where(sel, w, 0.0)
            s_wv = [s + torch.sum(wm * v, dim=-1) for s, v in zip(s_wv, values)]
            s_w = s_w + torch.sum(wm, dim=-1)
        # node (j + a, i + b) <- cell (j, i), within the lattice
        j_lo, j_hi = max(0, -a), min(ny, ny_n - a)
        if periodic_x:
            # node column m <- cell column (m - b) mod nx
            s_w = torch.roll(s_w, b, dims=1)
            s_wv = [torch.roll(s, b, dims=1) for s in s_wv]
            i_lo, i_hi, b_dst = 0, nx, 0
        else:
            i_lo, i_hi, b_dst = max(0, -b), min(nx, nx_n - b), b
        dst = (slice(j_lo + a, j_hi + a), slice(i_lo + b_dst, i_hi + b_dst))
        src = (slice(j_lo, j_hi), slice(i_lo, i_hi))
        field_w[dst] += s_w[src]
        for f, s in zip(fields_wv, s_wv):
            f[dst] += s[src]
    if periodic_x and nx_n == nx + 1:  # the seam sum in both seam columns
        field_w = torch.cat([field_w, field_w[:, :1]], dim=1)
        fields_wv = [torch.cat([f, f[:, :1]], dim=1) for f in fields_wv]
    return field_w, fields_wv


def transform_values(values, valid, mode: str):
    """The averaging transform of the marker values (empty slots
    sanitized before it: log(0) or 1/0 would turn masked zero weights into
    NaN)."""
    if mode == ARITHMETIC:
        return torch.where(valid, values, 0.0)
    safe = torch.where(valid, values, 1.0)
    if mode == GEOMETRIC:
        return torch.log(safe)
    if mode == HARMONIC:
        return 1.0 / safe
    raise ValueError(f"unknown averaging mode {mode!r}")


def mean_of(wv, w, mode: str = ARITHMETIC):
    """Weighted mean from raw sums, inverting the averaging transform."""
    mean = wv / torch.where(w == 0, 1.0, w)
    if mode == GEOMETRIC:
        mean = torch.exp(mean)
    elif mode == HARMONIC:
        mean = 1.0 / torch.where(mean == 0, 1.0, mean)
    return mean


def bucket_markers_to_grid(bm: BucketedMarkers, values, grid: StaggeredGrid,
                           loc: str, mode: str = ARITHMETIC,
                           periodic_x: bool = False):
    """Weighted mean of marker values on the ``loc`` sub-lattice.
    Returns (field, wsum)."""
    v = transform_values(values, bm.valid, mode)
    field_w, (field_wv,) = m2g_sums(bm, [v], grid, loc, periodic_x)
    return mean_of(field_wv, field_w, mode), field_w


# -- grid -> marker -------------------------------------------------------------------

def _sample(f, fx, fy, valid, reach: int, period: int = 0,
            col_offset: int = 0, x_clamp: bool = True):
    """Bilinear sample of lattice ``f`` at array coordinates (fx, fy) (node
    (r, c) at (fy, fx) = (r, c)), clamped to the lattice; a corner node
    contributes only if its offset from the marker's bucket cell lies in
    the reference's shift window [-reach, reach + 1], and empty slots
    sample 0.  ``period`` > 0 (periodic side walls): array column c reads
    column col_offset + (c - col_offset) mod period, and x is clamped to
    [-reach, nc - 2 + reach] (``x_clamp``) or not at all."""
    nr, nc = f.shape
    i0 = torch.floor(fx)
    if not period:
        i0 = torch.clamp(i0, 0, nc - 2)
    elif x_clamp:
        i0 = torch.clamp(i0, -reach, nc - 2 + reach)
    i0 = i0.to(torch.int64)
    j0 = torch.clamp(torch.floor(fy), 0, nr - 2).to(torch.int64)
    tx = torch.clamp(fx - i0, 0.0, 1.0)
    ty = torch.clamp(fy - j0, 0.0, 1.0)
    return _gather(f, j0, i0, ty, tx, valid, reach, period, col_offset)


def _gather(f, j0, i0, ty, tx, valid, reach: int, period: int = 0,
            col_offset: int = 0):
    """Bilinear sample of lattice ``f`` from the located interval (j0, i0)
    and local coordinates (ty, tx) of each slot, masked to the reference's
    shift window and to the valid slots (``_sample``)."""
    nc = f.shape[1]
    cj, ci = _cell_iota(tx.shape, tx.device)
    flat = f.reshape(-1)
    out = torch.zeros_like(tx)
    for dj, di, w in _corners(ty, tx):
        rj, ri = j0 + dj, i0 + di
        oj, oi = rj - cj, ri - ci
        ok = (valid & (oj >= -reach) & (oj <= reach + 1)
              & (oi >= -reach) & (oi <= reach + 1))
        if period:
            ri = (ri - col_offset) % period + col_offset
        out = out + torch.where(ok, w, 0.0) * flat[rj * nc + ri]
    return out


def _sample_stretched(f, px, py, valid, grid: StaggeredGrid, reach: int,
                      lattice: str):
    """Bilinear sample of a ghost-padded velocity lattice of a stretched
    grid (``padded_velocities``; ``lattice`` "vx" or "vy"): the windowed
    locate against its node coordinates, the ghost rows or columns one
    cell beyond the walls (the reference's ``_sample_coords``).  A
    center-like axis (nodes at cell centers and one ghost each side) has
    in-cell offsets {0, 1}, an edge-like axis {0}, each widened by
    ``reach`` for displaced positions."""
    if lattice == "vx":
        yc = grid.y_center
        ys = np.concatenate([[yc[0] - grid.dys[0]], yc,
                             [yc[-1] + grid.dys[-1]]])
        xs = grid.x_corner
        (ylo, yhi), (xlo, xhi) = (-reach, reach + 1), (-reach, reach)
    else:
        xc = grid.x_center
        xs = np.concatenate([[xc[0] - grid.dxs[0]], xc,
                             [xc[-1] + grid.dxs[-1]]])
        ys = grid.y_corner
        (ylo, yhi), (xlo, xhi) = (-reach, reach), (-reach, reach + 1)
    j0, ty = _axis_locate(py, grid, f"y_{lattice}_padded", ys, ylo, yhi,
                          axis=0)
    i0, tx = _axis_locate(px, grid, f"x_{lattice}_padded", xs, xlo, xhi,
                          axis=1)
    return _gather(f, j0, i0, ty, tx, valid, reach)


def bucket_grid_to_markers(field, px, py, valid, grid: StaggeredGrid,
                           loc: str, reach: int = 1, periodic_x: bool = False):
    """Bilinear interpolation of a ``loc``-lattice field to marker
    positions (``reach`` bounds the node offset from the bucket cell;
    ``periodic_x``: node columns wrap with period nx)."""
    if not grid.uniform:
        if periodic_x:
            raise ValueError("periodic side walls need a uniform grid")
        j0, i0, ty, tx = _stretched_locate(px, py, grid, loc, window=reach)
        return _gather(field, j0, i0, ty, tx, valid, reach)
    oy, ox = grid.origin(loc)
    return _sample(field, (px - ox) / grid.dx, (py - oy) / grid.dy, valid,
                   reach, period=grid.nx if periodic_x else 0, x_clamp=False)


# -- velocity sampling + RK4 advection --------------------------------------------------

def padded_velocities(vx, vy, bcs: VelocityBCs):
    """Ghost-padded velocity lattices: vx_p (ny+2, nx+1) with origin
    (-dy/2, 0), vy_p (ny+1, nx+2) with origin (0, -dx/2); moving no-slip
    walls enter through the ghosts, periodic side walls wrap vy's ghost
    columns."""
    top = bcs.s_top * vx[:1] + (1.0 - bcs.s_top) * bcs.vt_top
    bot = bcs.s_bottom * vx[-1:] + (1.0 - bcs.s_bottom) * bcs.vt_bottom
    vx_p = torch.cat([top, vx, bot], dim=0)
    if bcs.periodic_x:
        left, right = vy[:, -1:], vy[:, :1]
    else:
        left = bcs.s_left * vy[:, :1] + (1.0 - bcs.s_left) * bcs.vt_left
        right = bcs.s_right * vy[:, -1:] + (1.0 - bcs.s_right) * bcs.vt_right
    vy_p = torch.cat([left, vy, right], dim=1)
    return vx_p, vy_p


def bucket_advect_rk4(bm: BucketedMarkers, vx, vy, dt, grid: StaggeredGrid,
                      bcs: VelocityBCs, stage_reach: int = 2):
    """RK4 advection in bucket layout (positions only; rebucket after).
    ``stage_reach``: the shift window of the displaced stage positions
    (1 when dt keeps every stage within half a cell).  Final positions
    are clipped to the closed domain; periodic side walls sample the
    lattices wrapped in x (the stage positions themselves are not wrapped)
    and wrap the final x into [0, lx) with ``wrap_x``."""
    vx_p, vy_p = padded_velocities(vx, vy, bcs)
    period = grid.nx if bcs.periodic_x else 0
    if not grid.uniform:
        if period:
            raise ValueError("periodic side walls need a uniform grid")

        def vel(px, py, reach):
            return (_sample_stretched(vx_p, px, py, bm.valid, grid, reach,
                                      "vx"),
                    _sample_stretched(vy_p, px, py, bm.valid, grid, reach,
                                      "vy"))
    else:
        dx, dy = grid.dx, grid.dy

        def vel(px, py, reach):
            return (_sample(vx_p, px / dx, py / dy + 0.5, bm.valid, reach,
                            period, 0),
                    _sample(vy_p, px / dx + 0.5, py / dy, bm.valid, reach,
                            period, 1))

    x, y = bm.x, bm.y
    k1x, k1y = vel(x, y, 1)
    k2x, k2y = vel(x + 0.5 * dt * k1x, y + 0.5 * dt * k1y, stage_reach)
    k3x, k3y = vel(x + 0.5 * dt * k2x, y + 0.5 * dt * k2y, stage_reach)
    k4x, k4y = vel(x + dt * k3x, y + dt * k3y, stage_reach)

    nx_new = x + dt / 6.0 * (k1x + 2 * k2x + 2 * k3x + k4x)
    ny_new = y + dt / 6.0 * (k1y + 2 * k2y + 2 * k3y + k4y)
    eps_x = 1e-6 * grid.dx_min
    eps_y = 1e-6 * grid.dy_min
    return bm.replace(
        x=(wrap_x(nx_new, grid.lx) if period
           else torch.clamp(nx_new, eps_x, grid.lx - eps_x)),
        y=torch.clamp(ny_new, eps_y, grid.ly - eps_y),
    )


def wrap_x(px, lx: float):
    """x wrapped into [0, lx) as the reference's tensor path wraps it
    (``bucket._wrap_x``: px - lx * floor(px / lx), IEEE division).  In f32
    a tiny negative x can come out as exactly lx; the owning cell is then
    clipped to column nx - 1."""
    return px - lx * torch.floor(_true_div(px, lx))


# -- re-bucketing -------------------------------------------------------------------------

def _shift3(arr, a, b, periodic_x: bool = False):
    """arr[j + a, i + b, :] with zero fill outside the cell range
    (``periodic_x``: column (i + b) mod nx)."""
    if periodic_x:
        return _shift3(torch.roll(arr, -b, dims=1), a, 0)
    ny, nx = arr.shape[0], arr.shape[1]
    out = torch.zeros_like(arr)
    out[max(0, -a): min(ny, ny - a), max(0, -b): min(nx, nx - b)] = \
        arr[max(0, a): min(ny, ny + a), max(0, b): min(nx, nx + b)]
    return out


def _true_div(a, d: float):
    """a / d with IEEE division on every device (PyTorch's CUDA path turns a
    division by a host scalar into a multiply by its reciprocal)."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def target_cells(x, y, grid: StaggeredGrid):
    """Owning cell (tj, ti) of each position: clip(int(x / dx)) with IEEE
    division by the working-precision cell size, exactly as the reference
    traces it."""
    ti = torch.clamp(_true_div(x, grid.dx).to(torch.int32), 0, grid.nx - 1)
    tj = torch.clamp(_true_div(y, grid.dy).to(torch.int32), 0, grid.ny - 1)
    return tj, ti


def rebucket(bm: BucketedMarkers, grid: StaggeredGrid,
             periodic_x: bool = False):
    """Re-pack every bucket from its 3x3 neighbourhood (markers move at
    most one cell per step).  Candidates are taken in the reference's
    order — (a, b) slab-major, slot-minor — and a bucket keeps the first K
    that target it; later arrivals are dropped and counted.

    ``periodic_x``: the neighbourhood wraps in x, so a marker that crossed
    the seam repacks into the opposite edge column (needs nx >= 3: the
    wrapped offset (ti - ci + 1) mod nx - 1 of the reference).

    Returns (new_bm, dropped) with ``dropped`` a 0-d int64 tensor."""
    ny, nx, K = bm.x.shape
    if periodic_x and nx < 3:
        raise ValueError(f"periodic rebucketing needs nx >= 3, got {nx}")
    if grid.uniform:
        tj, ti = target_cells(bm.x, bm.y, grid)
    elif periodic_x:
        raise ValueError("periodic side walls need a uniform grid")
    else:  # markers move at most one cell: windowed locate on the edges
        ti, _ = _axis_locate(bm.x, grid, "x_corner", grid.x_corner, -1, 1,
                             axis=1)
        tj, _ = _axis_locate(bm.y, grid, "y_corner", grid.y_corner, -1, 1,
                             axis=0)
    cj, ci = _cell_iota(bm.x.shape, bm.x.device)
    stays_dj = tj.to(torch.int64) - cj
    stays_di = ti.to(torch.int64) - ci
    if periodic_x:
        stays_di = (stays_di + 1) % nx - 1

    takes, cands = [], {"x": [], "y": [], "T": [], "mat": []}
    for a, b in OFFSETS:
        # a marker in cell (j+a, i+b) belongs to cell (j, i) iff its
        # target offset from its own cell is (-a, -b)
        takes.append(_shift3(bm.valid, a, b, periodic_x)
                     & (_shift3(stays_dj, a, b, periodic_x) == -a)
                     & (_shift3(stays_di, a, b, periodic_x) == -b))
        for name in cands:
            cands[name].append(_shift3(getattr(bm, name), a, b, periodic_x))
    new, arrivals = pack_candidates(takes, cands, K)
    dropped = torch.sum(torch.clamp(arrivals - K, min=0))
    return new, dropped


def pack_candidates(takes, cands, K: int):
    """Repack buckets from their candidate slabs in insertion order:
    ``takes`` (list of (..., K) bool) and ``cands`` ({"x", "y", "T", "mat"}:
    lists of the matching slabs); a bucket keeps the first K candidates it
    takes.  Returns (BucketedMarkers, arrivals per bucket, int64)."""
    take = torch.cat(takes, dim=-1)  # (..., 9K) in insertion order
    rank = torch.cumsum(take.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    arrivals = torch.sum(take, dim=-1, dtype=torch.int64)
    keep = take & (rank < K)
    slot = torch.where(keep, rank, K).to(torch.int64)  # K = discard slot

    def pack(name):
        vals = torch.cat(cands[name], dim=-1)
        out = torch.zeros((*vals.shape[:-1], K + 1), dtype=vals.dtype,
                          device=vals.device)
        return out.scatter_(-1, slot, vals)[..., :K]

    count = torch.clamp(arrivals, max=K)
    valid = torch.arange(K, device=take.device) < count[..., None]
    new = BucketedMarkers(x=pack("x"), y=pack("y"), mat=pack("mat"),
                          T=pack("T"), valid=valid)
    return new, arrivals


# -- reseeding ----------------------------------------------------------------------------

def material_histogram(bm: BucketedMarkers, n_materials: int):
    """(ny, nx, n_materials) int32 count of each cell's valid markers per
    material id."""
    return torch.stack(
        [torch.sum(bm.valid & (bm.mat == m), dim=-1, dtype=torch.int32)
         for m in range(n_materials)], dim=-1)


def _cell_origins(grid: StaggeredGrid, dtype, device):
    """Each cell's first edge and width along x (1, nx, 1) and y (ny, 1, 1)
    in the marker ``dtype``, then widened to f64 (the reference's
    promotion of its spawn arithmetic); cached on the grid."""
    key = ("cell_origins", dtype, torch.device(device))
    cache = grid.tensor_cache
    if key not in cache:
        def cells(a, shape):
            return torch.from_numpy(np.asarray(a, np.float64)).to(
                dtype=dtype, device=device).to(torch.float64).view(shape)

        nx, ny = grid.nx, grid.ny
        cache[key] = (cells(grid.x_corner[:-1], (1, nx, 1)),
                      cells(grid.y_corner[:-1], (ny, 1, 1)),
                      cells(grid.dxs, (1, nx, 1)), cells(grid.dys, (ny, 1, 1)))
    return cache[key]


def reseed_spawn(bm: BucketedMarkers, majority, grid: StaggeredGrid,
                 min_per_cell: int):
    """The cell-local half of ``bucket_reseed``: which empty slots spawn
    (the first ``min_per_cell - count`` free slots of each cell, ranked by a
    prefix sum over K) and the new markers' x, y and material.  The
    golden-ratio sub-cell offsets are computed in f64 (the reference's x64
    dtype) and cast to the marker dtype last.  Returns (spawn, x, y, mat)."""
    ny, nx, K = bm.x.shape
    dev = bm.x.device
    deficit = torch.clamp(min_per_cell - bm.count(), min=0)
    free_rank = torch.cumsum((~bm.valid).to(torch.int32), dim=-1,
                             dtype=torch.int32) - 1
    spawn = (~bm.valid) & (free_rank < deficit[:, :, None])

    f64 = torch.float64
    s = torch.arange(K, dtype=f64, device=dev)
    off_x = (torch.remainder(s * 0.381966, 1.0) - 0.5) * 0.5
    off_y = (torch.remainder(s * 0.618034, 1.0) - 0.5) * 0.5
    if grid.uniform:
        ci = torch.arange(nx, dtype=f64, device=dev).view(1, nx, 1)
        cj = torch.arange(ny, dtype=f64, device=dev).view(ny, 1, 1)
        sx = (ci + 0.5 + off_x) * grid.dx
        sy = (cj + 0.5 + off_y) * grid.dy
    else:
        xe0, ye0, dxc, dyc = _cell_origins(grid, bm.x.dtype, dev)
        sx = xe0 + (0.5 + off_x) * dxc
        sy = ye0 + (0.5 + off_y) * dyc
    new_x = torch.where(spawn, sx.to(bm.x.dtype), bm.x)
    new_y = torch.where(spawn, sy.to(bm.y.dtype), bm.y)
    new_mat = torch.where(spawn, majority[:, :, None], bm.mat)
    return spawn, new_x, new_y, new_mat


def bucket_reseed(bm: BucketedMarkers, T_grid, grid: StaggeredGrid,
                  min_per_cell: int, n_materials: int = 8,
                  periodic_x: bool = False):
    """Fill cells below ``min_per_cell`` up from empty slots: new markers at
    deterministic sub-cell positions, T from the grid, material = the 3x3
    neighbourhood majority (a one-hot histogram over ``n_materials``
    material ids; ties go to the lowest id, as ``jnp.argmax``; the
    neighbourhood wraps in x with ``periodic_x``)."""
    hist = material_histogram(bm, n_materials)
    acc = torch.zeros_like(hist)
    for a, b in OFFSETS:
        acc = acc + _shift3(hist, a, b, periodic_x)
    majority = torch.argmax(acc, dim=-1).to(torch.int32)
    spawn, new_x, new_y, new_mat = reseed_spawn(bm, majority, grid,
                                                min_per_cell)
    T_at = bucket_grid_to_markers(T_grid, new_x, new_y, spawn, grid, "corner",
                                  periodic_x=periodic_x)
    return bm.replace(x=new_x, y=new_y, T=torch.where(spawn, T_at.to(
        bm.T.dtype), bm.T), mat=new_mat, valid=bm.valid | spawn)
