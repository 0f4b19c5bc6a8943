"""Marker <-> grid transfer of the flat engine (port of
``pylamp_tpu/markers/interp.py``).

marker -> grid: bilinear weights to the 4 surrounding nodes of the target
lattice, summed per node and normalized (a weighted arithmetic mean, with
geometric and harmonic options for viscosity).  The reference sums with
XLA's scatter-add, which is deterministic on its devices; ``index_add_``
on a CUDA tensor adds floats with atomics in whatever order they land.  So
the sums here are a sorted segment sum (``segment_sum``): a stable sort of
the flat node index, each node's contributions laid out in sorted order
in one row of a dense table, the rows reduced by ``torch.sum``.  The
result is the same bits on every run on a device.

grid -> marker: bilinear gather from the lattice.  A stretched grid
locates by binary search over the node coordinates
(``torch.searchsorted(..., right=True)``, the reference's
``side="right"``); periodic side walls need a uniform grid.
"""
from __future__ import annotations

import numpy as np
import torch

from pylamp_tpu_torch.core.grid import StaggeredGrid

ARITHMETIC = "arithmetic"
GEOMETRIC = "geometric"
HARMONIC = "harmonic"


def node_coords(grid: StaggeredGrid, name: str, coords, dtype, device):
    """A 1-D coordinate array (f64 numpy) as a tensor of ``dtype`` on
    ``device``, cached on the grid under ``name``."""
    key = ("flat_coords", name, dtype, torch.device(device))
    cache = grid.tensor_cache
    if key not in cache:
        cache[key] = torch.from_numpy(np.asarray(coords, np.float64)).to(
            dtype=dtype, device=device)
    return cache[key]


def locate_sorted(q, nodes):
    """Node interval i0 of each query (nodes[i0] <= q < nodes[i0 + 1],
    clipped to [0, len(nodes) - 2]) and the local coordinate in [0, 1]."""
    i0 = torch.clamp(torch.searchsorted(nodes, q.contiguous(), right=True)
                     - 1, 0, nodes.shape[0] - 2)
    lo, hi = nodes[i0], nodes[i0 + 1]
    return i0, torch.clamp((q - lo) / (hi - lo), 0.0, 1.0)


def _locate(px, py, grid: StaggeredGrid, loc: str, periodic_x: bool = False):
    """Cell (j0, i0) of each marker within the ``loc`` lattice and its local
    coordinates (ty, tx) in [0, 1], clamped so that markers beyond the
    outermost nodes use the outermost cell.  ``periodic_x``: no x clamp,
    i0 may be -1 on the half-offset lattices (callers wrap the node
    columns with period nx)."""
    ny_n, nx_n = grid.shape(loc)
    if not grid.uniform:
        if periodic_x:
            raise ValueError("periodic side walls need a uniform grid")
        ys, xs = grid.coords(loc)
        i0, tx = locate_sorted(px, node_coords(grid, f"x_{loc}", xs,
                                               px.dtype, px.device))
        j0, ty = locate_sorted(py, node_coords(grid, f"y_{loc}", ys,
                                               py.dtype, py.device))
        return j0, i0, ty, tx
    oy, ox = grid.origin(loc)
    fx = (px - ox) / grid.dx
    fy = (py - oy) / grid.dy
    i0 = torch.floor(fx)
    if not periodic_x:
        i0 = torch.clamp(i0, 0, nx_n - 2)
    j0 = torch.clamp(torch.floor(fy), 0, ny_n - 2)
    tx = torch.clamp(fx - i0, 0.0, 1.0)
    ty = torch.clamp(fy - j0, 0.0, 1.0)
    return j0.to(torch.int64), i0.to(torch.int64), ty, tx


def _weights(ty, tx):
    return ((1.0 - ty) * (1.0 - tx), (1.0 - ty) * tx, ty * (1.0 - tx),
            ty * tx)


def segment_sum(idx, vals, n: int):
    """Per-index sums of the rows of ``vals`` (M, C) over ``idx`` (M,) in
    [0, n): (n, C), in an order fixed by the data alone.  A stable sort
    groups each index's rows in their original order; they fill one row
    of a dense (n, longest segment, C) table, and ``torch.sum`` reduces
    it.  The table's width is read on the host (one sync)."""
    sidx, perm = torch.sort(idx, stable=True)
    nodes = torch.arange(n, dtype=sidx.dtype, device=sidx.device)
    start = torch.searchsorted(sidx, nodes)
    count = torch.searchsorted(sidx, nodes, right=True) - start
    width = max(int(torch.max(count)), 1) if n else 1
    rank = torch.arange(sidx.shape[0], device=sidx.device) - start[sidx]
    table = torch.zeros((n, width, vals.shape[1]), dtype=vals.dtype,
                        device=vals.device)
    table[sidx, rank] = vals[perm]
    return torch.sum(table, dim=1)


def markers_to_grid(px, py, values, grid: StaggeredGrid, loc: str,
                    mode: str = ARITHMETIC, weight_power: float = 1.0,
                    periodic_x: bool = False):
    """Weighted mean of marker ``values`` on the ``loc`` lattice.

    Returns (field, wsum): the field and the per-node weight sum (0 marks
    a marker-starved node; the caller chooses the fallback).  The sums
    accumulate in ``values``' dtype, as the reference's.
    ``periodic_x``: node columns wrap with period nx; lattices with a
    duplicated seam column return equal values in columns 0 and nx."""
    ny_n, nx_n = grid.shape(loc)
    j0, i0, ty, tx = _locate(px, py, grid, loc, periodic_x)
    ws = _weights(ty, tx)
    if weight_power != 1.0:
        ws = tuple(w ** weight_power for w in ws)
    if mode == ARITHMETIC:
        v = values
    elif mode == GEOMETRIC:
        v = torch.log(values)
    elif mode == HARMONIC:
        v = 1.0 / values
    else:
        raise ValueError(f"unknown averaging mode {mode!r}")

    nxu = grid.nx if periodic_x else nx_n  # unique node columns
    dtype = values.dtype
    idx, rows = [], []
    for dj, di, w in ((0, 0, ws[0]), (0, 1, ws[1]), (1, 0, ws[2]),
                      (1, 1, ws[3])):
        col = torch.remainder(i0 + di, nxu) if periodic_x else i0 + di
        idx.append((j0 + dj) * nxu + col)
        rows.append(torch.stack([(w * v).to(dtype), w.to(dtype)], dim=1))
    sums = segment_sum(torch.cat(idx), torch.cat(rows), ny_n * nxu)
    flat_wv, flat_w = sums[:, 0], sums[:, 1]
    wsum = flat_w.reshape(ny_n, nxu)
    mean = (flat_wv / torch.where(flat_w == 0, 1.0, flat_w)).reshape(ny_n,
                                                                     nxu)
    if periodic_x and nx_n == grid.nx + 1:
        mean = torch.cat([mean, mean[:, :1]], dim=1)
        wsum = torch.cat([wsum, wsum[:, :1]], dim=1)
    if mode == GEOMETRIC:
        mean = torch.exp(mean)
    elif mode == HARMONIC:
        mean = 1.0 / torch.where(mean == 0, 1.0, mean)
    return mean, wsum


def grid_to_markers(field, px, py, grid: StaggeredGrid, loc: str,
                    periodic_x: bool = False):
    """Bilinear gather of a ``loc`` lattice field onto markers."""
    j0, i0, ty, tx = _locate(px, py, grid, loc, periodic_x)
    w00, w01, w10, w11 = _weights(ty, tx)
    if periodic_x:
        f = field[:, : grid.nx]  # unique columns (period nx)
        i0 = torch.remainder(i0, grid.nx)
        i1 = torch.remainder(i0 + 1, grid.nx)
    else:
        f = field
        i1 = i0 + 1
    return (w00 * f[j0, i0] + w01 * f[j0, i1] + w10 * f[j0 + 1, i0]
            + w11 * f[j0 + 1, i1])
