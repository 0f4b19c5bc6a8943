"""Marker repopulation of starved cells for the flat engine (port of
``pylamp_tpu/markers/reseed.py``).

The population is fixed, so reseeding *moves* markers from the most
crowded cells into the most starved ones, at most ``max_moves`` per call:
the k-th starved cell (ascending count) receives the first marker of the
k-th most crowded cell, at the starved cell's center plus a golden-ratio
sub-cell offset, with T interpolated from the grid and the majority
material of the cell's 3x3 neighbourhood.  A move happens only where the
starved cell holds fewer than ``min_per_cell`` markers and the donor more
than ``2 * min_per_cell``.

Every sort is stable, as ``jnp.argsort``'s: counts tie everywhere in a
healthy field, and an unstable sort would pick other donors and other
starved cells.  Counts are integers (exact in any order).  Where two
moves name the same marker (an empty donor cell's "first marker" is the
next cell's), the later one is kept, as the reference's scatter keeps the
last update on its CPU.
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import _true_div
from pylamp_tpu_torch.markers.interp import grid_to_markers, node_coords
from pylamp_tpu_torch.markers.state import MarkerState


def cell_ids(x, y, grid: StaggeredGrid):
    """Flat id j * nx + i of each marker's cell."""
    if not grid.uniform:
        xe = node_coords(grid, "x_corner", grid.x_corner, x.dtype, x.device)
        ye = node_coords(grid, "y_corner", grid.y_corner, y.dtype, y.device)
        i = torch.clamp(torch.searchsorted(xe, x.contiguous(), right=True)
                        - 1, 0, grid.nx - 1)
        j = torch.clamp(torch.searchsorted(ye, y.contiguous(), right=True)
                        - 1, 0, grid.ny - 1)
        return j * grid.nx + i
    i = torch.clamp(_true_div(x, grid.dx).to(torch.int64), 0, grid.nx - 1)
    j = torch.clamp(_true_div(y, grid.dy).to(torch.int64), 0, grid.ny - 1)
    return j * grid.nx + i


def neighborhood_majority(hist, grid: StaggeredGrid, periodic_x=False):
    """hist (ncells, nmat) -> the majority material over each cell's 3x3
    neighbourhood (edge-padded, wrapped in x with ``periodic_x``); ties go
    to the lowest id."""
    nmat = hist.shape[1]
    h = hist.reshape(grid.ny, grid.nx, nmat)
    hp = torch.cat([h[:1], h, h[-1:]], dim=0)
    if periodic_x:
        hp = torch.cat([hp[:, -1:], hp, hp[:, :1]], dim=1)
    else:
        hp = torch.cat([hp[:, :1], hp, hp[:, -1:]], dim=1)
    acc = sum(hp[1 + dj: grid.ny + 1 + dj, 1 + di: grid.nx + 1 + di]
              for dj in (-1, 0, 1) for di in (-1, 0, 1))
    return torch.argmax(acc, dim=-1).reshape(-1).to(torch.int32)


def _last_of_each(idx):
    """Mask of the entries of ``idx`` that no later entry repeats."""
    sidx, perm = torch.sort(idx, stable=True)
    last = torch.ones_like(sidx, dtype=torch.bool)
    last[:-1] = sidx[1:] != sidx[:-1]
    keep = torch.empty_like(last)
    keep[perm] = last
    return keep


def reseed_starved(markers: MarkerState, T_grid, grid: StaggeredGrid,
                   n_materials: int, min_per_cell: int = 2,
                   max_moves: int = 256,
                   periodic_x: bool = False) -> MarkerState:
    dev = markers.x.device
    ncells = grid.nx * grid.ny
    max_moves = min(max_moves, ncells)
    cid = cell_ids(markers.x, markers.y, grid)
    cells = torch.arange(ncells, device=dev)

    # per-cell counts and material histograms from the sorted cell ids
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    seg_start = torch.searchsorted(sorted_cid, cells)
    counts = (torch.searchsorted(sorted_cid, cells, right=True)
              - seg_start).to(torch.int32)
    key = torch.sort(cid * n_materials + markers.mat.to(torch.int64))[0]
    slots = torch.arange(ncells * n_materials, device=dev)
    hist = (torch.searchsorted(key, slots, right=True)
            - torch.searchsorted(key, slots)).to(torch.int32)
    majority = neighborhood_majority(hist.reshape(ncells, n_materials), grid,
                                     periodic_x)

    starved_cells = torch.argsort(counts, stable=True)[:max_moves]
    donor_cells = torch.argsort(-counts, stable=True)[:max_moves]
    do_move = ((counts[starved_cells] < min_per_cell)
               & (counts[donor_cells] > 2 * min_per_cell))
    # the first marker of each donor cell (an empty cell's start is the
    # next cell's first marker; past the end, the last marker)
    donor_marker = order[torch.clamp(seg_start[donor_cells], max=markers.n
                                     - 1)]

    # destination: starved cell center + golden-ratio stagger (repeated
    # reseeds of one cell do not stack), in f64 as the reference's
    f64 = torch.float64
    sj = torch.div(starved_cells, grid.nx, rounding_mode="floor")
    si = starved_cells - sj * grid.nx
    k = torch.arange(max_moves, dtype=f64, device=dev)
    off_x = (torch.remainder(k * 0.381966, 1.0) - 0.5) * 0.5
    off_y = (torch.remainder(k * 0.618034, 1.0) - 0.5) * 0.5
    if grid.uniform:
        dst_x = (si.to(f64) + 0.5 + off_x) * grid.dx
        dst_y = (sj.to(f64) + 0.5 + off_y) * grid.dy
    else:
        xe = node_coords(grid, "x_corner", grid.x_corner, f64, dev)
        ye = node_coords(grid, "y_corner", grid.y_corner, f64, dev)
        dxs = node_coords(grid, "dxs", grid.dxs, f64, dev)
        dys = node_coords(grid, "dys", grid.dys, f64, dev)
        dst_x = xe[si] + (0.5 + off_x) * dxs[si]
        dst_y = ye[sj] + (0.5 + off_y) * dys[sj]
    T_at_dst = grid_to_markers(T_grid, dst_x, dst_y, grid, "corner",
                               periodic_x=periodic_x)

    keep = _last_of_each(donor_marker)
    tgt = donor_marker[keep]
    move = do_move[keep]

    def moved(field, new):
        out = field.clone()
        out[tgt] = torch.where(move, new[keep].to(field.dtype), field[tgt])
        return out

    return MarkerState(x=moved(markers.x, dst_x), y=moved(markers.y, dst_y),
                       mat=moved(markers.mat, majority[starved_cells]),
                       T=moved(markers.T, T_at_dst))
