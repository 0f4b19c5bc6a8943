"""Per-shard fused marker->grid transfer from one-ring-extended marker
blocks: wrapper of the CUDA kernel ``csrc/m2g_block.cu`` (replaces the TPU
kernel ``pylamp_tpu/markers/pallas/m2g_kernel.py:m2g_fused_block_pallas``).

Inputs are the (S, by+2, bx+2, K) marker streams of every shard with the
neighbours' markers exchanged into the ring (zeros, i.e. empty slots,
beyond the domain) and each shard's first own cell ``bases`` (S, 2) =
(row_base, col_base).  The output is the raw weighted-sum dict of kernel 2
(``m2g.OUT_ORDER`` names) with every plane (S, by+1, bx+1) in the shard's
node frame: entry (r, c) is global node (row_base + r, col_base + c),
complete for the shard's own nodes and the +1 seam row/column; nodes the
global lattice lacks are 0.  The caller keeps its own nodes plus the seam
strips (parallel/halo_markers.py).

``m2g_fused_block`` runs the plain PyTorch version (the dense-shift sums
of ``bucket.m2g_sums`` on the shard frame) on CPU tensors and launches the
kernel on CUDA tensors.  The kernel runs kernel 2's row-streamed gather on
``block_plan`` (``m2g.m2g_plan`` on the (by, bx) frame, all shards in one
launch); ``frame_blocks`` lists its blocks as the kernel computes them.

``periodic_x`` (periodic side walls; port-only: the reference keeps its
block kernels off there) takes the ring's cells as the wrapped columns
that they hold: a marker's x interval has no clamp and is counted from its
cell's wrapped column, as kernel 2's periodic form counts it, so every
node a shard keeps gets kernel 2p's sums.  The frame's last column is then
partial on every shard (its third cell column lies beyond the ring): the
caller takes the column-nx strip from column 0's owner.  The kernel's
periodic form (10p) counts in ``launches_periodic`` too.
"""
from __future__ import annotations

import ctypes

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import OFFSETS, _corners
from pylamp_tpu_torch.markers.kernels.m2g import (
    FLAG_ENERGY,
    FLAG_H,
    FLAG_PERIODIC,
    FLAG_RA,
    FLAG_VX,
    OUT_ORDER,
    M2GPlan,
    _lattice_streams,
    _streams,
    _table_struct,
    m2g_plan,
)
from pylamp_tpu_torch.physics.materials import MaterialTable

# resident blocks per SM of the kernel's forms (csrc/m2g_block.cu's launch
# bounds): kernel 2's 4, the periodic form 3 (its 92 registers do not fit
# 4 blocks without spilling)
BLOCKS_PER_SM = 4
BLOCKS_PER_SM_PERIODIC = 3

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, those of the periodic form and those with the
# rho0 * alpha stream
launches = 0
launches_periodic = 0
launches_ra = 0


def block_plan(S: int, by: int, bx: int, K: int) -> M2GPlan:
    """Kernel 10's plan: ``m2g_plan`` on the (by + 1) x (bx + 1) node frame
    of a shard (strips of 32 node columns, chunks of 32 node rows, K in
    units of at most 16 slots), the same on every shard.  At the 4x2
    mesh's 256x512 blocks x K18: 17 x 9 blocks a shard of 192 threads, two
    9-slot units a cell row.  Raises where the S extended blocks hold 2^31
    slots or more (the kernel indexes slots in 31 bits)."""
    if S * (by + 2) * (bx + 2) * K >= 2 ** 31:
        raise ValueError(f"m2g_block kernel: {S} extended blocks of "
                         f"{by + 2} x {bx + 2} x {K} slots (the kernel "
                         "indexes slots in 31 bits)")
    return m2g_plan(by, bx, K)


def frame_blocks(plan: M2GPlan, by: int, bx: int, bases, ny: int, nx: int,
                 periodic_x: bool = False):
    """Every block of kernel 10's launch in launch order, as
    csrc/m2g_block.cu computes it: (shard, node rows j_lo..j_hi-1, node
    columns i0..i0+txe-1, cell rows r_lo..r_hi, cell columns c_lo..c_hi),
    all global (``periodic_x``: the cell columns are the ring's, unclamped,
    each wrapped into the period where it is read); a block streams the
    cell rows max(j_lo - 1, r_lo) .. min(j_hi, r_hi), and node J completes
    at cell row min(J + 1, r_hi).  The grid is (chunk, shard, strip), chunk
    fastest: every shard's last strip goes last."""
    for strip in range(plan.nstrips):
        for s, (row_base, col_base) in enumerate(bases.tolist()):
            for chunk in range(plan.nchunks):
                c0, j0 = strip * plan.tx, chunk * plan.rows
                i0, j_lo = col_base + c0, row_base + j0
                cols = min(plan.tx, bx + 1 - c0)
                rows = min(plan.rows, by + 1 - j0)
                c_lo, c_hi = col_base - 1, col_base + bx
                if not periodic_x:
                    c_lo, c_hi = max(c_lo, 0), min(c_hi, nx - 1)
                yield (s, j_lo, min(j_lo + rows, ny + 1), i0,
                       min(cols, nx + 1 - i0), max(row_base - 1, 0),
                       min(row_base + by, ny - 1), c_lo, c_hi)


def kernel_info(plan: M2GPlan, flags: int) -> dict:
    """Occupancy of the instantiation ``flags`` picks (FLAG_RA with
    FLAG_ENERGY) at ``plan``'s strips and units, from the card's function
    attributes: registers per thread, static and dynamic shared bytes,
    local (spill) bytes per thread, threads and resident blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().m2g_block_kernel_info(
        plan.tx, plan.kc, plan.split, flags, out),
        "m2g_block (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def _frame_iota(bases, bye: int, bxe: int):
    """Global (cj, ci) of every extended-block cell, broadcastable against
    (S, by+2, bx+2, K)."""
    S = bases.shape[0]
    dev = bases.device
    rb = bases[:, 0].to(torch.int64).view(S, 1, 1, 1)
    cb = bases[:, 1].to(torch.int64).view(S, 1, 1, 1)
    cj = rb - 1 + torch.arange(bye, device=dev).view(1, bye, 1, 1)
    ci = cb - 1 + torch.arange(bxe, device=dev).view(1, 1, bxe, 1)
    return cj, ci


def m2g_block_sums(xe, ye, ve, values, grid: StaggeredGrid, loc: str, bases,
                   periodic_x: bool = False):
    """Raw weighted sums on the ``loc`` lattice over every shard's node
    frame: (sum w, [sum w * v for v in values]), each (S, by+1, bx+1).
    Extended cell (er, ec) reaches node (er - 1 + a, ec - 1 + b) for the 9
    offsets, as in ``bucket.m2g_sums`` (``periodic_x``: x intervals
    unclamped, offsets from each cell's wrapped column)."""
    S, bye, bxe, _ = xe.shape
    by, bx = bye - 2, bxe - 2
    oy, ox = grid.origin(loc)
    ny_n, nx_n = grid.shape(loc)
    fx = (xe - ox) / grid.dx
    fy = (ye - oy) / grid.dy
    i0 = torch.floor(fx)
    if not periodic_x:
        i0 = torch.clamp(i0, 0, nx_n - 2)
    i0 = i0.to(torch.int64)
    j0 = torch.clamp(torch.floor(fy), 0, ny_n - 2).to(torch.int64)
    tx = torch.clamp(fx - i0, 0.0, 1.0)
    ty = torch.clamp(fy - j0, 0.0, 1.0)
    cj, ci = _frame_iota(bases, bye, bxe)
    if periodic_x:
        ci = torch.remainder(ci, grid.nx)
    o_j, o_i = j0 - cj, i0 - ci
    corners = _corners(ty, tx)
    field_w = torch.zeros((S, by + 1, bx + 1), dtype=xe.dtype,
                          device=xe.device)
    fields_wv = [torch.zeros_like(field_w) for _ in values]
    zero = torch.zeros((S, bye, bxe), dtype=xe.dtype, device=xe.device)
    for a, b in OFFSETS:
        s_w = zero
        s_wv = [zero for _ in values]
        for dj, di, w in corners:
            sel = (o_j + dj == a) & (o_i + di == b) & ve
            wm = torch.where(sel, w, 0.0)
            s_wv = [s + torch.sum(wm * v, dim=-1) for s, v in zip(s_wv, values)]
            s_w = s_w + torch.sum(wm, dim=-1)
        # node r <- extended cell r + 1 - a, within both frames
        r_lo, r_hi = max(0, a - 1), min(by + 1, bye + a - 1)
        c_lo, c_hi = max(0, b - 1), min(bx + 1, bxe + b - 1)
        dst = (slice(None), slice(r_lo, r_hi), slice(c_lo, c_hi))
        src = (slice(None), slice(r_lo + 1 - a, r_hi + 1 - a),
               slice(c_lo + 1 - b, c_hi + 1 - b))
        field_w[dst] += s_w[src]
        for f, s in zip(fields_wv, s_wv):
            f[dst] += s[src]
    # nodes the global lattice lacks
    rb = bases[:, 0].to(torch.int64).view(S, 1, 1)
    cb = bases[:, 1].to(torch.int64).view(S, 1, 1)
    J = rb + torch.arange(by + 1, device=xe.device).view(1, by + 1, 1)
    I = cb + torch.arange(bx + 1, device=xe.device).view(1, 1, bx + 1)
    node = (J < ny_n) & (I < nx_n)
    return (torch.where(node, field_w, 0.0),
            [torch.where(node, f, 0.0) for f in fields_wv])


def m2g_fused_block_plain(xe, ye, Te, me, ve, grid: StaggeredGrid,
                          table: MaterialTable, phys, bases,
                          with_energy: bool = False, with_ra: bool = False,
                          periodic_x: bool = False):
    """Plain PyTorch version: marker properties, then ``m2g_block_sums``
    on each lattice."""
    out = {}
    for loc, wname, streams in _lattice_streams(Te, me, ve, table, phys,
                                                with_energy, xe.dtype,
                                                with_ra):
        w, wvs = m2g_block_sums(xe, ye, ve, list(streams.values()), grid,
                                loc, bases, periodic_x)
        out[wname] = w
        out.update(zip(streams.keys(), wvs))
    return out


def _check(name, t, dtype, shape):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_cuda
            or not t.is_contiguous()):
        raise ValueError(
            f"m2g_block kernel: {name} must be a contiguous CUDA {dtype} "
            f"tensor of shape {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def m2g_fused_block_cuda(xe, ye, Te, me, ve, grid: StaggeredGrid,
                         table: MaterialTable, phys, bases,
                         with_energy: bool = False, with_ra: bool = False,
                         periodic_x: bool = False):
    global launches, launches_periodic, launches_ra
    S, bye, bxe, K = xe.shape
    by, bx = bye - 2, bxe - 2
    for name, t, dtype in (("x", xe, torch.float32), ("y", ye, torch.float32),
                           ("T", Te, torch.float32), ("mat", me, torch.int32),
                           ("valid", ve, torch.bool)):
        _check(name, t, dtype, (S, bye, bxe, K))
    _check("bases", bases, torch.int32, (S, 2))
    with_vx, with_h, with_ra, names = _streams(table, phys, with_energy,
                                               with_ra)
    dev = xe.device
    out = {name: torch.empty((S, by + 1, bx + 1), dtype=torch.float32,
                             device=dev) for name in names}
    ptrs = (ctypes.c_void_p * len(OUT_ORDER))(
        *[out[name].data_ptr() if name in out else None for name in OUT_ORDER])
    tbl = _table_struct(table, phys)
    flags = ((FLAG_VX * with_vx) | (FLAG_ENERGY * with_energy)
             | (FLAG_H * with_h) | (FLAG_RA * with_ra)
             | (FLAG_PERIODIC * periodic_x))
    plan = block_plan(S, by, bx, K)
    code = cuda_build.library().launch_m2g_block(
        xe.data_ptr(), ye.data_ptr(), Te.data_ptr(), me.data_ptr(),
        ve.data_ptr(), bases.data_ptr(), ctypes.addressof(tbl),
        ctypes.addressof(ptrs), S, grid.ny, grid.nx, by, bx, K, grid.dx,
        grid.dy, flags, plan.tx, plan.rows, plan.kc, plan.units, plan.split,
        cuda_build.stream_ptr(dev))
    cuda_build.check(code, "m2g_block")
    launches += 1
    launches_periodic += periodic_x
    launches_ra += with_ra
    return out


def m2g_fused_block(xe, ye, Te, me, ve, grid: StaggeredGrid,
                    table: MaterialTable, phys, bases,
                    with_energy: bool = False, with_ra: bool = False,
                    periodic_x: bool = False):
    """Raw weighted-sum planes of every stream on the shards' node frames:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if xe.is_cuda:
        return m2g_fused_block_cuda(xe, ye, Te, me, ve, grid, table, phys,
                                    bases, with_energy, with_ra, periodic_x)
    return m2g_fused_block_plain(xe, ye, Te, me, ve, grid, table, phys, bases,
                                 with_energy, with_ra, periodic_x)
