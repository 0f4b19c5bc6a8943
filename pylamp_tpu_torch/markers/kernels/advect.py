"""Fused RK4 marker advection: wrapper of the CUDA kernel
``csrc/advect.cu`` (replaces the TPU kernel
``pylamp_tpu/markers/pallas/advect_kernel.py:advect_rk4_pallas``).

``advect_rk4_fused`` runs the plain PyTorch version (``advect_rk4_plain``,
the port of ``bucket.bucket_advect_rk4``) on CPU tensors and launches the
kernel on CUDA tensors.  The ghost-padded velocity lattices are built here
exactly as in the reference (``bucket.padded_velocities``) and shared by
both versions.  ``stage_reach`` (1 or 2) is the precondition that stage
displacements stay within that many cells; like the reference, a node
outside the window does not contribute.

Periodic side walls launch the kernel's periodic form, counted in
``launches_periodic`` as well: as the reference's wrapper does, this one
builds wrapped column planes of the padded lattices (``wrapped_planes``),
so the kernel samples x without a clamp, and the kernel wraps the new x
into [0, lx) with the TPU kernel's formula.  ``advect_plan`` gives the
kernel's launch geometry (tile, slots a round, shared memory).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import BucketedMarkers, padded_velocities
from pylamp_tpu_torch.markers.bucket import bucket_advect_rk4 as advect_rk4_plain
from pylamp_tpu_torch.markers.kernels import check_markers
from pylamp_tpu_torch.markers.kernels.rebucket import (
    MAX_THREADS_SM,
    SMEM_BLOCK_MAX,
    SMEM_RESERVED,
    SMEM_SM,
)

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, and those of the periodic form
launches = 0
launches_periodic = 0

# columns of wrap padding on each side of a periodic plane
# (csrc/advect_tile.cuh PADW): stage positions reach at most 2 cells past
# their bucket cell
PADW = 3

# the constants of csrc/advect_tile.cuh (kernels 3 and 11)
THREADS = 256
MARGIN = 3  # window nodes beyond the tile on each side
TILE_COLS = 32  # cells of a tile row
MAX_TILE_ROWS = 8
CAP = 2048  # most slots a round (a multiple of THREADS)
MAX_K = 2047  # slots a cell: the list's slot field
SMEM_STATIC = 4  # the live count


def smem_bytes(ty: int, tx: int, cap: int) -> int:
    """Dynamic shared bytes of a block with tiles of ``ty`` x ``tx`` cells
    and rounds of ``cap`` slots (the Layout of csrc/advect_tile.cuh): two
    velocity windows of (ty + 2 MARGIN) x (tx + 2 MARGIN) floats and a list
    of cap live slots at 12 bytes."""
    return 8 * (ty + 2 * MARGIN) * (tx + 2 * MARGIN) + 12 * cap


def blocks_per_sm(smem: int) -> int:
    """Resident blocks per SM that shared memory and threads allow."""
    return min(SMEM_SM // (smem + SMEM_STATIC + SMEM_RESERVED),
               MAX_THREADS_SM // THREADS)


class AdvectPlan(NamedTuple):
    """How csrc/advect.cu covers an (ny, nx) grid of cells: tiles of ``ty``
    x ``tx`` cells (the last ones take what is left), ``ntx`` x ``nty`` of
    them, each walking its slots in rounds of at most ``cap``, ``smem``
    dynamic shared bytes each."""
    ty: int
    tx: int
    cap: int
    ntx: int
    nty: int
    smem: int

    def extents(self, ny: int, nx: int):
        """Every block's cells as (row0, rows, col0, cols)."""
        for ty in range(self.nty):
            j0 = ty * self.ty
            for tx in range(self.ntx):
                i0 = tx * self.tx
                yield j0, min(self.ty, ny - j0), i0, min(self.tx, nx - i0)


@functools.lru_cache(maxsize=64)
def advect_plan(ny: int, nx: int, K: int) -> AdvectPlan:
    """Tiles TILE_COLS cells wide (nx if narrower) and as many rows (up to
    MAX_TILE_ROWS) as CAP slots hold; a round takes the tile's slots, up
    to CAP.  At 1024^2 x K18: 342 x 32 tiles of 3 x 32 cells (1,728
    slots, one round), 24 KB each."""
    if not 1 <= K <= MAX_K:
        raise ValueError(f"advect kernel: K = {K} slots per cell, the "
                         f"kernel takes 1..{MAX_K}")
    tx = min(TILE_COLS, nx)
    ty = max(1, min(MAX_TILE_ROWS, ny, CAP // (tx * K)))
    cap = min(CAP, math.ceil(ty * tx * K / THREADS) * THREADS)
    smem = smem_bytes(ty, tx, cap)
    if smem + SMEM_STATIC > SMEM_BLOCK_MAX:
        raise ValueError("advect kernel: a tile does not fit one block's "
                         "shared memory")
    return AdvectPlan(ty, tx, cap, math.ceil(nx / tx), math.ceil(ny / ty),
                      smem)


def kernel_info(plan: AdvectPlan, periodic: bool = False) -> dict:
    """Occupancy of the kernel (``periodic``: its periodic form) at
    ``plan``'s tiles, from the card's function attributes: registers per
    thread, static and dynamic shared bytes, local (spill) bytes per
    thread, threads and resident blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().advect_kernel_info(
        plan.ty, plan.tx, plan.cap, int(periodic), out),
        "advect (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def wrapped_planes(vx_p, vy_p, nx: int):
    """The periodic kernel's velocity planes: column PADW + c of each holds
    the padded lattice's column c wrapped into its period (vx_p: c mod nx;
    vy_p, whose column 0 is a ghost: 1 + (c - 1) mod nx), for c in
    [-PADW, nx + PADW)."""
    c = torch.arange(-PADW, nx + PADW, device=vx_p.device)
    return (vx_p[:, c % nx].contiguous(),
            vy_p[:, 1 + (c - 1) % nx].contiguous())


def advect_rk4_cuda(bm: BucketedMarkers, vx, vy, dt, grid: StaggeredGrid,
                    bcs: VelocityBCs, stage_reach: int = 1):
    global launches, launches_periodic
    if stage_reach not in (1, 2):
        raise ValueError(f"stage_reach must be 1 or 2, got {stage_reach}")
    check_markers(bm, "advect", positions_only=True)
    ny, nx, K = bm.x.shape
    dev = bm.x.device
    f32 = torch.float32
    vx_p, vy_p = padded_velocities(vx.to(f32), vy.to(f32), bcs)
    vx_p, vy_p = vx_p.contiguous(), vy_p.contiguous()
    if tuple(vx_p.shape) != (ny + 2, nx + 1) or tuple(vy_p.shape) != (ny + 1, nx + 2):
        raise ValueError("advect kernel: velocity shapes do not match the "
                         f"markers' ({ny}, {nx}) cells")
    if bcs.periodic_x:
        vx_p, vy_p = wrapped_planes(vx_p, vy_p, nx)
    dt_t = torch.as_tensor(dt, dtype=f32, device=dev).reshape(1).contiguous()
    out_x = torch.empty_like(bm.x)
    out_y = torch.empty_like(bm.y)
    eps_x = 1e-6 * grid.dx_min
    eps_y = 1e-6 * grid.dy_min
    plan = advect_plan(ny, nx, K)
    code = cuda_build.library().launch_advect(
        bm.x.data_ptr(), bm.y.data_ptr(), bm.valid.data_ptr(),
        vx_p.data_ptr(), vy_p.data_ptr(), dt_t.data_ptr(), out_x.data_ptr(),
        out_y.data_ptr(), ny, nx, K, grid.dx, grid.dy, eps_x,
        grid.lx - eps_x, eps_y, grid.ly - eps_y, stage_reach,
        int(bcs.periodic_x), grid.lx, 1.0 / grid.lx, plan.ty, plan.tx,
        plan.cap, cuda_build.stream_ptr(dev))
    cuda_build.check(code, "advect")
    launches += 1
    launches_periodic += bcs.periodic_x
    return bm.replace(x=out_x, y=out_y)


def advect_rk4_fused(bm: BucketedMarkers, vx, vy, dt, grid: StaggeredGrid,
                     bcs: VelocityBCs, stage_reach: int = 1):
    """RK4-advected markers (positions only): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if bm.x.is_cuda:
        return advect_rk4_cuda(bm, vx, vy, dt, grid, bcs, stage_reach)
    return advect_rk4_plain(bm, vx, vy, dt, grid, bcs, stage_reach)
