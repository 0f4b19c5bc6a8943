"""Marker re-bucketing: wrapper of the CUDA kernel ``csrc/rebucket.cu``
(replaces the TPU kernel
``pylamp_tpu/markers/pallas/rebucket_kernel.py:rebucket_pallas``).

``rebucket_fused`` runs the plain PyTorch version (``rebucket_plain``, the
port of ``bucket.rebucket``) on CPU tensors and launches the kernel on
CUDA tensors.  Both give identical buckets slot for slot and the same
drop count.  Layout stays (ny, nx, K).  ``periodic_x`` selects the
periodic form (the 3x3 neighbourhood wraps in x, nx >= 3); its launches
also count in ``launches_periodic``.  ``rebucket_plan`` gives the kernel's
launch geometry (strip width, rows per chunk, shared memory).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.markers.bucket import rebucket as rebucket_plain
from pylamp_tpu_torch.markers.kernels import check_markers

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, and those of the periodic form
launches = 0
launches_periodic = 0

# csrc/rebucket_rows.cuh's constants (kernels 4 and 12) and the H100's
# shared memory
THREADS = 256
RING = 4  # source rows held in shared memory
STRIP_WIDTHS = (32, 16, 8, 4, 2, 1)  # target columns of a block, widest first
CHUNK_ROWS = 32  # target rows of a block
SMEM_BLOCK_MAX = 232448  # 227 KB: the most one block may use
SMEM_SM = 233472  # 228 KB of shared memory per SM
SMEM_RESERVED = 1024  # the runtime's share of each resident block
MAX_THREADS_SM = 2048


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def smem_bytes(tx: int, K: int) -> int:
    """Dynamic shared bytes of a block with strips of ``tx`` columns (the
    Layout of csrc/rebucket_rows.cuh, kernels 4 and 12): RING ring rows of
    (tx + 2) K slots (x, y, T, mat: 16 bytes a slot; 9 target masks of
    ceil(K / 32) words per cell; two counts of the slots that change rows;
    the valid bytes, which the codes overwrite, of three runs, each with
    up to 3 bytes of alignment lead), the output row of tx K slots (16
    bytes a slot), 9 insertion offsets and a count per target, one drop
    sum per warp."""
    row = (16 * (tx + 2) * K + 36 * math.ceil(K / 32) * (tx + 2) + 8
           + 2 * _round4(K + 3) + _round4(tx * K + 3))
    return RING * row + 16 * tx * K + 40 * tx + 4 * (THREADS // 32)


def blocks_per_sm(smem: int) -> int:
    """Resident blocks per SM that shared memory and threads allow."""
    return min(SMEM_SM // (smem + SMEM_RESERVED), MAX_THREADS_SM // THREADS)


class RebucketPlan(NamedTuple):
    """How csrc/rebucket.cu covers an (ny, nx) grid of target cells (and
    csrc/rebucket_block.cu each shard's (by, bx) block): blocks
    of ``tx`` columns by ``rows`` rows (the last strip and chunk take what
    is left), ``nstrips`` x ``nchunks`` of them, ``smem`` dynamic shared
    bytes each."""
    tx: int
    rows: int
    nstrips: int
    nchunks: int
    smem: int

    def extents(self, ny: int, nx: int):
        """Every block's target cells as (row0, rows, col0, cols)."""
        for cy in range(self.nchunks):
            j0 = cy * self.rows
            for sx in range(self.nstrips):
                i0 = sx * self.tx
                yield j0, min(self.rows, ny - j0), i0, min(self.tx, nx - i0)


def repack_fits(K: int) -> bool:
    """Whether a block of the narrowest strip holds K slots a cell: the
    capacities ``rebucket_plan`` (and so kernels 4 and 12) take, K <= 993."""
    return smem_bytes(STRIP_WIDTHS[-1], K) <= SMEM_BLOCK_MAX


@functools.lru_cache(maxsize=64)
def rebucket_plan(ny: int, nx: int, K: int) -> RebucketPlan:
    """The widest strip whose block leaves room for 2 resident blocks per
    SM (else the widest that fits at all; none fits past K = 993), and
    chunks of CHUNK_ROWS rows: at 1024^2 x K18, 32 x 32 blocks of 32
    columns, 56 KB each (room for 4 per SM; the kernel's 80 registers a
    thread allow 3)."""
    if not repack_fits(K):
        raise ValueError(f"rebucket kernel: K = {K} slots per cell do not "
                         "fit one block's shared memory")
    fits = [tx for tx in STRIP_WIDTHS if smem_bytes(tx, K) <= SMEM_BLOCK_MAX]
    two = [tx for tx in fits if blocks_per_sm(smem_bytes(tx, K)) >= 2]
    tx = (two or fits)[0]
    rows = min(CHUNK_ROWS, ny)
    return RebucketPlan(tx, rows, math.ceil(nx / tx), math.ceil(ny / rows),
                        smem_bytes(tx, K))


def kernel_info(K: int, tx: int, periodic: bool = False) -> dict:
    """Occupancy of the kernel (``periodic``: its periodic form) with strips
    of ``tx`` columns at ``K`` slots, from the card's function attributes:
    registers per thread, static and dynamic shared bytes, local (spill)
    bytes per thread, threads and resident blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().rebucket_kernel_info(
        K, tx, int(periodic), out), "rebucket (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def rebucket_cuda(bm: BucketedMarkers, grid: StaggeredGrid,
                  periodic_x: bool = False):
    global launches, launches_periodic
    check_markers(bm, "rebucket")
    ny, nx, K = bm.x.shape
    if periodic_x and nx < 3:
        raise ValueError(f"periodic rebucketing needs nx >= 3, got {nx}")
    plan = rebucket_plan(ny, nx, K)
    ox, oy, oT = (torch.empty_like(bm.x), torch.empty_like(bm.y),
                  torch.empty_like(bm.T))
    omat = torch.empty_like(bm.mat)
    ovalid = torch.empty_like(bm.valid)
    dropped = torch.zeros((), dtype=torch.int64, device=bm.x.device)
    code = cuda_build.library().launch_rebucket(
        bm.x.data_ptr(), bm.y.data_ptr(), bm.T.data_ptr(), bm.mat.data_ptr(),
        bm.valid.data_ptr(), ox.data_ptr(), oy.data_ptr(), oT.data_ptr(),
        omat.data_ptr(), ovalid.data_ptr(), dropped.data_ptr(), ny, nx, K,
        grid.dx, grid.dy, plan.tx, plan.rows, int(periodic_x),
        cuda_build.stream_ptr(bm.x.device))
    cuda_build.check(code, "rebucket")
    launches += 1
    launches_periodic += bool(periodic_x)
    return BucketedMarkers(x=ox, y=oy, mat=omat, T=oT, valid=ovalid), dropped


def rebucket_fused(bm: BucketedMarkers, grid: StaggeredGrid,
                   periodic_x: bool = False):
    """(new_bm, dropped): the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if bm.x.is_cuda:
        return rebucket_cuda(bm, grid, periodic_x)
    return rebucket_plain(bm, grid, periodic_x)
