"""Per-shard marker re-bucketing from one-ring-extended marker blocks:
wrapper of the CUDA kernel ``csrc/rebucket_block.cu`` (replaces the TPU
kernel ``pylamp_tpu/markers/pallas/rebucket_kernel.py:rebucket_block_pallas``).

Inputs are the (S, by+2, bx+2, K) marker streams of every shard with the
neighbours' markers exchanged into the ring (empty slots beyond the
domain) and each shard's first own cell ``bases`` (S, 2).  Returns the
shards' own repacked buckets (S, by, bx, K) and the arrivals per cell
(S, by, bx), from candidates in the single-device order: bit-identical to
``bucket.rebucket`` on the global markers.

``rebucket_block`` runs the plain PyTorch version (``rebucket_block_plain``,
``bucket.rebucket``'s candidate slabs cut from the extended blocks) on CPU
tensors and launches the kernel on CUDA tensors.  ``periodic_x``
(periodic side walls; port-only: the reference keeps its block kernels off
there) takes the ring's cells as the wrapped columns they hold: a marker
whose x crossed the seam goes to the cell its x names on the far shard,
in kernel 4's periodic candidate order (the plain version needs no change
for it: a candidate goes to an own cell that its target names); the
kernel's periodic form (12p) counts in ``launches_periodic`` too.  The
kernel is kernel 4's row-streamed repack (``csrc/rebucket_rows.cuh``) on
every shard, on ``rebucket.rebucket_plan(by, bx, K)``'s strips and
chunks; it takes K up to 993 (``rebucket.repack_fits``: the mesh path's
gate routes larger K to the plain version).
"""
from __future__ import annotations

import ctypes

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import (
    OFFSETS,
    BucketedMarkers,
    pack_candidates,
    target_cells,
)
from pylamp_tpu_torch.markers.kernels.rebucket import rebucket_plan

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, and those of the periodic form
launches = 0
launches_periodic = 0


def rebucket_block_plain(xe, ye, Te, me, ve, grid: StaggeredGrid, bases):
    """(BucketedMarkers of (S, by, bx, K), arrivals (S, by, bx) int64)."""
    S, bye, bxe, K = xe.shape
    by, bx = bye - 2, bxe - 2
    dev = xe.device
    tj, ti = target_cells(xe, ye, grid)
    cj = (bases[:, 0].to(torch.int64).view(S, 1, 1, 1)
          + torch.arange(by, device=dev).view(1, by, 1, 1))
    ci = (bases[:, 1].to(torch.int64).view(S, 1, 1, 1)
          + torch.arange(bx, device=dev).view(1, 1, bx, 1))
    streams = {"x": xe, "y": ye, "T": Te, "mat": me}
    takes, cands = [], {name: [] for name in streams}
    for a, b in OFFSETS:
        # own cell (r, c) takes from extended cell (r + 1 + a, c + 1 + b)
        sl = (slice(None), slice(1 + a, 1 + a + by), slice(1 + b, 1 + b + bx))
        takes.append(ve[sl] & (tj[sl] == cj) & (ti[sl] == ci))
        for name, arr in streams.items():
            cands[name].append(arr[sl])
    return pack_candidates(takes, cands, K)


def kernel_info(K: int, tx: int, periodic: bool = False) -> dict:
    """Occupancy of the kernel (``periodic``: its periodic form) with
    strips of ``tx`` columns at ``K`` slots, from the card's function
    attributes: registers per thread, static and dynamic shared bytes,
    local (spill) bytes per thread, threads and resident blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().rebucket_block_kernel_info(
        K, tx, int(periodic), out), "rebucket_block (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def _check(name, t, dtype, shape):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_cuda
            or not t.is_contiguous()):
        raise ValueError(
            f"rebucket_block kernel: {name} must be a contiguous CUDA "
            f"{dtype} tensor of shape {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def rebucket_block_cuda(xe, ye, Te, me, ve, grid: StaggeredGrid, bases,
                        periodic_x: bool = False):
    global launches, launches_periodic
    S, bye, bxe, K = xe.shape
    by, bx = bye - 2, bxe - 2
    for name, t, dtype in (("x", xe, torch.float32), ("y", ye, torch.float32),
                           ("T", Te, torch.float32), ("mat", me, torch.int32),
                           ("valid", ve, torch.bool)):
        _check(name, t, dtype, (S, bye, bxe, K))
    _check("bases", bases, torch.int32, (S, 2))
    plan = rebucket_plan(by, bx, K)
    dev = xe.device
    own = (S, by, bx, K)
    ox = torch.empty(own, dtype=torch.float32, device=dev)
    oy, oT = torch.empty_like(ox), torch.empty_like(ox)
    omat = torch.empty(own, dtype=torch.int32, device=dev)
    ovalid = torch.empty(own, dtype=torch.bool, device=dev)
    arrivals = torch.empty((S, by, bx), dtype=torch.int32, device=dev)
    code = cuda_build.library().launch_rebucket_block(
        xe.data_ptr(), ye.data_ptr(), Te.data_ptr(), me.data_ptr(),
        ve.data_ptr(), bases.data_ptr(), ox.data_ptr(), oy.data_ptr(),
        oT.data_ptr(), omat.data_ptr(), ovalid.data_ptr(), arrivals.data_ptr(),
        S, grid.ny, grid.nx, by, bx, K, grid.dx, grid.dy, plan.tx, plan.rows,
        int(periodic_x), cuda_build.stream_ptr(dev))
    cuda_build.check(code, "rebucket_block")
    launches += 1
    launches_periodic += periodic_x
    return (BucketedMarkers(x=ox, y=oy, mat=omat, T=oT, valid=ovalid),
            arrivals.to(torch.int64))


def rebucket_block(xe, ye, Te, me, ve, grid: StaggeredGrid, bases,
                   periodic_x: bool = False):
    """(own buckets, arrivals): the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if xe.is_cuda:
        return rebucket_block_cuda(xe, ye, Te, me, ve, grid, bases,
                                   periodic_x)
    return rebucket_block_plain(xe, ye, Te, me, ve, grid, bases)
