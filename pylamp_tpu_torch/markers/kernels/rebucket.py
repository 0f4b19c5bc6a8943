"""Marker re-bucketing: wrapper of the CUDA kernel ``csrc/rebucket.cu``
(replaces the TPU kernel
``pylamp_tpu/markers/pallas/rebucket_kernel.py:rebucket_pallas``).

``rebucket_fused`` runs the plain PyTorch version (``rebucket_plain``, the
port of ``bucket.rebucket``) on CPU tensors and launches the kernel on
CUDA tensors.  Both give identical buckets slot for slot and the same
drop count.  Layout stays (ny, nx, K).  ``periodic_x`` selects the
periodic form (the 3x3 neighbourhood wraps in x, nx >= 3); its launches
also count in ``launches_periodic``.
"""
from __future__ import annotations

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


def rebucket_cuda(bm: BucketedMarkers, grid: StaggeredGrid,
                  periodic_x: bool = False):
    global launches, launches_periodic
    check_markers(bm, "rebucket")
    ny, nx, K = bm.x.shape
    if periodic_x and nx < 3:
        raise ValueError(f"periodic rebucketing needs nx >= 3, got {nx}")
    ox, oy, oT = (torch.empty_like(bm.x), torch.empty_like(bm.y),
                  torch.empty_like(bm.T))
    omat = torch.empty_like(bm.mat)
    ovalid = torch.empty_like(bm.valid)
    arrivals = torch.empty((ny, nx), dtype=torch.int32, device=bm.x.device)
    code = cuda_build.library().launch_rebucket(
        bm.x.data_ptr(), bm.y.data_ptr(), bm.T.data_ptr(), bm.mat.data_ptr(),
        bm.valid.data_ptr(), ox.data_ptr(), oy.data_ptr(), oT.data_ptr(),
        omat.data_ptr(), ovalid.data_ptr(), arrivals.data_ptr(), ny, nx, K,
        grid.dx, grid.dy, int(periodic_x), cuda_build.stream_ptr(bm.x.device))
    cuda_build.check(code, "rebucket")
    launches += 1
    launches_periodic += bool(periodic_x)
    dropped = torch.sum(torch.clamp(arrivals.to(torch.int64) - K, min=0))
    return BucketedMarkers(x=ox, y=oy, mat=omat, T=oT, valid=ovalid), dropped


def rebucket_fused(bm: BucketedMarkers, grid: StaggeredGrid,
                   periodic_x: bool = False):
    """(new_bm, dropped): the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if bm.x.is_cuda:
        return rebucket_cuda(bm, grid, periodic_x)
    return rebucket_plain(bm, grid, periodic_x)
