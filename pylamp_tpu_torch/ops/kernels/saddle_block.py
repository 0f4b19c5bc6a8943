"""Per-shard saddle stencil on one-deep extended blocks: wrapper of the CUDA
kernel ``csrc/saddle_block.cu`` (replaces the TPU kernel
``pylamp_tpu/ops/pallas/block_stencil_kernel.py:saddle_block_pallas``).

Inputs are the blocks a shard body of ``parallel/halo_ops`` builds, for
all S shards at once: vx/vy/p/en (S, by+2, bx+2) and es (S, by+1, bx+1),
with the BC ghosts already in the halo ring.  Outputs are the pure
interior (rx, ry, rc) of shape (S, by, bx); ``p=None`` gives the
momentum-only form (rx, ry).  All boundary semantics live in the inputs
and in the Dirichlet patches the caller applies afterwards, so the stencil
has no wall logic.

``saddle_block`` runs the plain PyTorch version (``saddle_block_plain``,
the tensor branch of the reference's shard body) on CPU tensors and
launches the kernel on CUDA tensors.  The kernel is kernel 1's tile
(``csrc/saddle_tile.cuh``) on every shard; ``tile_plan`` mirrors its
tiles of a shard's points.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.ops.kernels.saddle import TILE_X, TILE_Y

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def block_stencil_eligible(by: int, bx: int, dtype) -> bool:
    """The reference's per-shard gate (block_stencil_eligible) without its
    platform test: f32 blocks with 8-aligned heights, at least 64 rows and
    128 columns."""
    return (dtype == torch.float32 and by % 8 == 0 and by >= 64
            and bx >= 128)


def saddle_block_plain(vx_ext, vy_ext, p_ext, es_ext, en_ext, grid_dx,
                       grid_dy, kcont=1.0):
    """The stencil of ops.stokes.stokes_operator on extended blocks (any
    leading batch dims); returns (rx, ry, rc) or, with ``p_ext=None``,
    (rx, ry)."""
    dx, dy = grid_dx, grid_dy
    dvxdx = (vx_ext[..., 1:] - vx_ext[..., :-1]) / dx  # (by+2, bx+1)
    dvydy = (vy_ext[..., 1:, :] - vy_ext[..., :-1, :]) / dy  # (by+1, bx+2)
    sxx = 2.0 * en_ext[..., :-1] * dvxdx
    syy = 2.0 * en_ext[..., :-1, :] * dvydy
    sxy = es_ext * (
        (vx_ext[..., 1:, 1:] - vx_ext[..., :-1, 1:]) / dy
        + (vy_ext[..., 1:, 1:] - vy_ext[..., 1:, :-1]) / dx)  # (by+1, bx+1)
    rx = (-(sxx[..., 1:-1, 1:] - sxx[..., 1:-1, :-1]) / dx
          - (sxy[..., 1:, :-1] - sxy[..., :-1, :-1]) / dy)
    ry = (-(syy[..., 1:, 1:-1] - syy[..., :-1, 1:-1]) / dy
          - (sxy[..., :-1, 1:] - sxy[..., :-1, :-1]) / dx)
    if p_ext is None:
        return rx, ry
    rx = rx + (p_ext[..., 1:-1, 1:-1] - p_ext[..., 1:-1, :-2]) / dx
    ry = ry + (p_ext[..., 1:-1, 1:-1] - p_ext[..., :-2, 1:-1]) / dy
    rc = kcont * (dvxdx[..., 1:-1, 1:] + dvydy[..., 1:, 1:-1])
    return rx, ry, rc


class BlockTilePlan(NamedTuple):
    """How csrc/saddle_block.cu tiles each shard's by x bx points
    (``block_tile_grid``): nty x ntx tiles of TILE_Y x TILE_X points a
    shard, the last row and column of tiles clipped to the block."""
    nty: int
    ntx: int

    def extents(self, by: int, bx: int):
        """Every tile's own points as (row0, rows, col0, cols) of the
        (by, bx) output, and whether it takes the branch-free form
        (``apply_block_tile``: the tile is full, so its staged frame,
        extended rows row0..row0 + TILE_Y + 1 and columns col0..col0 +
        TILE_X + 1, lies in the extended block)."""
        for ty in range(self.nty):
            r0 = ty * TILE_Y
            for tx in range(self.ntx):
                c0 = tx * TILE_X
                rows, cols = min(TILE_Y, by - r0), min(TILE_X, bx - c0)
                yield r0, rows, c0, cols, (rows, cols) == (TILE_Y, TILE_X)


def tile_plan(by: int, bx: int) -> BlockTilePlan:
    """The tiles of kernel 9 on one shard's by x bx block (each shard has
    the same, blockIdx.z)."""
    return BlockTilePlan(-(-by // TILE_Y), -(-bx // TILE_X))


def kernel_info(with_p: bool = True) -> dict:
    """Occupancy of the kernel (``with_p``: the form with p) from the
    card's function attributes: registers per thread, static shared bytes,
    local (spill) bytes per thread, threads and resident blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().saddle_block_kernel_info(
        int(with_p), out), "saddle_block (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def _check(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(
            f"saddle_block kernel: {name} must be a contiguous CUDA float32 "
            f"tensor of shape {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def saddle_block_cuda(vx_ext, vy_ext, p_ext, es_ext, en_ext, grid_dx,
                      grid_dy, kcont=1.0):
    """The kernel on (S, ...) contiguous f32 CUDA blocks."""
    global launches
    S, by2, bx2 = vx_ext.shape
    by, bx = by2 - 2, bx2 - 2
    with_p = p_ext is not None
    ins = [("vx_ext", vx_ext, (S, by + 2, bx + 2)),
           ("vy_ext", vy_ext, (S, by + 2, bx + 2)),
           ("es_ext", es_ext, (S, by + 1, bx + 1)),
           ("en_ext", en_ext, (S, by + 2, bx + 2))]
    if with_p:
        ins.append(("p_ext", p_ext, (S, by + 2, bx + 2)))
    for name, t, shape in ins:
        _check(name, t, shape)
    dev = vx_ext.device
    rx = torch.empty((S, by, bx), dtype=torch.float32, device=dev)
    ry = torch.empty_like(rx)
    rc = kc = None
    if with_p:
        rc = torch.empty_like(rx)
        kc = torch.as_tensor(kcont, dtype=torch.float32,
                             device=dev).reshape(1)
    code = cuda_build.library().launch_saddle_block(
        vx_ext.data_ptr(), vy_ext.data_ptr(),
        p_ext.data_ptr() if with_p else None, es_ext.data_ptr(),
        en_ext.data_ptr(), kc.data_ptr() if with_p else None, rx.data_ptr(),
        ry.data_ptr(), rc.data_ptr() if with_p else None, S, by, bx, grid_dx,
        grid_dy, cuda_build.stream_ptr(dev))
    cuda_build.check(code, "saddle_block")
    launches += 1
    return (rx, ry, rc) if with_p else (rx, ry)


def saddle_block(vx_ext, vy_ext, p_ext, es_ext, en_ext, grid_dx, grid_dy,
                 kcont=1.0):
    """Per-shard stencil on (S, ...) blocks: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if vx_ext.is_cuda:
        return saddle_block_cuda(vx_ext, vy_ext, p_ext, es_ext, en_ext,
                                 grid_dx, grid_dy, kcont)
    return saddle_block_plain(vx_ext, vy_ext, p_ext, es_ext, en_ext, grid_dx,
                              grid_dy, kcont)


def saddle_block_batched(mesh, vx_ext, vy_ext, p_ext, es_ext, en_ext, grid,
                         kcont):
    """``saddle_block`` on a shard body's (my, mx, ...) blocks: flattened
    to (S, ...) for one launch over all shards, and back."""
    f32 = torch.float32

    def flat(t):
        return None if t is None else mesh.flat(t.to(f32))

    out = saddle_block(flat(vx_ext), flat(vy_ext), flat(p_ext), flat(es_ext),
                       flat(en_ext), grid.dx, grid.dy, kcont)
    return tuple(mesh.unflat(o) for o in out)
