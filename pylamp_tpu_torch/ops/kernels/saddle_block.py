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
launches the kernel on CUDA tensors.
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch import cuda_build

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
    kc = torch.as_tensor(kcont, dtype=torch.float32, device=dev).reshape(1)
    rx = torch.empty((S, by, bx), dtype=torch.float32, device=dev)
    ry = torch.empty_like(rx)
    rc = torch.empty_like(rx) if with_p else None
    code = cuda_build.library().launch_saddle_block(
        vx_ext.data_ptr(), vy_ext.data_ptr(),
        p_ext.data_ptr() if with_p else None, es_ext.data_ptr(),
        en_ext.data_ptr(), kc.data_ptr(), rx.data_ptr(), ry.data_ptr(),
        rc.data_ptr() if with_p else None, S, by, bx, grid_dx, grid_dy,
        cuda_build.stream_ptr(dev))
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
