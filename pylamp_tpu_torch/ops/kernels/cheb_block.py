"""Fused per-shard Chebyshev smoother on depth-h halo frames: wrapper of the
CUDA kernel ``csrc/cheb_block.cu`` (replaces the TPU kernel
``pylamp_tpu/ops/pallas/cheb_block_kernel.py:cheb_block_pallas``).

A frame holds one shard's interior plus h rings of neighbour data (the
layout of the reference's frame_cheb_sweep, h = halo depth, r0/c0 the
shard's first global interior row/col):

    ex, rx  (R,   C+1): frame row f = global vx row r0-h+f, col g = c0-h+g
    ey, ry  (R+1, C  ): frame row f = global vy row r0-h+f
    es      (R+1, C+1): corner row/col r0-h+f / c0-h+g
    en      (R,   C  ): cell row/col

with R = by + 2h and C = bx + 2h, for all S shards at once (leading dim
S).  ``iters`` coupled Chebyshev iterations (<= h, or <= h - 1 with the
emitted residual) leave the central (by, bx) blocks exact: frame edges go
stale by one ring per application, physical walls are re-derived from
current values before every application under per-shard runtime wall
flags (S, 4) = (top, bottom, left, right), and Dirichlet lines inside the
frame evolve by the pointwise kbnd recurrence.

``cheb_block`` runs the plain PyTorch version (``frame_cheb_sweep``, the
port of the reference's pure function, batched over shards) on CPU
tensors and launches the kernel on CUDA tensors.  The kernel runs kernel
5's tile sweep on the frames, tiled per level by ``cheb.block_tile_plan``
(all shards in one launch).  Periodic side walls have no per-shard
smoother: the reference keeps it off there (``halo_smoother_eligible``),
and the kernel's wrapper refuses them.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels import cheb

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

MAX_DEPTH = cheb.MAX_DEPTH  # csrc/cheb_tile.cuh MAX_HE


def block_smoother_eligible(by: int, bx: int, dtype, iters: int,
                            emit_residual: bool = False) -> bool:
    """The reference's per-shard gate (block_smoother_eligible) without
    its platform test and TPU VMEM model: f32 blocks of at least 8x8 and a
    fused depth of at most MAX_DEPTH."""
    h = iters + (1 if emit_residual else 0)
    return (dtype == torch.float32 and iters >= 1 and h <= MAX_DEPTH
            and by >= 8 and bx >= 8)


@dataclasses.dataclass(frozen=True)
class BlockSmootherPrep:
    """Per-level, per-solve constants of the per-shard sweep."""

    es_v: torch.Tensor  # (S, R+1, C+1) f32 viscosity frames
    en_v: torch.Tensor  # (S, R, C) f32
    flags: torch.Tensor  # (S, 4) f32 wall flags (top, bottom, left, right)
    coeffs: torch.Tensor  # (h, 2) f32 Chebyshev table
    kb: torch.Tensor  # (1,) f32 kbnd
    h: int
    by: int
    bx: int


def frame_cheb_sweep(ex, ey, rx, ry, es, en, *, by, bx, h, dx, dy, kb,
                     s_signs, flags, coeffs, iters, zero_init, emit_residual):
    """The reference's frame sweep on (S, ...) frames; returns full frames
    (ex, ey) or (ex, ey, rfx, rfy) (callers slice the central block)."""
    dev = ex.device
    R, C = by + 2 * h, bx + 2 * h
    s_top, s_bottom, s_left, s_right = s_signs
    wt, wb, wl, wr = (flags[:, k].view(-1, 1, 1) > 0.5 for k in range(4))
    rows_x = torch.arange(R, device=dev).view(R, 1)
    cols_x = torch.arange(C + 1, device=dev).view(1, C + 1)
    rows_y = torch.arange(R + 1, device=dev).view(R + 1, 1)
    cols_y = torch.arange(C, device=dev).view(1, C)
    # Dirichlet lines: global vx col 0 at frame col h on wall-left shards,
    # col nx at h + bx on wall-right ones; vy rows likewise
    m_dx = (wl & (cols_x == h)) | (wr & (cols_x == h + bx))
    m_dy = (wt & (rows_y == h)) | (wb & (rows_y == h + by))

    def cat_r(*a):
        return torch.cat(a, dim=-2)

    def cat_c(*a):
        return torch.cat(a, dim=-1)

    # Jacobi diagonals, frame-wide
    enc = cat_c(en, en[..., -1:])  # col g = cell g
    enp = cat_c(en[..., :1], en)  # col g = cell g - 1
    dvx = 2.0 * (enc + enp) / dx**2 + (es[..., :-1, :] + es[..., 1:, :]) / dy**2
    dvx = torch.where(m_dx, kb, dvx)
    enc2 = cat_r(en, en[..., -1:, :])
    enp2 = cat_r(en[..., :1, :], en)
    dvy = 2.0 * (enc2 + enp2) / dy**2 + (es[..., 1:] + es[..., :-1]) / dx**2
    dvy = torch.where(m_dy, kb, dvy)

    def bc_fix(ex, ey):
        # wall ghosts re-derived from the CURRENT interior values
        ex = torch.where(wt & (rows_x == h - 1), s_top * ex[..., h:h + 1, :],
                         ex)
        ex = torch.where(wb & (rows_x == h + by),
                         s_bottom * ex[..., h + by - 1:h + by, :], ex)
        ey = torch.where(wl & (cols_y == h - 1), s_left * ey[..., h:h + 1],
                         ey)
        ey = torch.where(wr & (cols_y == h + bx),
                         s_right * ey[..., h + bx - 1:h + bx], ey)
        return ex, ey

    def apply_A(ex, ey):
        """Coupled momentum stencil over the whole frame; frame-edge rows
        and columns come out garbage and are sacrificial."""
        ex_J = cat_r(ex, ex[..., -1:, :])  # (R+1, C+1)
        ex_Jm1 = cat_r(ex[..., :1, :], ex)
        ey_I = cat_c(ey, ey[..., -1:])  # (R+1, C+1)
        ey_Im1 = cat_c(ey[..., :1], ey)
        sxy = es * ((ex_J - ex_Jm1) / dy + (ey_I - ey_Im1) / dx)
        sxx = 2.0 * en * (ex[..., 1:] - ex[..., :-1]) / dx  # (R, C)
        syy = 2.0 * en * (ey[..., 1:, :] - ey[..., :-1, :]) / dy  # (R, C)
        sxxc = cat_c(sxx, sxx[..., -1:])  # (R, C+1)
        sxxp = cat_c(sxx[..., :1], sxx)
        ax = -(sxxc - sxxp) / dx - (sxy[..., 1:, :] - sxy[..., :-1, :]) / dy
        ax = torch.where(m_dx, kb * ex, ax)
        syyc = cat_r(syy, syy[..., -1:, :])  # (R+1, C)
        syyp = cat_r(syy[..., :1, :], syy)
        ay = -(syyc - syyp) / dy - (sxy[..., 1:] - sxy[..., :-1]) / dx
        ay = torch.where(m_dy, kb * ey, ay)
        return ax, ay

    dxs = torch.zeros_like(ex)
    dys = torch.zeros_like(ey)
    for k in range(iters):
        c1, c2 = coeffs[k, 0], coeffs[k, 1]
        ex, ey = bc_fix(ex, ey)
        if zero_init and k == 0:
            dxs = c2 * rx / dvx
            dys = c2 * ry / dvy
        else:
            ax, ay = apply_A(ex, ey)
            dxs = c1 * dxs + c2 * (rx - ax) / dvx
            dys = c1 * dys + c2 * (ry - ay) / dvy
        ex = ex + dxs
        ey = ey + dys
    if emit_residual:
        ax, ay = apply_A(*bc_fix(ex, ey))
        return ex, ey, rx - ax, ry - ay
    return ex, ey


def cheb_block_plain(ex_v, ey_v, rx_v, ry_v, prep: BlockSmootherPrep,
                     grid: StaggeredGrid, bcs: VelocityBCs, iters: int,
                     zero_init: bool = False, emit_residual: bool = False):
    """Central (S, by, bx) blocks of ``frame_cheb_sweep``."""
    h, by, bx = prep.h, prep.by, prep.bx
    if zero_init:
        ex_v, ey_v = torch.zeros_like(ex_v), torch.zeros_like(ey_v)
    out = frame_cheb_sweep(
        ex_v, ey_v, rx_v, ry_v, prep.es_v, prep.en_v, by=by, bx=bx, h=h,
        dx=grid.dx, dy=grid.dy, kb=prep.kb[0],
        s_signs=(bcs.s_top, bcs.s_bottom, bcs.s_left, bcs.s_right),
        flags=prep.flags, coeffs=prep.coeffs, iters=iters,
        zero_init=zero_init, emit_residual=emit_residual)
    return tuple(o[..., h:h + by, h:h + bx] for o in out)


def _check(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(
            f"cheb_block kernel: {name} must be a contiguous CUDA float32 "
            f"tensor of shape {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def cheb_block_cuda(ex_v, ey_v, rx_v, ry_v, prep: BlockSmootherPrep,
                    grid: StaggeredGrid, bcs: VelocityBCs, iters: int,
                    zero_init: bool = False, emit_residual: bool = False):
    global launches
    if bcs.periodic_x:
        raise ValueError(
            "cheb_block kernel: periodic side walls have no per-shard "
            "smoother (the reference keeps it off there: "
            "halo_smoother_eligible)")
    h, by, bx = prep.h, prep.by, prep.bx
    he = iters + (1 if emit_residual else 0)
    if not 1 <= iters or he > min(h, MAX_DEPTH):
        raise ValueError(f"cheb_block kernel: iters {iters} (+emit) exceeds "
                         f"the frames' halo depth {h} or {MAX_DEPTH}")
    S = prep.flags.shape[0]
    R, C = by + 2 * h, bx + 2 * h
    for name, t, shape in (("ex", ex_v, (S, R, C + 1)),
                           ("ey", ey_v, (S, R + 1, C)),
                           ("rx", rx_v, (S, R, C + 1)),
                           ("ry", ry_v, (S, R + 1, C)),
                           ("es", prep.es_v, (S, R + 1, C + 1)),
                           ("en", prep.en_v, (S, R, C)),
                           ("flags", prep.flags, (S, 4)),
                           ("kb", prep.kb, (1,))):
        _check(name, t, shape)
    if prep.coeffs.shape[0] < iters:
        raise ValueError("cheb_block kernel: coefficient table too short")
    dev = ex_v.device
    outs = [torch.empty((S, by, bx), dtype=torch.float32, device=dev)
            for _ in range(4 if emit_residual else 2)]
    ox, oy = outs[0], outs[1]
    fx, fy = (outs[2], outs[3]) if emit_residual else (ox, oy)
    plan = cheb.block_tile_plan(by, bx, he, S, cheb.device_sms(dev.index))
    code = cuda_build.library().launch_cheb_block(
        ex_v.data_ptr(), ey_v.data_ptr(), rx_v.data_ptr(), ry_v.data_ptr(),
        prep.es_v.data_ptr(), prep.en_v.data_ptr(), prep.flags.data_ptr(),
        prep.coeffs.data_ptr(), prep.kb.data_ptr(), ox.data_ptr(),
        oy.data_ptr(), fx.data_ptr(), fy.data_ptr(), S, by, bx, h, grid.dx,
        grid.dy, bcs.s_top, bcs.s_bottom, bcs.s_left, bcs.s_right, iters,
        int(zero_init), int(emit_residual), plan.ty,
        cuda_build.raw_stream(dev.index))
    cuda_build.check(code, "cheb_block")
    launches += 1
    return tuple(outs)


def kernel_info(he: int, ty: int) -> dict:
    """Occupancy of the depth-``he`` kernel with tiles of ``ty`` rows, from
    the card's own function attributes (the keys of cheb.kernel_info)."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().cheb_block_kernel_info(he, ty, out),
                     "cheb_block (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def cheb_block(ex_v, ey_v, rx_v, ry_v, prep: BlockSmootherPrep,
               grid: StaggeredGrid, bcs: VelocityBCs, iters: int,
               zero_init: bool = False, emit_residual: bool = False):
    """Central blocks (ex, ey) or (ex, ey, rfx, rfy), each (S, by, bx):
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if rx_v.is_cuda:
        return cheb_block_cuda(ex_v, ey_v, rx_v, ry_v, prep, grid, bcs, iters,
                               zero_init, emit_residual)
    return cheb_block_plain(ex_v, ey_v, rx_v, ry_v, prep, grid, bcs, iters,
                            zero_init, emit_residual)
