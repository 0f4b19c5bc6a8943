"""Per-shard RK4 marker advection on exchanged velocity windows: wrapper of
the CUDA kernel ``csrc/advect_block.cu`` (replaces the TPU kernel
``pylamp_tpu/markers/pallas/advect_kernel.py:advect_block_pallas``).

Inputs are every shard's own (S, by, bx, K) positions and valid flags, its
first own cell ``bases`` (S, 2), and the velocity windows that
parallel/halo_markers.advect_rk4_halo exchanges: (S, by+2R+1, bx+2R+1)
cuts of the global ghost-padded lattices vx_p (ny+2, nx+1) and vy_p
(ny+1, nx+2), window (q, l) = padded node (row_base + q - R,
col_base + l - R), with R = ``reach``, the stage reach (1 or 2).  Returns
the new (x, y), each (S, by, bx, K), clipped to the closed domain.

``advect_block`` runs the plain PyTorch version (``advect_block_plain``,
the sampling of ``bucket.bucket_advect_rk4`` on the windows) on CPU
tensors and launches the kernel on CUDA tensors.  The kernel runs kernel
3's tiles on live slots on ``advect.advect_plan(by, bx, K)``, all shards in
one launch.  ``cut_windows`` cuts the same windows from whole padded
lattices (the windows the exchange gives, on one device).

``periodic_x`` (periodic side walls; port-only: the reference keeps its
block kernels off there): the windows hold the wrapped columns that the
ring exchange gives (those of kernel 3's wrapped planes, ``cut_windows``
on ``advect.wrapped_planes``), x is sampled without a clamp as by kernel
3's periodic form, and the new x wraps into [0, lx) (the plain version
with ``bucket.wrap_x``, the kernel with kernel 3p's two-rounding
formula), so the positions are kernel 3p's.  The kernel's periodic form
(11p) counts in ``launches_periodic`` too.
"""
from __future__ import annotations

import ctypes

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import _corners, wrap_x
from pylamp_tpu_torch.markers.kernels.advect import AdvectPlan, advect_plan

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, and those of the periodic form
launches = 0
launches_periodic = 0


def cut_windows(vx_p, vy_p, bases, by: int, bx: int, R: int,
                col0: int = 0):
    """Every shard's (S, by+2R+1, bx+2R+1) windows of the whole padded
    lattices vx_p (ny+2, nx+1) and vy_p (ny+1, nx+2): window (q, l) =
    padded node (row_base + q - R, col_base + l - R), zeros beyond the
    lattice.  ``col0``: the lattices' first column is padded column
    -col0 (kernel 3p's wrapped planes: ``advect.PADW``)."""
    dev = vx_p.device
    b = bases.to(device=dev, dtype=torch.int64)
    rows = b[:, :1] - R + torch.arange(by + 2 * R + 1, device=dev)
    cols = b[:, 1:] - R + col0 + torch.arange(bx + 2 * R + 1, device=dev)

    def cut(p):
        H, W = p.shape
        ok = (((rows >= 0) & (rows < H))[:, :, None]
              & ((cols >= 0) & (cols < W))[:, None, :])
        v = p[rows.clamp(0, H - 1)[:, :, None],
              cols.clamp(0, W - 1)[:, None, :]]
        return torch.where(ok, v, torch.zeros_like(v)).contiguous()

    return cut(vx_p), cut(vy_p)


def kernel_info(plan: AdvectPlan, periodic: bool = False) -> dict:
    """Occupancy of the kernel (``periodic``: its periodic form) at
    ``plan``'s tiles, from the card's function attributes: registers per
    thread, static and dynamic shared bytes, local (spill) bytes per
    thread, threads and resident blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().advect_block_kernel_info(
        plan.ty, plan.tx, plan.cap, int(periodic), out),
        "advect_block (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def _sample_window(fe, fx, fy, valid, reach: int, rows: int, cols: int, cj,
                   ci, r0, c0, x_clamp=(0, 0)):
    """``bucket._sample`` on a window: bilinear sample of a lattice with
    global extent (rows, cols) at array coordinates (fx, fy), the nodes
    read from ``fe`` (S, wr, wc) whose (0, 0) is node (r0, c0); a corner
    contributes only inside the shift window of the marker's cell
    (cj, ci).  ``x_clamp`` (lo, hi): the first node's column is clamped
    to [lo, cols - 2 + hi] (walls: (0, 0); periodic side walls, whose
    window holds the wrapped columns: (-reach, reach) as ``bucket._sample``
    with a period, or None for no clamp)."""
    S, wr, wc = fe.shape
    i0 = torch.floor(fx)
    if x_clamp is not None:
        i0 = torch.clamp(i0, x_clamp[0], cols - 2 + x_clamp[1])
    i0 = i0.to(torch.int64)
    j0 = torch.clamp(torch.floor(fy), 0, rows - 2).to(torch.int64)
    tx = torch.clamp(fx - i0, 0.0, 1.0)
    ty = torch.clamp(fy - j0, 0.0, 1.0)
    flat = fe.reshape(S, wr * wc)
    out = torch.zeros_like(fx)
    for dj, di, w in _corners(ty, tx):
        rj, ri = j0 + dj, i0 + di
        oj, oi = rj - cj, ri - ci
        ok = (valid & (oj >= -reach) & (oj <= reach + 1)
              & (oi >= -reach) & (oi <= reach + 1))
        idx = torch.clamp((rj - r0) * wc + (ri - c0), 0, wr * wc - 1)
        val = torch.gather(flat, 1, idx.reshape(S, -1)).reshape(idx.shape)
        out = out + torch.where(ok, w, 0.0) * val
    return out


def advect_block_plain(xb, yb, vb, vx_ext, vy_ext, dt, grid: StaggeredGrid,
                       bases, reach: int, periodic_x: bool = False):
    """RK4 on the shards' own markers from the windows, as
    ``bucket.bucket_advect_rk4`` on the global lattices."""
    S, by, bx, _ = xb.shape
    dev = xb.device
    dx, dy = grid.dx, grid.dy
    rb = bases[:, 0].to(torch.int64).view(S, 1, 1, 1)
    cb = bases[:, 1].to(torch.int64).view(S, 1, 1, 1)
    cj = rb + torch.arange(by, device=dev).view(1, by, 1, 1)
    ci = cb + torch.arange(bx, device=dev).view(1, 1, bx, 1)
    r0, c0 = rb - reach, cb - reach

    def vel(px, py, r):
        clamp = (-r, r) if periodic_x else (0, 0)
        ux = _sample_window(vx_ext, px / dx, py / dy + 0.5, vb, r,
                            grid.ny + 2, grid.nx + 1, cj, ci, r0, c0, clamp)
        uy = _sample_window(vy_ext, px / dx + 0.5, py / dy, vb, r,
                            grid.ny + 1, grid.nx + 2, cj, ci, r0, c0, clamp)
        return ux, uy

    x, y = xb, yb
    k1x, k1y = vel(x, y, 1)
    k2x, k2y = vel(x + 0.5 * dt * k1x, y + 0.5 * dt * k1y, reach)
    k3x, k3y = vel(x + 0.5 * dt * k2x, y + 0.5 * dt * k2y, reach)
    k4x, k4y = vel(x + dt * k3x, y + dt * k3y, reach)
    nx_new = x + dt / 6.0 * (k1x + 2 * k2x + 2 * k3x + k4x)
    ny_new = y + dt / 6.0 * (k1y + 2 * k2y + 2 * k3y + k4y)
    eps_x = 1e-6 * grid.dx_min
    eps_y = 1e-6 * grid.dy_min
    return (wrap_x(nx_new, grid.lx) if periodic_x
            else torch.clamp(nx_new, eps_x, grid.lx - eps_x),
            torch.clamp(ny_new, eps_y, grid.ly - eps_y))


def _check(name, t, dtype, shape):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_cuda
            or not t.is_contiguous()):
        raise ValueError(
            f"advect_block kernel: {name} must be a contiguous CUDA {dtype} "
            f"tensor of shape {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def advect_block_cuda(xb, yb, vb, vx_ext, vy_ext, dt, grid: StaggeredGrid,
                      bases, reach: int, periodic_x: bool = False):
    global launches, launches_periodic
    if reach not in (1, 2):
        raise ValueError(f"reach must be 1 or 2, got {reach}")
    S, by, bx, K = xb.shape
    win = (S, by + 2 * reach + 1, bx + 2 * reach + 1)
    for name, t, dtype, shape in (
            ("x", xb, torch.float32, xb.shape), ("y", yb, torch.float32, xb.shape),
            ("valid", vb, torch.bool, xb.shape),
            ("vx_ext", vx_ext, torch.float32, win),
            ("vy_ext", vy_ext, torch.float32, win),
            ("bases", bases, torch.int32, (S, 2))):
        _check(name, t, dtype, shape)
    dev = xb.device
    dt_t = torch.as_tensor(dt, dtype=torch.float32, device=dev).reshape(1)
    out_x, out_y = torch.empty_like(xb), torch.empty_like(yb)
    eps_x = 1e-6 * grid.dx_min
    eps_y = 1e-6 * grid.dy_min
    if S * by * bx >= 2 ** 31:
        raise ValueError(f"advect_block kernel: {S} blocks of {by} x {bx} "
                         "cells (the kernel indexes cells in 31 bits)")
    plan = advect_plan(by, bx, K)
    code = cuda_build.library().launch_advect_block(
        xb.data_ptr(), yb.data_ptr(), vb.data_ptr(), vx_ext.data_ptr(),
        vy_ext.data_ptr(), bases.data_ptr(), dt_t.data_ptr(),
        out_x.data_ptr(), out_y.data_ptr(), S, grid.ny, grid.nx, by, bx, K,
        grid.dx, grid.dy, eps_x, grid.lx - eps_x, eps_y, grid.ly - eps_y,
        reach, int(periodic_x), grid.lx, 1.0 / grid.lx, plan.ty, plan.tx,
        plan.cap, cuda_build.stream_ptr(dev))
    cuda_build.check(code, "advect_block")
    launches += 1
    launches_periodic += periodic_x
    return out_x, out_y


def advect_block(xb, yb, vb, vx_ext, vy_ext, dt, grid: StaggeredGrid, bases,
                 reach: int, periodic_x: bool = False):
    """The shards' advected (x, y): the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if xb.is_cuda:
        return advect_block_cuda(xb, yb, vb, vx_ext, vy_ext, dt, grid, bases,
                                 reach, periodic_x)
    return advect_block_plain(xb, yb, vb, vx_ext, vy_ext, dt, grid, bases,
                              reach, periodic_x)
