"""Fused multi-iteration Chebyshev momentum smoother: wrapper of the CUDA
kernel ``csrc/cheb.cu`` (replaces the TPU kernel
``pylamp_tpu/ops/pallas/cheb_kernel.py:chebyshev_smooth_pallas``).

One sweep runs ``iters`` coupled Chebyshev iterations of D^-1 A over
[lam/4, lam] and, with ``emit_residual``, returns the residual
(rx - A ex', ry - A ey') of the final iterate as well.

``prep_smoother`` runs once per level per solve (the role of
``prep_smoother_eta``): it freezes contiguous f32 viscosities, the
coefficient table (built on the device from the lambda tensor, so no sweep
syncs the host), kbnd as a device tensor and the halo depth.
``chebyshev_smooth`` runs the plain PyTorch version
(``chebyshev_smooth_plain``, the MG smoother's recurrence) on CPU tensors
and launches the kernel on CUDA tensors.  Periodic side walls launch the
kernel's periodic form (its edge tiles load the x-periodic lattice; the
seam columns take half the wrapped row and diagonal), counted in
``launches_periodic`` as well; it reads ex, rx and eta_s as
seam-consistent, as the periodic multigrid keeps them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels.momentum import momentum_apply_plain
from pylamp_tpu_torch.ops.kernels.saddle import side_signs
from pylamp_tpu_torch.solvers.stokes_solver import velocity_diagonals

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, and those of the periodic form
launches = 0
launches_periodic = 0

# the reference's deepest fused sweep (cheb_kernel.py HS[-1]): deeper sweeps
# take the plain path
MAX_DEPTH = 7

# csrc/cheb.cu: threads per block, tile width, shared planes
THREADS = 512
TILE_X = 32
PLANES = 6
SMS = 132  # the H100 SXM's streaming multiprocessors (tile_plan's default)
SMEM_PER_BLOCK = 232_448  # bytes a block may use on the H100
TILE_ROWS = (32, 16, 8)  # the tile heights the plan chooses from


class TilePlan(NamedTuple):
    """How csrc/cheb.cu tiles one level's (ny+1, nx+1) point space, or
    csrc/cheb_block.cu each shard's by x bx block: tiles of ty x 32 points
    (the last tile row and column take what is left: on a level the +1
    point row and column fold into them), loaded with a halo of ``he`` into
    planes of row stride 33 + 2 he."""
    ty: int
    nty: int
    ntx: int
    he: int
    nq: int  # loaded points per thread (of THREADS)
    smem: int  # dynamic shared bytes per block

    def extents(self, ny: int, nx: int):
        """Every tile's centre as (row0, rows, col0, cols) in the
        (ny+1, nx+1) point space (a block plan: ny, nx = by - 1, bx - 1)."""
        for by in range(self.nty):
            rows = ny + 1 - by * self.ty if by == self.nty - 1 else self.ty
            for bx in range(self.ntx):
                cols = (nx + 1 - bx * TILE_X if bx == self.ntx - 1
                        else TILE_X)
                yield by * self.ty, rows, bx * TILE_X, cols


def _plan(rows: int, cols: int, he: int, sms: int, shards: int) -> TilePlan:
    """The tile height of a sweep of depth ``he`` over ``shards`` point
    spaces of rows x cols: of TILE_ROWS, the one with the least estimated
    time, ceil(blocks / sms) waves times the loaded points of one tile
    (ties: the taller tile)."""
    best = None
    sx = TILE_X + 1 + 2 * he
    for ty in TILE_ROWS:
        ly = ty + 1 + 2 * he
        nty = max(math.ceil((rows - 1) / ty), 1)
        ntx = max(math.ceil((cols - 1) / TILE_X), 1)
        cost = math.ceil(nty * ntx * shards / sms) * ly * sx
        if best is None or cost < best[0]:
            best = (cost, TilePlan(ty, nty, ntx, he,
                                   math.ceil(ly * sx / THREADS),
                                   PLANES * 4 * ly * sx))
    return best[1]


@functools.lru_cache(maxsize=256)
def tile_plan(ny: int, nx: int, he: int, sms: int = SMS) -> TilePlan:
    """Kernel 5's tiles on an ny x nx level.  With the H100 SXM's 132 SMs:
    on 1024^2 and 512^2 32 rows; on 256^2 16 (128 blocks instead of 64);
    on the sticky-air levels 512x128 and 256x64 at depth 7 16 and 8 (128
    and 64 blocks instead of 64 and 16)."""
    return _plan(ny + 1, nx + 1, he, sms, 1)


@functools.lru_cache(maxsize=256)
def block_tile_plan(by: int, bx: int, he: int, shards: int,
                    sms: int = SMS) -> TilePlan:
    """Kernel 8's tiles on each of ``shards`` by x bx blocks (all shards in
    one launch, so they share the waves).  At FK 1024^2 on the 4x2 mesh
    with the H100 SXM's 132 SMs: 32 rows on the 256x512 and 128x256
    blocks, shorter tiles below."""
    return _plan(by, bx, he, sms, shards)


@functools.cache
def device_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def cheb_interval(lam_max):
    """(theta, delta, sigma1) of the smoothing interval [lam_max/4, lam_max]."""
    lmin = lam_max / 4.0
    theta = 0.5 * (lam_max + lmin)
    delta = 0.5 * (lam_max - lmin)
    return theta, delta, theta / delta


def chebyshev_coeffs(lam_max, iters: int):
    """f32 table of (c1_k, c2_k), the Chebyshev recurrence on
    [lam_max/4, lam_max] as ``dxs = c1_k dxs + c2_k (r - A e) / D``: shape
    (iters, 2) for a scalar lam_max, (n, iters, 2) for n of them.  Built
    with tensor operations on lam_max's device."""
    theta, delta, sigma1 = cheb_interval(
        torch.as_tensor(lam_max).to(torch.float32))
    rows = [torch.stack([torch.zeros_like(theta), 1.0 / theta], dim=-1)]
    ro = 1.0 / sigma1
    for _ in range(iters - 1):
        rho = 1.0 / (2.0 * sigma1 - ro)
        rows.append(torch.stack([rho * ro, 2.0 * rho / delta], dim=-1))
        ro = rho
    return torch.stack(rows, dim=-2).contiguous()


def smoother_eligible(grid: StaggeredGrid, dtype, iters: int,
                      emit_residual: bool = False) -> bool:
    """The reference's gate (cheb_kernel.py smoother_eligible) without its
    platform test and TPU VMEM model: uniform f32 levels with nx >= 256,
    ny a multiple of 8, and a fused depth of at most MAX_DEPTH."""
    depth = iters + (1 if emit_residual else 0)
    return (grid.uniform and dtype == torch.float32 and iters >= 1
            and depth <= MAX_DEPTH and grid.nx >= 256 and grid.ny % 8 == 0)


@dataclasses.dataclass(frozen=True)
class SmootherPrep:
    eta_s: torch.Tensor  # (ny+1, nx+1) f32, contiguous
    eta_n: torch.Tensor  # (ny, nx) f32, contiguous
    kbnd: Any  # as given (the plain version's operand)
    lam: Any  # as given (the plain version's operand)
    diags: tuple  # (dvx, dvy) Jacobi diagonals (the plain version's)
    coeffs: torch.Tensor  # (h, 2) f32 Chebyshev table (the kernel's)
    kb: torch.Tensor  # (1,) f32 kbnd (the kernel's)
    h: int  # halo depth: iters (+1 with emit) applications fuse


def prep_smoother(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs, kbnd,
                  lam_max, h: int, diags=None) -> SmootherPrep:
    """Per-level, per-solve constants of the fused sweep; ``diags`` reuses
    the caller's velocity_diagonals."""
    f32 = torch.float32
    if diags is None:
        diags = velocity_diagonals(eta_s, eta_n, grid, kbnd, bcs=bcs)
    kb = torch.as_tensor(kbnd, device=eta_n.device).to(f32).reshape(1)
    prep = SmootherPrep(eta_s.to(f32).contiguous(),
                        eta_n.to(f32).contiguous(), kbnd, lam_max, diags,
                        chebyshev_coeffs(lam_max, h).to(eta_n.device), kb, h)
    if eta_n.is_cuda:  # the kernel's operands, checked once per prep
        for name, t, shape in (("eta_s", prep.eta_s, grid.shape_corner),
                               ("eta_n", prep.eta_n, grid.shape_center),
                               ("coeffs", prep.coeffs, (h, 2)),
                               ("kb", prep.kb, (1,))):
            _check(name, t, shape)
    return prep


def chebyshev_smooth_plain(ex, ey, rx, ry, eta_s, eta_n, grid: StaggeredGrid,
                           bcs: VelocityBCs, kbnd, lam_max, iters: int,
                           zero_init: bool = False,
                           emit_residual: bool = False, diags=None,
                           interval=None, apply=None):
    """Chebyshev semi-iteration on D^-1 A; returns (ex, ey) or, with
    ``emit_residual``, (ex, ey, rx - A ex, ry - A ey).  ``zero_init``:
    (ex, ey) are zero, so the first operator application is skipped.
    ``diags`` / ``interval``: the level's velocity_diagonals and
    cheb_interval(lam_max), where the caller froze them.  ``apply(ex, ey)
    -> A (ex, ey)``: the caller's momentum apply (the MG dispatcher);
    default the plain one on (eta_s, eta_n, kbnd)."""
    if apply is None:
        def apply(ex, ey):
            return momentum_apply_plain(ex, ey, eta_s, eta_n, grid, bcs, kbnd)
    dvx, dvy = diags if diags is not None else velocity_diagonals(
        eta_s, eta_n, grid, kbnd, bcs=bcs)
    theta, delta, sigma1 = interval if interval is not None else \
        cheb_interval(lam_max)
    if zero_init:  # A(0) = 0 exactly: skip the apply
        dx_ = rx / dvx / theta
        dy_ = ry / dvy / theta
    else:
        ax, ay = apply(ex, ey)
        dx_ = (rx - ax) / dvx / theta
        dy_ = (ry - ay) / dvy / theta
    ex = ex + dx_
    ey = ey + dy_
    ro = 1.0 / sigma1
    for _ in range(iters - 1):
        rho = 1.0 / (2.0 * sigma1 - ro)
        ax, ay = apply(ex, ey)
        dx_ = rho * ro * dx_ + (2.0 * rho / delta) * (rx - ax) / dvx
        dy_ = rho * ro * dy_ + (2.0 * rho / delta) * (ry - ay) / dvy
        ex = ex + dx_
        ey = ey + dy_
        ro = rho
    if not emit_residual:
        return ex, ey
    ax, ay = apply(ex, ey)
    return ex, ey, rx - ax, ry - ay


def _check(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(
            f"cheb kernel: {name} must be a contiguous CUDA float32 tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous: {t.is_contiguous()})")


def chebyshev_smooth_cuda(ex, ey, rx, ry, prep: SmootherPrep,
                          grid: StaggeredGrid, bcs: VelocityBCs, iters: int,
                          zero_init: bool = False,
                          emit_residual: bool = False):
    global launches, launches_periodic
    depth = iters + (1 if emit_residual else 0)
    if not 1 <= iters or depth > prep.h:
        raise ValueError(f"cheb kernel: iters {iters} (+emit) exceeds the "
                         f"prepped halo depth {prep.h}")
    ny, nx = grid.ny, grid.nx
    for name, t, shape in (("ex", ex, grid.shape_vx), ("ey", ey, grid.shape_vy),
                           ("rx", rx, grid.shape_vx), ("ry", ry, grid.shape_vy)):
        _check(name, t, shape)
    if prep.eta_n.shape != grid.shape_center or not prep.eta_n.is_cuda:
        raise ValueError("cheb kernel: the prep was built for another level "
                         "or for the CPU")
    ox = torch.empty_like(ex)
    oy = torch.empty_like(ey)
    fx = torch.empty_like(rx) if emit_residual else ox
    fy = torch.empty_like(ry) if emit_residual else oy
    plan = tile_plan(ny, nx, depth, device_sms(ex.device.index))
    code = cuda_build.library().launch_cheb(
        ex.data_ptr(), ey.data_ptr(), rx.data_ptr(), ry.data_ptr(),
        prep.eta_s.data_ptr(), prep.eta_n.data_ptr(), prep.coeffs.data_ptr(),
        prep.kb.data_ptr(), ox.data_ptr(), oy.data_ptr(), fx.data_ptr(),
        fy.data_ptr(), ny, nx, grid.dx, grid.dy, bcs.s_top, bcs.s_bottom,
        *side_signs(bcs), iters, prep.h, int(zero_init),
        int(emit_residual), plan.ty, int(bcs.periodic_x),
        cuda_build.stream_ptr(ex.device))
    cuda_build.check(code, "cheb")
    launches += 1
    launches_periodic += bcs.periodic_x
    return (ox, oy, fx, fy) if emit_residual else (ox, oy)


def kernel_info(he: int, ty: int, periodic: bool = False) -> dict:
    """Occupancy of the depth-``he`` kernel (``periodic``: its periodic
    form) with tiles of ``ty`` rows, from the card's own function
    attributes: registers per thread, static and dynamic shared bytes,
    local (spill) bytes per thread, threads and resident blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().cheb_kernel_info(
        he, ty, int(periodic), out), "cheb (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def chebyshev_smooth(ex, ey, rx, ry, prep: SmootherPrep, grid: StaggeredGrid,
                     bcs: VelocityBCs, iters: int, zero_init: bool = False,
                     emit_residual: bool = False):
    """One fused sweep: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if rx.is_cuda:
        return chebyshev_smooth_cuda(ex, ey, rx, ry, prep, grid, bcs, iters,
                                     zero_init, emit_residual)
    return chebyshev_smooth_plain(ex, ey, rx, ry, prep.eta_s, prep.eta_n, grid,
                                  bcs, prep.kbnd, prep.lam, iters, zero_init,
                                  emit_residual, diags=prep.diags)
