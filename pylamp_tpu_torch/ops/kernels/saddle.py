"""Full saddle-point apply for the FGMRES outer iterations: wrapper of the
CUDA kernel ``csrc/saddle.cu`` (replaces the TPU kernel
``pylamp_tpu/ops/pallas/stokes_kernel.py:saddle_apply_pallas``).

``prep_saddle`` runs once per Stokes solve (the counterpart of
``prep_eta_pallas``): it checks the contiguous f32 viscosities once and
packs (kbnd, kcont) into a 2-element device tensor, so no apply syncs the
host for the scales.  The first apply of a solve builds the launch's
constants (grid, wall signs, the frozen pointers) into one ctypes struct;
every apply then checks only vx, vy and p, allocates rx, ry and rc (three
allocations cost less host time than one buffer cut into views:
``kernel_ab.py``) and takes the stream handle without building a Stream
object.  ``saddle_apply`` runs the plain PyTorch version
(``saddle_apply_plain``, i.e. ``ops.stokes.stokes_operator``) on CPU
tensors and launches the kernel on CUDA tensors; it has no shape gate.
Periodic side walls launch the kernel's periodic form (wrapped vy ghost
columns, the seam half row in both seam columns), counted in
``launches_periodic`` as well.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.stokes import stokes_operator

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, and those of the periodic form
launches = 0
launches_periodic = 0

# csrc/saddle_tile.cuh: the tile of kernels 1 and 7, in points
TILE_Y = 16
TILE_X = 32


class TilePlan(NamedTuple):
    """How csrc/saddle_tile.cuh tiles a level's (ny+1, nx+1) point space
    for kernels 1 and 7 (``tile_grid``): nty x ntx tiles of TILE_Y x TILE_X
    points, the last row and column of tiles clipped to the space."""
    nty: int
    ntx: int

    def extents(self, ny: int, nx: int):
        """Every tile's points as (row0, rows, col0, cols) and whether it
        takes the branch-free form (``apply_tile``: its staged frame holds
        no ghost, and it no Dirichlet row or column and no seam)."""
        for by in range(self.nty):
            j0 = by * TILE_Y
            for bx in range(self.ntx):
                i0 = bx * TILE_X
                interior = (j0 >= 1 and j0 + TILE_Y <= ny - 1 and i0 >= 1
                            and i0 + TILE_X <= nx - 1)
                yield (j0, min(TILE_Y, ny + 1 - j0), i0,
                       min(TILE_X, nx + 1 - i0), interior)


def tile_plan(ny: int, nx: int) -> TilePlan:
    """The tiles of kernels 1 and 7 on an ny x nx level."""
    return TilePlan(-(-(ny + 1) // TILE_Y), -(-(nx + 1) // TILE_X))


class SaddleArgs(ctypes.Structure):
    """csrc/saddle_tile.cuh SaddleArgs: the launch's per-solve constants
    (kernels 1 and 7)."""
    _fields_ = [("eta_s", ctypes.c_void_p), ("eta_n", ctypes.c_void_p),
                ("kk", ctypes.c_void_p), ("ny", ctypes.c_int),
                ("nx", ctypes.c_int), ("dx", ctypes.c_float),
                ("dy", ctypes.c_float), ("s_top", ctypes.c_float),
                ("s_bottom", ctypes.c_float), ("s_left", ctypes.c_float),
                ("s_right", ctypes.c_float), ("periodic", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class SaddlePrep:
    eta_s: torch.Tensor  # (ny+1, nx+1) f32, contiguous
    eta_n: torch.Tensor  # (ny, nx) f32, contiguous
    kk: torch.Tensor  # (2,) f32: (kbnd, kcont)
    # the launch arguments of the last (grid, bcs) this prep was applied
    # with (saddle_apply_cuda fills it at the first call of a solve)
    launch: list = dataclasses.field(default_factory=lambda: [None],
                                     compare=False, repr=False)


def prep_saddle(eta_s, eta_n, kcont, kbnd) -> SaddlePrep:
    """Freeze a solve's viscosities and pack (kbnd, kcont) into a 2-element
    tensor on their device.  The viscosities must be contiguous f32 on one
    device, eta_s one point wider and taller than eta_n (the corner and
    cell lattices of one grid): every apply of the solve relies on these
    checks, made once here."""
    f32 = torch.float32
    for name, t in (("eta_s", eta_s), ("eta_n", eta_n)):
        if t.dtype != f32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"prep_saddle: {name} must be a contiguous 2-D float32 "
                f"tensor, got {t.dtype} {tuple(t.shape)}"
                f"{'' if t.is_contiguous() else ', not contiguous'}")
    ny, nx = eta_n.shape
    if tuple(eta_s.shape) != (ny + 1, nx + 1) or eta_s.device != eta_n.device:
        raise ValueError(
            f"prep_saddle: eta_s {tuple(eta_s.shape)} on {eta_s.device} is "
            f"not the corner lattice of eta_n {tuple(eta_n.shape)} on "
            f"{eta_n.device}")
    dev = eta_n.device
    kk = torch.stack([torch.as_tensor(kbnd, dtype=f32, device=dev).reshape(()),
                      torch.as_tensor(kcont, dtype=f32, device=dev).reshape(())])
    return SaddlePrep(eta_s, eta_n, kk)


def saddle_apply_eligible(grid: StaggeredGrid, dtype,
                          bcs: VelocityBCs) -> bool:
    """The reference's gate (stokes_kernel.py saddle_apply_eligible) without
    its platform test and TPU block shape: f32 on a uniform grid (the
    kernel divides by the scalar dx, dy; it has no shape gate of its own,
    and both wall forms and the periodic form exist)."""
    return dtype == torch.float32 and grid.uniform


def saddle_apply_plain(vx, vy, p, prep: SaddlePrep, grid: StaggeredGrid,
                       bcs: VelocityBCs):
    return stokes_operator(vx, vy, p, prep.eta_s, prep.eta_n, grid, bcs,
                           kcont=prep.kk[1], kbnd=prep.kk[0])


def side_signs(bcs: VelocityBCs):
    """(s_left, s_right) for a kernel's wall form; periodic side walls have
    no ghost sign (the periodic form never reads these)."""
    return (0.0, 0.0) if bcs.periodic_x else (bcs.s_left, bcs.s_right)


def launch_args(cache: list, eta_s, eta_n, kk, grid: StaggeredGrid,
                bcs: VelocityBCs, kernel: str):
    """(args, pointer to them, shapes of vx, vy and p) of an apply on
    ``grid`` with ``bcs`` over the frozen viscosities and scales: built and
    checked at the first apply of a solve, kept in ``cache`` (a prep's
    one-element list), then reused while the solve passes the same grid
    and BCs."""
    last = cache[0]
    if last is not None and last[0] is grid and last[1] is bcs:
        return last[2]
    for name, t, shape in (("eta_n", eta_n, grid.shape_center),
                           ("eta_s", eta_s, grid.shape_corner)):
        if tuple(t.shape) != shape or not t.is_cuda:
            raise ValueError(
                f"{kernel} kernel: the prep's {name} {tuple(t.shape)} on "
                f"{t.device} is not a CUDA tensor of the grid's {shape}")
    args = SaddleArgs(eta_s.data_ptr(), eta_n.data_ptr(), kk.data_ptr(),
                      grid.ny, grid.nx, grid.dx, grid.dy, bcs.s_top,
                      bcs.s_bottom, *side_signs(bcs), int(bcs.periodic_x))
    shapes = tuple(torch.Size(s) for s in (grid.shape_vx, grid.shape_vy,
                                           grid.shape_center))
    built = (args, ctypes.addressof(args), shapes)
    cache[0] = (grid, bcs, built)
    return built


def saddle_apply_cuda(vx, vy, p, prep: SaddlePrep, grid: StaggeredGrid,
                      bcs: VelocityBCs):
    """The kernel on CUDA tensors: vx, vy and p must be contiguous float32
    of the grid's shapes (the prep was checked by prep_saddle and, against
    the grid, at the solve's first apply)."""
    global launches, launches_periodic
    _, args_ptr, shapes = launch_args(prep.launch, prep.eta_s, prep.eta_n,
                                      prep.kk, grid, bcs, "saddle")
    for name, t, shape in zip(("vx", "vy", "p"), (vx, vy, p), shapes):
        if t.dtype != torch.float32 or t.shape != shape \
                or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(
                f"saddle kernel: {name} must be a contiguous CUDA float32 "
                f"tensor of shape {tuple(shape)}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    dev = vx.device
    rx, ry, rc = (torch.empty(s, dtype=torch.float32, device=dev)
                  for s in shapes)
    code = cuda_build.library().launch_saddle(
        vx.data_ptr(), vy.data_ptr(), p.data_ptr(), rx.data_ptr(),
        ry.data_ptr(), rc.data_ptr(), args_ptr,
        cuda_build.raw_stream(dev.index))
    cuda_build.check(code, "saddle")
    launches += 1
    launches_periodic += bcs.periodic_x
    return rx, ry, rc


def kernel_info(periodic: bool = False) -> dict:
    """Occupancy of the kernel (``periodic``: its periodic form), from the
    card's function attributes: registers per thread, static and dynamic
    shared bytes, local (spill) bytes per thread, threads and resident
    blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().saddle_kernel_info(
        int(periodic), out), "saddle (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def saddle_apply(vx, vy, p, prep: SaddlePrep, grid: StaggeredGrid,
                 bcs: VelocityBCs):
    """(rx, ry, rc) = saddle operator applied to (vx, vy, p): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if vx.is_cuda:
        return saddle_apply_cuda(vx, vy, p, prep, grid, bcs)
    return saddle_apply_plain(vx, vy, p, prep, grid, bcs)
