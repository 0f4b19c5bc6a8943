"""MG momentum-block apply: wrapper of the CUDA kernel ``csrc/momentum.cu``
(replaces the TPU kernel
``pylamp_tpu/ops/pallas/stokes_kernel.py:momentum_apply_pallas``).

(rx, ry) = A (vx, vy) is the saddle operator with p = 0 and no continuity
row.  ``momentum_apply_plain`` is the plain PyTorch version, and the one
plain momentum apply of the port (the smoothers' plain versions call it).

``prep_momentum`` runs once per level per solve (the role of
``prep_eta_pallas``): it freezes contiguous f32 viscosities and kbnd as a
1-element device tensor, so no apply syncs the host.  The first apply of
a solve on a level builds the launch's constants (grid, wall signs, the
frozen pointers) into one ctypes struct, as the saddle kernel's wrapper
does; every apply then checks only vx and vy and takes the stream handle
without building a Stream object.  ``momentum_apply_kernel`` runs the
plain version on CPU tensors and launches the kernel on CUDA tensors; the
shape gate is the caller's (``solvers/mg.py _pallas_eligible``).
Periodic side walls launch the kernel's periodic form, counted in
``launches_periodic`` as well.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels.saddle import launch_args
from pylamp_tpu_torch.ops.stokes import stokes_operator

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, and those of the periodic form
launches = 0
launches_periodic = 0


def momentum_apply_plain(vx, vy, eta_s, eta_n, grid, bcs, kbnd):
    """Momentum-block application (the saddle operator with p = 0)."""
    rx, ry, _ = stokes_operator(
        vx, vy, torch.zeros(grid.shape_center, dtype=vx.dtype, device=vx.device),
        eta_s, eta_n, grid, bcs, kcont=1.0, kbnd=kbnd)
    return rx, ry


@dataclasses.dataclass(frozen=True)
class MomentumPrep:
    eta_s: torch.Tensor  # (ny+1, nx+1) f32, contiguous
    eta_n: torch.Tensor  # (ny, nx) f32, contiguous
    kbnd: Any  # as given (the plain version's operand)
    kb: torch.Tensor  # (1,) f32 kbnd (the kernel's)
    # the launch arguments of the last (grid, bcs) this prep was applied
    # with (momentum_apply_cuda fills it at the first call of a solve)
    launch: list = dataclasses.field(default_factory=lambda: [None],
                                     compare=False, repr=False)


def prep_momentum(eta_s, eta_n, kbnd) -> MomentumPrep:
    kb = torch.as_tensor(kbnd, device=eta_n.device).to(torch.float32).reshape(1)
    return MomentumPrep(eta_s.to(torch.float32).contiguous(),
                        eta_n.to(torch.float32).contiguous(), kbnd, kb)


def momentum_apply_cuda(vx, vy, prep: MomentumPrep, grid: StaggeredGrid,
                        bcs: VelocityBCs):
    """The kernel on CUDA tensors: vx and vy must be contiguous float32 of
    the grid's shapes (the prep is checked against the grid at the first
    apply of a solve)."""
    global launches, launches_periodic
    _, args_ptr, shapes = launch_args(prep.launch, prep.eta_s, prep.eta_n,
                                      prep.kb, grid, bcs, "momentum")
    for name, t, shape in zip(("vx", "vy"), (vx, vy), shapes):
        if t.dtype != torch.float32 or t.shape != shape \
                or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(
                f"momentum kernel: {name} must be a contiguous CUDA float32 "
                f"tensor of shape {tuple(shape)}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous: "
                f"{t.is_contiguous()})")
    dev = vx.device
    rx = torch.empty(shapes[0], dtype=torch.float32, device=dev)
    ry = torch.empty(shapes[1], dtype=torch.float32, device=dev)
    code = cuda_build.library().launch_momentum(
        vx.data_ptr(), vy.data_ptr(), rx.data_ptr(), ry.data_ptr(), args_ptr,
        cuda_build.raw_stream(dev.index))
    cuda_build.check(code, "momentum")
    launches += 1
    launches_periodic += bcs.periodic_x
    return rx, ry


def kernel_info(periodic: bool = False) -> dict:
    """Occupancy of the kernel (``periodic``: its periodic form), from the
    card's function attributes (the keys of saddle.kernel_info)."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().momentum_kernel_info(
        int(periodic), out), "momentum (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


def momentum_apply_kernel(vx, vy, prep: MomentumPrep, grid: StaggeredGrid,
                          bcs: VelocityBCs):
    """(rx, ry) = A (vx, vy): the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if vx.is_cuda:
        return momentum_apply_cuda(vx, vy, prep, grid, bcs)
    return momentum_apply_plain(vx, vy, prep.eta_s, prep.eta_n, grid, bcs,
                                prep.kbnd)
