"""Full saddle-point apply for the FGMRES outer iterations: wrapper of the
CUDA kernel ``csrc/saddle.cu`` (replaces the TPU kernel
``pylamp_tpu/ops/pallas/stokes_kernel.py:saddle_apply_pallas``).

``prep_saddle`` runs once per Stokes solve (the counterpart of
``prep_eta_pallas``): it freezes contiguous f32 viscosities and packs
(kbnd, kcont) into a 2-element device tensor, so no apply syncs the host
for the scales.  ``saddle_apply`` runs the plain PyTorch version
(``saddle_apply_plain``, i.e. ``ops.stokes.stokes_operator``) on CPU
tensors and launches the kernel on CUDA tensors; it has no shape gate.
Periodic side walls launch the kernel's periodic form (wrapped vy ghost
columns, the seam half row in both seam columns), counted in
``launches_periodic`` as well.
"""
from __future__ import annotations

import dataclasses

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.stokes import stokes_operator

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, and those of the periodic form
launches = 0
launches_periodic = 0


@dataclasses.dataclass(frozen=True)
class SaddlePrep:
    eta_s: torch.Tensor  # (ny+1, nx+1) f32, contiguous
    eta_n: torch.Tensor  # (ny, nx) f32, contiguous
    kk: torch.Tensor  # (2,) f32: (kbnd, kcont)


def prep_saddle(eta_s, eta_n, kcont, kbnd) -> SaddlePrep:
    f32 = torch.float32
    dev = eta_n.device
    kk = torch.stack([torch.as_tensor(kbnd, dtype=f32, device=dev).reshape(()),
                      torch.as_tensor(kcont, dtype=f32, device=dev).reshape(())])
    return SaddlePrep(eta_s.to(f32).contiguous(), eta_n.to(f32).contiguous(),
                      kk)


def saddle_apply_plain(vx, vy, p, prep: SaddlePrep, grid: StaggeredGrid,
                       bcs: VelocityBCs):
    return stokes_operator(vx, vy, p, prep.eta_s, prep.eta_n, grid, bcs,
                           kcont=prep.kk[1], kbnd=prep.kk[0])


def side_signs(bcs: VelocityBCs):
    """(s_left, s_right) for a kernel's wall form; periodic side walls have
    no ghost sign (the periodic form never reads these)."""
    return (0.0, 0.0) if bcs.periodic_x else (bcs.s_left, bcs.s_right)


def _check(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(
            f"saddle kernel: {name} must be a contiguous CUDA float32 tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def saddle_apply_cuda(vx, vy, p, prep: SaddlePrep, grid: StaggeredGrid,
                      bcs: VelocityBCs):
    global launches, launches_periodic
    ny, nx = grid.ny, grid.nx
    vx, vy, p = vx.contiguous(), vy.contiguous(), p.contiguous()
    for name, t, shape in (("vx", vx, grid.shape_vx), ("vy", vy, grid.shape_vy),
                           ("p", p, grid.shape_center),
                           ("eta_s", prep.eta_s, grid.shape_corner),
                           ("eta_n", prep.eta_n, grid.shape_center),
                           ("kk", prep.kk, (2,))):
        _check(name, t, shape)
    rx = torch.empty_like(vx)
    ry = torch.empty_like(vy)
    rc = torch.empty_like(p)
    code = cuda_build.library().launch_saddle(
        vx.data_ptr(), vy.data_ptr(), p.data_ptr(), prep.eta_s.data_ptr(),
        prep.eta_n.data_ptr(), prep.kk.data_ptr(), rx.data_ptr(),
        ry.data_ptr(), rc.data_ptr(), ny, nx, grid.dx, grid.dy,
        bcs.s_top, bcs.s_bottom, *side_signs(bcs), int(bcs.periodic_x),
        cuda_build.stream_ptr(vx.device))
    cuda_build.check(code, "saddle")
    launches += 1
    launches_periodic += bcs.periodic_x
    return rx, ry, rc


def saddle_apply(vx, vy, p, prep: SaddlePrep, grid: StaggeredGrid,
                 bcs: VelocityBCs):
    """(rx, ry, rc) = saddle operator applied to (vx, vy, p): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if vx.is_cuda:
        return saddle_apply_cuda(vx, vy, p, prep, grid, bcs)
    return saddle_apply_plain(vx, vy, p, prep, grid, bcs)
