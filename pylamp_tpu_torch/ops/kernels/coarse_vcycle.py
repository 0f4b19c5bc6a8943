"""The whole coarse sub-V-cycle in one launch: wrapper of the CUDA kernel
``csrc/coarse_vcycle.cu`` (replaces the TPU kernel
``pylamp_tpu/ops/pallas/coarse_vcycle_kernel.py:coarse_vcycle_pallas``).

From the fusion start ``fs`` (``coarse_fuse_start``: the first level below
256 cells) down to the coarsest level, one V-cycle runs per level

    pre-smooth from zero (+ its residual) -> restrict -> V-cycle below
    -> prolong -> correct -> post-smooth

and ``coarse_iters`` Chebyshev iterations from zero on the coarsest level.
The transfers are the stencils of ``solvers/mg.py`` (the reference's dense
transfer matrices were how its kernel reached the TPU's matrix unit).

``CoarseVcyclePrep`` is built once per solve and holds every level's
constants and every scratch buffer the kernel uses, so a launch allocates
nothing but its output and never syncs the host.  The scratch is reused by
every call, so calls with one prep must run on one stream (the solve's).
``coarse_vcycle`` runs the plain recursive V-cycle (``coarse_vcycle_plain``)
on CPU tensors and launches the kernel on CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.ops.kernels.cheb import (
    chebyshev_coeffs,
    chebyshev_smooth_plain,
)
from pylamp_tpu_torch.solvers.stokes_solver import velocity_diagonals

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

MAX_LEVELS = 16  # csrc/coarse_vcycle.cu MAXLEV


class CoarseLevel(ctypes.Structure):
    """Mirror of ``struct CoarseLevel`` in csrc/coarse_vcycle.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("es", "en", "rx", "ry", "ex", "ey", "sx", "sy", "ax", "ay")]
                + [("ny", ctypes.c_int), ("nx", ctypes.c_int),
                   ("dx", ctypes.c_float), ("dy", ctypes.c_float)])


def coarse_fuse_start(grids, plan, bcs: VelocityBCs, dtype, smoother: str,
                      scaled_transfers: bool, ls_damp: bool,
                      cutoff: int = 256):
    """First level index the fused kernel can own: every level from there
    down must be uniform, fully coarsened, and below the cutoff.  None if
    fusion does not apply."""
    if (dtype != torch.float32 or smoother != "chebyshev"
            or scaled_transfers or ls_damp or bcs.periodic_x):
        return None
    nlev = len(grids)
    for l in range(1, nlev):
        g = grids[l]
        if not g.uniform:
            return None
        if max(g.ny, g.nx) >= cutoff:
            continue
        if any(p != (True, True) for p in plan[l:]):
            return None
        if l == nlev - 1:
            return None  # nothing to fuse below the coarsest
        return l
    return None


class CoarseVcyclePrep:
    """Per-solve constants of the fused levels (index 0 = the level the
    cycle starts at): grids, viscosities, Jacobi diagonals, kbnd and lambda
    as given (the plain version's), and for the kernel the f32 viscosities,
    a (nlev, maxit, 2) Chebyshev table, a (nlev,) kbnd tensor and per-level
    scratch."""

    def __init__(self, grids, etas, kbnds, lam_max, bcs: VelocityBCs,
                 pre: int, post: int, coarse_iters: int, diags=None):
        self.nlev = len(grids)
        if not 2 <= self.nlev <= MAX_LEVELS:
            raise ValueError(f"coarse V-cycle: {self.nlev} levels, not in "
                             f"2..{MAX_LEVELS}")
        self.grids, self.etas, self.kbnds = list(grids), list(etas), list(kbnds)
        self.lam = lam_max  # (nlev,) tensor
        self.bcs = bcs
        self.pre, self.post, self.coarse_iters = pre, post, coarse_iters
        self.diags = list(diags) if diags is not None else [
            velocity_diagonals(es, en, g, kb, bcs=bcs)
            for (es, en), g, kb in zip(self.etas, self.grids, self.kbnds)]
        if self.etas[0][1].is_cuda:
            self._kernel_constants()

    def _kernel_constants(self):
        """The kernel's operands: f32 tables, viscosities and scratch, with
        the host array of per-level pointers it is launched with."""
        f32 = torch.float32
        dev = self.etas[0][1].device
        self.maxit = max(self.pre, self.post, self.coarse_iters)
        self.coeffs = chebyshev_coeffs(self.lam, self.maxit).to(dev)
        self.kb = torch.stack([torch.as_tensor(k, device=dev).to(f32).reshape(())
                               for k in self.kbnds]).contiguous()
        self.eta32 = [(es.to(f32).contiguous(), en.to(f32).contiguous())
                      for es, en in self.etas]
        # scratch: the level-0 rhs and iterate are the call's own tensors
        self.scratch = []
        self.levels = (CoarseLevel * self.nlev)()
        for l, (g, (es, en)) in enumerate(zip(self.grids, self.eta32)):
            def buf(shape):
                return torch.empty(shape, dtype=f32, device=dev)
            s = dict(sx=buf(g.shape_vx), sy=buf(g.shape_vy),
                     ax=buf(g.shape_vx), ay=buf(g.shape_vy))
            if l > 0:
                s.update(rx=buf(g.shape_vx), ry=buf(g.shape_vy),
                         ex=buf(g.shape_vx), ey=buf(g.shape_vy))
            self.scratch.append(s)
            lv = self.levels[l]
            lv.es, lv.en = es.data_ptr(), en.data_ptr()
            for k, t in s.items():
                setattr(lv, k, t.data_ptr())
            lv.ny, lv.nx, lv.dx, lv.dy = g.ny, g.nx, g.dx, g.dy


def coarse_vcycle_plain(rx, ry, prep: CoarseVcyclePrep, l: int = 0):
    """The plain recursive V-cycle from level ``l`` of the prep down (the
    computation of solvers/mg.py's vcycle below the fusion start)."""
    from pylamp_tpu_torch.solvers.mg import (
        prolong_vx,
        prolong_vy,
        restrict_vx,
        restrict_vy,
    )

    bcs = prep.bcs

    def smooth(ex, ey, iters, zero_init, emit):
        es, en = prep.etas[l]
        return chebyshev_smooth_plain(
            ex, ey, rx, ry, es, en, prep.grids[l], bcs, prep.kbnds[l],
            prep.lam[l], iters, zero_init=zero_init, emit_residual=emit,
            diags=prep.diags[l])

    ex = torch.zeros_like(rx)
    ey = torch.zeros_like(ry)
    if l == prep.nlev - 1:
        return smooth(ex, ey, prep.coarse_iters, True, False)
    ex, ey, rfx, rfy = smooth(ex, ey, prep.pre, True, True)
    rcx = restrict_vx(rfx, bcs)
    rcy = restrict_vy(rfy, bcs)
    ecx, ecy = coarse_vcycle_plain(rcx, rcy, prep, l + 1)
    ex = ex + prolong_vx(ecx, bcs)
    ey = ey + prolong_vy(ecy, bcs)
    return smooth(ex, ey, prep.post, False, False)


def _check(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(
            f"coarse V-cycle kernel: {name} must be a contiguous CUDA float32 "
            f"tensor of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous: {t.is_contiguous()})")


def coarse_vcycle_cuda(rx, ry, prep: CoarseVcyclePrep):
    global launches
    if prep.bcs.periodic_x:
        raise NotImplementedError(
            "the periodic coarse V-cycle kernel waits for a later port PR")
    if not hasattr(prep, "levels"):
        raise ValueError("coarse V-cycle kernel: the prep was built for the "
                         "CPU (no kernel constants or scratch)")
    g0 = prep.grids[0]
    _check("rx", rx, g0.shape_vx)
    _check("ry", ry, g0.shape_vy)
    _check("coeffs", prep.coeffs, (prep.nlev, prep.maxit, 2))
    _check("kbnd", prep.kb, (prep.nlev,))
    for (es, en), g in zip(prep.eta32, prep.grids):
        _check("eta_s", es, g.shape_corner)
        _check("eta_n", en, g.shape_center)
    ex = torch.empty_like(rx)
    ey = torch.empty_like(ry)
    b = prep.bcs
    code = cuda_build.library().launch_coarse_vcycle(
        ctypes.addressof(prep.levels), prep.nlev, rx.data_ptr(), ry.data_ptr(),
        ex.data_ptr(), ey.data_ptr(), prep.coeffs.data_ptr(),
        prep.kb.data_ptr(), prep.maxit, prep.pre, prep.post,
        prep.coarse_iters, b.s_top, b.s_bottom, b.s_left, b.s_right,
        cuda_build.stream_ptr(rx.device))
    cuda_build.check(code, "coarse_vcycle")
    launches += 1
    return ex, ey


def coarse_vcycle(rx, ry, prep: CoarseVcyclePrep):
    """One V-cycle over the fused levels, returning the (ex, ey)
    correction: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors."""
    if rx.is_cuda:
        return coarse_vcycle_cuda(rx, ry, prep)
    return coarse_vcycle_plain(rx, ry, prep)
