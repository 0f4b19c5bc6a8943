"""The whole coarse sub-V-cycle in one launch: wrapper of the CUDA kernel
``csrc/coarse_vcycle.cu`` (replaces the TPU kernel
``pylamp_tpu/ops/pallas/coarse_vcycle_kernel.py:coarse_vcycle_pallas``).

From the fusion start ``fs`` (``coarse_fuse_start``: the first level below
256 cells whose levels one cluster can hold) down to the coarsest level, one
V-cycle runs per level

    pre-smooth from zero (+ its residual) -> restrict -> V-cycle below
    -> prolong -> correct -> post-smooth

and ``coarse_iters`` Chebyshev iterations from zero on the coarsest level.
The transfers are the stencils of ``solvers/mg.py`` (the reference's dense
transfer matrices were how its kernel reached the TPU's matrix unit).

``CoarseVcyclePrep`` is built once per solve and holds every level's
constants: f32 viscosities and inverse Jacobi diagonals, the Chebyshev
table, kbnd, and the cluster plan (``cluster_plan``: which levels are split
into row strips over the cluster's CTAs, the threads and shared-memory
offsets of each level) as a device array of ``CoarseLevel``.  A launch
allocates nothing but its output, keeps every level in the cluster's shared
memory and never syncs the host.  ``coarse_vcycle`` runs the plain
recursive V-cycle (``coarse_vcycle_plain``) on CPU tensors and launches the
kernel on CUDA tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

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
MAX_IT = 64  # MAXIT: Chebyshev iterations per sweep, at most
CLUSTER = 8  # CL: CTAs per cluster (the portable size)
THREADS = 512  # NT: threads per CTA
MAX_POINTS_PER_THREAD = 5  # NQ
LEVEL_PLANES = 10  # PLANES: two iterate buffers (x, y), eta_s, eta_n,
# the inverse diagonals, the rhs
# levels with max(ny, nx) >= SPLIT_MIN, or too many points for one CTA's
# threads, are split into strips
SPLIT_MIN = 64


class CoarseLevel(ctypes.Structure):
    """Mirror of ``struct CoarseLevel`` in csrc/coarse_vcycle.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("es", "en", "idx", "idy")]
                + [("ny", ctypes.c_int), ("nx", ctypes.c_int),
                   ("dx", ctypes.c_float), ("dy", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in ("split", "nthr", "rows", "off")]
                + [("lo", ctypes.c_int * (CLUSTER + 1))])


# the kernel's static shared memory (SMEM_STATIC: its copies of the plan,
# the Chebyshev tables and kbnd) and the dynamic bytes a CTA may use beside
# it, of the H100's 232,448
SMEM_STATIC = (ctypes.sizeof(CoarseLevel) * MAX_LEVELS
               + 4 * MAX_LEVELS * (2 * MAX_IT + 1))
SMEM_PER_BLOCK = 232_448 - SMEM_STATIC


class LevelPlan(NamedTuple):
    """Where one level lives in the cluster: ``split`` levels give CTA s the
    point rows lo[s] .. lo[s+1]-1 (with a ghost row on each side), the
    others live in CTA 0 alone; ``nthr`` threads per CTA work on it; its
    planes start ``off`` floats into shared memory and hold ``rows`` rows
    of nx+1 points each."""
    split: bool
    nthr: int
    rows: int
    off: int
    lo: tuple


def _level_plan(g, off: int):
    """The level's LevelPlan, or None if a CTA's threads cannot hold it."""
    R, W = g.ny + 1, g.nx + 1
    if R >= CLUSTER and (max(g.ny, g.nx) >= SPLIT_MIN
                         or R * W > MAX_POINTS_PER_THREAD * THREADS):
        lo = tuple(s * R // CLUSTER for s in range(CLUSTER + 1))
        rows = max(b - a for a, b in zip(lo, lo[1:]))
        nthr = THREADS
    else:
        lo = (0,) + (R,) * CLUSTER
        rows = R
        # one point per thread in whole warps (4^2: one warp), up to the
        # CTA (32^2: 2-3 points each); measured on the H100 faster than two
        # or four points per thread
        nthr = min(THREADS, 32 * math.ceil(R * W / 32))
    if math.ceil(rows * W / nthr) > MAX_POINTS_PER_THREAD:
        return None
    return LevelPlan(lo[1] < R, nthr, rows + 2, off, lo)


def cluster_plan(grids):
    """([LevelPlan], dynamic shared bytes per CTA) of the fused levels on
    one cluster of CLUSTER CTAs, or None if its CTAs cannot hold them (too
    many points per thread, or more than SMEM_PER_BLOCK bytes)."""
    plans, off = [], 0
    for g in grids:
        if g.nx >= 1024 or g.ny >= 2048:  # the kernel's packed point index
            return None
        lp = _level_plan(g, off)
        if lp is None:
            return None
        plans.append(lp)
        off += -(-LEVEL_PLANES * lp.rows * (g.nx + 1) // 4) * 4  # 16 B
    return (plans, 4 * off) if 4 * off <= SMEM_PER_BLOCK else None


def coarse_fuse_start(grids, plan, bcs: VelocityBCs, dtype, smoother: str,
                      scaled_transfers: bool, ls_damp: bool,
                      cutoff: int = 256):
    """First level index the fused kernel can own: every level from there
    down must be uniform, fully coarsened, and below the cutoff.  None if
    fusion does not apply.

    One gate is the port's own: the levels from the start must fit one
    cluster (``cluster_plan``).  Where the first level below the cutoff
    does not (192^2, 160^2 and 224^2: FK at nx = 384, 640, 448 and their
    doubles), the start moves down to the first level that does, and the
    levels above it run the unfused V-cycle.  The reference fuses from the
    first level below the cutoff."""
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
        if cluster_plan(grids[l:]) is None:
            continue  # too large for one cluster: fuse from further down
        return l
    return None


class CoarseVcyclePrep:
    """Per-solve constants of the fused levels (index 0 = the level the
    cycle starts at): grids, viscosities, Jacobi diagonals, kbnd and lambda
    as given (the plain version's), and for the kernel the f32 viscosities
    and inverse diagonals, a (nlev, maxit, 2) Chebyshev table, a (nlev,)
    kbnd tensor and the cluster plan."""

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
        """The kernel's operands: f32 tables, viscosities and inverse
        diagonals, and the cluster plan as a device array of CoarseLevel
        (with its host copy, which the launcher checks)."""
        f32 = torch.float32
        dev = self.etas[0][1].device
        self.maxit = max(self.pre, self.post, self.coarse_iters)
        self.coeffs = chebyshev_coeffs(self.lam, self.maxit).to(dev)
        self.kb = torch.stack([torch.as_tensor(k, device=dev).to(f32).reshape(())
                               for k in self.kbnds]).contiguous()
        self.eta32 = [(es.to(f32).contiguous(), en.to(f32).contiguous())
                      for es, en in self.etas]
        self.inv_diags = [((1.0 / dvx).to(f32).contiguous(),
                           (1.0 / dvy).to(f32).contiguous())
                          for dvx, dvy in self.diags]
        # the level tensors are checked once here, not at every launch
        _check("coeffs", self.coeffs, (self.nlev, self.maxit, 2))
        _check("kbnd", self.kb, (self.nlev,))
        for (es, en), (ix, iy), g in zip(self.eta32, self.inv_diags,
                                         self.grids):
            for name, t, shape in (("eta_s", es, g.shape_corner),
                                   ("eta_n", en, g.shape_center),
                                   ("inverse diagonal x", ix, g.shape_vx),
                                   ("inverse diagonal y", iy, g.shape_vy)):
                _check(name, t, shape)
        cp = cluster_plan(self.grids)
        if cp is None:
            raise ValueError(
                f"coarse V-cycle kernel: the levels from {self.grids[0].ny}x"
                f"{self.grids[0].nx} do not fit one cluster (coarse_fuse_start "
                "starts where they do)")
        self.plans, self.smem = cp
        self.levels = (CoarseLevel * self.nlev)()
        for l, (g, (es, en), (ix, iy), lp) in enumerate(
                zip(self.grids, self.eta32, self.inv_diags, self.plans)):
            lv = self.levels[l]
            lv.es, lv.en = es.data_ptr(), en.data_ptr()
            lv.idx, lv.idy = ix.data_ptr(), iy.data_ptr()
            lv.ny, lv.nx, lv.dx, lv.dy = g.ny, g.nx, g.dx, g.dy
            lv.split, lv.nthr, lv.rows, lv.off = (int(lp.split), lp.nthr,
                                                  lp.rows, lp.off)
            for s, v in enumerate(lp.lo):
                lv.lo[s] = v
        # pinned, so the copy is queued on the stream without a host sync
        host = torch.frombuffer(bytearray(bytes(self.levels)),
                                dtype=torch.uint8).pin_memory()
        self.levels_dev = host.to(dev, non_blocking=True)


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
        raise ValueError(
            "the coarse V-cycle kernel has no periodic form: its gate "
            "(coarse_fuse_start) refuses periodic side walls, as the "
            "reference's does")
    if not hasattr(prep, "levels"):
        raise ValueError("coarse V-cycle kernel: the prep was built for the "
                         "CPU (no kernel constants)")
    g0 = prep.grids[0]
    _check("rx", rx, g0.shape_vx)
    _check("ry", ry, g0.shape_vy)
    ex = torch.empty_like(rx)
    ey = torch.empty_like(ry)
    b = prep.bcs
    code = cuda_build.library().launch_coarse_vcycle(
        ctypes.addressof(prep.levels), prep.levels_dev.data_ptr(), prep.nlev,
        rx.data_ptr(), ry.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        prep.coeffs.data_ptr(), prep.kb.data_ptr(), prep.maxit, prep.pre,
        prep.post, prep.coarse_iters, b.s_top, b.s_bottom, b.s_left,
        b.s_right, prep.smem, cuda_build.stream_ptr(rx.device))
    cuda_build.check(code, "coarse_vcycle")
    launches += 1
    return ex, ey


def kernel_info(prep: CoarseVcyclePrep) -> dict:
    """Occupancy of the kernel at the prep's shared memory, from the card's
    own function attributes: registers per thread, static and dynamic
    shared bytes, local (spill) bytes per thread, threads per CTA, CTAs per
    cluster and clusters resident at once."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().coarse_vcycle_kernel_info(
        prep.smem, out), "coarse_vcycle (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=prep.smem,
                local_bytes=out[2], threads=out[4], cluster=out[5],
                clusters=out[3])


def coarse_vcycle(rx, ry, prep: CoarseVcyclePrep):
    """One V-cycle over the fused levels, returning the (ex, ey)
    correction: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors."""
    if rx.is_cuda:
        return coarse_vcycle_cuda(rx, ry, prep)
    return coarse_vcycle_plain(rx, ry, prep)
