"""Fused marker->grid transfer of every per-step stream: wrapper of the CUDA
kernel ``csrc/m2g.cu`` (replaces the TPU kernel
``pylamp_tpu/markers/pallas/m2g_kernel.py:m2g_fused_pallas``).

Both versions return the TPU kernel's RAW dict of weighted sums and
weights per lattice: ``c_w``, ``c_eta`` (corner), ``n_w``, ``n_eta``
(center), ``vy_w``, ``vy_rho``, [``vx_w``, ``vx_rho``] and, with
``with_energy``, ``c_T``, ``c_k``, ``c_rhocp``, [``c_H``] and, with
``with_ra`` too, ``c_ra`` (rho0 * alpha, adiabatic heating's
coefficient).  The eta sums are of the eta-averaging transform (log eta
for geometric).  The step divides by the weights
(``models.step._interp_fused``).

``m2g_fused`` runs the plain version (``m2g_fused_plain``: marker
properties from the material table, then ``bucket.m2g_sums`` per lattice)
on CPU tensors and launches the kernel on CUDA tensors.  ``periodic_x``
selects the periodic form (node columns wrap with period nx, and the
nx+1-wide corner and vx lattices carry the seam sum in both seam columns);
its launches also count in ``launches_periodic``, and those with the
rho0 * alpha stream in ``launches_ra``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pylamp_tpu_torch import cuda_build
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import (
    ARITHMETIC,
    BucketedMarkers,
    m2g_sums,
    transform_values,
)
from pylamp_tpu_torch.markers.kernels import check_markers
from pylamp_tpu_torch.physics.materials import MaterialTable

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, those of the periodic form and those with the
# rho0 * alpha stream
launches = 0
launches_periodic = 0
launches_ra = 0

MAX_MATERIALS = 8
ETA_MODES = {"arithmetic": 0, "geometric": 1, "harmonic": 2}
# output order of the kernel's pointer array (csrc/m2g.cu enum Out)
OUT_ORDER = ("c_w", "c_eta", "n_w", "n_eta", "vy_w", "vy_rho", "vx_w",
             "vx_rho", "c_T", "c_k", "c_rhocp", "c_H", "c_ra")
_TABLE_COLUMNS = ("eta0", "T_ref", "fk_gamma", "E_act", "rho0", "alpha", "k",
                  "cp", "H")


class _Table(ctypes.Structure):
    """Must match csrc/m2g.cu struct M2GTable."""

    _fields_ = ([("n", ctypes.c_int), ("eta_mode", ctypes.c_int),
                 ("eta_min", ctypes.c_float), ("eta_max", ctypes.c_float),
                 ("law", ctypes.c_int * MAX_MATERIALS)]
                + [(c, ctypes.c_float * MAX_MATERIALS) for c in _TABLE_COLUMNS])


def _streams(table: MaterialTable, phys, with_energy: bool,
             with_ra: bool = False):
    """(with_vx, with_h, with_ra) and the stream names the dict carries,
    in the TPU kernel's plan order (rho0 * alpha only with the energy
    streams)."""
    with_vx = phys.gx != 0.0
    with_h = bool(np.any(np.asarray(table.H) != 0.0)) and with_energy
    with_ra = with_ra and with_energy
    names = ["c_w", "c_eta", "n_w", "n_eta", "vy_w", "vy_rho"]
    if with_vx:
        names += ["vx_w", "vx_rho"]
    if with_energy:
        names += ["c_T", "c_k", "c_rhocp"]
        if with_h:
            names += ["c_H"]
        if with_ra:
            names += ["c_ra"]
    return with_vx, with_h, with_ra, names


def _lattice_streams(T, mat, valid, table: MaterialTable, phys,
                     with_energy: bool, dtype, with_ra: bool = False):
    """[(lattice, weight name, {stream name: marker values})] of every
    stream, the values sanitized and transformed as the sums take them."""
    with_vx, with_h, with_ra, _ = _streams(table, phys, with_energy, with_ra)
    eta = torch.clamp(table.viscosity_of(mat, T), phys.eta_min, phys.eta_max)
    eta_v = transform_values(eta, valid, phys.eta_avg)
    rho_v = transform_values(table.density(mat, T), valid, ARITHMETIC)

    corner = {"c_eta": eta_v}
    if with_energy:
        corner["c_T"] = transform_values(T, valid, ARITHMETIC)
        corner["c_k"] = transform_values(table.conductivity(mat, dtype),
                                         valid, ARITHMETIC)
        corner["c_rhocp"] = transform_values(table.rho_cp(mat, T), valid,
                                             ARITHMETIC)
        if with_h:
            corner["c_H"] = transform_values(table.heating(mat, dtype),
                                             valid, ARITHMETIC)
        if with_ra:  # rho0 * alpha in the working dtype, as the kernel
            corner["c_ra"] = transform_values(
                table._select(table.rho0, mat, dtype)
                * table._select(table.alpha, mat, dtype), valid, ARITHMETIC)
    lattices = [("corner", "c_w", corner), ("center", "n_w", {"n_eta": eta_v}),
                ("vy", "vy_w", {"vy_rho": rho_v})]
    if with_vx:
        lattices.append(("vx", "vx_w", {"vx_rho": rho_v}))
    return lattices


def m2g_fused_plain(bm: BucketedMarkers, grid: StaggeredGrid,
                    table: MaterialTable, phys, with_energy: bool = False,
                    periodic_x: bool = False, with_ra: bool = False):
    """Plain PyTorch version: marker properties, then the dense-shift
    weighted sums of ``bucket.m2g_sums`` on each lattice."""
    out = {}
    for loc, wname, streams in _lattice_streams(
            bm.T, bm.mat, bm.valid, table, phys, with_energy, bm.x.dtype,
            with_ra):
        w, wvs = m2g_sums(bm, list(streams.values()), grid, loc, periodic_x)
        out[wname] = w
        out.update(zip(streams.keys(), wvs))
    return out


def _table_struct(table: MaterialTable, phys) -> _Table:
    n = len(table)
    if n > MAX_MATERIALS:
        raise ValueError(f"m2g kernel: at most {MAX_MATERIALS} materials, "
                         f"got {n}")
    if phys.eta_avg not in ETA_MODES:
        raise ValueError(f"unknown averaging mode {phys.eta_avg!r}")
    t = _Table()
    t.n = n
    t.eta_mode = ETA_MODES[phys.eta_avg]
    t.eta_min = float(phys.eta_min)
    t.eta_max = float(phys.eta_max)
    for m in range(n):
        t.law[m] = int(table.law[m])
        for c in _TABLE_COLUMNS:
            getattr(t, c)[m] = float(getattr(table, c)[m])
    return t


def m2g_fused_cuda(bm: BucketedMarkers, grid: StaggeredGrid,
                   table: MaterialTable, phys, with_energy: bool = False,
                   periodic_x: bool = False, with_ra: bool = False):
    global launches, launches_periodic, launches_ra
    check_markers(bm, "m2g")
    with_vx, with_h, with_ra, names = _streams(table, phys, with_energy,
                                               with_ra)
    ny, nx, K = bm.x.shape
    dev = bm.x.device
    shapes = {"c": grid.shape_corner, "n": grid.shape_center,
              "vy": grid.shape_vy, "vx": grid.shape_vx}
    out = {name: torch.empty(shapes[name.split("_")[0]], dtype=torch.float32,
                             device=dev) for name in names}
    ptrs = (ctypes.c_void_p * len(OUT_ORDER))(
        *[out[name].data_ptr() if name in out else None for name in OUT_ORDER])
    tbl = _table_struct(table, phys)
    flags = ((1 * with_vx) | (2 * with_energy) | (4 * with_h)
             | (8 * periodic_x) | (16 * with_ra))
    code = cuda_build.library().launch_m2g(
        bm.x.data_ptr(), bm.y.data_ptr(), bm.T.data_ptr(), bm.mat.data_ptr(),
        bm.valid.data_ptr(), ctypes.addressof(tbl), ctypes.addressof(ptrs),
        ny, nx, K, grid.dx, grid.dy, flags, cuda_build.stream_ptr(dev))
    cuda_build.check(code, "m2g")
    launches += 1
    launches_periodic += bool(periodic_x)
    launches_ra += with_ra
    return out


def m2g_fused(bm: BucketedMarkers, grid: StaggeredGrid, table: MaterialTable,
              phys, with_energy: bool = False, periodic_x: bool = False,
              with_ra: bool = False):
    """Raw weighted-sum dict of every marker->grid stream: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if bm.x.is_cuda:
        return m2g_fused_cuda(bm, grid, table, phys, with_energy, periodic_x,
                              with_ra)
    return m2g_fused_plain(bm, grid, table, phys, with_energy, periodic_x,
                           with_ra)
