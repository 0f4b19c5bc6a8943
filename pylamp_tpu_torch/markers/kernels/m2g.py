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
rho0 * alpha stream in ``launches_ra``.  ``m2g_plan`` gives the kernel's
launch geometry (strip width, rows per chunk, slot units, shared memory).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

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
from pylamp_tpu_torch.markers.kernels.rebucket import (
    MAX_THREADS_SM,
    SMEM_BLOCK_MAX,
    SMEM_RESERVED,
    SMEM_SM,
)
from pylamp_tpu_torch.physics.materials import MaterialTable

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): all of them, those of the periodic form and those with the
# rho0 * alpha stream
launches = 0
launches_periodic = 0
launches_ra = 0

MAX_MATERIALS = 8
ETA_MODES = {"arithmetic": 0, "geometric": 1, "harmonic": 2}
# output order of the kernel's pointer array (csrc/m2g_node.cuh enum Out)
OUT_ORDER = ("c_w", "c_eta", "n_w", "n_eta", "vy_w", "vy_rho", "vx_w",
             "vx_rho", "c_T", "c_k", "c_rhocp", "c_H", "c_ra")
_TABLE_COLUMNS = ("eta0", "T_ref", "fk_gamma", "E_act", "rho0", "alpha", "k",
                  "cp", "H")
FLAG_VX, FLAG_ENERGY, FLAG_H, FLAG_PERIODIC, FLAG_RA = 1, 2, 4, 8, 16

# the constants of csrc/m2g_rows.cuh (kernels 2 and 10)
RING = 3  # units in shared memory
STRIP_COLS = 32  # node columns of a block
SPLIT = 2  # threads a node (each sums the slots s = h mod SPLIT)
CHUNK_ROWS = 32  # node rows of a block
MAX_UNIT = 16  # slots of a cell in one unit (at most 32: one mask word)
# the static shared memory: the material table (struct M2GTable) and the
# per-material k, rho0 * cp, H and rho0 * alpha
SMEM_STATIC = 4 * (4 + MAX_MATERIALS * (1 + len(_TABLE_COLUMNS) + 4))


def smem_bytes(tx: int, kc: int) -> int:
    """Dynamic shared bytes of a block with strips of ``tx`` node columns
    and units of ``kc`` slots (the Layout of csrc/m2g_rows.cuh): RING
    buffers of tx + 2 cells, each cell at a stride of kc | 1 slots of 48
    bytes (x, y, T, mat as landed, and the staged 32-byte record),
    ceil((kc + 3) / 4) words of valid bytes (up to 3 bytes of alignment
    lead) and 6 slot masks, each buffer rounded up to 16 bytes."""
    cells = tx + 2
    buf = cells * (48 * (kc | 1) + 4 * ((kc + 6) // 4) + 24)
    return RING * ((buf + 15) // 16 * 16)


def blocks_per_sm(smem: int, threads: int) -> int:
    """Resident blocks per SM that shared memory and threads allow."""
    return min(SMEM_SM // (smem + SMEM_STATIC + SMEM_RESERVED),
               MAX_THREADS_SM // threads, 32)


class M2GPlan(NamedTuple):
    """How csrc/m2g.cu covers the node lattice of an (ny, nx) grid: blocks
    of ``tx`` node columns (3 tx threads) by ``rows`` node rows (the last
    strip and chunk take what is left), ``nstrips`` x ``nchunks`` of them,
    each streaming its cell rows in ``units`` units of ``kc`` slots a
    cell, ``smem`` dynamic shared bytes each.  Node columns: nx + 1 (walls)
    or nx (periodic: the column-0 thread writes the seam column nx); node
    rows: ny + 1."""
    tx: int
    rows: int
    kc: int
    units: int
    split: int
    nstrips: int
    nchunks: int
    smem: int

    @property
    def threads(self) -> int:
        return 3 * self.tx * self.split

    def extents(self, ny: int, nx: int, periodic: bool = False):
        """Every block's node rows and columns as (row0, rows, col0,
        cols)."""
        nxn = nx if periodic else nx + 1
        for cy in range(self.nchunks):
            j0 = cy * self.rows
            for sx in range(self.nstrips):
                i0 = sx * self.tx
                yield (j0, min(self.rows, ny + 1 - j0), i0,
                       min(self.tx, nxn - i0))

    def slot_units(self, K: int):
        """Each unit's slots of a cell as (first, count)."""
        for c in range(self.units):
            yield c * self.kc, min(self.kc, K - c * self.kc)


@functools.lru_cache(maxsize=64)
def m2g_plan(ny: int, nx: int, K: int, flags: int = 0) -> M2GPlan:
    """Units of at most MAX_UNIT slots (K in balanced chunks), strips of
    STRIP_COLS node columns with SPLIT threads a node, chunks of
    CHUNK_ROWS node rows.  Of ``flags``
    (the kernel's) only FLAG_PERIODIC changes the plan.  At 1024^2 x K18:
    33 x 33 blocks of 32 node columns (192 threads), two 9-slot units a
    cell row, 47 KB each (4 resident per SM, as the kernel's 80 registers;
    smaller units leave room for more blocks, which hide the latency of a
    unit's staging: 0.77 ms against 1.0 ms with one 18-slot unit,
    PERF.md)."""
    if not 1 <= K or ny * nx * K >= 2 ** 31:
        raise ValueError(f"m2g kernel: K = {K} slots per cell on {ny} x "
                         f"{nx} cells (the kernel indexes slots in 31 bits)")
    units = math.ceil(K / MAX_UNIT)
    kc = math.ceil(K / units)
    tx = STRIP_COLS
    if smem_bytes(tx, kc) + SMEM_STATIC > SMEM_BLOCK_MAX:
        raise ValueError(f"m2g kernel: units of {kc} slots do not fit one "
                         "block's shared memory")
    nxn = nx if flags & FLAG_PERIODIC else nx + 1
    rows = min(CHUNK_ROWS, ny + 1)
    return M2GPlan(tx, rows, kc, units, SPLIT, math.ceil(nxn / tx),
                   math.ceil((ny + 1) / rows), smem_bytes(tx, kc))


def kernel_info(plan: M2GPlan, flags: int) -> dict:
    """Occupancy of the instantiation ``flags`` picks (FLAG_PERIODIC,
    FLAG_RA with FLAG_ENERGY) at ``plan``'s strips and units, from the
    card's function attributes: registers per thread, static and dynamic
    shared bytes, local (spill) bytes per thread, threads and resident
    blocks per SM."""
    out = (ctypes.c_int * 6)()
    cuda_build.check(cuda_build.library().m2g_kernel_info(
        plan.tx, plan.kc, plan.split, flags, out), "m2g (occupancy query)")
    return dict(registers=out[0], static_smem=out[1], dynamic_smem=out[5],
                local_bytes=out[2], threads=out[4], blocks_per_sm=out[3])


class _Table(ctypes.Structure):
    """Must match csrc/m2g_node.cuh struct M2GTable."""

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
    flags = ((FLAG_VX * with_vx) | (FLAG_ENERGY * with_energy)
             | (FLAG_H * with_h) | (FLAG_PERIODIC * periodic_x)
             | (FLAG_RA * with_ra))
    plan = m2g_plan(ny, nx, K, flags & FLAG_PERIODIC)
    code = cuda_build.library().launch_m2g(
        bm.x.data_ptr(), bm.y.data_ptr(), bm.T.data_ptr(), bm.mat.data_ptr(),
        bm.valid.data_ptr(), ctypes.addressof(tbl), ctypes.addressof(ptrs),
        ny, nx, K, grid.dx, grid.dy, flags, plan.tx, plan.rows, plan.kc,
        plan.units, plan.split, cuda_build.stream_ptr(dev))
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
