"""Explicit-halo Stokes and energy operators on the in-process mesh.

Port of ``pylamp_tpu/parallel/halo_ops.py``: the variable-viscosity
Stokes saddle apply and the energy diffusion apply with every neighbour
exchange placed by hand.

The staggered lattices carry one extra node row/column that does not
divide over the mesh, so each operator splits a field into a divisible
interior block array plus thin seam strips:

    vx    -> vx[:, :-1]  (ny, nx)  P(y, x)   + last column  P(y, None)
    vy    -> vy[:-1, :]  (ny, nx)  P(y, x)   + last row     P(None, x)
    corner-> f[:-1, :-1] (ny, nx)  P(y, x)   + last row/col + corner

A shard body builds one-deep extended blocks (rows first, then the
columns of the row-extended block, so diagonal corners ride along), fills
the physical walls with the global operators' BC ghosts and takes the true
last-node values from the seam strips.  Seam outputs are Dirichlet rows
assembled outside the body or psum-reduced strips.

Periodic side walls: the x exchanges become a ring over the torus seam,
and the duplicated seam columns (0 and nx) each carry half the wrapped
equation, as the global operators do (ops/stokes.py, ops/energy.py).

``stokes_operator_halo(use_pallas=True)`` runs each shard's stencil
arithmetic through the per-shard saddle kernel (ops/kernels/saddle_block,
the counterpart of the reference's block_stencil_kernel) on blocks that
pass its gate; the halo construction and the Dirichlet patches stay tensor
code either way; under periodic side walls the seam rows are tensor code
around it (the kernel has no periodic form, as in the reference).
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.bc import DIRICHLET, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels import saddle_block
from pylamp_tpu_torch.parallel.mesh import P, Mesh


def halo_eligible(grid: StaggeredGrid, mesh: Mesh) -> bool:
    """Evenly divisible blocks of at least 2x2 cells (one-deep halos);
    smaller levels stay on the global tensors."""
    if not grid.uniform:
        return False
    my, mx = mesh.my, mesh.mx
    return (grid.ny % my == 0 and grid.nx % mx == 0
            and grid.ny // my >= 2 and grid.nx // mx >= 2)


def _rows(*a):
    return torch.cat(a, dim=-2)


def _cols(*a):
    return torch.cat(a, dim=-1)


def _first_row(a):
    return a[..., :1, :]


def _last_row(a):
    return a[..., -1:, :]


def _first_col(a):
    return a[..., :1]


def _last_col(a):
    return a[..., -1:]


# -- Stokes -------------------------------------------------------------------


def stokes_operator_halo(vx, vy, p, eta_s, eta_n, grid: StaggeredGrid,
                         bcs: VelocityBCs, mesh: Mesh, kcont=1.0, kbnd=1.0,
                         use_pallas: bool = False):
    """Explicit-halo application of the Stokes operator; the same stencil
    and BC ghosts as ops.stokes.stokes_operator.  ``p=None`` applies the
    momentum block alone (the MG applies) and returns (rx, ry, None).
    ``use_pallas``: the per-shard saddle kernel on eligible blocks."""
    periodic = bcs.periodic_x
    my, mx = mesh.my, mesh.mx
    by, bx = grid.ny // my, grid.nx // mx
    dev = eta_n.device
    with_p = p is not None
    kernel = use_pallas and saddle_block.block_stencil_eligible(
        by, bx, eta_n.dtype)

    def local(vxI, vxR, vyI, vyB, esI, esR, esB, esC, en, pc):
        iy = mesh.axis_index("y", device=dev)
        ix = mesh.axis_index("x", device=dev)
        first_y, last_y = iy == 0, iy == my - 1
        first_x, last_x = ix == 0, ix == mx - 1

        # vx extended (by+2, bx+2): BC ghost rows at the walls, the true
        # last column (vxR) at the right seam; the leftmost block's left
        # halo is unused (col 0 is a Dirichlet row) and stays zero.
        # Periodic sides: the x exchanges are a ring over the torus seam --
        # the rightmost block's right halo is the leftmost's col 0 (the
        # duplicated seam node), the leftmost's left halo the rightmost's
        # last interior column (global nx-1), the wrap the global
        # operator's ghosts read
        t = mesh.from_prev(_last_row(vxI), "y")
        b = mesh.from_next(_first_row(vxI), "y")
        t = torch.where(first_y, bcs.s_top * _first_row(vxI), t)
        b = torch.where(last_y, bcs.s_bottom * _last_row(vxI), b)
        rows = _rows(t, vxI, b)
        left = mesh.from_prev(_last_col(rows), "x", ring=periodic)
        right = mesh.from_next(_first_col(rows), "x", ring=periodic)
        if not periodic:
            tR = mesh.from_prev(_last_row(vxR), "y")
            bR = mesh.from_next(_first_row(vxR), "y")
            tR = torch.where(first_y, bcs.s_top * _first_row(vxR), tR)
            bR = torch.where(last_y, bcs.s_bottom * _last_row(vxR), bR)
            right = torch.where(last_x, _rows(tR, vxR, bR), right)
        vx_ext = _cols(left, rows, right)

        # vy extended: BC ghost columns at the side walls (wrap halos under
        # periodic), the true last row (vyB) at the bottom seam
        t = mesh.from_prev(_last_row(vyI), "y")
        b = mesh.from_next(_first_row(vyI), "y")
        b = torch.where(last_y, vyB, b)
        rows = _rows(t, vyI, b)
        left = mesh.from_prev(_last_col(rows), "x", ring=periodic)
        right = mesh.from_next(_first_col(rows), "x", ring=periodic)
        if not periodic:
            left = torch.where(first_x, bcs.s_left * _first_col(rows), left)
            right = torch.where(last_x, bcs.s_right * _last_col(rows),
                                right)
        vy_ext = _cols(left, rows, right)

        # eta_s extended (by+1, bx+1): corner lattice, +1 row/col from the
        # next block (or the seam strips at the domain edge)
        b = mesh.from_next(_first_row(esI), "y")
        b = torch.where(last_y, esB, b)
        rows = _rows(esI, b)
        bR = mesh.from_next(_first_row(esR), "y")
        bR = torch.where(last_y, esC, bR)
        right = mesh.from_next(_first_col(rows), "x")
        right = torch.where(last_x, _rows(esR, bR), right)
        es_ext = _cols(rows, right)

        # cell-centred ring halos (the fill beyond the domain is read only
        # by boundary rows that are overwritten below)
        en_ext = mesh.ext1(en, ring_x=periodic)
        p_ext = mesh.ext1(pc, ring_x=periodic) if with_p else None

        if kernel:
            out = saddle_block.saddle_block_batched(
                mesh, vx_ext, vy_ext, p_ext, es_ext, en_ext, grid, kcont)
        else:
            out = saddle_block.saddle_block_plain(
                vx_ext, vy_ext, p_ext, es_ext, en_ext, grid.dx, grid.dy,
                kcont)
        rx_blk, ry_blk = out[0], out[1]
        rc = out[2] if with_p else None

        col = torch.arange(bx, device=dev).view(1, bx)
        row = torch.arange(by, device=dev).view(by, 1)
        ryI = torch.where(first_y & (row == 0), kbnd * vyI, ry_blk)
        seam = first_x & (col == 0)
        if periodic:
            # the seam momentum row (global vx cols 0 and nx are one node):
            # the ring halos made the leftmost blocks' col 0 the whole
            # wrapped equation; each duplicate column carries half of it
            rxI = torch.where(seam, 0.5 * rx_blk, rx_blk)
            rseam = mesh.psum(torch.where(
                first_x, 0.5 * _first_col(rx_blk),
                torch.zeros_like(_first_col(rx_blk))), "x")
            return rxI, ryI, rc, rseam
        rxI = torch.where(seam, kbnd * vxI, rx_blk)
        return rxI, ryI, rc, None

    blk = P("y", "x")
    body = mesh.shard_map(
        local,
        in_specs=(blk, P("y", None), blk, P(None, "x"), blk, P("y", None),
                  P(None, "x"), P(None, None), blk, blk),
        out_specs=(blk, blk, blk if with_p else (), P("y", None)))
    rxI, ryI, rc, rseam = body(
        vx[:, :-1], vx[:, -1:], vy[:-1, :], vy[-1:, :],
        eta_s[:-1, :-1], eta_s[:-1, -1:], eta_s[-1:, :-1], eta_s[-1:, -1:],
        eta_n, p)
    # seam outputs, assembled outside the body: the Dirichlet rows, or the
    # wrapped half-equation (periodic)
    rx = torch.cat([rxI, rseam if periodic else kbnd * vx[:, -1:]], dim=1)
    ry = torch.cat([ryI, kbnd * vy[-1:, :]], dim=0)
    return rx, ry, (rc if with_p else None)


# -- Energy -------------------------------------------------------------------


def _favg(a, b, mode: str):
    if mode == "arithmetic":
        return 0.5 * (a + b)
    if mode == "harmonic":
        return 2.0 * a * b / (a + b)
    raise ValueError(f"unknown k averaging mode {mode!r}")


def energy_operator_halo(T, k, rhocp_over_dt, grid: StaggeredGrid,
                         bcs: ThermalBCs, mesh: Mesh, kbnd=1.0,
                         k_avg: str = "arithmetic"):
    """Explicit-halo application of the energy operator; the same mirror
    ghosts, Dirichlet identity rows and face-averaged conductivity as
    ops.energy.energy_operator.  Periodic side walls: a ring exchange over
    the torus seam; the duplicated seam columns (0 and nx) each carry half
    the wrapped equation, with the col-nx equation computed on the
    leftmost blocks, which hold every value its stencil reads (the west
    ring halo, col nx-1; their own col 1; the replicated R/C strips)."""
    periodic = bcs.periodic_x
    my, mx = mesh.my, mesh.mx
    dx, dy = grid.dx, grid.dy
    dev = T.device
    rc_arr = torch.as_tensor(rhocp_over_dt, dtype=T.dtype,
                             device=dev).expand(T.shape)
    top_dir = bcs.top.kind == DIRICHLET
    bottom_dir = bcs.bottom.kind == DIRICHLET
    left_dir = (not periodic) and bcs.left.kind == DIRICHLET
    right_dir = (not periodic) and bcs.right.kind == DIRICHLET

    def split(f):
        return f[:-1, :-1], f[:-1, -1:], f[-1:, :-1], f[-1:, -1:]

    def local(TI, TR, TB, TC, kI, kR, kB, kC, cI, cR, cB, cC):
        iy = mesh.axis_index("y", device=dev)
        ix = mesh.axis_index("x", device=dev)
        first_y, last_y = iy == 0, iy == my - 1
        first_x, last_x = ix == 0, ix == mx - 1
        by, bx = TI.shape[-2:]

        def ext_corner(I, R, B, C):
            """(by+2, bx+2) frame + the y-extended right strip (by+2, 1):
            mirror ghosts beyond the domain (a ring wrap in x under
            periodic), true last-node values (R/B/C strips) at the
            seams."""
            t = mesh.from_prev(_last_row(I), "y")
            b = mesh.from_next(_first_row(I), "y")
            t = torch.where(first_y, I[..., 1:2, :], t)  # reflect ghost
            b = torch.where(last_y, B, b)  # true last row ny
            rows = _rows(t, I, b)
            tR = mesh.from_prev(_last_row(R), "y")
            bR = mesh.from_next(_first_row(R), "y")
            tR = torch.where(first_y, R[..., 1:2, :], tR)
            bR = torch.where(last_y, C, bR)
            R_ext = _rows(tR, R, bR)
            left = mesh.from_prev(_last_col(rows), "x", ring=periodic)
            right = mesh.from_next(_first_col(rows), "x", ring=periodic)
            if not periodic:
                left = torch.where(first_x, rows[..., 1:2], left)  # reflect
            right = torch.where(last_x, R_ext, right)  # true col nx
            return _cols(left, rows, right), R_ext

        T_ext, TR_ext = ext_corner(TI, TR, TB, TC)
        k_ext, kR_ext = ext_corner(kI, kR, kB, kC)

        kx = _favg(k_ext[..., :-1], k_ext[..., 1:], k_avg)
        fx = kx * (T_ext[..., 1:] - T_ext[..., :-1]) / dx
        ky = _favg(k_ext[..., :-1, :], k_ext[..., 1:, :], k_avg)
        fy = ky * (T_ext[..., 1:, :] - T_ext[..., :-1, :]) / dy
        div = (fx[..., 1:-1, 1:] - fx[..., 1:-1, :-1]) / dx + (
            fy[..., 1:, 1:-1] - fy[..., :-1, 1:-1]) / dy
        r_blk = cI * TI - div

        row = torch.arange(by, device=dev).view(by, 1)
        col = torch.arange(bx, device=dev).view(1, bx)
        seam = first_x & (col == 0)
        if periodic:
            # duplicated seam column 0: half the wrapped equation (the ring
            # halo already made r_blk's col 0 the whole wrapped one)
            r_blk = torch.where(seam, 0.5 * r_blk, r_blk)
        mask = torch.zeros((by, bx), dtype=torch.bool, device=dev)
        if left_dir:
            mask = mask | (first_x & (col == 0))
        if top_dir:
            mask = mask | (first_y & (row == 0))
        rI_out = torch.where(mask, kbnd * TI, r_blk)

        # right seam column (global col nx): a 3-column strip (west, self,
        # east), psum over x.  Walled: (nx-1, nx, mirror nx-1) on the
        # rightmost blocks; periodic: (nx-1, nx, wrap 1) on the leftmost
        # blocks (the west ring halo, the replicated R strip, their col 1)
        if periodic:
            Ts = _cols(T_ext[..., 0:1], TR_ext, T_ext[..., 2:3])
            ks = _cols(k_ext[..., 0:1], kR_ext, k_ext[..., 2:3])
        else:
            Ts = _cols(T_ext[..., -2:], T_ext[..., -2:-1])
            ks = _cols(k_ext[..., -2:], k_ext[..., -2:-1])
        fxs = _favg(ks[..., :-1], ks[..., 1:], k_avg) * (
            Ts[..., 1:] - Ts[..., :-1]) / dx
        fys = _favg(ks[..., :-1, 1:2], ks[..., 1:, 1:2], k_avg) * (
            Ts[..., 1:, 1:2] - Ts[..., :-1, 1:2]) / dy
        divR = (fxs[..., 1:-1, 1:2] - fxs[..., 1:-1, 0:1]) / dx + (
            fys[..., 1:, :] - fys[..., :-1, :]) / dy
        rR_blk = cR * TR - divR
        if periodic:
            rR_blk = 0.5 * rR_blk
        maskR = torch.zeros((by, 1), dtype=torch.bool, device=dev)
        if right_dir:
            maskR = torch.ones((by, 1), dtype=torch.bool, device=dev)
        if top_dir:
            maskR = maskR | (first_y & (row == 0))
        rR_out = torch.where(maskR, kbnd * TR, rR_blk)
        owner = first_x if periodic else last_x
        rR_out = mesh.psum(torch.where(owner, rR_out,
                                       torch.zeros_like(rR_out)), "x")

        # bottom seam row (global row ny)
        Tb = _rows(T_ext[..., -2:, :], T_ext[..., -2:-1, :])
        kb2 = _rows(k_ext[..., -2:, :], k_ext[..., -2:-1, :])
        fxb = _favg(kb2[..., :-1], kb2[..., 1:], k_avg) * (
            Tb[..., 1:] - Tb[..., :-1]) / dx
        fyb = _favg(kb2[..., :-1, :], kb2[..., 1:, :], k_avg) * (
            Tb[..., 1:, :] - Tb[..., :-1, :]) / dy
        divB = (fxb[..., 1:2, 1:] - fxb[..., 1:2, :-1]) / dx + (
            fyb[..., 1:2, 1:-1] - fyb[..., 0:1, 1:-1]) / dy
        rB_blk = cB * TB - divB
        if periodic:  # seam column 0 of the bottom row: half the equation
            rB_blk = torch.where(seam, 0.5 * rB_blk, rB_blk)
        maskB = torch.zeros((1, bx), dtype=torch.bool, device=dev)
        if left_dir:
            maskB = maskB | (first_x & (col == 0))
        if bottom_dir:
            maskB = maskB | torch.ones((1, bx), dtype=torch.bool, device=dev)
        rB_out = torch.where(maskB, kbnd * TB, rB_blk)
        rB_out = mesh.psum(torch.where(last_y, rB_out,
                                       torch.zeros_like(rB_out)), "y")

        # bottom-right corner node (ny, nx).  Walled: rows (ny-1, ny,
        # mirror) x cols (nx-1, nx, mirror) on the bottom-right block;
        # periodic: cols (nx-1, nx, wrap 1) on the bottom-left block (ring
        # halo + replicated strips), half-weighted
        if periodic:
            def strip3(ext, R_ext):
                return _cols(ext[..., -2:, 0:1], R_ext[..., -2:, :],
                             ext[..., -2:, 2:3])

            Tw = strip3(T_ext, TR_ext)
            kw = strip3(k_ext, kR_ext)
            Tc3 = _rows(Tw, Tw[..., 0:1, :])
            kc3 = _rows(kw, kw[..., 0:1, :])
        else:
            Tw = T_ext[..., -2:, -2:]
            kw = k_ext[..., -2:, -2:]
            Tc3 = _cols(Tw, Tw[..., 0:1])
            Tc3 = _rows(Tc3, Tc3[..., 0:1, :])
            kc3 = _cols(kw, kw[..., 0:1])
            kc3 = _rows(kc3, kc3[..., 0:1, :])
        fxc = _favg(kc3[..., :-1], kc3[..., 1:], k_avg) * (
            Tc3[..., 1:] - Tc3[..., :-1]) / dx
        fyc = _favg(kc3[..., :-1, :], kc3[..., 1:, :], k_avg) * (
            Tc3[..., 1:, :] - Tc3[..., :-1, :]) / dy
        divC = (fxc[..., 1:2, 1:2] - fxc[..., 1:2, 0:1]) / dx + (
            fyc[..., 1:2, 1:2] - fyc[..., 0:1, 1:2]) / dy
        rC_blk = cC * TC - divC
        if periodic:
            rC_blk = 0.5 * rC_blk
        if right_dir or bottom_dir:
            rC_blk = kbnd * TC
        here = last_y & owner
        rC_out = mesh.psum(torch.where(here, rC_blk,
                                       torch.zeros_like(rC_blk)), ("y", "x"))
        return rI_out, rR_out, rB_out, rC_out

    blk = P("y", "x")
    specs4 = (blk, P("y", None), P(None, "x"), P(None, None))
    rI, rR, rB, rC = mesh.shard_map(local, specs4 * 3, specs4)(
        *split(T), *split(k), *split(rc_arr))
    top = torch.cat([rI, rR], dim=1)
    bot = torch.cat([rB, rC], dim=1)
    return torch.cat([top, bot], dim=0)
