"""Explicit-halo Stokes and energy operators on the mesh (either
transport).

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

Both operators take and return sharded fields (``parallel/blocks.py
Blocks``: the interior block and the seam strips above), and run their
bodies on them as they are (``mesh.local_map``); global tensors (the
in-process mesh's global layout) are split on the way in and gathered on
the way out.

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
from pylamp_tpu_torch.parallel.blocks import Blocks
from pylamp_tpu_torch.parallel.mesh import Mesh


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
    ``use_pallas``: the per-shard saddle kernel on eligible blocks.
    Sharded fields in, sharded fields out; global tensors in, global
    out."""
    if not isinstance(vx, Blocks):
        locs = ("vx", "vy", "center", "corner", "center")
        out = stokes_operator_halo(
            *(None if a is None else Blocks.split(a, loc, mesh)
              for a, loc in zip((vx, vy, p, eta_s, eta_n), locs)),
            grid, bcs, mesh, kcont=kcont, kbnd=kbnd, use_pallas=use_pallas)
        return tuple(None if r is None else r.gather() for r in out)
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
        first_y = iy == 0
        first_x, last_x = ix == 0, ix == mx - 1

        # vx extended (by+2, bx+2): BC ghost rows at the walls, the true
        # last column (vxR) at the right seam; the leftmost block's left
        # halo is unused (col 0 is a Dirichlet row) and stays zero.
        # Periodic sides: the x exchanges are a ring over the torus seam --
        # the rightmost block's right halo is the leftmost's col 0 (the
        # duplicated seam node), the leftmost's left halo the rightmost's
        # last interior column (global nx-1), the wrap the global
        # operator's ghosts read.
        # vy extended: BC ghost columns at the side walls (wrap halos under
        # periodic), the true last row (vyB) at the bottom seam.
        # eta_s extended (by+1, bx+1): corner lattice, +1 row/col from the
        # next block (or the seam strips at the domain edge).
        # Cell-centred ring halos (the fill beyond the domain is read only
        # by boundary rows that are overwritten below).
        # Every halo travels in one exchange round (mesh.halos).
        cells = (en, pc) if with_p else (en,)
        fields = [(vxI, 1, 1, 1, 1, bcs.s_top * _first_row(vxI),
                   bcs.s_bottom * _last_row(vxI), periodic),
                  (vyI, 1, 1, 1, 1, None, vyB, periodic),
                  *((c, 1, 1, 1, 1, None, None, periodic) for c in cells),
                  (esI, 0, 1, 0, 1, None, esB, False),
                  (esR, 0, 1, 0, 0, None, esC, False)]
        if not periodic:
            fields.append((vxR, 1, 1, 0, 0, bcs.s_top * _first_row(vxR),
                           bcs.s_bottom * _last_row(vxR), False))
        got = iter(mesh.halos(*fields))
        vx_rows, left, right = next(got)
        vy_rows, vy_left, vy_right = next(got)
        cell_ext = [_cols(left_c, rw, right_c)
                    for rw, left_c, right_c in (next(got) for _ in cells)]
        es_rows, _, es_right = next(got)
        esR_rows = next(got)[0]
        if not periodic:
            right = torch.where(last_x, next(got)[0], right)
            vy_left = torch.where(first_x, bcs.s_left * _first_col(vy_rows),
                                  vy_left)
            vy_right = torch.where(last_x, bcs.s_right * _last_col(vy_rows),
                                   vy_right)
        vx_ext = _cols(left, vx_rows, right)
        vy_ext = _cols(vy_left, vy_rows, vy_right)
        en_ext = cell_ext[0]
        p_ext = cell_ext[1] if with_p else None
        es_ext = _cols(es_rows, torch.where(last_x, esR_rows, es_right))

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

    rxI, ryI, rc, rseam = mesh.local_map(local)(
        vx.I, vx.R, vy.I, vy.B, eta_s.I, eta_s.R, eta_s.B, eta_s.C, eta_n.I,
        p.I if with_p else None)
    # seam outputs: the Dirichlet rows, or the wrapped half-equation
    # (periodic, psum-reduced in the body)
    rx = Blocks(mesh, "vx", rxI, rseam if periodic else kbnd * vx.R)
    ry = Blocks(mesh, "vy", ryI, B=kbnd * vy.B)
    return rx, ry, (Blocks(mesh, "center", rc) if with_p else None)


# -- Energy -------------------------------------------------------------------


def _favg(a, b, mode: str):
    if mode == "arithmetic":
        return 0.5 * (a + b)
    if mode == "harmonic":
        return 2.0 * a * b / (a + b)
    raise ValueError(f"unknown k averaging mode {mode!r}")


def corner_frames(mesh: Mesh, fields, periodic: bool):
    """Per corner-lattice field (I, R, B, C pieces): the (by+2, bx+2) frame
    of its block and the y-extended right strip (by+2, 1): mirror ghosts
    beyond the domain (a ring wrap in x under periodic), true last-node
    values (R/B/C strips) at the seams.  Every halo in one exchange
    round."""
    I0 = fields[0][0]
    ix = mesh.axis_index("x", device=I0.device)
    first_x, last_x = ix == 0, ix == mesh.mx - 1
    got = iter(mesh.halos(*(
        f for I, R, B, C in fields
        for f in ((I, 1, 1, 1, 1, I[..., 1:2, :], B, periodic),
                  (R, 1, 1, 0, 0, R[..., 1:2, :], C, False)))))
    out = []
    for _ in fields:
        rw, left, right = next(got)
        R_ext = next(got)[0]
        if not periodic:
            left = torch.where(first_x, rw[..., 1:2], left)  # reflect
        right = torch.where(last_x, R_ext, right)  # true col nx
        out.append((_cols(left, rw, right), R_ext))
    return out


def energy_operator_halo(T, k, rhocp_over_dt, grid: StaggeredGrid,
                         bcs: ThermalBCs, mesh: Mesh, kbnd=1.0,
                         k_avg: str = "arithmetic"):
    """Explicit-halo application of the energy operator; the same mirror
    ghosts, Dirichlet identity rows and face-averaged conductivity as
    ops.energy.energy_operator.  Periodic side walls: a ring exchange over
    the torus seam; the duplicated seam columns (0 and nx) each carry half
    the wrapped equation, with the col-nx equation computed on the
    leftmost blocks, which hold every value its stencil reads (the west
    ring halo, col nx-1; their own col 1; the replicated R/C strips).
    Sharded fields in, a sharded field out (``rhocp_over_dt`` a field or
    a scalar); global tensors in, global out."""
    if not isinstance(T, Blocks):
        rc = torch.as_tensor(rhocp_over_dt, dtype=T.dtype,
                             device=T.device).expand(T.shape)
        return energy_operator_halo(
            *(Blocks.split(a, "corner", mesh) for a in (T, k, rc)), grid,
            bcs, mesh, kbnd=kbnd, k_avg=k_avg).gather()
    if not isinstance(rhocp_over_dt, Blocks):
        rhocp_over_dt = T.map(lambda q: torch.as_tensor(
            rhocp_over_dt, dtype=q.dtype, device=q.device).expand(q.shape))
    periodic = bcs.periodic_x
    my, mx = mesh.my, mesh.mx
    dx, dy = grid.dx, grid.dy
    dev = T.device
    top_dir = bcs.top.kind == DIRICHLET
    bottom_dir = bcs.bottom.kind == DIRICHLET
    left_dir = (not periodic) and bcs.left.kind == DIRICHLET
    right_dir = (not periodic) and bcs.right.kind == DIRICHLET

    def local(TI, TR, TB, TC, kI, kR, kB, kC, cI, cR, cB, cC):
        iy = mesh.axis_index("y", device=dev)
        ix = mesh.axis_index("x", device=dev)
        first_y, last_y = iy == 0, iy == my - 1
        first_x, last_x = ix == 0, ix == mx - 1
        by, bx = TI.shape[-2:]

        (T_ext, TR_ext), (k_ext, kR_ext) = corner_frames(
            mesh, ((TI, TR, TB, TC), (kI, kR, kB, kC)), periodic)

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
        # the seam strips, each summed from its owners (one collective)
        rR_out, rB_out, rC_out = mesh.psum_many(
            (torch.where(owner, rR_out, torch.zeros_like(rR_out)), "x"),
            (torch.where(last_y, rB_out, torch.zeros_like(rB_out)), "y"),
            (torch.where(here, rC_blk, torch.zeros_like(rC_blk)), ("y", "x")))
        return rI_out, rR_out, rB_out, rC_out

    return Blocks(mesh, "corner", *mesh.local_map(local)(
        *(getattr(f, n) for f in (T, k, rhocp_over_dt)
          for n in ("I", "R", "B", "C"))))
