"""Fused per-shard Chebyshev smoother under the explicit-halo engine.

Port of ``pylamp_tpu/parallel/halo_smoother.py`` on the in-process mesh:
the MG smoother of an explicit-halo level runs ``iters`` coupled
iterations per shard in ONE launch of the per-shard kernel
(ops/kernels/cheb_block.py) after ONE depth-h halo exchange per sweep
(h = iters, or iters + 1 when the sweep also emits its residual), instead
of one-deep exchanges per application.

Wall ghost layers are pre-filled here and re-derived inside the kernel
before every application under runtime wall flags.  The global Dirichlet
seam lines that the explicit-halo layout keeps outside the blocks (vx
column nx, vy row ny) evolve by the same pointwise kbnd recurrence in two
places that agree: inside the frames of the shards that carry them, and
globally here, to assemble the output strips.

Viscosity frames, wall flags, the coefficient table and kbnd are per-solve
constants: ``prep_halo_smoother`` builds them once per level per solve and
the per-sweep call exchanges only the four evolving fields.
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels import cheb
from pylamp_tpu_torch.ops.kernels.cheb_block import (
    BlockSmootherPrep,
    block_smoother_eligible,
    cheb_block,
)
from pylamp_tpu_torch.parallel.halo_ops import halo_eligible
from pylamp_tpu_torch.parallel.mesh import P, Mesh


def halo_smoother_eligible(grid: StaggeredGrid, mesh: Mesh, bcs: VelocityBCs,
                           dtype, iters: int,
                           emit_residual: bool = False) -> bool:
    """Per-level gate: even decomposition, non-periodic, a halo shallower
    than a block (deeper would need multi-hop exchanges), and the kernel's
    own gate."""
    if bcs.periodic_x or not halo_eligible(grid, mesh):
        return False
    by, bx = grid.ny // mesh.my, grid.nx // mesh.mx
    h = iters + (1 if emit_residual else 0)
    if h >= by or h >= bx:
        return False
    return block_smoother_eligible(by, bx, dtype, iters,
                                   emit_residual=emit_residual)


def _rep(a, n, dim):
    """``a`` repeated n times along ``dim`` (an empty slice for n = 0)."""
    return torch.cat([a] * n, dim=dim) if n > 0 else a.narrow(dim, 0, 0)


def _zeros(like, n, dim):
    shape = list(like.shape)
    shape[dim] = n
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def prep_halo_smoother(eta_s, eta_n, grid: StaggeredGrid, mesh: Mesh, h: int,
                       kbnd, lam_max) -> BlockSmootherPrep:
    """The per-shard viscosity frames (edge-replicated beyond the walls,
    true last-node strips at the seams), the wall flags, the Chebyshev
    table for depth h and kbnd, once per level per solve."""
    my, mx = mesh.my, mesh.mx
    by, bx = grid.ny // my, grid.nx // mx
    f32 = torch.float32
    dev = eta_n.device

    def local(esI, esR, esB, esC, en):
        iy = mesh.axis_index("y", device=dev)
        ix = mesh.axis_index("x", device=dev)
        first_y, last_y = iy == 0, iy == my - 1
        first_x, last_x = ix == 0, ix == mx - 1

        # es frame (R+1, C+1)
        t = mesh.from_prev(esI[..., -h:, :], "y")
        t = torch.where(first_y, _rep(esI[..., :1, :], h, -2), t)
        b = mesh.from_next(esI[..., :h + 1, :], "y")
        b = torch.where(last_y, torch.cat([esB, _rep(esB, h, -2)], dim=-2), b)
        rows_s = torch.cat([t, esI, b], dim=-2)  # (R+1, bx)
        tR = mesh.from_prev(esR[..., -h:, :], "y")
        tR = torch.where(first_y, _rep(esR[..., :1, :], h, -2), tR)
        bR = mesh.from_next(esR[..., :h + 1, :], "y")
        bR = torch.where(last_y, torch.cat([esC, _rep(esC, h, -2)], dim=-2),
                         bR)
        esR_ext = torch.cat([tR, esR, bR], dim=-2)  # (R+1, 1)
        left = mesh.from_prev(rows_s[..., -h:], "x")
        left = torch.where(first_x, _rep(rows_s[..., :1], h, -1), left)
        right = mesh.from_next(rows_s[..., :h + 1], "x")
        wall_r = torch.cat([esR_ext, _rep(esR_ext, h, -1)], dim=-1)
        right = torch.where(last_x, wall_r, right)
        es_v = torch.cat([left, rows_s, right], dim=-1)  # (R+1, C+1)

        # en frame (R, C): edge-replicated ring
        t = mesh.from_prev(en[..., -h:, :], "y")
        t = torch.where(first_y, _rep(en[..., :1, :], h, -2), t)
        b = mesh.from_next(en[..., :h, :], "y")
        b = torch.where(last_y, _rep(en[..., -1:, :], h, -2), b)
        rows_n = torch.cat([t, en, b], dim=-2)
        left = mesh.from_prev(rows_n[..., -h:], "x")
        left = torch.where(first_x, _rep(rows_n[..., :1], h, -1), left)
        right = mesh.from_next(rows_n[..., :h], "x")
        right = torch.where(last_x, _rep(rows_n[..., -1:], h, -1), right)
        en_v = torch.cat([left, rows_n, right], dim=-1)
        return mesh.flat(es_v), mesh.flat(en_v)

    blk = P("y", "x")
    es_v, en_v = local(*(mesh.split(a.to(f32), s) for a, s in zip(
        (eta_s[:-1, :-1], eta_s[:-1, -1:], eta_s[-1:, :-1], eta_s[-1:, -1:],
         eta_n),
        (blk, P("y", None), P(None, "x"), P(None, None), blk))))
    return BlockSmootherPrep(
        es_v=es_v, en_v=en_v, flags=mesh.wall_flags(device=dev),
        coeffs=cheb.chebyshev_coeffs(lam_max, h).to(dev),
        kb=torch.as_tensor(kbnd, device=dev).to(f32).reshape(1),
        h=h, by=by, bx=bx)


def smoother_frames(ex, ey, rx, ry, bcs: VelocityBCs, mesh: Mesh, h: int):
    """The per-shard depth-h frames of the four evolving fields, flat
    (S, ...) f32: (ex_v, ey_v, rx_v, ry_v).  Velocity frames carry the wall
    ghost layer; residual frames are zero beyond the walls."""
    my, mx = mesh.my, mesh.mx
    dev = rx.device

    def local(exI, exR, rxI, rxR, eyI, eyB, ryI, ryB):
        iy = mesh.axis_index("y", device=dev)
        ix = mesh.axis_index("x", device=dev)
        first_y, last_y = iy == 0, iy == my - 1
        first_x, last_x = ix == 0, ix == mx - 1

        def ext_vx(I, Rcol, wall_fill: bool):
            """(R, C+1) vx-lattice frame: ``wall_fill`` derives the wall
            ghost layer (velocity); without it the fill stays zero
            (residuals)."""
            def ext_rows(A):
                t = mesh.from_prev(A[..., -h:, :], "y")
                b = mesh.from_next(A[..., :h, :], "y")
                if wall_fill:
                    wt = torch.cat([_zeros(A, h - 1, -2),
                                    bcs.s_top * A[..., :1, :]], dim=-2)
                    wb = torch.cat([bcs.s_bottom * A[..., -1:, :],
                                    _zeros(A, h - 1, -2)], dim=-2)
                else:
                    wt = wb = _zeros(A, h, -2)
                t = torch.where(first_y, wt, t)
                b = torch.where(last_y, wb, b)
                return torch.cat([t, mesh._full(A), b], dim=-2)

            rows = ext_rows(I)  # (R, bx)
            R_ext = ext_rows(Rcol)  # (R, 1)
            left = mesh.from_prev(rows[..., -h:], "x")
            left = torch.where(first_x, _zeros(rows, h, -1), left)
            right = mesh.from_next(rows[..., :h + 1], "x")
            wall_r = torch.cat([R_ext, _zeros(R_ext, h, -1)], dim=-1)
            right = torch.where(last_x, wall_r, right)
            return torch.cat([left, rows, right], dim=-1)  # (R, C+1)

        def ext_vy(I, Brow, wall_fill: bool):
            """(R+1, C) vy-lattice frame."""
            t = mesh.from_prev(I[..., -h:, :], "y")
            t = torch.where(first_y, _zeros(I, h, -2), t)
            b = mesh.from_next(I[..., :h + 1, :], "y")
            wall_b = torch.cat([Brow, _zeros(Brow, h, -2)], dim=-2)
            b = torch.where(last_y, wall_b, b)
            rows = torch.cat([t, mesh._full(I), b], dim=-2)  # (R+1, bx)
            left = mesh.from_prev(rows[..., -h:], "x")
            right = mesh.from_next(rows[..., :h], "x")
            if wall_fill:
                wl = torch.cat([_zeros(rows, h - 1, -1),
                                bcs.s_left * rows[..., :1]], dim=-1)
                wr = torch.cat([bcs.s_right * rows[..., -1:],
                                _zeros(rows, h - 1, -1)], dim=-1)
            else:
                wl = wr = _zeros(rows, h, -1)
            left = torch.where(first_x, wl, left)
            right = torch.where(last_x, wr, right)
            return torch.cat([left, rows, right], dim=-1)  # (R+1, C)

        return tuple(mesh.flat(f) for f in (
            ext_vx(exI, exR, True), ext_vy(eyI, eyB, True),
            ext_vx(rxI, rxR, False), ext_vy(ryI, ryB, False)))

    blk = P("y", "x")
    f32 = torch.float32
    ex, ey, rx, ry = (a.to(f32) for a in (ex, ey, rx, ry))
    return local(*(mesh.split(a, s) for a, s in zip(
        (ex[:, :-1], ex[:, -1:], rx[:, :-1], rx[:, -1:],
         ey[:-1, :], ey[-1:, :], ry[:-1, :], ry[-1:, :]),
        (blk, P("y", None), blk, P("y", None),
         blk, P(None, "x"), blk, P(None, "x")))))


def chebyshev_smooth_halo(ex, ey, rx, ry, grid: StaggeredGrid,
                          bcs: VelocityBCs, kbnd, lam_max, iters: int,
                          mesh: Mesh, prepped: BlockSmootherPrep,
                          zero_init: bool = False,
                          emit_residual: bool = False):
    """Fused per-shard ``iters``-iteration Chebyshev sweep; drop-in for the
    MG smoother.  Returns (ex', ey') or (ex', ey', rx - A ex', ry - A ey')
    in f32.  ``kbnd`` and ``lam_max`` are those ``prepped`` froze."""
    f32 = torch.float32
    ex, ey, rx, ry = (a.to(f32) for a in (ex, ey, rx, ry))
    prep = prepped
    # frames deeper than the sweep needs are fine (staleness reaches only
    # ``iters`` rings); shallower would contaminate the interior
    if iters + (1 if emit_residual else 0) > prep.h:
        raise ValueError(f"sweep of {iters} (+emit) on frames of depth "
                         f"{prep.h}")
    frames = smoother_frames(ex, ey, rx, ry, bcs, mesh, prep.h)
    outs = [mesh.gather(mesh.unflat(o), P("y", "x")) for o in cheb_block(
        *frames, prep, grid, bcs, iters, zero_init, emit_residual)]

    # seam strips: the pointwise kbnd recurrence (identical to the in-frame
    # Dirichlet evolution, see the module docstring)
    kb = prep.kb[0]
    coeffs = prep.coeffs

    def seam_rec(s, r):
        d = torch.zeros_like(s)
        for k in range(iters):
            c1, c2 = coeffs[k, 0], coeffs[k, 1]
            if zero_init and k == 0:
                d = c2 * r / kb
            else:
                d = c1 * d + c2 * (r - kb * s) / kb
            s = s + d
        return s

    sx = seam_rec(torch.zeros_like(ex[:, -1:]) if zero_init else ex[:, -1:],
                  rx[:, -1:])
    sy = seam_rec(torch.zeros_like(ey[-1:, :]) if zero_init else ey[-1:, :],
                  ry[-1:, :])
    ex_new = torch.cat([outs[0], sx], dim=1)
    ey_new = torch.cat([outs[1], sy], dim=0)
    if not emit_residual:
        return ex_new, ey_new
    rfx = torch.cat([outs[2], rx[:, -1:] - kb * sx], dim=1)
    rfy = torch.cat([outs[3], ry[-1:, :] - kb * sy], dim=0)
    return ex_new, ey_new, rfx, rfy
