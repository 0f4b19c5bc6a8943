"""Fused per-shard Chebyshev smoother under the explicit-halo engine.

Port of ``pylamp_tpu/parallel/halo_smoother.py`` on the mesh:
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

The smoother takes and returns sharded fields (``parallel/blocks.py
Blocks``: the blocks the kernel writes and the seam strips the
recurrence evolves) or global tensors, which it splits and gathers.

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
from pylamp_tpu_torch.parallel.blocks import Blocks
from pylamp_tpu_torch.parallel.halo_ops import halo_eligible
from pylamp_tpu_torch.parallel.mesh import Mesh


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
    table for depth h and kbnd, once per level per solve.  The viscosities
    are sharded fields or global tensors."""
    my, mx = mesh.my, mesh.mx
    by, bx = grid.ny // my, grid.nx // mx
    f32 = torch.float32
    dev = eta_n.device

    def local(esI, esR, esB, esC, en):
        ix = mesh.axis_index("x", device=dev)
        first_x, last_x = ix == 0, ix == mx - 1

        # es frame (R+1, C+1) and en frame (R, C, edge-replicated ring):
        # every halo in one exchange round
        got = iter(mesh.halos(
            (esI, h, h + 1, h, h + 1, _rep(esI[..., :1, :], h, -2),
             torch.cat([esB, _rep(esB, h, -2)], dim=-2), False),
            (esR, h, h + 1, 0, 0, _rep(esR[..., :1, :], h, -2),
             torch.cat([esC, _rep(esC, h, -2)], dim=-2), False),
            (en, h, h, h, h, _rep(en[..., :1, :], h, -2),
             _rep(en[..., -1:, :], h, -2), False)))
        rows_s, left, right = next(got)  # rows_s (R+1, bx)
        esR_ext = next(got)[0]  # (R+1, 1)
        left = torch.where(first_x, _rep(rows_s[..., :1], h, -1), left)
        wall_r = torch.cat([esR_ext, _rep(esR_ext, h, -1)], dim=-1)
        right = torch.where(last_x, wall_r, right)
        es_v = torch.cat([left, rows_s, right], dim=-1)  # (R+1, C+1)
        rows_n, left, right = next(got)
        left = torch.where(first_x, _rep(rows_n[..., :1], h, -1), left)
        right = torch.where(last_x, _rep(rows_n[..., -1:], h, -1), right)
        en_v = torch.cat([left, rows_n, right], dim=-1)
        return mesh.flat(es_v), mesh.flat(en_v)

    if not isinstance(eta_s, Blocks):
        eta_s = Blocks.split(eta_s, "corner", mesh)
        eta_n = Blocks.split(eta_n, "center", mesh)
    es, en = eta_s.to(f32), eta_n.to(f32)
    es_v, en_v = mesh.local_map(local)(es.I, es.R, es.B, es.C, en.I)
    return BlockSmootherPrep(
        es_v=es_v, en_v=en_v, flags=mesh.wall_flags(device=dev),
        coeffs=cheb.chebyshev_coeffs(lam_max, h).to(dev),
        kb=torch.as_tensor(kbnd, device=dev).to(f32).reshape(1),
        h=h, by=by, bx=bx, mesh_shards=mesh.size)


def smoother_frames(ex, ey, rx, ry, bcs: VelocityBCs, mesh: Mesh, h: int):
    """The per-shard depth-h frames of the four evolving fields (sharded,
    or global tensors, split here), flat (S, ...) f32: (ex_v, ey_v, rx_v,
    ry_v).  Velocity frames carry the wall ghost layer; residual frames
    are zero beyond the walls."""
    mx = mesh.mx
    dev = rx.device

    def local(exI, exR, rxI, rxR, eyI, eyB, ryI, ryB):
        ix = mesh.axis_index("x", device=dev)
        first_x, last_x = ix == 0, ix == mx - 1

        # the four fields' halos (and the vx-lattice seam columns' rows) in
        # one exchange round
        def wall_rows(A, top: bool):
            """The vx lattice's wall ghost layer above / below A."""
            z = _zeros(A, h - 1, -2)
            if top:
                return torch.cat([z, bcs.s_top * A[..., :1, :]], dim=-2)
            return torch.cat([bcs.s_bottom * A[..., -1:, :], z], dim=-2)

        fields = []
        for I, Rcol, fill in ((exI, exR, True), (rxI, rxR, False)):
            # velocity: the wall ghost layer; residuals: zeros
            for A, wide in ((I, True), (Rcol, False)):
                fields.append((A, h, h, h if wide else 0,
                               h + 1 if wide else 0,
                               wall_rows(A, True) if fill else None,
                               wall_rows(A, False) if fill else None, False))
        for I, Brow in ((eyI, eyB), (ryI, ryB)):
            fields.append((I, h, h + 1, h, h, None,
                           torch.cat([Brow, _zeros(Brow, h, -2)], dim=-2),
                           False))
        got = iter(mesh.halos(*fields))

        def ext_vx(rows, left, right, R_ext):
            """(R, C+1) vx-lattice frame."""
            left = torch.where(first_x, _zeros(rows, h, -1), left)
            wall_r = torch.cat([R_ext, _zeros(R_ext, h, -1)], dim=-1)
            right = torch.where(last_x, wall_r, right)
            return torch.cat([left, rows, right], dim=-1)

        def ext_vy(rows, left, right, wall_fill: bool):
            """(R+1, C) vy-lattice frame."""
            if wall_fill:
                wl = torch.cat([_zeros(rows, h - 1, -1),
                                bcs.s_left * rows[..., :1]], dim=-1)
                wr = torch.cat([bcs.s_right * rows[..., -1:],
                                _zeros(rows, h - 1, -1)], dim=-1)
            else:
                wl = wr = _zeros(rows, h, -1)
            left = torch.where(first_x, wl, left)
            right = torch.where(last_x, wr, right)
            return torch.cat([left, rows, right], dim=-1)

        ex_v = ext_vx(*next(got), next(got)[0])
        rx_v = ext_vx(*next(got), next(got)[0])
        ey_v = ext_vy(*next(got), True)
        ry_v = ext_vy(*next(got), False)
        return tuple(mesh.flat(f) for f in (ex_v, ey_v, rx_v, ry_v))

    if not isinstance(ex, Blocks):
        ex, rx = (Blocks.split(a, "vx", mesh) for a in (ex, rx))
        ey, ry = (Blocks.split(a, "vy", mesh) for a in (ey, ry))
    ex, ey, rx, ry = (a.to(torch.float32) for a in (ex, ey, rx, ry))
    return mesh.local_map(local)(ex.I, ex.R, rx.I, rx.R, ey.I, ey.B, ry.I,
                                 ry.B)


def chebyshev_smooth_halo(ex, ey, rx, ry, grid: StaggeredGrid,
                          bcs: VelocityBCs, kbnd, lam_max, iters: int,
                          mesh: Mesh, prepped: BlockSmootherPrep,
                          zero_init: bool = False,
                          emit_residual: bool = False):
    """Fused per-shard ``iters``-iteration Chebyshev sweep; drop-in for the
    MG smoother.  Returns (ex', ey') or (ex', ey', rx - A ex', ry - A ey')
    in f32, sharded fields or global tensors as the inputs.  ``kbnd`` and
    ``lam_max`` are those ``prepped`` froze."""
    if not isinstance(ex, Blocks):
        out = chebyshev_smooth_halo(
            *(Blocks.split(a, loc, mesh) for a, loc in zip(
                (ex, ey, rx, ry), ("vx", "vy", "vx", "vy"))), grid, bcs,
            kbnd, lam_max, iters, mesh, prepped, zero_init, emit_residual)
        return tuple(o.gather() for o in out)
    f32 = torch.float32
    ex, ey, rx, ry = (a.to(f32) for a in (ex, ey, rx, ry))
    prep = prepped
    # frames deeper than the sweep needs are fine (staleness reaches only
    # ``iters`` rings); shallower would contaminate the interior
    if iters + (1 if emit_residual else 0) > prep.h:
        raise ValueError(f"sweep of {iters} (+emit) on frames of depth "
                         f"{prep.h}")
    frames = smoother_frames(ex, ey, rx, ry, bcs, mesh, prep.h)
    outs = [mesh.unflat(o) for o in cheb_block(
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

    sx = seam_rec(torch.zeros_like(ex.R) if zero_init else ex.R, rx.R)
    sy = seam_rec(torch.zeros_like(ey.B) if zero_init else ey.B, ry.B)
    ex_new = Blocks(mesh, "vx", outs[0], sx)
    ey_new = Blocks(mesh, "vy", outs[1], B=sy)
    if not emit_residual:
        return ex_new, ey_new
    rfx = Blocks(mesh, "vx", outs[2], rx.R - kb * sx)
    rfy = Blocks(mesh, "vy", outs[3], B=ry.B - kb * sy)
    return ex_new, ey_new, rfx, rfy
