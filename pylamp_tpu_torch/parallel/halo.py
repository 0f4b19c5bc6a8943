"""Explicit halo exchange on the in-process mesh: the building blocks and a
manually sharded 5-point diffusion apply.

Port of ``pylamp_tpu/parallel/halo.py``: each shard owns a block,
exchanges one-deep halos with its 4 mesh neighbours (edges at the physical
boundary are zero-filled; callers overlay their own BC ghosts there) and
applies the stencil locally.  The diffusion apply is the mechanism's test
bed against the single-device operator.
"""
from __future__ import annotations

from pylamp_tpu_torch.parallel.mesh import P, Mesh


def exchange_halo_2d(block, mesh: Mesh):
    """Shard-batched (my, mx, by, bx) ``block`` padded by one ring of halo
    values from the 4 mesh neighbours: (my, mx, by+2, bx+2)."""
    return mesh.ext1(block)


def diffusion_apply_sharded(T, kx, ky, rc, dx, dy, mesh: Mesh):
    """rc*T - div(k grad T) on a cell-centred (ny, nx) layout with a
    zero-Dirichlet exterior; kx/ky are the left/top face coefficients of
    the same shape.  Split P("y", "x"), returns the global result."""

    def local(Tb, kxb, kyb):
        Tp = exchange_halo_2d(Tb, mesh)
        kxp = exchange_halo_2d(kxb, mesh)
        kyp = exchange_halo_2d(kyb, mesh)
        c = (..., slice(1, -1), slice(1, -1))
        flux_x_l = kxp[c] * (Tp[c] - Tp[..., 1:-1, :-2]) / dx
        flux_x_r = kxp[..., 1:-1, 2:] * (Tp[..., 1:-1, 2:] - Tp[c]) / dx
        flux_y_u = kyp[c] * (Tp[c] - Tp[..., :-2, 1:-1]) / dy
        flux_y_d = kyp[..., 2:, 1:-1] * (Tp[..., 2:, 1:-1] - Tp[c]) / dy
        div = (flux_x_r - flux_x_l) / dx + (flux_y_d - flux_y_u) / dy
        return rc * Tb - div

    spec = P("y", "x")
    return mesh.shard_map(local, (spec, spec, spec), spec)(T, kx, ky)
