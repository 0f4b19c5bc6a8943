"""Geometric multigrid preconditioner for the energy (heat) equation.

Port of ``pylamp_tpu/solvers/energy_mg.py``: vertex-centered GMG on the
corner lattice.  Coarse nodes coincide with even fine nodes; bilinear
prolongation, full-weighting restriction (P^T/4), rediscretized coarse
operators with node-sampled coefficients, and Chebyshev-Jacobi smoothing
with power-iteration bounds or, for the anisotropic cells of stretched
grids, omega-damped line relaxation ("line": alternating y and x lines,
"line_y", "line_x"), whose tridiagonal coefficients are probed from the
level operator itself (``lines.stencil_line_coeffs``) and reduced once per
level (``lines.pcr_factor``).  Periodic side walls fold and re-emit the
seam columns in the restriction, and allow y lines only.

On the sharded layout (coefficients that are ``parallel/blocks.py
Blocks``) every level whose blocks the explicit-halo operator takes
(``halo_eligible``) stays sharded: its coefficients are sampled in block
form, its diagonal, masks and power bound are block forms with mesh
dots, and its transfers run in block form (parallel/block_ops.py: a
halo round each, and one reduction for the restriction's seam strips).  The coarser levels run on the global tensors on every
shard, as the reference runs them on GSPMD's global arrays: the last
sharded level's coefficients gathered once a hierarchy, its residual once
a V-cycle (a "coarse" collective), and the correction split on the way up
(no message).  Chebyshev smoothing and full coarsening only, on walled or
periodic sides (the periodic restriction folds the seam columns in block
form too).
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from pylamp_tpu_torch.core.bc import ThermalBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.energy import _dirichlet_masks, energy_operator
from pylamp_tpu_torch.parallel import block_ops
from pylamp_tpu_torch.parallel.blocks import Blocks, gather_all
from pylamp_tpu_torch.parallel.halo_ops import halo_eligible
from pylamp_tpu_torch.solvers.krylov import tdot
from pylamp_tpu_torch.solvers.lines import (
    line_axes,
    pcr_factor,
    pcr_solve,
    stencil_line_coeffs,
)
from pylamp_tpu_torch.solvers.mg import coarsening_plan


def _interleave_rows(a, b):
    """rows [a0, b0, a1, b1, ..., a_{n-1}]; a: (n, m), b: (n-1, m)."""
    n, m = a.shape
    out = torch.zeros((2 * n - 1, m), dtype=a.dtype, device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def prolong_corner(c, cx: bool = True, cy: bool = True):
    """Bilinear prolongation on the corner lattice: coarse (NY+1, NX+1) ->
    fine (2NY+1, 2NX+1), coincident at even fine nodes.  ``cx``/``cy``
    select the coarsened axes."""
    e = _interleave_rows(c, 0.5 * (c[:-1, :] + c[1:, :])) if cy else c
    if cx:
        e = _interleave_rows(e.T, (0.5 * (e[:, :-1] + e[:, 1:])).T).T
    return e


def restrict_corner(f, periodic_x: bool = False, cx: bool = True,
                    cy: bool = True):
    """Full weighting (P^T/4; P^T/2 along a single semi-coarsened axis):
    fine (2NY+1, 2NX+1) -> coarse (NY+1, NX+1), the truncated stencil on
    the boundary rows.  ``periodic_x``: the fine seam columns (one physical
    node) each carry half the residual; fold them, restrict with x
    wrap-around, and re-emit equal coarse halves."""
    if periodic_x and cx:
        fu = f[:, :-1].clone()
        fu[:, 0] += f[:, -1]  # unique columns, the physical seam
        fz = torch.cat([fu[:, -1:], fu], dim=1)  # left wrap ghost
        g = (0.5 * fz[:, 0:-2:2] + fz[:, 1:-1:2] + 0.5 * fz[:, 2::2]) / 2.0
    elif cx:
        fp = F.pad(f, (1, 1))
        g = (0.5 * fp[:, 0:-2:2] + fp[:, 1:-1:2] + 0.5 * fp[:, 2::2]) / 2.0
    else:
        g = f
    if cy:
        gp = F.pad(g, (0, 0, 1, 1))
        c = (0.5 * gp[0:-2:2, :] + gp[1:-1:2, :] + 0.5 * gp[2::2, :]) / 2.0
    else:
        c = g
    if periodic_x and cx:
        seam = 0.5 * c[:, :1]
        c = torch.cat([seam, c[:, 1:], seam], dim=1)
    return c


def _power_lambda_max(apply_binv_a, like, iters: int = 12):
    """|lambda_max| of D^-1 A by power iteration from the reference's
    deterministic start vector (on the lattice and in the dtype of
    ``like``, a tensor or a sharded field), on the device without a host
    read."""
    dtype, device = like.dtype, like.device
    if isinstance(like, Blocks):
        idx = block_ops.flat_index(like).to(dtype)
    else:
        idx = torch.arange(like.numel(), dtype=dtype,
                           device=device).reshape(like.shape)
    v = torch.remainder(idx * 0.754877666 + 0.1, 1.0) - 0.5
    lam = torch.ones((), dtype=dtype, device=device)
    for _ in range(iters):
        v = v / torch.sqrt(tdot(v, v))
        w = apply_binv_a(v)
        lam = tdot(v, w)
        v = w
    return torch.abs(lam)


def make_energy_mg_preconditioner(k, rhocp_over_dt, grid: StaggeredGrid,
                                  bcs: ThermalBCs, kbnd,
                                  k_avg: str = "arithmetic", levels: int = 0,
                                  pre_smooth: int = 2, post_smooth: int = 2,
                                  coarse_iters: int = 16, halo_mesh=None,
                                  smoother: str = "chebyshev",
                                  omega: float = 0.7,
                                  semicoarsen: float = 0.0):
    """M(r) -> z: one V-cycle on the energy operator from a zero initial
    guess (an approximately SPD preconditioner for flexible CG).
    ``halo_mesh`` routes every level's operator apply through the
    explicit-halo operator (``ops.energy.energy_operator`` checks each
    level's eligibility).  ``omega`` is the line smoothers' damping."""
    from pylamp_tpu_torch.solvers.energy_solver import energy_diagonal

    if smoother not in ("chebyshev", "line", "line_y", "line_x"):
        raise ValueError(f"unknown energy MG smoother {smoother!r}")
    if smoother != "chebyshev" and bcs.periodic_x \
            and 1 in line_axes(smoother):
        raise ValueError("x-line smoothing requires non-periodic side walls "
                         "(use smoother='line_y')")
    plan = coarsening_plan(grid, levels, semi_threshold=semicoarsen)
    nlev = len(plan) + 1
    dtype, device = k.dtype, k.device
    mesh = k.mesh if isinstance(k, Blocks) else None
    if mesh is not None and (smoother != "chebyshev"
                             or any(step != (True, True) for step in plan)):
        raise ValueError("the sharded energy multigrid takes Chebyshev "
                         "smoothing and full coarsening (ROADMAP item 19c)")

    grids = [grid]
    coeffs = [(k, rhocp_over_dt)]
    for cx, cy in plan:
        grids.append(grids[-1].coarsen(cx, cy))
        kl, rl = coeffs[-1]
        if isinstance(kl, Blocks):
            if halo_eligible(grids[-1], mesh):
                coeffs.append((block_ops.sample_corner(kl),
                               block_ops.sample_corner(rl)))
                continue
            # the first replicated level: the last sharded one, gathered
            kl, rl = gather_all([kl, rl], kind="coarse")
        # corner nodes coincide: sample coefficients at the surviving nodes
        sy = slice(None, None, 2) if cy else slice(None)
        sx = slice(None, None, 2) if cx else slice(None)
        coeffs.append((kl[sy, sx], rl[sy, sx]))
    # kbnd scales with 1/(dx*dy) like the stencil
    kbnds = [kbnd * (grids[0].dx_min * grids[0].dy_min)
             / (g.dx_min * g.dy_min) for g in grids]
    diags = [energy_diagonal(kl, rl, g, bcs, kb, k_avg)
             for (kl, rl), g, kb in zip(coeffs, grids, kbnds)]
    masks = [block_ops.dirichlet_masks(kl, bcs)[0] if isinstance(kl, Blocks)
             else _dirichlet_masks(g, bcs, dtype, device)[0]
             for (kl, _), g in zip(coeffs, grids)]

    def apply_l(l, T):
        kl, rl = coeffs[l]
        return energy_operator(T, kl, rl, grids[l], bcs, kbnd=kbnds[l],
                               k_avg=k_avg, halo_mesh=halo_mesh)

    if smoother == "chebyshev":
        lam = [1.1 * _power_lambda_max(
            lambda v, l=l: apply_l(l, v) / diags[l], coeffs[l][0])
            for l in range(nlev)]
    else:
        # each level's line systems along each sweep axis, reduced once
        lines = []
        for l in range(nlev):
            per_axis = {}
            for ax in line_axes(smoother):
                sub, sup = stencil_line_coeffs(
                    partial(apply_l, l), grids[l].shape_corner, ax, dtype,
                    device)
                per_axis[ax] = pcr_factor(sub, diags[l], sup, ax)
            lines.append(per_axis)

    def smooth(l, x, b, iters):
        if smoother != "chebyshev":
            for _ in range(iters):
                for f in lines[l].values():
                    x = x + omega * pcr_solve(f, b - apply_l(l, x))
            return x
        d = diags[l]
        lmax = lam[l]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        s1 = theta / delta
        dx_ = (b - apply_l(l, x)) / d / theta
        x = x + dx_
        ro = 1.0 / s1
        for _ in range(iters - 1):
            rho = 1.0 / (2.0 * s1 - ro)
            dx_ = (rho * ro * dx_
                   + (2.0 * rho / delta) * (b - apply_l(l, x)) / d)
            x = x + dx_
            ro = rho
        return x

    def vcycle(l, b):
        if l == nlev - 1:
            return smooth(l, torch.zeros_like(b), b, coarse_iters)
        x = smooth(l, torch.zeros_like(b), b, pre_smooth)
        r = b - apply_l(l, x)
        pcx, pcy = plan[l]
        # Dirichlet rows belong to the smoother on each level
        rc = _down(l, torch.where(masks[l], 0.0, r), pcx, pcy)
        ec = vcycle(l + 1, torch.where(masks[l + 1], 0.0, rc))
        x = x + torch.where(masks[l], 0.0, _up(l, ec, pcx, pcy))
        return smooth(l, x, b, post_smooth)

    def _down(l, r, pcx, pcy):
        """Level l's residual restricted into level l + 1's layout: in
        blocks, or, where l + 1 is replicated, gathered once and restricted
        on the global tensors."""
        if isinstance(r, Blocks):
            if isinstance(coeffs[l + 1][0], Blocks):
                return block_ops.restrict_corner(r, bcs.periodic_x)
            r = gather_all([r], kind="coarse")[0]
        return restrict_corner(r, bcs.periodic_x, cx=pcx, cy=pcy)

    def _up(l, ec, pcx, pcy):
        """Level l + 1's correction prolonged onto level l: in blocks, or
        from the replicated level on the global tensors, then split onto a
        sharded level l (no message)."""
        if isinstance(ec, Blocks):
            return block_ops.prolong_corner(ec)
        e = prolong_corner(ec, cx=pcx, cy=pcy)
        return (Blocks.split(e, "corner", mesh)
                if isinstance(coeffs[l][0], Blocks) else e)

    return lambda r: vcycle(0, r)
