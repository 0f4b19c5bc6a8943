"""Line (tridiagonal) relaxation, the anisotropy remedy of stretched grids.

Port of ``pylamp_tpu/solvers/lines.py``.  A line smoother solves, per
sweep, the 1-D tridiagonal system that couples each grid line along one
axis exactly, with the other axis' coupling in the full diagonal; "line"
alternates y and x lines.  Each sweep is a damped line-Jacobi iteration
x += omega * T^-1 (r - A x), T = D + L_axis + U_axis.

The batched tridiagonal systems are solved by parallel cyclic reduction
(ceil(log2 n) elementwise passes over the whole level, batched over the
other axis).  The reduction of the matrix does not depend on the right-hand
side, so ``pcr_factor`` runs it once per level and solve (the coefficients
are frozen while the viscosity is) and ``pcr_solve`` applies only the
right-hand side's half of each pass: the same arithmetic as
``tridiag_pcr``, the reference's one-call form, in three tensor operations
a pass instead of about a dozen.  It is plain tensor code, not a kernel.

Periodic side walls make the x coupling cyclic, which is not tridiagonal:
line smoothing needs non-periodic side walls.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.stretched import grid_tensors


class PcrFactor(NamedTuple):
    """A tridiagonal matrix reduced by parallel cyclic reduction: per pass
    (stride s, the lower ratios a_i / b_{i-s} for i >= s, the upper ratios
    c_i / b_{i+s} for i < n - s), and the final diagonal; all with the
    solve axis first."""

    axis: int
    passes: tuple  # ((s, ra, rc), ...)
    b: torch.Tensor


def pcr_factor(a, b, c, axis: int = 0) -> PcrFactor:
    """Reduce a_i x_{i-1} + b_i x_i + c_i x_{i+1} = d_i along ``axis``
    (batched over the other axis) for ``pcr_solve``.  a[0] and c[n-1] are
    ignored (taken as zero).  Stable for the diagonally dominant systems of
    the line smoothers."""
    a = torch.movedim(a, axis, 0).clone()
    b = torch.movedim(b, axis, 0)
    c = torch.movedim(c, axis, 0).clone()
    n = a.shape[0]
    a[0] = 0.0
    c[-1] = 0.0
    passes = []
    s = 1
    while s < n:
        # row i takes rows i - s and i + s; rows out of range are identity
        # rows, whose terms vanish exactly
        ra = a[s:] / b[:-s]
        rc = c[:-s] / b[s:]
        b = b.clone()
        b[s:].addcmul_(ra, c[:-s], value=-1.0)
        b[:-s].addcmul_(rc, a[s:], value=-1.0)
        a_new = torch.zeros_like(a)
        a_new[s:].addcmul_(ra, a[:-s], value=-1.0)
        c_new = torch.zeros_like(c)
        c_new[:-s].addcmul_(rc, c[s:], value=-1.0)
        passes.append((s, ra, rc))
        a, c = a_new, c_new
        s *= 2
    return PcrFactor(axis, tuple(passes), b)


def pcr_solve(f: PcrFactor, d):
    """x with T x = d for the factored T (``pcr_factor``)."""
    d = torch.movedim(d, f.axis, 0)
    for s, ra, rc in f.passes:
        d_new = d.clone()
        d_new[s:].addcmul_(ra, d[:-s], value=-1.0)
        d_new[:-s].addcmul_(rc, d[s:], value=-1.0)
        d = d_new
    return torch.movedim(d / f.b, 0, f.axis)


def tridiag_pcr(a, b, c, d, axis: int = 0):
    """Solve a_i x_{i-1} + b_i x_i + c_i x_{i+1} = d_i along ``axis``,
    batched over the other axis, by parallel cyclic reduction."""
    return pcr_solve(pcr_factor(a, b, c, axis), d)


# -- momentum-stencil line coefficients ---------------------------------------

def momentum_line_coeffs(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                         axis: int):
    """Exact sub/super-diagonals (sub_vx, sup_vx, sub_vy, sup_vy) of the
    momentum stencil along ``axis`` (0 = y lines, 1 = x lines), zeroed on
    the Dirichlet rows and columns (whose diagonal is kbnd).  Coupling
    entries are negative; the full diagonal dominates.  Shapes: the vx
    (ny, nx+1) and vy (ny+1, nx) lattices."""
    if bcs.periodic_x:
        raise ValueError("line smoothing requires non-periodic side walls "
                         "(cyclic x coupling is not tridiagonal)")
    ny, nx = grid.ny, grid.nx
    dt, dev = eta_n.dtype, eta_n.device
    s = grid_tensors(grid, dt, dev)

    if axis == 0:
        dyc, dyv, dyn = s.dyc, s.dyv, s.dyn  # columns
        # vx: shear coupling through the sxy rows
        sub_vx = -eta_s[:-1, :] / (dyn[:-1] * dyc)
        sup_vx = -eta_s[1:, :] / (dyn[1:] * dyc)
        sub_vx[0, :] = 0.0  # the ghost row folds into the diagonal
        sup_vx[-1, :] = 0.0
        for t in (sub_vx, sup_vx):  # Dirichlet columns
            t[:, 0] = 0.0
            t[:, -1] = 0.0
        # vy: normal-stress coupling through syy; rows 0 and ny Dirichlet
        zrow = torch.zeros((1, nx), dtype=dt, device=dev)
        sub_vy = torch.cat(
            [zrow, -2.0 * eta_n[:-1, :] / (dyc[:-1] * dyv), zrow], dim=0)
        sup_vy = torch.cat(
            [zrow, -2.0 * eta_n[1:, :] / (dyc[1:] * dyv), zrow], dim=0)
        return sub_vx, sup_vx, sub_vy, sup_vy

    if axis == 1:
        dxc, dxv, dxn = s.dxc, s.dxv, s.dxn  # rows
        # vx: normal-stress coupling through sxx; columns 0 and nx Dirichlet
        zcol = torch.zeros((ny, 1), dtype=dt, device=dev)
        sub_vx = torch.cat(
            [zcol, -2.0 * eta_n[:, :-1] / (dxc[:, :-1] * dxv), zcol], dim=1)
        sup_vx = torch.cat(
            [zcol, -2.0 * eta_n[:, 1:] / (dxc[:, 1:] * dxv), zcol], dim=1)
        # vy: shear coupling through the sxy columns
        sub_vy = -eta_s[:, :-1] / (dxn[:, :-1] * dxc)
        sup_vy = -eta_s[:, 1:] / (dxn[:, 1:] * dxc)
        sub_vy[:, 0] = 0.0  # the ghost column folds into the diagonal
        sup_vy[:, -1] = 0.0
        for t in (sub_vy, sup_vy):  # Dirichlet rows
            t[0, :] = 0.0
            t[-1, :] = 0.0
        return sub_vx, sup_vx, sub_vy, sup_vy

    raise ValueError(f"axis must be 0 (y lines) or 1 (x lines), got {axis}")


def stencil_line_coeffs(apply_fn, shape, axis: int, dtype, device):
    """Exact sub/super-diagonals along ``axis`` of any linear 5-point
    stencil operator ``apply_fn``, from nine 3-periodic comb probes
    e_{r,s}[j, i] = 1 iff (j mod 3, i mod 3) == (r, s): reading (A e)[j, i]
    at (j -+ 1) mod 3 == r, i mod 3 == s isolates the single y-neighbour
    coupling (and likewise for x).  Boundary entries come out exactly
    zero.  Nine operator applications; the energy multigrid's line
    coefficients."""
    j = torch.arange(shape[0], device=device).view(-1, 1)
    i = torch.arange(shape[1], device=device).view(1, -1)
    sub = torch.zeros(shape, dtype=dtype, device=device)
    sup = torch.zeros(shape, dtype=dtype, device=device)
    jm, jp = (j - 1) % 3, (j + 1) % 3
    im, ip = (i - 1) % 3, (i + 1) % 3
    for r in range(3):
        for q in range(3):
            e = ((j % 3 == r) & (i % 3 == q)).to(dtype)
            Ae = apply_fn(e)
            if axis == 0:
                sub = torch.where((jm == r) & (i % 3 == q), Ae, sub)
                sup = torch.where((jp == r) & (i % 3 == q), Ae, sup)
            else:
                sub = torch.where((j % 3 == r) & (im == q), Ae, sub)
                sup = torch.where((j % 3 == r) & (ip == q), Ae, sup)
    return sub, sup


def line_axes(smoother: str):
    """The sweep-axis sequence of a line-smoother name."""
    return {
        "line": (0, 1),  # alternating y then x lines (mixed aspect)
        "line_y": (0,),  # y lines only (dy << dx)
        "line_x": (1,),
    }[smoother]
