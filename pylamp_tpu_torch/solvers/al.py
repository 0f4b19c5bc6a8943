"""Augmented-Lagrangian (grad-div) row operation for sharp viscosity
contrast (port of ``pylamp_tpu/solvers/al.py``):

    momentum rows  +=  gamma * D^T ( eta_n * (div u) )        (operator)
    rhs            +=  gamma / kcont * D^T ( eta_n * g_c )    (same row op)
    Schur surrogate:   z_p = -(1 + gamma) * eta_n / kcont * r_c

Adding multiples of the continuity rows to the momentum rows leaves the
solution unchanged, and makes the eta-weighted pressure mass a Schur
surrogate whose quality does not depend on the viscosity contrast.  The
augmented velocity block A + gamma D^T W D is stiffer, so the MG
preconditioner solves it with an inner velocity FGMRES preconditioned by
the V-cycle on the un-augmented A (``solvers/mg.py``).  The production
value is the sticky-air preset's gamma = 10 (``models/benchmarks.py``).

On the uniform staggered grid D^T = -G (G the pressure gradient of the
momentum rows, zero on the Dirichlet rows), so the term is -G(gamma eta_n
D u).  Plain tensor code: the reference has no kernel for it.
"""
from __future__ import annotations

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid


def make_grad_div(eta_n, grid: StaggeredGrid, bcs: VelocityBCs, gamma,
                  dtype):
    """Returns gd(vx, vy) -> (tx, ty): the term gamma * D^T(eta_n * Du)
    to ADD to the momentum rows (= -G(gamma * eta_n * Du))."""
    from pylamp_tpu_torch.solvers.mg import _pressure_gradient

    if not grid.uniform:
        raise NotImplementedError(
            "al_gamma > 0 requires a uniform grid")
    w = (float(gamma) * eta_n).to(dtype)

    def gd(vx, vy):
        du = (vx[:, 1:] - vx[:, :-1]) / grid.dx + (
            vy[1:, :] - vy[:-1, :]) / grid.dy
        gx, gy = _pressure_gradient(w * du, grid, dtype, bcs=bcs)
        return -gx, -gy

    return gd


def augment_saddle_op(op, gd):
    """Wrap a (vx, vy, p) -> (rx, ry, rc) saddle operator (the plain
    stencil or the saddle kernel) with the AL momentum augmentation."""

    def op_aug(u):
        rx, ry, rc = op(u)
        tx, ty = gd(u[0], u[1])
        return rx + tx, ry + ty, rc

    return op_aug


def augment_rhs(b, eta_n, grid: StaggeredGrid, bcs: VelocityBCs, gamma,
                kcont, dtype):
    """f_gamma = f + gamma/kcont * D^T(eta_n * g_c): the rhs side of the
    same row operation (zero whenever the continuity rhs is zero)."""
    from pylamp_tpu_torch.solvers.mg import _pressure_gradient

    fx, fy, g_c = b
    q = (float(gamma) * eta_n / kcont) * g_c
    gx, gy = _pressure_gradient(q, grid, dtype, bcs=bcs)
    return fx - gx, fy - gy, g_c
