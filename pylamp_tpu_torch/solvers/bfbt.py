"""Weighted-BFBT Schur complement surrogate (``schur="wbfbt"``).

Port of ``pylamp_tpu/solvers/bfbt.py``.  The weighted BFBT approximation
(Elman's BFBt with viscosity-dependent diagonal weighting; Rudi, Stadler &
Ghattas, SISC 2017)

    S^-1  ~=  K^-1 (B C^-1 A C^-1 G) K^-1 ,     K = B C^-1 G

with C = diag(w) on the velocity faces, w = sqrt(eta_face / eta_char).  In
the operator's conventions (momentum rows carry +grad p, continuity rows
kcont * div v) it is

    S^-1 r  =  (1/kcont) * Khat^-1 [ div( C^-1 A C^-1 grad (Khat^-1 r) ) ]

with Khat = -div((1/w) grad) an SPSD pure-Neumann pressure Poisson
operator on the cell centres (wall faces carry no flux), its constant
nullspace handled by mean projection.  In the isoviscous limit it reduces
to the mass surrogate -(eta / kcont) r.

Khat^-1 is one cell-centred geometric-multigrid V-cycle (bilinear
transfers with Neumann ghosts, geometric-mean-coarsened viscosity,
Chebyshev smoothing with power-iteration bounds) inside a few flexible-CG
iterations.  Every loop has a fixed count and reads nothing back to the
host (``krylov.fcg_fixed`` for the CG wrap).  No kernel runs here: the
reference's module is tensor code too.

The reference records that on cell-sharp step coefficients the surrogate
stagnates (its tests/test_bfbt.py); it is meant for smooth coefficients.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.solvers.krylov import fcg_fixed


# -- the weighted pressure Poisson operator  Khat = -div((1/w) grad) ----------

def _log(a):
    """log of a tensor, or of a Python number in f64 (as the reference's
    weakly typed scalar)."""
    return torch.log(a) if torch.is_tensor(a) else math.log(a)


def face_coeffs(eta_n, eta_char):
    """Interior-face coefficients c = 1/w = 1/sqrt(eta_face/eta_char), with
    eta_face the geometric mean of the two adjacent cell viscosities.
    Returns (cx (ny, nx-1), cy (ny-1, nx))."""
    ln = torch.log(eta_n) - _log(eta_char)
    cx = torch.exp(-0.25 * (ln[:, 1:] + ln[:, :-1]))
    cy = torch.exp(-0.25 * (ln[1:, :] + ln[:-1, :]))
    return cx, cy


def poisson_apply(z, cx, cy, grid: StaggeredGrid):
    """Khat z = -div(c grad z) on the centre lattice; wall faces carry zero
    flux (pure Neumann; SPSD with constant nullspace)."""
    dx, dy = grid.dx, grid.dy
    fxp = F.pad(cx * (z[:, 1:] - z[:, :-1]) / dx, (1, 1))  # (ny, nx+1)
    fyp = F.pad(cy * (z[1:, :] - z[:-1, :]) / dy, (0, 0, 1, 1))  # (ny+1, nx)
    return -((fxp[:, 1:] - fxp[:, :-1]) / dx + (fyp[1:, :] - fyp[:-1, :]) / dy)


def poisson_diag(cx, cy, grid: StaggeredGrid):
    cxp = F.pad(cx, (1, 1))
    cyp = F.pad(cy, (0, 0, 1, 1))
    return ((cxp[:, 1:] + cxp[:, :-1]) / grid.dx ** 2
            + (cyp[1:, :] + cyp[:-1, :]) / grid.dy ** 2)


# -- cell-centred transfers ------------------------------------------------------

def _interleave(a, b, dim):
    return torch.stack([a, b], dim=dim + 1).flatten(dim, dim + 1)


def prolong_center(c):
    """Bilinear cell-centred prolongation with Neumann (copy) ghosts:
    coarse (NY, NX) -> fine (2NY, 2NX); fine centres sit at +-1/4 of the
    coarse spacing, weights (9, 3, 3, 1)/16."""
    g = F.pad(c[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    left = 0.75 * g[:, 1:-1] + 0.25 * g[:, :-2]
    right = 0.75 * g[:, 1:-1] + 0.25 * g[:, 2:]
    e = _interleave(left, right, 1)  # (NY+2, 2NX)
    up = 0.75 * e[1:-1, :] + 0.25 * e[:-2, :]
    dn = 0.75 * e[1:-1, :] + 0.25 * e[2:, :]
    return _interleave(up, dn, 0)  # (2NY, 2NX)


def restrict_center(f):
    """Adjoint of prolong_center / 4 (the Neumann ghosts fold the boundary
    weights back into the edge cells)."""
    # y: coarse row J gathers fine rows 2J, 2J+1 with weight 3/4 and the
    # outer neighbours 2J-1, 2J+2 with 1/4 (folded at the walls)
    a = 0.75 * f[0::2, :] + 0.75 * f[1::2, :]
    outer_up = torch.cat([f[:1, :] * 0, f[1:-1:2, :] * 0.25], dim=0)
    outer_dn = torch.cat([f[2::2, :] * 0.25, f[:1, :] * 0], dim=0)
    fold_up = torch.cat([f[:1, :] * 0.25, torch.zeros_like(f[1:-1:2, :])],
                        dim=0)
    fold_dn = torch.cat([torch.zeros_like(f[2::2, :]), f[-1:, :] * 0.25],
                        dim=0)
    g = a + outer_up + outer_dn + fold_up + fold_dn  # (NY, nx2)
    b = 0.75 * g[:, 0::2] + 0.75 * g[:, 1::2]
    outer_l = torch.cat([g[:, :1] * 0, g[:, 1:-1:2] * 0.25], dim=1)
    outer_r = torch.cat([g[:, 2::2] * 0.25, g[:, :1] * 0], dim=1)
    fold_l = torch.cat([g[:, :1] * 0.25, torch.zeros_like(g[:, 1:-1:2])],
                       dim=1)
    fold_r = torch.cat([torch.zeros_like(g[:, 2::2]), g[:, -1:] * 0.25],
                       dim=1)
    return (b + outer_l + outer_r + fold_l + fold_r) / 4.0


# -- pressure Poisson multigrid ----------------------------------------------------

def num_levels(grid: StaggeredGrid, requested: int = 0,
               min_cells: int = 4) -> int:
    n = 1
    nx, ny = grid.nx, grid.ny
    while nx % 2 == 0 and ny % 2 == 0 and min(nx, ny) > min_cells:
        nx //= 2
        ny //= 2
        n += 1
    if requested > 0:
        n = min(n, requested)
    return n


def _power_lambda_max(apply_binv_a, shape, dtype, device, iters: int = 12):
    """|lambda_max| of D^-1 Khat by power iteration orthogonal to the
    constant nullspace, from the reference's lattice start vector computed
    in the working dtype; no host read."""
    n = shape[0] * shape[1]
    v = (torch.remainder(
        torch.arange(n, dtype=dtype, device=device) * 0.754877666 + 0.1, 1.0)
        - 0.5).reshape(shape)
    v = v - torch.mean(v)
    lam = torch.ones((), dtype=dtype, device=device)
    for _ in range(iters):
        v = v / torch.sqrt(torch.vdot(v.reshape(-1), v.reshape(-1)))
        w = apply_binv_a(v)
        lam = torch.vdot(v.reshape(-1), w.reshape(-1))
        v = w - torch.mean(w)
    return torch.abs(lam)


def make_pressure_poisson_mg(eta_n, grid: StaggeredGrid, eta_char,
                             levels: int = 0, pre_smooth: int = 2,
                             post_smooth: int = 2, coarse_iters: int = 24):
    """V-cycle preconditioner for Khat (mean-projected in and out)."""
    nlev = num_levels(grid, levels)
    dtype, device = eta_n.dtype, eta_n.device

    grids = [grid]
    etas = [eta_n]
    for _ in range(nlev - 1):
        grids.append(grids[-1].coarsen())
        e = etas[-1]
        etas.append(torch.exp(0.25 * (
            torch.log(e[0::2, 0::2]) + torch.log(e[0::2, 1::2])
            + torch.log(e[1::2, 0::2]) + torch.log(e[1::2, 1::2]))))
    coeffs = [face_coeffs(e, eta_char) for e in etas]
    tiny = torch.finfo(dtype).tiny
    diags = [torch.clamp(poisson_diag(cx, cy, g), min=tiny)
             for (cx, cy), g in zip(coeffs, grids)]

    def apply_l(l, z):
        cx, cy = coeffs[l]
        return poisson_apply(z, cx, cy, grids[l])

    lam = [1.1 * _power_lambda_max(
        lambda v, l=l: apply_l(l, v) / diags[l], grids[l].shape_center,
        dtype, device) for l in range(nlev)]

    def smooth(l, x, b, iters):
        """Chebyshev on D^-1 Khat over [lmax/4, lmax]."""
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
            dx_ = rho * ro * dx_ + (2.0 * rho / delta) * (b - apply_l(l, x)) / d
            x = x + dx_
            ro = rho
        return x

    def vcycle(l, b):
        if l == nlev - 1:
            return smooth(l, torch.zeros_like(b), b, coarse_iters)
        x = smooth(l, torch.zeros_like(b), b, pre_smooth)
        r = b - apply_l(l, x)
        ec = vcycle(l + 1, restrict_center(r))
        x = x + prolong_center(ec)
        return smooth(l, x, b, post_smooth)

    def M(r):
        z = vcycle(0, r - torch.mean(r))
        return z - torch.mean(z)

    return M


# -- the weighted-BFBT Schur application ------------------------------------------

def make_bfbt_schur(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                    kcont, kbnd, eta_char, poisson_iters: int = 3,
                    poisson_tol: float = 1e-2, mg_levels: int = 0):
    """Returns S_inv(r_c) -> z_p implementing the weighted-BFBT formula.

    ``poisson_iters``: flexible-CG iterations per Khat solve (each
    preconditioned by one V-cycle; fewer where the residual falls under
    ``poisson_tol`` first); 0 = a single V-cycle, no Krylov wrap."""
    if not grid.uniform:
        raise ValueError(
            "the w-BFBT Schur surrogate has no stretched-grid path yet; use "
            "schur='mass' on stretched grids")
    # solvers/mg.py builds this surrogate, so its helpers come in here
    from pylamp_tpu_torch.solvers.mg import _pressure_gradient, momentum_apply

    dtype = eta_n.dtype
    if not torch.is_tensor(eta_char):
        eta_char = torch.tensor(eta_char, dtype=torch.float64,
                                device=eta_n.device)

    # C^-1 on the velocity faces: 1/w with w = sqrt(eta_face/eta_char);
    # boundary faces never see a nonzero input (grad is zero on Dirichlet
    # rows) and carry 1
    lnn = torch.log(eta_n) - _log(eta_char)
    winv_x = F.pad(torch.exp(-0.25 * (lnn[:, 1:] + lnn[:, :-1])), (1, 1),
                   value=1.0)  # (ny, nx+1)
    winv_y = F.pad(torch.exp(-0.25 * (lnn[1:, :] + lnn[:-1, :])),
                   (0, 0, 1, 1), value=1.0)  # (ny+1, nx)

    cx, cy = face_coeffs(eta_n, eta_char)
    Mpp = make_pressure_poisson_mg(eta_n, grid, eta_char, levels=mg_levels)

    def khat(z):
        return poisson_apply(z, cx, cy, grid)

    # f32 safety: the raw composition spans ~40 orders of magnitude, so
    # each K solve normalizes its input to O(1) and the middle momentum
    # apply runs as A / eta_char; everything is linear, so the scales
    # recombine exactly in the final factor
    tiny = torch.finfo(dtype).tiny

    def ksolve(r):
        r = r - torch.mean(r)
        s = torch.clamp(torch.max(torch.abs(r)), min=tiny)
        if poisson_iters > 0:
            z = fcg_fixed(khat, r / s, torch.zeros_like(r), M=Mpp,
                          tol=poisson_tol, maxiter=poisson_iters)
            return z - torch.mean(z), s
        return Mpp(r / s), s

    def div(vx, vy):
        return ((vx[:, 1:] - vx[:, :-1]) / grid.dx
                + (vy[1:, :] - vy[:-1, :]) / grid.dy)

    inv_echar = (1.0 / eta_char).to(dtype)
    # eta_char / kcont = (dx + dy) / 2 by construction (solvers/scaling.py),
    # kept symbolic so that another kcont stays correct
    out_scale = (eta_char / kcont).to(dtype)

    def S_inv(rc):
        z1, s1 = ksolve(rc)
        gx, gy = _pressure_gradient(z1, grid, dtype)
        ax, ay = momentum_apply(gx * winv_x, gy * winv_y, eta_s, eta_n, grid,
                                bcs, kbnd)
        mid = div(ax * inv_echar * winv_x, ay * inv_echar * winv_y)
        z2, s2 = ksolve(mid)
        return z2 * (s1 * s2 * out_scale)

    return S_inv
