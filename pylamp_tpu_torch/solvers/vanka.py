"""Coupled multigrid on the full Stokes system (``preconditioner="vanka"``).

Port of ``pylamp_tpu/solvers/vanka.py``: multigrid on the whole (vx, vy, p)
saddle-point system, so that pressure and velocity relax together where
the viscosity jumps by decades across one cell.  Two ingredients:

1. Symmetric Jacobi equilibration per level: velocities scaled by
   sqrt(momentum diagonal), pressure by sqrt(|Schur diagonal|), so the
   scaled system's rows and columns are O(1) at any viscosity contrast.
2. Braess-Sarazin smoothing: each sweep approximately solves the
   damped-diagonal saddle system [[alpha I, G_hat], [B_hat, 0]] du = r_hat
   (a few damped Jacobi iterations on the scaled pressure Laplacian, then
   the consistent velocity update dv = (r_v - G_hat dp) / alpha).

(The name is historical: the reference's first implementation used an
exact-box Vanka smoother, which measurement replaced with the above.)

Every level applies the plain global operator (ops/stokes.py), as in the
reference, on every path: no MG kernel runs under this preconditioner, and
on a mesh it works on the global tensors.  Every loop has a fixed count
and reads nothing back to the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.stokes import stokes_operator
from pylamp_tpu_torch.solvers.bfbt import num_levels
from pylamp_tpu_torch.solvers.mg import (
    coarsen_eta,
    prolong_vx,
    prolong_vy,
    restrict_vx,
    restrict_vy,
)


# -- pressure (cell-centred) transfers ------------------------------------------

def restrict_p(f):
    """(2NY, 2NX) -> (NY, NX): 4-child average (P^T/4 of injection)."""
    return 0.25 * (f[0::2, 0::2] + f[0::2, 1::2] + f[1::2, 0::2]
                   + f[1::2, 1::2])


def prolong_p(c):
    """(NY, NX) -> (2NY, 2NX): piecewise-constant injection."""
    return c.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


# -- BC-aware momentum diagonals ---------------------------------------------------

def _edge_weights(n, dtype, device, first, last, dim):
    """Ones of length n along ``dim`` (the other dim 1) with the first and
    last entries set to ``first`` and ``last`` (None: left at 1)."""
    w = torch.ones(n, dtype=dtype, device=device)
    if first is not None:
        w[0] = first
    if last is not None:
        w[-1] = last
    return w.view(n, 1) if dim == 0 else w.view(1, n)


def momentum_diagonals_bc(eta_s, eta_n, grid: StaggeredGrid,
                          bcs: VelocityBCs, kbnd):
    """BC-aware full momentum diagonals on the (vx, vy) face lattices (the
    ghost elimination drops the wall eta_s term under free slip and doubles
    it under no slip); Dirichlet faces carry kbnd."""
    ny, nx = grid.ny, grid.nx
    dtype, dev = eta_n.dtype, eta_n.device
    dx2, dy2 = grid.dx ** 2, grid.dy ** 2
    wt = _edge_weights(ny, dtype, dev, 1.0 - bcs.s_top, None, 0)
    wb = _edge_weights(ny, dtype, dev, None, 1.0 - bcs.s_bottom, 0)
    dvx_int = (2.0 * (eta_n[:, 1:] + eta_n[:, :-1]) / dx2
               + (wt * eta_s[:-1, 1:-1] + wb * eta_s[1:, 1:-1]) / dy2)
    wl = _edge_weights(nx, dtype, dev, 1.0 - bcs.s_left, None, 1)
    wr = _edge_weights(nx, dtype, dev, None, 1.0 - bcs.s_right, 1)
    dvy_int = (2.0 * (eta_n[1:, :] + eta_n[:-1, :]) / dy2
               + (wl * eta_s[1:-1, :-1] + wr * eta_s[1:-1, 1:]) / dx2)
    kb = kbnd * torch.ones((ny, 1), dtype=dtype, device=dev)
    dvx = torch.cat([kb, dvx_int, kb], dim=1)
    kb = kbnd * torch.ones((1, nx), dtype=dtype, device=dev)
    dvy = torch.cat([kb, dvy_int, kb], dim=0)
    return dvx, dvy


# -- one equilibrated level -----------------------------------------------------------

def _zero_first(a, dim):
    a = a.clone()
    a.select(dim, 0).zero_()
    return a


def _zero_last(a, dim):
    a = a.clone()
    a.select(dim, a.shape[dim] - 1).zero_()
    return a


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


class _ScaledLevel:
    """One level of the equilibrated coupled MG: the symmetric Jacobi
    scaling of the saddle system plus the Braess-Sarazin smoother data."""

    def __init__(self, eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                 kcont, kbnd, alpha: float):
        self.eta_s, self.eta_n = eta_s, eta_n
        self.grid, self.bcs = grid, bcs
        self.kcont, self.kbnd = kcont, kbnd
        self.alpha = alpha
        dx, dy = grid.dx, grid.dy

        dvx, dvy = momentum_diagonals_bc(eta_s, eta_n, grid, bcs, kbnd)
        adx, ady = alpha * dvx, alpha * dvy
        # face transmissibilities of M_p = B (alpha D)^-1 G: zero on the
        # Dirichlet faces (their momentum rows carry no pressure gradient:
        # the pressure stencil's natural Neumann closure)
        tL = _zero_first((kcont / dx ** 2) / adx[:, :-1], 1)
        tR = _zero_last((kcont / dx ** 2) / adx[:, 1:], 1)
        tT = _zero_first((kcont / dy ** 2) / ady[:-1, :], 0)
        tB = _zero_last((kcont / dy ** 2) / ady[1:, :], 0)
        self.t = (tL, tR, tT, tB)
        diag_p = tL + tR + tT + tB  # |Schur diagonal|
        self.sx = torch.sqrt(dvx)
        self.sy = torch.sqrt(dvy)
        self.sp = torch.sqrt(diag_p)

    # -- scaled-space linear algebra ---------------------------------------

    def scale_r(self, r):
        """PDE residual -> scaled residual (D^-1 r)."""
        return (r[0] / self.sx, r[1] / self.sy, r[2] / self.sp)

    def unscale_r(self, rh):
        """Scaled residual -> PDE residual (D r_hat)."""
        return (rh[0] * self.sx, rh[1] * self.sy, rh[2] * self.sp)

    def unscale_x(self, xh):
        """Scaled solution -> PDE solution (x = D^-1 x_hat)."""
        return (xh[0] / self.sx, xh[1] / self.sy, xh[2] / self.sp)

    def scale_x(self, x):
        """PDE solution -> scaled solution (x_hat = D x)."""
        return (x[0] * self.sx, x[1] * self.sy, x[2] * self.sp)

    def zeros(self):
        g = self.grid
        return tuple(torch.zeros(s, dtype=self.sx.dtype, device=self.sx.device)
                     for s in (g.shape_vx, g.shape_vy, g.shape_center))

    def apply_scaled(self, xh):
        """A_hat x_hat = D^-1 A (D^-1 x_hat): unit momentum diagonal."""
        vx, vy, p = self.unscale_x(xh)
        return self.scale_r(stokes_operator(
            vx, vy, p, self.eta_s, self.eta_n, self.grid, self.bcs,
            kcont=self.kcont, kbnd=self.kbnd))

    def _apply_Mp_hat(self, ph):
        """Scaled pressure stencil D_p^-1 M_p D_p^-1; diagonal is -1."""
        tL, tR, tT, tB = self.t
        p = ph / self.sp
        pL = F.pad(p, (1, 0))[:, :-1]
        pR = F.pad(p, (0, 1))[:, 1:]
        pT = F.pad(p, (0, 0, 1, 0))[:-1, :]
        pB = F.pad(p, (0, 0, 0, 1))[1:, :]
        out = tL * (pL - p) + tR * (pR - p) + tT * (pT - p) + tB * (pB - p)
        return out / self.sp

    def smooth(self, uh, rhs_h, sweeps: int, pressure_jacobi: int = 4,
               omega_j: float = 0.8):
        """Braess-Sarazin sweeps on the scaled system (module docstring)."""
        kcont, alpha = self.kcont, self.alpha
        dx, dy = self.grid.dx, self.grid.dy
        for _ in range(sweeps):
            rx, ry, rc = _sub(rhs_h, self.apply_scaled(uh))
            # rhs of the scaled pressure system: B_hat alpha^-1 r_v - r_c
            qx = rx / (alpha * self.sx)
            qy = ry / (alpha * self.sy)
            rhs_p = (kcont * ((qx[:, 1:] - qx[:, :-1]) / dx
                              + (qy[1:, :] - qy[:-1, :]) / dy)
                     / self.sp - rc)
            dp = torch.zeros_like(rc)
            for _ in range(pressure_jacobi):
                # Jacobi with diag(M_p_hat) = -1
                dp = dp - omega_j * (rhs_p - self._apply_Mp_hat(dp))
            # the consistent velocity update dv = (r_v - G_hat dp) / alpha
            dpp = dp / self.sp
            gpx = F.pad(dpp[:, 1:] - dpp[:, :-1], (1, 1)) / dx
            gpy = F.pad(dpp[1:, :] - dpp[:-1, :], (0, 0, 1, 1)) / dy
            dvx_h = (rx - gpx / self.sx) / alpha
            dvy_h = (ry - gpy / self.sy) / alpha
            uh = (uh[0] + dvx_h, uh[1] + dvy_h, uh[2] + dp)
        return uh


# -- the coupled V-cycle -----------------------------------------------------------------

def make_coupled_vanka_mg(eta_s, eta_n, grid: StaggeredGrid,
                          bcs: VelocityBCs, kcont, kbnd, levels: int = 0,
                          pre_smooth: int = 2, post_smooth: int = 2,
                          coarse_sweeps: int = 24, alpha: float = 1.5):
    """Returns mg(rhs) -> u: one equilibrated coupled V-cycle on the full
    (vx, vy, p) system from a zero initial guess.  ``rhs`` and the returned
    correction are in PDE units; the scaling is internal."""
    nlev = num_levels(grid, levels)

    # the Dirichlet-row scaling follows the stencil's h^-2 growth per
    # level; kcont is an h-independent row scaling and stays the same on
    # every level, so restricted residuals stay consistent
    lv = [_ScaledLevel(eta_s, eta_n, grid, bcs, kcont, kbnd, alpha)]
    for _ in range(nlev - 1):
        cg = lv[-1].grid.coarsen()
        es, en = coarsen_eta(lv[-1].eta_s, lv[-1].eta_n)
        ckbnd = kbnd * (grid.dx / cg.dx) ** 2
        lv.append(_ScaledLevel(es, en, cg, bcs, kcont, ckbnd, alpha))

    def vcycle(l, rhs_h):
        L = lv[l]
        if l == nlev - 1:
            return L.smooth(L.zeros(), rhs_h, coarse_sweeps)
        uh = L.smooth(L.zeros(), rhs_h, pre_smooth)
        # the transfers act on PDE-unit quantities; rescale per level
        r = L.unscale_r(_sub(rhs_h, L.apply_scaled(uh)))
        C = lv[l + 1]
        ec_h = vcycle(l + 1, C.scale_r((restrict_vx(r[0], bcs),
                                        restrict_vy(r[1], bcs),
                                        restrict_p(r[2]))))
        e = C.unscale_x(ec_h)
        ef_h = L.scale_x((prolong_vx(e[0], bcs), prolong_vy(e[1], bcs),
                          prolong_p(e[2])))
        uh = tuple(a + b for a, b in zip(uh, ef_h))
        return L.smooth(uh, rhs_h, post_smooth)

    fine = lv[0]

    def mg(rhs):
        return fine.unscale_x(vcycle(0, fine.scale_r(rhs)))

    return mg


def make_vanka_mg_preconditioner(eta_s, eta_n, grid: StaggeredGrid, kcont,
                                 kbnd, bcs: VelocityBCs = None,
                                 levels: int = 0, cycles: int = 1,
                                 pre_smooth: int = 2, post_smooth: int = 2,
                                 coarse_sweeps: int = 24, alpha: float = 1.5):
    """FGMRES preconditioner: equilibrated coupled-MG V-cycle(s) on the full
    residual; the pressure is returned in the mean-zero gauge (the
    constant-pressure nullspace projected once per application)."""
    if not grid.uniform:
        raise ValueError(
            "the Vanka preconditioner has no stretched-grid path yet; use "
            "preconditioner='mg' on stretched grids")
    if bcs is None:
        bcs = VelocityBCs()
    mg = make_coupled_vanka_mg(eta_s, eta_n, grid, bcs, kcont, kbnd,
                               levels=levels, pre_smooth=pre_smooth,
                               post_smooth=post_smooth,
                               coarse_sweeps=coarse_sweeps, alpha=alpha)

    def M(r):
        z = mg(r)
        for _ in range(cycles - 1):
            a = stokes_operator(z[0], z[1], z[2], eta_s, eta_n, grid, bcs,
                                kcont=kcont, kbnd=kbnd)
            d = mg(_sub(r, a))
            z = tuple(x + y for x, y in zip(z, d))
        return (z[0], z[1], z[2] - torch.mean(z[2]))

    return M
