"""Matrix-free Krylov solvers on tensors and tuples of tensors.

Port of ``pylamp_tpu/solvers/krylov.py``: ``cg`` (preconditioned CG for
the energy solve), ``fcg`` (flexible CG, for the approximately SPD
multigrid preconditioners) and ``fgmres (flexible right-preconditioned GMRES(m)
with one- or two-pass classical Gram-Schmidt, for the Stokes saddle
point).  Vectors are a tensor or a tuple of tensors (the reference's
pytrees).

Host-sync policy.  The reference runs these loops as ``lax.while_loop``s
with no host round trip.  Eager PyTorch cannot branch on a device value
without reading it, so each loop reads ONE small device tensor per
iteration: CG and FCG their residual norm and breakdown flag, FGMRES the new
Hessenberg column (plus one residual norm per restart cycle).  FGMRES keeps
its small Hessenberg / Givens least-squares problem on the host in f64;
the Krylov basis, the operator and the preconditioner stay on the device.
``fcg_fixed`` is FCG for a fixed, small iteration count with no host read
(the inner solves of the w-BFBT Schur surrogate).

Sharded vectors (leaves that are ``parallel/blocks.py Blocks``) take the
same loops: every dot (``tdot``, FGMRES's Gram-Schmidt column and its
norm) is a per-shard partial summed over the mesh in the in-process shard
order, one small collective each, and FGMRES keeps its basis as a list
of vectors, projecting and combining them one after the other.  Plain
tensors run exactly as on one device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class SolveInfo(NamedTuple):
    iterations: int  # total operator applications
    residual: float  # final residual norm
    converged: bool
    bnorm: float = float("nan")  # ||b||: residual / bnorm is the relative residual


# -- vector helpers (tensor or tuple of tensors) ------------------------------

def tmap(f, *trees):
    if isinstance(trees[0], tuple):
        return tuple(f(*leaves) for leaves in zip(*trees))
    return f(*trees)


def leaves(tree):
    return tree if isinstance(tree, tuple) else (tree,)


def _sharded(tree) -> bool:
    from pylamp_tpu_torch.parallel.blocks import Blocks

    return isinstance(leaves(tree)[0], Blocks)


def tdot(a, b):
    """Global dot product (0-d tensor): a mesh reduction of sharded
    vectors."""
    if _sharded(a):
        from pylamp_tpu_torch.parallel.blocks import dots

        return dots([(a, b)])[0]
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(leaves(a), leaves(b)))


def tnorm(a):
    return torch.sqrt(tdot(a, a))


def taxpy(alpha, x, y):
    """alpha * x + y"""
    return tmap(lambda xl, yl: alpha * xl + yl, x, y)


def tsub(x, y):
    return tmap(lambda a, b: a - b, x, y)


def _identity(x):
    return x


# -- CG ------------------------------------------------------------------------

def cg(op: Callable, b: Any, x0: Any, M: Callable | None = None,
       tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000):
    """Preconditioned conjugate gradients with the reference's breakdown
    guard (a direction with p'Ap <= 0 or rz == 0 ends the loop).  Returns
    (x, SolveInfo)."""
    M = M or _identity
    bnorm = float(tnorm(b))
    target = max(tol * bnorm, atol)

    x = x0
    r = tsub(b, op(x0))
    z = M(r)
    rz = tdot(r, z)
    p = z
    k = 0
    res = float(tnorm(r))
    while res > target and k < maxiter:
        Ap = op(p)
        pAp = tdot(p, Ap)
        ok = torch.logical_and(pAp > 0, torch.abs(rz) > 0)
        safe = torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        alpha = torch.where(ok, rz / safe, torch.zeros_like(rz))
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, Ap, r)
        z = M(r)
        rz_new = tdot(r, z)
        beta = torch.where(
            ok, rz_new / torch.where(rz == 0, torch.ones_like(rz), rz),
            torch.zeros_like(rz))
        p = taxpy(beta, p, z)
        rz = rz_new
        # the one host read of the iteration: residual norm + breakdown flag
        res, ok_h = torch.stack([tnorm(r), ok.to(rz.dtype)]).tolist()
        k = k + 1 if ok_h else maxiter
    return x, SolveInfo(k, res, res <= target, bnorm)


def _fcg_step(op, M, x, r, z, p, rz):
    """One flexible-CG iteration with the reference's breakdown guard:
    (x, r, z, p, rz, ok), ok False where p'Ap <= 0 or rz == 0 (alpha and
    beta are then 0)."""
    Ap = op(p)
    pAp = tdot(p, Ap)
    ok = torch.logical_and(pAp > 0, torch.abs(rz) > 0)
    safe_pAp = torch.where(pAp == 0, torch.ones_like(pAp), pAp)
    safe_rz = torch.where(rz == 0, torch.ones_like(rz), rz)
    alpha = torch.where(ok, rz / safe_pAp, torch.zeros_like(rz))
    x = taxpy(alpha, p, x)
    r_new = taxpy(-alpha, Ap, r)
    z_new = M(r_new)
    # Polak-Ribiere: beta = <r_new, z_new - z> / <r, z>
    beta = torch.where(ok, (tdot(r_new, z_new) - tdot(r_new, z)) / safe_rz,
                       torch.zeros_like(rz))
    rz = tdot(r_new, z_new)
    p = taxpy(beta, p, z_new)
    return x, r_new, z_new, p, rz, ok


def fcg(op: Callable, b: Any, x0: Any, M: Callable | None = None,
        tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000):
    """Flexible preconditioned CG (Polak-Ribiere beta; Notay 2000), for a
    preconditioner that is only approximately SPD (a multigrid V-cycle):
    beta = <r_new, z_new - z> / <r, z> re-orthogonalizes against the
    previous direction.  The breakdown guard and host reads are ``cg``'s.
    Returns (x, SolveInfo)."""
    M = M or _identity
    bnorm = float(tnorm(b))
    target = max(tol * bnorm, atol)

    x = x0
    r = tsub(b, op(x0))
    z = M(r)
    rz = tdot(r, z)
    p = z
    k = 0
    res = float(tnorm(r))
    while res > target and k < maxiter:
        x, r, z, p, rz, ok = _fcg_step(op, M, x, r, z, p, rz)
        res, ok_h = torch.stack([tnorm(r), ok.to(rz.dtype)]).tolist()
        k = k + 1 if ok_h else maxiter
    return x, SolveInfo(k, res, res <= target, bnorm)


def fcg_fixed(op: Callable, b: Any, x0: Any, M: Callable | None = None,
              tol: float = 1e-8, atol: float = 0.0, maxiter: int = 3):
    """``fcg``'s iterate after at most ``maxiter`` iterations, with no host
    read: the loop runs ``maxiter`` times, and an iteration after the one
    where ``fcg`` would stop (the residual under target, or a breakdown)
    keeps the state as it is.  For the few-iteration inner solves of a
    preconditioner (solvers/bfbt.py).  Returns x."""
    M = M or _identity
    target = torch.clamp(tol * tnorm(b), min=atol)
    x = x0
    r = tsub(b, op(x0))
    z = M(r)
    state = (x, r, z, z, tdot(r, z))
    active = tnorm(r) > target
    for _ in range(maxiter):
        *new, ok = _fcg_step(op, M, *state)
        state = tuple(tmap(lambda n, o: torch.where(active, n, o), a, b_)
                      for a, b_ in zip(new, state))
        active = active & ok & (tnorm(state[1]) > target)
    return state[0]


# -- FGMRES(m) -----------------------------------------------------------------

def _back_substitute(H, g):
    """Solve the upper-triangular H y = g (host, f64)."""
    n = g.shape[0]
    y = np.zeros(n)
    for i in range(n - 1, -1, -1):
        y[i] = (g[i] - H[i, i + 1:n] @ y[i + 1:n]) / H[i, i]
    return y


class _StackedBasis:
    """FGMRES's basis of plain tensors: each leaf's m + 1 rows in one
    tensor, projected and combined by one matrix product."""

    def __init__(self, b, m: int):
        # rows are written before they are read (V[:k+1], Z[:k])
        self.tuple = isinstance(b, tuple)
        self.V = tuple(torch.empty((m + 1,) + l.shape, dtype=l.dtype,
                                   device=l.device) for l in leaves(b))

    def _pack(self, tree_leaves):
        return tuple(tree_leaves) if self.tuple else tree_leaves[0]

    def set(self, j, v):
        for Vl, vl in zip(self.V, leaves(v)):
            Vl[j] = vl

    def get(self, j):
        return self._pack([Vl[j] for Vl in self.V])

    def dots(self, n, w):
        return sum(Vl[:n].reshape(n, -1) @ wl.reshape(-1)
                   for Vl, wl in zip(self.V, leaves(w)))

    def combine(self, n, c):
        return self._pack([(c @ Vl[:n].reshape(n, -1)).reshape(Vl.shape[1:])
                           for Vl in self.V])


class _ListBasis:
    """FGMRES's basis of sharded vectors: a list of them, projected by one
    mesh reduction of per-shard dots and combined one row after the
    other."""

    def __init__(self, b, m: int):
        self.rows = [None] * (m + 1)

    def set(self, j, v):
        self.rows[j] = v

    def get(self, j):
        return self.rows[j]

    def dots(self, n, w):
        from pylamp_tpu_torch.parallel.blocks import dots

        return dots([(v, w) for v in self.rows[:n]])

    def combine(self, n, c):
        acc = tmap(lambda vl: c[0] * vl, self.rows[0])
        for j in range(1, n):
            acc = taxpy(c[j], self.rows[j], acc)
        return acc


def fgmres(op: Callable, b: Any, x0: Any, M: Callable | None = None,
           tol: float = 1e-8, atol: float = 0.0, restart: int = 30,
           maxiter: int = 1000, stagnation: float = 0.95,
           cgs_passes: int = 2):
    """Flexible right-preconditioned GMRES(m).  Returns (x, SolveInfo);
    iterations counts operator applications inside the cycles.

    ``stagnation``: stop when a whole restart cycle reduces the true
    residual by less than this factor (the working precision's floor)."""
    M = M or _identity
    m = restart
    bnorm = float(tnorm(b))
    target = max(tol * bnorm, atol)
    dtype = leaves(b)[0].dtype

    basis = _ListBasis if _sharded(b) else _StackedBasis

    def inner_cycle(x, r, beta):
        V = basis(b, m)
        Z = basis(b, m)
        inv = 1.0 / beta if beta > 0 else 0.0
        V.set(0, tmap(lambda rl: rl * inv, r))
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        k = 0
        res = beta
        while k < m and res > target:
            z = M(V.get(k))
            Z.set(k, z)
            w = op(z)
            # CGS(1|2) against V[0..k]: batched dots + one combination
            h = None
            for _ in range(max(1, cgs_passes)):
                hp = V.dots(k + 1, w)
                w = tsub(w, V.combine(k + 1, hp))
                h = hp if h is None else h + hp
            hk1 = tnorm(w)
            inv_h = torch.where(hk1 > 0, 1.0 / hk1, torch.zeros_like(hk1))
            V.set(k + 1, tmap(lambda wl: inv_h * wl, w))
            # the one host read of the iteration: the new Hessenberg column
            col = np.zeros(m + 1)
            col[: k + 2] = torch.cat([h, hk1.reshape(1)]).double().cpu().numpy()
            for j in range(k):  # previous Givens rotations
                a0, a1 = col[j], col[j + 1]
                col[j] = cs[j] * a0 + sn[j] * a1
                col[j + 1] = -sn[j] * a0 + cs[j] * a1
            a0, a1 = col[k], col[k + 1]
            denom = math.sqrt(a0 * a0 + a1 * a1)
            ck = a0 / denom if denom > 0 else 1.0
            sk = a1 / denom if denom > 0 else 0.0
            col[k] = denom
            col[k + 1] = 0.0
            cs[k], sn[k] = ck, sk
            gk = g[k]
            g[k] = ck * gk
            g[k + 1] = -sk * gk
            H[:, k] = col
            res = abs(g[k + 1])
            k += 1
        if k > 0:
            y = _back_substitute(H[:k, :k], g[:k])
            yd = torch.as_tensor(y, dtype=dtype).to(leaves(b)[0].device)
            x = tmap(lambda xl, ul: xl + ul, x, Z.combine(k, yd))
        return x, k

    x = x0
    r = tsub(b, op(x))
    res = float(tnorm(r))
    prev = math.inf
    it = 0
    while res > target and it < maxiter and res < stagnation * prev:
        x, k = inner_cycle(x, r, res)
        r = tsub(b, op(x))  # true residual at the restart boundary
        it += k
        prev, res = res, float(tnorm(r))
    return x, SolveInfo(it, res, res <= target, bnorm)
