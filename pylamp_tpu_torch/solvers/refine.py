"""Mixed-precision iterative refinement (port of
``pylamp_tpu/solvers/refine.py``).

    repeat:  r = b - A x      (one f64 operator application)
             solve A dx ~= r  (f32 inner solve, adaptive tolerance)
             x <- x + dx      (f64 accumulate)

``_norm_f32`` and the adaptive inner tolerance are kept exactly as in the
reference, so the refinement passes and the inner iteration counts match.
One host read per pass (the residual norm that gates the loop).  On
sharded vectors (``parallel/blocks.py``) ``_norm_f32`` is a mesh
reduction: the per-leaf scale a mesh maximum, the f32 sum of squares a
per-shard partial summed over the mesh.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from pylamp_tpu_torch.solvers.krylov import SolveInfo, leaves, tmap, tsub


def _cast(tree, dtype):
    return tmap(lambda l: l.to(dtype), tree)


def _norm_f32(tree):
    """||tree|| accumulated in f32 with per-leaf max pre-scaling (momentum
    entries reach ~1e15, whose squares overflow f32); returns an f64 0-d
    tensor."""
    from pylamp_tpu_torch.parallel.blocks import Blocks, dots

    total = 0.0
    for l in leaves(tree):
        amax = torch.max(torch.abs(l))
        s = torch.where(amax > 0, amax, torch.ones_like(amax))
        ln = (l * (1.0 / s)).to(torch.float32)
        if isinstance(ln, Blocks):
            sq = dots([(ln, ln)])[0].to(torch.float64)
        else:
            ln = ln.reshape(-1)
            sq = torch.vdot(ln, ln).to(torch.float64)
        total = total + sq * s * s
    return torch.sqrt(total)


def refine(op64: Callable, inner_solve32: Callable, b64: Any, x0_64: Any,
           tol: float = 1e-8, max_refinements: int = 6,
           inner_tol: float = 1e-4):
    """op64: f64 operator; inner_solve32(r32, tol32) -> (dx32, SolveInfo)
    solves A dx = r in f32 from zero to the relative tolerance tol32.
    Returns (x64, SolveInfo) with the inner iteration counts summed.

    The requested inner tolerance is adaptive: clip(0.3 target / res,
    inner_tol, 0.3), so the last pass is only as tight as needed."""
    bnorm = float(_norm_f32(b64))
    target = tol * bnorm

    x = x0_64
    r = tsub(b64, op64(x))
    res = float(_norm_f32(r))
    k = 0
    it = 0
    while res > target and k < max_refinements:
        rel = min(max(0.3 * target / res, inner_tol), 0.3)
        rel32 = float(torch.tensor(rel, dtype=torch.float32))
        dx32, info = inner_solve32(_cast(r, torch.float32), rel32)
        x = tmap(lambda xl, dl: xl + dl.to(torch.float64), x, dx32)
        r = tsub(b64, op64(x))
        res = float(_norm_f32(r))
        k += 1
        it += info.iterations
    return x, SolveInfo(it, res, res <= target, bnorm)
