"""State bridge: the flat path-keyed arrays of the JAX package's checkpoint
format (``pylamp_tpu/io/checkpoint.py``: ``state.markers.x``,
``state.vx``, ..., ``state.mg_lam``) to and from a port ``ModelState``.

An ``np.load`` of a pylamp_tpu checkpoint loads straight into the port
(``state_from_numpy(dict(np.load(path)), device)``); keys outside
``state.`` (the format version, ``extra.*``) are ignored.  The port's own
checkpoints (``io/checkpoint.py``) use the same names: this module holds
the one list of them.  A bucket state's markers carry ``valid``; a flat
state's (``markers/state.py MarkerState``) do not, and that is how
``state_from_leaves`` tells the two engines apart.
"""
from __future__ import annotations

import numpy as np
import torch

from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.markers.state import MarkerState
from pylamp_tpu_torch.models.state import ModelState

MARKER_FIELDS = ("x", "y", "mat", "T", "valid")
FLAT_MARKER_FIELDS = ("x", "y", "mat", "T")
GRID_FIELDS = ("vx", "vy", "p", "T", "eta_s", "eta_n", "time", "step", "dt",
               "mg_lam")


def state_leaves(state: ModelState) -> dict:
    """Every leaf of ``state`` by its checkpoint name (``state.<path>``);
    a ``mg_lam`` of None has no leaf, as in the reference's pytree."""
    names = (MARKER_FIELDS if isinstance(state.markers, BucketedMarkers)
             else FLAT_MARKER_FIELDS)
    out = {f"state.markers.{f}": getattr(state.markers, f) for f in names}
    for f in GRID_FIELDS:
        v = getattr(state, f)
        if v is not None:
            out[f"state.{f}"] = v
    return out


def state_from_leaves(leaves: dict) -> ModelState:
    """ModelState from tensors keyed by checkpoint name (``state_leaves``'s
    inverse); a missing ``state.mg_lam`` gives None, and markers without
    ``valid`` a flat ``MarkerState``."""
    if "state.markers.valid" in leaves:
        markers = BucketedMarkers(
            **{f: leaves[f"state.markers.{f}"] for f in MARKER_FIELDS})
    else:
        markers = MarkerState(
            **{f: leaves[f"state.markers.{f}"] for f in FLAT_MARKER_FIELDS})
    fields = {f: leaves[f"state.{f}"] for f in GRID_FIELDS
              if f"state.{f}" in leaves}
    fields.setdefault("mg_lam", None)
    return ModelState(markers=markers, **fields)


def state_from_numpy(d, device="cuda", dtype=None) -> ModelState:
    """ModelState from path-keyed numpy arrays on ``device`` (the card
    unless the caller asks for the CPU).  ``dtype`` (a floating
    torch dtype) casts the floating leaves; None keeps the arrays'
    dtypes.  Integer and boolean leaves keep theirs."""

    def leaf(key):
        a = torch.from_numpy(np.array(d[key]))
        if dtype is not None and a.is_floating_point():
            a = a.to(dtype)
        return a.to(device)

    names = [f"state.markers.{f}" for f in MARKER_FIELDS
             if f"state.markers.{f}" in d] + [
        f"state.{f}" for f in GRID_FIELDS if f"state.{f}" in d]
    return state_from_leaves({k: leaf(k) for k in names})


def state_to_numpy(state: ModelState) -> dict:
    """Path-keyed numpy arrays of every leaf (the checkpoint's names)."""
    return {k: v.detach().cpu().numpy()
            for k, v in state_leaves(state).items()}


def sharded_from_numpy(d, mesh, device="cuda", dtype=None) -> ModelState:
    """``state_from_numpy`` into the sharded layout of ``mesh``: the
    arrays stay on the host and only this process's blocks move to
    ``device`` (``parallel/mesh.py shard_state``)."""
    from pylamp_tpu_torch.parallel.mesh import shard_state

    return shard_state(state_from_numpy(d, device="cpu", dtype=dtype), mesh,
                       device=device)


def sharded_to_numpy(state: ModelState, mesh, root=None):
    """``state_to_numpy`` of a sharded state: gathered (one collective a
    field under a distributed mesh), on rank ``root`` only where one is
    named (None elsewhere)."""
    from pylamp_tpu_torch.parallel.mesh import unshard_state

    full = unshard_state(state, mesh, root=root)
    return None if full is None else state_to_numpy(full)


def oversized_leaves(state: ModelState, grid, mesh) -> dict:
    """The leaves of a sharded ``state`` that hold more than this
    process's part of their lattice, ``{name: (elements held, bound)}``
    (empty where the layout is right).  Each piece is bounded by its own
    lattice's piece (``parallel/blocks.py``) of a ``grid.ny x grid.nx``
    grid's blocks on ``mesh``: I by*bx, R by, B bx, C 1 node, times the
    process's local shards and a marker stream's K; a leaf that is not
    sharded may be a scalar or a vector (the per-level MG bounds), never
    a field."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    by, bx = grid.ny // mesh.my, grid.nx // mesh.mx
    ly, lx = mesh.local_shape
    nodes = {"I": by * bx, "R": by, "B": bx, "C": 1}
    out = {}
    for k, v in state_leaves(state).items():
        if not isinstance(v, Blocks):
            if v.dim() > 1:
                out[k] = (v.numel(), 0)
            continue
        trail = 1
        for d in v.I.shape[4:]:
            trail *= d
        for n, piece in v.pieces().items():
            bound = ly * lx * nodes[n] * trail
            if piece.numel() > bound:
                out[f"{k}.{n}"] = (piece.numel(), bound)
    return out
