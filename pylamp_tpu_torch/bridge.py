"""State bridge: the flat path-keyed arrays of the JAX package's checkpoint
format (``pylamp_tpu/io/checkpoint.py``: ``state.markers.x``,
``state.vx``, ..., ``state.mg_lam``) to and from a port ``ModelState``.

An ``np.load`` of a pylamp_tpu checkpoint loads straight into the port
(``state_from_numpy(dict(np.load(path)), device)``); keys outside
``state.`` (the format version, ``extra.*``) are ignored.  The port's own
checkpoints (``io/checkpoint.py``) use the same names: this module holds
the one list of them.
"""
from __future__ import annotations

import numpy as np
import torch

from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.models.state import ModelState

MARKER_FIELDS = ("x", "y", "mat", "T", "valid")
GRID_FIELDS = ("vx", "vy", "p", "T", "eta_s", "eta_n", "time", "step", "dt",
               "mg_lam")


def state_leaves(state: ModelState) -> dict:
    """Every leaf of ``state`` by its checkpoint name (``state.<path>``);
    a ``mg_lam`` of None has no leaf, as in the reference's pytree."""
    out = {f"state.markers.{f}": getattr(state.markers, f)
           for f in MARKER_FIELDS}
    for f in GRID_FIELDS:
        v = getattr(state, f)
        if v is not None:
            out[f"state.{f}"] = v
    return out


def state_from_leaves(leaves: dict) -> ModelState:
    """ModelState from tensors keyed by checkpoint name (``state_leaves``'s
    inverse); a missing ``state.mg_lam`` gives None."""
    markers = BucketedMarkers(
        **{f: leaves[f"state.markers.{f}"] for f in MARKER_FIELDS})
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

    names = [f"state.markers.{f}" for f in MARKER_FIELDS] + [
        f"state.{f}" for f in GRID_FIELDS if f"state.{f}" in d]
    return state_from_leaves({k: leaf(k) for k in names})


def state_to_numpy(state: ModelState) -> dict:
    """Path-keyed numpy arrays of every leaf (the checkpoint's names)."""
    return {k: v.detach().cpu().numpy()
            for k, v in state_leaves(state).items()}
