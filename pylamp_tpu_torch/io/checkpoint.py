"""Versioned checkpoint / exact resume of the full model state (port of
``pylamp_tpu/io/checkpoint.py``).

One ``.npz`` per checkpoint, in the reference's format: leaves keyed
``state.<path>`` (the names of ``bridge.py``), ``extra.<key>`` beside
them, ``__format_version__`` 2.  A checkpoint written by either package
loads in the other.  Resume is bitwise-exact: the step carries nothing
between calls outside the ModelState."""
from __future__ import annotations

import os

import numpy as np
import torch

from pylamp_tpu_torch.bridge import (
    state_from_leaves,
    state_leaves,
    state_to_numpy,
)

FORMAT_VERSION = 2

# Leaves added after a format was in the wild: absent in old checkpoints,
# filled from the template (zeros = "recompute") instead of erroring.
_OPTIONAL_LEAVES = {"state.mg_lam"}


def save_checkpoint(path: str, state, extra: dict | None = None):
    payload = {"__format_version__": FORMAT_VERSION, **state_to_numpy(state)}
    for k, v in (extra or {}).items():
        payload[f"extra.{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def load_checkpoint(path: str, template):
    """Fill ``template`` (a ModelState of the right structure, e.g. freshly
    built from the same config) with the checkpointed leaves, each cast to
    the template leaf's dtype and placed on its device.  Keys the template
    lacks are ignored.

    Returns (state, extra dict)."""
    with np.load(path) as z:
        version = int(z["__format_version__"])
        if version > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than supported")

        leaves = {}
        for key, leaf in state_leaves(template).items():
            if key not in z and key in _OPTIONAL_LEAVES:
                leaves[key] = leaf
                continue
            if key not in z:
                raise KeyError(
                    f"checkpoint is missing leaf {key!r} — was it written with a "
                    f"different marker engine or model configuration?"
                )
            arr = z[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {arr.shape}, expected "
                    f"{tuple(leaf.shape)}"
                )
            leaves[key] = torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype)
        extra = {k[len("extra."):]: z[k] for k in z.files if k.startswith("extra.")}
    return state_from_leaves(leaves), extra
