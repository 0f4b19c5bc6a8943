"""Batched parameter sweeps (port of ``pylamp_tpu/models/sweep.py``).

A sweep advances a batch of independent models one step at a time: a
Rayleigh-number study, say.  The grid, the configuration (BCs, solver,
time control), the material count and the viscosity laws are shared; the
numeric material parameters (``NUMERIC_FIELDS``) and the whole model state
vary per member.

The members run in turn, each through its own ``make_step`` (built once,
in ``make_sweep_step``) on its own slice of the stacked state, with its
kernels where its solo step would run them.  The port's Krylov loops read
the host once per iteration, so ``torch.func.vmap`` cannot batch the step;
each member therefore stops at its own convergence, and member ``i``
equals its solo step from the same state bit for bit, Krylov counts
included.

``params`` stay on the host: ``MaterialTable`` and kernel 2's wrapper read
the numeric fields as numpy, so a step costs no device read for them, and
a change to ``params`` between calls steers the next step.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from pylamp_tpu_torch.bridge import state_from_leaves, state_leaves
from pylamp_tpu_torch.models.step import make_step, stack_diags
from pylamp_tpu_torch.physics.materials import MaterialTable

# the per-material numeric parameters that may vary across the sweep
NUMERIC_FIELDS = (
    "rho0", "alpha", "T_ref", "eta0", "fk_gamma", "E_act", "k", "cp", "H",
)


def _table_shim(table: MaterialTable, params: dict, i: int) -> MaterialTable:
    """``table`` (a copy of the sweep's first table: its materials and
    laws) with its numeric fields set to ``params`` row ``i``, numpy views
    of the host tensors.  Returns ``table``."""
    for f in NUMERIC_FIELDS:
        setattr(table, f, params[f][i].numpy())
    return table


def stack_tables(tables: Sequence[MaterialTable]) -> dict:
    """Stack per-model material tables into ``{field: (B, n_materials)}``
    host float64 tensors (the sweep's parameters)."""
    base = tables[0]
    for t in tables[1:]:
        if len(t) != len(base):
            raise ValueError("all sweep members must have the same number of materials")
        if list(t.law) != list(base.law):
            raise ValueError("all sweep members must share the same viscosity laws")
    return {
        f: torch.stack([torch.from_numpy(np.asarray(getattr(t, f),
                                                    np.float64))
                        for t in tables])
        for f in NUMERIC_FIELDS
    }


def stack_states(states):
    """Stack per-model ModelStates leaf by leaf (``bridge.state_leaves``:
    the checkpoint's leaves, either marker engine, ``mg_lam`` when it is
    not None) along a new leading batch axis."""
    leaves = [state_leaves(s) for s in states]
    return state_from_leaves(
        {k: torch.stack([lv[k] for lv in leaves]) for k in leaves[0]})


def unstack_state(batched, i: int):
    """Member ``i`` of a batched state, every leaf a view of row ``i``
    (contiguous, as the kernels' wrappers require; the step writes into
    none of its input's leaves)."""
    return state_from_leaves(
        {k: v[i] for k, v in state_leaves(batched).items()})


def make_sweep_step(grid, cfg, tables: Sequence[MaterialTable]):
    """Build ``(batched_step, params)``.

    ``batched_step(state_batch, params) -> (state_batch, diag_batch)``
    advances every member one step: member ``i`` runs its own step on
    ``unstack_state(state_batch, i)`` with the material table of
    ``params`` row ``i`` as the call finds it.  Pass ``params`` back each
    call, or change it to steer the sweep.  Every state leaf and diag value
    gains a leading batch axis of size ``len(tables)`` (diag values as
    ``models/step.py stack_diags`` stacks them).  A member's exception ends
    the call; a member that does not converge reports
    ``stokes_converged=False`` in its row."""
    params = stack_tables(tables)
    shims = [_table_shim(copy.copy(tables[0]), params, i)
             for i in range(len(tables))]
    steps = [make_step(grid, cfg, shim) for shim in shims]

    def batched_step(state_batch, params):
        states, diags = [], []
        for i, (shim, step) in enumerate(zip(shims, steps)):
            _table_shim(shim, params, i)
            st, diag = step(unstack_state(state_batch, i))
            states.append(st)
            diags.append(diag)
        return stack_states(states), stack_diags(diags)

    return batched_step, params
