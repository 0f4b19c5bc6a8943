"""Shared helpers of the port's CPU tests: pylamp_tpu_torch (PyTorch)
against pylamp_tpu (JAX, the reference) on the same numpy inputs.

Importing this module runs torch on one intra-op thread.  All cores per
worker would slow the 6-worker tier-1 run, and a second thread made the
1e-12 parity tests flaky: in about one full tier-1 run in ten, the first
vectorized exp that torch's second OpenMP thread ran in a worker returned
values up to ~1e-9 off (the half of a (20, 24, 18) marker array that
thread computed; an immediate rerun in the same process was exact).
"""
import dataclasses

import jax
import numpy as np
import torch

from pylamp_tpu.core import bc as jbc
from pylamp_tpu.io.checkpoint import _path_str
from pylamp_tpu.models import config as jconfig
from pylamp_tpu.physics.materials import Material as JMaterial

torch.set_num_threads(1)


def fields(dc) -> dict:
    """Shallow field dict of a dataclass instance."""
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def jax_vbcs(vbc):
    return jbc.VelocityBCs(**fields(vbc))


def jax_tbcs(tbc):
    return jbc.ThermalBCs(**{w: jbc.ThermalBC(**fields(getattr(tbc, w)))
                             for w in ("top", "bottom", "left", "right")})


def jax_config(cfg):
    """The JAX package's ModelConfig with the same values as a port
    ModelConfig (the two share field names)."""
    phys = fields(cfg.physics)
    phys["materials"] = tuple(JMaterial(**fields(m)) for m in phys["materials"])
    phys["velocity_bcs"] = jax_vbcs(cfg.physics.velocity_bcs)
    phys["thermal_bcs"] = jax_tbcs(cfg.physics.thermal_bcs)
    top = fields(cfg)
    top.update(physics=jconfig.PhysicsConfig(**phys),
               solver=jconfig.SolverConfig(**fields(cfg.solver)),
               time=jconfig.TimeConfig(**fields(cfg.time)))
    return jconfig.ModelConfig(**top)


def jax_state_dict(state) -> dict:
    """Flat path-keyed numpy leaves of a JAX ModelState (the checkpoint
    format's names)."""
    return {f"state.{_path_str(p)}": np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


def t(a, dtype=None):
    """numpy / JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(a)).to(dtype=dtype)


def rel(got, ref) -> float:
    """max |got - ref| / max |ref| in f64."""
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.max(np.abs(ref))
    return float(np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0))
