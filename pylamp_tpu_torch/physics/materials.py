"""Material tables and marker rheology.

Port of ``pylamp_tpu/physics/materials.py``: markers carry (material id,
T); a MaterialTable maps id -> parameters, and density / viscosity /
conductivity / rho*Cp / heating are evaluated on markers each step.

Viscosity laws: "constant" (eta0), "frank_kamenetskii"
(eta0 exp(-gamma (T - T_ref))), "arrhenius"
(eta0 exp(E/(R T) - E/(R T_ref))).  Density: Boussinesq
rho0 (1 - alpha (T - T_ref)).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

R_GAS = 8.314462618  # J / (mol K)

CONSTANT = "constant"
FRANK_KAMENETSKII = "frank_kamenetskii"
ARRHENIUS = "arrhenius"
LAW_CODE = {CONSTANT: 0, FRANK_KAMENETSKII: 1, ARRHENIUS: 2}


@dataclasses.dataclass(frozen=True)
class Material:
    """One material's parameters (SI or non-dimensional, caller's choice)."""

    name: str = "mat"
    rho0: float = 3300.0
    alpha: float = 0.0
    T_ref: float = 0.0
    eta0: float = 1e21
    viscosity: str = CONSTANT
    fk_gamma: float = 0.0
    E_act: float = 0.0
    k: float = 3.0
    cp: float = 1000.0
    H: float = 0.0


class MaterialTable:
    """Per-material parameter columns (host numpy) with a branch-free
    id -> value select for marker tensors."""

    def __init__(self, materials: Sequence[Material]):
        self.materials = tuple(materials)

        def get(f):
            return np.array([getattr(m, f) for m in materials])

        self.rho0 = get("rho0")
        self.alpha = get("alpha")
        self.T_ref = get("T_ref")
        self.eta0 = get("eta0")
        self.fk_gamma = get("fk_gamma")
        self.E_act = get("E_act")
        self.k = get("k")
        self.cp = get("cp")
        self.H = get("H")
        for m in materials:
            if m.viscosity not in LAW_CODE:
                raise ValueError(f"unknown viscosity law {m.viscosity!r}")
        self.law = np.array([LAW_CODE[m.viscosity] for m in materials])

    def __len__(self):
        return len(self.materials)

    def _select(self, vals, mat_id, dtype):
        """id -> per-material value as a select chain (uniform columns
        collapse to a constant), like the reference."""
        v = np.asarray(vals)
        out = torch.full_like(mat_id, float(v[0]), dtype=dtype)
        for m in range(1, len(v)):
            if v[m] != v[0]:
                out = torch.where(mat_id == m,
                                  torch.tensor(float(v[m]), dtype=dtype,
                                               device=mat_id.device), out)
        return out

    def density(self, mat_id, T):
        rho0 = self._select(self.rho0, mat_id, T.dtype)
        alpha = self._select(self.alpha, mat_id, T.dtype)
        T_ref = self._select(self.T_ref, mat_id, T.dtype)
        return rho0 * (1.0 - alpha * (T - T_ref))

    def viscosity_of(self, mat_id, T):
        eta0 = self._select(self.eta0, mat_id, T.dtype)
        T_ref = self._select(self.T_ref, mat_id, T.dtype)
        present = set(int(c) for c in self.law)
        eta = eta0
        if 1 in present:
            gamma = self._select(self.fk_gamma, mat_id, T.dtype)
            eta_fk = eta0 * torch.exp(-gamma * (T - T_ref))
            law = self._select(self.law, mat_id, torch.int32)
            eta = torch.where(law == 1, eta_fk, eta)
        if 2 in present:
            E = self._select(self.E_act, mat_id, T.dtype)
            T_safe = torch.clamp(T, min=1e-30)
            Tr_safe = torch.clamp(T_ref, min=1e-30)
            eta_arr = eta0 * torch.exp(E / (R_GAS * T_safe)
                                       - E / (R_GAS * Tr_safe))
            law = self._select(self.law, mat_id, torch.int32)
            eta = torch.where(law == 2, eta_arr, eta)
        return eta

    def conductivity(self, mat_id, dtype):
        return self._select(self.k, mat_id, dtype)

    def rho_cp(self, mat_id, T):
        rho0 = self._select(self.rho0, mat_id, T.dtype)
        cp = self._select(self.cp, mat_id, T.dtype)
        return rho0 * cp

    def heating(self, mat_id, dtype):
        return self._select(self.H, mat_id, dtype)
