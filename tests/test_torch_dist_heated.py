"""The thermal path on the sharded layout, on the CPU: FK 32^2 in f64
with the four thermal switches (``models.profile.fk_heated_config``:
shear and adiabatic heating, subgrid diffusion, reseeding, here below 10
markers per cell so that every cell spawns) and ``explicit_halo=True`` on
the 4x2 mesh (8x16 blocks), with the Jacobi-CG energy solve and with the
energy multigrid and flexible CG:

- sharded against global: the in-process mesh's step on the sharded
  state (``shard_state``) against its step on the global state from the
  same built state: 1e-12 relative (the mesh dots sum in another order
  than ``torch.vdot``), the same Stokes and energy counts, valid flags,
  materials and marker count equal;
- the distributed mesh: eight gloo ranks (``parallel/dist.py launch``,
  bounded by DIST_DEADLINE_S) each take one step of each variant on their
  own blocks, from the same state, in one world: rank 0's gathered state
  equals the in-process sharded step's bit for bit in every leaf, every
  rank has its diagnostics, the replicated scalars and strips agree, no
  rank holds a piece of a leaf beyond its lattice's block or strip, and
  no block is all-gathered in the step.  Each rank's collectives are
  printed (``-s``).

The heated sharded step against the JAX package's is in
tests/test_torch_heated_step.py; the block forms in
tests/test_torch_sharded_state.py.  This file compiles no JAX step.
"""
import numpy as np
import pytest
import torch
import torch_dist_workers as W

from pylamp_tpu_torch.bridge import (
    sharded_from_numpy,
    sharded_to_numpy,
    state_to_numpy,
)
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.parallel.dist import launch
from pylamp_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)
N = 32
VARIANTS = ("jacobi", "mg")
# the world's deadline: the two heated steps are ~2,400 + ~2,700
# collectives on every rank, the 8 ranks in lockstep beside the other
# workers of a 6-worker suite (tests/test_torch_mesh_step.py)
DIST_DEADLINE_S = 180.0


@pytest.fixture(scope="module")
def steps():
    """The built state (path-keyed), and per variant the in-process 4x2
    mesh's step on the global and on the sharded layout: (global state,
    diagnostics, sharded state gathered as numpy, diagnostics)."""
    mesh = make_mesh(8)
    out = {}
    for pre in VARIANTS:
        cfg = W.fk_heated_halo_config(N, pre)
        grid, table, st0 = build(cfg, dtype=torch.float64, device="cpu")
        d0 = state_to_numpy(st0)
        step = make_step(grid, cfg, table, mesh=mesh)
        st_g, diag_g = step(st0)
        st_s, diag_s = step(sharded_from_numpy(d0, mesh, device="cpu"))
        out[pre] = (state_to_numpy(st_g), diag_g,
                    sharded_to_numpy(st_s, mesh), diag_s)
    return d0, out


@pytest.mark.parametrize("pre", VARIANTS)
def test_heated_sharded_matches_global(steps, pre):
    _, out = steps
    want, diag_g, got, diag_s = out[pre]
    for name in ("vx", "vy", "p", "T", "eta_s", "eta_n"):
        a, b = got[f"state.{name}"], want[f"state.{name}"]
        assert float(np.max(np.abs(a - b))) <= 1e-12 * float(
            np.max(np.abs(b))), name
    for name in ("x", "y", "T"):
        a, b = got[f"state.markers.{name}"], want[f"state.markers.{name}"]
        assert float(np.max(np.abs(a - b))) <= 1e-12, name
    for name in ("valid", "mat"):
        np.testing.assert_array_equal(got[f"state.markers.{name}"],
                                      want[f"state.markers.{name}"])
    for k in ("stokes_iterations", "energy_iterations", "marker_count"):
        assert int(diag_s[k]) == int(diag_g[k]), k
    assert diag_s["energy_converged"] and diag_s["stokes_converged"]
    # reseeding spawned: more valid markers than the count before it
    assert int(np.sum(got["state.markers.valid"])) > int(
        diag_s["marker_count"])


def test_dist_heated_steps(steps):
    """Eight gloo ranks, one world: the heated Jacobi-CG step, then the
    heated MG-FCG step, each from the built state on the rank's own
    blocks, bit for bit equal to the in-process sharded steps."""
    d0, out = steps
    ranks = launch(8, W.heated_step_rank, d0, N, 4, 2, device="cpu",
                   timeout_s=DIST_DEADLINE_S)
    for rank, by_pre in enumerate(ranks):
        for pre in VARIANTS:
            st, diag, agree, oversized, stats = by_pre[pre]
            print(f"rank {rank} {pre}: {stats}")
            _, _, want, diag_s = out[pre]
            assert agree, (rank, pre)
            assert oversized == {}, (rank, pre, oversized)
            assert stats["block"] == 0 and stats["p2p"] > 0, (rank, pre)
            if pre == "mg":
                assert stats["coarse"] > 0, rank
            for k, v in diag_s.items():
                assert diag[k] == (v.item() if torch.is_tensor(v) else v), \
                    (rank, pre, k)
            if rank:
                assert st is None
                continue
            assert st.keys() == want.keys()
            for k, v in want.items():
                assert st[k].dtype == v.dtype, (pre, k)
                np.testing.assert_array_equal(st[k], v, err_msg=f"{pre} {k}")
