"""Port vs reference: the whole explicit-halo step of the slice on the CPU.

FK at 32^2 with the bench solver preset and ``explicit_halo=True`` on the
4x2 mesh (8x16 blocks), in f64 plain precision so that the reference's
compile stays short.  The JAX package builds the state and takes one step
on its 8-virtual-device mesh; the state is bridged into the port, which
takes the same step on its in-process mesh:

- against the reference's explicit-halo step: velocities within 1e-6
  max|v| and grid / marker temperatures and marker positions within 1e-7
  (the bars of tests/test_torch_step.py for the single-device step), valid
  flags and materials equal, Krylov and CG counts within +-1;
- against the port's own single-device step from the same state: 1e-12
  relative (every halo body computes the global stencil's arithmetic on
  the same values, and the per-shard transfers visit the markers in the
  single-device order);
- the card's path on the CPU: an f32 state through the plain versions of
  the per-shard kernels and the mixed-precision solves, against the port's
  single-device f32 step: velocities within 1e-5 max|vy| and marker y
  within 1e-5 max|y| (chip_smoke.py's bars), materials equal, Krylov
  within +-2;
- the port's dryrun sub-checks (b) and (c) pass on the CPU;
- the distributed mesh (parallel/dist.py): eight gloo ranks take the f64
  step on 4x2 from the reference's initial state, each rank at the bars
  against the reference's step and bit for bit equal to the in-process
  mesh's step (the same state, the same diagnostics).
"""
import jax
import numpy as np
import pytest
import torch
import torch_dist_workers as W
from torch_helpers import jax_config, jax_state_dict

from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu.models.step import make_step as jax_make_step
from pylamp_tpu.parallel.mesh import make_mesh as j_make_mesh
from pylamp_tpu.parallel.mesh import shard_state, state_shardings
from pylamp_tpu_torch.bridge import state_from_numpy, state_to_numpy
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step
from pylamp_tpu_torch.parallel.dist import launch
from pylamp_tpu_torch.parallel.mesh import make_mesh

N = 32
CFG = W.fk_halo_config(N)


# The 8-rank world's deadline.  The step is ~3,500 message rounds on every
# rank (1,733 halo rounds, 1,760 all-gathers: two a shard body, the 8 ranks
# in lockstep), ~12 s a rank on an idle 8-core machine; beside the other
# workers of a 6-worker suite each round waits for ranks the scheduler has
# set aside, and the world ran past 60 s there.
DIST_DEADLINE_S = 180.0


@pytest.fixture(scope="module")
def reference():
    """The reference's initial state (path-keyed arrays) and its state and
    diagnostics after one f64 explicit-halo step on the 4x2 mesh."""
    import jax.numpy as jnp

    jcfg = jax_config(CFG)
    jgrid, jtable, st = jax_build(jcfg, dtype=jnp.float64)
    d0 = jax_state_dict(st)
    mesh = j_make_mesh(8)
    step = jax.jit(jax_make_step(jgrid, jcfg, jtable, mesh=mesh),
                   in_shardings=(state_shardings(mesh, st),))
    st, diag = step(shard_state(st, mesh))
    return d0, jax_state_dict(st), {k: np.asarray(v) for k, v in diag.items()}


@pytest.fixture(scope="module")
def port_f64(reference):
    d0, _, _ = reference
    grid, table, _ = build(CFG, dtype=torch.float64, device="cpu")
    st0 = state_from_numpy(d0, device="cpu")
    mesh_out = make_step(grid, CFG, table, mesh=make_mesh(8))(st0)
    single_out = make_step(grid, CFG, table)(st0)
    return mesh_out, single_out


def _holds_reference(ref, rdiag, st, diag):
    """A port state ``st`` (path-keyed numpy) and its diagnostics against
    the reference's step at this file's bars."""
    vmax = float(np.max(np.abs(ref["state.vx"])))
    for name in ("vx", "vy"):
        err = float(np.max(np.abs(st[f"state.{name}"]
                                  - ref[f"state.{name}"])))
        assert err <= 1e-6 * vmax, name
    for name in ("T", "markers.x", "markers.y", "markers.T"):
        err = float(np.max(np.abs(st[f"state.{name}"]
                                  - ref[f"state.{name}"])))
        assert err <= 1e-7, name
    for name in ("markers.valid", "markers.mat"):
        np.testing.assert_array_equal(st[f"state.{name}"],
                                      ref[f"state.{name}"])
    assert abs(diag["stokes_iterations"] - int(rdiag["stokes_iterations"])) <= 1
    assert abs(diag["energy_iterations"] - int(rdiag["energy_iterations"])) <= 1
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == int(rdiag["markers_dropped"]) == 0


def test_mesh_step_matches_reference(reference, port_f64):
    _, ref, rdiag = reference
    (st, diag), _ = port_f64
    _holds_reference(ref, rdiag, state_to_numpy(st), diag)


def test_mesh_step_matches_single_device(port_f64):
    (st, diag), (st1, diag1) = port_f64
    for name in ("vx", "vy", "p", "T", "eta_s", "eta_n"):
        a, b = getattr(st, name), getattr(st1, name)
        assert float(torch.max(torch.abs(a - b))) <= 1e-12 * float(
            torch.max(torch.abs(b))), name
    for name in ("x", "y", "T"):
        a, b = getattr(st.markers, name), getattr(st1.markers, name)
        assert float(torch.max(torch.abs(a - b))) <= 1e-12, name
    assert torch.equal(st.markers.valid, st1.markers.valid)
    assert diag["stokes_iterations"] == diag1["stokes_iterations"]


def test_dist_mesh_step(reference, port_f64):
    """Eight gloo ranks (``parallel/dist.py launch``, bounded by
    DIST_DEADLINE_S) take the step on the distributed 4x2 mesh from the
    reference's initial state: each rank's state holds the reference's
    step at this file's bars and equals the in-process mesh's bit for bit,
    with the same diagnostics, and ``replicas_agree`` holds on every rank.
    Prints each rank's seconds and message rounds for the step."""
    d0, ref, rdiag = reference
    (st_mesh, diag_mesh), _ = port_f64
    want = state_to_numpy(st_mesh)
    ranks = launch(8, W.mesh_step_rank, d0, N, 4, 2, device="cpu",
                   timeout_s=DIST_DEADLINE_S)
    for rank, (st, diag, agree, stats) in enumerate(ranks):
        print(f"rank {rank}: {stats}")
        assert agree, rank
        _holds_reference(ref, rdiag, st, diag)
        assert st.keys() == want.keys()
        for k, v in want.items():
            assert st[k].dtype == v.dtype, (rank, k)
            np.testing.assert_array_equal(st[k], v, err_msg=f"{rank} {k}")
        for k, v in diag_mesh.items():
            assert diag[k] == (v.item() if torch.is_tensor(v) else v), \
                (rank, k)


def test_mesh_step_f32(reference):
    """The card's path on the CPU (f32 state, mixed-precision solves,
    plain versions of the per-shard kernels)."""
    d0, _, _ = reference
    grid, table, _ = build(CFG, dtype=torch.float32, device="cpu")
    st0 = state_from_numpy(d0, device="cpu", dtype=torch.float32)
    st, diag = make_step(grid, CFG, table, mesh=make_mesh(8))(st0)
    st1, diag1 = make_step(grid, CFG, table)(st0)
    assert st.vx.dtype == torch.float32
    assert diag["stokes_converged"] and diag["stokes_residual_rel"] <= 1e-8
    assert int(diag["markers_dropped"]) == 0
    vmax = float(torch.max(torch.abs(st1.vy)))
    for name in ("vx", "vy"):
        err = float(torch.max(torch.abs(getattr(st, name)
                                        - getattr(st1, name))))
        assert err <= 1e-5 * vmax, name
    ymax = float(torch.max(torch.abs(st1.markers.y)))
    assert float(torch.max(torch.abs(st.markers.y - st1.markers.y))) \
        <= 1e-5 * ymax
    assert torch.equal(st.markers.mat, st1.markers.mat)
    assert abs(diag["stokes_iterations"] - diag1["stokes_iterations"]) <= 2


def test_dryrun_cpu(capsys):
    from pylamp_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(8, "cpu", checks="bc")
    assert "dryrun_multichip OK on cpu" in capsys.readouterr().out
    with pytest.raises(ValueError):  # (a) is the single-device step here
        dryrun_multichip(8, "cpu", checks="a")
