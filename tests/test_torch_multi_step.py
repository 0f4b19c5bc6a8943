"""The chunked multi-step time loop on the CPU: ``models/step.py
make_multi_step`` and ``models/driver.py run_model(scan_chunk=N)`` (``run
--scan N``), held to the per-step loop bit for bit and to the reference's
chunk semantics (``pylamp_tpu/models/driver.py:191-277``): the loop
condition checked between chunks only, outputs where ``step % every <
chunk``, the whole chunk rerun with the stronger solver on divergence.

One run is held against the JAX package's ``run_model(scan_chunk=2)`` on
the same configuration in f64 (one compile for the module): the same
files, its metrics lines, dumps and checkpoint at
``tests/test_torch_driver.py``'s bars.  The port writes each step's
``time`` as its per-step loop does (the state's dtype) where the
reference sums the chunk's dt in f64 on the host, and its per-step loop's
drop warning (none is written here): ROADMAP queue 3, port-only.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch_helpers import (
    assert_metrics_close,
    assert_outputs_close,
    jax_config,
)

from pylamp_tpu_torch import cli
from pylamp_tpu_torch.bridge import state_leaves
from pylamp_tpu_torch.models.benchmarks import falling_block
from pylamp_tpu_torch.models.config import SolverConfig
from pylamp_tpu_torch.models.driver import run_model
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_multi_step, make_step
from pylamp_tpu_torch.parallel.mesh import make_mesh

CFG = falling_block(nx=12, ny=12, max_steps=4)
KW = dict(dtype=torch.float64, device="cpu")
# the records' clocks
WALL = ("step_wall_s", "wall_s")
# the cadence run: max_steps 5 at chunk 2 (6 steps), fields every 3 steps,
# a checkpoint every 4
CADENCE = dataclasses.replace(CFG, time=dataclasses.replace(CFG.time,
                                                            max_steps=5))
CADENCE_OUT = dict(scan_chunk=2, output_every=3, checkpoint_every=4)
V_TOL = 1e-6  # of max|v|
X_TOL = 1e-7  # T and marker positions (unit box)


def _lines(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _clockless(out):
    lines = _lines(out)
    for r in lines:
        for k in WALL:
            r.pop(k)
    return lines


@pytest.fixture(scope="module")
def cadence(tmp_path_factory):
    """The port's chunked CADENCE run: (out dir, final state, diags, the
    steps the callback saw)."""
    out, seen = str(tmp_path_factory.mktemp("port")), []
    state, diags, _ = run_model(
        CADENCE, out_dir=out, callback=lambda st, d: seen.append(int(st.step)),
        **CADENCE_OUT, **KW)
    return out, state, diags, seen


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's chunked CADENCE run in f64: its out dir."""
    from pylamp_tpu.models.driver import run_model as jax_run_model

    out = str(tmp_path_factory.mktemp("jax"))
    jax_run_model(jax_config(CADENCE), out_dir=out, **CADENCE_OUT)
    return out


def _assert_states_equal(a, b):
    a, b = state_leaves(a), state_leaves(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_multi_step_equals_single_steps():
    """n_steps steps in one call: the state of n single steps bit for bit,
    every diag value stacked (n,), row i the value step i returned."""
    grid, table, state = build(CFG, **KW)
    step = make_step(grid, CFG, table)
    st, diags = state, []
    for _ in range(3):
        st, d = step(st)
        diags.append(d)
    got, stacked = make_multi_step(grid, CFG, table, 3)(state)
    _assert_states_equal(st, got)
    assert sorted(stacked) == sorted(diags[0])
    for k, v in stacked.items():
        assert tuple(v.shape) == (3,), k
        for i, d in enumerate(diags):
            if torch.is_tensor(v):
                assert torch.equal(v[i], d[k]), k
            else:
                assert v[i].item() == d[k] and type(v[i].item()) is type(d[k]), k


def test_scanned_run_equals_per_step_run(tmp_path):
    """run_model(scan_chunk=2) against the per-step loop over 4 steps: the
    final checkpoint in every leaf and each metrics line in every key but
    the clocks, as the per-step loop writes them."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    sa, da, _ = run_model(CFG, out_dir=a, checkpoint_every=4, **KW)
    sb, db, _ = run_model(CFG, out_dir=b, checkpoint_every=4, scan_chunk=2,
                          **KW)
    _assert_states_equal(sa, sb)
    ca, cb = (_npz(os.path.join(d, "checkpoint.npz")) for d in (a, b))
    assert sorted(ca) == sorted(cb)
    for k, v in ca.items():
        np.testing.assert_array_equal(cb[k], v, err_msg=k)
    la, lb = _clockless(a), _clockless(b)
    assert len(la) == len(lb) == len(da) == len(db) == 4
    for ra, rb in zip(la, lb):
        assert json.dumps(ra) == json.dumps(rb)


def test_scan_overshoot_and_output_cadence(cadence):
    """max_steps 5 at chunk 2 runs 6 steps (the loop condition is read
    between chunks); outputs land where step % every < chunk: fields at
    4 and 6 for every 3, the checkpoint at 4 for every 4; the callback
    once per chunk."""
    out, state, diags, seen = cadence
    assert int(state.step) == 6 and len(diags) == 6
    assert [r["step"] for r in _lines(out)] == [1, 2, 3, 4, 5, 6]
    assert seen == [2, 4, 6]
    assert sorted(f for f in os.listdir(out) if f.startswith("fields_")) \
        == ["fields_000004.npz", "fields_000006.npz"]
    assert int(_npz(os.path.join(out, "checkpoint.npz"))["state.step"]) == 4


def test_scanned_run_matches_reference(cadence, reference):
    """The cadence run against the JAX package's: the same files, each
    metrics line at the driver's bars (no warning in either), the dumps at
    steps 4 and 6 and the step-4 checkpoint at the step's bars."""
    out = cadence[0]
    assert sorted(os.listdir(out)) == sorted(os.listdir(reference))
    assert_metrics_close(_clockless(reference), _clockless(out), V_TOL)
    for name in ("fields_000004.npz", "fields_000006.npz", "checkpoint.npz"):
        which = "checkpoint" if name == "checkpoint.npz" else "fields"
        assert_outputs_close(_npz(os.path.join(reference, name)),
                             _npz(os.path.join(out, name)), which, V_TOL,
                             X_TOL)


def test_scan_divergence_reruns_chunk(tmp_path):
    """A starved solver fails the chunk; the whole chunk reruns with 4x
    maxiter and 2x restart (no per-step ``retried`` key, as the
    reference's scanned loop) and every step converges."""
    cfg = dataclasses.replace(
        falling_block(nx=12, ny=12, max_steps=2),
        solver=SolverConfig(preconditioner="mg", stokes_maxiter=5,
                            stokes_restart=5))
    out = str(tmp_path)
    state, diags, _ = run_model(cfg, out_dir=out, scan_chunk=2, **KW)
    assert int(state.step) == 2
    lines = _lines(out)
    assert len(lines) == 2
    for r in lines:
        assert r["stokes_converged"] and r["stokes_iterations"] > 5
        assert "retried" not in r and "warning" not in r


def test_scan_on_mesh(tmp_path):
    """Two steps on the in-process 4x2 mesh in one chunk: the records carry
    the mesh tag, the state equals two mesh steps bit for bit."""
    cfg = dataclasses.replace(
        falling_block(nx=16, ny=16, max_steps=2),
        solver=dataclasses.replace(CFG.solver, explicit_halo=True))
    mesh = make_mesh(8)
    state, _, _ = run_model(cfg, out_dir=str(tmp_path), scan_chunk=2,
                            mesh=mesh, **KW)
    assert [r["mesh"] for r in _lines(str(tmp_path))] == ["4x2", "4x2"]
    grid, table, st = build(cfg, **KW)
    step = make_step(grid, cfg, table, mesh=mesh)
    for _ in range(2):
        st, _ = step(st)
    _assert_states_equal(st, state)


def test_cli_scan(tmp_path):
    out = str(tmp_path)
    assert cli.main(["run", "falling_block", "--nx", "12", "--steps", "2",
                     "--scan", "2", "--x64", "--device", "cpu", "--out", out,
                     "--checkpoint-every", "2"]) == 0
    assert [r["step"] for r in _lines(out)] == [1, 2]
    assert int(_npz(os.path.join(out, "checkpoint.npz"))["state.step"]) == 2
