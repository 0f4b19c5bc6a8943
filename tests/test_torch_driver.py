"""Port vs reference: the time-loop driver (``models/driver.py run_model``)
on the CPU.

- The slice as a whole: the JAX package's ``run_model`` and the port's on
  ``falling_block(16)`` in f64, 2 steps, with a checkpoint and a field
  dump at step 2.  The metrics lines hold the same keys; step, time, dt,
  vrms and vmax agree within ``tests/test_torch_step.py``'s bars
  (velocities 1e-6 of max|v|, T and marker positions 1e-7, Krylov +-1),
  and so do the fields npz and the checkpoint.
- The driver's own behaviour, port alone: the divergence retry (the twin
  of ``tests/test_driver.py::test_divergence_retry_and_metrics``), exact
  resume bit for bit (the twin of ``tests/test_checkpoint.py::
  test_exact_resume`` with the MG preconditioner, and the same through
  ``run_model`` with the phased runner between), the mesh tag, the
  refusal of scan_chunk with profile_phases, and that the run surface
  imports no JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_helpers import (
    assert_metrics_close,
    assert_outputs_close,
    jax_config,
)

from pylamp_tpu_torch.bridge import state_leaves
from pylamp_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pylamp_tpu_torch.models.benchmarks import falling_block
from pylamp_tpu_torch.models.config import SolverConfig
from pylamp_tpu_torch.models.driver import run_model
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import TIMED_PHASES, make_step
from pylamp_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
STEPS = 2
CFG = falling_block(nx=N, ny=N, max_steps=STEPS)
V_TOL = 1e-6  # of max|v|
X_TOL = 1e-7  # T and marker positions (unit box)


def _lines(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _run_both(run, out, **kw):
    run(out_dir=out, checkpoint_every=STEPS, output_every=STEPS, **kw)
    return (_lines(out), _npz(os.path.join(out, f"fields_{STEPS:06d}.npz")),
            _npz(os.path.join(out, "checkpoint.npz")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port): metrics lines, fields npz and checkpoint of each
    package's run_model on CFG in f64."""
    from pylamp_tpu.models.driver import run_model as jax_run_model

    jcfg = jax_config(CFG)
    ref = _run_both(lambda **kw: jax_run_model(jcfg, **kw),
                    str(tmp_path_factory.mktemp("jax")))
    port = _run_both(lambda **kw: run_model(CFG, dtype=torch.float64,
                                            device="cpu", **kw),
                     str(tmp_path_factory.mktemp("port")))
    return ref, port


def test_metrics_lines_match_reference(runs):
    (ref, _, _), (got, _, _) = runs
    assert len(ref) == STEPS
    assert_metrics_close(ref, got, V_TOL)


@pytest.mark.parametrize("which", ["fields", "checkpoint"])
def test_outputs_match_reference(runs, which):
    i = 1 if which == "fields" else 2
    assert_outputs_close(runs[0][i], runs[1][i], which, V_TOL, X_TOL)


def test_divergence_retry_and_metrics(tmp_path):
    cfg = falling_block(nx=12, ny=12, max_steps=2)
    # deliberately starve the solver so every step fails first; the 4x
    # retry budget is enough for the MG-preconditioned solve
    cfg = dataclasses.replace(
        cfg, solver=SolverConfig(preconditioner="mg", stokes_maxiter=5,
                                 stokes_restart=5)
    )
    out = str(tmp_path)
    state, diags, grid = run_model(cfg, out_dir=out, dtype=torch.float64,
                                   device="cpu")
    assert int(state.step) == 2
    assert all(bool(d.get("retried", False)) for d in diags)
    assert all(bool(d["stokes_converged"]) for d in diags)

    lines = _lines(out)
    assert len(lines) == 2
    rec = lines[-1]
    assert rec["step"] == 2 and "vrms" in rec and "dt" in rec
    assert rec["retried"] is True and "warning" not in rec


def test_exact_resume(tmp_path):
    cfg = falling_block(nx=12, ny=12)
    cfg = dataclasses.replace(cfg, solver=SolverConfig(preconditioner="mg",
                                                        stokes_restart=60))
    grid, table, state = build(cfg, dtype=torch.float64, device="cpu")
    step = make_step(grid, cfg, table)

    # run 2 steps, checkpoint, run 2 more
    for _ in range(2):
        state, _ = step(state)
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, state, extra={"note": 1})
    cont = state
    for _ in range(2):
        cont, _ = step(cont)

    # resume from checkpoint and run the same 2 steps (template = a fresh
    # build of the same config, as the driver does)
    _, _, template = build(cfg, dtype=torch.float64, device="cpu")
    resumed, extra = load_checkpoint(ckpt, template=template)
    assert int(extra["note"]) == 1
    for _ in range(2):
        resumed, _ = step(resumed)

    a, b = state_leaves(cont), state_leaves(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_resume_through_run_model(tmp_path, dtype):
    """chip_smoke.py's cli_paths on the CPU: 4 plain steps (A) against 2
    phased steps, a checkpoint and 2 resumed steps (B, C); every leaf of
    C's checkpoint equals A's bit for bit, and the phased runner reports
    the four phases."""
    cfg = dataclasses.replace(CFG, time=dataclasses.replace(CFG.time,
                                                            max_steps=4))
    kw = dict(dtype=getattr(torch, dtype), device="cpu")
    a, b, c = (str(tmp_path / d) for d in "ABC")
    run_model(cfg, out_dir=a, checkpoint_every=4, **kw)
    half = dataclasses.replace(cfg, time=dataclasses.replace(cfg.time,
                                                             max_steps=2))
    _, diags, _ = run_model(half, out_dir=b, checkpoint_every=2,
                            profile_phases=True, **kw)
    assert all(sorted(d["phase_seconds"]) == sorted(TIMED_PHASES)
               for d in diags)
    run_model(cfg, out_dir=c, checkpoint_every=4,
              resume_from=os.path.join(b, "checkpoint.npz"), **kw)
    ca, cc = (_npz(os.path.join(d, "checkpoint.npz")) for d in (a, c))
    assert sorted(ca) == sorted(cc)
    for k, v in ca.items():
        np.testing.assert_array_equal(cc[k], v, err_msg=k)
    assert int(cc["state.step"]) == 4
    assert [r["step"] for r in _lines(c)] == [3, 4]
    assert all("phase_seconds" in r for r in _lines(b))


def test_mesh_tag(tmp_path):
    cfg = dataclasses.replace(CFG, time=dataclasses.replace(CFG.time,
                                                            max_steps=1),
                              solver=dataclasses.replace(
                                  CFG.solver, explicit_halo=True))
    mesh = make_mesh(8)
    run_model(cfg, out_dir=str(tmp_path), dtype=torch.float64, device="cpu",
              mesh=mesh)
    (rec,) = _lines(str(tmp_path))
    assert rec["mesh"] == "4x2" and rec["stokes_converged"]
    with pytest.raises(ValueError, match="single-device only"):
        run_model(cfg, device="cpu", mesh=mesh, profile_phases=True)


def test_scan_chunk_refused():
    """scan_chunk runs (tests/test_torch_multi_step.py), but not with the
    per-phase profiler, as in the reference."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_model(CFG, device="cpu", scan_chunk=2, profile_phases=True)


def test_run_surface_imports_no_jax():
    code = (
        "import sys\n"
        "import pylamp_tpu_torch.cli, pylamp_tpu_torch.models.driver\n"
        "import pylamp_tpu_torch.io.checkpoint, pylamp_tpu_torch.io.output\n"
        "import pylamp_tpu_torch.io.logging, pylamp_tpu_torch.utils.profiling\n"
        "import pylamp_tpu_torch.utils.artifacts\n"
        "import pylamp_tpu_torch.models.sweep\n"
        "import pylamp_tpu_torch.parallel.dist\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_dist_workers\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pylamp_tpu' or m.startswith('pylamp_tpu.')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env={**os.environ, "OMP_NUM_THREADS": "1"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
