"""The port's command line (``python -m pylamp_tpu_torch``).

- Twins of ``tests/test_cli.py``'s wiring tests with a monkeypatched
  ``run_model``: the default is an f32 state on the card, ``--x64`` gives
  f64, ``--mesh 2x4`` sets the explicit halo and coarse replication 16,
  ``--no-explicit-halo`` opts out; ``run_model``'s own default is f64.
- ``list`` gives the reference's six names; ``run`` refuses a machine
  without CUDA unless ``--device cpu`` is given; ``bench`` is refused
  without importing JAX.
- The twin of ``tests/test_fault_injection.py`` at 16^2, ``--x64 --device
  cpu``: a run SIGKILLed after its step-3 checkpoint and resumed ends
  where the uninterrupted run does (every checkpoint leaf to 1e-12).
"""
import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import pylamp_tpu_torch.models.driver as driver_mod
from pylamp_tpu_torch.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one torch thread per CLI process: six test workers share the cores
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
BASE = [sys.executable, "-m", "pylamp_tpu_torch", "run", "falling_block",
        "--nx", "16", "--x64", "--device", "cpu", "--checkpoint-every", "1"]
STEPS = 6
STEP_DELAY = 0.5  # seconds of sleep after every victim step


def _run_cli(monkeypatch, argv):
    captured = {}

    def fake_run_model(cfg, **kw):
        captured.update(kw)
        captured["cfg"] = cfg
        state = types.SimpleNamespace(step=0, time=0.0)
        return state, [], None

    monkeypatch.setattr(driver_mod, "run_model", fake_run_model)
    assert main(argv) == 0
    return captured


RUN = ["run", "falling_block", "--nx", "16", "--steps", "1"]


def test_default_run_is_f32_state_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cap = _run_cli(monkeypatch, RUN)
    assert cap["dtype"] == torch.float32 and cap["device"] == "cuda"
    assert cap["cfg"].time.max_steps == 1 and cap["cfg"].nx == 16


def test_x64_flag_selects_f64_state(monkeypatch):
    cap = _run_cli(monkeypatch, RUN + ["--x64", "--device", "cpu"])
    assert cap["dtype"] == torch.float64 and cap["device"] == "cpu"


def test_run_model_default_dtype_is_f64(monkeypatch):
    seen = {}

    def fake_build(cfg, dtype=None, device=None):
        seen["dtype"] = dtype
        raise RuntimeError("stop after build")

    monkeypatch.setattr(driver_mod, "build", fake_build)
    from pylamp_tpu_torch.models.benchmarks import falling_block

    with pytest.raises(RuntimeError, match="stop after build"):
        driver_mod.run_model(falling_block(nx=16, ny=16, max_steps=1),
                             device="cpu")
    assert seen["dtype"] == torch.float64


def test_mesh_flag_wires_mesh_and_explicit_halo(monkeypatch):
    cap = _run_cli(monkeypatch, RUN + ["--mesh", "2x4", "--device", "cpu"])
    mesh = cap["mesh"]
    assert mesh is not None and (mesh.my, mesh.mx) == (2, 4)
    assert cap["cfg"].solver.explicit_halo is True
    assert cap["cfg"].solver.mg_coarse_replicate == 16


def test_mesh_flag_global_tensors_opt_out(monkeypatch):
    cap = _run_cli(monkeypatch, RUN + ["--mesh", "8", "--no-explicit-halo",
                                       "--device", "cpu"])
    assert (cap["mesh"].my, cap["mesh"].mx) == (4, 2)
    assert cap["cfg"].solver.explicit_halo is False


def test_list_gives_reference_names(capsys):
    from pylamp_tpu.cli import BENCHMARKS as JAX_BENCHMARKS

    assert main(["list"]) == 0
    names = capsys.readouterr().out.split()
    assert names == sorted(JAX_BENCHMARKS) and len(names) == 6


def test_run_without_cuda_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(driver_mod, "run_model",
                        lambda *a, **kw: called.append(1))
    with pytest.raises(SystemExit) as exc:
        main(RUN)
    assert exc.value.code not in (0, None) and "--device cpu" in str(
        exc.value.code)
    assert not called


def test_bench_refused_without_jax():
    code = ("import sys\n"
            "from pylamp_tpu_torch.cli import main\n"
            "try:\n"
            "    main(['bench'])\n"
            "except SystemExit as e:\n"
            "    print(json.dumps([str(e.code), 'jax' in sys.modules]))\n")
    r = subprocess.run([sys.executable, "-c", "import json\n" + code],
                       cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    msg, jax_loaded = json.loads(r.stdout.splitlines()[-1])
    assert "waits for a later port PR" in msg and not jax_loaded
    r = subprocess.run([sys.executable, "-m", "pylamp_tpu_torch", "bench"],
                       cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0


# -- fault injection -----------------------------------------------------------

def _metrics_lines(out_dir):
    path = os.path.join(out_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return 0
    with open(path) as fh:
        return sum(1 for _ in fh)


def _kill_mid_run(crash_dir, deadline_s):
    """Start a victim run and SIGKILL it once the step-3 checkpoint exists.
    Returns True if the kill landed mid-run (a checkpoint exists and the
    run is incomplete)."""
    ck = os.path.join(crash_dir, "checkpoint.npz")
    p = subprocess.Popen(
        BASE + ["--steps", str(STEPS), "--out", crash_dir,
                "--step-delay", str(STEP_DELAY)],
        cwd=REPO, env=ENV,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    deadline = time.time() + deadline_s
    while time.time() < deadline and p.poll() is None:
        if _metrics_lines(crash_dir) >= 3 and os.path.exists(ck):
            break
        time.sleep(0.05)
    if p.poll() is None:
        p.send_signal(signal.SIGKILL)
    p.wait(timeout=120)
    return os.path.exists(ck) and 3 <= _metrics_lines(crash_dir) < STEPS


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    ref_dir = str(tmp_path / "ref")
    t0 = time.time()
    r = subprocess.run(BASE + ["--steps", str(STEPS), "--out", ref_dir,
                               "--output-every", "3"],
                       cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=600)
    ref_wall = time.time() - t0
    assert r.returncode == 0, r.stderr[-2000:]
    # the CLI's outputs at 16^2 on the CPU
    assert sorted(os.listdir(ref_dir)) == [
        "checkpoint.npz", "fields_000003.npz", "fields_000006.npz",
        "metrics.jsonl"]

    deadline_s = max(120.0, 5.0 * ref_wall)
    crash_dir = None
    for attempt in range(2):
        crash_dir = str(tmp_path / f"crash{attempt}")
        if _kill_mid_run(crash_dir, deadline_s):
            break
    else:
        pytest.fail(f"could not land a mid-run SIGKILL in {deadline_s:.0f}s x2")

    ck = os.path.join(crash_dir, "checkpoint.npz")
    r = subprocess.run(BASE + ["--steps", str(STEPS), "--out", crash_dir,
                               "--resume", ck],
                       cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]

    with np.load(os.path.join(ref_dir, "checkpoint.npz")) as a, \
            np.load(ck) as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(b["state.step"]) == STEPS
        for k in a.files:
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            scale = max(float(np.max(np.abs(x))), 1e-300)
            assert np.max(np.abs(x - y)) <= 1e-12 * scale, k
    with open(os.path.join(crash_dir, "metrics.jsonl")) as fh:
        steps = [json.loads(line)["step"] for line in fh]
    assert steps[-1] == STEPS and sorted(set(steps)) == list(
        range(1, STEPS + 1))
