"""The port's step profiler on the CPU: the device-time count of a trace,
and the phase hook of ``run_step`` (the step ``make_step`` returns)."""
import numpy as np
import pytest
import torch
from torch_helpers import rel

from pylamp_tpu_torch.models.benchmarks import fk_bench_config
from pylamp_tpu_torch.models.profile import device_activity
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.models.step import make_step, make_step_phases, run_step


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# host-side records of the same work: never device time
HOST = [_ev("cpu_op", "aten::add", 0.0, 50.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1.0, 3.0),
        _ev("user_annotation", "stokes", 0.0, 100.0),
        _ev("gpu_user_annotation", "stokes", 10.0, 90.0),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 4.0}]


@pytest.mark.parametrize("device,busy_us,n_ops", [
    # one stream: kernel, copy and fill back to back, with gaps
    ([_ev("kernel", "add", 10.0, 5.0), _ev("gpu_memcpy", "DtoH", 20.0, 2.0),
      _ev("gpu_memset", "fill", 30.0, 1.0), _ev("kernel", "add", 40.0, 5.0)],
     13.0, 4),
    # two streams overlapping: the union, not the sum
    ([_ev("kernel", "a", 10.0, 10.0), _ev("kernel", "b", 15.0, 10.0),
      _ev("kernel", "c", 16.0, 2.0)], 15.0, 3),
    ([], 0.0, 0),
])
def test_device_activity_counts_device_work_once(device, busy_us, n_ops):
    busy, n, by_name = device_activity(HOST + device)
    assert busy == pytest.approx(busy_us * 1e-6)
    assert n == n_ops
    assert sum(c for c, _ in by_name.values()) == n_ops
    assert "aten::add" not in by_name and "cudaLaunchKernel" not in by_name


def test_run_step_hook_sees_every_phase():
    """``run_step`` with a phase hook takes the same step as ``make_step``
    and calls the phases in the step's order."""
    cfg = fk_bench_config(16)
    grid, table, st0 = build(cfg, dtype=torch.float64, device="cpu")
    calls = []

    def timed(name, fn, *args):
        calls.append(name)
        return fn(*args)

    got, gdiag = run_step(make_step_phases(grid, cfg, table), st0, timed)
    ref, rdiag = make_step(grid, cfg, table)(st0)
    assert calls == ["interp", "stokes", "timestep", "energy", "advect"]
    for f in ("vx", "vy", "p", "T"):
        assert rel(getattr(got, f), getattr(ref, f)) == 0.0, f
    assert torch.equal(got.markers.x, ref.markers.x)
    assert gdiag["stokes_iterations"] == rdiag["stokes_iterations"]
    assert int(got.step) == int(ref.step) == 1
    assert np.isfinite(float(gdiag["dt"]))
