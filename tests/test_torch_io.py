"""Port vs reference: checkpoints, field dumps, figures, metrics lines,
JSON artifacts and the profiling hooks (``pylamp_tpu_torch/io``,
``pylamp_tpu_torch/utils``).

A checkpoint written by either package loads in the other, leaf for leaf
and exactly, in the loading template's dtypes; each refuses a bad checkpoint as the reference
does.  ``save_fields`` on a bridged state writes the reference's keys and
arrays, and a metrics record gives the reference's line."""
import json
import os

import numpy as np
import pytest
import torch
from torch_helpers import jax_config, jax_state_dict

from pylamp_tpu.io import checkpoint as jckpt
from pylamp_tpu.io.logging import MetricsLogger as JaxMetricsLogger
from pylamp_tpu.io.output import save_fields as jax_save_fields
from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu_torch.bridge import state_from_numpy, state_to_numpy
from pylamp_tpu_torch.io.checkpoint import (
    FORMAT_VERSION,
    load_checkpoint,
    save_checkpoint,
)
from pylamp_tpu_torch.io.logging import MetricsLogger
from pylamp_tpu_torch.io.output import (
    plot_fields,
    plot_npz_fields,
    plot_timeseries,
    save_fields,
)
from pylamp_tpu_torch.models.benchmarks import fk_bench_config
from pylamp_tpu_torch.models.setup import build
from pylamp_tpu_torch.utils import profiling
from pylamp_tpu_torch.utils.artifacts import write_json_artifact

N = 16
CFG = fk_bench_config(N)
DTYPES = ["float64", "float32"]


def _moved(d, rng):
    """Path-keyed arrays with every floating leaf perturbed and the clock
    set, so a round trip that drops or reorders a leaf shows."""
    out = {}
    for k, v in d.items():
        if k == "state.step":
            v = np.asarray(7, v.dtype)
        elif np.issubdtype(v.dtype, np.floating):
            v = (v + rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def states():
    """Per dtype: the JAX template, the port template and one set of
    non-trivial path-keyed leaves to write."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    out = {}
    for dt in DTYPES:
        jgrid, _, jst = jax_build(jax_config(CFG), dtype=jnp.dtype(dt))
        grid, _, st = build(CFG, dtype=getattr(torch, dt), device="cpu")
        out[dt] = dict(jax=jst, jgrid=jgrid, port=st, grid=grid,
                       leaves=_moved(jax_state_dict(jst), rng))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(states, tmp_path, dtype, writer):
    """Each leaf arrives in the loading template's dtype (the JAX f32
    build's eta_s and eta_n are f64, the port's f32)."""
    s = states[dtype]
    path = str(tmp_path / "ck.npz")
    src = s["leaves"]
    if writer == "port":
        save_checkpoint(path, state_from_numpy(src, device="cpu"))
        loaded, _ = jckpt.load_checkpoint(path, template=s["jax"])
        got, template = jax_state_dict(loaded), jax_state_dict(s["jax"])
    else:
        jst, _ = jckpt.load_checkpoint(_write_raw(tmp_path, src), s["jax"])
        jckpt.save_checkpoint(path, jst)
        loaded, _ = load_checkpoint(path, template=s["port"])
        got, template = state_to_numpy(loaded), state_to_numpy(s["port"])
    assert sorted(got) == sorted(src)
    for k, v in src.items():
        assert got[k].dtype == template[k].dtype, k
        np.testing.assert_array_equal(got[k], v.astype(template[k].dtype),
                                      err_msg=k)


def _write_raw(tmp_path, leaves, version=FORMAT_VERSION, name="raw.npz"):
    path = str(tmp_path / name)
    np.savez(path, __format_version__=version, **leaves)
    return path


def test_load_casts_to_template(states, tmp_path):
    """An f64 checkpoint fills an f32 template in the template's dtypes."""
    src = states["float64"]["leaves"]
    port = states["float32"]["port"]
    loaded, _ = load_checkpoint(_write_raw(tmp_path, src), template=port)
    got, template = state_to_numpy(loaded), state_to_numpy(port)
    for k, v in src.items():
        assert got[k].dtype == template[k].dtype, k
        np.testing.assert_array_equal(got[k], v.astype(template[k].dtype),
                                      err_msg=k)


def test_extra_roundtrip_and_no_tmp(states, tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, states["float64"]["port"],
                    extra={"note": 1, "tag": np.arange(3)})
    assert os.listdir(tmp_path) == ["ck.npz"]
    _, extra = load_checkpoint(path, template=states["float64"]["port"])
    assert int(extra["note"]) == 1
    np.testing.assert_array_equal(extra["tag"], np.arange(3))
    _, jextra = jckpt.load_checkpoint(path, template=states["float64"]["jax"])
    assert sorted(jextra) == sorted(extra)


def test_missing_mg_lam_loads_zeros(states, tmp_path):
    s = states["float64"]
    leaves = {k: v for k, v in s["leaves"].items() if k != "state.mg_lam"}
    loaded, _ = load_checkpoint(_write_raw(tmp_path, leaves), s["port"])
    assert torch.equal(loaded.mg_lam, torch.zeros_like(s["port"].mg_lam))
    assert torch.equal(loaded.vx, torch.from_numpy(leaves["state.vx"]))


@pytest.mark.parametrize("fault", ["newer", "missing", "shape"])
def test_bad_checkpoint_raises_as_reference(states, tmp_path, fault):
    s = states["float64"]
    leaves = dict(s["leaves"])
    version = FORMAT_VERSION
    if fault == "newer":
        version += 1
    elif fault == "missing":
        del leaves["state.vx"]
    else:
        leaves["state.p"] = leaves["state.p"][:-1]
    path = _write_raw(tmp_path, leaves, version)
    with pytest.raises((ValueError, KeyError)) as ref:
        jckpt.load_checkpoint(path, template=s["jax"])
    with pytest.raises(ref.type):
        load_checkpoint(path, template=s["port"])


def test_save_fields_matches_reference(states, tmp_path):
    s = states["float64"]
    jst, _ = jckpt.load_checkpoint(_write_raw(tmp_path, s["leaves"]), s["jax"])
    jax_save_fields(str(tmp_path / "ref.npz"), jst, s["jgrid"])
    save_fields(str(tmp_path / "port.npz"),
                state_from_numpy(s["leaves"], device="cpu"), s["grid"])
    with np.load(tmp_path / "ref.npz") as r, np.load(tmp_path / "port.npz") as g:
        assert sorted(g.files) == sorted(r.files)
        assert g["marker_x"].size == int(s["leaves"]["state.markers.valid"].sum())
        for k in r.files:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_plots_write_pngs(states, tmp_path):
    s = states["float32"]
    st = state_from_numpy(s["leaves"], device="cpu")
    st = st.replace(eta_n=torch.abs(st.eta_n) + 1.0)
    save_fields(str(tmp_path / "fields.npz"), st, s["grid"])
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("".join(json.dumps(
        {"step": i, "time": 0.1 * i, "vrms": 1.0 + i, "dt": 0.1,
         "stokes_iterations": 10, "step_wall_s": 0.5,
         "phase_seconds": {"interp": 0.1, "stokes": 0.3}}) + "\n"
        for i in range(1, 4)))
    made = [plot_fields(str(tmp_path / "a.png"), st, s["grid"]),
            plot_npz_fields(str(tmp_path / "b.png"), str(tmp_path / "fields.npz")),
            plot_timeseries(str(tmp_path / "c.png"), str(metrics))]
    assert made == [True, True, True]
    for name in ("a.png", "b.png", "c.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_metrics_line_matches_reference(tmp_path):
    import jax.numpy as jnp

    def record(scalar):
        return {"step": 3, "time": scalar(0.25, "float64"),
                "step_wall_s": 0.5, "stokes_iterations": 12,
                "stokes_converged": scalar(True, "bool"),
                "vrms": scalar(1.5, "float32"),
                "markers_dropped": scalar(0, "int64"),
                "phase_seconds": {"interp": 0.1}, "warning": "w",
                "wall_s": 2.0}

    lines = []
    for logger_cls, scalar in (
            (JaxMetricsLogger, lambda v, d: jnp.asarray(v, d)),
            (MetricsLogger, lambda v, d: torch.tensor(v, dtype=getattr(
                torch, d)))):
        path = str(tmp_path / f"{logger_cls.__module__}.jsonl")
        lg = logger_cls(path)
        lg.log(record(scalar))
        lg.close()
        lines.append(open(path).read())
    assert lines[1] == lines[0]
    with pytest.raises(ValueError, match="only 0-d"):
        MetricsLogger().log({"vx": torch.zeros(3)})


@pytest.mark.parametrize("payload", [None, {}, [], ""])
def test_artifact_refuses_empty(tmp_path, payload):
    path = tmp_path / "a.json"
    with pytest.raises(ValueError, match="refusing"):
        write_json_artifact(path, payload)
    assert not path.exists()
    write_json_artifact(path, {"ok": 1})
    assert json.loads(path.read_text()) == {"ok": 1}


def test_profiling_phases_and_trace(tmp_path):
    profiling.reset_phases()
    profiling.start_trace(str(tmp_path))
    for _ in range(2):
        with profiling.phase("stokes"):
            torch.ones(8).sum()
    path = profiling.stop_trace()
    rep = profiling.phase_report()
    assert list(rep) == ["stokes"] and rep["stokes"]["count"] == 2
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "stokes" in names
    profiling.reset_phases()
    assert profiling.phase_report() == {}
