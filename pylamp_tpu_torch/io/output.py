"""Field/marker output (port of ``pylamp_tpu/io/output.py``): per-step
``.npz`` dumps with the reference's keys, and quick-look figures.
Plotting is optional and gated on matplotlib availability."""
from __future__ import annotations

import json
import os

import numpy as np

from pylamp_tpu_torch.markers.bucket import flatten


def _np(t):
    return t.detach().cpu().numpy()


def save_fields(path: str, state, grid, markers: bool = True):
    """The grid fields, the clock and (``markers``) the live markers in
    ``reshape(-1)`` slot order; only the live markers leave the device."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = dict(
        vx=_np(state.vx),
        vy=_np(state.vy),
        p=_np(state.p),
        T=_np(state.T),
        eta_s=_np(state.eta_s),
        eta_n=_np(state.eta_n),
        time=_np(state.time),
        step=_np(state.step),
        x_corner=grid.x_corner,
        y_corner=grid.y_corner,
    )
    if markers:
        fx, fy, fm, fT, fv = flatten(state.markers)
        data.update(marker_x=_np(fx[fv]), marker_y=_np(fy[fv]),
                    marker_mat=_np(fm[fv]), marker_T=_np(fT[fv]))
    np.savez_compressed(path, **data)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib is optional
        return None
    return plt


def _speed(vx, vy):
    return np.hypot(0.5 * (vx[:, 1:] + vx[:, :-1]),
                    0.5 * (vy[1:, :] + vy[:-1, :]))


def _save(fig, plt, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_fields(path: str, state, grid):
    """Quick-look figure (T + velocity + viscosity). No-op without
    matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    panels = (("T", _np(state.T)),
              ("|v|", _speed(_np(state.vx), _np(state.vy))),
              ("log10 eta", np.log10(_np(state.eta_n))))
    for ax, (title, f) in zip(axes, panels):
        im = ax.imshow(f, origin="upper", aspect="auto")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    _save(fig, plt, path)
    return True


def plot_npz_fields(path: str, npz_path: str):
    """Quick-look figure from a saved fields_*.npz dump (T, |v|, log eta,
    markers colored by material).  No-op without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    d = np.load(npz_path)
    n = 3 + ("marker_x" in d)
    fig, axes = plt.subplots(1, n, figsize=(4.5 * n, 3.6))
    panels = ((f"T (step {int(d['step'])})", d["T"]),
              ("|v|", _speed(d["vx"], d["vy"])),
              ("log10 eta", np.log10(d["eta_n"])))
    for ax, (title, f) in zip(axes, panels):
        im = ax.imshow(f, origin="upper", aspect="auto")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    if "marker_x" in d:
        # subsample for plot speed at 10M+ markers
        stride = max(1, d["marker_x"].size // 200_000)
        axes[3].scatter(
            d["marker_x"][::stride], d["marker_y"][::stride],
            c=d["marker_mat"][::stride], s=0.2, cmap="tab10", lw=0,
        )
        axes[3].invert_yaxis()
        axes[3].set_title("markers (material)")
        axes[3].set_aspect("equal")
    fig.tight_layout()
    _save(fig, plt, path)
    return True


def plot_timeseries(path: str, metrics_path: str):
    """Time-series figure (v_rms, dt, Krylov iterations, per-phase wall time
    when present) from a metrics.jsonl written by the driver.  No-op
    without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False

    with open(metrics_path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    if not recs:
        return False

    t = np.array([r.get("time", i) for i, r in enumerate(recs)])

    def series(key):
        return np.array([r.get(key, np.nan) for r in recs], dtype=float)

    panels = [
        ("v_rms", series("vrms"), "log"),
        ("dt", series("dt"), "log"),
        ("Krylov iters/step", series("stokes_iterations"), "linear"),
        ("step wall [s]", series("step_wall_s"), "linear"),
    ]
    has_phases = any("phase_seconds" in r for r in recs)
    fig, axes = plt.subplots(
        1, len(panels) + has_phases, figsize=(4.2 * (len(panels) + has_phases), 3.2)
    )
    for ax, (title, ys, scale) in zip(axes, panels):
        ax.plot(t, ys, lw=1)
        ax.set_title(title)
        ax.set_xlabel("model time")
        if scale == "log" and np.nanmax(ys) > 0:
            ax.set_yscale("log")
    if has_phases:
        ax = axes[-1]
        names = sorted({k for r in recs for k in r.get("phase_seconds", {})})
        for name in names:
            ys = np.array(
                [r.get("phase_seconds", {}).get(name, np.nan) for r in recs]
            )
            ax.plot(t, ys, lw=1, label=name)
        ax.set_title("phase wall [s]")
        ax.set_xlabel("model time")
        ax.legend(fontsize=7)
    fig.tight_layout()
    _save(fig, plt, path)
    return True
