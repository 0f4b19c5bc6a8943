"""Port vs reference: the benchmark diagnostics (Nusselt number at both
walls, v_rms) at 1e-12 on a uniform and on stretched grids, and the
``rt_van_keken`` preset's build at 16^2 against the reference's."""
import numpy as np
import pytest
import torch
from torch_helpers import jax_state_dict, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.models import benchmarks as JB
from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu_torch.bridge import state_to_numpy
from pylamp_tpu_torch.core.grid import StaggeredGrid, geometric_edges
from pylamp_tpu_torch.models import benchmarks as B
from pylamp_tpu_torch.models.setup import build

NX, NY = 16, 12
GRIDS = {
    "uniform": dict(),
    "stretched_y": dict(y_edges=geometric_edges(NY, 1.0, 4.0)),
    "stretched_xy": dict(x_edges=geometric_edges(NX, 2.0, 3.0),
                         y_edges=geometric_edges(NY, 1.0, 4.0)),
}


@pytest.mark.parametrize("kind", sorted(GRIDS))
@pytest.mark.parametrize("fn", ["nusselt_top", "nusselt_bottom", "vrms_box"])
def test_diagnostic_matches_reference(kind, fn):
    lx = 2.0 if kind == "stretched_xy" else 1.0
    kw = dict(nx=NX, ny=NY, lx=lx, ly=1.0, **GRIDS[kind])
    grid, jgrid = StaggeredGrid(**kw), JGrid(**kw)
    rng = np.random.default_rng(1)
    if fn == "vrms_box":
        args = (rng.standard_normal(grid.shape_vx),
                rng.standard_normal(grid.shape_vy))
        got = getattr(B, fn)(*(t(a) for a in args))
        ref = getattr(JB, fn)(*args)
    else:
        # the conductive profile plus noise: Nu ~ 1
        T = (np.asarray(grid.y_corner)[:, None]
             + 0.1 * rng.standard_normal(grid.shape_corner))
        got = getattr(B, fn)(t(T), grid)
        ref = getattr(JB, fn)(T, jgrid)
    ref = float(ref)
    assert got.dtype == torch.float64
    assert abs(float(got) - ref) <= 1e-12 * abs(ref)


def test_rt_van_keken_build_matches_reference():
    import jax.numpy as jnp

    cfg = B.rt_van_keken(nx=16, ny=16)
    jcfg = JB.rt_van_keken(nx=16, ny=16)
    assert (cfg.lx, cfg.markers_per_cell_dim, cfg.time.max_steps) == (
        jcfg.lx, jcfg.markers_per_cell_dim, jcfg.time.max_steps)
    _, _, st = build(cfg, dtype=torch.float64, device="cpu")
    _, _, jst = jax_build(jcfg, dtype=jnp.float64)
    got, ref = state_to_numpy(st), jax_state_dict(jst)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if k in ("state.eta_s", "state.eta_n", "state.T"):
            np.testing.assert_allclose(got[k], v, rtol=1e-13, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
