"""Port vs reference: the state bridge.  A pylamp_tpu checkpoint (npz of
path-keyed leaves) loads straight into the port and comes back out equal
leaf for leaf, dtypes included; a port state saved in that format loads
into the JAX package's ``load_checkpoint``."""
import numpy as np
import pytest
import torch
from torch_helpers import jax_config

from pylamp_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from pylamp_tpu.models.setup import build as jax_build
from pylamp_tpu_torch.bridge import state_from_numpy, state_to_numpy
from pylamp_tpu_torch.models.benchmarks import fk_bench_config
from pylamp_tpu_torch.models.setup import build

N = 16


@pytest.fixture(scope="module", params=["float64", "float32"])
def jax_state(request):
    import jax.numpy as jnp

    jcfg = jax_config(fk_bench_config(N))
    _, _, st = jax_build(jcfg, dtype=jnp.dtype(request.param))
    return request.param, st


def test_checkpoint_roundtrip(jax_state, tmp_path):
    _, st = jax_state
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, st, extra={"step_count": 3})
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    port = state_from_numpy(d, device="cpu")
    back = state_to_numpy(port)
    leaves = {k: v for k, v in d.items() if k.startswith("state.")}
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_port_state_loads_into_reference(jax_state, tmp_path):
    """The port's own initial state, written in the checkpoint format,
    fills the JAX template and equals the JAX package's initial state."""
    dtype, jst = jax_state
    _, _, st = build(fk_bench_config(N), dtype=getattr(torch, dtype),
                     device="cpu")
    path = str(tmp_path / "port.npz")
    np.savez(path, __format_version__=2, **state_to_numpy(st))
    loaded, _ = load_checkpoint(path, jst)
    np.testing.assert_array_equal(np.asarray(loaded.markers.x),
                                  np.asarray(jst.markers.x))
    np.testing.assert_array_equal(np.asarray(loaded.markers.valid),
                                  np.asarray(jst.markers.valid))
    # f32: the grid mirrors are log-averages summed in another order
    # (exp turns the last-bit differences of the sums into ~1e-6)
    rtol = 1e-13 if dtype == "float64" else 1e-5
    for f in ("eta_s", "eta_n", "T"):
        np.testing.assert_allclose(np.asarray(getattr(loaded, f)),
                                   np.asarray(getattr(jst, f)), rtol=rtol)
