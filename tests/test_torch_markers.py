"""Port vs reference: the bucket marker engine and the plain versions of
the three marker kernels (m2g, advect, rebucket), on the CPU.

Markers come from seeded numpy positions bucketed by the JAX package's
``bucket_from_flat``.  Each port function's plain version (what its CUDA
wrapper runs on a CPU tensor) is held against the reference's own plain
XLA function, never its Pallas interpret mode:

- m2g against ``bucket_markers_to_grid``, f64, 1e-12 relative;
- advect against ``bucket_advect_rk4``, f64, 1e-12 relative;
- rebucket against ``rebucket``: equal slot for slot, same drop count.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_vbcs, rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.markers import bucket as jbucket
from pylamp_tpu.physics.materials import Material as JMaterial
from pylamp_tpu.physics.materials import MaterialTable as JTable
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers import bucket
from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
from pylamp_tpu_torch.models.config import PhysicsConfig
from pylamp_tpu_torch.physics.materials import Material, MaterialTable

NX, NY, LX, LY = 24, 20, 1.2, 1.0
GRID = StaggeredGrid(nx=NX, ny=NY, lx=LX, ly=LY)
JGRID = JGrid(nx=NX, ny=NY, lx=LX, ly=LY)
MATERIALS = (
    Material(rho0=100.0, alpha=1.0, eta0=1.0, viscosity="frank_kamenetskii",
             fk_gamma=9.2, k=1.0, cp=0.01),
    Material(rho0=90.0, alpha=0.5, T_ref=0.2, eta0=3.0, viscosity="arrhenius",
             E_act=4.0, k=2.0, cp=0.02, H=1.5),
)
TABLE = MaterialTable(MATERIALS)
JTABLE = JTable([JMaterial(**dataclasses.asdict(m)) for m in MATERIALS])
FIELDS = ("x", "y", "mat", "T", "valid")


def _jax_markers(dtype, capacity=18, seed=0):
    """Reference bucketed markers from seeded jittered positions."""
    rng = np.random.default_rng(seed)
    m = 3
    xs = (np.arange(NX * m) + 0.5) * LX / (NX * m)
    ys = (np.arange(NY * m) + 0.5) * LY / (NY * m)
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    x = X.ravel() + rng.uniform(-0.25, 0.25, X.size) * LX / (NX * m)
    y = Y.ravel() + rng.uniform(-0.25, 0.25, X.size) * LY / (NY * m)
    mat = (x > 0.55 * LX).astype(np.int32)
    T = rng.uniform(0.0, 1.0, x.size)
    return jbucket.bucket_from_flat(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(mat),
        jnp.asarray(T, dtype), JGRID, capacity)


def _port(jbm):
    return bucket.BucketedMarkers(**{f: t(getattr(jbm, f)) for f in FIELDS})


@pytest.fixture(scope="module")
def jax_markers64():
    return _jax_markers(jnp.float64)


@pytest.fixture
def markers64(jax_markers64):
    """The reference markers (immutable JAX arrays, built once) and a fresh
    port copy per test, so no test sees another's tensors."""
    return jax_markers64, _port(jax_markers64)


def test_bucket_from_flat_equal():
    """Same flat markers -> identical buckets (stable sort order; the
    capacity holds every cell, as setup always does)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, LX, 5000)
    y = rng.uniform(0, LY, 5000)
    mat = rng.integers(0, 2, 5000).astype(np.int32)
    T = rng.uniform(0, 1, 5000)
    ref = jbucket.bucket_from_flat(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(mat), jnp.asarray(T), JGRID, 40)
    got = bucket.bucket_from_flat(t(x), t(y), t(mat), t(T), GRID, 40)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))


STREAMS = [
    # (dict key, weight key, lattice, averaging, marker values)
    ("c_eta", "c_w", "corner", "geometric", "eta"),
    ("n_eta", "n_w", "center", "geometric", "eta"),
    ("vy_rho", "vy_w", "vy", "arithmetic", "rho"),
    ("vx_rho", "vx_w", "vx", "arithmetic", "rho"),
    ("c_T", "c_w", "corner", "arithmetic", "T"),
    ("c_k", "c_w", "corner", "arithmetic", "k"),
    ("c_rhocp", "c_w", "corner", "arithmetic", "rhocp"),
    ("c_H", "c_w", "corner", "arithmetic", "H"),
]


@pytest.mark.parametrize("eta_avg", ["geometric", "harmonic"])
@pytest.mark.parametrize("key,wkey,loc,mode,what", STREAMS)
def test_m2g_plain_vs_reference(markers64, key, wkey, loc, mode, what,
                                eta_avg):
    jbm, bm = markers64
    if what == "eta":
        mode = eta_avg
    phys = PhysicsConfig(gx=0.5, gy=1.0, materials=MATERIALS, eta_min=1e-3,
                         eta_max=50.0, eta_avg=eta_avg)
    n0 = m2g.launches
    out = m2g.m2g_fused(bm, GRID, TABLE, phys, with_energy=True)
    assert m2g.launches == n0
    vals = {
        "eta": jnp.clip(JTABLE.viscosity_of(jbm.mat, jbm.T), 1e-3, 50.0),
        "rho": JTABLE.density(jbm.mat, jbm.T),
        "T": jbm.T,
        "k": JTABLE.conductivity(jbm.mat, jnp.float64),
        "rhocp": JTABLE.rho_cp(jbm.mat, jbm.T),
        "H": JTABLE.heating(jbm.mat, jnp.float64),
    }[what]
    ref_mean, ref_w = jbucket.bucket_markers_to_grid(jbm, vals, JGRID, loc,
                                                     mode)
    assert rel(out[wkey], ref_w) <= 1e-12
    got_mean = bucket.mean_of(out[key], out[wkey], mode)
    assert rel(got_mean, ref_mean) <= 1e-12


def test_grid_to_markers_vs_reference(markers64):
    jbm, bm = markers64
    field = np.random.default_rng(6).standard_normal(GRID.shape_corner)
    ref = jbucket.bucket_grid_to_markers(jnp.asarray(field), jbm.x, jbm.y,
                                         jbm.valid, JGRID, "corner")
    got = bucket.bucket_grid_to_markers(t(field), bm.x, bm.y, bm.valid, GRID,
                                        "corner")
    assert rel(got, ref) <= 1e-12


VBCS = [VelocityBCs(), VelocityBCs(top="no_slip", left="no_slip", vt_top=0.4)]


@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("bi", range(len(VBCS)))
def test_advect_plain_vs_reference(markers64, reach, bi):
    jbm, bm = markers64
    rng = np.random.default_rng(7)
    vx = rng.uniform(-1, 1, GRID.shape_vx)
    vy = rng.uniform(-1, 1, GRID.shape_vy)
    dt = 0.45 * reach * GRID.dx
    bcs = VBCS[bi]
    ref = jbucket.bucket_advect_rk4(jbm, jnp.asarray(vx), jnp.asarray(vy),
                                    jnp.asarray(dt), JGRID, jax_vbcs(bcs),
                                    stage_reach=reach)
    n0 = advect.launches
    got = advect.advect_rk4_fused(bm, t(vx), t(vy),
                                  torch.tensor(dt, dtype=torch.float64),
                                  GRID, bcs, stage_reach=reach)
    assert advect.launches == n0
    assert rel(got.x, ref.x) <= 1e-12
    assert rel(got.y, ref.y) <= 1e-12


_jax_rebucket = jax.jit(jbucket.rebucket, static_argnums=(1,))


@pytest.mark.parametrize("capacity", [18, 9])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rebucket_plain_equals_reference(capacity, dtype):
    """Markers displaced by up to one cell and re-packed: identical buckets
    slot for slot and the same drop count (capacity 9 overflows)."""
    jdt = jnp.dtype(dtype)
    jbm = _jax_markers(jdt, capacity=18, seed=1)
    rng = np.random.default_rng(8)
    shape = jbm.x.shape
    dx = rng.uniform(-0.95, 0.95, shape) * GRID.dx
    dy = rng.uniform(-0.95, 0.95, shape) * GRID.dy
    x = np.clip(np.asarray(jbm.x, np.float64) + dx, 1e-6, LX - 1e-6)
    y = np.clip(np.asarray(jbm.y, np.float64) + dy, 1e-6, LY - 1e-6)
    jmoved = jbucket.BucketedMarkers(
        x=jnp.asarray(x[..., :capacity], jdt),
        y=jnp.asarray(y[..., :capacity], jdt),
        mat=jbm.mat[..., :capacity], T=jbm.T[..., :capacity],
        valid=jbm.valid[..., :capacity])
    ref, ref_dropped = _jax_rebucket(jmoved, JGRID)
    n0 = rebucket.launches
    got, dropped = rebucket.rebucket_fused(_port(jmoved), GRID)
    assert rebucket.launches == n0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert int(dropped) == int(ref_dropped)
    if capacity == 9:
        assert int(dropped) > 0
