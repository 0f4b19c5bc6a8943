"""Port vs reference: the explicit-halo marker engine on the in-process 4x2
mesh, on the CPU.

As the reference's own halo-marker tests do (tests/test_halo_markers.py,
tests/test_halo_pallas.py), each halo function is held against the JAX
package's global bucket engine on the same seeded markers of a 32x32 grid
(8x16 blocks), through the per-shard kernels' plain versions:

- ``m2g_fused_halo``, every stream, against ``bucket_markers_to_grid``
  (weights and means), f64, 1e-12 relative;
- ``g2m_halo`` on all four lattices against ``bucket_grid_to_markers``,
  f64, 1e-12;
- ``advect_rk4_halo``, reach 1 and 2, free slip and a moving no-slip lid,
  against ``bucket_advect_rk4``, f64, 1e-12;
- ``rebucket_halo`` against ``rebucket``: bit-identical slot for slot and
  the same drop count, including the capacity-overflow case of
  tests/test_halo_pallas.py (buckets overcrowded so markers drop).
"""
import dataclasses

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
from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.models.config import PhysicsConfig
from pylamp_tpu_torch.parallel.halo_markers import (
    advect_rk4_halo,
    g2m_halo,
    halo_markers_eligible,
    m2g_fused_halo,
    rebucket_halo,
)
from pylamp_tpu_torch.parallel.mesh import make_mesh
from pylamp_tpu_torch.physics.materials import Material, MaterialTable

N, LX = 32, 1.2
GRID = StaggeredGrid(nx=N, ny=N, lx=LX, ly=1.0)
JGRID = JGrid(nx=N, ny=N, lx=LX, ly=1.0)
MATERIALS = (
    Material(rho0=100.0, alpha=1.0, eta0=1.0, viscosity="frank_kamenetskii",
             fk_gamma=9.2, k=1.0, cp=0.01),
    Material(rho0=90.0, alpha=0.5, T_ref=0.2, eta0=3.0, k=2.0, cp=0.02,
             H=1.5),
)
TABLE = MaterialTable(MATERIALS)
JTABLE = JTable([JMaterial(**dataclasses.asdict(m)) for m in MATERIALS])
FIELDS = ("x", "y", "mat", "T", "valid")


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh(8)
    assert halo_markers_eligible(GRID, m)
    return m


def _jax_markers(n_per_dim=3, capacity=12, seed=0, jitter=0.25):
    rng = np.random.default_rng(seed)
    m = n_per_dim
    xs = (np.arange(N * m) + 0.5) * LX / (N * m)
    ys = (np.arange(N * m) + 0.5) * 1.0 / (N * m)
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    x = X.ravel() + rng.uniform(-jitter, jitter, X.size) * LX / (N * m)
    y = Y.ravel() + rng.uniform(-jitter, jitter, X.size) * 1.0 / (N * m)
    mat = (x > 0.55 * LX).astype(np.int32)
    T = rng.uniform(0.0, 1.0, x.size)
    return jbucket.bucket_from_flat(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mat), jnp.asarray(T),
        JGRID, capacity)


def _port(jbm):
    return BucketedMarkers(**{f: t(getattr(jbm, f)) for f in FIELDS})


@pytest.mark.parametrize("eta_avg", ["geometric"])
def test_m2g_fused_halo(mesh, eta_avg):
    jbm = _jax_markers()
    phys = PhysicsConfig(gx=0.4, gy=1.0, materials=MATERIALS,
                         eta_avg=eta_avg)
    got = m2g_fused_halo(_port(jbm), GRID, TABLE, phys, mesh,
                         with_energy=True, kernel=False)
    eta = jnp.clip(JTABLE.viscosity_of(jbm.mat, jbm.T), phys.eta_min,
                   phys.eta_max)
    rho = JTABLE.density(jbm.mat, jbm.T)
    streams = {  # name: (lattice, weight, values, mode)
        "c_eta": ("corner", "c_w", eta, eta_avg),
        "n_eta": ("center", "n_w", eta, eta_avg),
        "vy_rho": ("vy", "vy_w", rho, "arithmetic"),
        "vx_rho": ("vx", "vx_w", rho, "arithmetic"),
        "c_T": ("corner", "c_w", jbm.T, "arithmetic"),
        "c_H": ("corner", "c_w", JTABLE.heating(jbm.mat, jnp.float64),
                "arithmetic"),
    }
    for name, (loc, wname, vals, mode) in streams.items():
        mean, w = jbucket.bucket_markers_to_grid(jbm, vals, JGRID, loc, mode)
        assert rel(got[wname], w) <= 1e-12, wname
        sw = got[wname]
        m = got[name] / torch.where(sw == 0, 1.0, sw)
        if mode == "geometric":
            m = torch.exp(m)
        elif mode == "harmonic":
            m = 1.0 / torch.where(m == 0, 1.0, m)
        assert rel(m, mean) <= 1e-12, name


@pytest.mark.parametrize("loc", ["corner", "center", "vx", "vy"])
def test_g2m_halo(mesh, loc):
    jbm = _jax_markers(seed=1)
    field = np.random.default_rng(6).standard_normal(GRID.shape(loc))
    ref = jbucket.bucket_grid_to_markers(jnp.asarray(field), jbm.x, jbm.y,
                                         jbm.valid, JGRID, loc)
    bm = _port(jbm)
    got = g2m_halo(t(field), bm.x, bm.y, bm.valid, GRID, loc, mesh)
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("bcs", [VelocityBCs(),
                                 VelocityBCs(top="no_slip", vt_top=0.4,
                                             left="no_slip")],
                         ids=["free", "moving"])
def test_advect_rk4_halo(mesh, bcs, reach):
    jbm = _jax_markers(seed=2)
    rng = np.random.default_rng(7)
    vx = rng.uniform(-1, 1, GRID.shape_vx)
    vy = rng.uniform(-1, 1, GRID.shape_vy)
    dt = 0.45 * reach * GRID.dx
    ref = jbucket.bucket_advect_rk4(jbm, jnp.asarray(vx), jnp.asarray(vy), dt,
                                    JGRID, jax_vbcs(bcs), stage_reach=reach)
    got = advect_rk4_halo(_port(jbm), t(vx), t(vy), dt, GRID, bcs, mesh,
                          stage_reach=reach, kernel=False)
    assert rel(got.x - t(jbm.x), np.asarray(ref.x - jbm.x)) <= 1e-12
    assert rel(got.y - t(jbm.y), np.asarray(ref.y - jbm.y)) <= 1e-12


@pytest.mark.parametrize("overflow", [False, True])
def test_rebucket_halo(mesh, overflow):
    """Markers displaced by up to one cell (across the seams); with
    ``overflow`` 25 markers a cell into 10 slots, so buckets overflow."""
    if overflow:
        jbm = _jax_markers(n_per_dim=5, capacity=10, seed=5, jitter=0.45)
    else:
        jbm = _jax_markers(capacity=24, seed=3)
    rng = np.random.default_rng(8)
    dx = rng.uniform(-1, 1, jbm.x.shape) * GRID.dx
    dy = rng.uniform(-1, 1, jbm.y.shape) * GRID.dy
    jbm = jbm.replace(x=jnp.clip(jbm.x + dx, 1e-6, LX - 1e-6),
                      y=jnp.clip(jbm.y + dy, 1e-6, 1.0 - 1e-6))
    ref, ref_drop = jbucket.rebucket(jbm, JGRID)
    got, got_drop = rebucket_halo(_port(jbm), GRID, mesh, kernel=False)
    assert int(got_drop) == int(ref_drop)
    assert (int(ref_drop) > 0) == overflow
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
