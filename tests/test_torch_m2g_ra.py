"""Port vs reference: the rho0*alpha stream (``c_ra``, adiabatic heating's
coefficient on the corner lattice) of kernels 2 and 10.

The plain versions (``m2g_fused_plain``, ``m2g_fused_block_plain``, what
the wrappers run on CPU tensors) against the JAX package's Pallas kernels
(``m2g_fused_pallas``, ``m2g_fused_block_pallas``) in interpret mode, in
f32 on markers drawn with numpy from a seed, three materials with
different rho0 and alpha:

- kernel 2 at (8, 128, 3), walls and periodic side walls: every stream,
  ``c_ra`` included, within the m2g bar (1e-5 max|err| / max|ref|, the
  TPU kernel's own test, markers/pallas/m2g_kernel.py); the periodic seam
  columns of ``c_ra`` equal;
- kernel 10 on the bottom-right shard of a 32^2 grid on the 4x2 mesh
  (8x16 blocks, K = 8): ``c_ra`` on the shard's own nodes and seam strips
  within the same bar;
- every other stream is bit-identical with and without ``with_ra``, and
  ``c_ra`` comes only with the energy streams.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import rel, t

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.markers import bucket as jbucket
from pylamp_tpu.markers.pallas.m2g_kernel import (
    m2g_fused_block_pallas,
    m2g_fused_pallas,
)
from pylamp_tpu.models.config import PhysicsConfig as JPhysics
from pylamp_tpu.physics.materials import Material as JMaterial
from pylamp_tpu.physics.materials import MaterialTable as JTable
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import BucketedMarkers
from pylamp_tpu_torch.markers.kernels import m2g, m2g_block
from pylamp_tpu_torch.models.config import PhysicsConfig
from pylamp_tpu_torch.physics.materials import Material, MaterialTable

FIELDS = ("x", "y", "mat", "T", "valid")
BAR = 1e-5
MATERIALS = (
    dict(name="a", rho0=3300.0, alpha=2.5e-5, T_ref=0.2, eta0=1e21,
         viscosity="frank_kamenetskii", fk_gamma=6.9, k=3.0, cp=1250.0,
         H=2e-8),
    dict(name="b", rho0=3200.0, alpha=3.0e-5, eta0=1e19, k=100.0, cp=1000.0),
    dict(name="c", rho0=3350.0, alpha=2.0e-5, eta0=1e23, k=3.3, cp=1200.0,
         H=1e-9),
)
PHYS_KW = dict(eta_avg="geometric", eta_min=1e18, eta_max=1e24, gx=0.0,
               gy=9.81)
MATS = tuple(Material(**m) for m in MATERIALS)
JMATS = tuple(JMaterial(**m) for m in MATERIALS)
PHYS = PhysicsConfig(materials=MATS, **PHYS_KW)
JPHYS = JPhysics(materials=JMATS, **PHYS_KW)
TABLE, JTABLE = MaterialTable(MATS), JTable(JMATS)


def _markers(shape, grid, seed, fill=0.8):
    """f32 markers jittered in their cells, three materials, a fraction
    ``fill`` of the slots valid."""
    rng = np.random.default_rng(seed)
    ny, nx, _ = shape
    ci = np.arange(nx)[None, :, None]
    cj = np.arange(ny)[:, None, None]
    x = ((ci + rng.uniform(0.001, 0.999, shape)) * grid.dx).astype(np.float32)
    y = ((cj + rng.uniform(0.001, 0.999, shape)) * grid.dy).astype(np.float32)
    return dict(x=x, y=y, T=rng.uniform(0.1, 1.0, shape).astype(np.float32),
                mat=rng.integers(0, 3, shape).astype(np.int32),
                valid=rng.uniform(size=shape) < fill)


# -- kernel 2 at (8, 128, 3) ------------------------------------------------------

NY, NX, K = 8, 128, 3
GRID = StaggeredGrid(nx=NX, ny=NY, lx=1.0, ly=0.5)
JGRID = JGrid(nx=NX, ny=NY, lx=1.0, ly=0.5)


@pytest.mark.parametrize("periodic_x", [False, True])
def test_m2g_ra_plain_vs_pallas(periodic_x):
    arrays = _markers((NY, NX, K), GRID, 21)
    jbm = jbucket.BucketedMarkers(**{f: jnp.asarray(arrays[f])
                                     for f in FIELDS})
    bm = BucketedMarkers(**{f: t(arrays[f]) for f in FIELDS})
    ref = m2g_fused_pallas(jbm, JGRID, JTABLE, JPHYS, with_energy=True,
                           with_ra=True, interpret=True,
                           periodic_x=periodic_x)
    n0 = (m2g.launches, m2g.launches_ra)
    got = m2g.m2g_fused(bm, GRID, TABLE, PHYS, with_energy=True,
                        periodic_x=periodic_x, with_ra=True)
    assert (m2g.launches, m2g.launches_ra) == n0  # the plain version ran
    assert sorted(got) == sorted(ref)
    assert "c_ra" in got
    for k in ref:
        assert rel(got[k], ref[k]) <= BAR, k
    if periodic_x:
        assert torch.equal(got["c_ra"][:, 0], got["c_ra"][:, -1])


@pytest.mark.parametrize("periodic_x", [False, True])
def test_m2g_ra_leaves_other_streams(periodic_x):
    bm = BucketedMarkers(**{f: t(a) for f, a in
                            _markers((NY, NX, K), GRID, 22).items()})
    base = m2g.m2g_fused_plain(bm, GRID, TABLE, PHYS, with_energy=True,
                               periodic_x=periodic_x)
    with_ra = m2g.m2g_fused_plain(bm, GRID, TABLE, PHYS, with_energy=True,
                                  periodic_x=periodic_x, with_ra=True)
    assert sorted(with_ra) == sorted([*base, "c_ra"])
    for k in base:
        assert torch.equal(base[k], with_ra[k]), k
    # rho0 * alpha only with the energy streams, as the TPU kernel's plan
    no_energy = m2g.m2g_fused_plain(bm, GRID, TABLE, PHYS, with_ra=True,
                                    periodic_x=periodic_x)
    assert "c_ra" not in no_energy and "c_T" not in no_energy


# -- kernel 10 on one shard of the 4x2 mesh ------------------------------------------

N, MY, MX, KB = 32, 4, 2, 8
BY, BX = N // MY, N // MX
BGRID = StaggeredGrid(nx=N, ny=N, lx=1.2, ly=1.0)
JBGRID = JGrid(nx=N, ny=N, lx=1.2, ly=1.0)


def _cut(a, r0, c0, rows, cols):
    """a[r0:r0+rows, c0:c0+cols], zeros where it leaves the array (the
    halo exchange's fill beyond the domain)."""
    out = np.zeros((rows, cols) + a.shape[2:], a.dtype)
    rs, cs = max(r0, 0), max(c0, 0)
    re, ce = min(r0 + rows, a.shape[0]), min(c0 + cols, a.shape[1])
    out[rs - r0:re - r0, cs - c0:ce - c0] = a[rs:re, cs:ce]
    return out


@pytest.mark.parametrize("iy,ix", [(MY - 1, MX - 1), (1, 0)])
def test_m2g_block_ra_plain_vs_pallas(iy, ix):
    arrays = _markers((N, N, KB), BGRID, 23)
    ext = [_cut(arrays[f], iy * BY - 1, ix * BX - 1, BY + 2, BX + 2)
           for f in ("x", "y", "T", "mat", "valid")]
    xe, ye, Te, me, ve = ext
    ref, _ = m2g_fused_block_pallas(
        *(jnp.asarray(a) for a in (xe, ye, Te, me)),
        jnp.asarray(ve.astype(np.int32)), JBGRID, JTABLE, JPHYS,
        row_base=iy * BY, col_base=ix * BX, with_energy=True, with_ra=True,
        interpret=True)
    bases = torch.tensor([[iy * BY, ix * BX]], dtype=torch.int32)
    args = [t(a[None]) for a in ext]
    got = m2g_block.m2g_fused_block_plain(*args, BGRID, TABLE, PHYS, bases,
                                          with_energy=True, with_ra=True)
    base = m2g_block.m2g_fused_block_plain(*args, BGRID, TABLE, PHYS, bases,
                                           with_energy=True)
    assert sorted(got) == sorted(ref) == sorted([*base, "c_ra"])
    for k in base:
        assert torch.equal(base[k], got[k]), k
    F = np.asarray(ref["c_ra"])  # (BY+1, W), lane l = node col ix*BX-1+l
    G = got["c_ra"][0].numpy()
    assert rel(G[:BY, :BX], F[:BY, 1:BX + 1]) <= BAR
    if iy == MY - 1:  # the bottom seam row
        assert rel(G[BY, :BX], F[BY, 1:BX + 1]) <= BAR
    if ix == MX - 1:  # the right seam column
        assert rel(G[:BY + (iy == MY - 1), BX],
                   F[:BY + (iy == MY - 1), BX + 1]) <= BAR
