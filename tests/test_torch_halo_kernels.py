"""Port vs reference: the plain versions of the five per-shard kernels
(8-12) against the JAX package's Pallas kernels in interpret mode, on the
CPU, in f32.

Each kernel runs on one shard's inputs (the port's with a leading shard
dim of 1), built with numpy from a seed the way the explicit-halo shard
bodies build them: extended blocks and frames of a 32x32 grid on the 4x2
mesh (8x16 blocks), with the halo ring cut from the global arrays and
zeros beyond the domain.  Bars (f32, another summation order):

- kernel 9 (saddle_block), both forms: 1e-5 max|err| / max|ref|;
- kernel 8 (cheb_block), degree 4 + residual at h = 5, zero and non-zero
  start, corner / interior / opposite-corner wall flags: 2e-5;
- kernel 10 (m2g_block), every stream, the shard's own nodes and the seam
  strips the caller keeps: 1e-5;
- kernel 11 (advect_block), reach 1 and 2: displacement error beyond one
  f32 spacing of the position, 1e-4 of max |displacement|;
- kernel 12 (rebucket_block): bit-identical, with and without overflow.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import rel

from pylamp_tpu.core.grid import StaggeredGrid as JGrid
from pylamp_tpu.markers import bucket as jbucket
from pylamp_tpu.markers.pallas.advect_kernel import advect_block_pallas
from pylamp_tpu.markers.pallas.m2g_kernel import m2g_fused_block_pallas
from pylamp_tpu.markers.pallas.rebucket_kernel import rebucket_block_pallas
from pylamp_tpu.models import config as jconfig
from pylamp_tpu.ops.pallas.block_stencil_kernel import saddle_block_pallas
from pylamp_tpu.ops.pallas.cheb_block_kernel import cheb_block_pallas
from pylamp_tpu.physics.materials import Material as JMaterial
from pylamp_tpu.physics.materials import MaterialTable as JTable
from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.kernels import (
    advect_block,
    m2g_block,
    rebucket_block,
)
from pylamp_tpu_torch.models.config import PhysicsConfig
from pylamp_tpu_torch.ops.kernels import cheb_block, saddle_block
from pylamp_tpu_torch.ops.kernels.cheb import chebyshev_coeffs
from pylamp_tpu_torch.physics.materials import Material, MaterialTable

N, MY, MX = 32, 4, 2
BY, BX = N // MY, N // MX
GRID = StaggeredGrid(nx=N, ny=N, lx=1.2, ly=1.0)
JGRID = JGrid(nx=N, ny=N, lx=1.2, ly=1.0)
F32 = np.float32
# shards of the 4x2 mesh: the top-left corner, an interior shard and the
# bottom-right corner (which keeps every seam strip)


def _f32(a):
    return torch.from_numpy(np.array(a, dtype=F32))


def _np(a):
    return torch.from_numpy(np.array(a))


def _cut(a, r0, c0, rows, cols):
    """a[r0:r0+rows, c0:c0+cols] with zeros where it leaves the array (the
    zero fill of the halo exchange beyond the domain)."""
    out = np.zeros((rows, cols) + a.shape[2:], a.dtype)
    rs, cs = max(r0, 0), max(c0, 0)
    re, ce = min(r0 + rows, a.shape[0]), min(c0 + cols, a.shape[1])
    out[rs - r0:re - r0, cs - c0:ce - c0] = a[rs:re, cs:ce]
    return out


@pytest.mark.parametrize("with_p", [True, False])
def test_saddle_block_plain(with_p):
    rng = np.random.default_rng(1)
    ext = (BY + 2, BX + 2)
    vx, vy, p = (rng.standard_normal(ext).astype(F32) for _ in range(3))
    en = np.exp(2.0 * rng.standard_normal(ext)).astype(F32)
    es = np.exp(2.0 * rng.standard_normal((BY + 1, BX + 1))).astype(F32)
    ref = saddle_block_pallas(*(jnp.asarray(a) for a in (vx, vy, p, es, en)),
                              JGRID, kcont=0.7, with_p=with_p,
                              interpret=True)
    got = saddle_block.saddle_block_plain(
        _f32(vx[None]), _f32(vy[None]), _f32(p[None]) if with_p else None,
        _f32(es[None]), _f32(en[None]), GRID.dx, GRID.dy, 0.7)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert rel(g[0], r) <= 1e-5


@pytest.mark.parametrize("flags,zero_init", [
    ((1, 0, 1, 0), True), ((1, 0, 1, 0), False), ((0, 0, 0, 0), True),
    ((0, 1, 0, 1), False)])
def test_cheb_block_plain(flags, zero_init):
    h, iters = 5, 4
    R, C = BY + 2 * h, BX + 2 * h
    rng = np.random.default_rng(2)
    bcs = VelocityBCs(top="no_slip", left="no_slip")
    s_signs = (bcs.s_top, bcs.s_bottom, bcs.s_left, bcs.s_right)

    def r(*shape):
        return rng.standard_normal(shape).astype(F32)

    ex = np.zeros((R, C + 1), F32) if zero_init else r(R, C + 1)
    ey = np.zeros((R + 1, C), F32) if zero_init else r(R + 1, C)
    rx, ry = r(R, C + 1), r(R + 1, C)
    es = np.exp(r(R + 1, C + 1)).astype(F32)
    en = np.exp(r(R, C)).astype(F32)
    kbnd, lam = 40.0, 2.7
    ref = cheb_block_pallas(
        *(jnp.asarray(a) for a in (ex, ey, rx, ry, es, en)), by=BY, bx=BX,
        h=h, grid=JGRID, kbnd=kbnd, s_signs=s_signs,
        wall_flags=tuple(jnp.asarray(f, jnp.float32) for f in flags),
        lam_max=jnp.asarray(lam, jnp.float32), iters=iters,
        zero_init=zero_init, emit_residual=True,
        interpret=True)
    prep = cheb_block.BlockSmootherPrep(
        es_v=_f32(es[None]), en_v=_f32(en[None]),
        flags=torch.tensor([flags], dtype=torch.float32),
        coeffs=chebyshev_coeffs(lam, h), kb=torch.tensor([kbnd]), h=h,
        by=BY, bx=BX)
    got = cheb_block.cheb_block_plain(
        _f32(ex[None]), _f32(ey[None]), _f32(rx[None]), _f32(ry[None]), prep,
        GRID, bcs, iters, zero_init, True)
    assert len(got) == len(ref) == 4
    for g, rf in zip(got, ref):
        assert rel(g[0], rf) <= 2e-5


MATERIALS = (
    Material(rho0=100.0, alpha=1.0, eta0=1.0, viscosity="frank_kamenetskii",
             fk_gamma=9.2, k=1.0, cp=0.01),
    Material(rho0=90.0, alpha=0.5, T_ref=0.2, eta0=3.0, viscosity="arrhenius",
             E_act=4.0, k=2.0, cp=0.02, H=1.5),
)


@pytest.fixture(scope="module")
def markers():
    """Bucketed f32 markers (K = 8) of the 32x32 grid, numpy streams, from
    seeded jittered positions through the reference's bucket_from_flat."""
    rng = np.random.default_rng(3)
    m = 2
    xs = (np.arange(N * m) + 0.5) * 1.2 / (N * m)
    ys = (np.arange(N * m) + 0.5) * 1.0 / (N * m)
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    x = X.ravel() + rng.uniform(-0.4, 0.4, X.size) * 1.2 / (N * m)
    y = Y.ravel() + rng.uniform(-0.4, 0.4, X.size) * 1.0 / (N * m)
    mat = (x > 0.5).astype(np.int32)
    T = rng.uniform(0.0, 1.0, x.size)
    bm = jbucket.bucket_from_flat(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(mat), jnp.asarray(T, jnp.float32), JGRID, 8)
    return {f: np.asarray(getattr(bm, f)) for f in
            ("x", "y", "T", "mat", "valid")}


def _ext_streams(st, iy, ix):
    """One shard's one-ring-extended (BY+2, BX+2, K) streams."""
    r0, c0 = iy * BY - 1, ix * BX - 1
    return [_cut(st[f], r0, c0, BY + 2, BX + 2)
            for f in ("x", "y", "T", "mat", "valid")]


@pytest.mark.parametrize("iy,ix", [(3, 1)])
def test_m2g_block_plain(markers, iy, ix):
    phys = PhysicsConfig(gx=0.4, gy=1.0, materials=MATERIALS,
                         eta_avg="geometric")
    jphys = jconfig.PhysicsConfig(
        gx=0.4, gy=1.0, eta_avg="geometric",
        materials=tuple(JMaterial(**dataclasses.asdict(m))
                        for m in MATERIALS))
    jtable = JTable(list(jphys.materials))
    xe, ye, Te, me, ve = _ext_streams(markers, iy, ix)
    ref, _ = m2g_fused_block_pallas(
        jnp.asarray(xe), jnp.asarray(ye), jnp.asarray(Te), jnp.asarray(me),
        jnp.asarray(ve.astype(np.int32)), JGRID, jtable, jphys,
        row_base=iy * BY, col_base=ix * BX, with_energy=True, interpret=True)
    got = m2g_block.m2g_fused_block_plain(
        _f32(xe[None]), _f32(ye[None]), _f32(Te[None]),
        _np(me[None]), _np(ve[None]), GRID,
        MaterialTable(MATERIALS), phys,
        torch.tensor([[iy * BY, ix * BX]], dtype=torch.int32),
        with_energy=True)
    assert sorted(got) == sorted(ref)
    lattice_rows = {"c": N + 1, "n": N, "vy": N + 1, "vx": N}
    lattice_cols = {"c": N + 1, "n": N, "vy": N, "vx": N + 1}
    for name, F in ref.items():
        F = np.asarray(F)  # (BY+1, W), lane l = node col ix*BX - 1 + l
        G = got[name][0].numpy()
        assert rel(G[:BY, :BX], F[:BY, 1:BX + 1]) <= 1e-5, name
        kind = name.split("_")[0]
        if iy == MY - 1 and lattice_rows[kind] == N + 1:
            assert rel(G[BY, :BX], F[BY, 1:BX + 1]) <= 1e-5, name
        if ix == MX - 1 and lattice_cols[kind] == N + 1:
            assert rel(G[:BY, BX], F[:BY, BX + 1]) <= 1e-5, name


def _padded_velocities(seed):
    """Random vx, vy and their ghost-padded lattices (free slip)."""
    rng = np.random.default_rng(seed)
    vx = rng.uniform(-1, 1, GRID.shape_vx).astype(F32)
    vy = rng.uniform(-1, 1, GRID.shape_vy).astype(F32)
    vx_p = np.concatenate([vx[:1], vx, vx[-1:]], axis=0)
    vy_p = np.concatenate([vy[:, :1], vy, vy[:, -1:]], axis=1)
    return vx_p, vy_p


def _disp_rel(got, ref, start):
    """Displacement error beyond one f32 spacing of the position, over
    max |displacement|."""
    got, ref, start = (np.asarray(a, np.float64) for a in (got, ref, start))
    top = np.maximum(np.abs(got), np.abs(ref)).astype(F32)
    spacing = np.nextafter(top, np.float32(np.inf)) - top
    excess = np.clip(np.abs(got - ref) - spacing, 0.0, None)
    return float(excess.max() / np.abs(ref - start).max())


@pytest.mark.parametrize("iy,ix,reach", [(0, 0, 2)])
def test_advect_block_plain(markers, iy, ix, reach):
    vx_p, vy_p = _padded_velocities(4)
    rb, cb = iy * BY, ix * BX
    w = (BY + 2 * reach + 1, BX + 2 * reach + 1)
    vx_ext = _cut(vx_p, rb - reach, cb - reach, *w)
    vy_ext = _cut(vy_p, rb - reach, cb - reach, *w)
    own = [markers[f][rb:rb + BY, cb:cb + BX] for f in ("x", "y", "valid")]
    dt = 0.45 * reach * GRID.dx
    rx, ry = advect_block_pallas(
        jnp.asarray(own[0]), jnp.asarray(own[1]),
        jnp.asarray(own[2].astype(np.int32)), jnp.asarray(vx_ext),
        jnp.asarray(vy_ext), dt, JGRID, row_base=rb, col_base=cb,
        reach=reach, interpret=True)
    gx, gy = advect_block.advect_block_plain(
        _f32(own[0][None]), _f32(own[1][None]), _np(own[2][None]),
        _f32(vx_ext[None]), _f32(vy_ext[None]), dt, GRID,
        torch.tensor([[rb, cb]], dtype=torch.int32), reach)
    valid = own[2]
    for g, r, s in ((gx, rx, own[0]), (gy, ry, own[1])):
        g = g[0].numpy()[valid]
        assert _disp_rel(g, np.asarray(r)[valid], s[valid]) <= 1e-4


@pytest.mark.parametrize("iy,ix,overflow", [(0, 0, False), (3, 1, True)])
def test_rebucket_block_plain(markers, iy, ix, overflow):
    """Markers displaced by up to 0.95 cells, so they cross the seams; with
    ``overflow`` the capacity drops to 4 and buckets overflow."""
    rng = np.random.default_rng(5)
    st = dict(markers)
    for f, d in (("x", GRID.dx), ("y", GRID.dy)):
        lim = GRID.lx if f == "x" else GRID.ly
        st[f] = np.clip(st[f] + rng.uniform(-0.95, 0.95, st[f].shape) * d,
                        1e-6, lim - 1e-6).astype(F32)
    if overflow:
        st = {f: a[..., :4] for f, a in st.items()}
    xe, ye, Te, me, ve = _ext_streams(st, iy, ix)
    ref = rebucket_block_pallas(
        jnp.asarray(xe), jnp.asarray(ye), jnp.asarray(Te), jnp.asarray(me),
        jnp.asarray(ve.astype(np.int32)), JGRID, row_base=iy * BY,
        col_base=ix * BX, interpret=True)
    got, arrivals = rebucket_block.rebucket_block_plain(
        _f32(xe[None]), _f32(ye[None]), _f32(Te[None]),
        _np(me[None]), _np(ve[None]), GRID,
        torch.tensor([[iy * BY, ix * BX]], dtype=torch.int32))
    for g, r in zip((got.x, got.y, got.T, got.mat, got.valid), ref[:5]):
        np.testing.assert_array_equal(g[0].numpy(),
                                      np.asarray(r).astype(g.numpy().dtype))
    np.testing.assert_array_equal(arrivals[0].numpy(), np.asarray(ref[5]))
    if overflow:
        assert int((arrivals > 4).sum()) > 0
