"""Explicit-halo marker engine on the mesh (either transport).

Port of ``pylamp_tpu/parallel/halo_markers.py`` (non-periodic): the
operations of the dense bucketed engine with hand-placed neighbour
exchanges.  Marker state (ny, nx, K) is split P("y", "x", None):
each shard owns the markers of its cell block, so every operation is local
up to a bounded halo:

- marker->grid (``m2g_fused_halo``): a one-deep ring exchange of the marker
  streams, then the per-shard fused transfer (markers/kernels/m2g_block),
  which computes each shard's nodes and the +1 seam row/column COMPLETELY;
  assembly is selection, with the seam strips psum-selected;
- the one-stream marker->grid transfer (``m2g_halo``, subgrid diffusion's):
  the same ring exchange of positions and values, then the dense-shift
  sums of ``m2g_block.m2g_block_sums`` per shard (the reference folds a
  scattered rim instead; the sums differ only in rounding);
- grid->marker (``g2m_halo``): a depth-(reach+1) exchange of the field
  block, then a bilinear gather;
- RK4 advection (``advect_rk4_halo``): one exchange of the two ghost-padded
  velocity lattices at the stage reach, then the per-shard RK4
  (markers/kernels/advect_block);
- rebucket (``rebucket_halo``): a one-deep ring exchange of the five marker
  streams and the per-shard repack in the single-device candidate order
  (markers/kernels/rebucket_block): bit-identical slot assignment;
- reseeding (``reseed_halo``): a one-deep exchange of the per-cell
  material histograms for the 3x3 majority, the cell-local spawn rule of
  ``bucket.bucket_reseed`` and ``g2m_halo`` for the new markers' T.
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import (
    OFFSETS,
    BucketedMarkers,
    material_histogram,
    mean_of,
    reseed_spawn,
    transform_values,
)
from pylamp_tpu_torch.markers.kernels.advect_block import (
    _sample_window,
    advect_block,
    advect_block_plain,
)
from pylamp_tpu_torch.markers.kernels.m2g_block import (
    m2g_block_sums,
    m2g_fused_block,
    m2g_fused_block_plain,
)
from pylamp_tpu_torch.markers.kernels.rebucket import repack_fits
from pylamp_tpu_torch.markers.kernels.rebucket_block import (
    rebucket_block,
    rebucket_block_plain,
)
from pylamp_tpu_torch.parallel.mesh import P, Mesh

BLK3 = P("y", "x", None)


def halo_markers_eligible(grid: StaggeredGrid, mesh: Mesh) -> bool:
    """Blocks divide evenly and hold the deepest halo the engine exchanges
    (reach-2 RK4 stage sampling needs 3 rows/cols)."""
    if not grid.uniform:
        return False
    my, mx = mesh.my, mesh.mx
    return (grid.ny % my == 0 and grid.nx % mx == 0
            and grid.ny // my >= 4 and grid.nx // mx >= 4)


def block_kernel_eligible(by: int, bx: int, K: int | None = None) -> bool:
    """The per-shard marker kernels' shape gate (the reference's
    m2g/advect/rebucket block gates without the platform test and the TPU
    VMEM model): block heights a multiple of 8; with ``K``, the per-shard
    repack's too: its plan holds K slots a cell in one block's shared
    memory (``rebucket.repack_fits``, K <= 993), as the reference's gate
    carries its VMEM model."""
    return by % 8 == 0 and by >= 8 and (K is None or repack_fits(K))


def _blocks(mesh: Mesh, grid: StaggeredGrid):
    return grid.ny // mesh.my, grid.nx // mesh.mx


# -- marker -> grid -------------------------------------------------------------


def _ext_blocks(mesh: Mesh, *streams):
    """Every shard's one-ring-extended (S, by+2, bx+2, K) block of each
    (ny, nx, K) stream (zeros, i.e. empty slots, beyond the domain)."""
    return [mesh.flat(e) for e in mesh.ext1_many(
        [mesh.split(a, BLK3) for a in streams], nd=3)]


def _assemble(mesh: Mesh, grid: StaggeredGrid, frames):
    """Global (rows, cols) lattices from the shards' (S, by+1, bx+1) node
    frames ``frames`` [(F, (rows, cols)), ...], each complete on its own
    nodes and the +1 seam strips: the interior blocks, and the seam row /
    column / corner selected from the last mesh row / column
    (psum-selected, as the reference).  One psum and one gather
    collective for all of them."""
    my, mx = mesh.my, mesh.mx
    ny, nx = grid.ny, grid.nx
    by, bx = _blocks(mesh, grid)
    sums, plan = [], []
    for F, (rows, cols) in frames:
        F = mesh.unflat(F)  # (*local_shape, by+1, bx+1)
        iy = mesh.axis_index("y", device=F.device)
        ix = mesh.axis_index("x", device=F.device)
        zero = torch.zeros((), dtype=F.dtype, device=F.device)
        parts = [(F[..., :by, :bx], P("y", "x"))]
        if cols == nx + 1:
            sums.append((torch.where(ix == mx - 1, F[..., :by, bx:], zero),
                         "x"))
            parts.append((len(sums) - 1, P("y", None)))
        if rows == ny + 1:
            sums.append((torch.where(iy == my - 1, F[..., by:, :bx], zero),
                         "y"))
            parts.append((len(sums) - 1, P(None, "x")))
            if cols == nx + 1:
                sums.append((torch.where((iy == my - 1) & (ix == mx - 1),
                                         F[..., by:, bx:], zero), ("y", "x")))
                parts.append((len(sums) - 1, P()))
        plan.append((rows, cols, parts))
    summed = mesh.psum_many(*sums) if sums else []
    got = iter(mesh.gather_many(*(
        (summed[b] if isinstance(b, int) else b, spec)
        for _, _, parts in plan for b, spec in parts)))
    out = []
    for rows, cols, parts in plan:
        a = next(got)
        if cols == nx + 1:
            a = torch.cat([a, next(got)], dim=1)
        if rows == ny + 1:
            bottom = next(got)
            if cols == nx + 1:
                bottom = torch.cat([bottom, next(got)], dim=1)
            a = torch.cat([a, bottom], dim=0)
        out.append(a)
    return out


def m2g_fused_halo(bm: BucketedMarkers, grid: StaggeredGrid, table, phys,
                   mesh: Mesh, with_energy: bool = False,
                   with_ra: bool = False, kernel: bool = True):
    """Explicit-halo fused marker->grid transfer: the raw weighted-sum dict
    of ``markers.kernels.m2g.m2g_fused`` on the global lattices.
    ``kernel``: the per-shard wrapper (kernel 10 on CUDA tensors); else its
    plain version on any dtype."""
    by, bx = _blocks(mesh, grid)
    bases = mesh.bases(by, bx, device=bm.x.device)
    transfer = m2g_fused_block if kernel else m2g_fused_block_plain
    fields = transfer(*_ext_blocks(mesh, bm.x, bm.y, bm.T, bm.mat, bm.valid),
                      grid, table, phys, bases, with_energy=with_energy,
                      with_ra=with_ra)
    locs = {"c": "corner", "n": "center", "vy": "vy", "vx": "vx"}
    return dict(zip(fields, _assemble(mesh, grid, [
        (F, grid.shape(locs[name.split("_")[0]]))
        for name, F in fields.items()])))


def m2g_halo(bm: BucketedMarkers, values, grid: StaggeredGrid, loc: str,
             mode: str, mesh: Mesh):
    """Explicit-halo ``bucket_markers_to_grid`` of one (ny, nx, K) value
    stream: returns (mean, wsum) on the ``loc`` lattice."""
    by, bx = _blocks(mesh, grid)
    v = transform_values(values, bm.valid, mode)
    xe, ye, ve, vale = _ext_blocks(mesh, bm.x, bm.y, v, bm.valid)
    w, (wv,) = m2g_block_sums(xe, ye, vale, [ve], grid, loc,
                              mesh.bases(by, bx, device=bm.x.device))
    shape = grid.shape(loc)
    field_w, field_wv = _assemble(mesh, grid, [(w, shape), (wv, shape)])
    return mean_of(field_wv, field_w, mode), field_w


# -- grid -> marker -------------------------------------------------------------


def _extend_lattice_block(mesh: Mesh, fI, fR, fB, fC, pl: int, ph: int):
    """A node-lattice block with ``pl`` halo rows/cols before and ``ph``
    after; fR/fB/fC: the +1 seam column/row/corner strips (None for
    lattices without them).  Zero beyond the domain, as the global engine's
    zero padding (those reads are weight-masked)."""
    dev = fI.device
    ix = mesh.axis_index("x", device=dev)

    def zeros(like, n, dim):
        shape = list(like.shape)
        shape[dim] = n
        return torch.zeros(shape, dtype=like.dtype, device=dev)

    def bottom(B):
        if B is None:
            return None
        B = mesh._full(B)
        return torch.cat([B, zeros(B, ph - 1, -2)], dim=-2)

    # every halo in one exchange round
    fields = [(fI, pl, ph, pl, ph, None, bottom(fB), False)]
    if fR is not None:
        fields.append((fR, pl, ph, 0, 0, None, bottom(fC), False))
    got = mesh.halos(*fields)
    rows, left, right = got[0]
    if fR is not None:
        rowsR = got[1][0]
        lastc = torch.cat([rowsR, zeros(rowsR, ph - 1, -1)], dim=-1)
    else:
        lastc = torch.zeros_like(right)
    right = torch.where(ix == mesh.mx - 1, lastc, right)
    return torch.cat([left, rows, right], dim=-1)


def g2m_halo(field, px, py, valid, grid: StaggeredGrid, loc: str, mesh: Mesh,
             reach: int = 1):
    """Explicit-halo ``bucket_grid_to_markers``: the ``loc``-lattice field
    at the (ny, nx, K) marker positions."""
    ny, nx = grid.ny, grid.nx
    by, bx = _blocks(mesh, grid)
    ny_n, nx_n = grid.shape(loc)
    has_brow, has_rcol = ny_n == ny + 1, nx_n == nx + 1
    oy, ox = grid.origin(loc)
    dev = field.device
    bases = mesh.bases(by, bx, device=dev).to(torch.int64)
    S = mesh.n_local
    rb = bases[:, 0].view(S, 1, 1, 1)
    cb = bases[:, 1].view(S, 1, 1, 1)
    cj = rb + torch.arange(by, device=dev).view(1, by, 1, 1)
    ci = cb + torch.arange(bx, device=dev).view(1, 1, bx, 1)

    blk = P("y", "x")
    fI = mesh.split(field[:ny, :nx], blk)
    fR = mesh.split(field[:ny, nx:], P("y", None)) if has_rcol else None
    fB = mesh.split(field[ny:, :nx], P(None, "x")) if has_brow else None
    fC = (mesh.split(field[ny:, nx:], P(None, None))
          if has_brow and has_rcol else None)
    ext = mesh.flat(_extend_lattice_block(mesh, fI, fR, fB, fC, reach,
                                          reach + 1))
    pxb, pyb, valb = (mesh.flat(mesh.split(a, BLK3)) for a in (px, py, valid))
    out = _sample_window(ext, (pxb - ox) / grid.dx, (pyb - oy) / grid.dy,
                         valb, reach, ny_n, nx_n, cj, ci, rb - reach,
                         cb - reach)
    return mesh.gather(mesh.unflat(out), BLK3)


# -- RK4 advection --------------------------------------------------------------


def velocity_windows(vx, vy, grid: StaggeredGrid, bcs: VelocityBCs,
                     mesh: Mesh, R: int):
    """Every shard's (S, by+2R+1, bx+2R+1) windows of the ghost-padded
    velocity lattices vx_p and vy_p: window (q, l) = padded node
    (row_base + q - R, col_base + l - R), zeros beyond them."""
    if bcs.periodic_x:
        # the reference has no wrap-around exchange path for the marker
        # engine: under periodic walls the markers stay on the global
        # tensors (models/step.py marker_halo_gate)
        raise ValueError(
            "periodic side walls: the explicit-halo marker engine has no "
            "wrap-around exchange path (the step keeps the markers on the "
            "global tensors)")
    mx = mesh.mx
    _, bx = _blocks(mesh, grid)
    dev = vx.device
    dtype = vx.dtype

    def zeros(rows, cols):
        return torch.zeros((*mesh.local_shape, rows, cols), dtype=dtype,
                           device=dev)

    def local(vxI, vxR, vyI, vyB):
        ix = mesh.axis_index("x", device=dev)

        # every halo in one exchange round.  vx in the padded vx_p frame
        # (ghost rows above/below the walls): R+1 rows from prev (wall:
        # zeros, then the ghost row), R from next (wall: the ghost row,
        # then zeros); vx has no ghost columns (marker x is clamped inside
        # the walls).  vy in the padded vy_p frame (ghost columns at the
        # side walls).
        def vx_walls(I):
            w = I.shape[-1]
            ghost_t = (bcs.s_top * I[..., :1, :]
                       + (1.0 - bcs.s_top) * bcs.vt_top)
            ghost_b = (bcs.s_bottom * I[..., -1:, :]
                       + (1.0 - bcs.s_bottom) * bcs.vt_bottom)
            return (torch.cat([zeros(R, w), mesh._full(ghost_t)], dim=-2),
                    torch.cat([mesh._full(ghost_b), zeros(R - 1, w)],
                              dim=-2))

        (rows, left, right), (rowsR, _, _), (vy_rows, vy_left, vy_right) = \
            mesh.halos(
                (vxI, R + 1, R, R, R + 1, *vx_walls(vxI), False),
                (vxR, R + 1, R, 0, 0, *vx_walls(vxR), False),
                (vyI, R, R + 1, R + 1, R, None,
                 torch.cat([mesh._full(vyB), zeros(R, bx)], dim=-2), False))
        h_rows = rows.shape[-2]  # by + 2R + 1
        lastc = torch.cat([rowsR, zeros(h_rows, R)], dim=-1)
        right = torch.where(ix == mx - 1, lastc, right)
        vx_ext = torch.cat([left, rows, right], dim=-1)

        ghost_l = (bcs.s_left * vy_rows[..., :1]
                   + (1.0 - bcs.s_left) * bcs.vt_left)
        left = torch.where(ix == 0, torch.cat(
            [zeros(h_rows, R), ghost_l], dim=-1), vy_left)
        ghost_r = (bcs.s_right * vy_rows[..., -1:]
                   + (1.0 - bcs.s_right) * bcs.vt_right)
        right = torch.where(ix == mx - 1, torch.cat(
            [ghost_r, zeros(h_rows, R - 1)], dim=-1), vy_right)
        vy_ext = torch.cat([left, vy_rows, right], dim=-1)
        return mesh.flat(vx_ext), mesh.flat(vy_ext)

    blk = P("y", "x")
    return local(mesh.split(vx[:, :-1], blk),
                 mesh.split(vx[:, -1:], P("y", None)),
                 mesh.split(vy[:-1, :], blk),
                 mesh.split(vy[-1:, :], P(None, "x")))


def advect_rk4_halo(bm: BucketedMarkers, vx, vy, dt, grid: StaggeredGrid,
                    bcs: VelocityBCs, mesh: Mesh, stage_reach: int = 2,
                    kernel: bool = True):
    """Explicit-halo ``bucket_advect_rk4``: one exchange of the two
    BC-ghost-padded velocity lattices at the stage reach, then every RK4
    stage samples locally.  ``kernel``: the per-shard wrapper (kernel 11
    on CUDA tensors); else its plain version."""
    by, bx = _blocks(mesh, grid)
    R = stage_reach
    vx_ext, vy_ext = velocity_windows(vx, vy, grid, bcs, mesh, R)
    xb, yb, vb = (mesh.flat(mesh.split(a, BLK3))
                  for a in (bm.x, bm.y, bm.valid))
    bases = mesh.bases(by, bx, device=vx.device)
    step = advect_block if kernel else advect_block_plain
    nx_b, ny_b = step(xb, yb, vb, vx_ext, vy_ext, dt, grid, bases, R)
    x, y = mesh.gather_many((mesh.unflat(nx_b), BLK3),
                            (mesh.unflat(ny_b), BLK3))
    return bm.replace(x=x, y=y)


# -- re-bucketing ---------------------------------------------------------------


def rebucket_halo(bm: BucketedMarkers, grid: StaggeredGrid, mesh: Mesh,
                  kernel: bool = True):
    """Explicit-halo rebucket: a one-deep ring of the marker streams, then
    the per-shard repack in the single-device candidate order (kernel 12
    on CUDA tensors with ``kernel``; else the plain version).  Returns
    (new markers, dropped) like ``bucket.rebucket``."""
    by, bx = _blocks(mesh, grid)
    K = bm.capacity
    dev = bm.x.device
    ext = _ext_blocks(mesh, bm.x, bm.y, bm.T, bm.mat, bm.valid)
    repack = rebucket_block if kernel else rebucket_block_plain
    new, arrivals = repack(*ext, grid, mesh.bases(by, bx, device=dev))
    # every shard's overflow, summed over the mesh (integers: exact in any
    # order)
    over = torch.clamp(arrivals - K, min=0).sum(dim=(1, 2))
    dropped = mesh.psum(mesh.unflat(over), ("y", "x")).reshape(-1)[0]
    names = ("x", "y", "mat", "T", "valid")
    return BucketedMarkers(**dict(zip(names, mesh.gather_many(*(
        (mesh.unflat(getattr(new, f)), BLK3) for f in names))))), dropped


# -- reseeding ------------------------------------------------------------------


def reseed_halo(bm: BucketedMarkers, T_grid, grid: StaggeredGrid,
                min_per_cell: int, n_materials: int, mesh: Mesh):
    """Explicit-halo ``bucket.bucket_reseed``: the 3x3 material majority
    from a one-deep exchange of the per-cell histograms (zeros beyond the
    domain, the global engine's padding), the cell-local spawn rule, and
    ``g2m_halo`` for the new markers' T."""
    by, bx = _blocks(mesh, grid)
    hist = mesh.ext1(mesh.split(material_histogram(bm, n_materials),
                                BLK3), nd=3)  # (my, mx, by+2, bx+2, NMAT)
    acc = torch.zeros_like(hist[..., 1:-1, 1:-1, :])
    for a, b in OFFSETS:
        acc = acc + hist[..., 1 + a:1 + a + by, 1 + b:1 + b + bx, :]
    majority = mesh.gather(torch.argmax(acc, dim=-1).to(torch.int32),
                           P("y", "x"))
    spawn, new_x, new_y, new_mat = reseed_spawn(bm, majority, grid,
                                                min_per_cell)
    T_at = g2m_halo(T_grid, new_x, new_y, spawn, grid, "corner", mesh)
    return bm.replace(x=new_x, y=new_y, T=torch.where(spawn, T_at.to(
        bm.T.dtype), bm.T), mat=new_mat, valid=bm.valid | spawn)
