"""Block forms of the stencil helpers a sharded step runs outside the
operators: each takes and returns sharded fields (``parallel/blocks.py``)
on a uniform grid, walled or with periodic side walls, and reads its
neighbours through ONE halo round (``mesh.halos``; under periodic side
walls the x halos ring over the torus seam).

Each computes, node for node, the arithmetic of its global counterpart
in the same order on the same values, so that its gathered result equals
the global function's bit for bit (a CPU test holds every form so):

- ``velocity_diagonals``, ``gershgorin_lambda`` (solvers/stokes_solver.py,
  solvers/mg.py), ``pressure_gradient`` (mg.py ``_pressure_gradient``),
  ``stokes_rhs`` (ops/stokes.py, moving no-slip walls included) and
  ``project_vx_mean`` (the constant-vx nullspace);
- ``energy_rhs`` (a prescribed flux included) and ``energy_diagonal``
  (solvers/energy_solver.py; its seam strips are psum-selected from their
  owner shards, as the halo energy operator's are);
- ``coarsen_eta`` and the MG transfers ``restrict`` / ``prolong``
  (solvers/mg.py ``restrict_vx`` and ``restrict_vy``, ``prolong_vx`` and
  ``prolong_vy``, full coarsening; the pair in one halo round);
- ``vrms`` (the step's diagnostic);
- the thermal path: ``strain_rate_ii`` (ops/stokes.py), ``center_to_corner``,
  ``shear_heating`` and ``adiabatic_heating`` (physics/heating.py: the
  edge clamp at the domain's x edges, periodic side walls included, as the
  global functions clamp; the neighbour's row or column at an interior
  seam);
- the energy multigrid's transfers (solvers/energy_mg.py):
  ``sample_corner`` (the coefficients at the surviving nodes),
  ``restrict_corner`` (one halo round, the strips psum-selected from their
  owners) and ``prolong_corner`` (one halo round), and ``flat_index``
  (each node's global flat index, the power iteration's start vector).

Periodic side walls: vx columns 0 and nx (and the corner lattice's) are
one node.  Where the global function emits the seam value once and
duplicates it (the halved rhs, the seam diagonal and gradient, the
restricted seam), the column-nx strip is selected from column 0's owners
(the first mesh column, one psum), so that both copies are equal bit for
bit on every shard; where it computes column nx from column nx's own
values (a prolonged correction, the energy rhs), so does the block form.
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.bc import DIRICHLET, NEUMANN, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.parallel.blocks import EXTRA, Blocks


def _cols(*a):
    return torch.cat(a, dim=-1)


def _rows(*a):
    return torch.cat(a, dim=-2)


def _axes(f: Blocks):
    """(iy, ix) broadcast index tensors of the local shards."""
    mesh, dev = f.mesh, f.device
    return mesh.axis_index("y", device=dev), mesh.axis_index("x", device=dev)


def node_coords(f: Blocks):
    """Global (row, col) indices of every node of ``f``'s lattice, as two
    int64 fields that broadcast against ``f``."""
    mesh, dev = f.mesh, f.device
    iy, ix = _axes(f)
    by, bx = f.I.shape[2], f.I.shape[3]
    ny, nx = by * mesh.my, bx * mesh.mx
    ey, ex = EXTRA[f.loc]
    r = iy * by + torch.arange(by, device=dev).view(by, 1)
    c = ix * bx + torch.arange(bx, device=dev).view(1, bx)
    rs = torch.full_like(iy, ny)
    cs = torch.full_like(ix, nx)
    rows = Blocks(f.mesh, f.loc, r, r if ex else None, rs if ey else None,
                  rs if ex and ey else None)
    cols = Blocks(f.mesh, f.loc, c, cs if ex else None, c if ey else None,
                  cs if ex and ey else None)
    return rows, cols


def _first(f: Blocks, axis: str):
    """The local shards' "first block along ``axis``" mask, (L, L, 1, 1)."""
    iy, ix = _axes(f)
    return (iy if axis == "y" else ix) == 0


def _last(f: Blocks, axis: str):
    iy, ix = _axes(f)
    return (iy == f.mesh.my - 1) if axis == "y" else (ix == f.mesh.mx - 1)


def _local_index(n: int, dev, axis: int):
    shape = [1, 1]
    shape[axis] = n
    return torch.arange(n, device=dev).view(shape)


# -- Stokes: diagonals, rhs, pressure gradient, Gershgorin ---------------------


def _periodic(bcs) -> bool:
    return bcs is not None and bcs.periodic_x


def _from_first_x(mesh, *cols):
    """Each (L, L, rows, 1) column as the first mesh column's shards hold
    it, handed to every shard of their mesh row (one psum): the column-nx
    strip of a periodic lattice, which is column 0's value."""
    ix = mesh.axis_index("x", device=cols[0].device)
    zero = torch.zeros((), dtype=cols[0].dtype, device=cols[0].device)
    return mesh.psum_many(*((torch.where(ix == 0, c, zero), "x")
                            for c in cols))


def _diag_frames(eta_s: Blocks, eta_n: Blocks, periodic: bool):
    """In one halo round: eta_n with its left column (the ring's under
    periodic side walls) and its upper row, eta_s with its lower row and
    its right column (the seam strips at the domain's last row /
    column)."""
    mesh = eta_n.mesh
    last_x = _last(eta_s, "x")
    (en_rows, en_left, _), (es_rows, _, es_right) = mesh.halos(
        (eta_n.I, 1, 0, 1, 0, None, None, periodic),
        (eta_s.I, 0, 1, 0, 1, None, eta_s.B, False))
    by = eta_n.I.shape[2]
    en_l = _cols(en_left[..., 1:, :], en_rows[..., 1:, :])  # (by, bx+1)
    en_u = en_rows  # (by+1, bx)
    es_d = es_rows  # (by+1, bx)
    es_r = _cols(es_rows[..., :by, :],
                 torch.where(last_x, eta_s.R, es_right[..., :by, :]))
    return en_l, en_u, es_d, es_r


def velocity_diagonals(eta_s: Blocks, eta_n: Blocks, grid: StaggeredGrid,
                       kbnd, bcs=None):
    """``solvers/stokes_solver.py velocity_diagonals`` on blocks (periodic
    side walls: the wrapped seam diagonal, half in each seam column)."""
    return _diagonals(eta_s, eta_n, grid, kbnd, _periodic(bcs))[0]


def _diagonals(eta_s: Blocks, eta_n: Blocks, grid: StaggeredGrid, kbnd,
               periodic: bool = False):
    """``velocity_diagonals`` and the halo frames it read (``es_d``,
    ``es_r``), for a caller that needs both from one halo round."""
    dx, dy = grid.dx, grid.dy
    en_l, en_u, es_d, es_r = _diag_frames(eta_s, eta_n, periodic)
    by, bx = eta_n.I.shape[2:4]
    dev = eta_n.device
    # (periodic: column 0's left neighbour is the ring's column nx - 1,
    # so the seam row reads en[0] + en[nx - 1], the global order)
    dvx = (2.0 * (en_l[..., 1:] + en_l[..., :-1]) / dx**2
           + (es_d[..., 1:, :] + es_d[..., :-1, :]) / dy**2)
    dvy = (2.0 * (en_u[..., 1:, :] + en_u[..., :-1, :]) / dy**2
           + (es_r[..., 1:] + es_r[..., :-1]) / dx**2)
    kb = torch.as_tensor(kbnd, dtype=eta_n.dtype, device=dev)
    mesh = eta_n.mesh
    wall_x, wall_y = _wall_col0(mesh, dvx), _wall_row0(mesh, dvy)
    if periodic:
        dvx = torch.where(wall_x, 0.5 * dvx, dvx)
        strip_x, = _from_first_x(mesh, dvx[..., :1])
    else:
        dvx = torch.where(wall_x, kb, dvx)
        strip_x = kb.expand(*mesh.local_shape, by, 1)
    strip_y = kb.expand(*mesh.local_shape, 1, bx)
    return ((Blocks(mesh, "vx", dvx, strip_x),
             Blocks(mesh, "vy", torch.where(wall_y, kb, dvy), B=strip_y)),
            (es_d, es_r))


def gershgorin_lambda(eta_s: Blocks, eta_n: Blocks, grid: StaggeredGrid,
                      kbnd, bcs=None):
    """``solvers/mg.py gershgorin_lambda`` on blocks: the row-sum ratios
    on every shard's interior momentum rows (never the seam rows), one
    mesh maximum."""
    (dvx, dvy), (es_d, es_r) = _diagonals(eta_s, eta_n, grid, kbnd,
                                          _periodic(bcs))
    dx, dy = grid.dx, grid.dy
    dev = eta_n.device
    cross_vx = 2.0 * (es_d[..., 1:, :] + es_d[..., :-1, :]) / (dx * dy)
    cross_vy = 2.0 * (es_r[..., 1:] + es_r[..., :-1]) / (dx * dy)
    low = torch.tensor(float("-inf"), dtype=eta_n.dtype, device=dev)
    mesh = eta_n.mesh
    rx = torch.where(_wall_col0(mesh, cross_vx), low, cross_vx / dvx.I)
    ry = torch.where(_wall_row0(mesh, cross_vy), low, cross_vy / dvy.I)
    part = torch.maximum(torch.amax(rx, dim=(-2, -1)),
                         torch.amax(ry, dim=(-2, -1)))
    bxy = mesh.total(part, "max")
    return 2.0 + bxy


def _pieces(like: Blocks, **given):
    """A field on ``like``'s lattice with the ``given`` pieces (each
    broadcast to its piece's shape) and zeros elsewhere: the term of a
    ``torch.where`` that selects only the given pieces' nodes."""
    return Blocks(like.mesh, like.loc, *(
        None if p is None else (given[n].expand_as(p) if n in given
                                else torch.zeros_like(p))
        for n, p in zip(("I", "R", "B", "C"),
                        (like.I, like.R, like.B, like.C))))


def stokes_rhs(rho_vx: Blocks, rho_vy: Blocks, gx, gy, grid: StaggeredGrid,
               bcs: VelocityBCs, kbnd, dtype, eta_s: Blocks = None):
    """``ops/stokes.py stokes_rhs`` on blocks: the moving no-slip walls'
    2 eta_s v_t / h^2 on the wall-adjacent rows (every term on the wall
    blocks' own pieces), then the Dirichlet rows or, under periodic side
    walls, the seam buoyancy halved in both seam columns."""
    bx = (rho_vx * gx).to(dtype)
    by = (rho_vy * gy).to(dtype)
    kb = torch.as_tensor(kbnd, device=bx.device)
    rows_x, cols = node_coords(bx)
    rows, cols_y = node_coords(by)
    nx, ny = grid.nx, grid.ny
    inner_x = (cols > 0) & (cols < nx)
    inner_y = (rows > 0) & (rows < ny)
    dy2_top, dy2_bot = grid.dys[0] ** 2, grid.dys[-1] ** 2
    dx2_left, dx2_right = grid.dxs[0] ** 2, grid.dxs[-1] ** 2

    def moving(f, sel, es, v, h2):
        # the global form's bx[0, 1:-1] += 2.0 * eta_s[0, 1:-1] * v / h^2
        # (and its three twins), in place in the rhs dtype
        return torch.where(sel, (f + _pieces(f, I=2.0 * es * v / h2)).to(
            dtype), f)

    if bcs.top == "no_slip" and bcs.vt_top != 0.0:
        bx = moving(bx, (rows_x == 0) & inner_x, eta_s.I[..., :1, :],
                    bcs.vt_top, dy2_top)
    if bcs.bottom == "no_slip" and bcs.vt_bottom != 0.0:
        bx = moving(bx, (rows_x == ny - 1) & inner_x, eta_s.B,
                    bcs.vt_bottom, dy2_bot)
    if bcs.left == "no_slip" and bcs.vt_left != 0.0:
        by = moving(by, (cols_y == 0) & inner_y, eta_s.I[..., :, :1],
                    bcs.vt_left, dx2_left)
    if bcs.right == "no_slip" and bcs.vt_right != 0.0:
        by = moving(by, (cols_y == nx - 1) & inner_y, eta_s.R,
                    bcs.vt_right, dx2_right)
    if bcs.periodic_x:
        bx = torch.where((cols == 0) | (cols == nx), 0.5 * bx, bx)
    else:
        bx = torch.where(cols == 0, (kb * bcs.vn_left).to(dtype), bx)
        bx = torch.where(cols == nx, (kb * bcs.vn_right).to(dtype), bx)
    by = torch.where(rows == 0, (kb * bcs.vn_top).to(dtype), by)
    by = torch.where(rows == ny, (kb * bcs.vn_bottom).to(dtype), by)
    bc = torch.zeros_like(rho_vx.I, dtype=dtype)
    return bx, by, Blocks(bx.mesh, "center", bc)


def project_vx_mean(vx: Blocks) -> Blocks:
    """``solvers/stokes_solver.py project_vx_mean`` on blocks: the mean
    over columns 0 .. nx - 1 (the duplicated seam column counted once), a
    mesh mean of the blocks in psum's shard order."""
    return vx - torch.mean(Blocks(vx.mesh, "center", vx.I))


def pressure_gradient(zp: Blocks, grid: StaggeredGrid, dtype, bcs=None):
    """``solvers/mg.py _pressure_gradient`` on blocks (periodic side walls:
    the wrapped seam gradient, half in each seam column)."""
    mesh = zp.mesh
    periodic = _periodic(bcs)
    (rows, left, _), = mesh.halos((zp.I, 1, 0, 1, 0, None, None, periodic))
    by, bx = zp.I.shape[2:4]
    dev = zp.device
    zl = _cols(left[..., 1:, :], rows[..., 1:, :])
    gy = (rows[..., 1:, :] - rows[..., :-1, :]) / grid.dy
    gy = _zero_where(_wall_row0(mesh, gy), gy)
    zt = torch.zeros((*mesh.local_shape, 1, bx), dtype=dtype, device=dev)
    if periodic:
        # the seam: 0.5 * (zp[0] - zp[nx - 1]) / dx, the ring's column
        dz = zl[..., 1:] - zl[..., :-1]
        gx = torch.where(_wall_col0(mesh, dz), 0.5 * dz, dz) / grid.dx
        strip, = _from_first_x(mesh, gx[..., :1])
        return Blocks(mesh, "vx", gx, strip), Blocks(mesh, "vy", gy, B=zt)
    gx = (zl[..., 1:] - zl[..., :-1]) / grid.dx
    gx = _zero_where(_wall_col0(mesh, gx), gx)
    z = torch.zeros((*mesh.local_shape, by, 1), dtype=dtype, device=dev)
    return Blocks(mesh, "vx", gx, z), Blocks(mesh, "vy", gy, B=zt)


# -- energy: rhs and diagonal -----------------------------------------------------


def dirichlet_masks(T: Blocks, bcs: ThermalBCs):
    """``ops/energy.py _dirichlet_masks`` on ``T``'s blocks (sides first,
    then top / bottom: horizontal walls win the corners)."""
    rows, cols = node_coords(T)
    ny, nx = T.shape[0] - 1, T.shape[1] - 1
    mask = torch.zeros_like(T, dtype=torch.bool)
    vals = torch.zeros_like(T)
    for wall, sel in (("left", cols == 0), ("right", cols == nx),
                      ("top", rows == 0), ("bottom", rows == ny)):
        bc = getattr(bcs, wall)
        if bc.kind == DIRICHLET:
            mask = mask | sel
            vals = torch.where(sel, torch.tensor(bc.value, dtype=T.dtype,
                                                 device=T.device), vals)
    return mask, vals


def energy_rhs(T_old: Blocks, k: Blocks, rhocp_over_dt, H,
               grid: StaggeredGrid, bcs: ThermalBCs, kbnd,
               k_avg: str = "arithmetic"):
    """``ops/energy.py energy_rhs`` on blocks: the seam rows halved under
    periodic side walls, then each prescribed flux's 2 k_face g / h on its
    wall's nodes (sides first, then top / bottom, as the global form adds
    them), then the Dirichlet rows."""
    b = rhocp_over_dt * T_old + H
    rows, cols = node_coords(T_old)
    ny, nx = grid.ny, grid.nx
    if bcs.periodic_x:
        b = torch.where((cols == 0) | (cols == nx), 0.5 * b, b)
    flux = {w: getattr(bcs, w).value for w in ("left", "right", "top",
                                                "bottom")
            if getattr(bcs, w).kind == NEUMANN
            and getattr(bcs, w).value != 0.0}
    if flux:
        b = _flux_terms(b, k, flux, rows, cols, grid, k_avg)
    mask, vals = dirichlet_masks(T_old, bcs)
    return torch.where(mask, kbnd * vals, b)


def _flux_terms(b: Blocks, k: Blocks, flux: dict, rows, cols,
                grid: StaggeredGrid, k_avg: str):
    """``b`` plus the prescribed-flux constants 2.0 * k_face * g / h of the
    walls in ``flux`` (wall -> g), in the global form's order.  Each face
    lies inside its wall's blocks and strips; a strip that every shard of
    a mesh row or column holds (R, B, C) but whose face reads a block's
    edge is computed on the wall's shards and psum-selected (one psum)."""
    mesh = k.mesh
    dx, dy = grid.dx, grid.dy
    ny, nx = grid.ny, grid.nx
    last_x, last_y = _last(k, "x"), _last(k, "y")
    zero = torch.zeros((), dtype=k.dtype, device=k.device)

    def face(a, c):
        return _face(a, c, k_avg)

    def dx_term(kf, g):
        return 2.0 * kf * g / dx

    def dy_term(kf, g):
        return 2.0 * kf * g / dy

    # the owner-computed strips: the right wall's R and C (faces of column
    # nx - 1 and nx), the bottom wall's B and C (rows ny - 1 and ny)
    owned = []
    if "right" in flux:
        g = flux["right"]
        owned += [(torch.where(last_x, dx_term(face(k.I[..., -1:], k.R), g),
                               zero), "x"),
                  (torch.where(last_x, dx_term(face(k.B[..., -1:], k.C), g),
                               zero), "x")]
    if "bottom" in flux:
        g = flux["bottom"]
        owned += [(torch.where(last_y, dy_term(face(k.I[..., -1:, :], k.B),
                                               g), zero), "y"),
                  (torch.where(last_y, dy_term(face(k.R[..., -1:, :], k.C),
                                               g), zero), "y")]
    got = iter(mesh.psum_many(*owned) if owned else [])
    for wall, g in flux.items():
        if wall == "left":
            term = _pieces(b, I=dx_term(face(k.I[..., :1], k.I[..., 1:2]), g),
                           B=dx_term(face(k.B[..., :1], k.B[..., 1:2]), g))
            sel = cols == 0
        elif wall == "right":
            term = _pieces(b, R=next(got), C=next(got))
            sel = cols == nx
        elif wall == "top":
            term = _pieces(b, I=dy_term(face(k.I[..., :1, :],
                                             k.I[..., 1:2, :]), g),
                           R=dy_term(face(k.R[..., :1, :], k.R[..., 1:2, :]),
                                     g))
            sel = rows == 0
        else:
            term = _pieces(b, B=next(got), C=next(got))
            sel = rows == ny
        b = torch.where(sel, b + term, b)
    return b


def _owned_strips(mesh, like: Blocks, R, B, C, first_col: bool = False):
    """The corner lattice's seam strips, each computed on its owner shards
    (R on the last mesh column, or the first with ``first_col``; B on the
    last row; C on the last row's last (first) shard) and summed from
    there (one psum)."""
    col = _first(like, "x") if first_col else _last(like, "x")
    last_y = _last(like, "y")
    zero = torch.zeros((), dtype=R.dtype, device=R.device)
    return mesh.psum_many((torch.where(col, R, zero), "x"),
                          (torch.where(last_y, B, zero), "y"),
                          (torch.where(col & last_y, C, zero), ("y", "x")))


def _face(a, b, mode):
    if mode == "arithmetic":
        return 0.5 * (a + b)
    if mode == "harmonic":
        return 2.0 * a * b / (a + b)
    raise ValueError(f"unknown k averaging mode {mode!r}")


def _diag_on(kf, rc, dx, dy, mode):
    """rc + the conductance sums of the nodes inside frame ``kf`` (one
    ring wider than ``rc``): energy_diagonal's arithmetic."""
    kx = _face(kf[..., :-1], kf[..., 1:], mode)
    ky = _face(kf[..., :-1, :], kf[..., 1:, :], mode)
    return (rc + (kx[..., 1:-1, 1:] + kx[..., 1:-1, :-1]) / dx**2
            + (ky[..., 1:, 1:-1] + ky[..., :-1, 1:-1]) / dy**2)


def energy_diagonal(k: Blocks, rhocp_over_dt: Blocks, grid: StaggeredGrid,
                    bcs: ThermalBCs, kbnd, k_avg: str):
    """``solvers/energy_solver.py energy_diagonal`` on blocks: mirror ghosts
    beyond the walls, the seam strips from their owner shards (one psum).
    Periodic side walls: the ring's ghost columns, the column-nx strip
    (west column nx - 1, east column 1) on the first mesh column, which
    holds both, and both seam columns halved."""
    from pylamp_tpu_torch.parallel.halo_ops import corner_frames

    mesh = k.mesh
    periodic = bcs.periodic_x
    dx, dy = grid.dx, grid.dy
    rc = rhocp_over_dt
    (k_ext, kR_ext), = corner_frames(mesh, [(k.I, k.R, k.B, k.C)], periodic)
    dI = _diag_on(k_ext, rc.I, dx, dy, k_avg)
    if periodic:
        # column nx between the ring's column nx - 1 and column 1
        ks = _cols(k_ext[..., 0:1], kR_ext, k_ext[..., 2:3])
        kw = _cols(k_ext[..., -2:, 0:1], kR_ext[..., -2:, :],
                   k_ext[..., -2:, 2:3])
        kc = _rows(kw, kw[..., 0:1, :])
    else:
        ks = _cols(k_ext[..., -2:], k_ext[..., -2:-1])  # nx-1, nx, nx-1
        kw = k_ext[..., -2:, -2:]
        kc = _cols(kw, kw[..., 0:1])
        kc = _rows(kc, kc[..., 0:1, :])
    dR = _diag_on(ks, rc.R, dx, dy, k_avg)
    kb = _rows(k_ext[..., -2:, :], k_ext[..., -2:-1, :])
    dB = _diag_on(kb, rc.B, dx, dy, k_avg)
    dC = _diag_on(kc, rc.C, dx, dy, k_avg)
    if periodic:
        seam = _wall_col0(mesh, dI)
        dI = torch.where(seam, 0.5 * dI, dI)
        dB = torch.where(_wall_col0(mesh, dB), 0.5 * dB, dB)
        dR, dC = 0.5 * dR, 0.5 * dC
    diag = Blocks(mesh, "corner", dI,
                  *_owned_strips(mesh, k, dR, dB, dC, first_col=periodic))
    mask, _ = dirichlet_masks(k, bcs)
    return torch.where(mask, kbnd, diag)


# -- multigrid --------------------------------------------------------------------


def coarsen_eta(eta_s: Blocks, eta_n: Blocks):
    """``solvers/mg.py coarsen_eta`` (both axes) on blocks of even size:
    block-local (the blocks start on even nodes)."""
    en = eta_n.I
    en_c = torch.exp(0.25 * (torch.log(en[..., 0::2, 0::2])
                             + torch.log(en[..., 0::2, 1::2])
                             + torch.log(en[..., 1::2, 0::2])
                             + torch.log(en[..., 1::2, 1::2])))
    es_c = Blocks(eta_s.mesh, "corner", eta_s.I[..., 0::2, 0::2],
                  eta_s.R[..., 0::2, :], eta_s.B[..., :, 0::2], eta_s.C)
    return es_c, Blocks(eta_n.mesh, "center", en_c)


def _interleave_rows(a, b):
    return torch.stack([a, b], dim=-2).reshape(
        *a.shape[:-2], 2 * a.shape[-2], a.shape[-1])


def _interleave_cols(a, b):
    return torch.stack([a, b], dim=-1).reshape(
        *a.shape[:-1], 2 * a.shape[-1])


def _zero_where(mask, a):
    return torch.where(mask, torch.zeros((), dtype=a.dtype, device=a.device),
                       a)


def _wall_col0(mesh, a):
    """Global column 0 of the (L, L, by, bx) blocks ``a``."""
    ix = mesh.axis_index("x", device=a.device)
    return (ix == 0) & (_local_index(a.shape[-1], a.device, 1) == 0)


def _wall_row0(mesh, a):
    iy = mesh.axis_index("y", device=a.device)
    return (iy == 0) & (_local_index(a.shape[-2], a.device, 0) == 0)


def _y_weight(F):
    """The restriction's y stencil (0.25, 0.75, 0.75, 0.25) / 2 of a frame
    with one row above and one below."""
    return (0.25 * F[..., 0:-3:2, :] + 0.75 * F[..., 1:-2:2, :]
            + 0.75 * F[..., 2:-1:2, :] + 0.25 * F[..., 3::2, :]) / 2.0


def restrict(fx: Blocks, fy: Blocks, bcs: VelocityBCs):
    """``solvers/mg.py restrict_vx`` and ``restrict_vy`` (both axes) on
    blocks, their halos in one round.  Periodic side walls: the ring's
    columns, the fine seam columns folded into column 0 (its R strip's
    y-restriction added on the first mesh column) and the coarse seam
    emitted as equal halves (the R strip from the first mesh column)."""
    mesh = fx.mesh
    periodic = bcs.periodic_x
    fzx = fx.I if periodic else _zero_where(_wall_col0(mesh, fx.I), fx.I)
    fzy = _zero_where(_wall_row0(mesh, fy.I), fy.I)
    fields = [(fzx, 1, 1, 1, 0, bcs.s_top * fzx[..., :1, :],
               bcs.s_bottom * fzx[..., -1:, :], periodic),
              (fzy, 1, 0, 1, 1, None, None, periodic)]
    if periodic:
        fields.append((fx.R, 1, 1, 0, 0, bcs.s_top * fx.R[..., :1, :],
                       bcs.s_bottom * fx.R[..., -1:, :], False))
    got = mesh.halos(*fields)
    (rows, left, _), (rows_y, left_y, right_y) = got[:2]
    # vx: rows with the wall ghosts, then columns with a zero pad (the
    # ring's column and the fold under periodic walls)
    g = _y_weight(_cols(left, rows))
    if periodic:
        fold = _first(fx, "x") & (_local_index(g.shape[-1], g.device, 1) == 1)
        g = torch.where(fold, g + _y_weight(got[2][0]), g)
    c = (0.5 * g[..., 0:-2:2] + 1.0 * g[..., 1:-1:2] + 0.5 * g[..., 2::2])
    c = c / 2.0
    if periodic:
        c = torch.where(_wall_col0(mesh, c), 0.5 * c, c)
        cx = Blocks(mesh, "vx", c, *_from_first_x(mesh, c[..., :1]))
    else:
        cx = Blocks(mesh, "vx", _zero_where(_wall_col0(mesh, c), c),
                    torch.zeros_like(c[..., :1]))
    # vy: columns with the wall ghosts (the ring under periodic walls),
    # then rows with a zero pad
    if not periodic:
        left_y = torch.where(_first(fy, "x"), bcs.s_left * rows_y[..., :1],
                             left_y)
        right_y = torch.where(_last(fy, "x"), bcs.s_right * rows_y[..., -1:],
                              right_y)
    G = _cols(left_y, rows_y, right_y)
    g = (0.25 * G[..., 0:-3:2] + 0.75 * G[..., 1:-2:2]
         + 0.75 * G[..., 2:-1:2] + 0.25 * G[..., 3::2]) / 2.0
    c = (0.5 * g[..., 0:-2:2, :] + 1.0 * g[..., 1:-1:2, :]
         + 0.5 * g[..., 2::2, :])
    c = c / 2.0
    cy = Blocks(mesh, "vy", _zero_where(_wall_row0(mesh, c), c),
                B=torch.zeros_like(c[..., :1, :]))
    return cx, cy


def prolong(cx: Blocks, cy: Blocks, bcs: VelocityBCs):
    """``solvers/mg.py prolong_vx`` and ``prolong_vy`` (both axes) on
    blocks, their halos in one round.  Periodic side walls: no Dirichlet
    columns, the ring's vy columns, and the fine column-nx strip
    interpolated from the coarse one, as the global form does."""
    mesh = cx.mesh
    periodic = bcs.periodic_x
    czx = cx.I if periodic else _zero_where(_wall_col0(mesh, cx.I), cx.I)
    czy = _zero_where(_wall_row0(mesh, cy.I), cy.I)
    fields = [(czx, 1, 1, 0, 1, bcs.s_top * czx[..., :1, :],
               bcs.s_bottom * czx[..., -1:, :], False),
              (czy, 0, 1, 1, 1, None, None, periodic)]
    if periodic:
        fields.append((cx.R, 1, 1, 0, 0, bcs.s_top * cx.R[..., :1, :],
                       bcs.s_bottom * cx.R[..., -1:, :], False))
    got = mesh.halos(*fields)
    (CG, _, right), (rows_y, left_y, right_y) = got[:2]

    def along_rows(E):
        a0 = 0.25 * E[..., :-2, :] + 0.75 * E[..., 1:-1, :]
        a1 = 0.75 * E[..., 1:-1, :] + 0.25 * E[..., 2:, :]
        return _interleave_rows(a0, a1)

    # vx: rows (wall ghosts) interpolated, then the odd columns; the last
    # mesh column's right neighbour is the coarse column NX (the R strip)
    if periodic:
        RG = got[2][0]
        right = torch.where(_last(cx, "x"), RG, right)
    e = along_rows(_cols(CG, right))
    odd = 0.5 * (e[..., :-1] + e[..., 1:])
    f = _interleave_cols(e[..., :-1], odd)
    if periodic:
        fx = Blocks(mesh, "vx", f, along_rows(RG))
    else:
        fx = Blocks(mesh, "vx", _zero_where(_wall_col0(mesh, f), f),
                    torch.zeros_like(f[..., :1]))
    # vy: columns (wall ghosts, the ring under periodic walls)
    # interpolated, then the odd rows
    if not periodic:
        left_y = torch.where(_first(cy, "x"), bcs.s_left * rows_y[..., :1],
                             left_y)
        right_y = torch.where(_last(cy, "x"), bcs.s_right * rows_y[..., -1:],
                              right_y)
    CG = _cols(left_y, rows_y, right_y)
    a0 = 0.25 * CG[..., :-2] + 0.75 * CG[..., 1:-1]
    a1 = 0.75 * CG[..., 1:-1] + 0.25 * CG[..., 2:]
    e = _interleave_cols(a0, a1)
    odd = 0.5 * (e[..., :-1, :] + e[..., 1:, :])
    f = _interleave_rows(e[..., :-1, :], odd)
    fy = Blocks(mesh, "vy", _zero_where(_wall_row0(mesh, f), f),
                B=torch.zeros_like(f[..., :1, :]))
    return fx, fy


# -- diagnostics --------------------------------------------------------------------


def vrms(vx: Blocks, vy: Blocks):
    """The step's ``vrms``: the root mean square of the cell-centred
    velocity, one halo round and one mesh mean."""
    mesh = vx.mesh
    (_, _, right), (vy_rows, _, _) = mesh.halos(
        (vx.I, 0, 0, 0, 1, None, None, False),
        (vy.I, 0, 1, 0, 0, None, vy.B, False))
    right = torch.where(_last(vx, "x"), vx.R, right)
    vxe = _cols(vx.I, right)
    cx = 0.5 * (vxe[..., 1:] + vxe[..., :-1])
    cy = 0.5 * (vy_rows[..., 1:, :] + vy_rows[..., :-1, :])
    return torch.sqrt(torch.mean(Blocks(mesh, "center", cx ** 2 + cy ** 2)))


# -- the thermal path: strain rate and heating --------------------------------------


def strain_rate_ii(vx: Blocks, vy: Blocks, grid: StaggeredGrid,
                   bcs: VelocityBCs):
    """``ops/stokes.py strain_rate_ii`` on blocks (uniform): one halo round
    of vx (wall ghost rows, the R strip at the right seam) and vy (wall
    ghost columns, or the ring's under periodic side walls; the B strip at
    the bottom seam) for the corner shear rate around each cell."""
    mesh = vx.mesh
    periodic = bcs.periodic_x
    first_x, last_x = _first(vx, "x"), _last(vx, "x")
    (vx_rows, _, right), (vxR_rows, _, _), (vy_rows, vy_left, vy_right) = \
        mesh.halos(
            (vx.I, 1, 1, 0, 1, bcs.s_top * vx.I[..., :1, :],
             bcs.s_bottom * vx.I[..., -1:, :], False),
            (vx.R, 1, 1, 0, 0, bcs.s_top * vx.R[..., :1, :],
             bcs.s_bottom * vx.R[..., -1:, :], False),
            (vy.I, 0, 1, 1, 1, None, vy.B, periodic))
    vx_ext = _cols(vx_rows, torch.where(last_x, vxR_rows, right))
    if not periodic:  # (periodic: the ring's columns, _ghost_vy's wrap)
        vy_left = torch.where(first_x, bcs.s_left * vy_rows[..., :1],
                              vy_left)
        vy_right = torch.where(last_x, bcs.s_right * vy_rows[..., -1:],
                               vy_right)
    vy_ext = _cols(vy_left, vy_rows, vy_right)
    dvxdx = (vx_ext[..., 1:-1, 1:] - vx_ext[..., 1:-1, :-1]) / grid.dx
    dvydy = (vy_rows[..., 1:, :] - vy_rows[..., :-1, :]) / grid.dy
    # the corner shear rate (the global form's sxy with eta_s = 1)
    sxy = ((vx_ext[..., 1:, :] - vx_ext[..., :-1, :]) / grid.dy
           + (vy_ext[..., 1:] - vy_ext[..., :-1]) / grid.dx)
    exx = 0.5 * (dvxdx - dvydy)
    e = 0.5 * sxy
    exy = 0.25 * (e[..., :-1, :-1] + e[..., :-1, 1:] + e[..., 1:, :-1]
                  + e[..., 1:, 1:])
    return Blocks(mesh, "center", torch.sqrt(exx ** 2 + exy ** 2))


def _corner_avg(F):
    return 0.25 * (F[..., :-1, :-1] + F[..., :-1, 1:] + F[..., 1:, :-1]
                   + F[..., 1:, 1:])


def center_to_corner(f: Blocks) -> Blocks:
    """``physics/heating.py _center_to_corner`` on blocks: the 4-point
    average of the cells around each corner, the cell field clamped at the
    domain's edges, periodic side walls included, as the global form pads
    (on the wall blocks only: an interior seam takes the neighbour's row or
    column, one halo round); the seam strips read the last cell row /
    column only, so their owners compute them (one psum)."""
    mesh = f.mesh
    (rows, left, _), = mesh.halos((f.I, 1, 0, 1, 0, f.I[..., :1, :], None,
                                   False))
    F = _cols(torch.where(_first(f, "x"), rows[..., :1], left), rows)
    col = rows[..., -1:]  # (by+1, 1): cell column nx-1
    R = _corner_avg(_cols(col, col))
    brow = F[..., -1:, :]  # (1, bx+1): cell row ny-1
    B = _corner_avg(_rows(brow, brow))
    c = rows[..., -1:, -1:]
    C = _corner_avg(_rows(_cols(c, c), _cols(c, c)))
    return Blocks(mesh, "corner", _corner_avg(F),
                  *_owned_strips(mesh, f, R, B, C))


def shear_heating(vx: Blocks, vy: Blocks, eta_n: Blocks,
                  grid: StaggeredGrid, bcs: VelocityBCs) -> Blocks:
    """``physics/heating.py shear_heating`` on blocks."""
    eII = strain_rate_ii(vx, vy, grid, bcs)
    return center_to_corner(4.0 * eta_n * eII ** 2)


def adiabatic_heating(T_corner: Blocks, rho_alpha_corner: Blocks,
                      vy: Blocks, gy) -> Blocks:
    """``physics/heating.py adiabatic_heating`` on blocks: vy's edge
    columns clamped on the wall blocks (periodic side walls too, as the
    global form pads), the left neighbour's last column
    at an interior seam (one halo round); the R strip reads vy's column
    nx-1 only, so the last mesh column computes it (one psum)."""
    mesh = vy.mesh
    first_x, last_x = _first(vy, "x"), _last(vy, "x")
    (_, left, _), (_, left_b, _) = mesh.halos(
        (vy.I, 0, 0, 1, 0, None, None, False),
        (vy.B, 0, 0, 1, 0, None, None, False))
    V = _cols(torch.where(first_x, vy.I[..., :1], left), vy.I)
    Vb = _cols(torch.where(first_x, vy.B[..., :1], left_b), vy.B)
    col, cb = vy.I[..., -1:], vy.B[..., -1:]
    zero = torch.zeros((), dtype=vy.dtype, device=vy.device)
    R, C = mesh.psum_many((torch.where(last_x, 0.5 * (col + col), zero), "x"),
                          (torch.where(last_x, 0.5 * (cb + cb), zero), "x"))
    vy_corner = Blocks(mesh, "corner", 0.5 * (V[..., :-1] + V[..., 1:]), R,
                       0.5 * (Vb[..., :-1] + Vb[..., 1:]), C)
    return rho_alpha_corner * T_corner * gy * vy_corner


# -- the energy multigrid ---------------------------------------------------------


def flat_index(f: Blocks) -> Blocks:
    """Every node's global flat (row-major) index on ``f``'s lattice, an
    int64 field: the block form of ``torch.arange(numel).reshape(shape)``."""
    rows, cols = node_coords(f)
    return rows * f.shape[1] + cols


def sample_corner(f: Blocks) -> Blocks:
    """``f[::2, ::2]`` of a corner field on blocks of even size: the nodes
    that survive a full coarsening (the blocks start on even nodes, so
    each keeps its global parity)."""
    return Blocks(f.mesh, "corner", f.I[..., 0::2, 0::2], f.R[..., 0::2, :],
                  f.B[..., :, 0::2], f.C)


def _full_weight(F, axis: int):
    """The full-weighting stencil (0.5, 1, 0.5) / 2 along ``axis`` (-1 or
    -2) of a frame whose first entry is the node before the first output's
    centre."""
    def cut(start, stop):
        idx = [slice(None)] * F.dim()
        idx[axis] = slice(start, stop, 2)
        return F[tuple(idx)]

    return (0.5 * cut(0, -2) + cut(1, -1) + 0.5 * cut(2, None)) / 2.0


def restrict_corner(f: Blocks, periodic_x: bool = False) -> Blocks:
    """``solvers/energy_mg.py restrict_corner`` (both axes) on blocks: one
    halo round (the row above and the column left, zeros beyond the domain
    as the global zero pad), columns then rows; the coarse seam strips read
    the fine last row / column, so their owners compute them (one psum).
    ``periodic_x``: the ring's column left of column 0, the fine seam
    columns folded into column 0 (the R and C strips added on the first
    mesh column), and the coarse seam emitted as equal halves (its strips
    from the first mesh column)."""
    mesh = f.mesh
    (rows, left, _), (rows_r, _, _), (_, left_b, _) = mesh.halos(
        (f.I, 1, 0, 1, 0, None, None, periodic_x),
        (f.R, 1, 0, 0, 0, None, None, False),
        (f.B, 0, 0, 1, 0, None, None, periodic_x))
    F, FB = _cols(left, rows), _cols(left_b, f.B)
    if periodic_x:
        fold = _first(f, "x") & (_local_index(F.shape[-1], F.device, 1) == 1)
        F = torch.where(fold, F + rows_r, F)
        FB = torch.where(fold, FB + f.C, FB)
    g = _full_weight(F, -1)  # (by+1, bx/2)
    cI = _full_weight(g, -2)
    g_b = _full_weight(FB, -1)  # (1, bx/2): fine row ny
    zero_b = torch.zeros_like(g_b)
    cB = _full_weight(_rows(g[..., -1:, :], g_b, zero_b), -2)
    if periodic_x:
        cI = torch.where(_wall_col0(mesh, cI), 0.5 * cI, cI)
        cB = torch.where(_wall_col0(mesh, cB), 0.5 * cB, cB)
        return Blocks(mesh, "corner", cI, *_owned_strips(
            mesh, f, cI[..., :1], cB, cB[..., :1], first_col=True))
    zero_c = torch.zeros_like(rows_r)
    g_r = _full_weight(_cols(rows[..., -1:], rows_r, zero_c), -1)
    cR = _full_weight(g_r, -2)
    g_c = _full_weight(_cols(f.B[..., -1:], f.C, torch.zeros_like(f.C)), -1)
    cC = _full_weight(_rows(g_r[..., -1:, :], g_c, torch.zeros_like(g_c)),
                      -2)
    return Blocks(mesh, "corner", cI, *_owned_strips(mesh, f, cR, cB, cC))


def prolong_corner(c: Blocks) -> Blocks:
    """``solvers/energy_mg.py prolong_corner`` (both axes) on blocks: one
    halo round (the row below and the column right, the seam strips at the
    domain's last row and column), rows then columns; no reduction."""
    mesh = c.mesh
    last_x = _last(c, "x")
    (rows, _, right), (rows_r, _, _), (_, _, right_b) = mesh.halos(
        (c.I, 0, 1, 0, 1, None, c.B, False),
        (c.R, 0, 1, 0, 0, None, c.C, False),
        (c.B, 0, 0, 0, 1, None, None, False))

    def along_rows(E):
        return _interleave_rows(E[..., :-1, :],
                                0.5 * (E[..., :-1, :] + E[..., 1:, :]))

    def along_cols(e):
        return _interleave_cols(e[..., :-1], 0.5 * (e[..., :-1] + e[..., 1:]))

    E = _cols(rows, torch.where(last_x, rows_r, right))
    Eb = _cols(c.B, torch.where(last_x, c.C, right_b))
    return Blocks(mesh, "corner", along_cols(along_rows(E)),
                  along_rows(rows_r), along_cols(Eb), c.C)
