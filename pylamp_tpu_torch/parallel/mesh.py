"""Device mesh: 2-D domain decomposition, with two transports.

Port of ``pylamp_tpu/parallel/mesh.py`` (``make_mesh``, ``state_shardings``,
``shard_state``) and of the ``shard_map`` engine its explicit-halo modules
run under.  A mesh of ``my x mx`` shards has axes ("y", "x").  A shard
body sees its shards as two leading batch dimensions: a global
(ny, nx[, K]) tensor split ``P("y", "x")`` becomes a (*local_shape, by,
bx[, K]) view.

The state comes in two layouts.  GLOBAL: every caller holds whole
tensors and only the shard bodies see blocks (``shard_map``: split, the
body, gather); the in-process mesh runs every configuration this way.
SHARDED (``shard_state``, the counterpart of the reference's
``shard_state``): every field is a ``parallel/blocks.py Blocks``, each
shard holding its block and the seam strips of its mesh row / column,
the markers a (by, bx, K) block, scalars replicated; the bodies run on
the blocks as they are (``local_map``), reductions are per-shard partials
summed over the mesh, and nothing is gathered inside a step but the MG
levels the solver replicates.  Both transports take the sharded layout;
a distributed mesh takes nothing else.

Two transports share one interface:

- ``Mesh`` (this module): every shard in ONE process on ONE device, the
  port's counterpart of the reference's virtual-device mesh (its tests and
  dryrun run on 8 virtual CPU devices).  ``local_shape`` is (my, mx): a
  body sees every shard at once, and each per-shard kernel launches once
  over all of them.
- ``parallel/dist.py DistMesh``: one rank of a ``my x mx``
  torch.distributed world, one shard per rank.  ``local_shape`` is (1, 1);
  the exchanges are point-to-point messages, ``psum`` / ``pmax`` small
  collectives (see there).

``my`` / ``mx`` / ``shape`` / ``size`` are the GLOBAL mesh (block sizes are
``grid.ny // mesh.my``); ``local_shape`` / ``n_local`` are the shards this
process computes (the batch dimensions of a body, the leading dimension of
the per-shard kernels' flat layout), ``local_shards`` their indices.

Specs (``P`` below) follow ``jax.sharding.PartitionSpec`` over the leading
dimensions of a tensor: ``P("y", "x")`` splits both, ``P("y", None)``
splits rows and REPLICATES along x (every shard of a mesh row holds the
same strip), ``P(None, "x")`` the transpose, ``P(None, None)`` / ``P()``
replicate.  Out-specs reassemble: a replicated axis takes shard 0 of it,
as ``shard_map`` assumes the replicas agree.

The exchange primitives carry the reference's ``lax.ppermute`` semantics
along one mesh axis: ``from_prev`` / ``from_next`` deliver the (i-1) /
(i+1) neighbour's payload, edge shards receive zeros, and ``ring=True``
wraps.  ``exchange`` runs several of them as one round (one message per
neighbour under a distributed transport), and ``halos`` a body's 2-D
halos in one such round (the corners from the diagonal neighbours).
``psum`` sums over one or both axes and hands every shard the sum,
``pmax`` the maximum; ``axis_index`` returns broadcastable index tensors,
so a ``jnp.where(iy == 0, ...)`` of the reference becomes a broadcast
mask.
"""
from __future__ import annotations

import dataclasses
import math

import torch

AXES = ("y", "x")
PREV, NEXT = "prev", "next"  # exchange sides: from_prev, from_next


def P(*axes):
    """A partition spec: one mesh axis name (or None) per leading dim."""
    return tuple(axes)


def _factor2(n: int):
    """Near-square factorization n = a*b with a >= b."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``my x mx`` shards in one process; axes ("y", "x")."""

    my: int
    mx: int

    # one process of a torch.distributed world (parallel/dist.py)
    distributed = False

    @property
    def shape(self):
        """The global mesh: {"y": my, "x": mx}."""
        return {"y": self.my, "x": self.mx}

    @property
    def size(self) -> int:
        """Shards of the global mesh, my * mx."""
        return self.my * self.mx

    @property
    def local_shape(self) -> tuple[int, int]:
        """The (y, x) batch dimensions a shard body sees: the shards this
        process computes.  In-process every shard, (my, mx); one rank of a
        distributed mesh, (1, 1)."""
        return (self.my, self.mx)

    @property
    def n_local(self) -> int:
        """The shards this process computes: the leading dimension of the
        per-shard kernels' flat (S, ...) layout."""
        ly, lx = self.local_shape
        return ly * lx

    @property
    def lead(self) -> bool:
        """Whether this process writes the run's files (rank 0 of a
        distributed mesh; always in-process)."""
        return True

    def barrier(self):
        """Wait for every process of the mesh (none in-process)."""

    def local_shards(self):
        """(li, lj, iy, ix) of every shard this process computes: its
        index in the local batch dimensions and on the mesh, in the flat
        (row-major) shard order."""
        return [(iy, ix, iy, ix) for iy in range(self.my)
                for ix in range(self.mx)]

    def _dim(self, axis: str) -> int:
        return AXES.index(axis)

    def _full(self, x):
        return x.expand(*self.local_shape, *x.shape[2:])

    # -- split / reassemble ------------------------------------------------

    def split(self, a, spec):
        """Global tensor -> shard-batched (my, mx, *block) view (a scalar
        or a P() argument passes through as is)."""
        if not torch.is_tensor(a) or len(spec) == 0 or a.dim() == 0:
            return a
        spec = tuple(spec) + (None,) * (2 - len(spec))
        sy, sx = spec[0], spec[1]
        if sy not in (None, "y") or sx not in (None, "x"):
            raise ValueError(f"unsupported partition spec {spec}")
        d0, d1, rest = a.shape[0], a.shape[1], a.shape[2:]
        a0 = self.my if sy == "y" else 1
        a1 = self.mx if sx == "x" else 1
        if d0 % a0 or d1 % a1:
            raise ValueError(f"shape {tuple(a.shape)} does not split over "
                             f"the {self.my}x{self.mx} mesh by {spec}")
        v = a.reshape(a0, d0 // a0, a1, d1 // a1, *rest)
        v = v.permute(0, 2, 1, 3, *range(4, v.dim()))
        return self._full(v)

    def gather(self, b, spec):
        """Shard-batched (my, mx, *block) tensor -> global tensor by
        ``spec`` (P() takes shard (0, 0)); None stays None."""
        if b is None:
            return None
        b = self._full(b)
        if len(spec) == 0:
            return b[0, 0]
        spec = tuple(spec) + (None,) * (2 - len(spec))
        if spec[0] != "y":
            b = b[:1]
        if spec[1] != "x":
            b = b[:, :1]
        a0, a1, b0, b1 = b.shape[:4]
        v = b.permute(0, 2, 1, 3, *range(4, b.dim()))
        return v.reshape(a0 * b0, a1 * b1, *b.shape[4:])

    def gather_many(self, *pairs, root=None, kind: str = "block"):
        """``gather`` of several (block tensor, spec) pairs: one collective
        under a distributed transport, which hands the global tensors to
        rank ``root`` only where one is named (None elsewhere) and counts
        the collective under ``kind``."""
        return [self.gather(b, s) for b, s in pairs]

    def local_map(self, body):
        """``body`` on arguments that are already split (shard-batched
        blocks, or scalars): no split, no gather; its outputs stay
        blocks."""
        def run(*blocks):
            return body(*(self._full(b) if torch.is_tensor(b) and b.dim() >= 2
                          else b for b in blocks))
        return run

    def shard_map(self, body, in_specs, out_specs):
        """``body`` over global arguments: split each argument by its
        in-spec, ``local_map`` the body, reassemble each output by its
        out-spec."""
        def run(*args):
            outs = self.local_map(body)(
                *(self.split(a, s) for a, s in zip(args, in_specs)))
            if isinstance(out_specs, tuple) and out_specs and \
                    isinstance(out_specs[0], tuple):
                return tuple(self.gather_many(*zip(outs, out_specs)))
            return self.gather(outs, out_specs)
        return run

    # -- primitives inside a shard body -------------------------------------

    def axis_index(self, axis: str, nd: int = 2, device=None):
        """This shard's index along ``axis`` as an int64 tensor that
        broadcasts against (my, mx, *block) with ``nd`` block dims."""
        n = self.shape[axis]
        shape = [1, 1] + [1] * nd
        shape[self._dim(axis)] = n
        return torch.arange(n, device=device).view(shape)

    def from_prev(self, x, axis: str, ring: bool = False):
        """The (i-1) neighbour's payload along ``axis`` (zeros at i = 0, or
        the last shard's with ``ring``)."""
        x = self._full(x)
        d = self._dim(axis)
        if ring:
            return torch.roll(x, 1, dims=d)
        return torch.cat([torch.zeros_like(x.narrow(d, 0, 1)),
                          x.narrow(d, 0, x.shape[d] - 1)], dim=d)

    def from_next(self, x, axis: str, ring: bool = False):
        """The (i+1) neighbour's payload along ``axis``."""
        x = self._full(x)
        d = self._dim(axis)
        if ring:
            return torch.roll(x, -1, dims=d)
        return torch.cat([x.narrow(d, 1, x.shape[d] - 1),
                          torch.zeros_like(x.narrow(d, 0, 1))], dim=d)

    def _shift(self, x, axis, side, ring: bool = False):
        """One request of ``exchange``: ``from_prev`` / ``from_next`` along
        one axis, or along both (``axis`` ("y", "x"), ``side`` (y side, x
        side), the diagonal neighbour's payload; ``ring`` wraps x only)."""
        if isinstance(axis, tuple):
            return self._shift(self._shift(x, "x", side[1], ring), "y",
                               side[0])
        return (self.from_prev if side == PREV else self.from_next)(
            x, axis, ring)

    def exchange(self, *requests):
        """Several exchanges as one round: each request is ``(x, axis,
        side)`` or ``(x, axis, side, ring)`` with ``side`` PREV
        (``from_prev``) or NEXT (``from_next``), or a diagonal one (see
        ``_shift``); returns the received payloads in request order.  No
        request may depend on another's result.  In-process the round is
        the exchanges in turn."""
        return [self._shift(x, axis, side, *ring)
                for x, axis, side, *ring in requests]

    def halos(self, *fields):
        """The 2-D halos of several blocks in ONE exchange round.

        Each field is ``(a, up, down, left, right, top, bottom, ring)``: a
        (*lead, n, m) block, the halo depths on each side (0: none), the
        (*lead, up, m) / (*lead, down, m) rows the shard puts above / below
        ``a`` at the domain's top / bottom wall (None: zeros) and whether
        the x halos wrap.  Returns per field ``(rows, left, right)``:
        ``rows`` = ``a`` between the y-neighbours' ``up`` / ``down`` rows
        (``top`` / ``bottom`` at the walls), ``left`` / ``right`` the
        (*lead, up+n+down, left / right) edge columns of the x-neighbours'
        ``rows`` (zeros beyond the domain without ``ring``): what a round
        of row halos and a second round of column halos of the
        row-extended blocks deliver.  The corners come from the diagonal
        neighbours; the x-neighbours send their columns with their own
        wall rows, taken where the mesh row is at a wall (the same for
        every shard of a mesh row)."""
        reqs, plans = [], []
        for a, up, down, left, right, top, bottom, ring in fields:
            a = self._full(a)
            nd = a.dim() - 2
            first_y = self.axis_index("y", nd, a.device) == 0
            last_y = self.axis_index("y", nd, a.device) == self.my - 1
            walls = (top if up else None, bottom if down else None)

            def wall(w, d, a=a):
                shape = (*a.shape[:-2], d, a.shape[-1])
                return (a.new_zeros(shape) if w is None
                        else self._full(w).expand(shape))

            # the block between its own wall rows: its x-neighbours' source
            # of the column halos' wall part
            own = torch.cat([wall(walls[0], up), a, wall(walls[1], down)],
                            dim=-2)
            lasts = a[..., -up:, :] if up else None
            firsts = a[..., :down, :] if down else None
            want = []
            if up:
                want.append((lasts, "y", PREV))
            if down:
                want.append((firsts, "y", NEXT))
            for d, side, cut in ((left, PREV, lambda t: t[..., -left:]),
                                 (right, NEXT, lambda t: t[..., :right])):
                if not d:
                    continue
                want.append((cut(own), "x", side, ring))
                if up:
                    want.append((cut(lasts), ("y", "x"), (PREV, side),
                                 ring))
                if down:
                    want.append((cut(firsts), ("y", "x"), (NEXT, side),
                                 ring))
            reqs += want
            plans.append((a, up, down, left, right, walls, first_y, last_y))
        got = iter(self.exchange(*reqs))
        out = []
        for a, up, down, left, right, walls, first_y, last_y in plans:
            parts = [a]
            if up:
                t = next(got)
                parts.insert(0, t if walls[0] is None else
                             torch.where(first_y, walls[0], t))
            if down:
                b = next(got)
                parts.append(b if walls[1] is None else
                             torch.where(last_y, walls[1], b))
            sides = []
            for d in (left, right):
                if not d:
                    sides.append(None)
                    continue
                col = next(got)
                n = col.shape[-2] - up - down
                pieces = [col.narrow(-2, up, n)]
                if up:
                    pieces.insert(0, torch.where(
                        first_y, col.narrow(-2, 0, up), next(got)))
                if down:
                    pieces.append(torch.where(
                        last_y, col.narrow(-2, up + n, down), next(got)))
                sides.append(torch.cat(pieces, dim=-2))
            out.append((torch.cat(parts, dim=-2), *sides))
        return out

    def psum(self, x, axes):
        """Sum over the mesh ``axes`` ("y", "x" or both), replicated back
        to every shard.  The shards add in a fixed order, one after the
        other in the flat (row-major) shard order, whatever the tensor's
        memory layout: the distributed mesh runs this on its gathered
        stacks and gets the same bits."""
        x = self._full(x)
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = sorted(self._dim(a) for a in axes)
        keep = [d for d in (0, 1) if d not in dims]
        terms = x.permute(*dims, *keep, *range(2, x.dim()))
        terms = terms.reshape(-1, *terms.shape[len(dims):])
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        total = total.unsqueeze(dims[0])
        if len(dims) == 2:
            total = total.unsqueeze(1)
        return self._full(total)

    def psum_many(self, *pairs):
        """``psum`` of several (tensor, axes) pairs: one collective under a
        distributed transport."""
        return [self.psum(x, axes) for x, axes in pairs]

    def pmax(self, x, axes):
        """The maximum over the mesh ``axes``, replicated back to every
        shard (exact in any order)."""
        x = self._full(x)
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = tuple(self._dim(a) for a in axes)
        return self._full(torch.amax(x, dim=dims, keepdim=True))

    def total(self, partials, op: str = "sum"):
        """The mesh-wide "sum", "max" or "min" of per-shard ``partials``
        (*local_shape, ...): one small collective under a distributed
        transport; the sum runs in ``psum``'s flat shard order."""
        both = ("y", "x")
        if op == "sum":
            return self.psum(partials, both)[0, 0]
        if op == "max":
            return self.pmax(partials, both)[0, 0]
        if op == "min":
            return -self.pmax(-partials, both)[0, 0]
        raise ValueError(f"unknown mesh reduction {op!r}")

    def ext1(self, block, nd: int = 2, ring_x: bool = False):
        """``block`` (rows and cols at dims -nd and -nd+1) with one ring of
        neighbour data around it, zeros beyond the domain (``ring_x``: the
        x halos wrap, periodic side walls): rows first, then columns of the
        row-extended block, so the diagonal corners ride along."""
        return self.ext1_many([block], nd, ring_x)[0]

    def ext1_many(self, blocks, nd: int = 2, ring_x: bool = False):
        """``ext1`` of several blocks in one exchange round (``halos``)."""
        lead = tuple(range(2, nd))  # trailing dims, moved before the rows
        tail = tuple(range(-nd + 2, 0))
        got = self.halos(*((self._full(b).movedim(tail, lead), 1, 1, 1, 1,
                            None, None, ring_x) for b in blocks))
        return [torch.cat([left, rows, right], dim=-1).movedim(lead, tail)
                for rows, left, right in got]

    def flat(self, x):
        """(*local_shape, *block) -> contiguous (n_local, *block), the
        layout the per-shard kernels take."""
        x = self._full(x)
        return x.reshape(self.n_local, *x.shape[2:]).contiguous()

    def unflat(self, x):
        return x.reshape(*self.local_shape, *x.shape[1:])

    def bases(self, by: int, bx: int, device=None):
        """(n_local, 2) int32 tensor of every local shard's first own cell
        (row_base, col_base), the per-shard kernels' offsets."""
        iy = torch.arange(self.my, device=device).repeat_interleave(self.mx)
        ix = torch.arange(self.mx, device=device).repeat(self.my)
        return torch.stack([iy * by, ix * bx], dim=1).to(torch.int32)

    def wall_flags(self, device=None):
        """(n_local, 4) f32 tensor of (top, bottom, left, right) physical
        wall flags per local shard, the fused per-shard smoother's runtime
        flags."""
        iy = torch.arange(self.my, device=device).repeat_interleave(self.mx)
        ix = torch.arange(self.mx, device=device).repeat(self.my)
        return torch.stack([iy == 0, iy == self.my - 1, ix == 0,
                            ix == self.mx - 1], dim=1).to(torch.float32)


def make_mesh(n_devices: int = 8) -> Mesh:
    """2-D ("y", "x") mesh of ``n_devices`` shards: (my, mx) =
    ``_factor2(n)``, so make_mesh(8) is the reference's 4x2 mesh."""
    my, mx = _factor2(n_devices)
    return Mesh(my, mx)


def parse_mesh(spec: str) -> Mesh:
    """The CLI's ``--mesh``: "YxX", e.g. "4x2"."""
    try:
        my, mx = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected YxX, e.g. 4x2") from None
    return Mesh(my, mx)


# -- the sharded state ---------------------------------------------------------

# the lattice of each ModelState field
STATE_LOCS = {"vx": "vx", "vy": "vy", "p": "center", "T": "corner",
              "eta_s": "corner", "eta_n": "center"}


def state_specs(state, mesh: Mesh) -> dict:
    """The sharded layout of ``state`` by checkpoint name
    (``bridge.state_leaves``): a lattice field's pieces and their specs
    (``parallel/blocks.py``), the markers' ``P("y", "x", None)``, and
    ``P()`` for the replicated scalars and ``mg_lam``.  The port's
    counterpart of the reference's ``state_shardings``."""
    from pylamp_tpu_torch.bridge import state_leaves
    from pylamp_tpu_torch.parallel.blocks import EXTRA, SPECS

    out = {}
    for key in state_leaves(state):
        name = key[len("state."):]
        if name.startswith("markers."):
            out[key] = P("y", "x", None)
        elif name in STATE_LOCS:
            ey, ex = EXTRA[STATE_LOCS[name]]
            out[key] = {n: SPECS[n] for n, keep in (
                ("I", True), ("R", ex), ("B", ey), ("C", ex and ey)) if keep}
        else:
            out[key] = P()
    return out


def shard_state(state, mesh: Mesh, device=None):
    """``state`` (global tensors, on the host or any device) in the
    sharded layout: each field this process's blocks and strips as fresh
    tensors on ``device`` (default the state's), so that the global
    tensors can go; no message."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    device = torch.device(device) if device is not None else state.vx.device

    def own(p):
        return p.to(device).clone(memory_format=torch.contiguous_format)

    def field(a, loc):
        return Blocks.split(a, loc, mesh).map(own)

    m = state.markers
    markers = m.replace(**{f: field(getattr(m, f), "center") for f in (
        "x", "y", "mat", "T", "valid")})
    return state.replace(
        markers=markers,
        **{f: field(getattr(state, f), loc) for f, loc in STATE_LOCS.items()},
        **{f: None if getattr(state, f) is None else own(getattr(state, f))
           for f in ("time", "step", "dt", "mg_lam")})


def unshard_state(state, mesh: Mesh, root=None):
    """The global state of a sharded ``state`` (one collective under a
    distributed mesh; with ``root`` only that rank gets it, the others
    None).  For files and checks, never inside a step."""
    from pylamp_tpu_torch.parallel.blocks import gather_all

    m = state.markers
    names = ("x", "y", "mat", "T", "valid")
    got = gather_all([getattr(m, f) for f in names]
                     + [getattr(state, f) for f in STATE_LOCS], root)
    if got[0] is None:
        return None
    return state.replace(markers=m.replace(**dict(zip(names, got))),
                         **dict(zip(STATE_LOCS, got[len(names):])))


def is_sharded(state) -> bool:
    """Whether ``state`` is in the sharded layout."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    return isinstance(state.vx, Blocks)
