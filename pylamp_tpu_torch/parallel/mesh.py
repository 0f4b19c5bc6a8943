"""In-process device mesh: 2-D domain decomposition with every shard on one
card.

Port of ``pylamp_tpu/parallel/mesh.py`` (``make_mesh``) and of the
``shard_map`` engine its explicit-halo modules run under.  A mesh of
``my x mx`` shards with axes ("y", "x") keeps all shards in ONE process on
ONE device as two leading batch dimensions: a global (ny, nx[, K]) tensor
split ``P("y", "x")`` becomes a (my, mx, by, bx[, K]) view, and a shard
body sees every shard at once.  This is the port's counterpart of the
reference's virtual-device mesh (its tests and dryrun run on 8 virtual CPU
devices); each per-shard kernel launches once over all shards.

Specs (``P`` below) follow ``jax.sharding.PartitionSpec`` over the leading
dimensions of a tensor: ``P("y", "x")`` splits both, ``P("y", None)``
splits rows and REPLICATES along x (every shard of a mesh row holds the
same strip), ``P(None, "x")`` the transpose, ``P(None, None)`` / ``P()``
replicate.  Out-specs reassemble: a replicated axis takes shard 0 of it,
as ``shard_map`` assumes the replicas agree.

The exchange primitives carry the reference's ``lax.ppermute`` semantics
along one mesh axis: ``from_prev`` / ``from_next`` deliver the (i-1) /
(i+1) neighbour's payload, edge shards receive zeros, and ``ring=True``
wraps.  ``psum`` sums over one or both axes and hands every shard the sum;
``axis_index`` returns broadcastable index tensors, so a
``jnp.where(iy == 0, ...)`` of the reference becomes a broadcast mask.

``state_shardings`` / ``shard_state`` have no counterpart: in-process the
state stays global, and only the shard bodies see blocks.  A transport
across several GPUs (torch.distributed / NCCL) would replace the split,
the exchange primitives and the reassembly here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

AXES = ("y", "x")


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

    @property
    def shape(self):
        return {"y": self.my, "x": self.mx}

    @property
    def size(self) -> int:
        return self.my * self.mx

    def _dim(self, axis: str) -> int:
        return AXES.index(axis)

    def _full(self, x):
        return x.expand(self.my, self.mx, *x.shape[2:])

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

    def shard_map(self, body, in_specs, out_specs):
        """``body`` over shard-batched arguments: split each argument by
        its in-spec, call the body once with every shard, reassemble each
        output by its out-spec."""
        def run(*args):
            outs = body(*(self.split(a, s) for a, s in zip(args, in_specs)))
            if isinstance(out_specs, tuple) and out_specs and \
                    isinstance(out_specs[0], tuple):
                return tuple(self.gather(o, s)
                             for o, s in zip(outs, out_specs))
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

    def psum(self, x, axes):
        """Sum over the mesh ``axes`` ("y", "x" or both), replicated back
        to every shard."""
        x = self._full(x)
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [self._dim(a) for a in axes]
        return self._full(x.sum(dim=dims, keepdim=True))

    def ext1(self, block, nd: int = 2, ring_x: bool = False):
        """``block`` (rows and cols at dims -nd and -nd+1) with one ring of
        neighbour data around it, zeros beyond the domain (``ring_x``: the
        x halos wrap, periodic side walls): rows first, then columns of the
        row-extended block, so the diagonal corners ride along."""
        r, c = -nd, -nd + 1
        t = self.from_prev(block.narrow(r, block.shape[r] - 1, 1), "y")
        b = self.from_next(block.narrow(r, 0, 1), "y")
        rows = torch.cat([t, self._full(block), b], dim=r)
        left = self.from_prev(rows.narrow(c, rows.shape[c] - 1, 1), "x",
                              ring=ring_x)
        right = self.from_next(rows.narrow(c, 0, 1), "x", ring=ring_x)
        return torch.cat([left, rows, right], dim=c)

    def flat(self, x):
        """(my, mx, *block) -> contiguous (my * mx, *block), the layout the
        per-shard kernels take."""
        x = self._full(x)
        return x.reshape(self.size, *x.shape[2:]).contiguous()

    def unflat(self, x):
        return x.reshape(self.my, self.mx, *x.shape[1:])

    def bases(self, by: int, bx: int, device=None):
        """(my * mx, 2) int32 tensor of every shard's first own cell
        (row_base, col_base), the per-shard kernels' offsets."""
        iy = torch.arange(self.my, device=device).repeat_interleave(self.mx)
        ix = torch.arange(self.mx, device=device).repeat(self.my)
        return torch.stack([iy * by, ix * bx], dim=1).to(torch.int32)

    def wall_flags(self, device=None):
        """(my * mx, 4) f32 tensor of (top, bottom, left, right) physical
        wall flags per shard, the fused per-shard smoother's runtime
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
