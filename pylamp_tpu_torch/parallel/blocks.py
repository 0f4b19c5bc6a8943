"""Sharded fields: a staggered-lattice field held as blocks on a mesh.

The port's counterpart of a ``jax.Array`` sharded by
``pylamp_tpu/parallel/mesh.py state_shardings``.  A lattice of
``(ny + ey, nx + ex)`` nodes (``EXTRA[loc]``: vx one extra column, vy one
extra row, the corner lattice both) is held in the split of
``parallel/halo_ops.py``:

    I  (ny, nx) interior        P("y", "x")   every shard its own block
    R  last column (ny, 1)      P("y", None)  every shard of a mesh row
    B  last row    (1, nx)      P(None, "x")  every shard of a mesh column
    C  corner      (1, 1)       P()           every shard

Each piece is shard-batched, as a shard body sees it: (*local_shape,
*block[, *trail]), (my, mx, ...) on the in-process mesh and (1, 1, ...)
on a rank of a distributed one.  A marker stream (ny, nx, K) is a
"center" field with one trailing dimension.

``Blocks`` is a tensor-like value (``__torch_function__``): elementwise
torch functions and arithmetic (the list ``_PIECEWISE``) apply piece by
piece (a replicated strip stays replicated, as every shard of its row
computes the same values), and the full reductions ``torch.sum`` /
``mean`` / ``max`` / ``min`` are mesh reductions that return a replicated
0-d tensor.  Every other torch function raises: one that reads across
nodes (slicing, reshapes, concatenation, dots, stencils) has a block form
of its own (``parallel/block_ops.py``, the halo operators, ``dots``).

Every reduction computes one partial per shard with ONE per-shard
function (``shard_partials``: the same call on the same shapes on either
transport), the strips from their owner shard only (the last mesh
column holds R, the last row B, the last shard C: each node counts once),
and sums the partials with the mesh's ``psum`` in the flat shard order;
a distributed rank's result is the in-process mesh's bit for bit.
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.parallel.mesh import P

EXTRA = {"center": (0, 0), "vx": (0, 1), "vy": (1, 0), "corner": (1, 1)}
PIECES = ("I", "R", "B", "C")
SPECS = {"I": P("y", "x"), "R": P("y", None), "B": P(None, "x"), "C": P()}

# the torch functions that act node by node: the only ones applied piece
# by piece (with the reductions below); any other raises
_PIECEWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "true_divide", "neg", "pow",
    "reciprocal", "square", "abs", "sign", "exp", "log", "sqrt", "rsqrt",
    "remainder",
    "clamp", "clip", "maximum", "minimum", "where", "eq", "ne", "gt", "ge",
    "lt", "le", "logical_and", "logical_or", "logical_not", "logical_xor",
    "isfinite", "isnan", "zeros_like", "ones_like", "full_like",
    "empty_like", "clone"))
_REDUCTIONS = {"sum": "sum", "mean": "mean", "max": "max", "min": "min",
               "amax": "max", "amin": "min", "any": "any", "all": "all"}


class Blocks:
    """A field on ``mesh`` at lattice ``loc`` ("center", "vx", "vy",
    "corner"): the pieces I, R, B, C (module docstring; None where the
    lattice has none)."""

    __slots__ = ("mesh", "loc", "I", "R", "B", "C")
    __hash__ = None

    def __init__(self, mesh, loc, I, R=None, B=None, C=None):
        ey, ex = EXTRA[loc]
        if (R is None) == bool(ex) or (B is None) == bool(ey) or \
                (C is None) == bool(ex and ey):
            raise ValueError(f"{loc} field: pieces I, R, B, C = "
                             f"{[p is not None for p in (I, R, B, C)]}")
        self.mesh, self.loc = mesh, loc
        self.I, self.R, self.B, self.C = I, R, B, C

    # -- layout ---------------------------------------------------------------

    @classmethod
    def split(cls, a, loc, mesh) -> "Blocks":
        """This process's shards of the global tensor ``a`` (no message;
        the pieces are views of ``a``)."""
        ey, ex = EXTRA[loc]
        ny, nx = a.shape[0] - ey, a.shape[1] - ex
        I = mesh.split(a[:ny, :nx], SPECS["I"])
        R = mesh.split(a[:ny, nx:], SPECS["R"]) if ex else None
        B = mesh.split(a[ny:, :nx], SPECS["B"]) if ey else None
        C = (mesh._full(a[ny:, nx:][None, None]) if ex and ey else None)
        return cls(mesh, loc, I, R, B, C)

    def gather(self, root=None, kind: str = "block"):
        """The global tensor (one collective under a distributed mesh);
        with ``root``, only on that rank (None elsewhere).  ``kind`` names
        the collective in ``dist.rounds``."""
        return gather_all([self], root, kind)[0]

    def pieces(self) -> dict:
        return {n: getattr(self, n) for n in PIECES
                if getattr(self, n) is not None}

    def map(self, fn, loc=None) -> "Blocks":
        """``fn`` on every piece."""
        return Blocks(self.mesh, loc or self.loc,
                      *(None if p is None else fn(p)
                        for p in (self.I, self.R, self.B, self.C)))

    def owned(self, li: int, lj: int, iy: int, ix: int) -> list:
        """The pieces shard (iy, ix) (local batch index (li, lj)) owns:
        its block, and the strips it is the owner of."""
        my, mx = self.mesh.my, self.mesh.mx
        out = [self.I[li, lj]]
        if self.R is not None and ix == mx - 1:
            out.append(self.R[li, lj])
        if self.B is not None and iy == my - 1:
            out.append(self.B[li, lj])
        if self.C is not None and iy == my - 1 and ix == mx - 1:
            out.append(self.C[li, lj])
        return out

    @property
    def dtype(self):
        return self.I.dtype

    @property
    def device(self):
        return self.I.device

    @property
    def is_cuda(self) -> bool:
        return self.I.is_cuda

    @property
    def shape(self) -> tuple:
        """The global shape."""
        ey, ex = EXTRA[self.loc]
        s = self.I.shape
        return (s[2] * self.mesh.my + ey, s[3] * self.mesh.mx + ex,
                *s[4:])

    def to(self, *args, **kwargs) -> "Blocks":
        return self.map(lambda p: p.to(*args, **kwargs))

    def numel_global(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    # -- tensor-like ------------------------------------------------------------

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        blocks = [a for a in (*args, *kwargs.values())
                  if isinstance(a, Blocks)]
        if name in _REDUCTIONS:
            if _is_full_reduction(args, kwargs):
                return _reduce(args[0], _REDUCTIONS[name])
            if not (len(args) > 1 and (isinstance(args[1], Blocks)
                                       or torch.is_tensor(args[1]))):
                _check_trailing(args, kwargs, name)  # else: elementwise
        elif name not in _PIECEWISE:
            raise TypeError(f"{name} is not a node-by-node function of a "
                            "sharded field: use its block form")
        first = blocks[0]
        for b in blocks[1:]:
            if b.loc != first.loc or b.mesh != first.mesh:
                raise TypeError(f"{name}: fields at {first.loc} and "
                                f"{b.loc} do not combine")
        for a in (*args, *kwargs.values()):
            if torch.is_tensor(a) and a.dim() > 0:
                raise TypeError(f"{name}: a sharded field combines with "
                                "0-d tensors only")

        def pick(a, n):
            if isinstance(a, Blocks):
                return getattr(a, n)
            if isinstance(a, (list, tuple)):
                return type(a)(pick(x, n) for x in a)
            return a

        out = {}
        for n in PIECES:
            if getattr(first, n) is None:
                continue
            r = func(*pick(args, n), **{k: pick(v, n)
                                        for k, v in kwargs.items()})
            if not torch.is_tensor(r):
                raise TypeError(f"{name} has no piecewise form")
            out[n] = r
        return Blocks(first.mesh, first.loc, *(out.get(n) for n in PIECES))

    # the full reductions as methods too: mesh reductions
    def all(self):
        return torch.all(self)

    def any(self):
        return torch.any(self)

    def sum(self):
        return torch.sum(self)

    def mean(self):
        return torch.mean(self)

    def max(self):
        return torch.max(self)

    def min(self):
        return torch.min(self)

    def __add__(self, o):
        return torch.add(self, o)

    def __radd__(self, o):
        return torch.add(o, self)

    def __sub__(self, o):
        return torch.sub(self, o)

    def __rsub__(self, o):
        return torch.sub(o, self)

    def __mul__(self, o):
        return torch.mul(self, o)

    def __rmul__(self, o):
        return torch.mul(o, self)

    def __truediv__(self, o):
        return torch.div(self, o)

    def __rtruediv__(self, o):
        return torch.div(o, self)

    def __pow__(self, o):
        return torch.pow(self, o)

    def __neg__(self):
        return torch.neg(self)

    def __abs__(self):
        return torch.abs(self)

    def __gt__(self, o):
        return torch.gt(self, o)

    def __ge__(self, o):
        return torch.ge(self, o)

    def __lt__(self, o):
        return torch.lt(self, o)

    def __le__(self, o):
        return torch.le(self, o)

    def __eq__(self, o):
        return torch.eq(self, o)

    def __ne__(self, o):
        return torch.ne(self, o)

    def __and__(self, o):
        return torch.logical_and(self, o)

    def __or__(self, o):
        return torch.logical_or(self, o)

    def __invert__(self):
        return torch.logical_not(self)


def _is_full_reduction(args, kwargs) -> bool:
    """A reduction over every element (no dim, a single tensor)."""
    return (len(args) == 1 and not kwargs and isinstance(args[0], Blocks))


def gather_all(fields, root=None, kind: str = "block") -> list:
    """The global tensors of several sharded fields in ONE collective
    (``mesh.gather_many``); with ``root`` only on that rank (Nones
    elsewhere)."""
    mesh = fields[0].mesh
    got = iter(mesh.gather_many(
        *((getattr(f, n), SPECS[n]) for f in fields for n in PIECES
          if getattr(f, n) is not None), root=root, kind=kind))
    out = []
    for f in fields:
        ey, ex = EXTRA[f.loc]
        a = next(got)
        R = next(got) if ex else None
        B = next(got) if ey else None
        C = next(got) if ex and ey else None
        if a is None:
            out.append(None)
            continue
        if ex:
            a = torch.cat([a, R], dim=1)
        if ey:
            a = torch.cat([a, torch.cat([B, C], dim=1) if ex else B], dim=0)
        out.append(a)
    return out


def _check_trailing(args, kwargs, name):
    """A reduction along dims: piecewise only over a field's trailing
    dimensions (a marker stream's K)."""
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    dims = dim if isinstance(dim, (tuple, list)) else (dim,)
    field = args[0]
    trail = field.I.dim() - 4 if isinstance(field, Blocks) else 0
    if not all(isinstance(d, int) and -trail <= d < 0 for d in dims):
        raise TypeError(f"{name} over dim {dim} reads across the blocks of "
                        "a sharded field")


def shard_partials(mesh, fn, *fields):
    """``fn(*owned)`` once per local shard, ``owned`` each field's owned
    pieces there (``Blocks.owned``), stacked (*local_shape, *result): the
    one per-shard function every reduction runs."""
    parts = [fn(*(f.owned(li, lj, iy, ix) for f in fields))
             for li, lj, iy, ix in mesh.local_shards()]
    out = torch.stack(parts)
    return out.reshape(*mesh.local_shape, *out.shape[1:])


def _fold(vals, op):
    """The per-shard values of one reduction, folded in piece order."""
    step = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
    total = vals[0]
    for v in vals[1:]:
        total = step(total, v)
    return total


def _reduce(field: Blocks, op: str):
    mesh = field.mesh
    if op in ("any", "all"):  # a mesh maximum of per-shard flags
        flags = field if op == "any" else torch.logical_not(field)
        parts = shard_partials(mesh, lambda own: _fold(
            [torch.any(p).to(torch.uint8) for p in own], "max"), flags)
        hit = mesh.total(parts, "max") > 0
        return hit if op == "any" else torch.logical_not(hit)
    piece_op = {"sum": torch.sum, "mean": torch.sum, "max": torch.amax,
                "min": torch.amin}[op]
    fold = "sum" if op == "mean" else op
    parts = shard_partials(mesh, lambda own: _fold(
        [piece_op(p) for p in own], fold), field)
    total = mesh.total(parts, fold)
    if op == "mean":
        total = total / field.numel_global()
    return total


def dots(pairs) -> torch.Tensor:
    """(n,) tensor of the dot products of the n (a, b) pairs, each a
    sharded field or a tuple of them: one per-shard partial vector, one
    psum."""
    pairs = [(a if isinstance(a, tuple) else (a,),
              b if isinstance(b, tuple) else (b,)) for a, b in pairs]
    mesh = pairs[0][0][0].mesh
    flat = [f for a, b in pairs for f in (*a, *b)]

    def per_shard(*owned):
        it = iter(owned)
        vals = []
        for a, b in pairs:
            fa = [next(it) for _ in a]
            fb = [next(it) for _ in b]
            acc = None
            for pa, pb in zip(fa, fb):
                for x, y in zip(pa, pb):
                    d = torch.vdot(x.reshape(-1), y.reshape(-1))
                    acc = d if acc is None else acc + d
            vals.append(acc)
        return torch.stack(vals)

    return mesh.total(shard_partials(mesh, per_shard, *flat), "sum")


def zeros(mesh, loc: str, like, trail=()) -> Blocks:
    """A zero field at ``loc`` with the blocks of the mesh level whose
    block shape ``like`` (a Blocks of the same level) has."""
    by, bx = like.I.shape[2], like.I.shape[3]
    ey, ex = EXTRA[loc]
    lead = tuple(mesh.local_shape)
    kw = dict(dtype=like.dtype, device=like.device)

    def z(r, c):
        return torch.zeros((*lead, r, c, *trail), **kw)

    return Blocks(mesh, loc, z(by, bx), z(by, 1) if ex else None,
                  z(1, bx) if ey else None, z(1, 1) if ex and ey else None)
