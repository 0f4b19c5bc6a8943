"""Distributed mesh: one shard per rank of a torch.distributed world.

The port's counterpart of the reference's mesh over real devices
(``pylamp_tpu/cli.py`` ``--mesh YxX`` builds a ``jax.sharding.Mesh``, the
step runs its ``shard_map`` bodies there with ``lax.ppermute`` halo
exchanges and ``lax.psum`` seams).  Rank ``r`` of a ``my x mx`` world owns
shard (r // mx, r % mx), the in-process mesh's flat order:

- every rank holds the global state, as every caller of the in-process
  mesh does, and repeats the work outside the shard bodies (Krylov
  vectors, MG transfers, replicated coarse levels), as GSPMD does for the
  reference; only the bodies are divided, so kernels 8-12 launch once per
  rank over its own block;
- ``split`` cuts this rank's block from a global tensor (no message);
- ``exchange`` / ``from_prev`` / ``from_next`` are point-to-point messages
  (``dist.batch_isend_irecv``, one message per neighbour a round, the
  diagonal neighbours' too), the counterpart of ``lax.ppermute``;
- ``psum`` and ``gather`` all-gather every rank's block (one
  ``all_to_all_single``) into the (my, mx, ...) stack and run the
  in-process mesh's own reduction or reassembly on it, so sums run in the
  in-process order on every backend and world size (an ``all_reduce``
  would not): a rank's state equals the in-process mesh's bit for bit.

Backends: NCCL for CUDA tensors, one card per rank (two NCCL ranks on one
device raise); gloo for the CPU, or for CUDA tensors when the caller asks
for it (ranks sharing one card): gloo moves host memory, so each message
is staged through the host in ``_through_host`` and nowhere else.

``launch`` spawns a world in this process (the tests, ``chip_smoke.py``,
``dryrun --ranks``); ``init_from_env`` joins the world ``torchrun`` starts
(``python -m pylamp_tpu_torch run ... --mesh YxX``).
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import hashlib
import math
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from pylamp_tpu_torch.parallel.mesh import NEXT, PREV, Mesh

DEFAULT_TIMEOUT_S = 600.0


# -- the transport ----------------------------------------------------------


def _through_host(comm, sends, recvs):
    """``comm(sends, recvs)`` on host copies of CUDA payloads, the received
    ones copied back to their device: gloo moves host memory only.  The
    gloo transport's one staging point.  The host buffers are pinned, so
    that the copies are asynchronous on the stream (the caching host
    allocator reuses a buffer only once its copy is done); pageable
    buffers made the step slower on the H100 (PERF.md)."""
    if not any(t.is_cuda for t in (*sends, *recvs)):
        return comm(sends, recvs)
    host_sends = [torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                  for s in sends]
    for h, s in zip(host_sends, sends):
        h.copy_(s, non_blocking=True)
    host_recvs = [torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                  for r in recvs]
    torch.cuda.current_stream((*sends, *recvs)[0].device).synchronize()
    comm(host_sends, host_recvs)
    for r, h in zip(recvs, host_recvs):
        r.copy_(h, non_blocking=True)


def _nbytes(shape, dtype) -> int:
    """A payload's bytes in a ``_pack`` buffer: padded to 8, so that every
    payload starts aligned for its dtype."""
    return -(-math.prod(shape) * dtype.itemsize // 8) * 8


def _pack(tensors, device):
    """One flat byte buffer of several tensors (any dtypes and strides)."""
    buf = torch.empty(sum(_nbytes(t.shape, t.dtype) for t in tensors),
                      dtype=torch.uint8, device=device)
    for t, view in zip(tensors, _unpack(buf, [(t.shape, t.dtype)
                                              for t in tensors])):
        view.copy_(t)
    return buf


def _unpack(buf, likes):
    """Tensors shaped and typed as ``likes`` from a ``_pack`` buffer."""
    out, off = [], 0
    for shape, dtype in likes:
        n = math.prod(shape) * dtype.itemsize
        out.append(buf[off:off + n].view(dtype).reshape(shape))
        off += _nbytes(shape, dtype)
    return out


# this process's message rounds since they were last set to 0: an exchange
# round of point-to-point messages, an all-gather
rounds = {"p2p": 0, "all_gather": 0}


@dataclasses.dataclass(frozen=True)
class _Transport:
    """The running process group's messages (its rank, size and backend
    read once): the same two calls on every backend, ``batch_isend_irecv``
    for a round and ``all_to_all_single`` for an all-gather; gloo stages
    CUDA payloads through the host."""

    rank: int
    world: int
    gloo: bool

    @classmethod
    def current(cls) -> "_Transport":
        return cls(dist.get_rank(), dist.get_world_size(),
                   dist.get_backend() == "gloo")

    def _run(self, comm, sends, recvs):
        if self.gloo:
            _through_host(comm, sends, recvs)
        else:
            comm(sends, recvs)

    def p2p(self, sends: dict, recvs: dict):
        """One round of point-to-point messages, posted as one batch:
        ``sends`` {peer: buffer}, ``recvs`` {peer: buffer to fill}."""
        rounds["p2p"] += 1

        def comm(s_bufs, r_bufs):
            ops = [dist.P2POp(dist.isend, b, p) for p, b in zip(sends, s_bufs)]
            ops += [dist.P2POp(dist.irecv, b, p)
                    for p, b in zip(recvs, r_bufs)]
            for work in dist.batch_isend_irecv(ops) if ops else []:
                work.wait()

        self._run(comm, list(sends.values()), list(recvs.values()))

    def all_gather(self, buf):
        """(world, n) stack of every rank's 1-D ``buf``, in rank order.  An
        all-to-all of ``world`` copies of ``buf``: every block reaches
        every rank in one step, where gloo's all_gather passes the blocks
        round a ring in world - 1 steps, each a wait on the slowest rank;
        a one-rank NCCL group still runs an NCCL collective (PERF.md)."""
        rounds["all_gather"] += 1
        out = torch.empty((self.world, buf.numel()), dtype=buf.dtype,
                          device=buf.device)
        self._run(lambda s, r: dist.all_to_all_single(
            r[0], s[0].repeat(self.world)), [buf], [out])
        return out


@dataclasses.dataclass(frozen=True)
class DistMesh(Mesh):
    """Rank ``rank`` of a ``my x mx`` world: one shard, (my, mx) the
    global mesh, (1, 1) the local batch dimensions."""

    rank: int

    @classmethod
    def from_group(cls, my: int, mx: int) -> "DistMesh":
        """This process's rank of the running world, which must hold
        exactly ``my * mx`` ranks."""
        world = dist.get_world_size()
        if world != my * mx:
            raise ValueError(f"--mesh {my}x{mx}: needs {my * mx} devices, "
                             f"have {world}")
        return cls(my, mx, dist.get_rank())

    @functools.cached_property
    def coords(self) -> tuple[int, int]:
        """This rank's (iy, ix) on the mesh."""
        return divmod(self.rank, self.mx)

    @functools.cached_property
    def _transport(self) -> _Transport:
        return _Transport.current()

    @property
    def local_shape(self) -> tuple[int, int]:
        return (1, 1)

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def barrier(self):
        dist.barrier()

    @property
    def _inproc(self) -> Mesh:
        """The in-process mesh of the same shape: its reductions and
        reassembly run on the all-gathered stacks."""
        return Mesh(self.my, self.mx)

    # -- split / reassemble ------------------------------------------------

    def split(self, a, spec):
        """This rank's (1, 1, *block) view of a global tensor (no
        message)."""
        if not torch.is_tensor(a) or len(spec) == 0 or a.dim() == 0:
            return a
        spec = tuple(spec) + (None,) * (2 - len(spec))
        sy, sx = spec[0], spec[1]
        if sy not in (None, "y") or sx not in (None, "x"):
            raise ValueError(f"unsupported partition spec {spec}")
        d0, d1 = a.shape[0], a.shape[1]
        a0 = self.my if sy == "y" else 1
        a1 = self.mx if sx == "x" else 1
        if d0 % a0 or d1 % a1:
            raise ValueError(f"shape {tuple(a.shape)} does not split over "
                             f"the {self.my}x{self.mx} mesh by {spec}")
        iy, ix = self.coords
        by, bx = d0 // a0, d1 // a1
        r0 = iy * by if sy == "y" else 0
        c0 = ix * bx if sx == "x" else 0
        return a[r0:r0 + by, c0:c0 + bx][None, None]

    def _stacks(self, blocks):
        """Every rank's (1, 1, *shape) block of each tensor as one
        (my, mx, *shape) stack each: one all-gather."""
        blocks = [self._full(b) for b in blocks]
        packed = self._transport.all_gather(_pack(blocks, blocks[0].device))
        out, off = [], 0
        for b in blocks:
            n = math.prod(b.shape) * b.dtype.itemsize
            out.append(packed[:, off:off + n].view(b.dtype).reshape(
                self.my, self.mx, *b.shape[2:]))
            off += _nbytes(b.shape, b.dtype)
        return out

    def gather_many(self, *pairs):
        live = [(b, s) for b, s in pairs if b is not None]
        stacks = iter(self._stacks([b for b, _ in live]) if live else ())
        return [None if b is None else self._inproc.gather(next(stacks), s)
                for b, s in pairs]

    def gather(self, b, spec):
        return self.gather_many((b, spec))[0]

    def psum_many(self, *pairs):
        iy, ix = self.coords
        stacks = self._stacks([x for x, _ in pairs])
        return [self._inproc.psum(st, axes)[iy:iy + 1, ix:ix + 1]
                for st, (_, axes) in zip(stacks, pairs)]

    def psum(self, x, axes):
        return self.psum_many((x, axes))[0]

    # -- primitives inside a shard body -------------------------------------

    def axis_index(self, axis: str, nd: int = 2, device=None):
        """This rank's index along ``axis``, int64, shaped (1, 1, *1s)."""
        i = self.coords[self._dim(axis)]
        return torch.full([1, 1] + [1] * nd, i, dtype=torch.int64,
                          device=device)

    def _peer(self, axis, step, ring: bool):
        """The rank ``step`` shards away along ``axis``, or along both axes
        (``axis`` ("y", "x"), ``step`` a pair; ``ring`` wraps x only);
        None beyond the domain edge without ``ring``."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        steps = step if isinstance(step, tuple) else (step,)
        at = dict(zip(("y", "x"), self.coords))
        for a, s in zip(axes, steps):
            i = at[a] + s
            if not 0 <= i < self.shape[a]:
                if not ring or (len(axes) == 2 and a == "y"):
                    return None
                i %= self.shape[a]
            at[a] = i
        return at["y"] * self.mx + at["x"]

    def exchange(self, *requests):
        """One round of messages: each neighbour gets one buffer of every
        payload bound for it, in request order."""
        sends, recvs, out = {}, {}, [None] * len(requests)
        for k, (x, axis, side, *ring) in enumerate(requests):
            ring = bool(ring and ring[0])
            x = self._full(x)
            sides = side if isinstance(axis, tuple) else (side,)
            step = tuple(-1 if sd == PREV else 1 for sd in sides)
            src = self._peer(axis, step, ring)
            dst = self._peer(axis, tuple(-st for st in step), ring)
            if src is None:
                out[k] = torch.zeros_like(x)
            elif src == self.rank:
                out[k] = x
            else:  # the peer's payload has this one's shape and dtype
                recvs.setdefault(src, []).append((k, (x.shape, x.dtype)))
            if dst is not None and dst != self.rank:
                sends.setdefault(dst, []).append(x)
        if not sends and not recvs:
            return out
        dev = requests[0][0].device
        send_bufs = {p: _pack(xs, dev) for p, xs in sends.items()}
        recv_bufs = {p: torch.empty(sum(_nbytes(*like) for _, like in got),
                                    dtype=torch.uint8, device=dev)
                     for p, got in recvs.items()}
        self._transport.p2p(
            {p: b for p, b in send_bufs.items() if b.numel()},
            {p: b for p, b in recv_bufs.items() if b.numel()})
        for p, got in recvs.items():
            views = _unpack(recv_bufs[p], [like for _, like in got])
            for (k, _), t in zip(got, views):
                out[k] = t
        return out

    def from_prev(self, x, axis: str, ring: bool = False):
        return self.exchange((x, axis, PREV, ring))[0]

    def from_next(self, x, axis: str, ring: bool = False):
        return self.exchange((x, axis, NEXT, ring))[0]

    def bases(self, by: int, bx: int, device=None):
        iy, ix = self.coords
        return torch.tensor([[iy * by, ix * bx]], dtype=torch.int32,
                            device=device)

    def wall_flags(self, device=None):
        iy, ix = self.coords
        return torch.tensor([[iy == 0, iy == self.my - 1, ix == 0,
                              ix == self.mx - 1]], dtype=torch.float32,
                            device=device)


# -- process groups and devices --------------------------------------------


def backend_for(device, backend: str | None = None) -> str:
    """The caller's backend, else NCCL for CUDA and gloo for the CPU."""
    if backend is not None:
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, local_rank: int, backend: str) -> torch.device:
    """``cuda:{local_rank}`` where the node has that many cards; else, for
    gloo ranks (the caller asked for ranks that share cards),
    ``cuda:{local_rank % cards}``, and for NCCL a raise.  The CPU for CPU
    runs."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if local_rank < cards:
        return torch.device("cuda", local_rank)
    if backend != "gloo":
        raise RuntimeError(
            f"{backend} rank {local_rank}: this node has {cards} CUDA "
            f"device(s), and {backend} refuses two ranks on one device "
            "(ranks share a card only under gloo)")
    return torch.device("cuda", local_rank % cards)


def _init(backend: str, dev: torch.device, init_method: str, rank: int,
          world: int, timeout_s: float):
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # raises on failure: the run never goes on alone or on another device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def torchrun_world() -> int:
    """WORLD_SIZE of a torchrun launch (1 outside one)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_from_env(device="cuda", backend: str | None = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the world torchrun started (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT); returns this rank's device."""
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                          "MASTER_ADDR", "MASTER_PORT")}
    missing = [k for k, v in env.items() if v is None]
    if missing:
        raise RuntimeError(f"not under torchrun: {', '.join(missing)} unset")
    backend = backend_for(device, backend)
    dev = rank_device(device, int(env["LOCAL_RANK"]), backend)
    _init(backend, dev, f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
          int(env["RANK"]), int(env["WORLD_SIZE"]), timeout_s)
    return dev


def shutdown():
    """Destroy the process group, if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def replicas_agree(state) -> bool:
    """Whether every leaf of ``state`` (a ModelState, or a dict of
    tensors) holds rank 0's bits on every rank: an all-gather of a 64-bit
    digest of each leaf (a check for tests and the chip run, not on the
    step's path)."""
    from pylamp_tpu_torch.bridge import state_leaves

    leaves = state if isinstance(state, dict) else state_leaves(state)
    digests = [int.from_bytes(hashlib.sha256(
        v.detach().contiguous().cpu().numpy().tobytes()).digest()[:8],
        "little", signed=True) for v in leaves.values()]
    dev = next(iter(leaves.values())).device
    got = _Transport.current().all_gather(
        torch.tensor(digests, dtype=torch.int64, device=dev))
    return bool((got == got[0]).all())


# -- spawning a world ---------------------------------------------------------


def _rank_main(rank, world, out_dir, backend, device, timeout_s):
    torch.set_num_threads(1)
    try:
        fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                              weights_only=False)
        dev = rank_device(device, rank, backend)
        _init(backend, dev, f"file://{os.path.join(out_dir, 'store')}",
              rank, world, timeout_s)
        try:
            result = fn(dev, *args)
        finally:
            shutdown()
        torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def launch(world: int, fn, *args, device, backend: str | None = None,
           timeout_s: float = 60.0):
    """Run ``fn(device, *args)`` on each rank of a ``world``-rank group of
    spawned processes and return the ranks' results in rank order.
    ``device`` ("cuda" or "cpu") is the ranks' device type, always named
    by the caller.

    The call (``fn`` and ``args``) reaches the ranks, and their results
    come back, through files in a fresh temporary directory, where the
    group also meets at a ``file://`` store (no port to race for).  Each
    rank runs one torch intra-op thread and takes its device by
    ``rank_device`` (gloo ranks may share a card); every collective is
    bounded by ``timeout_s``, and the parent waits at most ``timeout_s``
    for the world, then kills the ranks and raises.  A rank that fails
    fails the launch with its traceback.  On a CUDA ``device`` the kernel
    library is built here, once, before any rank starts.  ``fn`` and its
    results must pickle."""
    import multiprocessing

    backend = backend_for(device, backend)
    if torch.device(device).type == "cuda":
        from pylamp_tpu_torch import cuda_build

        cuda_build.build()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        # the call goes through a file: a large argument in the spawn pipe
        # would start the ranks one after the other
        torch.save((fn, args), os.path.join(out_dir, "call.pt"))
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, out_dir, backend, device, timeout_s), daemon=True)
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"launch: the {world}-rank world did not finish in "
                        f"{timeout_s:.0f} s")
                time.sleep(0.01)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as fh:
                    errors.append(f"rank {r}:\n{fh.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("launch failed:\n" + "\n".join(errors))
        return [torch.load(os.path.join(out_dir, f"result_{r}.pt"),
                           weights_only=False) for r in range(world)]
