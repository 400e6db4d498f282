"""The port's collectives over ``torch.distributed`` (the reference's
``jax.lax.all_gather``, ``all_to_all``, ``psum`` / ``pmax`` and
``ppermute`` inside ``shard_map``).

A mesh axis that runs across processes is a gloo group: on the CPU, and
on the card too, because NCCL will not put two ranks on one GPU.  gloo's
collectives take host tensors, so a CUDA tensor is staged through pinned
host memory here, explicitly and in this module alone: the caller's step
still runs on the card, and a collective that fails raises.  Every
tensor travels as its bytes (``uint8``), so any dtype crosses (fp8 codes
and the int16 of the compressed gradient sync included) and arrives bit
for bit.

Reductions (:func:`all_reduce`) are an ``all_gather`` followed by a sum
(or max) in rank order at the tensor's dtype: deterministic, bit-equal
on every rank, and exact on integers (gloo's own ``all_reduce`` refuses
int16).  :func:`reduce_scatter` sends each rank only its block (one
``all_to_all``) and folds the blocks in the same order, so its result is
the bits of ``all_reduce``'s on that block.  :data:`WIRE` counts what
each call put on the wire.

The autograd Functions carry the reference's transposes, with the
convention that a replicated tensor's cotangent is whole on every rank:
the backward of :func:`all_to_all` is ``all_to_all``; of a tiled gather
whose output is replicated (:func:`gather_replicated`) this rank's slice
of the cotangent; of a tiled gather of a parameter's blocks that each
rank then uses on its own part of the data (:func:`gather_sharded`) the
group's sum of the cotangents, this rank's block of it
(:func:`reduce_scatter`); of taking this rank's slice of a replicated
input (:func:`slice_replicated`) the slices' cotangents gathered (a
scatter into zeros summed over the group, without the zeros on the
wire); of a sum whose output is replicated (:func:`sum_replicated`) the
identity; :func:`sum_grad` (a replicated parameter used on this rank's
part of the data) sums its gradient over the group; a sum of partial
terms that each rank then uses on its own channels (:func:`sum_split`)
sums both ways; and a tiled gather of which each rank keeps its own
segments (:func:`gather_segments`) gathers every rank's segments'
cotangents and keeps its block of their sum.
"""

from __future__ import annotations

import collections
import time
from typing import List, Sequence

import torch
import torch.distributed as dist


# the group of this process alone: a mesh axis of size 1, over which
# every collective here is the identity
LOCAL = "local"


class AbstractGroup:
    """A group of ``size`` ranks that exist as shapes only: an axis of the
    dry run's production mesh (``launch.mesh.make_production_mesh``), on
    which this process plays rank 0 on the ``meta`` device.  A collective
    over it takes ``meta`` tensors (anything else raises), logs in
    :data:`WIRE` what rank 0 of a real group would put on the wire, and
    returns empty results of the real shapes."""

    def __init__(self, size: int):
        self.size = int(size)

    def __repr__(self) -> str:
        return f"AbstractGroup({self.size})"


def _abstract(x: torch.Tensor, group) -> bool:
    """True for a collective over an :class:`AbstractGroup` (whose tensors
    must lie on ``meta``)."""
    if not isinstance(group, AbstractGroup):
        return False
    if x.device.type != "meta":
        raise ValueError(f"a collective over {group} takes meta tensors, "
                         f"got one on {x.device}")
    return True


def group_size(group=None) -> int:
    """Ranks in ``group`` (None: the default group; 1 when no process
    group was initialized, and for ``LOCAL``)."""
    if isinstance(group, AbstractGroup):
        return group.size
    if group is LOCAL or (group is None and not dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank in ``group`` (None: the default group; 0 when
    no process group was initialized, and for ``LOCAL`` and an
    :class:`AbstractGroup`)."""
    if group is LOCAL or isinstance(group, AbstractGroup) or (
            group is None and not dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def _global_rank(group, rank: int) -> int:
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


class WireLog:
    """What this process put on the wire: one ``(collective, dtype,
    bytes)`` entry per call (``totals()`` sums them per key), and the
    host seconds the calls spent waiting for the device to finish the
    tensor (``wait_s``), staging it between the card and pinned host
    memory (``stage_s``) and in gloo (``wire_s``).  ``reset()`` zeroes
    it."""

    def __init__(self):
        self.entries: List[tuple] = []
        self.wait_s = self.stage_s = self.wire_s = 0.0

    def add(self, op: str, dtype: torch.dtype, nbytes: int) -> None:
        self.entries.append((op, str(dtype).replace("torch.", ""), nbytes))

    def reset(self) -> None:
        self.entries.clear()
        self.wait_s = self.stage_s = self.wire_s = 0.0

    def totals(self) -> dict:
        """{(op, dtype): {"calls": n, "bytes": b}}."""
        out = collections.defaultdict(lambda: {"calls": 0, "bytes": 0})
        for op, dt, n in self.entries:
            out[(op, dt)]["calls"] += 1
            out[(op, dt)]["bytes"] += n
        return dict(out)


WIRE = WireLog()


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes on the host (pinned for a CUDA tensor; the copy waits
    for the device)."""
    b = x.contiguous().reshape(-1).view(torch.uint8)
    if b.device.type == "cpu":
        return b
    t0 = time.perf_counter()
    torch.cuda.current_stream(b.device).synchronize()  # the copy waits too
    t1 = time.perf_counter()
    host = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(b)
    WIRE.wait_s += t1 - t0
    WIRE.stage_s += time.perf_counter() - t1
    return host


def _host_empty(nbytes: int, like: torch.Tensor) -> torch.Tensor:
    """A host byte buffer to receive into: pinned when ``like`` is a CUDA
    tensor (from the caching host allocator, so a buffer of a size seen
    before is reused, its pages already mapped, and the copy to the card
    is a DMA)."""
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=like.device.type == "cuda")


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` (timed as staging on a card)."""
    if device.type == "cpu":
        return t
    t0 = time.perf_counter()
    out = t.to(device)
    WIRE.stage_s += time.perf_counter() - t0
    return out


def _wire(call, *args, **kwargs) -> None:
    t0 = time.perf_counter()
    call(*args, **kwargs)
    WIRE.wire_s += time.perf_counter() - t0


def _from_host(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bytes received on the host -> a tensor of ``like``'s shape, dtype
    and device."""
    return _to_device(b.view(like.dtype).reshape(like.shape), like.device)


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reference's tiled ``all_gather``); each rank's ``x`` has one shape."""
    n = group_size(group)
    if n == 1:
        return x
    return _to_device(torch.cat(_gather_parts(x, group), dim=dim), x.device)


# gloo moves one call's bytes on one connection; a large tensor goes as
# pieces of at most this many bytes, all in flight at once (about twice
# the rate of one call on a host's loopback)
WIRE_PIECE = 1 << 26


def _gather_parts(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank) on the host, in rank
    order (``x`` itself for each rank of an :class:`AbstractGroup`)."""
    if _abstract(x, group):
        WIRE.add("all_gather", x.dtype, x.numel() * x.element_size())
        return [x] * group.size
    host = _to_host(x)
    n, nb = group_size(group), host.numel()
    parts = list(_host_empty(n * nb, x).view(n, nb))
    WIRE.add("all_gather", x.dtype, nb)

    def gather():
        works = [dist.all_gather([p[a:a + WIRE_PIECE] for p in parts],
                                 host[a:a + WIRE_PIECE], group=group,
                                 async_op=True)
                 for a in range(0, nb, WIRE_PIECE)]
        for w in works:
            w.wait()

    _wire(gather)
    return [p.view(x.dtype).reshape(x.shape) for p in parts]


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The group's sum (``op="sum"``) or max (``"max"``) of ``x``: every
    rank's ``x`` gathered, then folded in rank order at ``x``'s dtype on
    ``x``'s device - the same bits on every rank."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce op {op!r}: sum or max")
    if group_size(group) == 1:
        return x
    me = group_rank(group)
    parts = [x if r == me else _to_device(p, x.device)
             for r, p in enumerate(_gather_parts(x, group))]
    out = parts[0]
    for p in parts[1:]:
        out = out + p if op == "sum" else torch.maximum(out, p)
    return out


def reduce_scatter(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's block along ``dim`` (equal blocks in rank order) of the
    group's sum of ``x``, folded in rank order at ``x``'s dtype: the bits
    :func:`all_reduce` gives on that block.  Each rank receives only its
    block from every other (``all_to_all_single`` on the host, in pieces
    of ``WIRE_PIECE`` bytes a peer, all in flight at once); :data:`WIRE`
    logs the bytes that leave this rank, (n - 1) / n of ``x``'s."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter of dim {dim} of {tuple(x.shape)} "
                         f"over {n} ranks")
    blocks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    me = group_rank(group)
    like = blocks[me]
    nb = like.numel() * like.element_size()
    WIRE.add("reduce_scatter", x.dtype, nb * (n - 1))
    if _abstract(x, group):
        return torch.empty(like.shape, dtype=x.dtype, device=x.device)
    sent = _to_host(blocks).view(n, nb)
    recv = _host_empty(n * nb, x).view(n, nb)

    def exchange():
        # one all_to_all_single a piece of every block (gloo has no
        # list-form all_to_all), the pieces' columns copied contiguous
        works = []
        for a in range(0, nb, WIRE_PIECE):
            dst = recv[:, a:a + WIRE_PIECE]
            src = sent[:, a:a + WIRE_PIECE].contiguous()
            out = dst if dst.is_contiguous() else torch.empty_like(src)
            works.append((dst, out, dist.all_to_all_single(
                out, src, group=group, async_op=True)))
        for dst, out, w in works:
            w.wait()
            if out is not dst:
                dst.copy_(out)

    _wire(exchange)
    out = None
    for r in range(n):
        part = like if r == me else _from_host(recv[r], like)
        out = part if out is None else out + part
    return out.contiguous()


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's untiled ``all_to_all`` over axis 0 (split 0,
    concat 0): ``x`` (n, ...) with n the group's size; row j goes to rank
    j, and row i of the result came from rank i."""
    n = group_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all of {tuple(x.shape)} over {n} ranks")
    if n == 1:
        return x
    if _abstract(x, group):
        nbytes = x.numel() * x.element_size()
        WIRE.add("all_to_all", x.dtype, nbytes * (n - 1) // n)
        return torch.empty_like(x)
    host = _to_host(x)
    out = _host_empty(host.numel(), x)
    WIRE.add("all_to_all", x.dtype, host.numel() * (n - 1) // n)
    _wire(dist.all_to_all_single, out, host, group=group)
    return _from_host(out, x)


class RingShift:
    """One step of a ring: each rank sends ``tensors`` to rank + 1 and
    receives the same shapes from rank - 1, posted at construction
    (``dist.batch_isend_irecv``) so the caller computes while the bytes
    move; :meth:`wait` returns the received tensors on the senders'
    device."""

    def __init__(self, tensors: Sequence[torch.Tensor], group=None):
        n, me = group_size(group), group_rank(group)
        nxt = _global_rank(group, (me + 1) % n)
        prv = _global_rank(group, (me - 1) % n)
        self._like = list(tensors)
        self._sent = [_to_host(t) for t in tensors]
        self._recv = [torch.empty_like(b) for b in self._sent]
        ops = []
        for s, r in zip(self._sent, self._recv):
            ops.append(dist.P2POp(dist.isend, s, nxt, group))
            ops.append(dist.P2POp(dist.irecv, r, prv, group))
        self._reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for req in self._reqs:
            req.wait()
        return [_from_host(b, t) for b, t in zip(self._recv, self._like)]


def shard(x: torch.Tensor, dim: int, parts: int, index: int,
          ) -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``x`` along ``dim``, as a
    contiguous copy."""
    size = x.shape[dim] // parts
    return x.narrow(dim, index * size, size).contiguous()


# ------------------------------------------------- differentiable forms --

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (shard(g, ctx.dim, group_size(ctx.group),
                      group_rank(ctx.group)), None, None)


class _GatherSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.dim, ctx.group), None, None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return shard(x, dim, group_size(group), group_rank(group))

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


class _GatherSegments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, segments, group):
        ctx.segments, ctx.group, ctx.width = segments, group, x.shape[-1]
        full = all_gather(x, x.dim() - 1, group)
        return torch.cat([full[..., a:a + n]
                          for a, n in segments[group_rank(group)]], dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, me = group_size(ctx.group), group_rank(ctx.group)
        parts = all_gather(g.contiguous()[None], 0, ctx.group)
        full = g.new_zeros(g.shape[:-1] + (ctx.width * n,))
        for r in range(n):              # rank order: the same bits everywhere
            off = 0
            for a, k in ctx.segments[r]:
                full[..., a:a + k] += parts[r][..., off:off + k]
                off += k
        return shard(full, full.dim() - 1, n, me), None, None


def _active(group) -> bool:
    return group_size(group) > 1


def all_to_all_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_to_all` whose backward is ``all_to_all``."""
    return _AllToAll.apply(x, group) if _active(group) else x


def gather_replicated(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Tiled ``all_gather`` along ``dim`` whose output is replicated: the
    backward is this rank's slice of the cotangent."""
    return _GatherReplicated.apply(x, dim, group) if _active(group) else x


def gather_sharded(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Tiled ``all_gather`` along ``dim`` of a parameter's blocks (ZeRO
    over the data axes): each rank uses the whole on its own part of the
    data, so the backward is the group's sum of the cotangents, this
    rank's block of it (:func:`reduce_scatter`)."""
    return _GatherSharded.apply(x, dim, group) if _active(group) else x


def slice_replicated(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's part of a replicated ``x`` along ``dim`` (equal parts
    in rank order): the backward gathers every rank's cotangent."""
    return _SliceReplicated.apply(x, dim, group) if _active(group) else x


def sum_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_reduce` (sum) whose output is replicated: the backward
    is the identity."""
    return _SumReplicated.apply(x, group) if _active(group) else x


def sum_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` forward; its gradient summed over the group backward (a
    replicated parameter that each rank uses on its part of the data)."""
    return _SumGrad.apply(x, group) if _active(group) else x


def sum_split(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_reduce` (sum) forward and backward: the partial sums of
    a contraction split over the group whose result each rank then uses
    on its own channels, so that its cotangent is a partial sum too."""
    return sum_grad(sum_replicated(x, group), group)


def gather_segments(x: torch.Tensor, segments, group=None) -> torch.Tensor:
    """Every rank's block ``x`` (..., W / n) gathered along the last dim
    into the whole (..., W), of which this rank keeps its ``segments``
    (``segments[r]``: the ``(start, length)`` column runs that rank ``r``
    keeps, concatenated in order; every rank keeps as many columns).
    The backward gathers every rank's cotangent of its segments, adds
    them into the whole width in rank order (a column two ranks keep gets
    both) and returns this rank's block of the sum: a column-parallel
    product whose output columns do not fall on the ranks that use them
    exchanges activations, not its weight."""
    return _GatherSegments.apply(x, segments, group)
