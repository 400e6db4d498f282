"""The port's collectives over ``torch.distributed`` (the reference's
``jax.lax.all_gather`` and ``ppermute`` inside ``shard_map``).

The model axis runs one process per rank in a gloo group: on the CPU, and
on the card too, because NCCL will not put two ranks on one GPU.  gloo's
``all_gather`` and send / recv take host tensors, so a CUDA tensor is
staged through pinned host memory here, explicitly and in this module
alone: the caller's step still runs on the card, and a collective that
fails raises.  Every leaf travels as its bytes (``uint8``), so any dtype
crosses (fp8 codes included) and arrives bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def group_size(group=None) -> int:
    """Ranks in ``group`` (None: the default group; 1 when no process
    group was initialized)."""
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank in ``group`` (None: the default group; 0 when
    no process group was initialized)."""
    if group is None and not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _global_rank(group, rank: int) -> int:
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes on the host (pinned for a CUDA tensor; the copy waits
    for the device)."""
    b = x.contiguous().view(torch.uint8).reshape(-1)
    if b.device.type == "cpu":
        return b
    host = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(b)
    return host


def _from_host(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bytes received on the host -> a tensor of ``like``'s shape, dtype
    and device."""
    return b.view(like.dtype).reshape(like.shape).to(like.device)


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reference's tiled ``all_gather``); each rank's ``x`` has one shape."""
    n = group_size(group)
    if n == 1:
        return x
    host = _to_host(x)
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    shards = [p.view(x.dtype).reshape(x.shape) for p in parts]
    return torch.cat(shards, dim=dim).to(x.device)


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
