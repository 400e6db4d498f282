"""FLOPs and bytes of one executed step, by op (counterpart of
``repro.launch.hlo_analysis``).

The reference re-derives the dot FLOPs of a compiled step from its HLO,
because ``cost_analysis()`` counts a ``while`` body once.  An eager torch
step has no loop to under-count: its counterpart counts the ops as they
run.

    with op_analysis.count() as c:
        step(...)
    c.flops, c.flops_by_op, c.bytes_by_op

  * GEMMs and every other op outside the attention ops: the aten FLOPs
    that ``torch.utils.flop_counter.FlopCounterMode`` reports (its
    formula registry, its decompositions), and each such op's bytes, its
    tensor inputs read once and its output written once.
  * The attention ops of ``kernels.ops`` (paged decode, paged prefill,
    contiguous decode, shift-KV, PASA and FlashAttention-2): each call
    adds its formula from ``kernels.cost`` (the kernel bound's) and
    nothing of what runs inside it - the CUDA kernel, the plain version
    or the ``meta`` branch alike (``kernels.cost.run_op``); the
    plain-version backward of ``kernels.train_attention.KernelAttention``
    adds ``cost.BACKWARD_FACTOR`` times its forward sweep's FLOPs.  So the
    count reads the same work whatever implements the op: on the
    ``meta`` device (the dry run), on the CPU and on the card.

A length-dependent op (the decodes, paged prefill) reads its lengths
from the tensor; on ``meta`` there are none, and the caller names them:
``count(lengths={"kv_len": [...], "chunk_start": [...]})``.

The count is process-wide, not per thread: on the card autograd runs the
backward (and a remat recompute) on a device thread of its own.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.cost import ACTIVE as _ACTIVE

_aten = torch.ops.aten
_prim = torch.ops.prim
# metadata queries FlopCounterMode leaves to their defaults
_SKIP = {
    _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    _prim.layout.default,
}


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) argument list."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(x) for x in tree.values())
    return 0


class OpCount:
    """The running totals of one :func:`count`: ``flops``, and by op name
    (``aten.mm``, ``pasa_attention``, ``pasa_attention.backward``, ...)
    ``flops_by_op``, ``bytes_by_op`` and ``calls_by_op``."""

    def __init__(self, lengths: Optional[Dict[str, list]] = None):
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.bytes_by_op: Dict[str, int] = {}
        self.calls_by_op: Dict[str, int] = {}
        self.lengths = dict(lengths or {})
        self._inside = 0          # attention ops open now

    def add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.flops_by_op[name] = self.flops_by_op.get(name, 0) + flops
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + nbytes
        self.calls_by_op[name] = self.calls_by_op.get(name, 0) + 1

    @property
    def bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "flops_by_op": dict(self.flops_by_op),
                "bytes_by_op": dict(self.bytes_by_op),
                "calls_by_op": dict(self.calls_by_op)}


class _Mode(TorchDispatchMode):
    """FlopCounterMode's dispatch, counting into an :class:`OpCount`
    except inside an attention op."""

    def __init__(self, counter: OpCount):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SKIP:
            return NotImplemented
        if self.counter._inside:
            return func(*args, **kwargs)
        if func is not _prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.counter.add(str(packet), int(formula(*args, **kwargs,
                                                      out_val=out)),
                             _tensor_bytes((args, kwargs)) + _tensor_bytes(out))
        return out


@contextlib.contextmanager
def count(lengths: Optional[Dict[str, list]] = None):
    """Count the FLOPs and bytes of the ops run inside (module doc).
    ``lengths``: the host lengths of the length-dependent attention ops
    on ``meta`` (``kv_len``, ``chunk_start``), each a list over the
    batch."""
    c = OpCount(lengths)
    _ACTIVE.append(c)
    try:
        with _Mode(c):
            yield c
    finally:
        _ACTIVE.remove(c)
