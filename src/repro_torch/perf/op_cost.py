"""The counterpart of ``repro.perf.hlo_cost``: the per-device cost of a
step, counted op by op as it runs (the port has no HLO to parse).

:class:`OpCost` is a dispatch mode. Run a step under it, usually on fake
tensors (``FakeTensorMode``) and DTensors over a fake world
(``launch.dryrun``): it hands every op on DTensors back to DTensor
(``NotImplemented``), so it sees the ops each device runs on its local
shards, and the collectives DTensor inserts, rather than the global op.
A product over a 16-way sharded weight counts 1/16 of its global flops;
a fully replicated product its whole count on every device.

Conventions (the reference's):
  flops: products only: mm, addmm, bmm and baddbmm (what einsum and
         matmul reach) at 2 * result * contraction; convolutions and
         elementwise flops are ignored.
  bytes: per op, unique operand bytes + result bytes. Views, dtype-only
         converts and allocations are free; an in-place scatter of rows
         (index_copy_, index_put_, ...) reads and writes its rows, twice
         the bytes of its other operands, not the buffer.
  collectives: result bytes with ring-model wire multipliers
         (``roofline.ring_wire_bytes``), the group size from the
         collective's process group; a group whose ranks lie on more than
         one node of ``roofline.NODE_GPUS`` is counted apart.
  loops: eager PyTorch runs every trip, so no trip count is parsed.

It also keeps the live bytes of every storage that an op creates (and of
the storages given to :meth:`OpCost.hold`), freed when the storage dies,
and their peak: a step's peak memory per device.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.perf.roofline import NODE_GPUS, CollectiveStats

_aten = torch.ops.aten
# product op -> the args holding (a, b) of its batch of a @ b
_PRODUCTS = {_aten.mm.default: (0, 1), _aten.addmm.default: (1, 2),
             _aten.bmm.default: (0, 1), _aten.baddbmm.default: (1, 2)}
# in-place writes of a few rows: what is read and written is the rows
# (the reference's dynamic-update-slice), not the buffer
_SCATTERS = {_aten.index_copy_.default, _aten.index_put_.default,
             _aten._index_put_impl_.default, _aten.scatter_.src,
             _aten.scatter_add_.default, _aten.index_add_.default}
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.new_empty.default, _aten.empty_like.default,
                _aten.new_empty_strided.default}
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def product_flops(func, args) -> float:
    """2 * result * contraction of a product op (0 for any other)."""
    idx = _PRODUCTS.get(func)
    if idx is None:
        return 0.0
    a, b = args[idx[0]], args[idx[1]]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


class OpCost(TorchDispatchMode):
    """Counts flops, bytes, collectives and live bytes of what runs under
    it (see the module docstring); with ``counts``, only the ops with a
    tensor argument or result ``t`` for which ``counts(t)`` holds (the
    dry run counts the ops on its fake local shards, not the ones DTensor
    runs to plan them). Read ``flops``, ``bytes``,
    ``collectives`` (a ``roofline.CollectiveStats``), ``live_bytes`` and
    ``peak_bytes`` after the run."""

    def __init__(self, counts=None):
        super().__init__()
        # which ops count: those with a tensor argument or result for
        # which counts(t) holds (default: every op)
        self._counts = counts
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = CollectiveStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held: set[int] = set()
        self._groups: dict[str, tuple[int, bool]] = {}

    def hold(self, tensors) -> int:
        """Count the storages of ``tensors`` (DTensors: their local
        shards) as live until they die; returns the bytes added."""
        from torch.distributed.tensor import DTensor
        added = 0
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            added += self._hold(t)
        return added

    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return 0
        n = st.nbytes()
        self._held.add(key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)
        return n

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live_bytes -= n

    def _group(self, name: str) -> tuple[int, bool]:
        """(size, spans nodes) of the process group named ``name``."""
        if name not in self._groups:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import (
                _resolve_process_group,
            )
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(name))
            nodes = {r // NODE_GPUS for r in ranks}
            self._groups[name] = (len(ranks), len(nodes) > 1)
        return self._groups[name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        results = _tensors(out)
        ins = _tensors(list(args) + list(kwargs.values()))
        if self._counts is not None and not any(
                self._counts(t) for t in results + ins):
            return
        if not results or func.is_view or func in _ALLOCATIONS:
            for t in results:
                self._hold(t)
            return
        op = _COLLECTIVES.get(func._overloadpacket.__name__) \
            if func.namespace == "_c10d_functional" else None
        if func.namespace == "_c10d_functional" and op is None:
            return                       # wait_tensor: the result's alias
        if (func == _aten._to_copy.default and len(ins) == 1
                and set(kwargs) <= {"dtype"}):
            for t in results:
                self._hold(t)
            return                       # a dtype-only convert
        res_bytes = sum(_nbytes(t) for t in results)
        if op is not None:
            size, cross = self._group(args[-1])
            self.collectives.add(op, res_bytes, size, cross)
            self.bytes += res_bytes
        elif func in _SCATTERS:
            self.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
        else:
            self.flops += product_flops(func, args)
            seen, opnd = set(), 0
            for t in ins:
                if id(t) not in seen:
                    seen.add(id(t))
                    opnd += _nbytes(t)
            self.bytes += opnd + res_bytes
        for t in results:
            self._hold(t)
