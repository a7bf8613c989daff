"""Op-level cost counter: the port's counterpart of ``repro.launch.hlo_analysis``.

The reference re-derives whole-program costs from optimized HLO text
because XLA's ``cost_analysis()`` counts a while-loop body once, and its
layers run under ``lax.scan``. That reason does not arise here: the port
runs eagerly, so one run of a step visits every layer and microbatch (the
layer stacks are Python loops), and remat recomputes each layer through
``torch.utils.checkpoint``, which the run's backward shows as operators
like any other. There are no trip counts to recover.

:func:`count` is a context manager around a ``TorchDispatchMode`` that
sees every operator a step runs on this rank's local tensors and fills a
:class:`Costs` with the reference's fields:

  * ``flops``, per device: ``torch.utils.flop_counter``'s registry (matrix
    products, convolutions, attention) and the FLOP formulas the kernel ops
    register (K2, K3 and their backwards: ``kernels.flash_attention``,
    ``kernels.ssd_scan``). An operator not in the registry is decomposed
    first where it can be, as ``FlopCounterMode`` does, so a trace counts
    what ``FlopCounterMode`` counts for the same step run for real. The route
    to per-device counts: an operator on DTensors is passed on
    (``NotImplemented``), DTensor's dispatch runs it on the local shards,
    and those operators come back to the mode on plain tensors and are
    counted. DTensor's sharding propagation also evaluates each operator at
    the global shape on fake tensors; it runs with the counter paused (and
    outside the fake mode, whose tensors would make its index arithmetic
    data-dependent): :func:`_dtensor_metadata`.
  * ``bytes``: each operator's inputs plus outputs, as stored in the
    tensors it reads and writes (a broadcast input, expanded with stride 0,
    once). In eager mode every operator is its own kernel, so there are no
    fusion boundaries to respect. Views, aliases, uninitialised allocations
    and metadata queries (``prim.device``) move no bytes. Tallied by
    operator as ``Costs.tally`` does.
  * ``coll``: payload bytes by kind (all-gather, all-reduce,
    reduce-scatter, all-to-all) of the ``_c10d_functional`` and ``c10d``
    operators: the largest tensor among an operator's inputs and outputs,
    the rule of the reference's analyzer.
  * ``calls``: the kernel ops' calls (``repro_torch::flash_attention`` and
    the others), where the reference has none.

The counter also follows the storages that operators create (weak
references, freed when the last tensor on them dies): ``peak_bytes`` is
the most such bytes alive at once, the dry-run's temporary memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

KERNEL_NAMESPACE = "repro_torch"
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# the reference's kinds, by the operator's name without underscores
_COLLECTIVE_KINDS = {"allgather": "all-gather", "reducescatter": "reduce-scatter",
                     "allreduce": "all-reduce", "alltoall": "all-to-all"}
# allocations that write nothing
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def tally(self, kind: str, nbytes: float):
        self.bytes += nbytes
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + nbytes


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of memory ``t`` spans: its elements, but an expanded
    (stride 0) dim once, as an operator reads a broadcast input once."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))
    return min(span, t.numel()) * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _collective_kind(name: str):
    """The reference's kind of a collective operator, None for a wait."""
    if name == "wait_tensor":
        return None
    flat = name.replace("_", "")
    return next((kind for part, kind in _COLLECTIVE_KINDS.items() if part in flat), name)


class OpCounter(TorchDispatchMode):
    """The mode :func:`count` enters: :class:`Costs` in ``costs``, and the
    bytes of storages created under it, ``live_bytes`` now and
    ``peak_bytes`` at most. ``arguments`` (tensors, or trees of them) are
    the step's inputs, whose storages count as neither."""

    def __init__(self, arguments=()):
        super().__init__()
        self.costs = Costs()
        self.live_bytes = self.peak_bytes = 0
        self.paused = 0
        self._storages: Dict[int, int] = {}     # id -> bytes counted
        for t in _tensors(arguments):
            self._track(_local(t), counted=False)

    def _track(self, t: torch.Tensor, *, counted: bool = True) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._storages:
            return
        nbytes = storage.nbytes() if counted else 0
        self._storages[key] = nbytes
        weakref.finalize(storage, self._free, key)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it on the local shards
        if self.paused:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        inputs, outputs = _tensors((args, kwargs)), _tensors(out)
        if packet in flop_registry:
            self.costs.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        if func.namespace == KERNEL_NAMESPACE:
            self.costs.calls[name] = self.costs.calls.get(name, 0) + 1
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _collective_kind(name)
            if kind is not None:
                self.costs.coll[kind] = self.costs.coll.get(kind, 0.0) + max(
                    [tensor_bytes(t) for t in inputs + outputs] + [0])
                self.costs.tally(kind, sum(map(tensor_bytes, inputs + outputs)))
        elif not (func.namespace == "prim" or func.is_view or name in _NO_BYTES
                  or _aliases(func, inputs, outputs)):
            self.costs.tally(name, sum(map(tensor_bytes, inputs + outputs)))
        for t in outputs:
            self._track(t)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _aliases(func, inputs, outputs) -> bool:
    """An operator that writes nothing and returns its inputs' storage
    (``_unsafe_view``, ``_reshape_alias``) moves no bytes."""
    if func._schema.is_mutable or not outputs:
        return False
    mine = {id(t.untyped_storage()) for t in inputs}
    return all(id(t.untyped_storage()) in mine for t in outputs)


@contextlib.contextmanager
def _dtensor_metadata(counter: OpCounter):
    """DTensor's own bookkeeping, run outside the fake mode and uncounted:
    its sharding propagation (which evaluates each operator at the global
    shape, and computes redistribution costs with index arithmetic on
    tensors) and ``_StridedShard``'s shard sizes, which it takes from a
    ``torch.arange`` (under a fake mode its ``tolist`` would be
    data-dependent). Both are private to torch: the patches are undone on
    the way out."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    def outside(fn):
        def wrapper(*args, **kwargs):
            counter.paused += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                counter.paused -= 1
        return wrapper

    dispatcher = DTensor._op_dispatcher
    propagate = dispatcher._propagate_op_sharding_dispatch_slow_path
    shard_size = _StridedShard.local_shard_size_and_offset
    dispatcher._propagate_op_sharding_dispatch_slow_path = outside(propagate)
    _StridedShard.local_shard_size_and_offset = outside(shard_size)
    try:
        yield
    finally:
        del dispatcher._propagate_op_sharding_dispatch_slow_path
        _StridedShard.local_shard_size_and_offset = shard_size


@contextlib.contextmanager
def count(arguments=()):
    """Count the operators run inside on this rank's local tensors; yields
    the :class:`OpCounter` (``.costs``, ``.peak_bytes``)."""
    counter = OpCounter(arguments)
    with _dtensor_metadata(counter), counter:
        yield counter
