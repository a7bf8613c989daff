"""Rule-based sharding: logical roles -> concrete mesh axes (port of
``repro.launch.shardings``).

``Rules`` resolves each tensor dimension to a mesh axis only when the size
divides evenly (e.g. granite-moe's 40 experts do not split over a 16-way
tp axis -> replicated; a decode batch of 1 does not split over dp).

Roles:
  * dp    — batch-parallel axes: ("data",) single-pod, ("pod","data")
            multi-pod (the pod axis is DP-over-pods by default).
  * tp    — tensor-parallel axis ("model"): attention heads, ffn hidden,
            experts (EP), vocab, and the *sequence* axis of decode KV
            caches (flash-decoding).
  * fsdp  — ZeRO-3 parameter sharding over the dp axes: the non-tp dim of
            every large matrix; gathered where a layer uses it.

A spec is a :class:`PartitionSpec` (a tuple, as JAX's ``P`` is) with one
entry per tensor dimension: a mesh axis name, a tuple of names, ``None``
(replicated) or a role placeholder (``"DP"``, ``"TP"``). :func:`placements`
turns a resolved spec into DTensor placements on a torch ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union


class PartitionSpec(tuple):
    """One mesh-axis entry per tensor dimension; trailing dimensions left
    out are replicated. ``PartitionSpec("data", None) == P("data", None)``
    entry for entry, as JAX's ``PartitionSpec`` compares."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    axis_sizes: dict                 # mesh axis name -> size
    dp_axes: Tuple[str, ...]         # e.g. ("pod", "data")
    tp_axis: Optional[str] = "model"
    fsdp_on: bool = True

    # ---- role attributes used in activation constraints ---------------------

    @property
    def dp(self) -> Union[Tuple[str, ...], str, None]:
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def tp(self) -> Optional[str]:
        return self.tp_axis

    # ---- divisibility-aware resolution for parameter dims -------------------

    def _size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    def tp_for(self, dim: int):
        if self.tp_axis and dim % self._size(self.tp_axis) == 0:
            return self.tp_axis
        return None

    def fsdp_for(self, dim: int):
        if not self.fsdp_on:
            return None
        if dim % self._size(self.dp_axes) == 0:
            return self.dp if len(self.dp_axes) > 1 else self.dp_axes[0]
        # try the inner dp axis alone (e.g. multi-pod where pod*data doesn't
        # divide but data does)
        if len(self.dp_axes) > 1 and dim % self._size(self.dp_axes[-1]) == 0:
            return self.dp_axes[-1]
        return None

    def dp_for(self, dim: int):
        if dim % self._size(self.dp_axes) == 0:
            return self.dp
        if len(self.dp_axes) > 1 and dim % self._size(self.dp_axes[-1]) == 0:
            return self.dp_axes[-1]
        return None


def make_rules(mesh, *, fsdp: bool = True) -> Rules:
    """The rules of a torch ``DeviceMesh`` with named dimensions."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    tp = "model" if "model" in sizes else None
    return Rules(axis_sizes=sizes, dp_axes=dp_axes or ("data",),
                 tp_axis=tp, fsdp_on=fsdp)


ROLE_DP = "DP"
ROLE_TP = "TP"


def resolve_spec(shape, spec: P, rules: Rules) -> P:
    """Map role placeholders (DP/TP) to concrete mesh axes and drop axes
    that don't divide the corresponding dim."""
    out = []
    for i, entry in enumerate(spec):
        if entry == ROLE_DP:
            entry = rules.dp
        elif entry == ROLE_TP:
            entry = rules.tp_axis
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        k = math.prod(rules.axis_sizes.get(a, 1) for a in axes)
        out.append(entry if shape[i] % k == 0 else None)
    out += [None] * (len(shape) - len(out))
    return P(*out)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements on ``mesh`` of a resolved ``spec``: ``Shard(i)`` on
    each mesh dimension that tensor dim ``i`` is split over (a tuple of axes
    shards that dim over each of them, in order) and ``Replicate()`` on every
    other mesh dimension. An axis that ``mesh`` lacks is left out."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis in names:
                if out[names.index(axis)] != Replicate():
                    raise ValueError(f"placements: mesh axis {axis!r} used "
                                     f"twice in {spec}")
                out[names.index(axis)] = Shard(i)
    return tuple(out)
