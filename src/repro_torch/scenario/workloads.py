"""Workload generators + registry (the object/operation side of a Scenario).

A workload generator is anything satisfying the contract the open-loop
:class:`repro_torch.core.simulator.Client` drives:

  * ``sample_object(client, rng) -> int`` — the object id an op targets
    (namespaces: private per-client ``client << 24 | u20``, shared common
    ``1<<60 | idx``, shared hot ``1<<61 | idx`` — the shard router keys
    its locality/steal behaviour off the shared-namespace markers);
  * ``sample_kind(client, rng) -> str`` — ``"r"`` or ``"w"``; the default
    draws ``rng.random() < reads_fraction`` (one rng draw per op, always
    consumed, so sweeping the fraction never re-keys the object stream);
  * optionally ``submit_gap(client, n_submitted, rng) -> float`` —
    seconds the client idles before submitting batch ``n_submitted``
    (open-loop arrival shaping; absent or 0.0 means submit the moment a
    flow-control slot frees, the classic paper behaviour).

The paper's 90/5/5 mix is :class:`repro_torch.core.simulator.Workload`
(registered here as ``paper_mix``); its rng draw sequence is contractual
(tests/test_scenario.py pins the default Scenario bit-for-bit against the
pre-Scenario runner). New generators register with
:func:`register_workload` and become addressable from Scenario dicts /
JSON as ``{"kind": "<name>", ...params}``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Type

import numpy as np

from repro_torch.core.simulator import Workload

SHARED_COMMON_BASE = 1 << 60
SHARED_HOT_BASE = 1 << 61


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type] = {}
_KIND_OF: Dict[Type, str] = {}


def register_workload(kind: str, cls: Type) -> Type:
    """Register a workload generator class under a Scenario ref name."""
    _REGISTRY[kind] = cls
    _KIND_OF[cls] = kind
    return cls


def workload_kinds() -> list:
    return sorted(_REGISTRY)


def workload_kind_of(workload) -> str:
    try:
        return _KIND_OF[type(workload)]
    except KeyError:
        raise ValueError(
            f"workload {type(workload).__name__} is not registered "
            f"(known kinds: {workload_kinds()}); register it with "
            f"repro_torch.scenario.register_workload") from None


def workload_ref(workload) -> dict:
    """Serialize a generator to its declarative ref
    (``{"kind": ..., **params}``); nested generators recurse."""
    ref = {"kind": workload_kind_of(workload)}
    for f in dataclasses.fields(workload):
        if f.name.startswith("_"):
            continue                      # runtime state, not spec
        v = getattr(workload, f.name)
        ref[f.name] = workload_ref(v) if type(v) in _KIND_OF else v
    return ref


def make_workload(ref) -> object:
    """Resolve a declarative ref (or pass through a live generator)."""
    if not isinstance(ref, dict):
        if not callable(getattr(ref, "sample_object", None)):
            raise ValueError(
                f"not a workload generator: {ref!r} (needs "
                f"sample_object(client, rng))")
        return ref
    params = dict(ref)
    kind = params.pop("kind", None)
    if kind not in _REGISTRY:
        raise ValueError(f"unknown workload kind {kind!r} "
                         f"(known: {workload_kinds()})")
    cls = _REGISTRY[kind]
    # private fields are runtime state, never spec: a hand-edited ref
    # must not be able to inject them
    names = {f.name for f in dataclasses.fields(cls)
             if not f.name.startswith("_")}
    bad = set(params) - names
    if bad:
        raise ValueError(f"workload {kind!r} has no parameters {sorted(bad)}"
                         f" (accepts {sorted(n for n in names if not n.startswith('_'))})")
    for k, v in params.items():
        if isinstance(v, dict) and "kind" in v:
            params[k] = make_workload(v)
    return cls(**params)


# ---------------------------------------------------------------------------
# Generators beyond the paper mix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZipfWorkload:
    """Zipf-skewed draws over a shared object space: a *continuous*
    contention axis. ``theta=0`` is uniform over ``n_objects`` (near-zero
    conflict for large spaces); raising ``theta`` concentrates mass on
    the head of the distribution until a handful of objects carry most
    ops (the full-contention regime). ``p_private`` mixes in
    private-namespace draws (guaranteed conflict-free), letting a sweep
    pin the independent fraction exactly.
    """

    n_objects: int = 512
    theta: float = 0.9
    p_private: float = 0.0
    reads_fraction: float = 0.0

    @functools.cached_property
    def _cdf(self) -> np.ndarray:
        ranks = np.arange(1, self.n_objects + 1, dtype=np.float64)
        w = ranks ** -self.theta
        return np.cumsum(w / w.sum())

    def probabilities(self) -> np.ndarray:
        """Per-object draw probabilities, head first (analysis helper)."""
        cdf = self._cdf
        return np.diff(cdf, prepend=0.0) * (1.0 - self.p_private)

    def independence_index(self) -> float:
        """P(two independent shared draws differ) scaled by the private
        mass: an exact, closed-form 'fraction of independent work' for
        this generator — the continuous analog of the paper's >70%
        independent-objects knob."""
        p = np.diff(self._cdf, prepend=0.0)
        shared = 1.0 - self.p_private
        return float(1.0 - shared * shared * np.sum(p * p))

    def sample_object(self, client: int, rng: np.random.Generator) -> int:
        if self.p_private and rng.random() < self.p_private:
            return (client << 24) | int(rng.random() * (1 << 20))
        idx = int(np.searchsorted(self._cdf, rng.random(), side="right"))
        return SHARED_HOT_BASE | min(idx, self.n_objects - 1)

    def sample_kind(self, client: int, rng: np.random.Generator) -> str:
        return "r" if rng.random() < self.reads_fraction else "w"


@dataclasses.dataclass
class HotspotDriftWorkload:
    """Drifting shared hotspot for *unsharded* runs (the flat-cluster
    analog of the sharded ``drift`` locality mode): with probability
    ``p_hot`` an op hits the current epoch's working set of ``n_hot``
    shared objects, otherwise a private independent object. The working
    set is a pure function of the epoch number (``seed ^ epoch`` keys a
    dedicated rng), and each client advances epochs on its own draw
    count — clients drift in near-lockstep without any cross-client
    coordination, so sampling stays deterministic per client regardless
    of event interleaving. Scenario validation rejects this generator in
    sharded runs — use the Sharding spec's locality modes there."""

    n_hot: int = 8
    p_hot: float = 0.5
    drift_every: int = 2_000            # draws per client per epoch
    pool: int = 1 << 16                 # shared ids the hotspot draws from
    seed: int = 0
    reads_fraction: float = 0.0
    _counts: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)
    _wsets: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def reset(self) -> None:
        """Drop per-run draw state (run_scenario calls this at run start
        so identical Scenarios replay identical streams)."""
        self._counts.clear()
        self._wsets.clear()

    def _wset(self, epoch: int) -> np.ndarray:
        ws = self._wsets.get(epoch)
        if ws is None:
            rng = np.random.default_rng((self.seed << 32) ^ (epoch + 1))
            ws = rng.choice(self.pool, size=min(self.n_hot, self.pool),
                            replace=False)
            self._wsets[epoch] = ws
            self._wsets.pop(epoch - 2, None)   # bounded cache
        return ws

    def sample_object(self, client: int, rng: np.random.Generator) -> int:
        cnt = self._counts.get(client, 0)
        self._counts[client] = cnt + 1
        if rng.random() < self.p_hot:
            ws = self._wset(cnt // max(1, self.drift_every))
            return SHARED_HOT_BASE | int(ws[int(rng.random() * len(ws))])
        return (client << 24) | int(rng.random() * (1 << 20))

    def sample_kind(self, client: int, rng: np.random.Generator) -> str:
        return "r" if rng.random() < self.reads_fraction else "w"


@dataclasses.dataclass(frozen=True)
class BurstyWorkload:
    """Open-loop arrival shaping around any base mix: the client submits
    ``burst_batches`` batches back-to-back (flow control permitting),
    then idles ``gap_s`` of simulated time before the next burst. The
    gap schedule is deterministic (no rng draw), so wrapping a base
    workload never re-keys its object/kind streams — a bursty run and a
    steady run draw identical ops, only arrival times differ."""

    base: Workload = dataclasses.field(default_factory=Workload)
    burst_batches: int = 16
    gap_s: float = 0.01

    @property
    def reads_fraction(self) -> float:
        return self.base.reads_fraction

    def reset(self) -> None:
        base_reset = getattr(self.base, "reset", None)
        if base_reset is not None:
            base_reset()

    def sample_object(self, client: int, rng: np.random.Generator) -> int:
        return self.base.sample_object(client, rng)

    def sample_kind(self, client: int, rng: np.random.Generator) -> str:
        return self.base.sample_kind(client, rng)

    def submit_gap(self, client: int, n_submitted: int,
                   rng: np.random.Generator) -> float:
        if n_submitted and n_submitted % max(1, self.burst_batches) == 0:
            return self.gap_s
        return 0.0


@dataclasses.dataclass(frozen=True)
class ValueSizesWorkload:
    """Value-size axis around any base mix (the data-heavy workload
    knob, repro_torch.coding): ``sample_object``/``sample_kind`` delegate to
    the base untouched, and every generated op additionally draws a
    payload size. Distributions:

      * ``"fixed"``     — ``size_small`` always;
      * ``"bimodal"``   — ``size_large`` with probability ``p_large``,
                          else ``size_small`` (the hot-photo / cold-blob
                          mix Crossword evaluates);
      * ``"lognormal"`` — ``size_small``-median heavy tail with shape
                          ``size_sigma``.

    The size draw consumes rng draws *after* the base's object/kind
    draws, so wrapping a base never re-keys its op stream — but sized
    runs are a different draw sequence than sizeless ones by design
    (the size IS part of the workload)."""

    base: Workload = dataclasses.field(default_factory=Workload)
    size_dist: str = "bimodal"
    size_small: int = 256
    size_large: int = 1 << 20
    p_large: float = 0.1
    size_sigma: float = 1.5

    def __post_init__(self):
        if self.size_dist not in ("fixed", "bimodal", "lognormal"):
            raise ValueError(f"unknown size_dist {self.size_dist!r} "
                             "(want 'fixed', 'bimodal' or 'lognormal')")

    @property
    def reads_fraction(self) -> float:
        return getattr(self.base, "reads_fraction", 0.0)

    @property
    def sizes_on(self) -> bool:
        return True

    def reset(self) -> None:
        base_reset = getattr(self.base, "reset", None)
        if base_reset is not None:
            base_reset()

    def sample_object(self, client: int, rng: np.random.Generator) -> int:
        return self.base.sample_object(client, rng)

    def sample_kind(self, client: int, rng: np.random.Generator) -> str:
        return self.base.sample_kind(client, rng)

    def sample_size(self, client: int, rng: np.random.Generator) -> int:
        d = self.size_dist
        if d == "bimodal":
            return (self.size_large if rng.random() < self.p_large
                    else self.size_small)
        if d == "lognormal":
            return max(1, int(self.size_small
                              * rng.lognormal(0.0, self.size_sigma)))
        return self.size_small          # "fixed"


register_workload("paper_mix", Workload)
register_workload("zipf", ZipfWorkload)
register_workload("hotspot_drift", HotspotDriftWorkload)
register_workload("bursty", BurstyWorkload)
register_workload("value_sizes", ValueSizesWorkload)
