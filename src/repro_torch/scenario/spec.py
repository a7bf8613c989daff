"""The declarative Scenario spec: one object describing an experiment.

A :class:`Scenario` names everything a run needs — cluster topology and
cost model, protocol (by registry name), workload generator (by registry
ref), fault schedule, sharding/parallelism, verification flags — and
nothing about *how* to run it. ``run_scenario`` (repro_torch.scenario.build)
is the single entrypoint that lowers a Scenario onto the simulator; the
legacy ``run(RunConfig)`` / ``run_sharded(ShardedRunConfig)`` surfaces
are thin converters onto this spec.

Construction is validated (``__post_init__``): contradictions — a fault
schedule with parallel workers, an unknown protocol or workload ref, a
sharded run of an unsharded-only workload — fail fast at build time,
not 40 000 simulated ops in. ``to_dict``/``from_dict`` (and the JSON
twins) round-trip losslessly: ``Scenario.from_dict(sc.to_dict()) == sc``.

Legacy compatibility: ``from_dict`` and ``Scenario.from_run_config``
accept the deprecated ``crash_at``/``recover_at`` knobs and fold them
into the declarative fault schedule (a ``Crash``/``Recover`` event pair
targeting replica 0 — exactly the wiring ``run()`` used to hand-roll).
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional, Tuple

from repro_torch.core.simulator import CostModel, Workload
from repro_torch.faults import (Crash, Degrade, Heal, Partition, Recover,
                          resolve_node)
from repro_torch.scenario.registry import protocol_info
from repro_torch.scenario.workloads import make_workload, workload_ref

LOCALITIES = ("uniform", "mixed", "drift")

# workload kinds that only make sense on a flat (unsharded) cluster —
# the sharded equivalent is the Sharding spec's locality machinery
UNSHARDED_ONLY_WORKLOADS = ("hotspot_drift",)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Object-space partitioning + execution parallelism. ``n_groups=1``
    still runs the sharded machinery (gates, router clients) — the G=1
    equivalence tests pin it bit-identical to the flat path. ``workers``:
    1 = serial single-heap oracle, >=2 = per-group parallel engines,
    0 = auto (min(groups, cores); resolves to serial when faults are
    scheduled)."""

    n_groups: int = 2
    locality: str = "uniform"
    p_local: float = 0.9
    working_set: int = 16
    p_working: float = 0.85
    drift_every: int = 400
    steal_threshold: int = 3           # remote hits per hint; <=0 disables
    steal_cooldown: float = 0.25
    workers: int = 1


@dataclasses.dataclass(frozen=True)
class Observability:
    """Deterministic op-level tracing (repro_torch.obs). ``trace`` enables the
    host-side span recorder — simulated timing is bit-identical with it
    on or off, and same-seed runs export byte-identical traces.
    ``sample_every=k`` keeps every k-th op's span (deterministic hash of
    the op id; authoritative commit stamps are always recorded, so
    path-mix metrics stay exact under sampling). ``export`` names a file
    to write the canonical trace to after the run, in ``export_format``:
    "chrome" (Perfetto-loadable ``trace_event`` JSON) or "jsonl"."""

    trace: bool = False
    sample_every: int = 1
    export: Optional[str] = None
    export_format: str = "chrome"


@dataclasses.dataclass(frozen=True)
class Leases:
    """Linearizable local reads via weighted object leases
    (repro_torch.core.leases). Default-off: with ``Scenario.leases=None`` the
    lease subsystem is never constructed and runs are bit-identical to
    pre-lease builds. ``duration_s`` is the lease window (holders stop
    serving at expiry by their own clock; writers on leased objects wait
    out revocation acks or the window). ``renew_margin`` is the fraction
    of the window left when a serving replica starts renewing.
    ``grant_after_reads`` is how many local read misses an object needs
    at one replica before it starts a grant round — 1 leases eagerly,
    higher values keep cold objects lease-free."""

    enabled: bool = True
    duration_s: float = 0.05
    renew_margin: float = 0.5
    grant_after_reads: int = 2


@dataclasses.dataclass(frozen=True)
class Reassign:
    """Self-healing weighted quorums: online weight reassignment under
    churn (repro_torch.core.reassign). Default-off: with
    ``Scenario.reassign=None`` the subsystem is never constructed, and
    even with the knob on, fault-free runs are bit-identical to
    knob-off runs (the monitor piggybacks on heartbeats and sends
    nothing without confirmed fault evidence).

    ``ema_ratio`` flags a peer whose latency EMA exceeds that multiple
    of the peer median; ``stale_after_s`` flags heartbeat staleness.
    ``confirm_ticks`` heartbeat ticks of consecutive evidence confirm a
    suspicion (hysteresis). ``min_reports`` reporters (0 = deployment
    count-majority, leader included) let the leader install a demoting
    weight view; installs back off exponentially from ``backoff_s`` up
    to ``backoff_max_s`` (anti-flap). ``epoch_fence=False`` disables
    the slow-path-anchored install fence — only the mutation-twin test
    should ever do that."""

    enabled: bool = True
    ema_ratio: float = 2.5
    stale_after_s: float = 0.045
    confirm_ticks: int = 3
    min_reports: int = 0
    report_interval_s: float = 0.02
    report_ttl_s: float = 0.12
    backoff_s: float = 0.05
    backoff_max_s: float = 0.4
    epoch_fence: bool = True


@dataclasses.dataclass(frozen=True)
class Coding:
    """Adaptive payload striping: Crossword-style erasure coding
    (repro_torch.coding). Default-off: with ``Scenario.coding=None`` no
    CodingManager is constructed and runs are bit-identical to
    pre-coding builds. Even with the knob on, writes below
    ``stripe_min_bytes`` (and every op of a sizeless workload, where
    ``op.size == 0``) ship as classic full copies.

    ``stripe_min_bytes`` is the ``op.size`` floor at which the
    coordinator considers an RS (k, m) stripe instead of a full copy;
    ``parity`` is m, the number of parity shards per stripe (the
    number of shard losses a committed stripe survives beyond the
    weighted-reconstructable commit gate's margin)."""

    enabled: bool = True
    stripe_min_bytes: int = 4096
    parity: int = 1


@dataclasses.dataclass(frozen=True)
class Verification:
    """Post-run checking. ``capture_history`` records the client
    invoke/response history on the result (implied by any fault
    schedule); ``check_linearizable`` additionally runs the
    repro_torch.verify history checker after the run and raises on violation
    (requires a protocol whose read path is verified when the workload
    issues reads — validated at construction)."""

    capture_history: bool = False
    check_linearizable: bool = False


@dataclasses.dataclass(frozen=True)
class Scenario:
    protocol: str = "woc"
    n_replicas: int = 5                # per group when sharded
    n_clients: int = 2                 # per group when sharded
    t_fail: int = 1
    batch_size: int = 10
    max_inflight: int = 5              # paper §5.1 open-loop cap
    total_ops: int = 40_000            # across all clients (all groups)
    seed: int = 0
    sim_time_cap: float = 300.0
    workload: object = dataclasses.field(default_factory=Workload)
    costs: CostModel = dataclasses.field(default_factory=CostModel)
    faults: Tuple = ()
    sharding: Optional[Sharding] = None
    verify: Verification = dataclasses.field(default_factory=Verification)
    obs: Optional[Observability] = None
    leases: Optional[Leases] = None
    reassign: Optional[Reassign] = None
    coding: Optional[Coding] = None

    # -- validation (fail fast at construction) -----------------------------

    def __post_init__(self):
        info = _value_error(lambda: protocol_info(self.protocol))
        for name, lo in (("n_replicas", 1), ("n_clients", 1),
                         ("t_fail", 1), ("batch_size", 1),
                         ("max_inflight", 1), ("total_ops", 1)):
            v = getattr(self, name)
            if not isinstance(v, int) or v < lo:
                raise ValueError(f"{name} must be an int >= {lo}, "
                                 f"got {v!r}")
        if not self.sim_time_cap > 0:
            raise ValueError(f"sim_time_cap must be > 0, "
                             f"got {self.sim_time_cap!r}")
        wl = self.workload
        if not (callable(getattr(wl, "sample_object", None))
                and callable(getattr(wl, "sample_kind", None))):
            raise ValueError(
                f"workload {wl!r} does not satisfy the generator contract "
                f"(sample_object/sample_kind; see repro_torch.scenario.workloads)")
        self._validate_faults()
        sh = self.sharding
        if sh is not None:
            if not isinstance(sh, Sharding):
                raise ValueError(f"sharding must be a Sharding spec, "
                                 f"got {sh!r}")
            if sh.n_groups < 1:
                raise ValueError(f"n_groups must be >= 1, "
                                 f"got {sh.n_groups}")
            if sh.locality not in LOCALITIES:
                raise ValueError(f"unknown locality {sh.locality!r} "
                                 f"(expected one of {LOCALITIES})")
            if not info.supports_sharding:
                raise ValueError(
                    f"protocol {self.protocol!r} does not support "
                    f"sharding (registry capability supports_sharding="
                    f"False)")
            from repro_torch.scenario.workloads import workload_kind_of
            try:
                kind = workload_kind_of(wl)
            except ValueError:
                kind = None
            if kind in UNSHARDED_ONLY_WORKLOADS:
                raise ValueError(
                    f"workload {kind!r} is unsharded-only; sharded runs "
                    f"express drift via Sharding(locality='drift')")
            if self.faults and sh.workers > 1:
                raise ValueError(
                    "faults require serial execution (workers=1): the "
                    "conservative window lookahead does not yet model "
                    "partitions, so parallel sharded runs cannot replay "
                    "a fault schedule deterministically")
            if self.verify.capture_history and sh.workers > 1:
                raise ValueError(
                    "history capture requires serial execution "
                    "(workers=1): the parallel engine does not capture "
                    "client histories; use workers=1 (or 0, which "
                    "resolves to serial when capture is requested)")
        ob = self.obs
        if ob is not None:
            if not isinstance(ob, Observability):
                raise ValueError(f"obs must be an Observability spec, "
                                 f"got {ob!r}")
            if not isinstance(ob.sample_every, int) or ob.sample_every < 1:
                raise ValueError(f"obs.sample_every must be an int >= 1, "
                                 f"got {ob.sample_every!r}")
            from repro_torch.obs.export import EXPORT_FORMATS
            if ob.export_format not in EXPORT_FORMATS:
                raise ValueError(
                    f"unknown obs.export_format {ob.export_format!r} "
                    f"(expected one of {EXPORT_FORMATS})")
            if ob.export and not ob.trace:
                raise ValueError("obs.export requires obs.trace=True")
        ls = self.leases
        if ls is not None:
            if not isinstance(ls, Leases):
                raise ValueError(f"leases must be a Leases spec, "
                                 f"got {ls!r}")
            if ls.enabled:
                if not info.lease_reads:
                    raise ValueError(
                        f"protocol {self.protocol!r} does not support "
                        f"read leases (registry capability "
                        f"lease_reads=False)")
                if not ls.duration_s > 0:
                    raise ValueError(f"leases.duration_s must be > 0, "
                                     f"got {ls.duration_s!r}")
                if not 0.0 < ls.renew_margin < 1.0:
                    raise ValueError(
                        f"leases.renew_margin must be in (0, 1), "
                        f"got {ls.renew_margin!r}")
                if (not isinstance(ls.grant_after_reads, int)
                        or ls.grant_after_reads < 1):
                    raise ValueError(
                        f"leases.grant_after_reads must be an int >= 1, "
                        f"got {ls.grant_after_reads!r}")
                if sh is not None and sh.workers > 1:
                    raise ValueError(
                        "leases require serial execution (workers=1): "
                        "revocation and shard fencing cross group "
                        "boundaries, which the conservative window "
                        "lookahead does not model")
        ra = self.reassign
        if ra is not None:
            if not isinstance(ra, Reassign):
                raise ValueError(f"reassign must be a Reassign spec, "
                                 f"got {ra!r}")
            if ra.enabled:
                if not info.reassign:
                    raise ValueError(
                        f"protocol {self.protocol!r} does not support "
                        f"weight reassignment (registry capability "
                        f"reassign=False)")
                if not ra.ema_ratio > 1.0:
                    raise ValueError(
                        f"reassign.ema_ratio must be > 1, "
                        f"got {ra.ema_ratio!r}")
                if not ra.stale_after_s > 0:
                    raise ValueError(
                        f"reassign.stale_after_s must be > 0, "
                        f"got {ra.stale_after_s!r}")
                if not isinstance(ra.confirm_ticks, int) \
                        or ra.confirm_ticks < 1:
                    raise ValueError(
                        f"reassign.confirm_ticks must be an int >= 1, "
                        f"got {ra.confirm_ticks!r}")
                if not isinstance(ra.min_reports, int) \
                        or ra.min_reports < 0:
                    raise ValueError(
                        f"reassign.min_reports must be an int >= 0, "
                        f"got {ra.min_reports!r}")
                if not (ra.backoff_s > 0
                        and ra.backoff_max_s >= ra.backoff_s):
                    raise ValueError(
                        f"reassign backoff must satisfy 0 < backoff_s "
                        f"<= backoff_max_s, got {ra.backoff_s!r}/"
                        f"{ra.backoff_max_s!r}")
                if sh is not None and sh.workers > 1:
                    raise ValueError(
                        "reassign requires serial execution (workers=1):"
                        " weight-view installs cross group boundaries, "
                        "which the conservative window lookahead does "
                        "not model")
        cd = self.coding
        if cd is not None:
            if not isinstance(cd, Coding):
                raise ValueError(f"coding must be a Coding spec, "
                                 f"got {cd!r}")
            if cd.enabled:
                if not info.coding:
                    raise ValueError(
                        f"protocol {self.protocol!r} does not support "
                        f"payload striping (registry capability "
                        f"coding=False)")
                if (not isinstance(cd.stripe_min_bytes, int)
                        or cd.stripe_min_bytes < 1):
                    raise ValueError(
                        f"coding.stripe_min_bytes must be an int >= 1, "
                        f"got {cd.stripe_min_bytes!r}")
                if not isinstance(cd.parity, int) or cd.parity < 1:
                    raise ValueError(
                        f"coding.parity must be an int >= 1, "
                        f"got {cd.parity!r}")
                if sh is not None and sh.workers > 1:
                    raise ValueError(
                        "coding requires serial execution (workers=1): "
                        "shard repair fetches and stripe pushes cross "
                        "group boundaries via stolen objects, which the "
                        "conservative window lookahead does not model")
        if (self.verify.check_linearizable
                and not (self.verify.capture_history or self.faults)):
            raise ValueError(
                "check_linearizable needs a captured history: set "
                "Verification.capture_history (or schedule faults, "
                "which imply capture)")
        if (self.verify.check_linearizable
                and getattr(wl, "reads_fraction", 0.0) > 0.0
                and info.reads != "linearizable"):
            raise ValueError(
                f"protocol {self.protocol!r} has an unverified read path "
                f"(registry reads={info.reads!r}); use a write-only "
                f"workload or drop check_linearizable")

    def _validate_faults(self) -> None:
        # node refs must resolve inside the replica id space: the whole
        # cluster for explicit ids, the group-0 block for symbolic names
        # (matching compile_schedule's sharded resolution)
        sh = self.sharding
        n_total = self.n_replicas * (sh.n_groups if sh else 1)
        for ev in self.faults:
            if not isinstance(ev, (Crash, Recover, Partition, Heal,
                                   Degrade)):
                raise ValueError(f"not a fault event: {ev!r}")
            refs = ev.side if isinstance(ev, Partition) else \
                (ev.node,) if hasattr(ev, "node") else ()
            for ref in refs:
                _value_error(lambda ref=ref: resolve_node(
                    ref, self.n_replicas if isinstance(ref, str)
                    else n_total))

    # -- dict / JSON round-trip ----------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "protocol": self.protocol,
            "n_replicas": self.n_replicas,
            "n_clients": self.n_clients,
            "t_fail": self.t_fail,
            "batch_size": self.batch_size,
            "max_inflight": self.max_inflight,
            "total_ops": self.total_ops,
            "seed": self.seed,
            "sim_time_cap": self.sim_time_cap,
            "workload": workload_ref(self.workload),
            "costs": dataclasses.asdict(self.costs),
            "faults": [fault_to_dict(ev) for ev in self.faults],
            "sharding": (dataclasses.asdict(self.sharding)
                         if self.sharding is not None else None),
            "verify": dataclasses.asdict(self.verify),
            "obs": (dataclasses.asdict(self.obs)
                    if self.obs is not None else None),
            "leases": (dataclasses.asdict(self.leases)
                       if self.leases is not None else None),
            "reassign": (dataclasses.asdict(self.reassign)
                         if self.reassign is not None else None),
            "coding": (dataclasses.asdict(self.coding)
                       if self.coding is not None else None),
        }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        faults = tuple(fault_from_dict(ev) if isinstance(ev, dict) else ev
                       for ev in d.pop("faults", ()))
        crash_at = d.pop("crash_at", None)
        recover_at = d.pop("recover_at", None)
        faults = _legacy_crash_faults(crash_at, recover_at) + faults
        wl = d.pop("workload", None)
        costs = d.pop("costs", None)
        sharding = d.pop("sharding", None)
        verify = d.pop("verify", None)
        obs = d.pop("obs", None)
        leases = d.pop("leases", None)
        reassign = d.pop("reassign", None)
        coding = d.pop("coding", None)
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown Scenario fields {sorted(bad)}")
        return cls(
            workload=make_workload(wl) if wl is not None else Workload(),
            costs=(costs if isinstance(costs, CostModel)
                   else _cost_model_from_dict(costs) if costs is not None
                   else CostModel()),
            faults=faults,
            sharding=(sharding if isinstance(sharding, (Sharding,
                                                        type(None)))
                      else Sharding(**sharding)),
            verify=(verify if isinstance(verify, Verification)
                    else Verification(**verify) if verify is not None
                    else Verification()),
            obs=(obs if isinstance(obs, (Observability, type(None)))
                 else Observability(**obs)),
            leases=(leases if isinstance(leases, (Leases, type(None)))
                    else Leases(**leases)),
            reassign=(reassign if isinstance(reassign, (Reassign,
                                                        type(None)))
                      else Reassign(**reassign)),
            coding=(coding if isinstance(coding, (Coding, type(None)))
                    else Coding(**coding)),
            **d)

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        return cls.from_dict(json.loads(text))

    # -- legacy config conversion --------------------------------------------

    @classmethod
    def from_run_config(cls, cfg) -> "Scenario":
        """Lower a legacy ``RunConfig`` onto the Scenario spec (the
        ``run()`` compatibility path). ``crash_at``/``recover_at`` fold
        into the declarative fault schedule."""
        faults = _legacy_crash_faults(cfg.crash_at, cfg.recover_at) \
            + tuple(cfg.faults)
        return cls(
            protocol=cfg.protocol, n_replicas=cfg.n_replicas,
            n_clients=cfg.n_clients, t_fail=cfg.t_fail,
            batch_size=cfg.batch_size, max_inflight=cfg.max_inflight,
            total_ops=cfg.total_ops, seed=cfg.seed,
            sim_time_cap=cfg.sim_time_cap, workload=cfg.workload,
            costs=cfg.costs, faults=faults,
            verify=Verification(capture_history=cfg.capture_history))

    @classmethod
    def from_sharded_config(cls, cfg) -> "Scenario":
        """Lower a legacy ``ShardedRunConfig`` onto the Scenario spec
        (the ``run_sharded()`` compatibility path)."""
        return cls(
            protocol=cfg.protocol, n_replicas=cfg.n_replicas_per_group,
            n_clients=cfg.n_clients_per_group, t_fail=cfg.t_fail,
            batch_size=cfg.batch_size, max_inflight=cfg.max_inflight,
            total_ops=cfg.total_ops, seed=cfg.seed,
            sim_time_cap=cfg.sim_time_cap, workload=cfg.workload,
            costs=cfg.costs, faults=tuple(cfg.faults),
            sharding=Sharding(
                n_groups=cfg.n_groups, locality=cfg.locality,
                p_local=cfg.p_local, working_set=cfg.working_set,
                p_working=cfg.p_working, drift_every=cfg.drift_every,
                steal_threshold=cfg.steal_threshold,
                steal_cooldown=cfg.steal_cooldown, workers=cfg.workers),
            verify=Verification(capture_history=cfg.capture_history),
            obs=cfg.obs)


# ---------------------------------------------------------------------------
# Fault event / cost model serialization
# ---------------------------------------------------------------------------

_FAULT_TYPES = {"crash": Crash, "recover": Recover, "partition": Partition,
                "heal": Heal, "degrade": Degrade}
_FAULT_NAMES = {cls: name for name, cls in _FAULT_TYPES.items()}


def fault_to_dict(ev) -> dict:
    name = _FAULT_NAMES.get(type(ev))
    if name is None:
        raise ValueError(f"not a serializable fault event: {ev!r}")
    d = {"type": name}
    d.update(dataclasses.asdict(ev))
    if "side" in d:
        d["side"] = list(d["side"])
    return d


def fault_from_dict(d: dict):
    d = dict(d)
    name = d.pop("type", None)
    cls = _FAULT_TYPES.get(name)
    if cls is None:
        raise ValueError(f"unknown fault event type {name!r} "
                         f"(expected one of {sorted(_FAULT_TYPES)})")
    if "side" in d:
        d["side"] = tuple(d["side"])
    return cls(**d)


def _cost_model_from_dict(d: dict) -> CostModel:
    d = dict(d)
    for k in ("speeds", "net_dist", "link_bw"):
        if k in d:
            d[k] = tuple(d[k])
    return CostModel(**d)


def _legacy_crash_faults(crash_at, recover_at) -> Tuple:
    if crash_at is None and recover_at is None:
        return ()
    warnings.warn(
        "crash_at/recover_at are deprecated: express failures as "
        "declarative fault events (repro_torch.faults.Crash/Recover) on "
        "Scenario.faults / RunConfig.faults",
        DeprecationWarning, stacklevel=3)
    events: Tuple = ()
    if crash_at is not None:
        events += (Crash(crash_at, 0),)
    if recover_at is not None:
        events += (Recover(recover_at, 0),)
    return events


def _value_error(fn):
    """Normalize registry KeyErrors into ValueError for validation."""
    try:
        return fn()
    except KeyError as exc:
        raise ValueError(exc.args[0]) from None
