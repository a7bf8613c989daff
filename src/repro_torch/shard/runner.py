"""Sharded experiment runner: G independent WOC groups, serial or parallel.

``run_sharded_config`` builds ``n_groups`` consensus groups (each an
unmodified protocol cluster behind a shard gate) over a hash-partitioned
object space, homes ``n_clients_per_group`` router clients at each
group, and drives the whole deployment deterministically. It is the
execution half of the Scenario API's sharded path; ``run_sharded`` is
the legacy surface, now a thin converter through
``repro_torch.scenario.Scenario`` (which is where validation lives). With ``n_groups=1`` it
reduces to :func:`repro_torch.core.runner.run` (same cost model, same id
layout, no redirects or migrations) — the G=1 equivalence tests pin that.

Execution modes (``ShardedRunConfig.workers``):

  * ``1`` — the single-heap serial engine: every group's events share one
    :class:`Simulation`. This is the oracle.
  * ``>= 2`` — conservative parallel discrete-event simulation
    (:mod:`repro_torch.shard.parallel`): one :class:`EventEngine` per group,
    spread over worker processes, synchronized by time windows of the
    minimum cross-group link latency. Produces **bit-identical**
    ShardedRunResult metrics to the serial engine (pinned by
    tests/test_parallel.py) — see parallel.py for why.
  * ``0`` — auto: ``min(n_groups, cpu_count)``.

The builder helpers (:func:`make_gate`, :func:`build_group`,
:func:`build_client`) and the metric assembler (:func:`assemble_result`)
are shared verbatim by both modes, so the only thing that can differ
between them is event *scheduling* — which the per-link jitter sequence
makes irrelevant to timing (see repro_torch.core.simulator module notes).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.simulator import CostModel, Simulation, Workload
from repro_torch.scenario.registry import protocol_class
from repro_torch.shard.gate import GroupGate, make_sharded_replica
from repro_torch.shard.groupview import GroupNodeProxy, GroupView
from repro_torch.shard.router import ShardClient, ShardWorkload


@dataclasses.dataclass
class ShardedRunConfig:
    protocol: str = "woc"
    n_groups: int = 2
    n_replicas_per_group: int = 5
    n_clients_per_group: int = 2
    batch_size: int = 10
    max_inflight: int = 5
    total_ops: int = 40_000            # across all clients, all groups
    t_fail: int = 1
    locality: str = "uniform"          # "uniform" | "mixed" | "drift"
    p_local: float = 0.9
    working_set: int = 16
    p_working: float = 0.85
    drift_every: int = 400
    steal_threshold: int = 3           # remote hits per hint; <=0 disables
    steal_cooldown: float = 0.25
    workload: Workload = dataclasses.field(default_factory=Workload)
    costs: CostModel = dataclasses.field(default_factory=CostModel)
    seed: int = 0
    sim_time_cap: float = 300.0
    # 1 = serial single-heap oracle; >=2 = parallel per-group engines over
    # that many worker processes; 0 = auto (min(n_groups, cpu_count))
    workers: int = 1
    # declarative fault schedule (repro_torch.faults): serial-only for now —
    # conservative window lookahead does not yet model partitions, so
    # explicit workers>1 with faults fails fast and workers=0 resolves
    # to serial. Symbolic node selectors resolve inside group 0's block.
    faults: Sequence = ()
    capture_history: bool = False
    # Observability spec (repro_torch.scenario.spec.Observability) or None;
    # duck-typed here (.trace/.sample_every) to keep the carrier free of
    # a scenario import. Tracing works in both serial and parallel modes
    # (workers merge their per-engine traces through canonical_events).
    obs: object = None
    # lowered lease knob (repro_torch.core.leases.LeaseConfig) or None. Scenario
    # validation restricts leases to workers=1, so the parallel engines
    # never see it.
    leases: object = None
    # lowered weight-reassignment knob (repro_torch.core.reassign.ReassignConfig)
    # or None; like leases, Scenario validation restricts it to workers=1.
    reassign: object = None
    # lowered payload-striping knob (repro_torch.coding.manager.CodingConfig)
    # or None; Scenario validation restricts it to workers=1 (repair
    # fetches on stolen objects cross group boundaries).
    coding: object = None


@dataclasses.dataclass
class ShardGroupStats:
    group: int
    ops_admitted: int
    redirects: int
    fenced_ops: int
    migrations_in: int
    migrations_out: int
    steals_started: int
    steal_nacks: int


@dataclasses.dataclass
class EngineStats:
    """Per-group engine telemetry of a parallel run (wall-clock side)."""
    group: int
    events: int
    wall_s: float
    events_per_sec: float
    messages: int
    heap_peak: int
    collapsed: int = 0                 # idle-path arrive+proc pairs inlined


@dataclasses.dataclass
class ShardedRunResult:
    protocol: str
    n_groups: int
    group_size: int
    n_clients: int
    batch_size: int
    locality: str
    committed_ops: int
    makespan_s: float
    throughput_tx_s: float
    latency_avg_ms: float
    latency_p50_ms: float
    latency_p99_ms: float
    fast_path_frac: float
    messages: int
    migrations: int
    redirected_ops: int
    redirect_rate: float               # redirected ops / committed ops
    remote_frac: float                 # dispatches to a non-home group
    steal_hints: int
    per_group: List[ShardGroupStats] = dataclasses.field(default_factory=list)
    # engine telemetry (wall-clock side — excluded from determinism checks;
    # see TELEMETRY_FIELDS)
    events: int = 0
    events_per_sec: float = 0.0
    wall_s: float = 0.0
    heap_peak: int = 0
    workers: int = 1
    barriers: int = 0                  # parallel: time-window sync count
    idle_wait_frac: float = 0.0        # parallel: worker time blocked at
                                       # window barriers / total worker time
    per_engine: List[EngineStats] = dataclasses.field(default_factory=list)
    # aggregate idle-path collapse count: deterministic per engine, but
    # heap-composition dependent, so serial and parallel runs legitimately
    # differ -> telemetry
    collapsed: int = 0
    # commit_log entries left after matching client ops (stamps that never
    # reached a client ack path); the logs themselves are released at run
    # end. Identical serial vs parallel (the merged log is), so NOT
    # telemetry.
    commit_log_residual: int = 0
    # fraction of committed ops shipped as erasure-coded stripes
    # (repro_torch.coding); 0.0 without the coding knob. Deterministic (and
    # coding is serial-only anyway), so NOT telemetry.
    striped_frac: float = 0.0
    # weight-view install records [(t, epoch, ranking, by)] from the
    # reassignment subsystem (repro_torch.core.reassign); ids are global.
    # Deterministic (and reassign is serial-only anyway), so NOT telemetry.
    weight_epochs: list = dataclasses.field(default_factory=list)
    # client invoke/response history (repro_torch.verify), captured on serial
    # runs when capture_history/faults is set; deterministic, so NOT a
    # telemetry field (parallel runs never capture — see faults note on
    # ShardedRunConfig — so the serial<->parallel contract is unaffected)
    history: list = dataclasses.field(default_factory=list, repr=False)
    # canonical span trace (repro_torch.obs) when cfg.obs enables tracing. The
    # span *set* is pinned identical serial vs parallel by tests/test_obs,
    # but per-engine commit-dedup choices can differ in timestamps on
    # duplicate-stamped ops, so the field itself is telemetry
    trace: list = dataclasses.field(default_factory=list, repr=False)

    def row(self) -> str:
        return (f"{self.protocol},{self.n_groups},{self.group_size},"
                f"{self.n_clients},{self.batch_size},{self.locality},"
                f"{self.committed_ops},{self.throughput_tx_s:.0f},"
                f"{self.latency_p50_ms:.3f},{self.latency_p99_ms:.3f},"
                f"{self.migrations},{self.redirect_rate:.4f},"
                f"{self.remote_frac:.4f}")


# wall-clock-side fields: identical workloads on different machines (or
# worker counts) legitimately differ here — everything else is pinned
# bit-identical between serial and parallel runs
TELEMETRY_FIELDS = {"events", "events_per_sec", "wall_s", "heap_peak",
                    "workers", "barriers", "idle_wait_frac", "per_engine",
                    "collapsed", "trace"}


def non_telemetry_metrics(result: "ShardedRunResult") -> dict:
    """The determinism-contract view of a result: every field except
    wall-clock telemetry. The single definition of "bit-identical" used
    by tests/test_parallel.py and bench_parallel_shard."""
    d = dataclasses.asdict(result)
    for k in TELEMETRY_FIELDS:
        d.pop(k)
    return d


@dataclasses.dataclass
class ShardedRunArtifacts:
    result: ShardedRunResult
    sim: Optional[Simulation]          # None for parallel runs (state lives
    replicas: List[List[object]]       # in worker processes); [] likewise
    gates: List[GroupGate]
    clients: List[ShardClient]


@dataclasses.dataclass
class ClientRow:
    """Client-side metric record (what assemble_result needs per client).

    ``ops`` is [(op_id, submit_time)] in creation order; commit metadata
    comes from the engines' commit logs, NOT from Op objects — a
    cross-engine Op reference is a pickled copy, so in-place replica
    stamping is not observable across engines (see simulator commit_log).
    """
    node_id: int
    ops: List[tuple]
    redirected_ops: int
    remote_ops: int
    hints_sent: int
    done_time: float


# ---------------------------------------------------------------------------
# Shared builders (serial and parallel construct identical deployments)
# ---------------------------------------------------------------------------

def resolve_workers(cfg: ShardedRunConfig) -> int:
    w = cfg.workers
    if w == 0:
        w = os.cpu_count() or 1
    return max(1, min(w, cfg.n_groups))


def client_home_map(cfg: ShardedRunConfig) -> Dict[int, int]:
    """client global id -> home group. Client ci is homed at group ci % G:
    every group hosts the same client population, and with G=1 ids
    collapse onto the flat layout."""
    G, npg = cfg.n_groups, cfg.n_replicas_per_group
    n_clients = G * cfg.n_clients_per_group
    return {G * npg + ci: ci % G for ci in range(n_clients)}


def lookahead_of(costs: CostModel, allow_steal: bool = True) -> float:
    """Conservative-sync lookahead: the minimum one-way delay base of any
    cross-group link. Every boundary message pays at least this much on
    top of its send time — jitter, per-node distance and sender occupancy
    only add — so an engine that has seen every peer event up to T cannot
    receive anything new before T + lookahead.

    Cross-group replica<->replica messages exist only in the object-steal
    flow (steal req/nack/grant; redirects and replies ride client links),
    so with stealing disabled the lookahead widens to the client WAN hop
    — ~3x fewer window barriers under the default cost model."""
    client_link = costs.net_client + costs.net_remote_client
    if not allow_steal:
        return client_link
    return min(costs.net_base + costs.net_cross, client_link)


def make_gate(cfg: ShardedRunConfig, g: int, journal: bool = False) -> GroupGate:
    gate = GroupGate(g, cfg.n_groups, cfg.n_replicas_per_group,
                     seed=cfg.seed, steal_cooldown=cfg.steal_cooldown)
    if journal:
        gate.journal = []
    return gate


def build_group(sim, cfg: ShardedRunConfig, g: int,
                gate: GroupGate) -> List[object]:
    """Construct group ``g``'s replicas against ``sim`` (a Simulation or a
    partitioned EventEngine) and start their heartbeats."""
    npg = cfg.n_replicas_per_group
    cls = make_sharded_replica(protocol_class(cfg.protocol))
    t = max(1, min(cfg.t_fail, (npg - 1) // 2))
    view = GroupView(sim, g, npg)
    grp = [cls(i, view, gate=gate, t_fail=t,
               group_cap=max(cfg.batch_size, 1),
               leases=cfg.leases, reassign=cfg.reassign,
               coding=cfg.coding)
           for i in range(npg)]
    for rep in grp:
        sim.add_node(GroupNodeProxy(rep, view))
        rep.start_heartbeats()
    return grp


def shard_workload_of(cfg: ShardedRunConfig) -> ShardWorkload:
    return ShardWorkload(locality=cfg.locality, p_local=cfg.p_local,
                         working_set=cfg.working_set,
                         p_working=cfg.p_working,
                         drift_every=cfg.drift_every, base=cfg.workload)


def client_batches(cfg: ShardedRunConfig, ci: int) -> int:
    n_clients = cfg.n_groups * cfg.n_clients_per_group
    total_batches = max(1, cfg.total_ops // max(1, cfg.batch_size))
    base, rem = divmod(total_batches, n_clients)
    return max(1, base + (1 if ci < rem else 0))


def build_client(sim, cfg: ShardedRunConfig, ci: int,
                 swl: ShardWorkload) -> ShardClient:
    G, npg = cfg.n_groups, cfg.n_replicas_per_group
    return ShardClient(
        G * npg + ci, sim, protocol=cfg.protocol, n_groups=G,
        group_size=npg, home_group=ci % G, client_index=ci // G,
        shard_workload=swl, steal_threshold=cfg.steal_threshold,
        map_seed=cfg.seed, batch_size=cfg.batch_size,
        max_inflight=cfg.max_inflight,
        total_batches=client_batches(cfg, ci),
        value_seed=cfg.seed)


# ---------------------------------------------------------------------------
# Run
# ---------------------------------------------------------------------------

def run_sharded(cfg: ShardedRunConfig) -> ShardedRunArtifacts:
    """Legacy surface: lower the config onto a declarative Scenario
    (validating it — contradictions like an explicit-parallel fault
    schedule fail fast there) and run through the shared
    ``run_scenario`` path."""
    from repro_torch.scenario.build import run_scenario      # lazy: cycle
    from repro_torch.scenario.spec import Scenario
    return run_scenario(Scenario.from_sharded_config(cfg))


def run_sharded_config(cfg: ShardedRunConfig) -> ShardedRunArtifacts:
    """Execute a lowered sharded run plan (the post-validation internal
    path shared by ``run_scenario`` and, transitively, the legacy
    ``run_sharded``)."""
    w = resolve_workers(cfg)
    if (cfg.faults or cfg.capture_history) and w > 1:
        if cfg.workers == 0:
            w = 1          # auto resolves to the serial oracle
        else:
            raise ValueError(
                "faults/history capture require serial execution "
                "(workers=1): the conservative window lookahead does not "
                "model partitions and the parallel engine does not "
                "capture client histories")
    if w > 1 and cfg.n_groups > 1:
        from repro_torch.shard.parallel import run_sharded_parallel
        return run_sharded_parallel(cfg, w)

    G, npg = cfg.n_groups, cfg.n_replicas_per_group
    n_clients = G * cfg.n_clients_per_group
    sim = Simulation(G * npg, cfg.costs, seed=cfg.seed, group_size=npg,
                     client_home=client_home_map(cfg))
    obs = cfg.obs
    if obs is not None and getattr(obs, "trace", False):
        # before build_group: each GroupView captures the tracer (like
        # commit_log) at construction
        from repro_torch.obs.spans import Tracer
        sim.tracer = Tracer(sample_every=getattr(obs, "sample_every", 1))

    gates = [make_gate(cfg, g) for g in range(G)]
    replicas = [build_group(sim, cfg, g, gates[g]) for g in range(G)]
    if cfg.faults:
        from repro_torch.faults import compile_schedule
        compile_schedule(sim, cfg.faults, n_replicas=G * npg,
                         symbolic_n=npg)

    swl = shard_workload_of(cfg)
    clients = [build_client(sim, cfg, ci, swl) for ci in range(n_clients)]
    for c in clients:
        sim.add_node(c)

    for c in clients:
        c.start()
    sim.run(until=cfg.sim_time_cap, stop_when_clients_done=len(clients))

    rows = [ClientRow(c.node_id,
                      [(op.op_id, op.submit_time) for op in c.ops],
                      c.redirected_ops, c.remote_ops, c.hints_sent,
                      c.done_time)
            for c in clients]
    gate_rows = [gate_stats(g) for g in gates]
    trace = None
    if sim.tracer is not None:
        from repro_torch.obs.spans import canonical_events
        trace = canonical_events(sim.tracer.events)
    result = assemble_result(
        cfg, rows, sim.commit_log, gate_rows,
        makespan_t=sim.now, messages=sim.stats_messages,
        events=sim.stats_events, wall_s=sim.wall_s,
        heap_peak=sim.heap_peak, workers=1,
        collapsed=sim.stats_collapsed, trace=trace,
        striped_ops=sim.striped_ops)
    sim.commit_log.clear()     # growth fix: residual is on the result
    result.weight_epochs = list(sim.weight_installs)
    if cfg.capture_history or cfg.faults:
        from repro_torch.verify import capture_history
        result.history = capture_history(clients)
    return ShardedRunArtifacts(result, sim, replicas, gates, clients)


def gate_stats(g: GroupGate) -> ShardGroupStats:
    return ShardGroupStats(
        group=g.group, ops_admitted=g.ops_admitted, redirects=g.redirects,
        fenced_ops=g.fenced_ops, migrations_in=g.migrations_in,
        migrations_out=g.migrations_out, steals_started=g.steals_started,
        steal_nacks=g.steal_nacks)


def assemble_result(cfg: ShardedRunConfig, client_rows: List[ClientRow],
                    commit_log: Dict[int, tuple],
                    gate_rows: List[ShardGroupStats], *,
                    makespan_t: float, messages: int,
                    events: int = 0, wall_s: float = 0.0,
                    heap_peak: int = 0, workers: int = 1,
                    barriers: int = 0, idle_wait_frac: float = 0.0,
                    per_engine: Optional[List[EngineStats]] = None,
                    collapsed: int = 0, trace: Optional[list] = None,
                    striped_ops: int = 0) -> ShardedRunResult:
    """Shared metric math: one code path for serial and parallel runs, so
    identical inputs give bit-identical outputs. ``commit_log`` maps
    op_id -> (commit_time, path) — for parallel runs the per-engine logs
    merged earliest-stamp-first (matching the ``commit_time < 0`` stamp
    guard on the serial engine's shared Op objects)."""
    lat: List[float] = []
    fast = 0
    for row in sorted(client_rows, key=lambda r: r.node_id):
        for op_id, submit in row.ops:
            rec = commit_log.get(op_id)
            if rec is not None:
                lat.append(rec[0] - submit)
                if rec[1] == "fast":
                    fast += 1
    committed = len(lat)
    lat_ms = np.array(lat) * 1e3
    makespan = max(makespan_t, 1e-9)
    redirected = sum(r.redirected_ops for r in client_rows)
    remote = sum(r.remote_ops for r in client_rows)
    return ShardedRunResult(
        protocol=cfg.protocol, n_groups=cfg.n_groups,
        group_size=cfg.n_replicas_per_group, n_clients=len(client_rows),
        batch_size=cfg.batch_size, locality=cfg.locality,
        committed_ops=committed, makespan_s=makespan,
        throughput_tx_s=committed / makespan,
        latency_avg_ms=float(lat_ms.mean()) if committed else float("nan"),
        latency_p50_ms=(float(np.percentile(lat_ms, 50))
                        if committed else float("nan")),
        latency_p99_ms=(float(np.percentile(lat_ms, 99))
                        if committed else float("nan")),
        fast_path_frac=fast / committed if committed else 0.0,
        messages=messages,
        migrations=sum(g.migrations_in for g in gate_rows),
        redirected_ops=redirected,
        redirect_rate=redirected / committed if committed else 0.0,
        remote_frac=remote / max(1, committed),
        steal_hints=sum(r.hints_sent for r in client_rows),
        per_group=sorted(gate_rows, key=lambda g: g.group),
        events=events,
        events_per_sec=events / wall_s if wall_s > 0 else 0.0,
        wall_s=wall_s, heap_peak=heap_peak, workers=workers,
        barriers=barriers, idle_wait_frac=idle_wait_frac,
        per_engine=per_engine or [], collapsed=collapsed,
        commit_log_residual=len(commit_log) - committed,
        striped_frac=striped_ops / committed if committed else 0.0,
        trace=trace or [])
