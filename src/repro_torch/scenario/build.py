"""run_scenario(): the one entrypoint that lowers a Scenario onto the
simulator.

Flat scenarios (``sharding is None``) build the classic single-group
deployment — ``Simulation`` + protocol replicas + open-loop ``Client``s
— exactly as the legacy ``run(RunConfig)`` did (the Scenario golden pins
assert bit-for-bit identity). Sharded scenarios lower onto
``ShardedRunConfig`` and reuse the shard runner's shared builders; with
``Sharding.workers >= 2`` the conservative parallel engine takes over
unchanged.

Return type mirrors the legacy surfaces: ``RunArtifacts`` for flat runs,
``ShardedRunArtifacts`` for sharded ones — both carry ``.result``, which
is all the bench/refine loops consume.
"""

from __future__ import annotations

from typing import Union

from repro_torch.core.runner import RunArtifacts, client_target_fn
from repro_torch.core.simulator import Client, Simulation, collect_metrics
from repro_torch.faults import compile_schedule
from repro_torch.scenario.registry import protocol_class, protocol_info
from repro_torch.scenario.spec import Scenario
from repro_torch.shard.runner import (ShardedRunArtifacts, ShardedRunConfig,
                                run_sharded_config)


def _lease_cfg(sc: Scenario):
    """Lower the declarative Leases knob to the picklable LeaseConfig the
    replica constructor takes (None when disabled — the subsystem is then
    never constructed and the run is bit-identical to pre-lease builds)."""
    ls = sc.leases
    if ls is None or not ls.enabled:
        return None
    from repro_torch.core.leases import LeaseConfig
    return LeaseConfig(duration_s=ls.duration_s,
                       renew_margin=ls.renew_margin,
                       grant_after_reads=ls.grant_after_reads)


def _reassign_cfg(sc: Scenario):
    """Lower the declarative Reassign knob to the picklable
    ReassignConfig the replica constructor takes (None when disabled —
    no ReassignManager is constructed and the run is bit-identical to
    pre-reassignment builds)."""
    ra = sc.reassign
    if ra is None or not ra.enabled:
        return None
    from repro_torch.core.reassign import ReassignConfig
    return ReassignConfig(ema_ratio=ra.ema_ratio,
                          stale_after_s=ra.stale_after_s,
                          confirm_ticks=ra.confirm_ticks,
                          min_reports=ra.min_reports,
                          report_interval_s=ra.report_interval_s,
                          report_ttl_s=ra.report_ttl_s,
                          backoff_s=ra.backoff_s,
                          backoff_max_s=ra.backoff_max_s,
                          epoch_fence=ra.epoch_fence)


def _coding_cfg(sc: Scenario):
    """Lower the declarative Coding knob to the picklable CodingConfig
    the replica constructor takes (None when disabled — no CodingManager
    is constructed and the run is bit-identical to pre-coding builds)."""
    cd = sc.coding
    if cd is None or not cd.enabled:
        return None
    from repro_torch.coding.manager import CodingConfig
    return CodingConfig(stripe_min_bytes=cd.stripe_min_bytes,
                        parity=cd.parity)


def lower_sharded(sc: Scenario) -> ShardedRunConfig:
    """The sharded run plan: a Scenario flattened onto the internal
    ShardedRunConfig carrier (also what parallel workers unpickle)."""
    sh = sc.sharding
    return ShardedRunConfig(
        protocol=sc.protocol, n_groups=sh.n_groups,
        n_replicas_per_group=sc.n_replicas,
        n_clients_per_group=sc.n_clients, batch_size=sc.batch_size,
        max_inflight=sc.max_inflight, total_ops=sc.total_ops,
        t_fail=sc.t_fail, locality=sh.locality, p_local=sh.p_local,
        working_set=sh.working_set, p_working=sh.p_working,
        drift_every=sh.drift_every, steal_threshold=sh.steal_threshold,
        steal_cooldown=sh.steal_cooldown, workload=sc.workload,
        costs=sc.costs, seed=sc.seed, sim_time_cap=sc.sim_time_cap,
        workers=sh.workers, faults=sc.faults,
        capture_history=sc.verify.capture_history, obs=sc.obs,
        leases=_lease_cfg(sc), reassign=_reassign_cfg(sc),
        coding=_coding_cfg(sc))


def run_scenario(sc: Scenario) -> Union[RunArtifacts,
                                        ShardedRunArtifacts]:
    """Run a validated Scenario. Flat specs return :class:`RunArtifacts`,
    sharded specs :class:`ShardedRunArtifacts`; ``artifacts.result``
    carries the metrics either way."""
    reset = getattr(sc.workload, "reset", None)
    if reset is not None:
        reset()        # stateful generators replay identical streams on
                       # every run of the same spec
    if sc.sharding is not None:
        art = run_sharded_config(lower_sharded(sc))
    else:
        art = _run_flat(sc)
    if sc.verify.check_linearizable:
        _check(sc, art)
    if sc.obs is not None and sc.obs.export:
        from repro_torch.obs.export import write_trace
        write_trace(sc.obs.export, art.result.trace,
                    fmt=sc.obs.export_format)
    return art


def _run_flat(sc: Scenario) -> RunArtifacts:
    sim = Simulation(sc.n_replicas, sc.costs, seed=sc.seed)
    if sc.obs is not None and sc.obs.trace:
        from repro_torch.obs.spans import Tracer
        sim.tracer = Tracer(sample_every=sc.obs.sample_every)
    cls = protocol_class(sc.protocol)
    t = max(1, min(sc.t_fail, (sc.n_replicas - 1) // 2))
    leases = _lease_cfg(sc)
    reassign = _reassign_cfg(sc)
    coding = _coding_cfg(sc)
    replicas = [cls(i, sim, t_fail=t, group_cap=max(sc.batch_size, 1),
                    leases=leases, reassign=reassign, coding=coding)
                for i in range(sc.n_replicas)]
    for rep in replicas:
        sim.add_node(rep)
        rep.start_heartbeats()

    total_batches = max(1, sc.total_ops // max(1, sc.batch_size))
    base, rem = divmod(total_batches, sc.n_clients)

    clients = []
    for ci in range(sc.n_clients):
        c = Client(sc.n_replicas + ci, sim, batch_size=sc.batch_size,
                   max_inflight=sc.max_inflight, workload=sc.workload,
                   target_fn=client_target_fn(sc.protocol, ci,
                                              sc.n_replicas),
                   total_batches=max(1, base + (1 if ci < rem else 0)),
                   value_seed=sc.seed)
        sim.add_node(c)
        clients.append(c)

    if sc.faults:
        compile_schedule(sim, sc.faults, n_replicas=sc.n_replicas)

    for c in clients:
        c.start()
    # clients bump sim.clients_done exactly once on completion, so the
    # per-event stop check is a counter compare, not an all() scan
    sim.run(until=sc.sim_time_cap, stop_when_clients_done=len(clients))

    if sc.coding is not None:
        # the engine halts the moment the last client acks: a read of a
        # striped object committed in the final instants can still be
        # parked, its stamp cut off by the shutdown rather than by data
        # loss — flush it iff the stripe is reconstructable cluster-wide
        from repro_torch.coding import drain_pending_reads
        drain_pending_reads(replicas)

    result = collect_metrics(sc.protocol, sim, clients, sc.batch_size,
                             t_start=0.0)
    # commit_log growth fix: every stamped op holds one entry for the
    # whole run — surface the orphan count (stamps that never reached a
    # client ack) and release the log
    result.commit_log_residual = len(sim.commit_log) - result.committed_ops
    sim.commit_log.clear()
    if sim.tracer is not None:
        from repro_torch.obs.spans import canonical_events
        result.trace = canonical_events(sim.tracer.events)
    if sc.verify.capture_history or sc.faults:
        from repro_torch.verify import capture_history
        result.history = capture_history(clients)
    return RunArtifacts(result, sim, replicas, clients)


def _check(sc: Scenario, art) -> None:
    from repro_torch.verify import check_history_linearizable
    result = art.result
    if not result.history:
        raise ValueError(
            "check_linearizable needs a captured history: set "
            "Verification.capture_history (or schedule faults)")
    ok, why = check_history_linearizable(result.history)
    if not ok:
        raise AssertionError(f"scenario history not linearizable: {why}")
    # The history check is sound but incomplete: it only sees what
    # clients happened to observe. Flat runs carry live replica state,
    # so also require one total apply order across live replicas —
    # divergence there means no linearization exists even if no client
    # read caught it. Skipped for protocols whose replicas legitimately
    # diverge (EPaxos arrival-order commit, reads == "unverified") and
    # for sharded artifacts (per-group object spaces; the shard suite
    # covers those directly).
    if (isinstance(art, RunArtifacts)
            and protocol_info(sc.protocol).reads == "linearizable"):
        from repro_torch.verify import verify_artifacts
        ok, why = verify_artifacts(art, check_history=False)
        if not ok:
            raise AssertionError(
                f"scenario replica state not linearizable: {why}")
