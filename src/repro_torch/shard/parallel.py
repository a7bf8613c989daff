"""Parallel sharded simulation: per-group event engines, conservative
time-window synchronization (classic conservative PDES, specialized to
this simulator's cost model).

Why this is possible
--------------------
Every quantity that determines simulated timing is a pure function of
*local* deterministic state: per-message network jitter is keyed by the
(src, dst, link-sequence) of the message (NOT by a global counter — see
the parallel-simulation notes in :mod:`repro_torch.core.simulator`), per-link FIFO floors and
per-node busy-until evolve only with the owning engine's own event
processing, and CPU costs are constants. So G per-group engines that
each process their own events in timestamp order reproduce *exactly* the
event times of the single-heap serial engine — the only thing they need
from each other is timely delivery of boundary messages.

Conservative windows
--------------------
Every cross-engine link (replica<->replica across groups, or a client
talking to a non-home group) has a one-way delay base of at least
``lookahead_of(costs)`` (jitter, distance and sender occupancy only
add). Engines therefore advance in lockstep windows: after a barrier at
which every boundary message with arrival time < W has been delivered,
all engines may freely process events up to ``W = M + lookahead`` (M =
the global minimum next-event time), because anything a peer sends
during that window is sent at time >= M and arrives at >= M + lookahead.
Barriers are hub-and-spoke through the orchestrating process; boundary
messages are routed between barriers in (source group, emission order) —
fully deterministic.

Exact stop (the fiddly part)
----------------------------
The serial oracle stops *mid-event-stream*: the moment the last client
completes (time T*), nothing later is processed. A window runs past T*
before the barrier can detect completion, so engines journal the final
window's side effects that feed metrics — message posts (per-window
event-time log) and shard-gate counters (``GroupGate.journal``) — and
truncate them to T* at finalize time. Client-side counters need no
truncation (a client with nothing left in flight mutates nothing), and
commit stamps are merged earliest-first across engines, so a post-T*
courtesy stamp can never displace the authoritative one. Committed-op
metadata comes from the engines' commit logs because a cross-engine Op
reference is a pickled copy — replica-side in-place stamping is only
observable within one engine.

When to prefer the serial engine
--------------------------------
``workers=1`` remains the right choice for G=1 (nothing to parallelize),
for tiny runs (fork + per-window IPC overhead dominates), and for
heavily cross-group workloads, where boundary traffic makes windows
chatty while each engine has little private work per window.
"""

from __future__ import annotations

import gc
import multiprocessing as mp
import time
import warnings
from typing import Dict, List

from repro_torch.core.simulator import EventEngine
from repro_torch.shard.runner import (ClientRow, EngineStats, ShardedRunArtifacts,
                                ShardedRunConfig, assemble_result,
                                build_client, build_group, client_home_map,
                                gate_stats, lookahead_of, make_gate,
                                shard_workload_of)

_INF = float("inf")


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------

class _Engine:
    """One consensus group's event engine + its homed clients."""

    def __init__(self, cfg: ShardedRunConfig, g: int):
        G, npg = cfg.n_groups, cfg.n_replicas_per_group
        home = client_home_map(cfg)
        n_nodes = G * npg + len(home)
        self.group = g
        self.sim = EventEngine(G * npg, cfg.costs, seed=cfg.seed,
                               group_size=npg, client_home=home)
        obs = cfg.obs
        if obs is not None and getattr(obs, "trace", False):
            # before build_group: the GroupView captures the tracer at
            # construction (same contract as the serial runner)
            from repro_torch.obs.spans import Tracer
            self.sim.tracer = Tracer(
                sample_every=getattr(obs, "sample_every", 1))
        self.sim.configure_partition(
            lambda i: (i // npg == g) if i < G * npg else home[i] == g,
            n_nodes)
        self.gate = make_gate(cfg, g, journal=True)
        self.replicas = build_group(self.sim, cfg, g, self.gate)
        swl = shard_workload_of(cfg)
        self.clients = [build_client(self.sim, cfg, ci, swl)
                        for ci in range(len(home)) if ci % G == g]
        for c in self.clients:
            self.sim.add_node(c)
        for c in self.clients:
            c.start()

    def report(self) -> tuple:
        return (self.group,
                self.sim.drain_outbox(),
                self.sim.next_event_time(),
                self.sim.clients_done,
                max((c.done_time for c in self.clients), default=-1.0))

    def run_window(self, wend: float, inject: List[tuple]) -> None:
        sim = self.sim
        sim.begin_window()
        if self.gate.journal:
            self.gate.journal.clear()
        for arrive, msg in inject:
            sim.inject(arrive, msg)
        sim.run(until=wend)

    def finalize(self, tstar: float) -> dict:
        sim = self.sim
        self.gate.truncate_after(tstar)
        return {
            "group": self.group,
            "clients": [ClientRow(
                c.node_id, [(op.op_id, op.submit_time) for op in c.ops],
                c.redirected_ops, c.remote_ops, c.hints_sent, c.done_time)
                for c in self.clients],
            "commit_log": sim.commit_log,
            "gate": gate_stats(self.gate),
            "messages": sim.stats_messages - sim.posts_after(tstar),
            "events": sim.stats_events,
            "wall_s": sim.wall_s,
            "heap_peak": sim.heap_peak,
            "collapsed": sim.stats_collapsed,
            # truncate to the serial stop point: keep t <= T* (the
            # complement of posts_after's strictly-after convention)
            "trace": (None if sim.tracer is None else
                      [e for e in sim.tracer.events if e[0] <= tstar]),
        }


def _worker_main(conn, cfg: ShardedRunConfig, group_ids: List[int]) -> None:
    t_start = time.perf_counter()
    blocked = 0.0
    # one long-lived event loop split into thousands of window-sized
    # run() calls: keep the cyclic GC off for the worker's whole life
    # (matching the serial engine, which pauses it across the single
    # run() call) instead of paying a generational collection against a
    # large live heap at every window boundary
    gc.disable()
    try:
        engines = [_Engine(cfg, g) for g in group_ids]
        conn.send(("ok", [e.report() for e in engines]))
        while True:
            t0 = time.perf_counter()
            cmd = conn.recv()
            blocked += time.perf_counter() - t0
            if cmd[0] == "window":
                _, wend, inject = cmd
                for e in engines:
                    e.run_window(wend, inject.get(e.group, ()))
                conn.send(("ok", [e.report() for e in engines]))
            elif cmd[0] == "finalize":
                total = time.perf_counter() - t_start
                conn.send(("ok", {
                    "engines": [e.finalize(cmd[1]) for e in engines],
                    "blocked_s": blocked,
                    "total_s": total,
                }))
                return
            else:                       # "stop"
                return
    except BaseException as exc:        # surface worker crashes upstream
        try:
            conn.send(("err", repr(exc)))
        except Exception:
            pass
        raise


# ---------------------------------------------------------------------------
# Orchestrator side
# ---------------------------------------------------------------------------

def _recv(conn):
    status, payload = conn.recv()
    if status != "ok":
        raise RuntimeError(f"parallel shard worker failed: {payload}")
    return payload


def run_sharded_parallel(cfg: ShardedRunConfig,
                         workers: int) -> ShardedRunArtifacts:
    G, npg = cfg.n_groups, cfg.n_replicas_per_group
    W = max(1, min(workers, G))
    n_clients = G * cfg.n_clients_per_group
    lookahead = lookahead_of(cfg.costs,
                             allow_steal=cfg.steal_threshold > 0)
    cap = cfg.sim_time_cap
    home = client_home_map(cfg)

    def engine_of(node_id: int) -> int:
        return node_id // npg if node_id < G * npg else home[node_id]

    ctx = mp.get_context("fork" if "fork" in mp.get_all_start_methods()
                         else "spawn")
    conns, procs = [], []
    assign = [[g for g in range(G) if g % W == w] for w in range(W)]
    worker_of = {g: w for w in range(W) for g in assign[w]}
    try:
        for w in range(W):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main,
                            args=(child, cfg, assign[w]), daemon=True)
            with warnings.catch_warnings():
                # jax warns at os.fork() whenever it has been imported in
                # this process. Workers never execute jax: the simulator
                # path uses the numpy weight twin (see core/weights.py),
                # so the inherited XLA state is never touched.
                warnings.filterwarnings(
                    "ignore", message=r".*os\.fork\(\).*",
                    category=RuntimeWarning)
                p.start()
            child.close()
            conns.append(parent)
            procs.append(p)

        barriers = 0
        reports: Dict[int, tuple] = {}
        for w in range(W):
            for rep in _recv(conns[w]):
                reports[rep[0]] = rep

        while True:
            done = sum(rep[3] for rep in reports.values())
            if done >= n_clients:
                # T*: the sim time at which the last client completed —
                # exactly where the serial oracle's event loop stops.
                # Boundary messages still in flight were all sent during
                # the window that completed the last client, so they
                # arrive at >= that window's end > T*: the serial engine
                # would not have processed them either.
                tstar = max(rep[4] for rep in reports.values())
                break
            # route boundary messages deterministically: ascending source
            # group, emission order within each outbox
            inject: Dict[int, list] = {}
            pending_min = _INF
            for g in sorted(reports):
                for arrive, msg in reports[g][1]:
                    inject.setdefault(engine_of(msg.dst), []).append(
                        (arrive, msg))
                    if arrive < pending_min:
                        pending_min = arrive
            # conservative bound: the global minimum next event must count
            # the arrivals being injected THIS round, not just heap tops —
            # in sparse regimes a boundary message can arrive well before
            # any queued local event, and a window sized off heap tops
            # alone would let its consequences (a reply crossing back
            # within the same window) violate causal delivery
            nxt = min(min(rep[2] for rep in reports.values()), pending_min)
            if nxt > cap or nxt == _INF:
                tstar = cap          # nothing (queued or in flight) can
                break                # happen at or before the time cap
            wend = min(nxt + lookahead, cap)
            per_worker: List[Dict[int, list]] = [{} for _ in range(W)]
            for eng, msgs in inject.items():
                per_worker[worker_of[eng]][eng] = msgs
            for w in range(W):
                conns[w].send(("window", wend, per_worker[w]))
            barriers += 1
            for w in range(W):
                for rep in _recv(conns[w]):
                    reports[rep[0]] = rep

        for w in range(W):
            conns[w].send(("finalize", tstar))
        finals = [_recv(conns[w]) for w in range(W)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
        for c in conns:
            c.close()

    engines = sorted((e for f in finals for e in f["engines"]),
                     key=lambda e: e["group"])
    # merge commit logs earliest-stamp-first: within one engine stamps are
    # time-ordered (first write wins), and across engines the earliest
    # stamp is exactly the one the serial engine's shared-Op guard keeps
    merged: Dict[int, tuple] = {}
    for e in engines:
        for op_id, rec in e["commit_log"].items():
            cur = merged.get(op_id)
            if cur is None or rec[0] < cur[0]:
                merged[op_id] = rec
    client_rows = [row for e in engines for row in e["clients"]]
    gate_rows = [e["gate"] for e in engines]
    trace = None
    if any(e["trace"] is not None for e in engines):
        # canonicalize the merged log: total (t, kind, node) order plus
        # earliest-commit dedup (an op can stamp in two engines — e.g. a
        # post-migration replay — where the serial shared log keeps one)
        from repro_torch.obs.spans import canonical_events
        trace = canonical_events(
            [ev for e in engines for ev in (e["trace"] or ())])
    messages = sum(e["messages"] for e in engines)
    events = sum(e["events"] for e in engines)
    wall_s = max((e["wall_s"] for e in engines), default=0.0)
    blocked = sum(f["blocked_s"] for f in finals)
    total = sum(f["total_s"] for f in finals)
    result = assemble_result(
        cfg, client_rows, merged, gate_rows,
        makespan_t=tstar, messages=messages,
        events=events, wall_s=wall_s,
        heap_peak=max((e["heap_peak"] for e in engines), default=0),
        workers=W, barriers=barriers,
        idle_wait_frac=blocked / total if total > 0 else 0.0,
        per_engine=[EngineStats(
            group=e["group"], events=e["events"], wall_s=e["wall_s"],
            events_per_sec=(e["events"] / e["wall_s"]
                            if e["wall_s"] > 0 else 0.0),
            messages=e["messages"], heap_peak=e["heap_peak"],
            collapsed=e["collapsed"])
            for e in engines],
        collapsed=sum(e["collapsed"] for e in engines), trace=trace)
    return ShardedRunArtifacts(result, None, [], [], [])
