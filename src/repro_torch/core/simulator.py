"""Deterministic discrete-event cluster simulator (paper §5 substrate).

The paper evaluates WOC against Cabinet on 3-9 VM clusters with open-loop
clients. This container has no cluster, so we reproduce §5 with a
discrete-event simulation whose cost model captures exactly the effects the
paper measures:

  * per-message CPU costs at each replica (recv / send), scaled by a
    per-replica heterogeneity factor — the reason weighted quorums help;
  * per-operation coordination cost paid by whichever replica *coordinates*
    an operation (ordering, bookkeeping, "quorum computation" — §5.4
    attributes replica saturation to this) — the reason a single leader
    becomes the bottleneck and WOC's distributed coordination scales;
  * per-operation parse/apply costs paid by every replica (SMR replication
    floor — no protocol can beat it);
  * heterogeneous network one-way delays with deterministic hash jitter.

Replicas process messages from a FIFO queue one at a time (busy_until
tracking); outgoing sends occupy the sender (fan-out is not free — this is
what saturates Cabinet's leader). Everything is deterministic given the
seed: simulations are exactly reproducible.

Engine notes (the hot-path overhaul):

  * **Jitter hash.** Per-message network jitter is drawn from a
    splitmix64-style integer hash (:func:`hash_jitter_u01`) instead of the
    original blake2b digest. The stream is equally well distributed for
    this purpose but numerically *different*, so every jitter-sensitive
    number (throughput/latency CSVs from earlier runs) was re-baselined
    once by that overhaul. Same-seed bit-for-bit reproducibility and the
    sharded-G=1 ≡ unsharded equivalence are contractual and covered by
    tests/test_engine.py golden traces.
  * **Event collapsing.** A message arrival normally schedules a separate
    processing-completion event (``now`` stays strictly monotone while a
    busy node drains its queue). When the destination is idle and no other
    event is scheduled before processing would complete, the two events
    are collapsed and the handler runs inline — same times, same order,
    half the heap traffic.
  * **Cancellable timers.** :meth:`Simulation.set_timer` returns a
    :class:`TimerHandle`; cancelled timers die lazily when popped instead
    of dispatching into node code (client retry timers are the big win).
  * Per-node service state (busy-until, send/recv/parse costs, one-way
    delay bases) lives in flat lists indexed by node id, not dicts.

Engine notes (the parallel-simulation refactor):

  * **EventEngine extraction.** The event loop proper — heap, timers,
    per-node service state, per-link FIFO/jitter records — is
    :class:`EventEngine`, with no assumption that it hosts *every* node
    in the simulated deployment. :class:`Simulation` (one engine hosting
    everything — the single-heap oracle) subclasses it unchanged;
    :mod:`repro_torch.shard.parallel` composes one engine per consensus group
    across worker processes, synchronized by conservative time windows.
  * **Per-link jitter sequence.** The jitter coordinate ``seq`` is now
    the count of prior messages on the same (src, dst) link, not a
    simulation-global message counter. A global counter depends on how
    independent groups' events interleave in one heap — exactly what a
    partitioned run does not reproduce — while a link-local count is a
    pure function of the sender's own deterministic execution. This is
    the property that makes serial and parallel sharded runs
    bit-identical, and it re-keys the jitter stream: every
    jitter-sensitive recorded number was re-baselined once by that refactor
    (the one-time cost the hot-path overhaul paid for the splitmix64 switch).
  * **Partitioned mode.** :meth:`EventEngine.configure_partition` marks
    foreign nodes; ``post()`` computes arrival times for them as usual
    (sender-side state only: busy charge, link FIFO, jitter) but diverts
    the message to ``outbox`` instead of the heap. The orchestrator
    routes outboxes between engines at window barriers and feeds them to
    :meth:`EventEngine.inject`. ``run(until=...)`` is window-exact: an
    event past ``until`` is pushed back, not dropped.
  * **Commit log.** Protocol stamp sites record ``(commit_time, path)``
    per op id in ``EventEngine.commit_log`` (earliest stamp wins). In a
    one-engine run this mirrors the in-place ``Op`` stamping exactly; in
    a partitioned run it is what makes commit metadata collectable even
    though a cross-engine ``Op`` reference is a pickled copy.

Engine notes (fault injection):

  * **Link faults.** :meth:`EventEngine.cut_links` /
    :meth:`EventEngine.restore_links` / :meth:`EventEngine.set_degrade`
    schedule ``_FAULT`` heap events next to crash/recover, so a fault
    schedule is part of the deterministic event stream. Cuts drop
    messages at post time (in-flight messages survive, like packets
    already in the pipe); degrade multiplies one-way delays. The
    declarative layer lives in :mod:`repro_torch.faults`; verification of the
    resulting histories in :mod:`repro_torch.verify`.

Entity ids: replicas are ``0..n-1``; clients are ``n..n+m-1``.
"""

from __future__ import annotations

import dataclasses
import gc
import heapq
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostModel:
    """CPU / network constants, in seconds. Defaults calibrated so that the
    5-server / 2-client baseline lands in the paper's Tx/s ballpark."""

    c_recv: float = 25e-6         # fixed cost to ingest one message
    c_send: float = 15e-6         # fixed cost to emit one message
    c_parse: float = 0.15e-6      # per-op cost to deserialize a batch
    c_coord: float = 4e-6         # per-op cost at the COORDINATING replica
    c_apply: float = 1.5e-6       # per-op cost to apply at commit (everyone)
    net_base: float = 150e-6      # one-way network delay replica<->replica
    net_client: float = 250e-6    # one-way delay client<->replica
    net_jitter: float = 60e-6     # uniform jitter bound
    timeout: float = 30e-3        # fast-path / election timeout
    # Sharded deployments (src/repro_torch/shard): consensus groups live in
    # different regions, so cross-group replica traffic and a client
    # talking to a non-home group pay a WAN penalty. Both are zero-cost
    # in single-group runs (there is only one group).
    net_cross: float = 300e-6     # extra one-way delay across groups
    net_remote_client: float = 1.2e-3  # extra one-way client<->remote group

    # Payload-size dimension (repro_torch.coding): per-byte costs, all zero by
    # default so every message is priced identically to the historical
    # model unless a run opts into value sizes. The wire term charges the
    # SENDER (NIC serialization occupies the sender, store-and-forward:
    # the byte time also delays arrival); the parse term charges the
    # receiver. ``link_bw`` is a per-replica relative wire-slowdown tuple
    # (indexed by group-local id like ``speeds``; () = uniform): a link's
    # per-byte time is c_byte_wire scaled by the slower endpoint.
    c_byte_wire: float = 0.0      # seconds per byte on the wire
    c_byte_parse: float = 0.0     # seconds per byte to parse on receive
    link_bw: Tuple[float, ...] = ()

    def bw(self, replica: int) -> float:
        lb = self.link_bw
        return lb[replica % len(lb)] if lb else 1.0

    # Heterogeneity: mild CPU spread + strongly heterogeneous network
    # distance (a geo-distributed deployment — §2.3's multi-region story).
    # Weighted quorums pay off by *not waiting* for far/slow replicas.
    speeds: Tuple[float, ...] = (1.0, 1.05, 1.1, 1.15, 1.2, 1.25, 1.3,
                                 1.35, 1.4)
    net_dist: Tuple[float, ...] = (0.0, 30e-6, 60e-6, 90e-6, 120e-6,
                                   150e-6, 180e-6, 210e-6, 240e-6)

    def speed(self, replica: int) -> float:
        return self.speeds[replica % len(self.speeds)]

    def dist(self, replica: int) -> float:
        return self.net_dist[replica % len(self.net_dist)]


# ---------------------------------------------------------------------------
# Deterministic jitter hash (splitmix64-style; golden-pinned in tests)
# ---------------------------------------------------------------------------

_U64 = (1 << 64) - 1
_INV_2_64 = 1.0 / 2.0 ** 64
_SEED_MULT = 0xD1342543DE82EF95
_SRC_MULT = 0x9E3779B97F4A7C15
_DST_MULT = 0xC2B2AE3D27D4EB4F


def _jitter(seed_term: int, src: int, dst: int, seq: int) -> float:
    """Uniform [0,1) from a pre-multiplied seed term + message coordinates.

    One linear combine + the splitmix64 finalizer: ~10x cheaper than the
    blake2b digest it replaced, which was the single largest per-message
    cost in the event loop.
    """
    x = (seed_term + src * _SRC_MULT + dst * _DST_MULT + seq) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return ((x ^ (x >> 31)) & _U64) * _INV_2_64


def hash_jitter_u01(seed: int, src: int, dst: int, seq: int) -> float:
    """Canonical per-message jitter sample in [0,1).

    This is THE timing-critical hash: every network delay in the simulator
    adds ``hash_jitter_u01(seed, src, dst, link_seq) * net_jitter``, where
    ``link_seq`` counts prior messages on the same (src, dst) link — a
    pure function of the sender's deterministic execution, which is what
    lets per-group engines reproduce the exact timing of the single-heap
    simulation (see module docstring). tests/test_engine.py pins golden
    values so refactors cannot silently shift simulated timing (which
    would invalidate recorded baselines).
    """
    return _jitter((seed * _SEED_MULT) & _U64, src, dst, seq)


# ---------------------------------------------------------------------------
# Messages and operations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False, slots=True)
class Op:
    op_id: int
    client: int
    obj: int
    kind: str = "w"            # "w" | "r"
    value: int = 0
    submit_time: float = 0.0
    commit_time: float = -1.0
    path: str = ""             # "fast" | "slow" (filled at commit)
    read_result: object = None # for reads: value returned at the
                               # serialization point (same at every replica
                               # because per-object apply order is agreed)
    size: int = 0              # payload bytes (0 = historical sizeless op;
                               # drives the per-byte cost terms and the
                               # coding subsystem's stripe policy)


@dataclasses.dataclass(eq=False, slots=True)
class Msg:
    kind: str
    src: int
    dst: int
    payload: dict
    size_ops: int = 0          # number of ops carried (drives c_parse)
    size_bytes: int = 0        # payload bytes on the wire (drives the
                               # per-byte cost terms; 0 = metadata-only)


class TimerHandle:
    """Returned by :meth:`Simulation.set_timer`; ``cancel()`` makes the
    pending timer die lazily in the event loop (no heap surgery)."""

    __slots__ = ("alive",)

    def __init__(self):
        self.alive = True

    def cancel(self) -> None:
        self.alive = False


class Node:
    """Base class for replicas and clients. Subclasses implement handlers."""

    def __init__(self, node_id: int, sim: "Simulation"):
        self.node_id = node_id
        self.sim = sim
        self._handlers: Dict[str, Callable] = {}   # msg kind -> bound method

    def on_message(self, msg: Msg, now: float) -> None:
        handler = self._handlers.get(msg.kind)
        if handler is None:
            handler = getattr(self, "on_" + msg.kind.lower(), None)
            if handler is None:
                raise ValueError(f"{type(self).__name__} has no handler for "
                                 f"{msg.kind}")
            self._handlers[msg.kind] = handler
        handler(msg, now)

    def on_timer(self, name: str, payload: dict, now: float) -> None:
        pass

    # -- convenience --------------------------------------------------------

    def send(self, dst: int, kind: str, payload: dict, size_ops: int = 0,
             size_bytes: int = 0):
        self.sim.post(Msg(kind, self.node_id, dst, payload, size_ops,
                          size_bytes))

    def broadcast(self, dsts: Sequence[int], kind: str, payload: dict,
                  size_ops: int = 0, size_bytes: int = 0):
        for d in dsts:
            self.send(d, kind, payload, size_ops, size_bytes)

    def set_timer(self, delay: float, name: str,
                  payload: dict | None = None) -> TimerHandle:
        return self.sim.set_timer(self.node_id, delay, name, payload or {})


# ---------------------------------------------------------------------------
# The event loop
# ---------------------------------------------------------------------------

# heap event kinds (ints compare faster than strings and never reach the
# tuple comparison anyway — (time, seq) is always unique)
_ARRIVE, _PROC, _TIMER, _CRASH, _RECOVER, _FAULT = 0, 1, 2, 3, 4, 5


class EventEngine:
    """Event loop with FIFO service queues and deterministic jitter.

    A self-contained engine: heap + timers + per-node service state. By
    default it hosts every node of the deployment (:class:`Simulation`);
    with :meth:`configure_partition` it hosts one shard of the node space
    and exchanges boundary messages through ``outbox`` / :meth:`inject`
    (driven by :mod:`repro_torch.shard.parallel` at conservative time-window
    barriers).
    """

    # pause the cyclic GC inside run(): the event loop allocates heavily
    # (messages, heap tuples, payloads) against a large live heap, so
    # generational collections burn 10-20% of wall time scanning objects
    # that refcounting alone reclaims. Everything the loop churns is
    # acyclic; cycle garbage created mid-run is collected when the GC
    # resumes at exit.
    GC_PAUSE = True

    def __init__(self, n_replicas: int, costs: CostModel | None = None,
                 seed: int = 0, group_size: int | None = None,
                 client_home: Dict[int, int] | None = None):
        self.n = n_replicas
        self.costs = costs or CostModel()
        self.seed = seed
        # multi-group node-id namespacing (src/repro_torch/shard): replica global
        # ids are laid out in contiguous per-group blocks of ``group_size``
        # (group g owns [g*group_size, (g+1)*group_size)); CPU speed and
        # network distance are indexed by the *local* id so every group
        # mirrors the single-group heterogeneity profile. ``client_home``
        # maps client ids to their home group for the WAN locality penalty.
        # Defaults reduce to the original single-group behaviour exactly.
        self.group_size = group_size or n_replicas
        self.client_home: Dict[int, int] = dict(client_home or {})
        self.now = 0.0
        self.nodes: Dict[int, Node] = {}
        self._heap: List[tuple] = []
        self._seq = 0
        self._seed_term = (seed * _SEED_MULT) & _U64
        self._jit_scale = self.costs.net_jitter * _INV_2_64
        # flat per-node service state (rebuilt lazily when nodes change)
        self._nodes: List[Optional[Node]] = []
        self._busy: List[float] = []
        self._send_c: List[float] = []
        self._recv_c: List[float] = []
        self._parse_c: List[float] = []
        self._delay_base: List[List[float]] = []
        # per-byte cost tables (repro_torch.coding): row lists are only consulted
        # when a message carries size_bytes > 0, so the default (sizeless)
        # event path executes the exact historical float arithmetic
        self._byte_wire: List[List[float]] = []
        self._byte_parse: List[float] = []
        self._tables_ok = False
        # committed ops that shipped striped (repro_torch.coding manager bumps
        # this once per op id); deterministic, surfaced as striped_frac
        self.striped_ops = 0
        # per-link state, keyed src<<24|dst: [next jitter seq, last arrival].
        # The seq half is the jitter coordinate and must never reset (the
        # stream is a pure function of link history); the arrival half is
        # the per-link FIFO floor. Size is bounded by live (src, dst)
        # pairs, not message count, so no pruning is needed.
        self._links: Dict[int, list] = {}
        self.crashed: set[int] = set()
        # link faults (repro_torch.faults): directed links currently down (keyed
        # src<<24|dst like _links) and per-node network-delay inflation
        # factors. Both empty in fault-free runs — post() pays one
        # truthiness check each.
        self._cut: set[int] = set()
        self._degrade: Dict[int, float] = {}
        self.clients_done = 0          # bumped by Client on completion
        # op_id -> (commit_time, path): earliest protocol stamp, written
        # next to every ``op.commit_time = now`` site (metrics substrate
        # for partitioned runs; mirrors Op stamping in one-engine runs).
        # Cleared by the runners once metrics are assembled (unbounded
        # growth fix); the residual count is surfaced as a metric.
        self.commit_log: Dict[int, tuple] = {}
        # read-result capture hook (repro_torch.transport): None in simulation —
        # clients share Op objects by reference, so a read's result is
        # visible the moment a replica stamps it. Over a real transport
        # ops are wire copies; the serving context sets this to a dict
        # and the apply sites record ``op_id -> read_result`` so replies
        # can carry the value back (see NetContext._enrich_reply).
        self.read_results: Optional[Dict[int, object]] = None
        # observability (repro_torch.obs): host-side span recorder, attached by
        # the runners when the Observability spec enables tracing. Every
        # instrumentation site is guarded by an ``is not None`` check and
        # the recorder never posts messages or charges CPU time, so
        # simulated timing is bit-identical with tracing on or off.
        self.tracer = None
        # weight-view ledger (repro_torch.core.reassign): the live epoch-stamped
        # ranking — (epoch, ranking-or-None) — plus the install log
        # (t, epoch, ranking, installer) surfaced as RunResult.weight_epochs.
        # Deferred symbolic fault selectors resolve against the live view.
        self.weight_view: tuple = (0, None)
        self.weight_installs: List[tuple] = []
        # partitioned mode (None/inactive for plain Simulation): foreign
        # lookup table, boundary outbox, and the current window's post
        # event-times (for exact-stop message accounting — see parallel.py)
        self._foreign: Optional[List[bool]] = None
        self._n_nodes_hint = 0
        self.outbox: List[tuple] = []
        self._post_log: Optional[List[float]] = None
        # engine telemetry (surfaced in RunResult / bench_engine)
        self.stats_messages = 0
        self.stats_events = 0
        self.stats_collapsed = 0       # arrive+proc pairs run inline
        self.heap_peak = 0
        self.wall_s = 0.0

    # -- partitioned mode -----------------------------------------------------

    def configure_partition(self, is_local, n_nodes: int) -> None:
        """Mark this engine as one shard of a partitioned deployment.

        ``is_local(node_id)`` says whether this engine hosts the node;
        posts to foreign nodes are fully timed sender-side (busy charge,
        link FIFO, per-link jitter) and appended to ``outbox`` as
        ``(arrive_time, msg)`` instead of entering the heap. ``n_nodes``
        sizes the cost tables for the whole deployment so delay bases to
        foreign destinations resolve.
        """
        self._foreign = [not is_local(i) for i in range(n_nodes)]
        self._n_nodes_hint = n_nodes
        self._post_log = []
        self._tables_ok = False

    def inject(self, arrive: float, msg: Msg) -> None:
        """Deliver a boundary message computed by a peer engine: it enters
        this engine's heap at the sender-computed arrival time. The
        conservative window protocol must never deliver into this
        engine's past — enforced here so a lookahead bug fails loudly
        instead of silently dragging the clock backwards."""
        if arrive < self.now:
            raise RuntimeError(
                f"causality violation: boundary message for node "
                f"{msg.dst} arrives at {arrive:.9f} but engine clock is "
                f"already at {self.now:.9f} (window lookahead too large)")
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (arrive, seq, _ARRIVE, msg))

    def next_event_time(self) -> float:
        return self._heap[0][0] if self._heap else float("inf")

    def begin_window(self) -> None:
        """Start a new window: reset the window-local post log (posts from
        earlier windows can never land past a stop time inside this one)."""
        if self._post_log is not None:
            self._post_log.clear()

    def drain_outbox(self) -> List[tuple]:
        out, self.outbox = self.outbox, []
        return out

    def posts_after(self, t: float) -> int:
        """How many messages this engine posted during events strictly
        after ``t`` in the current window (exact-stop truncation)."""
        log = self._post_log
        return sum(1 for x in log if x > t) if log else 0

    # -- wiring --------------------------------------------------------------

    def add_node(self, node: Node) -> None:
        self.nodes[node.node_id] = node
        self._tables_ok = False

    def replicas(self) -> List[int]:
        return [i for i in range(self.n) if i not in self.crashed]

    # -- cost helpers ---------------------------------------------------------

    def _is_replica(self, node_id: int) -> bool:
        return node_id < self.n

    def _local(self, node_id: int) -> int:
        """Group-local replica id (identity in single-group simulations)."""
        return node_id % self.group_size

    def _group(self, node_id: int) -> int:
        return node_id // self.group_size

    def _delay_base_for(self, src: int, dst: int) -> float:
        """One-way delay base (everything but jitter) — precomputed per
        (src, dst) into ``_delay_base`` at table-build time."""
        c = self.costs
        if self._is_replica(src) and self._is_replica(dst):
            base = c.net_base
            if self._group(src) != self._group(dst):
                base += c.net_cross
        else:
            base = c.net_client
            rep, cli = (src, dst) if self._is_replica(src) else (dst, src)
            home = self.client_home.get(cli)
            if (home is not None and self._is_replica(rep)
                    and home != self._group(rep)):
                base += c.net_remote_client
        for e in (src, dst):
            if self._is_replica(e):
                base += c.dist(self._local(e))
        return base

    def _build_tables(self) -> None:
        """Flatten per-node costs + pairwise delay bases into lists.
        Mutates the existing list objects IN PLACE: ``run()`` binds them
        to locals for speed, so a mid-run rebuild (a node added by a
        handler) must stay visible to the live event loop."""
        size = (max(self.nodes) + 1) if self.nodes else 0
        if self._n_nodes_hint > size:
            size = self._n_nodes_hint   # partitioned: table rows for
                                        # foreign destinations too
        c = self.costs
        self._nodes[:] = (self.nodes.get(i) for i in range(size))
        self._busy[:] = [self._busy[i] if i < len(self._busy) else 0.0
                         for i in range(size)]
        send_c, recv_c, parse_c = [], [], []
        for i in range(size):
            if i < self.n:
                sp = c.speed(self._local(i))
                send_c.append(c.c_send * sp)
                recv_c.append(c.c_recv * sp)
                parse_c.append(c.c_parse * sp)
            else:                   # clients are not the bottleneck
                send_c.append(1e-6)
                recv_c.append(1e-6)
                parse_c.append(0.0)
        self._send_c[:] = send_c
        self._recv_c[:] = recv_c
        self._parse_c[:] = parse_c
        self._delay_base[:] = [[self._delay_base_for(s, d)
                                for d in range(size)] for s in range(size)]
        # per-byte tables: a link's wire time is scaled by the slower
        # endpoint's relative bandwidth (client endpoints count as 1.0);
        # parse is receiver-side, replica-only (clients never bottleneck)
        bw = [c.bw(self._local(i)) if i < self.n else 1.0
              for i in range(size)]
        cbw = c.c_byte_wire
        self._byte_wire[:] = [[cbw * (bw[s] if bw[s] >= bw[d] else bw[d])
                               for d in range(size)] for s in range(size)]
        self._byte_parse[:] = [c.c_byte_parse * c.speed(self._local(i))
                               if i < self.n else 0.0 for i in range(size)]
        self._tables_ok = True

    def busy(self, node_id: int, seconds: float) -> None:
        """Charge CPU time to a node (per-op coordination / apply costs)."""
        if not self._tables_ok:
            self._build_tables()
        b = self._busy
        t = b[node_id]
        now = self.now
        b[node_id] = (t if t > now else now) + seconds

    # -- event posting --------------------------------------------------------

    def post(self, msg: Msg) -> None:
        """Send a message: charge the sender, delay, enqueue arrival."""
        if not self._tables_ok:
            self._build_tables()
        src = msg.src
        dst = msg.dst
        if self.crashed and (src in self.crashed or dst in self.crashed):
            return
        if self._cut and ((src << 24) | dst) in self._cut:
            return      # link down: lost in the network (same free-drop
                        # convention as posts to/from crashed nodes; app-
                        # level retries and retransmit timers re-drive)
        b = self._busy
        t = b[src]
        now = self.now
        send_done = (t if t > now else now) + self._send_c[src]
        # per-byte wire time: NIC serialization occupies the sender and
        # (store-and-forward) delays the arrival by the same amount. The
        # guard keeps the sizeless path's float arithmetic byte-identical;
        # crucially the term only ever ADDS delay, so the parallel
        # runner's zero-byte conservative lookahead stays valid.
        nb = msg.size_bytes
        if nb:
            send_done += nb * self._byte_wire[src][dst]
        b[src] = send_done
        # per-link record: [next jitter seq, last arrival]. The jitter
        # coordinate is the count of prior messages on this link — a pure
        # function of the sender's own execution, NOT of how unrelated
        # engines' events interleave (the bit-identity keystone for
        # partitioned runs). Links key as src<<24|dst: int dict ops beat
        # tuple keys.
        link = (src << 24) | dst
        rec = self._links.get(link)
        if rec is None:
            rec = self._links[link] = [0, 0.0]
        mseq = rec[0]
        rec[0] = mseq + 1
        # splitmix64 jitter, inlined (see hash_jitter_u01)
        x = (self._seed_term + src * _SRC_MULT + dst * _DST_MULT + mseq) \
            & _U64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
        base = self._delay_base[src][dst]
        deg = self._degrade
        if deg:
            f = deg.get(src)
            if f is not None:
                base *= f
            f = deg.get(dst)
            if f is not None:
                base *= f
        arrive = send_done + base \
            + ((x ^ (x >> 31)) & _U64) * self._jit_scale
        # per-link FIFO delivery (TCP semantics): messages on one connection
        # never reorder, which real protocol implementations rely on.
        last = rec[1]
        if arrive < last + 1e-9:
            arrive = last + 1e-9
        rec[1] = arrive
        self.stats_messages += 1
        log = self._post_log
        if log is not None:
            log.append(now)
        fo = self._foreign
        if fo is not None and fo[dst]:
            self.outbox.append((arrive, msg))
            return
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (arrive, seq, _ARRIVE, msg))

    def set_timer(self, node_id: int, delay: float, name: str,
                  payload: dict) -> TimerHandle:
        handle = TimerHandle()
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (self.now + delay, seq, _TIMER,
                                    (node_id, name, payload, handle)))
        return handle

    def crash(self, node_id: int, at: float) -> None:
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (at, seq, _CRASH, node_id))

    def recover(self, node_id: int, at: float) -> None:
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (at, seq, _RECOVER, node_id))

    # -- link faults (repro_torch.faults: nemesis fault injection) ------------------
    #
    # Faults are heap events like crash/recover, so a fault schedule is part
    # of the deterministic event stream: same seed + schedule => identical
    # timing. Link cuts drop messages at POST time (a message already in
    # flight when the cut lands is delivered — packets in the pipe survive a
    # partition); degrade inflates one-way delays of every message posted
    # while the factor is active.

    def _schedule_fault(self, at: float, action: str, payload) -> None:
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (at, seq, _FAULT, (action, payload)))

    def schedule_dynamic(self, at: float, thunk) -> None:
        """Schedule a deferred fault action: ``thunk(engine, t)`` runs at
        ``at`` against live engine state. This is how symbolic fault
        selectors ("top_weight", "median", ...) bind to the weight view
        in force when the event fires, not the static seed ranking."""
        self._schedule_fault(at, "dyn", thunk)

    def note_weight_install(self, t: float, epoch: int, ranking: list,
                            by: int) -> None:
        """Record a weight-view install (called by the installing
        replica's ReassignManager alongside its broadcast)."""
        if epoch > self.weight_view[0]:
            self.weight_view = (epoch, list(ranking))
        self.weight_installs.append((t, epoch, tuple(ranking), by))
        tr = self.tracer
        if tr is not None:
            tr.ev("weight_install", t, by, epoch,
                  ",".join(map(str, ranking)))

    def cut_links(self, pairs, at: float) -> None:
        """From time ``at``, drop every message posted on the directed
        (src, dst) links in ``pairs`` until :meth:`restore_links`."""
        self._schedule_fault(at, "cut",
                             frozenset((s << 24) | d for s, d in pairs))

    def restore_links(self, pairs=None, at: float = 0.0) -> None:
        """Heal the given directed links at ``at`` (all links if None)."""
        keys = None if pairs is None else \
            frozenset((s << 24) | d for s, d in pairs)
        self._schedule_fault(at, "restore", keys)

    def set_degrade(self, node: int, factor: float, at: float) -> None:
        """From ``at``, multiply one-way network delays of messages sent
        to or from ``node`` by ``factor`` (1.0 heals). Both endpoints
        degraded compounds — matching a shared congested uplink."""
        self._schedule_fault(at, "degrade", (node, factor))

    def _apply_fault(self, action: str, payload) -> None:
        if action == "cut":
            self._cut.update(payload)
        elif action == "restore":
            if payload is None:
                self._cut.clear()
            else:
                self._cut.difference_update(payload)
        else:  # "degrade"
            node, factor = payload
            if factor is not None and factor != 1.0:
                self._degrade[node] = factor
            else:
                self._degrade.pop(node, None)

    # -- run ------------------------------------------------------------------

    def run(self, until: float = float("inf"),
            stop: Optional[Callable[[], bool]] = None,
            max_events: int = 50_000_000,
            stop_when_clients_done: Optional[int] = None) -> float:
        """Event loop. ``now`` is strictly monotone: message arrival and
        message processing-completion are separate events, so a busy node's
        deferred processing never drags the global clock backwards. The
        idle-path collapse below preserves that contract: the inline
        handler runs at the processing-completion time, and only when no
        other event is scheduled before it."""
        if not self._tables_ok:
            self._build_tables()
        heap = self._heap
        pop = heapq.heappop
        push = heapq.heappush
        busy = self._busy
        nodes = self._nodes
        recv_c = self._recv_c
        parse_c = self._parse_c
        byte_parse = self._byte_parse
        crashed = self.crashed
        events = self.stats_events
        collapsed = self.stats_collapsed
        peak = self.heap_peak
        t_wall = time.perf_counter()
        gc_was_on = self.GC_PAUSE and gc.isenabled()
        if gc_was_on:
            gc.disable()
        try:
            done_target = stop_when_clients_done
            while heap:
                # stop checks: the counter compare is the hot default
                # (runner experiments); the callable is the general hook
                if done_target is not None:
                    if self.clients_done >= done_target:
                        break
                elif stop is not None and stop():
                    break
                if not (events & 255) and len(heap) > peak:
                    peak = len(heap)        # sampled (cheap, ~exact)
                t, eseq, kind, item = pop(heap)
                if t > until:
                    # window-exact: the event stays queued for the next
                    # run() call (parallel engines advance in windows)
                    push(heap, (t, eseq, kind, item))
                    self.now = until
                    break
                self.now = t
                events += 1
                if events > max_events:
                    raise RuntimeError("simulation event budget exceeded")
                if kind == _ARRIVE:
                    msg: Msg = item
                    dst = msg.dst
                    if not crashed or dst not in crashed:
                        # FIFO service: start when the node frees up
                        bt = busy[dst]
                        done = (t if t >= bt else bt) + recv_c[dst] \
                            + parse_c[dst] * msg.size_ops
                        nb = msg.size_bytes
                        if nb:      # sizeless path: arithmetic untouched
                            done += byte_parse[dst] * nb
                        busy[dst] = done
                        if done <= until and (not heap
                                              or heap[0][0] > done):
                            # destination idle path: nothing can happen
                            # before processing completes — run the
                            # handler inline at its completion time
                            self.now = done
                            events += 1
                            collapsed += 1
                            nodes[dst].on_message(msg, done)
                        else:
                            seq = self._seq
                            self._seq = seq + 1
                            push(heap, (done, seq, _PROC, msg))
                elif kind == _PROC:
                    # handler runs at processing completion time
                    msg = item
                    if not crashed or msg.dst not in crashed:
                        nodes[msg.dst].on_message(msg, t)
                elif kind == _TIMER:
                    node_id, name, payload, handle = item
                    if handle.alive and node_id not in crashed:
                        nodes[node_id].on_timer(name, payload, t)
                elif kind == _CRASH:
                    crashed.add(item)
                    tr = self.tracer
                    if tr is not None:
                        tr.ev("fault", t, item, "crash", 0.0)
                elif kind == _RECOVER:
                    crashed.discard(item)
                    busy[item] = t
                    tr = self.tracer
                    if tr is not None:
                        tr.ev("fault", t, item, "recover", 0.0)
                    hook = getattr(self.nodes.get(item), "on_recover", None)
                    if hook is not None:
                        hook(t)
                else:  # _FAULT
                    action, payload = item
                    if action == "dyn":
                        # deferred fault: resolve + apply against live
                        # state (the thunk does its own trace annotation)
                        payload(self, t)
                        continue
                    self._apply_fault(*item)
                    tr = self.tracer
                    if tr is not None:
                        if action == "degrade":
                            tr.ev("fault", t, payload[0], "degrade",
                                  float(payload[1]
                                        if payload[1] is not None else 1.0))
                        else:   # cut / restore: annotate affected link count
                            tr.ev("fault", t, -1, action,
                                  float(len(payload)
                                        if payload is not None else -1))
        finally:
            if gc_was_on:
                gc.enable()
            self.stats_events = events
            self.stats_collapsed = collapsed
            self.heap_peak = peak
            self.wall_s += time.perf_counter() - t_wall
        return self.now


class Simulation(EventEngine):
    """One engine hosting the entire deployment: the single-heap
    simulation every flat experiment runs on, and the ``workers=1``
    oracle the parallel sharded runner is pinned bit-identical to."""


# ---------------------------------------------------------------------------
# Open-loop clients (paper §5.1: max 5 in-flight batches)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    """The paper-mix workload generator (§5.1 default: 90/5/5
    independent/common/hot). This is the reference implementation of the
    generator contract every Scenario workload satisfies (see
    :mod:`repro_torch.scenario.workloads`): ``sample_object`` + ``sample_kind``
    each consume a fixed number of rng draws per op, and the default
    mix's draw sequence is contractual — the Scenario golden pins assert
    bit-identical runs across refactors."""

    p_independent: float = 0.90
    p_common: float = 0.05
    p_hot: float = 0.05
    n_common_objects: int = 64
    n_hot_objects: int = 4
    reads_fraction: float = 0.0
    # value-size axis (repro_torch.coding / per-byte cost model). "" keeps ops
    # sizeless — zero extra rng draws, so the classic mixes' draw streams
    # (and every golden pin) are untouched. "fixed" = size_small always;
    # "bimodal" = size_large w.p. p_large else size_small; "lognormal" =
    # size_small-median heavy tail with shape size_sigma.
    size_dist: str = ""
    size_small: int = 256
    size_large: int = 1 << 20
    p_large: float = 0.1
    size_sigma: float = 1.5

    def __post_init__(self):
        if self.size_dist not in ("", "fixed", "bimodal", "lognormal"):
            raise ValueError(f"unknown size_dist {self.size_dist!r} "
                             "(want '', 'fixed', 'bimodal' or 'lognormal')")

    @property
    def sizes_on(self) -> bool:
        return bool(self.size_dist)

    def sample_size(self, client: int, rng: np.random.Generator) -> int:
        d = self.size_dist
        if d == "bimodal":
            return (self.size_large if rng.random() < self.p_large
                    else self.size_small)
        if d == "lognormal":
            return max(1, int(self.size_small
                              * rng.lognormal(0.0, self.size_sigma)))
        return self.size_small          # "fixed"

    def sample_object(self, client: int, rng: np.random.Generator) -> int:
        # index draws use random()*N (uniform up to fp granularity): it is
        # ~2.5x cheaper per call than Generator.integers and this runs
        # once per generated op
        u = rng.random()
        if u < self.p_independent:
            # private namespace per client, wide enough that birthday
            # self-collisions stay negligible even at batch 4000
            return (client << 24) | int(rng.random() * (1 << 20))
        if u < self.p_independent + self.p_common:
            return (1 << 60) | int(rng.random() * self.n_common_objects)
        return (1 << 61) | int(rng.random() * self.n_hot_objects)

    def sample_kind(self, client: int, rng: np.random.Generator) -> str:
        # always one draw, even at reads_fraction=0: sweeping the read
        # fraction must not re-key the object stream
        return "r" if rng.random() < self.reads_fraction else "w"


class Client(Node):
    """Open-loop batch generator with bounded in-flight *operations*.

    Flow control is per-op (``max_inflight * batch_size`` op slots), so a
    few slow-path stragglers consume only their own slots instead of
    gating all submission — this is what "open-loop with a max in-flight
    cap" (§5.1) means. Unacked batches are retried against a different
    replica after ``RETRY`` seconds (idempotent op ids make this safe),
    which is how clients fail over from a crashed coordinator/leader.
    Retry timers are cancelled the moment a batch fully acks, so at high
    throughput the heap is not full of doomed-to-no-op timer events.
    """

    RETRY = 0.25

    def __init__(self, node_id: int, sim: Simulation, *, batch_size: int,
                 max_inflight: int, workload: Workload,
                 target_fn: Callable[[int], int], total_batches: int,
                 value_seed: int = 0):
        super().__init__(node_id, sim)
        self.batch_size = batch_size
        self.max_inflight_ops = max_inflight * batch_size
        self.workload = workload
        # open-loop arrival shaping (repro_torch.scenario.workloads contract):
        # absent on the classic mixes, so the default submit loop is
        # untouched; when present, _maybe_submit idles between bursts
        self._gap_fn = getattr(workload, "submit_gap", None)
        # value-size hook (repro_torch.scenario.workloads contract): only bound
        # when the generator declares sizes_on, so classic mixes draw
        # nothing extra and stay bit-identical
        self._size_fn = (workload.sample_size
                         if getattr(workload, "sizes_on", False) else None)
        self._gap_paid = -1          # last batch index whose gap was paid
        self._gap_wait = False       # gap timer pending: acks must not
                                     # sneak submissions past the idle
        self.target_fn = target_fn   # attempt counter -> replica to contact
        self.total = total_batches
        self.submitted = 0
        self.completed_ops = 0
        self.inflight_ops = 0
        self.rng = np.random.default_rng((sim.seed << 16) ^ node_id)
        self.ops: List[Op] = []      # every op this client created
        self._open: Dict[int, dict] = {}   # batch_id -> {ops, acked, attempt}
        self._next_op = 0
        self._next_batch = 0
        self.value_seed = value_seed
        self._done = False
        self.done_time = -1.0        # sim time of the completing ack
        self._suspect: Dict[int, float] = {}   # replica -> suspicion expiry
        # client-global ack dedup: an op may be credited more than once
        # (retries reaching two coordinators; in sharded runs the old and
        # new owner across a migration, under different sub-batch ids) —
        # flow-control accounting must count each op exactly once
        self._acked: set = set()

    def _pick_target(self, k: int) -> int:
        t = self.target_fn(k)
        if not self._suspect:
            return t
        for _ in range(self.sim.n):
            if self._suspect.get(t, 0.0) < self.sim.now:
                return t
            t = (t + 1) % self.sim.n
        return t

    def start(self) -> None:
        self._maybe_submit()

    def _sample_object(self) -> int:
        """Object-choice hook (ShardClient overrides with locality modes)."""
        return self.workload.sample_object(self.node_id, self.rng)

    def _make_batch(self) -> List[Op]:
        ops = []
        rng = self.rng
        kind_of = self.workload.sample_kind
        now = self.sim.now
        node_id = self.node_id
        value_seed = self.value_seed
        size_fn = self._size_fn
        for _ in range(self.batch_size):
            oid = (node_id << 40) | self._next_op
            self._next_op += 1
            obj = self._sample_object()
            kind = kind_of(node_id, rng)
            op = Op(oid, node_id, obj, kind, oid ^ value_seed, now)
            if size_fn is not None:
                op.size = size_fn(node_id, rng)
            ops.append(op)
        return ops

    def _ops_bytes(self, ops: List[Op]) -> int:
        """Wire bytes of a batch (0 without a size hook: the sizeless
        path never sums)."""
        if self._size_fn is None:
            return 0
        return sum(op.size for op in ops)

    def _new_batch_id(self) -> int:
        bid = (self.node_id << 32) | self._next_batch
        self._next_batch += 1
        return bid

    def _dispatch(self, ops: List[Op]) -> None:
        """Routing hook (ShardClient splits per owning group instead)."""
        bid = self._new_batch_id()
        target = self._pick_target(self.submitted)
        rec = {"ops": ops, "attempt": 0, "target": target,
               "unacked": {op.op_id for op in ops}}
        self._open[bid] = rec
        self.send(target, "client_req",
                  {"batch_id": bid, "ops": ops}, size_ops=len(ops),
                  size_bytes=self._ops_bytes(ops))
        rec["timer"] = self.set_timer(self.RETRY, "client_retry",
                                      {"bid": bid})

    def _maybe_submit(self) -> None:
        gap_fn = self._gap_fn
        while (self.submitted < self.total
               and self.inflight_ops + self.batch_size
               <= self.max_inflight_ops):
            if gap_fn is not None:
                if self._gap_wait:
                    return
                if self.submitted != self._gap_paid:
                    g = gap_fn(self.node_id, self.submitted, self.rng)
                    self._gap_paid = self.submitted
                    if g > 0.0:
                        # open-loop burst gap: resume via timer; the paid
                        # marker keeps the resumed call from re-charging it
                        self._gap_wait = True
                        self.set_timer(g, "submit_gap", {})
                        return
            ops = self._make_batch()
            self.ops.extend(ops)
            self.submitted += 1
            self.inflight_ops += self.batch_size
            self._dispatch(ops)

    def _close_batch(self, bid: int, rec: dict) -> None:
        self._open.pop(bid, None)
        timer = rec.get("timer")
        if timer is not None:
            timer.cancel()

    def on_client_reply(self, msg: Msg, now: float) -> None:
        bid = msg.payload["batch_id"]
        rec = self._open.get(bid)
        if rec is None:
            return                       # duplicate ack after retry
        if "op_ids" in msg.payload:
            ids = set(msg.payload["op_ids"])
        else:                            # whole-batch ack (EPaxos finish)
            ids = {op.op_id for op in rec["ops"]}
        acked = self._acked
        fresh = ids - acked
        acked |= fresh
        self.inflight_ops -= len(fresh)
        self.completed_ops += len(fresh)
        unacked = rec["unacked"]
        unacked.difference_update(ids)
        if not unacked:
            self._close_batch(bid, rec)
        if not self._done and self.completed_ops >= \
                self.total * self.batch_size:
            self._done = True
            self.done_time = now
            self.sim.clients_done += 1
        self._maybe_submit()

    def _retry_target(self, rec: dict) -> int:
        """Pick a different replica for a retried batch (ShardClient
        overrides to stay inside the owning group's id block)."""
        target = self._pick_target(self.submitted + rec["attempt"] * 7 + 1)
        if target == rec["target"]:
            target = (target + 1) % self.sim.n
        return target

    def on_timer(self, name: str, payload: dict, now: float) -> None:
        if name == "submit_gap":
            self._gap_wait = False
            self._maybe_submit()
            return
        rec = self._open.get(payload["bid"])
        if rec is None:
            return
        rec["attempt"] += 1
        # the unresponsive target is suspected for a while: new batches
        # fail over immediately instead of paying a retry timeout each.
        # Prune expired suspicions on the way in — over a long run with
        # transient timeouts this map otherwise only ever grows.
        if self._suspect:
            self._suspect = {r: exp for r, exp in self._suspect.items()
                             if exp >= now}
        self._suspect[rec["target"]] = now + self.RETRY * 16
        rec["target"] = self._retry_target(rec)
        self.send(rec["target"], "client_req",
                  {"batch_id": payload["bid"], "ops": rec["ops"]},
                  size_ops=len(rec["ops"]),
                  size_bytes=self._ops_bytes(rec["ops"]))
        rec["timer"] = self.set_timer(self.RETRY * min(4, 1 + rec["attempt"]),
                                      "client_retry", payload)

    def done(self) -> bool:
        return self.completed_ops >= self.total * self.batch_size


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    protocol: str
    n_replicas: int
    n_clients: int
    batch_size: int
    committed_ops: int
    makespan_s: float
    throughput_tx_s: float
    latency_avg_ms: float
    latency_p50_ms: float
    latency_p99_ms: float
    fast_path_frac: float
    messages: int
    # fraction of committed reads served locally under a read lease
    # (repro_torch.core.leases); 0.0 when leases are off or the workload is
    # write-only. Deterministic, so part of the same-seed contract.
    read_local_frac: float = 0.0
    # fraction of committed ops whose value shipped erasure-striped
    # (repro_torch.coding); 0.0 with coding off. Deterministic.
    striped_frac: float = 0.0
    # engine telemetry (wall-clock side — excluded from determinism checks)
    events: int = 0
    events_per_sec: float = 0.0
    wall_s: float = 0.0
    heap_peak: int = 0
    # idle-path arrive+proc pairs run inline — deterministic for a single
    # engine (part of the same-seed contract), but heap-composition
    # dependent, so the sharded serial<->parallel contract treats its
    # aggregate as telemetry (see repro_torch.shard TELEMETRY_FIELDS)
    collapsed: int = 0
    # commit_log entries left after matching client ops (ops that never
    # reached a client ack path); the log itself is cleared at run end
    commit_log_residual: int = 0
    # weight-view install log (repro_torch.core.reassign): (t, epoch, ranking,
    # installer) per install; empty when the knob is off or no fault
    # evidence ever confirmed. Deterministic given seed + schedule.
    weight_epochs: list = dataclasses.field(default_factory=list)
    # client invoke/response history (repro_torch.verify.HistoryEntry records),
    # captured when RunConfig.capture_history is set or a fault schedule is
    # active; deterministic given seed + schedule, unlike the telemetry
    history: list = dataclasses.field(default_factory=list, repr=False)
    # canonical span trace (repro_torch.obs), populated when the Observability
    # spec enables tracing; deterministic given seed + schedule
    trace: list = dataclasses.field(default_factory=list, repr=False)

    def row(self) -> str:
        return (f"{self.protocol},{self.n_replicas},{self.n_clients},"
                f"{self.batch_size},{self.committed_ops},"
                f"{self.throughput_tx_s:.0f},{self.latency_avg_ms:.3f},"
                f"{self.latency_p50_ms:.3f},{self.latency_p99_ms:.3f},"
                f"{self.fast_path_frac:.3f},{self.messages}")


def collect_metrics(protocol: str, sim: Simulation, clients: List[Client],
                    batch_size: int, t_start: float) -> RunResult:
    ops = [op for c in clients for op in c.ops if op.commit_time >= 0]
    lat = np.array([op.commit_time - op.submit_time for op in ops]) * 1e3
    fast = sum(1 for op in ops if op.path == "fast")
    reads = local = 0
    for op in ops:
        if op.kind == "r":
            reads += 1
            if op.path == "local":
                local += 1
    makespan = max(sim.now - t_start, 1e-9)
    return RunResult(
        protocol=protocol, n_replicas=sim.n, n_clients=len(clients),
        batch_size=batch_size, committed_ops=len(ops), makespan_s=makespan,
        throughput_tx_s=len(ops) / makespan,
        latency_avg_ms=float(lat.mean()) if len(lat) else float("nan"),
        latency_p50_ms=float(np.percentile(lat, 50)) if len(lat) else float("nan"),
        latency_p99_ms=float(np.percentile(lat, 99)) if len(lat) else float("nan"),
        fast_path_frac=fast / len(ops) if ops else 0.0,
        read_local_frac=local / reads if reads else 0.0,
        striped_frac=sim.striped_ops / len(ops) if ops else 0.0,
        messages=sim.stats_messages,
        events=sim.stats_events,
        events_per_sec=(sim.stats_events / sim.wall_s
                        if sim.wall_s > 0 else 0.0),
        wall_s=sim.wall_s,
        heap_peak=sim.heap_peak,
        collapsed=sim.stats_collapsed,
        weight_epochs=list(sim.weight_installs))
