"""Asyncio transport core: the engine facade + per-peer outbound channels.

:class:`NetContext` implements the slice of the
:class:`repro_torch.core.simulator.EventEngine` surface that replicas actually
touch (``post`` / ``set_timer`` / ``busy`` / ``now`` / ``n`` / ``costs``
/ ``tracer`` / ``commit_log`` / ...), so the protocol classes run over
real sockets **unmodified** — the same post/deliver contract, a
different substrate:

  * ``now`` is wall-clock seconds since a cluster-wide epoch the
    launcher hands every process (same host, same ``time.time`` domain),
    so spans and histories from different processes share one timeline;
  * timers are ``loop.call_later`` (monotonic) behind the same
    :class:`TimerHandle` interface (``cancel()`` / ``alive``) the
    simulator returns;
  * ``post`` routes by destination id: loopback via ``call_soon`` (a
    handler's sends must not recurse into handlers, exactly like the
    simulator's event queue), replicas via their :class:`PeerChannel`,
    clients via the inbound socket they dialed in on;
  * ``busy`` is a no-op — real CPU time charges itself.

Clock-domain caveat: ``time.time`` can step (NTP); on a single host the
histories this transport records are causally ordered by the sockets
themselves, and the linearizability checker consumes invoke/response
*intervals*, which only widen under small steps. Cross-host deployments
would need a real clock-sync story; this transport targets loopback.

Long-run memory contract (the soak assertions in tests/test_torch_transport.py
pin this): every per-peer table in this module is bounded —
``PeerChannel`` queues cap at ``max_queue`` frames (drop-oldest; the
protocol's retransmit/retry layers re-drive), reconnect backoff is
capped, and the ``read_results`` / ``commit_log`` reply-enrichment
tables prune FIFO above a fixed cap (a retried op older than 64k
credits would lose its path stamp in the reply — it keeps its ack).
Nothing here grows with the op count of the run except the tracer,
which is explicitly sampled.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from repro_torch.core.simulator import CostModel, Msg
from repro_torch.transport.codec import encode_hello, encode_msg

READ_RESULTS_CAP = 65536      # reply-enrichment table bound (FIFO prune)
WRITE_BUF_LIMIT = 8 * 1024 * 1024   # per-client-socket backpressure bound


class TransportTimer:
    """``TimerHandle``-compatible wrapper over ``loop.call_later``."""

    __slots__ = ("alive", "_handle")

    def __init__(self):
        self.alive = True
        self._handle = None

    def cancel(self) -> None:
        self.alive = False
        if self._handle is not None:
            self._handle.cancel()


class NetContext:
    """One node process's engine facade (see module docstring)."""

    def __init__(self, node_id: int, n: int, *, epoch: float,
                 costs: Optional[CostModel] = None, seed: int = 0):
        self.local_id = node_id
        self.n = n
        self.costs = costs or CostModel()
        self.seed = seed
        self._epoch = epoch
        # engine-surface state the protocol layer reads
        self.crashed: set = set()
        self.clients_done = 0
        self.commit_log: Dict[int, tuple] = {}
        self.tracer = None
        self.weight_view: tuple = (0, None)
        self.weight_installs: List[tuple] = []
        # transport-only: read results recorded at apply time (the sim
        # shares Op objects by reference so the client sees the result
        # for free; over sockets ops are copies and the value must ride
        # the client_reply explicitly — see protocol_base apply sites)
        self.read_results: Dict[int, object] = {}
        self._node = None
        self._senders: Dict[int, Callable[[bytes], None]] = {}
        self.stats_messages = 0
        self.dropped_no_route = 0      # sends with no live route (peer
                                       # down / client gone): the
                                       # transport twin of a cut link

    # -- engine surface ------------------------------------------------------

    @property
    def now(self) -> float:
        return time.time() - self._epoch

    def add_node(self, node) -> None:
        assert node.node_id == self.local_id
        self._node = node

    def replicas(self) -> List[int]:
        return list(range(self.n))

    def busy(self, node_id: int, seconds: float) -> None:
        pass                           # real CPU time charges itself

    def set_timer(self, node_id: int, delay: float, name: str,
                  payload: dict) -> TransportTimer:
        handle = TransportTimer()

        def fire() -> None:
            if handle.alive:
                handle.alive = False
                self._node.on_timer(name, payload, self.now)

        handle._handle = asyncio.get_running_loop().call_later(delay, fire)
        return handle

    def note_weight_install(self, t: float, epoch: int, ranking: list,
                            by: int) -> None:
        if epoch > self.weight_view[0]:
            self.weight_view = (epoch, list(ranking))
        self.weight_installs.append((t, epoch, tuple(ranking), by))
        tr = self.tracer
        if tr is not None:
            tr.ev("weight_install", t, by, epoch,
                  ",".join(map(str, ranking)))

    def post(self, msg: Msg) -> None:
        self.stats_messages += 1
        if msg.dst == self.local_id:
            # loopback: defer like the simulator's event queue — a
            # handler's sends to self must not reenter handlers inline
            asyncio.get_running_loop().call_soon(self._deliver_local, msg)
            return
        if msg.kind == "client_reply":
            self._enrich_reply(msg.payload)
        sender = self._senders.get(msg.dst)
        if sender is None:
            self.dropped_no_route += 1
            return
        sender(encode_msg(msg))

    # -- transport plumbing --------------------------------------------------

    def _deliver_local(self, msg: Msg) -> None:
        self._node.on_message(msg, self.now)

    def deliver(self, msg: Msg) -> None:
        """Inbound frame -> protocol handler (called by the node
        runner's connection reader)."""
        self._node.on_message(msg, self.now)

    def _enrich_reply(self, payload: dict) -> None:
        """Attach read results + commit paths to an outgoing credit
        message. Values are looked up (not popped): a retried op may be
        credited twice and both replies should carry the answer; the
        table is FIFO-pruned above a fixed cap instead."""
        rr = self.read_results
        commit_log = self.commit_log
        results = {}
        paths = {}
        for op_id in payload.get("op_ids", ()):
            if op_id in rr:
                results[op_id] = rr[op_id]
            stamp = commit_log.get(op_id)
            if stamp is not None:
                paths[op_id] = [stamp[0], stamp[1]]   # (commit_time, path)
        if results:
            payload["results"] = results
        if paths:
            payload["paths"] = paths
        if len(rr) > READ_RESULTS_CAP:
            drop = len(rr) - READ_RESULTS_CAP
            for k in list(rr)[:drop]:
                del rr[k]
        if len(commit_log) > READ_RESULTS_CAP:
            drop = len(commit_log) - READ_RESULTS_CAP
            for k in list(commit_log)[:drop]:
                del commit_log[k]

    def register_peer(self, peer_id: int,
                      sender: Callable[[bytes], None]) -> None:
        self._senders[peer_id] = sender

    def register_client_writer(self, client_id: int,
                               writer: asyncio.StreamWriter) -> None:
        """Replies to a client go back over the socket it dialed in on.
        Writes are bounded by the transport's write-buffer size: a stuck
        client drops replies (its retries re-drive) instead of growing
        the buffer without limit."""

        def send(data: bytes) -> None:
            transport = writer.transport
            if transport is None or transport.is_closing():
                self._senders.pop(client_id, None)
                self.dropped_no_route += 1
                return
            if transport.get_write_buffer_size() > WRITE_BUF_LIMIT:
                self.dropped_no_route += 1
                return
            writer.write(data)

        self._senders[client_id] = send

    def unregister(self, peer_id: int) -> None:
        self._senders.pop(peer_id, None)


class PeerChannel:
    """One outbound replica->replica connection: bounded queue, dial +
    reconnect with capped exponential backoff, optional frame-reorder
    mutation.

    The address is re-resolved through ``addr_fn`` on every dial so a
    peer that restarts on a fresh port is picked up without any control
    plane (the node runner's port files are the discovery mechanism).

    ``reorder=True`` is the MUTATION TWIN for tests: every
    ``REORDER_EVERY``-th frame on this channel is held back and released
    only after ``REORDER_SKIP`` later frames have been sent, breaking
    the per-link FIFO property real TCP gives. Displacement (not a mere
    adjacent swap) is required to hurt: the slow path's wire stream
    strictly alternates commit(k), propose(k+1), commit(k+1), so
    distance-1 swaps can never invert two commits of the same object —
    a held frame skipping many successors can. Consecutive slow
    instances carry no dependency edges between their own ops (deps
    only cover live fast ops), so a displaced commit applies out of
    order at the receiving replica and a read coordinated there returns
    a stale value. The displacement must also exceed the client
    concurrency width: a one-generation inversion swaps writes that
    were concurrently in flight — whose client intervals overlap — and
    the checker may legally reorder those; rolling the store back past
    a dozen frames (several committed generations) makes the stale
    value's overwriters strictly real-time-before any witnessing read.
    A transport with this bug must fail the linearizability checker —
    that is what makes the checker-on-real-histories pipeline
    trustworthy.
    """

    REORDER_EVERY = 4     # hold every 4th frame ...
    REORDER_SKIP = 12     # ... until 12 later frames have been sent

    def __init__(self, src: int, dst: int,
                 addr_fn: Callable[[], Optional[tuple]], *,
                 max_queue: int = 512, reorder: bool = False,
                 on_frame: Optional[Callable[[bytes], None]] = None):
        self.src = src
        self.dst = dst
        self.addr_fn = addr_fn
        self.max_queue = max_queue
        self.reorder = reorder
        self.on_frame = on_frame       # clients: replies ride this socket
        self._q: deque = deque()
        self._held: Optional[bytes] = None     # reorder twin: displaced frame
        self._held_skip = 0                    # frames left to jump over
        self._sent_ctr = 0                     # selects every Nth frame
        self._wake = asyncio.Event()
        self._closed = False
        # soak-visible stats: every one of these is bounded per the
        # module contract; queue_hwm <= max_queue is asserted in tests
        self.sent = 0
        self.dropped = 0
        self.reconnects = 0
        self.queue_hwm = 0
        self._task = asyncio.ensure_future(self._run())

    # -- send side (sync, called from protocol handlers) ---------------------

    def send(self, data: bytes) -> None:
        if self._closed:
            return
        if self.reorder:
            if self._held is not None:
                self._push(data)
                self._held_skip -= 1
                if self._held_skip <= 0:
                    held, self._held = self._held, None
                    self._push(held)       # displaced frame lands late
                return
            self._sent_ctr += 1
            if self._sent_ctr % self.REORDER_EVERY == 0:
                self._held = data
                self._held_skip = self.REORDER_SKIP
                return
        self._push(data)

    def _push(self, data: bytes) -> None:
        if len(self._q) >= self.max_queue:
            self._q.popleft()              # drop-oldest: retransmit
            self.dropped += 1              # timers / client retries
        self._q.append(data)               # re-drive consensus traffic
        if len(self._q) > self.queue_hwm:
            self.queue_hwm = len(self._q)
        self._wake.set()

    # -- connection loop -----------------------------------------------------

    async def _run(self) -> None:
        backoff = 0.05
        while not self._closed:
            addr = self.addr_fn()
            if addr is None:
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
                continue
            try:
                reader, writer = await asyncio.open_connection(*addr)
            except OSError:
                self.reconnects += 1
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
                continue
            backoff = 0.05
            writer.write(encode_hello(self.src))
            reader_task = None
            if self.on_frame is not None:
                reader_task = asyncio.ensure_future(
                    self._read_loop(reader, writer))
            try:
                while not self._closed:
                    if writer.transport.is_closing():
                        # asyncio swallows writes to a dead transport;
                        # surface it so the dial loop reconnects (the
                        # frames already handed over are lost — drop
                        # semantics, retries re-drive)
                        raise ConnectionResetError
                    if not self._q:
                        self._wake.clear()
                        try:           # bounded wait: the is_closing
                            await asyncio.wait_for(   # poll above must
                                self._wake.wait(), timeout=0.25)  # run
                        except asyncio.TimeoutError:  # on idle channels
                            # reorder twin: a frame held for a full idle
                            # window is released rather than held
                            # forever (liveness); releasing only after
                            # a quiet period — not the moment the queue
                            # drains — is what lets the displacement
                            # actually straddle later frames on a fast
                            # loopback link
                            if self._held is not None and not self._q:
                                self._push(self._held)
                                self._held = None
                        continue
                    writer.write(self._q.popleft())
                    self.sent += 1
                    if not self._q:
                        await writer.drain()
            except (ConnectionError, OSError):
                self.reconnects += 1
            finally:
                if reader_task is not None:
                    reader_task.cancel()
                writer.close()

    async def _read_loop(self, reader, writer) -> None:
        from repro_torch.transport.codec import read_frame
        try:
            while True:
                body = await read_frame(reader)
                self.on_frame(body)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                ValueError):
            # EOF / reset: kill the transport so the write side's
            # is_closing poll triggers the reconnect path
            writer.transport.abort()

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        self._task.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, Exception):
            pass

    def stats(self) -> dict:
        return {"dst": self.dst, "sent": self.sent, "dropped": self.dropped,
                "reconnects": self.reconnects, "queue_hwm": self.queue_hwm,
                "queue_len": len(self._q), "max_queue": self.max_queue}
