"""One served replica per process: ``python -m repro_torch.transport.node_runner``.

The runner builds a :class:`repro_torch.transport.net.NetContext`, constructs
the registry protocol class against it exactly as the scenario builder
does against a :class:`Simulation`, listens on an ephemeral localhost
port, and dials a :class:`PeerChannel` to every other replica. Discovery
is file-based: each runner writes ``node-<id>.port`` into the shared run
directory (atomically, tmp + rename) and peers re-read the file on every
dial attempt, so a replica that restarts on a fresh port is found
without any control plane.

Inbound connections self-identify with a hello frame: ids below ``n``
are replicas (frames are protocol messages), ids at or above ``n`` are
clients — their socket is also registered as the reply route
(:meth:`NetContext.register_client_writer`).

On SIGTERM/SIGINT the runner dumps its raw tracer events to
``node-<id>.trace.jsonl`` and channel/engine counters to
``node-<id>.stats.json`` before exiting; the launcher merges the per-node
traces through the same ``canonical_events`` path simulator runs use.

``--recover`` marks a restarted process: after boot it enters the
protocol's crash-recovery flow (state transfer from a live peer) instead
of claiming fresh state — the same ``on_recover`` hook the simulator's
``_RECOVER`` event drives.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
from pathlib import Path

from repro_torch.scenario.registry import protocol_class
from repro_torch.transport.codec import decode_body, decode_hello, read_frame
from repro_torch.transport.net import NetContext, PeerChannel


def port_file(run_dir: Path, node_id: int) -> Path:
    return run_dir / f"node-{node_id}.port"


def write_port_file(run_dir: Path, node_id: int, port: int) -> None:
    tmp = run_dir / f".node-{node_id}.port.tmp"
    tmp.write_text(str(port))
    os.replace(tmp, port_file(run_dir, node_id))


def read_addr(run_dir: Path, node_id: int):
    """Fresh port lookup (called per dial attempt — restarts move ports)."""
    try:
        return ("127.0.0.1", int(port_file(run_dir, node_id).read_text()))
    except (FileNotFoundError, ValueError):
        return None


async def _serve_connection(ctx: NetContext, reader, writer) -> None:
    try:
        peer_id = decode_hello(await read_frame(reader))
    except (asyncio.IncompleteReadError, ConnectionError, OSError,
            ValueError, KeyError):
        writer.close()
        return
    if peer_id >= ctx.n:
        ctx.register_client_writer(peer_id, writer)
    try:
        while True:
            msg = decode_body(await read_frame(reader))
            ctx.deliver(msg)
    except (asyncio.IncompleteReadError, ConnectionError, OSError,
            ValueError):
        pass
    finally:
        writer.close()


async def serve(args) -> None:
    run_dir = Path(args.run_dir)
    ctx = NetContext(args.node_id, args.n, epoch=args.epoch, seed=args.seed)
    if args.trace:
        from repro_torch.obs.spans import Tracer
        ctx.tracer = Tracer(sample_every=args.sample_every)
    cls = protocol_class(args.protocol)
    t = max(1, min(args.t_fail, (args.n - 1) // 2))
    replica = cls(args.node_id, ctx, t_fail=t,
                  group_cap=max(args.batch_size, 1))
    # failure-detector timescale: the class constants assume the
    # simulator's perfectly fair scheduler; real processes on a loaded
    # host see multi-hundred-ms event-loop stalls (GC, CPU contention,
    # cold page cache), and a 45 ms window turns every stall into a
    # spurious all-isolated episode. Instance overrides only — the
    # simulator path never sees them.
    replica.HB_INTERVAL = replica.HB_INTERVAL * args.hb_scale
    replica.HB_TIMEOUT = replica.HB_TIMEOUT * args.hb_scale
    ctx.add_node(replica)

    server = await asyncio.start_server(
        lambda r, w: _serve_connection(ctx, r, w), "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    write_port_file(run_dir, args.node_id, port)

    channels = []
    for j in range(args.n):
        if j == args.node_id:
            continue
        chan = PeerChannel(args.node_id, j,
                           lambda j=j: read_addr(run_dir, j),
                           max_queue=args.max_queue, reorder=args.reorder)
        ctx.register_peer(j, chan.send)
        channels.append(chan)

    # boot barrier: hold heartbeats until every peer has published a
    # port (interpreter start-up skew is seconds — far beyond the
    # failure detector's window; a fresh boot must not open with every
    # replica declaring isolation). A restart skips the wait: its peers
    # are already up and it enters recovery mode anyway.
    if not args.recover:
        while any(read_addr(run_dir, j) is None for j in range(args.n)):
            await asyncio.sleep(0.02)
    replica.start_heartbeats()
    if args.recover:
        replica.on_recover(ctx.now)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()

    server.close()
    for chan in channels:
        await chan.close()
    _dump(ctx, replica, channels, run_dir, args.node_id)


def _dump(ctx: NetContext, replica, channels, run_dir: Path,
          node_id: int) -> None:
    if ctx.tracer is not None:
        with open(run_dir / f"node-{node_id}.trace.jsonl", "w") as f:
            for ev in ctx.tracer.events:
                f.write(json.dumps(ev) + "\n")
    stats = {
        "node": node_id,
        "now": ctx.now,
        "messages": ctx.stats_messages,
        "dropped_no_route": ctx.dropped_no_route,
        "applied": replica.rsm.apply_count,
        "store_size": len(replica.rsm.store),
        "commit_log": len(ctx.commit_log),
        "read_results": len(ctx.read_results),
        "recovering": replica.recovering,
        "isolated": replica._isolated,
        "channels": [c.stats() for c in channels],
    }
    tmp = run_dir / f".node-{node_id}.stats.json.tmp"
    tmp.write_text(json.dumps(stats, indent=1))
    os.replace(tmp, run_dir / f"node-{node_id}.stats.json")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--node-id", type=int, required=True)
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--protocol", default="woc")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epoch", type=float, required=True,
                   help="cluster-wide time.time() origin: every process "
                        "reports 'now' relative to it, so merged spans "
                        "and histories share one timeline")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--t-fail", type=int, default=1)
    p.add_argument("--max-queue", type=int, default=512)
    p.add_argument("--hb-scale", type=float, default=10.0,
                   help="failure-detector timescale multiplier over the "
                        "simulator-tuned heartbeat constants (wall-clock "
                        "schedulers stall; 10x puts the suspicion window "
                        "at ~450 ms)")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--sample-every", type=int, default=1)
    p.add_argument("--reorder", action="store_true",
                   help="MUTATION TWIN: displace every Nth outbound frame "
                        "past later ones per peer (tests only — must fail "
                        "the linearizability checker)")
    p.add_argument("--recover", action="store_true",
                   help="restarted process: resync state from a live "
                        "peer before participating")
    asyncio.run(serve(p.parse_args(argv)))


if __name__ == "__main__":
    main()
