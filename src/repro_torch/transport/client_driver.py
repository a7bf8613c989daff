"""Closed-loop client process: ``python -m repro_torch.transport.client_driver``.

Reuses the simulator's :class:`repro_torch.core.simulator.Client` — flow
control, retry/failover, suspicion, ack dedup — against a
:class:`NetContext`, so the served system is driven by exactly the
client logic the paper-mix experiments use. One channel is dialed to
every replica (replies ride the same socket back; see the node runner's
hello handling), and retried batches walk replicas just like in the
simulator, which is what carries the workload across a crashed node.

The one served-path difference is result plumbing: in the simulator,
replicas stamp the client's own ``Op`` objects by reference; over
sockets ops are wire copies, so :class:`NetClient` stamps commit
time/path/read-result from the ``results``/``paths`` enrichment the
serving replica attaches to ``client_reply`` (see
``NetContext._enrich_reply``). A read acked without its result (pruned
server-side) is left unstamped and drops out of the history rather than
recording a value no replica returned.

On completion the process writes ``client-<gid>.history.jsonl`` — one
``[op_id, obj, kind, value, invoke, response, path]`` row per committed
op, in the same canonical (invoke, op_id) order ``capture_history``
uses — which the launcher feeds to the linearizability checker.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from pathlib import Path

from repro_torch.core.runner import client_target_fn
from repro_torch.core.rsm import history_from_ops
from repro_torch.core.simulator import Client, Workload
from repro_torch.transport.codec import decode_body
from repro_torch.transport.net import NetContext, PeerChannel
from repro_torch.transport.node_runner import read_addr


class NetClient(Client):
    """Simulator client + served-path result stamping (module docstring)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._op_index = {}

    def _dispatch(self, ops):
        for op in ops:
            self._op_index[op.op_id] = op
        super()._dispatch(ops)

    def on_client_reply(self, msg, now: float) -> None:
        payload = msg.payload
        results = payload.get("results") or {}
        paths = payload.get("paths") or {}
        for op_id in payload.get("op_ids", ()):
            op = self._op_index.get(op_id)
            if op is None or op.commit_time >= 0:
                continue               # duplicate ack: first stamp wins
            stamp = paths.get(op_id)
            if op.kind == "r" and op_id not in results:
                continue               # result pruned server-side: the
                                       # op stays out of the history
            if op.kind == "r":
                op.read_result = results[op_id]
            if stamp is not None:
                op.commit_time = stamp[0]
                op.path = stamp[1]
            else:
                # acked without a commit stamp: the client's ack receipt
                # is the (later, checker-sound) response time
                op.commit_time = now
                op.path = "ack"
        super().on_client_reply(msg, now)


async def drive(args) -> int:
    run_dir = Path(args.run_dir)
    gid = args.n + args.client_id
    ctx = NetContext(gid, args.n, epoch=args.epoch, seed=args.seed)

    workload = Workload(
        p_independent=max(0.0, 1.0 - args.p_common - args.p_hot),
        p_common=args.p_common, p_hot=args.p_hot,
        n_hot_objects=args.n_hot, reads_fraction=args.reads_fraction)
    client = NetClient(
        gid, ctx, batch_size=args.batch_size,
        max_inflight=args.max_inflight, workload=workload,
        target_fn=client_target_fn(args.protocol, args.client_id, args.n),
        total_batches=args.total_batches, value_seed=args.seed)
    ctx.add_node(client)

    def on_frame(body: bytes) -> None:
        client.on_message(decode_body(body), ctx.now)

    channels = []
    for j in range(args.n):
        chan = PeerChannel(gid, j, lambda j=j: read_addr(run_dir, j),
                           on_frame=on_frame)
        ctx.register_peer(j, chan.send)
        channels.append(chan)

    client.start()
    deadline = ctx.now + args.time_limit
    while not client.done() and ctx.now < deadline:
        await asyncio.sleep(0.02)
    done = client.done()

    for chan in channels:
        await chan.close()

    hist = history_from_ops(client.ops)
    hist.sort(key=lambda h: (h.invoke, h.op_id))
    path_of = {op.op_id: op.path for op in client.ops}
    tmp = run_dir / f".client-{gid}.history.jsonl.tmp"
    with open(tmp, "w") as f:
        for h in hist:
            f.write(json.dumps([h.op_id, h.obj, h.kind, h.value, h.invoke,
                                h.response, path_of.get(h.op_id, "")])
                    + "\n")
    os.replace(tmp, run_dir / f"client-{gid}.history.jsonl")
    stats = {"client": gid, "done": done,
             "completed_ops": client.completed_ops,
             "committed_in_history": len(hist),
             "channels": [c.stats() for c in channels]}
    (run_dir / f"client-{gid}.stats.json").write_text(json.dumps(stats))
    return 0 if done else 3


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--client-id", type=int, required=True,
                   help="0-based client index (global node id = n + this)")
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--protocol", default="woc")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epoch", type=float, required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-inflight", type=int, default=4)
    p.add_argument("--total-batches", type=int, default=50)
    p.add_argument("--reads-fraction", type=float, default=0.25)
    p.add_argument("--p-common", type=float, default=0.05)
    p.add_argument("--p-hot", type=float, default=0.05)
    p.add_argument("--n-hot", type=int, default=4)
    p.add_argument("--time-limit", type=float, default=60.0)
    sys.exit(asyncio.run(drive(p.parse_args(argv))))


if __name__ == "__main__":
    main()
