"""Asyncio socket transport: the served (non-simulated) substrate.

The protocol stack in :mod:`repro_torch.core` is written against the
simulator's post/deliver contract; this package implements that same
contract over real localhost sockets — length-prefixed msgpack/JSON
frames, per-peer outbound queues with reconnect/backoff, wall-clock
timers — so the identical replica classes serve real concurrent client
processes. The simulator stays the deterministic oracle; this is the
production artifact.

Entry points:

  * :func:`run_served` / :class:`ClusterConfig` — one-call harness:
    boot a loopback cluster, drive it with client processes, verify the
    captured history with ``repro_torch.verify``, aggregate obs artifacts.
  * ``python -m repro_torch.transport.node_runner`` — one replica process.
  * ``python -m repro_torch.transport.client_driver`` — one client process.
"""

from repro_torch.transport.launcher import (ClusterConfig, ClusterLauncher,
                                      ServedArtifacts, ServedResult,
                                      load_histories, run_served)

__all__ = [
    "ClusterConfig", "ClusterLauncher", "ServedArtifacts", "ServedResult",
    "load_histories", "run_served",
]
