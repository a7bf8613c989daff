"""Drills on the served cluster (``repro_torch.transport``) that wait on what
its processes show rather than on the clock.

A replica process publishes nothing while it runs but its port file, and
dumps its counters only when it is stopped, so a crash drill timed by
sleeps is a guess about scheduling: on a loaded host the clients may not
have started when the replica dies, or a peer may never have dialed it.
These drills read the loopback sockets instead: ``/proc/net/tcp`` gives
every connection's ports, state and queued bytes, and ``/proc/<pid>/fd``
says which of them a process holds. Every wait has a deadline and raises
``TimeoutError`` with what it last saw.

  * :func:`crash_restart` — SIGKILL one replica once every peer and the
    first client are connected to it, restart it with ``--recover`` once
    every dialer has seen its connection die, and stop the cluster only
    once every peer is connected to the new process and the bytes between
    them are read;
  * :func:`start_up_s` — seconds for a fresh interpreter to import the
    module a replica or a client process runs.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.transport import ClusterConfig, ClusterLauncher, ServedArtifacts
from repro_torch.transport.launcher import _SRC_ROOT

ESTABLISHED, CLOSE_WAIT = 0x01, 0x08
POLL_S = 0.02
WAIT_S = 30.0                  # each stage's deadline
# polls in a row for which ``settled`` must hold: where /proc/net/tcp reports
# no queued bytes (gVisor's reports 0 always), these 100 ms cover the frames
# still on their way
SETTLED_POLLS = 5


@dataclasses.dataclass(frozen=True)
class Conn:
    """One row of ``/proc/net/tcp``."""

    local_port: int
    remote_port: int
    state: int
    tx_queue: int                  # bytes sent and not yet acknowledged
    rx_queue: int                  # bytes received and not yet read
    inode: int


def connections() -> list[Conn]:
    """Every IPv4 TCP socket of this network namespace."""
    rows = []
    for line in Path("/proc/net/tcp").read_text().splitlines()[1:]:
        f = line.split()
        tx, rx = f[4].split(":")
        rows.append(Conn(int(f[1].split(":")[1], 16), int(f[2].split(":")[1], 16),
                         int(f[3], 16), int(tx, 16), int(rx, 16), int(f[9])))
    return rows


def socket_inodes(pid: int) -> set[int]:
    """The inodes of the sockets that process ``pid`` holds open (none once
    it has exited)."""
    out = set()
    try:
        fds = list(Path(f"/proc/{pid}/fd").iterdir())
    except OSError:
        return out
    for fd in fds:
        try:
            target = os.readlink(fd)
        except OSError:
            continue                       # closed while we looked
        if target.startswith("socket:["):
            out.add(int(target[8:-1]))
    return out


def port_of(launcher: ClusterLauncher, node_id: int) -> int:
    return int((launcher.run_dir / f"node-{node_id}.port").read_text())


def wait_for(what: str, probe, timeout: float) -> float:
    """Poll ``probe()`` until it returns ``(True, _)``; return the seconds it
    took. ``probe`` returns ``(done, seen)``; ``seen`` goes into the error."""
    t0 = time.perf_counter()
    while True:
        done, seen = probe()
        if done:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{what}: not seen in {timeout} s (last: {seen})")
        time.sleep(POLL_S)


def dialers(port: int, states=(ESTABLISHED,)) -> list[Conn]:
    """The dialing ends of the connections to ``port``."""
    return [c for c in connections() if c.remote_port == port and c.state in states]


def working(launcher: ClusterLauncher, node_id: int, port: int) -> tuple[bool, dict]:
    """Whether every other replica holds a connection to ``node_id`` at
    ``port`` and a client does too or has already exited."""
    holding = {c.inode for c in dialers(port)}
    peers = [proc.pid for j, proc in launcher.nodes.items() if j != node_id]
    peers_in = sum(bool(socket_inodes(pid) & holding) for pid in peers)
    clients = launcher.clients.values()
    clients_in = sum(proc.poll() is None and bool(socket_inodes(proc.pid) & holding)
                     for proc in clients)
    exited = sum(proc.poll() is not None for proc in clients)
    seen = {"peers": peers_in, "clients": clients_in, "clients_exited": exited}
    return peers_in == len(peers) and (clients_in or exited) > 0, seen


def settled(launcher: ClusterLauncher, node_id: int, port: int) -> tuple[bool, dict]:
    """Whether every other replica holds a connection to ``node_id`` at
    ``port`` and ``node_id`` holds one to each of them, with no byte queued
    on the way in: what the others sent it (its state transfer included)
    has been read by the process."""
    n = launcher.cfg.n_replicas
    peers = {port_of(launcher, j) for j in range(n) if j != node_id}
    mine = socket_inodes(launcher.nodes[node_id].pid)
    conns = connections()
    inbound = [c for c in conns if c.remote_port == port and c.state == ESTABLISHED]
    own = [c for c in conns if c.inode in mine and c.state == ESTABLISHED]
    outbound = {c.remote_port for c in own} & peers
    queued = sum(c.tx_queue for c in inbound) + sum(c.rx_queue for c in own)
    seen = {"inbound": len(inbound), "outbound": len(outbound), "queued_bytes": queued}
    return len(inbound) >= n - 1 and outbound == peers and queued == 0, seen


def crash_restart(cfg: ClusterConfig) -> tuple[ServedArtifacts, dict]:
    """One served run in which replica 0 is killed mid-workload and restarted
    in recovery mode, as tests/test_transport.py's crash case does; returns
    the artifacts and the seconds each stage took. The stages, each waited
    for on the sockets (``WAIT_S`` each):

    1. every other replica holds a connection to the replica, and so does
       a client, or a client has exited: the workload is running through
       it (a client drains a few thousand ops in well under a second once
       it has started, so the first client is the moment); then SIGKILL;
    2. none of those connections is open any more: every dialer has seen
       the crash (a peer's channel counts the reconnect); then restart;
    3. the clients exit (``wait_clients``, bounded by the run's limit);
    4. :func:`settled` holds for ``SETTLED_POLLS`` polls in a row for the
       new process; then SIGTERM, which makes every replica dump its
       counters.
    """
    launcher, node_id = ClusterLauncher(cfg), 0
    stages = {}
    try:
        t0 = time.perf_counter()
        launcher.start()
        stages["start_s"] = time.perf_counter() - t0
        launcher.start_clients()
        old = port_of(launcher, node_id)
        stages["connected_s"] = wait_for(f"the workload running through replica {node_id}",
                                         lambda: working(launcher, node_id, old), WAIT_S)
        stages["clients_running_at_kill"] = sum(
            proc.poll() is None for proc in launcher.clients.values())
        launcher.kill_node(node_id)
        stages["noticed_s"] = wait_for(
            f"every dialer of replica {node_id} saw its crash",
            lambda: (not (seen := dialers(old, (ESTABLISHED, CLOSE_WAIT))), len(seen)),
            WAIT_S)
        t0 = time.perf_counter()
        launcher.restart_node(node_id)
        stages["restart_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        done = launcher.wait_clients()
        stages["clients_s"] = time.perf_counter() - t0
        new = port_of(launcher, node_id)
        streak = [0]

        def steady():
            ok, seen = settled(launcher, node_id, new)
            streak[0] = streak[0] + 1 if ok else 0
            return streak[0] >= SETTLED_POLLS, seen

        stages["settled_s"] = wait_for(f"replica {node_id} rejoined", steady, WAIT_S)
    finally:
        for proc in launcher.clients.values():     # left running only by a failed wait
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        launcher.stop()
    return launcher.collect(done), stages


def start_up_s(module: str) -> float:
    """Wall seconds for a fresh interpreter, on the path the launcher gives
    its processes, to import ``module`` and exit."""
    pp = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_SRC_ROOT if not pp else _SRC_ROOT + os.pathsep + pp)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", f"import {module}"], env=env, check=True)
    return time.perf_counter() - t0
