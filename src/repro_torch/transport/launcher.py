"""Cluster launcher: boot a loopback served cluster, drive it with real
client processes, and feed the captured artifacts back through the
simulator's own verification and observability pipelines.

``run_served(cfg)`` is the one-call harness: it spawns one
:mod:`node_runner` process per replica and one :mod:`client_driver`
process per client against a shared run directory, waits for the
clients to drain their workloads, SIGTERMs the replicas (which dump
their raw tracer events and channel stats), and then

  * merges the per-client history files into one canonical
    ``HistoryEntry`` list — the input the ``repro_torch.verify``
    linearizability checker already takes;
  * merges the per-node raw span logs through the same
    ``canonical_events`` path simulator runs use and aggregates them
    into a ``MetricsRegistry`` via ``metrics_from_trace`` — wall-clock
    timestamps (seconds since the shared launch epoch) occupy the span
    schema's time column, so every obs report works on real runs
    unchanged.

The returned :class:`ServedArtifacts` mimics the simulator's
``RunArtifacts`` shape (``.result.history``, ``.result.trace``,
``.clients``) closely enough for ``verify_artifacts(art,
check_rsm=False)`` — there is no live replica state to audit, which is
exactly the checker-on-real-histories limitation documented in the
README: the history check is sound but only sees what clients observed.

Mid-run fault hooks (:meth:`ClusterLauncher.kill_node` /
:meth:`ClusterLauncher.restart_node`) SIGKILL a replica process (no
shutdown dump — a crash, not an exit) and relaunch it with
``--recover``, driving the protocol's real state-transfer path over
sockets. The restarted process binds a fresh port; peers re-read its
port file on every reconnect attempt.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import repro_torch
from repro_torch.core.rsm import HistoryEntry

_SRC_ROOT = str(Path(repro_torch.__file__).resolve().parents[1])


@dataclasses.dataclass
class ClusterConfig:
    """One served run: cluster shape + workload + capture knobs."""

    protocol: str = "woc"
    n_replicas: int = 5
    n_clients: int = 2
    t_fail: int = 1
    seed: int = 0
    batch_size: int = 8
    max_inflight: int = 4
    total_ops: int = 1600          # across all clients
    reads_fraction: float = 0.25
    p_common: float = 0.05
    p_hot: float = 0.05
    n_hot: int = 4
    trace: bool = True
    sample_every: int = 1
    max_queue: int = 512
    hb_scale: float = 10.0         # failure-detector timescale (wall clock)
    reorder: bool = False          # mutation twin: per-peer frame displacement
    time_limit_s: float = 60.0
    run_dir: Optional[str] = None  # default: a fresh temp directory

    @classmethod
    def from_json(cls, path) -> "ClusterConfig":
        """Load a served-cluster config file. The ``"served": true``
        marker distinguishes these from simulator Scenario JSON (the CI
        scenario validator routes on it)."""
        raw = json.loads(Path(path).read_text())
        if not raw.pop("served", False):
            raise ValueError(f"{path}: not a served-cluster config "
                             f"(missing \"served\": true marker)")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"{path}: unknown config keys {sorted(unknown)}")
        return cls(**raw)


@dataclasses.dataclass
class ServedResult:
    """RunResult-shaped summary of a served run (wall-clock domain)."""

    protocol: str
    n_replicas: int
    n_clients: int
    committed_ops: int
    makespan_s: float
    throughput_tx_s: float
    fast_path_frac: float
    clients_done: int              # clients that drained their workload
    history: list = dataclasses.field(default_factory=list, repr=False)
    trace: list = dataclasses.field(default_factory=list, repr=False)
    metrics: dict = dataclasses.field(default_factory=dict, repr=False)
    node_stats: list = dataclasses.field(default_factory=list, repr=False)
    client_stats: list = dataclasses.field(default_factory=list, repr=False)


@dataclasses.dataclass
class ServedArtifacts:
    result: ServedResult
    run_dir: str
    # no live replica objects in a served run; empty keeps the shape
    # verify_artifacts(check_rsm=False) expects
    clients: list = dataclasses.field(default_factory=list)


class ClusterLauncher:
    """Process supervisor for one served cluster (see module docstring)."""

    def __init__(self, cfg: ClusterConfig):
        self.cfg = cfg
        self.run_dir = Path(cfg.run_dir or tempfile.mkdtemp(
            prefix="woc-served-"))
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.epoch = 0.0
        self.nodes: Dict[int, subprocess.Popen] = {}
        self.clients: Dict[int, subprocess.Popen] = {}
        self._env = dict(os.environ)
        pp = self._env.get("PYTHONPATH")
        self._env["PYTHONPATH"] = (_SRC_ROOT if not pp
                                   else _SRC_ROOT + os.pathsep + pp)

    # -- replica processes ---------------------------------------------------

    def start_node(self, node_id: int, *, recover: bool = False) -> None:
        cfg = self.cfg
        cmd = [sys.executable, "-m", "repro_torch.transport.node_runner",
               "--node-id", str(node_id), "--n", str(cfg.n_replicas),
               "--run-dir", str(self.run_dir), "--protocol", cfg.protocol,
               "--seed", str(cfg.seed), "--epoch", repr(self.epoch),
               "--batch-size", str(cfg.batch_size),
               "--t-fail", str(cfg.t_fail),
               "--max-queue", str(cfg.max_queue),
               "--hb-scale", str(cfg.hb_scale)]
        if cfg.trace:
            cmd += ["--trace", "--sample-every", str(cfg.sample_every)]
        if cfg.reorder:
            cmd.append("--reorder")
        if recover:
            cmd.append("--recover")
        self.nodes[node_id] = subprocess.Popen(cmd, env=self._env)

    def start(self) -> None:
        self.epoch = time.time()
        for f in self.run_dir.glob("node-*.port"):
            f.unlink()                 # stale ports from a previous run
        for i in range(self.cfg.n_replicas):
            self.start_node(i)
        self.wait_for_ports(range(self.cfg.n_replicas))

    def wait_for_ports(self, node_ids, timeout: float = 15.0) -> None:
        deadline = time.time() + timeout
        pending = set(node_ids)
        while pending:
            pending = {i for i in pending
                       if not (self.run_dir / f"node-{i}.port").exists()}
            if not pending:
                return
            if time.time() > deadline:
                raise TimeoutError(f"replicas {sorted(pending)} never "
                                   f"published a port in {timeout}s")
            time.sleep(0.02)

    def kill_node(self, node_id: int) -> None:
        """Hard-crash a replica (SIGKILL: no shutdown dump, no goodbye
        on the wire — peers discover via dead sockets)."""
        proc = self.nodes.pop(node_id, None)
        if proc is not None:
            proc.kill()
            proc.wait()
        # retract the port file: peers' dials fail fast instead of
        # hitting a dead (or recycled) port, and restart_node's
        # port wait observes the NEW process's publication rather than
        # returning on this stale one (a SIGTERM during interpreter
        # start-up would bypass the dump handler entirely)
        (self.run_dir / f"node-{node_id}.port").unlink(missing_ok=True)

    def restart_node(self, node_id: int) -> None:
        """Relaunch a killed replica in recovery mode: it re-binds a
        fresh port, pulls a state snapshot from a live peer, and rejoins."""
        self.start_node(node_id, recover=True)
        self.wait_for_ports([node_id])

    # -- client processes ----------------------------------------------------

    def start_clients(self) -> None:
        cfg = self.cfg
        total_batches = max(1, cfg.total_ops // max(1, cfg.batch_size))
        base, rem = divmod(total_batches, cfg.n_clients)
        for ci in range(cfg.n_clients):
            cmd = [sys.executable, "-m", "repro_torch.transport.client_driver",
                   "--client-id", str(ci), "--n", str(cfg.n_replicas),
                   "--run-dir", str(self.run_dir),
                   "--protocol", cfg.protocol, "--seed", str(cfg.seed),
                   "--epoch", repr(self.epoch),
                   "--batch-size", str(cfg.batch_size),
                   "--max-inflight", str(cfg.max_inflight),
                   "--total-batches",
                   str(max(1, base + (1 if ci < rem else 0))),
                   "--reads-fraction", str(cfg.reads_fraction),
                   "--p-common", str(cfg.p_common),
                   "--p-hot", str(cfg.p_hot), "--n-hot", str(cfg.n_hot),
                   "--time-limit", str(cfg.time_limit_s)]
            self.clients[ci] = subprocess.Popen(cmd, env=self._env)

    def wait_clients(self) -> int:
        """Block until every client process exits; count the ones that
        drained their full workload (exit 0)."""
        done = 0
        deadline = time.time() + self.cfg.time_limit_s + 20.0
        for proc in self.clients.values():
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            done += rc == 0
        return done

    def stop(self) -> None:
        """Graceful replica shutdown: SIGTERM triggers the trace/stats
        dump; stragglers are killed."""
        for proc in self.nodes.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in self.nodes.values():
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    # -- artifact collection -------------------------------------------------

    def collect(self, clients_done: int) -> ServedArtifacts:
        history = load_histories(self.run_dir)
        trace: list = []
        node_stats = []
        for i in range(self.cfg.n_replicas):
            tf = self.run_dir / f"node-{i}.trace.jsonl"
            if tf.exists():
                with open(tf) as f:
                    trace.extend(tuple(json.loads(line)) for line in f)
            sf = self.run_dir / f"node-{i}.stats.json"
            if sf.exists():
                node_stats.append(json.loads(sf.read_text()))
        client_stats = []
        for sf in sorted(self.run_dir.glob("client-*.stats.json")):
            client_stats.append(json.loads(sf.read_text()))

        metrics: dict = {}
        if trace:
            from repro_torch.obs.metrics import metrics_from_trace
            from repro_torch.obs.spans import canonical_events
            trace = canonical_events(trace)
            metrics = metrics_from_trace(trace).to_dict()

        committed = len(history)
        if history:
            t0 = min(h.invoke for h in history)
            t1 = max(h.response for h in history)
            makespan = max(t1 - t0, 1e-9)
        else:
            makespan = 1e-9
        fast = sum(1 for h, p in zip(history, _history_paths(self.run_dir))
                   if p == "fast")
        result = ServedResult(
            protocol=self.cfg.protocol, n_replicas=self.cfg.n_replicas,
            n_clients=self.cfg.n_clients, committed_ops=committed,
            makespan_s=makespan, throughput_tx_s=committed / makespan,
            fast_path_frac=fast / committed if committed else 0.0,
            clients_done=clients_done, history=history, trace=trace,
            metrics=metrics, node_stats=node_stats,
            client_stats=client_stats)
        return ServedArtifacts(result, str(self.run_dir))


def _history_rows(run_dir: Path):
    for hf in sorted(Path(run_dir).glob("client-*.history.jsonl")):
        with open(hf) as f:
            for line in f:
                yield json.loads(line)


def load_histories(run_dir) -> List[HistoryEntry]:
    """Merge per-client history files into one canonical checker input."""
    hist = [HistoryEntry(r[0], r[1], r[2], r[3], r[4], r[5])
            for r in _history_rows(run_dir)]
    hist.sort(key=lambda h: (h.invoke, h.op_id))
    return hist


def _history_paths(run_dir: Path) -> List[str]:
    rows = sorted(_history_rows(run_dir), key=lambda r: (r[4], r[0]))
    return [r[6] if len(r) > 6 else "" for r in rows]


def run_served(cfg: ClusterConfig) -> ServedArtifacts:
    """Boot, drive, stop, collect — the end-to-end served harness."""
    launcher = ClusterLauncher(cfg)
    launcher.start()
    try:
        launcher.start_clients()
        done = launcher.wait_clients()
    finally:
        launcher.stop()
    return launcher.collect(done)
