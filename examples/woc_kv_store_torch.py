"""End-to-end driver: a replicated KV store on WOC, with a mid-run leader
crash, recovery via state transfer, and a full safety audit — all
declared in one Scenario.

Act one is the paper's system doing its actual job: 7 heterogeneous
replicas, 4 clients issuing reads+writes over independent/common/hot
objects, the initial slow-path leader killed at t=100ms and recovered at
t=400ms. ``check_linearizable`` makes run_scenario verify the captured
history before returning (it raises on violation); the RSM-level audits
below cross-check replica state directly.

Act two is the same store under a read-heavy workload, run twice — with
and without weighted object leases (``Scenario.leases``). Unleased,
every read rides full consensus at write cost; leased, most reads are
served locally under a lease and throughput roughly doubles, still
linearizable (both runs are checked).

Act three is the store under data-heavy traffic — 256 KiB values on a
cost model with real per-byte wire terms — run twice, with and without
adaptive payload striping (``Scenario.coding``). Full-copy, every
write ships the whole value to every replica; striped, large writes
are erasure-coded so each replica receives one shard, and throughput
roughly triples (both histories checked).

Act four leaves the simulator: the SAME replica classes are served
over real asyncio sockets on localhost — 5 replica processes, 2 client
processes, length-prefixed frames, wall-clock timers — and the history
the real clients observed goes through the same linearizability
checker (``repro_torch.transport.run_served``).

This is the PyTorch port's twin of ``examples/woc_kv_store.py``: the same
acts through ``repro_torch``, which imports no JAX. Acts one to three are
simulated and print the reference's lines; act four runs real processes,
so its times are the host's own.

Run:  PYTHONPATH=src python examples/woc_kv_store_torch.py
"""

from repro_torch.core.rsm import (check_linearizability, check_state_machine_safety,
                            history_from_ops)
from repro_torch.core.simulator import Workload
from repro_torch.faults import Crash, Recover
from repro_torch.scenario import (Leases, Scenario, Verification, ZipfWorkload,
                            run_scenario)

sc = Scenario(
    protocol="woc", n_replicas=7, n_clients=4, batch_size=20,
    total_ops=30_000, t_fail=2,
    workload=Workload(p_independent=0.8, p_common=0.1, p_hot=0.1,
                      n_hot_objects=4, reads_fraction=0.25),
    faults=(Crash(0.10, "leader"), Recover(0.40, "leader")),
    verify=Verification(capture_history=True, check_linearizable=True),
)
print("running 7-replica WOC KV store with leader crash @100ms ...")
art = run_scenario(sc)
r = art.result

print(f"\ncommitted {r.committed_ops} ops in {r.makespan_s:.2f}s "
      f"({r.throughput_tx_s:.0f} Tx/s)")
print(f"latency p50/p99: {r.latency_p50_ms:.2f}/{r.latency_p99_ms:.2f} ms; "
      f"fast-path {r.fast_path_frac:.0%}")
print("history linearizable:                  OK (checked by run_scenario)")

rsms = [rep.rsm for rep in art.replicas]
ok, why = check_state_machine_safety(rsms)
print(f"state-machine safety across replicas: {'OK' if ok else why}")

best = max(rsms, key=lambda m: m.apply_count)
ops = [op for c in art.clients for op in c.ops]
ok, why = check_linearizability(history_from_ops(ops), best.applied)
print(f"linearizability (reads + writes):      {'OK' if ok else why}")

om = art.replicas[1].om
from collections import Counter
classes = Counter(v.value for v in om.snapshot().values())
print(f"object classes at replica 1: {dict(classes)}")

# -- act two: read-heavy traffic, leases off vs on --------------------------

print("\nread-heavy phase (90% reads over 64 hot objects), "
      "leases off vs on ...")


def read_heavy(leases):
    return run_scenario(Scenario(
        protocol="woc", n_replicas=5, n_clients=4, batch_size=4,
        total_ops=12_000, seed=3,
        workload=ZipfWorkload(n_objects=64, theta=0.0, reads_fraction=0.9),
        leases=leases,
        verify=Verification(capture_history=True,
                            check_linearizable=True))).result


off = read_heavy(None)
on = read_heavy(Leases(grant_after_reads=1))
print(f"  leases off: {off.throughput_tx_s:8.0f} Tx/s   "
      f"p50 {off.latency_p50_ms:.2f} ms   (every read pays consensus)")
print(f"  leases on:  {on.throughput_tx_s:8.0f} Tx/s   "
      f"p50 {on.latency_p50_ms:.2f} ms   "
      f"({on.read_local_frac:.0%} of reads served locally)")
print(f"  speedup: {on.throughput_tx_s / off.throughput_tx_s:.2f}x — "
      f"both histories checked linearizable")

# -- act three: data-heavy writes, striping off vs on ------------------------

print("\ndata-heavy phase (256 KiB values, per-byte wire costs), "
      "striping off vs on ...")

from repro_torch.core.simulator import CostModel
from repro_torch.scenario import Coding, ValueSizesWorkload


def data_heavy(coding):
    return run_scenario(Scenario(
        protocol="woc", n_replicas=5, n_clients=4, batch_size=4,
        total_ops=2_500, seed=7,
        costs=CostModel(c_byte_wire=4e-9, c_byte_parse=1e-9),
        workload=ValueSizesWorkload(
            base=ZipfWorkload(n_objects=512, theta=0.0,
                              reads_fraction=0.5),
            size_dist="fixed", size_small=1 << 18),
        coding=coding,
        verify=Verification(capture_history=True,
                            check_linearizable=True))).result


full = data_heavy(None)
striped = data_heavy(Coding())
print(f"  full copies: {full.throughput_tx_s:8.0f} Tx/s   "
      f"(every write ships {1 << 18} B to every replica)")
print(f"  striped:     {striped.throughput_tx_s:8.0f} Tx/s   "
      f"({striped.striped_frac:.0%} of ops striped, one shard per "
      f"replica)")
print(f"  speedup: {striped.throughput_tx_s / full.throughput_tx_s:.2f}x"
      f" — both histories checked linearizable")

# -- act four: the same store served over real sockets -----------------------

print("\nserving over asyncio sockets: 5 replica processes, "
      "2 client processes ...")

from repro_torch.transport import ClusterConfig, run_served
from repro_torch.verify import check_history_linearizable

served = run_served(ClusterConfig(
    protocol="woc", n_replicas=5, n_clients=2, total_ops=800,
    batch_size=8, seed=7, time_limit_s=45)).result
ok, why = check_history_linearizable(served.history)
assert ok, why
print(f"  committed {served.committed_ops} ops in "
      f"{served.makespan_s:.2f}s wall-clock "
      f"({served.throughput_tx_s:.0f} Tx/s, "
      f"fast-path {served.fast_path_frac:.0%})")
print(f"  {served.clients_done}/{served.n_clients} client processes "
      f"drained; real history checked linearizable: OK")
