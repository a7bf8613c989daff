"""The port's protocol stack against the JAX package's, run for run.

``repro_torch``'s simulator, protocols, scenario, faults, shard, obs,
verify and coding modules are copies of the reference's numpy and
plain-Python modules (``tests/test_torch_protocol_copies.py`` holds their
sources). Both packages run the same Python and numpy code on the same
seed, so every case here compares exactly: every field of the run's result
except the wall-clock telemetry (``wall_s`` and ``events_per_sec``, also
inside each engine's stats, and a parallel run's ``idle_wait_frac``, the
share of wall time its workers waited), the client history, the weight
epochs, the canonical span trace, and each replica's applied state (store,
per-object apply order, applied op ids).

The cases: the five golden runs of ``tests/test_scenario.py``, epaxos, read
leases, weight reassignment under a leader crash, erasure coding under
bimodal value sizes, tracing, two draws of the fault-schedule property that
the reference fails (ROADMAP queue 3; the port must give the reference's
verdict, not a pass), and ``run_sharded`` serial and with two workers. Every
run is at most 3,000 ops, with torch on one thread.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
import warnings  # noqa: E402

# wall-clock telemetry: differs between any two runs, of one package or two
WALL_CLOCK = {"wall_s", "events_per_sec", "idle_wait_frac"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def package(root: str) -> types.SimpleNamespace:
    """The modules of one package, ``repro`` or ``repro_torch``."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        runner=mod("core.runner"), simulator=mod("core.simulator"),
        scenario=mod("scenario"), faults=mod("faults"), shard=mod("shard"),
        obs=mod("obs"), verify=mod("verify"))


def plain(x):
    """A value with every dataclass made a dict (wall-clock fields dropped),
    so that the two packages' classes compare by content."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"<class>": type(x).__name__,
                **{f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                   if f.name not in WALL_CLOCK}}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return sorted(x)
    return x


def replica_state(replicas):
    """Each replica's applied state: its store, the per-object apply order
    (write values and op ids), its applied op ids and apply count."""
    out = []
    for rep in replicas:
        if isinstance(rep, list):                  # sharded: one list a group
            out.append(replica_state(rep))
            continue
        rsm = rep.rsm
        out.append({"node": rep.node_id, "store": dict(rsm.store),
                    "applied": {k: list(v) for k, v in rsm.applied.items()},
                    "obj_ops": {k: list(v) for k, v in rsm.obj_ops.items()},
                    "applied_ops": sorted(rsm.applied_ops),
                    "apply_count": rsm.apply_count})
    return out


def paper_mix(p, proto, mix):
    """The workloads of ``tests/test_faults.py``'s fault-schedule property."""
    W = p.simulator.Workload
    return [W(),
            W(p_independent=0.6, p_common=0.2, p_hot=0.2, n_hot_objects=4,
              reads_fraction=0.25 if proto != "epaxos" else 0.0),
            W(p_independent=0.9, p_common=0.05, p_hot=0.05,
              reads_fraction=0.1 if proto != "epaxos" else 0.0)][mix]


def sc(p, **kw):
    """A Scenario with the feature tests' defaults (5 replicas, 4 clients,
    batch 4, seed 3)."""
    for key, value in (("n_replicas", 5), ("n_clients", 4), ("batch_size", 4),
                       ("seed", 3)):
        kw.setdefault(key, value)
    return p.scenario.Scenario(**kw)


def nemesis_run(p, seed, proto, mix):
    """One draw of the fault-schedule property, built as
    ``tests/test_faults.py::test_random_fault_schedules_stay_linearizable``."""
    return p.runner.run(p.runner.RunConfig(
        protocol=proto, total_ops=3000, batch_size=10, workload=paper_mix(p, proto, mix),
        faults=p.faults.Nemesis(seed).random_schedule(5), seed=seed & 0xFF,
        sim_time_cap=30.0))


def legacy_crash(p):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return p.runner.run(p.runner.RunConfig(protocol="woc", total_ops=3000, batch_size=10,
                                               crash_at=0.05, recover_at=0.4, seed=0))


CASES = {
    # the golden runs (tests/test_scenario.py:32-74)
    "golden_flat_woc": lambda p: p.runner.run(p.runner.RunConfig(
        protocol="woc", total_ops=2000, batch_size=10, seed=3)),
    "golden_flat_cabinet": lambda p: p.scenario.run_scenario(p.scenario.Scenario(
        protocol="cabinet", total_ops=2000, batch_size=10, seed=3)),
    "golden_sharded_drift": lambda p: p.scenario.run_scenario(p.scenario.Scenario(
        protocol="woc", n_replicas=3, total_ops=2000, batch_size=10, seed=5,
        sharding=p.scenario.Sharding(n_groups=2, locality="drift", working_set=8,
                                     p_working=0.9, steal_threshold=2))),
    "golden_sharded_uniform": lambda p: p.shard.run_sharded(p.shard.ShardedRunConfig(
        n_groups=2, total_ops=2000, batch_size=10, seed=3)),
    "golden_legacy_crash": legacy_crash,
    "epaxos": lambda p: p.runner.run(p.runner.RunConfig(
        protocol="epaxos", total_ops=2000, batch_size=10, seed=3, capture_history=True)),
    "leases": lambda p: p.scenario.run_scenario(sc(
        p, protocol="woc", total_ops=3000,
        workload=p.scenario.ZipfWorkload(n_objects=64, theta=0.0, reads_fraction=0.9),
        leases=p.scenario.Leases(grant_after_reads=1),
        verify=p.scenario.Verification(capture_history=True, check_linearizable=True))),
    "reassign_leader_crash": lambda p: p.scenario.run_scenario(sc(
        p, protocol="woc", total_ops=3000, reassign=p.scenario.Reassign(),
        faults=p.faults.leader_crash(at=0.05, recover_at=0.2),
        verify=p.scenario.Verification(capture_history=True))),
    "coding_bimodal": lambda p: p.scenario.run_scenario(sc(
        p, protocol="woc", total_ops=1500, coding=p.scenario.Coding(),
        workload=p.scenario.ValueSizesWorkload(
            base=p.scenario.ZipfWorkload(n_objects=64, theta=0.0, reads_fraction=0.5),
            size_dist="bimodal", size_small=256, size_large=1 << 20, p_large=0.3),
        verify=p.scenario.Verification(capture_history=True))),
    "tracing": lambda p: p.scenario.run_scenario(sc(
        p, protocol="woc", total_ops=2000,
        obs=p.scenario.Observability(trace=True, sample_every=1))),
    # two draws of the fault-schedule property that the reference fails
    "nemesis_957206_woc_0": lambda p: nemesis_run(p, 957206, "woc", 0),
    "nemesis_882811_cabinet_1": lambda p: nemesis_run(p, 882811, "cabinet", 1),
    "sharded_workers_2": lambda p: p.shard.run_sharded(p.shard.ShardedRunConfig(
        n_groups=2, total_ops=2000, batch_size=10, seed=7, workers=2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_reproduces_the_reference_run(name):
    ref, port = package("repro"), package("repro_torch")
    want, got = CASES[name](ref), CASES[name](port)
    assert type(got.result).__module__.startswith("repro_torch.")
    assert type(want.result).__module__.startswith("repro.")
    w, g = plain(want.result), plain(got.result)
    assert g.keys() == w.keys()
    for field in w:
        assert g[field] == w[field], field
    assert replica_state(got.replicas) == replica_state(want.replicas)
    assert (port.obs.canonical_events(got.result.trace)
            == ref.obs.canonical_events(want.result.trace))
    r = got.result
    assert r.committed_ops > 0
    if name in ("epaxos", "leases", "reassign_leader_crash", "coding_bimodal") \
            or name.startswith("nemesis"):
        assert r.history, "the case captures a history"
    if name == "leases":
        assert r.read_local_frac > 0.3
    if name == "reassign_leader_crash":
        assert r.weight_epochs, "the crash installs a weight view"
    if name == "coding_bimodal":
        assert 0.0 < r.striped_frac
    if name == "tracing":
        assert r.trace
    if name == "sharded_workers_2":
        assert r.workers == 2 and got.sim is None


@pytest.mark.parametrize("seed,proto,mix", [(957206, "woc", 0), (882811, "cabinet", 1)])
def test_failing_fault_draws_give_the_reference_verdict(seed, proto, mix):
    """The copies inherit the reference's fault-schedule defect (ROADMAP
    queue 3): on these draws the reference's checks fail, and the port's
    give the same verdicts with the same reasons."""
    verdicts = {}
    for root in ("repro", "repro_torch"):
        p = package(root)
        art = nemesis_run(p, seed, proto, mix)
        verdicts[root] = (p.verify.check_history_linearizable(art.result.history),
                          p.verify.verify_artifacts(art))
    assert verdicts["repro_torch"] == verdicts["repro"]
    linearizable, safe = verdicts["repro"]
    assert not (linearizable[0] and safe[0]), "the reference passes this draw now"


GOLDEN = {   # tests/test_scenario.py:32-74
    "golden_flat_woc": dict(
        committed_ops=2000, makespan_s=0.040969713431704705,
        throughput_tx_s=48816.54843239117, latency_avg_ms=1.3035649910470413,
        latency_p50_ms=1.242662486132747, latency_p99_ms=2.813452602624127,
        fast_path_frac=0.9545, messages=3501),
    "golden_flat_cabinet": dict(
        committed_ops=2000, makespan_s=0.12971771712868987,
        throughput_tx_s=15418.09433799893, latency_p50_ms=6.0553194258676335,
        fast_path_frac=0.0, messages=3040),
    "golden_sharded_drift": dict(
        committed_ops=2000, makespan_s=0.06748755811196536,
        throughput_tx_s=29635.09209626308, latency_p50_ms=5.645318806117558,
        fast_path_frac=0.133, messages=3982, migrations=19, redirected_ops=100,
        remote_frac=0.165, steal_hints=71),
    "golden_sharded_uniform": dict(
        committed_ops=2000, makespan_s=0.02649124472521434,
        throughput_tx_s=75496.64127697262, latency_p50_ms=1.3455711655872165,
        fast_path_frac=0.9385, messages=4246),
    "golden_legacy_crash": dict(
        committed_ops=3000, makespan_s=0.47268602465982446,
        latency_p99_ms=251.22218468018943, fast_path_frac=0.928, messages=6008),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_matches_the_golden_pins(name):
    """The port alone, with no JAX package loaded, reproduces the golden
    pins bit for bit."""
    r = CASES[name](package("repro_torch")).result
    for field, want in GOLDEN[name].items():
        assert getattr(r, field) == want, field


def test_deprecated_runner_names_point_at_the_port():
    """``PROTOCOLS`` and ``LEADER_BASED`` warn on every use, naming the
    port's modules, and hold what the reference's do."""
    port, ref = package("repro_torch").runner, package("repro").runner
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.core\.runner\.PROTOCOLS .*repro_torch\.scenario\.registry"):
        names = sorted(port.PROTOCOLS)
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.core\.runner\.LEADER_BASED"):
        leaders = sorted(port.LEADER_BASED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert names == sorted(ref.PROTOCOLS)
        assert leaders == sorted(ref.LEADER_BASED)



def test_chip_smoke_pins_the_references_golden_runs_and_verdict():
    """``chip_smoke.py``'s protocol path holds the port, on the card's host,
    to pins it cannot compute there: the golden runs above, and the
    reference's verdict on its fault schedule, which the reference passes."""
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.PROTOCOL_GOLDEN == {name[len("golden_"):]: pins
                                          for name, pins in GOLDEN.items()}
    for root in ("repro", "repro_torch"):
        p = package(root)
        art = nemesis_run(p, chip_smoke.NEMESIS_SEED, "woc", 0)
        verdict = (p.verify.check_history_linearizable(art.result.history),
                   p.verify.verify_artifacts(art))
        assert verdict == chip_smoke.NEMESIS_VERDICT, root
