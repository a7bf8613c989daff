"""The port's served transport (``repro_torch.transport``) against the JAX
package's (``repro.transport``).

The transport's modules are copies of the reference's
(``tests/test_torch_protocol_copies.py`` holds their sources); these cases
hold what they do:

* the codec: the two packages' frames are equal byte for byte for the
  protocol shapes of ``tests/test_transport.py``, and each package decodes
  the other's, on the msgpack branch and on the JSON branch;
* the twins of the reference's three cluster tests, with every assertion
  of the reference. The crash twin waits on the cluster's sockets
  (``repro_torch.launch.served.crash_restart``) where the reference sleeps;
* one served run whose processes cannot import msgpack, the branch that
  runs on a host without it: each process reports the JSON codec;
* one small run of each package from the same configuration: the clients
  draw their ops from the seed alone, so both commit the same ops and write
  the same values.

Every cluster is a few hundred to a few thousand ops on localhost.
"""

import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

from _served_probe import probed_env, read_reports  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.transport import ClusterConfig as RefClusterConfig  # noqa: E402
from repro.transport import codec as ref_codec  # noqa: E402
from repro.transport import run_served as ref_run_served  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.launch.served import crash_restart  # noqa: E402
from repro_torch.transport import ClusterConfig, run_served  # noqa: E402
from repro_torch.transport import codec  # noqa: E402
from repro_torch.transport.net import READ_RESULTS_CAP  # noqa: E402
from repro_torch.verify import check_history_linearizable, verify_artifacts  # noqa: E402


# ---------------------------------------------------------------------------
# codec (no sockets)
# ---------------------------------------------------------------------------

def shapes(mod):
    """The messages of ``tests/test_transport.py``'s codec cases, built from
    one package's ``Msg`` and ``Op``."""
    op = mod.Op(7, 5, 0x2000000000000000, "w", 1234, 0.5, -1.0, "", None)
    sized = mod.Op(7, 5, 0x2000000000000000, "w", 1234, 0.5, -1.0, "", None, 1 << 20)
    read = mod.Op(8, 5, 3, "r", 0, 0.25, 0.75, "fast", 41, 64)
    return [
        mod.Msg("slow_commit", 1, 3,
                {"ops": [op], "deps": {7: [3, 4]}, "applied": {1, 2},
                 "buf": [(op, None, "slow")], "store": {9: 42}}, 1),
        mod.Msg("hb", 0, 1, {"t": 0.25}, 0),
        mod.Msg("fast_propose", 1, 3, {"ops": [sized]}, 1, 1 << 20),
        mod.Msg("client_reply", 2, 6, {"op_ids": [8], "results": {8: 41},
                                       "paths": {8: [0.75, "fast"]}, "ops": [read]}, 1),
    ]


def canon(x):
    """A decoded value with each package's ``Msg`` and ``Op`` made a tagged
    tuple, so that the two packages' decodings compare by content and type."""
    if isinstance(x, (sim.Op, ref_sim.Op)):
        return ("Op",) + tuple(canon(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (sim.Msg, ref_sim.Msg)):
        return ("Msg", x.kind, x.src, x.dst, canon(x.payload), x.size_ops, x.size_bytes)
    if isinstance(x, dict):
        return ("dict", tuple((canon(k), canon(v)) for k, v in x.items()))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(canon(v) for v in x)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(canon(v) for v in x))
    return x


@pytest.fixture(params=["msgpack", "json"])
def branch(request, monkeypatch):
    """Both packages' codecs on one branch: msgpack where it is installed,
    or compact JSON, as on an interpreter without msgpack."""
    if request.param == "msgpack":
        pytest.importorskip("msgpack")
        assert codec.msgpack is not None and ref_codec.msgpack is not None
    else:
        monkeypatch.setattr(codec, "msgpack", None)
        monkeypatch.setattr(ref_codec, "msgpack", None)
    return request.param


@pytest.mark.parametrize("index", range(4))
def test_frames_equal_the_reference_and_cross_decode(branch, index):
    port_msg, ref_msg = shapes(sim)[index], shapes(ref_sim)[index]
    frame = codec.encode_msg(port_msg)
    assert frame == ref_codec.encode_msg(ref_msg)
    bodies, tail = codec.split_frames(frame)
    assert tail == b"" and len(bodies) == 1
    mine, theirs = codec.decode_body(bodies[0]), ref_codec.decode_body(bodies[0])
    assert canon(mine) == canon(theirs) == canon(port_msg) == canon(ref_msg)
    assert isinstance(mine, sim.Msg) and isinstance(theirs, ref_sim.Msg)
    assert all(isinstance(op, sim.Op) for op in mine.payload.get("ops", []))
    assert all(isinstance(op, ref_sim.Op) for op in theirs.payload.get("ops", []))


def test_hello_and_partial_frames_equal_the_reference(branch):
    assert codec.encode_hello(4) == ref_codec.encode_hello(4)
    a = codec.encode_msg(sim.Msg("hb", 0, 1, {"t": 0.25}, 0))
    b = ref_codec.encode_hello(4)
    frames, tail = codec.split_frames(a + b[:3])
    assert len(frames) == 1 and tail == b[:3]
    assert (frames, tail) == ref_codec.split_frames(a + b[:3])
    frames2, tail2 = ref_codec.split_frames(tail + b[3:])
    assert tail2 == b"" and codec.decode_hello(frames2[0]) == 4
    # sizeless messages carry no "b" key on either branch
    assert b'"b"' not in a and b"\xa1b" not in a


def test_legacy_frame_and_oversize_as_the_reference(branch):
    """A 9-field ``__op__`` without "b" decodes as sizeless in both packages
    (JSON body, as the reference's case builds it), and both refuse a frame
    above ``MAX_FRAME`` at either end."""
    legacy = json.dumps(
        {"k": "fast_propose", "s": 1, "d": 3, "z": 1,
         "p": {"ops": [{"__op__": [7, 5, 9, "w", 1234, 0.5, -1.0, "", None]}]}},
        separators=(",", ":")).encode()
    if branch == "json":
        old, ref_old = codec.decode_body(legacy), ref_codec.decode_body(legacy)
        assert canon(old) == canon(ref_old)
        assert old.size_bytes == 0 and old.payload["ops"][0].size == 0
    assert codec.MAX_FRAME == ref_codec.MAX_FRAME
    with pytest.raises(ValueError, match="exceeds MAX_FRAME"):
        codec.split_frames(codec.HEADER.pack(codec.MAX_FRAME + 1))
    with pytest.raises(ValueError, match="exceeds MAX_FRAME"):
        codec.encode_msg(sim.Msg("blob", 0, 1, {"v": "x" * (codec.MAX_FRAME + 16)}, 1))


# ---------------------------------------------------------------------------
# loopback clusters: twins of tests/test_transport.py's
# ---------------------------------------------------------------------------

def hold_healthy(art, cfg):
    """Every assertion of the reference's healthy-cluster case."""
    r = art.result
    assert r.clients_done == cfg.n_clients
    assert r.committed_ops == cfg.total_ops
    ok, why = check_history_linearizable(r.history)
    assert ok, why
    ok, why = verify_artifacts(art, check_rsm=False)
    assert ok, why
    if cfg.trace:
        counters = r.metrics["counters"]
        committed_by_path = sum(v for k, v in counters.items()
                                if k.startswith("ops_committed_total"))
        assert committed_by_path == cfg.total_ops
    assert len(r.node_stats) == cfg.n_replicas
    for ns in r.node_stats:
        assert ns["applied"] == cfg.total_ops
        assert not ns["recovering"] and not ns["isolated"]
        assert ns["read_results"] <= READ_RESULTS_CAP
        assert ns["commit_log"] <= READ_RESULTS_CAP
        for ch in ns["channels"]:
            assert ch["queue_hwm"] <= ch["max_queue"]
            assert ch["dropped"] == 0
            assert ch["queue_len"] <= ch["max_queue"]
            assert ch["reconnects"] == 0


def test_served_cluster_history_linearizable_and_bounded():
    """5 replicas + 2 client processes of the port over localhost sockets:
    every op commits, the history is linearizable, the trace's counters sum
    to the op count, and every per-peer table stays bounded."""
    cfg = ClusterConfig(n_replicas=5, n_clients=2, total_ops=400,
                        batch_size=8, seed=11, time_limit_s=45)
    hold_healthy(run_served(cfg), cfg)


def test_served_crash_restart_recovers_over_sockets():
    """SIGKILL replica 0 mid-workload and restart it with --recover, each
    step taken when the sockets show the one before it done: the survivors
    redial, state transfer catches the replica up, and the history stays
    linearizable."""
    cfg = ClusterConfig(n_replicas=5, n_clients=2, total_ops=2400,
                        batch_size=8, seed=13, time_limit_s=60,
                        trace=False)
    art, stages = crash_restart(cfg)
    r = art.result

    assert r.clients_done == cfg.n_clients
    assert r.committed_ops == cfg.total_ops
    ok, why = check_history_linearizable(r.history)
    assert ok, why

    stats = {ns["node"]: ns for ns in r.node_stats}
    assert set(stats) == set(range(cfg.n_replicas))
    assert not stats[0]["recovering"]
    assert stats[0]["applied"] > 0
    for i in range(1, cfg.n_replicas):
        chan0 = next(c for c in stats[i]["channels"] if c["dst"] == 0)
        assert chan0["reconnects"] >= 1, (i, chan0, stages)


def test_reorder_twin_fails_the_checker():
    """The port's frame-reorder mutation must fail the checker on one of
    the reference's seeds, with every op still committed."""
    failed = False
    for seed in (1, 2, 3):
        cfg = ClusterConfig(n_replicas=5, n_clients=3, total_ops=600,
                            batch_size=1, max_inflight=1,
                            reads_fraction=0.35, p_hot=0.9, p_common=0.02,
                            n_hot=1, seed=seed, time_limit_s=60,
                            reorder=True, trace=False)
        r = run_served(cfg).result
        assert r.committed_ops == cfg.total_ops
        ok, _ = check_history_linearizable(r.history)
        if not ok:
            failed = True
            break
    assert failed, "reorder twin produced linearizable histories on every seed"


# ---------------------------------------------------------------------------
# the JSON branch in the processes, and the two packages side by side
# ---------------------------------------------------------------------------

def test_served_cluster_with_msgpack_hidden(tmp_path, monkeypatch):
    """The JSON branch in every process, as on a host without msgpack: the
    healthy twin's assertions, and each replica and client reports it."""
    reports = probed_env(tmp_path, monkeypatch, hide_msgpack=True)
    cfg = ClusterConfig(n_replicas=5, n_clients=2, total_ops=400,
                        batch_size=8, seed=11, time_limit_s=45)
    hold_healthy(run_served(cfg), cfg)
    seen = read_reports(reports)
    roles = sorted(r["argv"][0].rsplit("/", 1)[-1] for r in seen)
    assert roles == ["client_driver.py"] * 2 + ["node_runner.py"] * 5
    assert {r["codec"] for r in seen} == {"json"}
    assert not any(m == "msgpack" for r in seen for m in r["modules"])


def written(history) -> tuple:
    """What the seed fixes in a history: the written (op_id, obj, value)
    and the read (op_id, obj)."""
    return ({(h.op_id, h.obj, h.value) for h in history if h.kind == "w"},
            {(h.op_id, h.obj) for h in history if h.kind == "r"})


def test_port_and_reference_serve_the_same_ops():
    """One small run of each package from one configuration: the same
    committed count, the same writes and the same reads (read results
    depend on timing and are held by the checker instead)."""
    cfg = ClusterConfig(n_replicas=5, n_clients=2, total_ops=200,
                        batch_size=8, seed=5, time_limit_s=45, trace=False)
    ref_cfg = RefClusterConfig(**dataclasses.asdict(cfg))
    mine, theirs = run_served(cfg).result, ref_run_served(ref_cfg).result
    assert mine.committed_ops == theirs.committed_ops == cfg.total_ops
    assert mine.clients_done == theirs.clients_done == cfg.n_clients
    writes, reads = written(mine.history)
    assert (writes, reads) == written(theirs.history)
    assert len(writes) + len(reads) == cfg.total_ops and writes and reads
    for r in (mine, theirs):
        ok, why = check_history_linearizable(r.history)
        assert ok, why
