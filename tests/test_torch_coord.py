"""The port's coordination layer (``repro_torch.coord``) against
``repro.coord``: ``GradQuorum``'s masks, row weights, batch masks and
certificates equal on the same latencies; ``CheckpointConsensus`` and
``Membership`` on the cases of ``tests/test_coord.py`` and against the JAX
package's objects; ``quorum_allreduce`` over ``torch.distributed`` with the
gloo backend in two processes on localhost, expecting the masked mean that
``tests/test_coord.py:71-105`` expects of the JAX package's ``shard_map``
form.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro import coord as jax_coord  # noqa: E402
from repro_torch import coord  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@given(n=st.integers(3, 64), seed=st.integers(0, 2**31))
@settings(max_examples=20, deadline=None)
def test_grad_quorum_equals_jax(n, seed):
    rng = np.random.default_rng(seed)
    got, want = coord.GradQuorum(n, t_fail=2), jax_coord.GradQuorum(n, t_fail=2)
    assert got.state.steepness == want.state.steepness
    for _ in range(3):
        lat = rng.uniform(0.5, 3.0, n)
        got.observe(lat)
        want.observe(lat)
    np.testing.assert_array_equal(got.state.latency_ema, want.state.latency_ema)
    np.testing.assert_array_equal(got.state.weights(), want.state.weights())
    arrivals = rng.uniform(0.0, 2.0, n)
    for arr in (None, arrivals):
        mask = got.commit_mask(arr)
        np.testing.assert_array_equal(mask, want.commit_mask(arr))
        assert got.state.committed_frac == want.state.committed_frac
        np.testing.assert_array_equal(got.row_weights(mask), want.row_weights(mask))
        batch = {"mask": np.ones((2 * n, 5), np.float32)}
        np.testing.assert_array_equal(got.scale_batch_mask(batch, mask)["mask"],
                                      want.scale_batch_mask(batch, mask)["mask"])
        assert got.certificate(7, mask) == want.certificate(7, mask)
        w = got.state.weights()
        assert w[mask].sum() > w.sum() / 2 and mask.sum() >= 2


def test_grad_quorum_cases_of_the_reference():
    gq = coord.GradQuorum(8)
    lat = np.ones(8)
    lat[7] = 10.0
    for _ in range(10):
        gq.observe(lat)
    mask = gq.commit_mask()
    assert not mask[7] and mask.sum() < 8
    rw = coord.GradQuorum(4).row_weights(np.array([True, True, False, True]))
    np.testing.assert_allclose(rw.sum(), 4.0)
    assert rw[2] == 0.0
    gq = coord.GradQuorum(32, t_fail=4)
    lat = np.ones(32)
    lat[-3:] = 4.0
    for _ in range(10):
        gq.observe(lat)
    want = jax_coord.GradQuorum(32, t_fail=4)
    for _ in range(10):
        want.observe(lat)
    stats = gq.expected_step_time(lat, trials=400)
    assert stats == want.expected_step_time(lat, trials=400)
    assert stats["speedup"] > 1.5


@pytest.mark.parametrize("n,t_fail", [(1, 1), (3, 1), (5, 2), (5, 1), (9, 4)])
def test_checkpoint_consensus_equals_jax(tmp_path, n, t_fail):
    got, want = coord.CheckpointConsensus(n, t_fail=t_fail), jax_coord.CheckpointConsensus(
        n, t_fail=t_fail)
    assert isinstance(got.weights, np.ndarray) and got.weights.dtype == np.float32
    np.testing.assert_allclose(got.weights, want.weights, rtol=2e-7)
    assert got.threshold == pytest.approx(want.threshold, rel=2e-7)
    got.propose(3, ["f"])
    want.propose(3, ["f"])
    for h in reversed(range(n)):
        assert got.ack(3, h) == want.ack(3, h)
    assert got.committed_step == want.committed_step == 3
    got.write_manifest(tmp_path, 3)
    assert jax_coord.CheckpointConsensus.latest_committed(tmp_path)["step"] == 3


def test_checkpoint_consensus_cases_of_the_reference(tmp_path):
    cc = coord.CheckpointConsensus(5, t_fail=2)
    cc.propose(100, ["a", "b"])
    assert not cc.ack(100, 4)                     # lightest host alone: no
    committed = False
    for h in (0, 1, 2):
        committed = cc.ack(100, h) or committed
    assert committed
    path = cc.write_manifest(tmp_path, 100)
    assert path.exists() and coord.CheckpointConsensus.latest_committed(tmp_path)["step"] == 100
    other = tmp_path / "other"
    other.mkdir()
    cc = coord.CheckpointConsensus(5)
    cc.propose(1, ["x"])
    for h in range(5):
        cc.ack(1, h)
    cc.write_manifest(other, 1)
    cc.propose(2, ["y"])
    cc.ack(2, 4)                                  # insufficient weight
    cc.write_manifest(other, 2)                   # committed=False inside
    assert coord.CheckpointConsensus.latest_committed(other)["step"] == 1


def test_membership_equals_jax():
    t = [0.0]
    got = coord.Membership(8, hb_timeout=10.0, clock=lambda: t[0])
    want = jax_coord.Membership(8, hb_timeout=10.0, clock=lambda: t[0])
    views = []
    for now, beats in ((0.0, ()), (5.0, [h for h in range(8) if h != 3]), (12.0, ()),
                       (13.0, range(8)), (30.0, (1, 2)), (45.0, ())):
        t[0] = now
        for h in beats:
            got.heartbeat(h)
            want.heartbeat(h)
        g, w = got.view(), want.view()
        assert (g.epoch, g.alive, g.leader, g.mesh_proposal) == (
            w.epoch, w.alive, w.leader, w.mesh_proposal)
        views.append(g)
    assert views[1].epoch == 0 and 3 not in views[2].alive and views[2].epoch == 1
    assert views[2].mesh_proposal["data"] == 7 and 3 in views[3].alive
    assert views[4].leader == 1 and views[5].alive == []


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from repro_torch.coord import quorum_allreduce
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        out = {}
        for name, mask in (("both", [1.0, 1.0]), ("first", [1.0, 0.0]),
                           ("second", [0.0, 1.0]), ("none", [0.0, 0.0])):
            g = {"g": torch.full((3, 4), float(rank + 1)),
                 "h": {"b": torch.arange(4.0) * (rank + 1)},
                 "bf": torch.full((2,), float(rank + 1), dtype=torch.bfloat16)}
            res = quorum_allreduce(g, torch.tensor(mask))
            out[name] = {"g": res["g"].tolist(), "b": res["h"]["b"].tolist(),
                         "bf": res["bf"].tolist(), "bf_dtype": str(res["bf"].dtype),
                         "input_kept": g["g"][0, 0].item()}
        print(json.dumps(out))
    finally:
        dist.destroy_process_group()
""")


def test_quorum_allreduce_over_gloo():
    """Two ranks contribute g = rank + 1: the masked mean is 1.5 with both
    committed, 1 or 2 with one, and 0 with none (the count's max(., 1))."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    expect = {"both": 1.5, "first": 1.0, "second": 2.0, "none": 0.0}
    for out in outs:
        for name, mean in expect.items():
            got = out[name]
            np.testing.assert_allclose(got["g"], np.full((3, 4), mean), rtol=1e-6)
            np.testing.assert_allclose(got["b"], np.arange(4.0) * mean, rtol=1e-6)
            np.testing.assert_allclose(got["bf"], [mean, mean], rtol=1e-6)
            assert got["bf_dtype"] == "torch.float32"     # as JAX promotes bf16 * f32
    # the inputs are not reduced in place
    assert [out["both"]["input_kept"] for out in outs] == [1.0, 2.0]
