"""Sharded training and serving in the port on 4 gloo processes, and the
MoE's group-local dispatch against the JAX package's on 4 host devices.

Four processes (``tests/_torch_sharded_worker.py``, torch on one thread
each) form a (2, 2) ("data", "model") mesh over gloo and run, in float32:

* qwen3-1.7b (smoke) trained two steps with 2 microbatches and remat
  through ``make_train_step(..., rules=make_rules(mesh))``: the loss and
  ``grad_norm`` at 1e-5 relative and every parameter at 1e-4 of the
  single-process port step's (moments too);
* the loss and every gradient leaf of the smoke qwen3, zamba2, granite-moe,
  seamless and internvl2 at 1e-5 relative (loss) and 1e-4 of the largest
  gradient;
* the same five served, prefill plus 2 greedy decode steps: logits at 1e-5
  (K2 and K3's plain versions through ``local_map``, the flash-decoding
  softmax over a sequence-split cache), equal greedy tokens, caches at 1e-4
  of their largest entry;
* qwen3's loss over a batch without a mask;
* granite-moe's loss at G = 2 dispatch groups: equal to the single process
  given plain tensors and the same rules, and not to G = 1;
* the train step's ``grad_shard``: reduce-scatters, no all-reduce, for
  the gradients of parameters sharded on every mesh dim;
* ``quorum_allreduce`` over the dp mesh dim's process group.

The single-process references of an MoE family take the same rules on
plain tensors: its dispatch groups come from the rules.

Then granite-moe's ``moe_mlp`` and ``loss_fn`` under the Rules of a (2, 2)
mesh against JAX's under ``with mesh:`` with 4 host devices (a subprocess,
as ``tests/test_dryrun_small.py`` runs JAX), at the tolerances of
``tests/test_torch_moe.py``, at a capacity factor low enough that pairs
drop; G = 2 and G = 1 differ there, on both sides, so the test can tell a
wrong G.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch.shardings import Rules  # noqa: E402
from repro_torch.models import family, moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
LOGITS_TOL = 1e-5
MOE_TOL = 1e-4                      # tests/test_torch_moe.py's
NEAR_TIE = 1e-5                     # a router gap this small may pick otherwise
ARCHS = ("qwen3-1.7b", "zamba2-1.2b", "granite-moe-3b-a800m", "seamless-m4t-medium",
         "internvl2-26b")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' run and the JAX subprocess (``JAX_MOE``, below),
    started together, once for the module: rank 0's report and the path of
    JAX's arrays."""
    tmp = tmp_path_factory.mktemp("sharded")
    report, arrays = tmp / "report.json", tmp / "moe.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", JAX_MOE, str(arrays)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT)]
    procs += [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_sharded_worker.py"),
                                str(r), str(port), str(WORLD), str(report)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                               env=env, cwd=ROOT) for r in range(WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return json.loads(report.read_text()), arrays


@pytest.fixture(scope="module")
def sharded(runs):
    return runs[0]


def close(pair, rtol):
    got, want = pair
    return abs(got - want) <= rtol * abs(want)


def test_train_step(sharded):
    """qwen3's sharded train step equals the single-process one."""
    case = sharded["train"]
    assert sharded["mesh"] == [2, 2] and case["placements_kept"]
    for k in ("loss", "grad_norm"):
        assert all(close(pair, LOSS_RTOL) for pair in case[k]), (k, case[k])
    assert case["params"]["err"] <= PARAM_TOL, case["params"]
    assert case["moments"]["err"] <= PARAM_TOL * case["moments"]["scale"], case["moments"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(sharded, arch):
    case = sharded[f"grads/{arch}"]
    assert close(case["loss"], LOSS_RTOL), case["loss"]
    assert case["grads"]["err"] <= PARAM_TOL * case["grads"]["scale"], case["grads"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving(sharded, arch):
    case = sharded[f"serve/{arch}"]
    assert case["logits"]["err"] <= LOGITS_TOL, case["logits"]
    assert case["cache"]["err"] <= PARAM_TOL * case["cache"]["scale"], case["cache"]
    assert case["tokens_equal"]


def test_loss_without_mask(sharded):
    """No mask: the mean of the dp shards' equal means."""
    assert close(sharded["no_mask"]["loss"], LOSS_RTOL), sharded["no_mask"]


def test_moe_groups(sharded):
    """G = 2 sharded equals G = 2 on one process, which differs from G = 1."""
    case = sharded["moe_groups"]
    assert case["groups"] == 2
    assert close(case["loss"], LOSS_RTOL), case["loss"]
    assert case["grads"]["err"] <= PARAM_TOL * case["grads"]["scale"], case["grads"]
    assert abs(case["loss"][1] - case["loss_g1"]) > 100 * LOSS_RTOL * abs(case["loss_g1"])


def test_grad_shard_reduce_scatters(sharded):
    """A fresh gradient reaches its parameter's placements by
    reduce-scatters where the parameter is sharded on every mesh dim, never
    by an all-reduce; a replicated parameter's gradient is all-reduced."""
    leaves = {k: v for k, v in sharded["grad_shard"].items() if k != "seconds"}
    sharded_leaves = [v for v in leaves.values() if v["param_sharded_on_every_dim"]]
    assert len(sharded_leaves) >= 6
    for name, leaf in leaves.items():
        if leaf["param_sharded_on_every_dim"]:
            assert "all_reduce" not in leaf["comms"], (name, leaf)
        if leaf["param_replicated"]:
            assert set(leaf["comms"]) <= {"all_reduce"}, (name, leaf)
    assert sum(v["comms"].get("reduce_scatter_tensor", 0) for v in sharded_leaves) >= 6


def test_quorum_allreduce_over_dp_group(sharded):
    """Data ranks 0 and 1 contribute 1 and 2: the mean over the dp group."""
    assert sharded["quorum"]["mean"] == [1.5, 1.5, 1.5]


# ---------------------------------------------------------------------------
# the group-local dispatch against JAX on 4 host devices
# ---------------------------------------------------------------------------

CAPACITY = 0.3          # low enough that pairs drop
B, S = 4, 16

JAX_MOE = textwrap.dedent(f"""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro import configs
    from repro.launch.shardings import make_rules
    from repro.models import family, moe

    cfg = dataclasses.replace(configs.smoke("granite-moe-3b-a800m"), param_dtype="float32",
                              compute_dtype="float32", capacity_factor={CAPACITY})
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = make_rules(mesh)
    params = family(cfg).init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(({B}, {S}, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(2, cfg.vocab, ({B}, {S} + 1)).astype(np.int32)
    batch = {{"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
              "mask": np.ones(({B}, {S}), np.float32)}}
    layer = jax.tree.map(lambda t: t[0], params["layers"])["moe"]
    with mesh:
        y2 = jax.jit(lambda p, x: moe.moe_mlp(p, cfg, x, rules))(layer, x)
        l2 = jax.jit(lambda p, b: family(cfg).loss_fn(cfg, p, b, rules))(params, batch)
    y1 = moe.moe_mlp(layer, cfg, jnp.asarray(x), None)
    l1 = family(cfg).loss_fn(cfg, params, batch, None)
    flat = {{"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(params)}}
    np.savez(sys.argv[1], y2=np.asarray(y2), y1=np.asarray(y1), l2=np.asarray(l2),
             l1=np.asarray(l1), x=x, **batch, **{{"param/" + k: v for k, v in flat.items()}})
""")


@pytest.fixture(scope="module")
def jax_moe(runs):
    """JAX's outputs, and its parameters as the port's tensors."""
    out = runs[1]
    data = dict(np.load(out))
    tree = {}
    for key, v in data.items():
        if key.startswith("param/"):
            *path, leaf = key[len("param/"):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = v
    return data, convert.params_from_jax(tree, device="cpu")


def port_cfg():
    import dataclasses
    return dataclasses.replace(configs.smoke("granite-moe-3b-a800m"), param_dtype="float32",
                               compute_dtype="float32", capacity_factor=CAPACITY)


RULES = Rules(axis_sizes={"data": 2, "model": 2}, dp_axes=("data",), tp_axis="model")


class RouterGaps:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over every routing call, and the pairs that dropped."""

    def __init__(self, monkeypatch, cfg):
        self.gap, self.cfg = float("inf"), cfg
        route = moe.route

        def recording(params, cfg_, xf):
            top_p, top_e, probs = route(params, cfg_, xf)
            top = torch.topk(probs, cfg_.top_k + 1, dim=-1).values
            self.gap = min(self.gap, float((top[:, -2] - top[:, -1]).min()))
            return top_p, top_e, probs
        monkeypatch.setattr(moe, "route", recording)


def test_moe_mlp_groups_equal_jax(jax_moe, monkeypatch):
    """moe_mlp at G = 2 (the rules of a (2, 2) mesh) and at G = 1 (no rules)
    against JAX's; the two differ on both sides."""
    data, params = jax_moe
    cfg = port_cfg()
    gaps = RouterGaps(monkeypatch, cfg)
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.from_numpy(data["x"])
    with torch.no_grad():
        y2 = moe.moe_mlp(layer, cfg, x, RULES)
        y1 = moe.moe_mlp(layer, cfg, x)
    assert gaps.gap >= NEAR_TIE
    np.testing.assert_allclose(y2.numpy(), data["y2"], atol=MOE_TOL, rtol=MOE_TOL)
    np.testing.assert_allclose(y1.numpy(), data["y1"], atol=MOE_TOL, rtol=MOE_TOL)
    # pairs drop at this capacity, and where they drop depends on the groups
    Tl = B * S // 2
    assert moe.group_capacity(cfg, RULES, Tl) * cfg.n_experts < Tl * cfg.top_k
    assert np.abs(data["y2"] - data["y1"]).max() > 100 * MOE_TOL
    assert (y2 - y1).abs().max() > 100 * MOE_TOL


def test_moe_loss_groups_equal_jax(jax_moe, monkeypatch):
    """granite-moe's loss at G = 2 and G = 1 against JAX's."""
    data, params = jax_moe
    cfg = port_cfg()
    gaps = RouterGaps(monkeypatch, cfg)
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "targets", "mask")}
    fam = family(cfg)
    with torch.no_grad():
        l2 = float(fam.loss_fn(cfg, params, batch, RULES))
        l1 = float(fam.loss_fn(cfg, params, batch))
    assert gaps.gap >= NEAR_TIE
    assert l2 == pytest.approx(float(data["l2"]), rel=MOE_TOL, abs=MOE_TOL)
    assert l1 == pytest.approx(float(data["l1"]), rel=MOE_TOL, abs=MOE_TOL)
    assert abs(float(data["l2"]) - float(data["l1"])) > 10 * MOE_TOL
