"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the JAX package ``repro``, by source and at run time, nor
does any process that the port's served launcher starts."""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from _served_probe import probed_env, read_reports  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_repro():
    assert len(PORT_FILES) > 5
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES[:-1]}
    for module in ("models/transformer", "launch/train", "optim/adamw",
                   "optim/schedule", "optim/grad_compress", "data/pipeline",
                   "coord/ckpt_consensus", "coord/grad_quorum", "coord/membership",
                   "checkpoint/manager", "tree", "launch/dryrun", "launch/roofline",
                   "launch/op_analysis", "core/simulator", "core/rsm",
                   "core/protocol_base", "core/fastpath", "core/slowpath",
                   "core/object_manager", "core/woc", "core/cabinet", "core/epaxos",
                   "core/leases", "core/reassign", "core/runner", "scenario/build",
                   "scenario/registry", "scenario/spec", "scenario/workloads",
                   "faults/schedule", "faults/nemesis", "shard/shard_map", "shard/gate",
                   "shard/groupview", "shard/router", "shard/runner", "shard/parallel",
                   "obs/spans", "obs/metrics", "obs/export", "obs/critical_path",
                   "verify/history", "verify/linearizability", "verify/recovery",
                   "coding/rs", "coding/policy", "coding/manager", "transport/__init__",
                   "transport/codec", "transport/net", "transport/node_runner",
                   "transport/client_driver", "transport/launcher", "launch/served"):
        assert f"repro_torch/{module}.py" in names
    bad = [(path.relative_to(ROOT).as_posix(), mod)
           for path in PORT_FILES for mod in imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.launch.serve\n"
        "import repro_torch.models.transformer, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.coord\n"
        "import repro_torch.checkpoint, repro_torch.tree\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
        "import repro_torch.core.runner, repro_torch.scenario, repro_torch.shard\n"
        "import repro_torch.faults, repro_torch.verify, repro_torch.obs\n"
        "import repro_torch.coding, repro_torch.core.leases, repro_torch.core.reassign\n"
        "import repro_torch.coding.manager, repro_torch.shard.parallel\n"
        "import repro_torch.transport, repro_torch.transport.node_runner\n"
        "import repro_torch.transport.client_driver, repro_torch.launch.served\n"
        "import chip_smoke\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('repro', 'jaxlib'))\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_served_processes_load_no_jax_and_no_repro(tmp_path, monkeypatch):
    """Every replica and client process of a small served run of the port
    reports, at exit, the modules it loaded: the port's, never JAX's or the
    JAX package's."""
    from repro_torch.transport import ClusterConfig, run_served

    reports = probed_env(tmp_path, monkeypatch)
    cfg = ClusterConfig(n_replicas=3, n_clients=1, total_ops=64, batch_size=8,
                        time_limit_s=45, trace=False)
    assert run_served(cfg).result.committed_ops == cfg.total_ops
    seen = read_reports(reports)
    roles = sorted(r["argv"][0].rsplit("/", 1)[-1] for r in seen)
    assert roles == ["client_driver.py"] + ["node_runner.py"] * 3
    for r in seen:
        assert "repro_torch.transport.codec" in r["modules"], r["argv"]
        bad = [m for m in r["modules"] if m.split(".")[0] in FORBIDDEN]
        assert not bad, (r["argv"], bad)


def test_served_processes_load_no_torch(tmp_path, monkeypatch):
    """The replica and client processes run the protocol stack, which needs
    numpy and no tensor: none of them imports torch, whose import made up
    most of a served cluster's start."""
    from repro_torch.transport import ClusterConfig, run_served

    reports = probed_env(tmp_path, monkeypatch)
    cfg = ClusterConfig(n_replicas=3, n_clients=1, total_ops=64, batch_size=8,
                        time_limit_s=45, trace=True)
    assert run_served(cfg).result.committed_ops == cfg.total_ops
    seen = read_reports(reports)
    assert len(seen) == 4
    for r in seen:
        loaded = [m for m in r["modules"] if m.split(".")[0] == "torch"]
        assert not loaded, (r["argv"], loaded[:5])
