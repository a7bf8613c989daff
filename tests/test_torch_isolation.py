"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the JAX package ``repro``, by source and at run time."""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

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
                   "launch/op_analysis"):
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
