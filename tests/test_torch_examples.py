"""The port's twins of the examples (``examples/*_torch.py``), each run
once on the CPU as a user runs it:

* ``quickstart_torch.py``: the batched quorum commit's committed flags,
  commit times and quorum sizes, printed, equal those of
  ``examples/quickstart.py`` (the JAX package);
* ``serve_lm_torch.py``: the smoke qwen3 served, prefill plus greedy decode;
* ``train_lm_torch.py``: ``--tiny --steps 3`` with ``GradQuorum``'s commit
  masks and the async checkpoint, then ``--resume`` from it to step 5;
* ``woc_kv_store_torch.py``: acts one to three (simulated) print the lines of
  ``examples/woc_kv_store.py``; act four (served over sockets, wall-clock
  times) commits every op, drains both clients and checks the history.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def run(*args, timeout=300) -> str:
    r = subprocess.run([sys.executable, *map(str, args)], capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def quorum_lines(out: str) -> list:
    lines = out.splitlines()
    start = lines.index("batched quorum commit:")
    return lines[start:start + 3]


def test_quickstart_torch_equals_jax():
    got = quorum_lines(run("examples/quickstart_torch.py", "--device", "cpu"))
    want = quorum_lines(run("examples/quickstart.py"))
    assert got == want
    assert got[1] == "  op0: committed=True t=2.0 quorum_size=2"


def test_serve_lm_torch():
    out = run("examples/serve_lm_torch.py", "--device", "cpu", "--gen", "4")
    assert "arch=qwen3-1.7b family=dense" in out
    first = next(line for line in out.splitlines() if line.startswith("first sequence"))
    assert len(ast.literal_eval(first.split(":", 1)[1].strip())) == 4


def test_train_lm_torch_and_resume(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = run("examples/train_lm_torch.py", "--tiny", "--steps", "3", "--device", "cpu",
              "--ckpt", ckpt)
    assert "step    0 loss" in out and "commit " in out
    assert (ckpt / "step_00000003").is_dir()
    out = run("examples/train_lm_torch.py", "--tiny", "--steps", "5", "--device", "cpu",
              "--ckpt", ckpt, "--resume")
    assert "resumed from step 3" in out and "step    4 loss" in out


def served_act(out: str) -> tuple[list, list]:
    """The lines of acts one to three, and act four's lines."""
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("serving over asyncio"))
    return lines[:start], lines[start:]


def test_woc_kv_store_torch_equals_jax():
    got, served = served_act(run("examples/woc_kv_store_torch.py"))
    want, ref_served = served_act(run("examples/woc_kv_store.py"))
    assert got == want
    assert "state-machine safety across replicas: OK" in got
    committed = re.compile(r"  committed (\d+) ops in [0-9.]+s wall-clock")
    assert [committed.match(line).group(1) for line in (served[1], ref_served[1])] == \
        ["800", "800"]
    assert served[2] == ref_served[2] == \
        "  2/2 client processes drained; real history checked linearizable: OK"


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_lm_torch", "train_lm_torch",
                                  "woc_kv_store_torch"])
def test_twins_import_no_jax(name):
    """The twins stand alone: they import the port, never JAX or ``repro``."""
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    mods = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
            for alias in node.names}
    mods |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "repro"}
