"""The port's protocol stack is a copy of the reference's, module for module.

These modules compute in numpy and plain Python and import no JAX, so the
port keeps copies of them rather than rewrites (ROADMAP, queue 1). Each
copy must equal its reference after one substitution: every module path
``repro.`` (and ``repro/``) becomes ``repro_torch.`` (``repro_torch/``), in
imports and in the strings and comments that name modules, and so does the
package's bare name (``import repro``, whose ``__file__`` the served
launcher puts on its processes' path). The only other
differences are the docstring lines listed in ``REWORDED``, with the reason.
``tests/test_torch_protocol.py`` holds the copies' runs to the reference's.
"""

import pytest

torch = pytest.importorskip("torch")

import re  # noqa: E402
from pathlib import Path  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CORE = ("simulator", "rsm", "protocol_base", "fastpath", "slowpath", "object_manager",
        "woc", "cabinet", "epaxos", "leases", "reassign", "runner")
PACKAGES = ("scenario", "faults", "shard", "obs", "verify", "coding", "transport")
MODULES = [f"core/{name}.py" for name in CORE] + [
    f"{pkg}/{path.name}" for pkg in PACKAGES
    for path in sorted((SRC / "repro" / pkg).glob("*.py"))]


# Lines of the reference (numbered from 1) whose docstrings name, by number,
# the change requests that built the engine; the port's lines say what those
# changes were instead, since its program files name no change request.
# Docstrings only: no code differs.
REWORDED = {"core/simulator.py": (23, 30, 45, 62, 63, 77), "core/rsm.py": (28,),
            "shard/parallel.py": (10,), "obs/__init__.py": (5,),
            # the soak contract is pinned for the port by its own test file
            "transport/net.py": (28,)}


def renamed(text: str) -> str:
    """The reference's source with every module path moved to the port."""
    return re.sub(r"\brepro\b", "repro_torch", text)


def test_every_module_of_the_stack_is_copied():
    assert len(MODULES) == 46
    for pkg in PACKAGES:
        ref = {p.name for p in (SRC / "repro" / pkg).glob("*.py")}
        port = {p.name for p in (SRC / "repro_torch" / pkg).glob("*.py")}
        assert port == ref, pkg


@pytest.mark.parametrize("module", MODULES)
def test_copy_equals_the_reference_after_renaming(module):
    want = renamed((SRC / "repro" / module).read_text()).split("\n")
    port = (SRC / "repro_torch" / module).read_text()
    got = port.split("\n")
    assert len(got) == len(want)
    differ = tuple(i + 1 for i, (g, w) in enumerate(zip(got, want)) if g != w)
    assert differ == REWORDED.get(module, ())
    assert not re.search(r"\brepro\b", port)
