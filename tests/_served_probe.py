"""A probe of the processes that a served cluster's launcher starts: each
reports, as it exits, the modules it loaded and its codec branch.

``probed_env`` puts a ``sitecustomize`` on ``PYTHONPATH``, which the
launcher keeps after its own source root, so every replica and client
process imports it at start-up; optionally it hides msgpack from them, as
on a host without it.
"""

import json
import os
import textwrap
from pathlib import Path

PROBE = '''
import atexit, json, os, sys

if os.environ.get("SERVED_PROBE_HIDE_MSGPACK"):
    class _NoMsgpack:
        def find_spec(self, name, path=None, target=None):
            if name == "msgpack" or name.startswith("msgpack."):
                raise ImportError("msgpack hidden from this process")
    sys.meta_path.insert(0, _NoMsgpack())


@atexit.register
def _report():
    c = sys.modules.get("repro_torch.transport.codec")
    path = os.path.join(os.environ["SERVED_PROBE_DIR"], f"{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump({"argv": sys.argv, "modules": sorted(sys.modules),
                   "codec": None if c is None else
                   ("msgpack" if c.msgpack is not None else "json")}, f)
'''


def probed_env(tmp_path, monkeypatch, hide_msgpack=False) -> Path:
    """Make every process the launcher starts report into the returned
    directory; optionally hide msgpack from those processes."""
    site, reports = tmp_path / "site", tmp_path / "reports"
    site.mkdir()
    reports.mkdir()
    (site / "sitecustomize.py").write_text(textwrap.dedent(PROBE))
    pp = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", str(site) if not pp else f"{site}{os.pathsep}{pp}")
    monkeypatch.setenv("SERVED_PROBE_DIR", str(reports))
    if hide_msgpack:
        monkeypatch.setenv("SERVED_PROBE_HIDE_MSGPACK", "1")
    return reports


def read_reports(reports: Path) -> list:
    return [json.loads(p.read_text()) for p in sorted(reports.glob("*.json"))]
