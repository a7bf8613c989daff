"""Is the served path's crash-and-restart run steady on this host? Runs
``chip_smoke.SERVED_CRASH`` (5 replicas, 2 clients, 2,400 ops, seed 13: the
configuration of tests/test_transport.py's crash case) ``--runs`` times
through ``launch.served.crash_restart``, each held as ``chip_smoke.py``
holds it, and prints one JSON line per run (its verdict, or the error
that failed it, and each stage's seconds) and a summary line.

    PYTHONPATH=src python experiments/served_drill.py [--runs 5]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.launch.served import crash_restart  # noqa: E402
from repro_torch.transport import ClusterConfig  # noqa: E402
from repro_torch.transport import codec  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    passed = 0
    for i in range(args.runs):
        cfg = ClusterConfig(**cs.SERVED_CRASH)
        t0 = time.perf_counter()
        try:
            art, stages = crash_restart(cfg)
            ok, row = True, cs.hold_crash_restart(art, cfg, stages)
        except Exception as e:                       # a failed run is a reading here
            ok, row = False, {"error": f"{type(e).__name__}: {e}"}
        passed += ok
        print(json.dumps({"run": i, "ok": ok, "wall_s": time.perf_counter() - t0, **row}),
              flush=True)
    print(json.dumps({"served_drill": {
        "runs": args.runs, "passed": passed,
        "codec": "msgpack" if codec.msgpack is not None else "json",
        "host_cpu": cs.host_cpu()}}))
    return 0 if passed == args.runs else 1


if __name__ == "__main__":
    sys.exit(main())
