"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under ``build/repro_torch/``
at the root of the checkout, which ``.gitignore`` lists. A library's file name
carries a hash of its source, of every header ``csrc/*.cuh`` and of the
compiler flags, so a stale build is never loaded. Libraries are loaded with
``ctypes``. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--resource-usage")

_loaded: dict[str, ctypes.CDLL] = {}
# What nvcc printed for each source built by this process: with
# --resource-usage, each kernel's registers, spills and shared memory.
compiler_output: dict[str, str] = {}


def sources() -> list[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where the library built from the current ``csrc/<name>.cu`` and the
    current headers ``csrc/*.cuh`` lives."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode())
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def nvcc() -> str:
    """Path of the CUDA compiler: on ``PATH``, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("repro_torch: nvcc not found on PATH or in $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile each named source (default: all) that has no library for its
    current hash, one ``nvcc`` per source, all started together.

    Returns the library path of every name; raises ``RuntimeError`` with the
    compiler's output if any compile fails.
    """
    paths = {name: library_path(name) for name in (names or sources())}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    running = []
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        output, _ = proc.communicate()
        compiler_output[name] = output
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu: nvcc exited {proc.returncode}\n{output}")
    if failures:
        raise RuntimeError("repro_torch: kernel build failed\n" + "\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
