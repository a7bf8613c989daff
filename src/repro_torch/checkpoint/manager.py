"""Sharded checkpoints with 2-phase commit + async writer + restart (port
of ``repro.checkpoint.manager``, with the same on-disk layout).

Layout: ``<dir>/step_<S>/host<h>.npz`` (flattened param/opt trees keyed by
logical path names, ``p/<path>`` and ``o/<path>`` with the dict keys of the
path joined by ``/``) + ``manifest_<S>.json`` with the slow-path quorum
certificate (``repro_torch.coord.ckpt_consensus``). The manifest is written
ONLY after every shard file is flushed and fsync'd, so restart-from-latest
can never observe a torn checkpoint: readers take the newest manifest whose
certificate verifies and ignore everything else. A checkpoint written by
either package restores in the other.

bfloat16: ``np.savez`` stores a JAX bf16 array as raw 2-byte records
(``|V2``), and the port writes a bf16 tensor as the same bytes. Restoring,
a ``|V2`` array is read as bf16 bits (reinterpreted through int16, not
cast), then converted to the template leaf's dtype like any other array.
"""

from __future__ import annotations

import json
import os
import pathlib
import queue
import threading
from typing import Tuple

import numpy as np
import torch

from repro_torch.coord.ckpt_consensus import CheckpointConsensus
from repro_torch.tree import tree_items, tree_map

BF16_RECORD = np.dtype("V2")    # how np.savez stores a bfloat16 array


def _to_numpy(leaf) -> np.ndarray:
    """A numpy copy of a tensor (bf16 as ``|V2`` records), or an array."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().to("cpu", copy=True)
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(BF16_RECORD)
    return leaf.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor with the dtype and device of ``like``."""
    if arr.dtype == BF16_RECORD:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree) -> dict:
    return {"/".join(str(k) for k in path): _to_numpy(leaf)
            for path, leaf in tree_items(tree)}


def _unflatten_into(tree, flat: dict, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, prefix + (k,)) for k, v in tree.items()}
    key = "/".join(str(k) for k in prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(tree.shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"{arr.shape} vs {tuple(tree.shape)}")
    return _to_tensor(arr, tree)


def save_shard(directory, step: int, host: int, params, opt_state) -> str:
    d = pathlib.Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"host{host}.npz"
    tmp = d / f".host{host}.npz.tmp"
    payload = {f"p/{k}": v for k, v in _flatten(params).items()}
    payload.update({f"o/{k}": v for k, v in _flatten(opt_state).items()})
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())            # phase 1: durable shard
    tmp.rename(path)
    return str(path)


def save(directory, step: int, params, opt_state, *, n_hosts: int = 1,
         host: int = 0) -> str:
    """Single-host convenience: shard write + immediate quorum-of-one
    manifest (the multi-host path drives CheckpointConsensus explicitly)."""
    path = save_shard(directory, step, host, params, opt_state)
    cc = CheckpointConsensus(max(n_hosts, 3))
    cc.propose(step, [path])
    for h in range(max(n_hosts, 3)):    # all local shards durable
        cc.ack(step, h)
    cc.write_manifest(directory, step)  # phase 2: commit point
    return path


def restore_latest(directory, params_template, opt_template
                   ) -> Tuple[object, object, int]:
    """The newest committed checkpoint as trees with the templates' keys,
    dtypes and devices, and its step."""
    m = CheckpointConsensus.latest_committed(directory)
    if m is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    step = m["step"]
    flat = {}
    d = pathlib.Path(directory) / f"step_{step:08d}"
    for shard in sorted(d.glob("host*.npz")):
        with np.load(shard) as z:
            flat.update({k: z[k] for k in z.files})
    params = _unflatten_into(params_template,
                             {k[2:]: v for k, v in flat.items()
                              if k.startswith("p/")})
    opt = _unflatten_into(opt_template,
                          {k[2:]: v for k, v in flat.items()
                           if k.startswith("o/")})
    return params, opt, step


class AsyncCheckpointer:
    """Background writer thread: training never blocks on disk."""

    def __init__(self, directory, n_hosts: int = 1):
        self.directory = directory
        self.n_hosts = n_hosts
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.errors: list = []

    def save(self, step: int, params, opt_state) -> None:
        # snapshot to host memory NOW (the step updates parameters in place)
        p = tree_map(_to_numpy, params)
        o = tree_map(_to_numpy, opt_state)
        self._q.put((step, p, o))

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, p, o = item
            try:
                save(self.directory, step, p, o, n_hosts=self.n_hosts)
            except Exception as e:     # surfaced via .errors in wait()
                self.errors.append(e)
            finally:
                self._q.task_done()

    def wait(self):
        self._q.join()
        if self.errors:
            raise self.errors[0]
