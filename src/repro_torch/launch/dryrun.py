"""Multi-pod dry-run (port of ``repro.launch.dryrun``): trace every
(arch x shape x mesh) cell once on fake tensors.

Per cell:
  * a fake process group (backend ``"fake"`` over a ``FakeStore``) with the
    production mesh's ranks, this process rank 0, and the production mesh
    on it (``launch.mesh.make_production_mesh``: 16x16 single-pod,
    2x16x16 multi-pod) — on the default device type, CUDA where there is
    one, else the CPU;
  * parameters, optimizer state, batch and cache as rank 0's local shards,
    placed by ``tree_shardings``/``batch_spec_tree`` and wrapped as
    DTensors: fake tensors (``FakeTensorMode``), shapes, dtypes and a
    device without storage, built from ``abstract_params``,
    ``abstract_opt_state``, ``abstract_cache`` and ``configs.base.input_specs``
    — a 340B model is never allocated and no weight is drawn;
  * the right step (``make_train_step`` / ``make_prefill_step`` /
    ``make_decode_step``, each with ``rules=``) run once under the cost
    counter (``launch.op_analysis``), which also follows the bytes of the
    storages the step creates; K2 and K3 reach their ops' fakes on fake CUDA
    tensors (their plain versions on a CPU mesh, as the reference's dry-run
    on CPU devices traces its ``ref`` path);
  * a record with the reference's keys: memory per device and the roofline
    (``launch.roofline``), written as JSON.

Differences from the reference. Nothing is compiled: ``lower_s`` is the
trace's seconds and ``compile_s`` has no counterpart. Memory per device:
``argument`` the inputs' local shards; ``output`` the step's outputs;
``alias`` the outputs that are inputs updated in place (the parameters and
moments of a train step, the cache of a decode step), which JAX donates;
``temp`` the most bytes of storages the step created that were alive at
once, less the new outputs; ``peak_estimate`` argument + temp + output -
alias, as the reference sums it. Importing this module changes no process
state: the fake group is created in :func:`lower_cell` and destroyed at its
end, and the call raises where a default process group exists already.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.launch import op_analysis, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import abstract_cache, make_decode_step, make_prefill_step
from repro_torch.launch.shardings import make_rules
from repro_torch.launch.train import (abstract_opt_state, abstract_params, batch_spec_tree,
                                      make_train_step, tree_shardings)
from repro_torch.models import family
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.tree import tree_map


def skip_reason(cfg, shape_name):
    sh = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: 512k decode needs sub-quadratic "
                "attention (assignment rule; see DESIGN.md)")
    return None


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0; destroyed on the way out. Raises where a default group exists."""
    if dist.is_initialized():
        raise RuntimeError("dry-run: a default process group exists already; the "
                           "dry-run makes its own fake one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_like(tree, device, fake_mode):
    """Fake tensors of ``tree``'s shapes and dtypes on ``device``."""
    with fake_mode:
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def fake_shards(tree, mesh, placements, fake_mode):
    """``tree`` (tensors of the global shapes) as DTensors on ``mesh`` with
    ``placements`` (a tree of them), each holding rank 0's local shard as a
    fake tensor on the mesh's device type."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def leaf(t, pl):
        shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        with fake_mode:
            local = torch.empty(shape, dtype=t.dtype, device=mesh.device_type)
            return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                      stride=t.stride())
    return tree_map(leaf, tree, placements)


def _storages(obj) -> dict:
    """id -> bytes of the distinct storages of the tensors in ``obj`` (a
    DTensor's local shard)."""
    storages = (op_analysis._local(t).untyped_storage() for t in op_analysis._tensors(obj))
    return {id(st): st.nbytes() for st in storages}


def trace(fn, args, fake_mode):
    """``fn(*args)`` once on fake tensors under the cost counter. Returns
    (costs, the memory record, the trace's seconds)."""
    t0 = time.perf_counter()
    with fake_mode, op_analysis.count(args) as counter:
        out = fn(*args)
        seconds = time.perf_counter() - t0
        given, made = _storages(args), _storages(out)
        argument, output = sum(given.values()), sum(made.values())
        alias = sum(b for k, b in made.items() if k in given)
        temp = max(0, counter.peak_bytes - (output - alias))
    memory = {"argument_bytes_per_device": argument, "output_bytes_per_device": output,
              "temp_bytes_per_device": temp, "alias_bytes_per_device": alias,
              "peak_estimate_per_device": argument + temp + output - alias}
    return counter.costs, memory, seconds


def trace_step(cfg, kind: str, inputs: dict, *, mesh=None, device=None, cache=None):
    """One step of ``cfg`` (``kind`` train, prefill or decode) traced on fake
    tensors: the batch ``inputs`` (``input_specs``' keys, ``meta`` tensors
    of the global shapes) and, for decode, ``cache`` (``abstract_cache``).
    Sharded on ``mesh`` (``rules`` from it; rank 0's local shards), else
    unsharded on ``device``. Parameters and moments from
    ``abstract_params``/``abstract_opt_state``. Returns :func:`trace`'s
    (costs, memory, seconds)."""
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    fam = family(cfg)
    fake_mode = FakeTensorMode()
    rules = make_rules(mesh) if mesh is not None else None
    if rules is None:
        def place(tree, specs):
            return fake_like(tree, device, fake_mode)
        pspecs = None
    else:
        def place(tree, specs):
            return fake_shards(tree, mesh, tree_shardings(mesh, tree, specs, rules), fake_mode)
        pspecs = fam.param_specs(cfg, rules)
    params = place(abstract_params(cfg), pspecs)
    if kind == "train":
        opt_state = place(abstract_opt_state(cfg, opt_cfg),
                          pspecs and adamw.state_specs(pspecs))
        fn = make_train_step(cfg, opt_cfg, rules=rules)
        args = (params, opt_state, place(inputs, batch_spec_tree(inputs)), 0)
    elif kind == "prefill":
        fn = make_prefill_step(cfg, rules=rules)
        args = (params, place(inputs, batch_spec_tree(inputs)))
    else:
        inputs = place(inputs, batch_spec_tree(inputs))
        fn = make_decode_step(cfg, rules=rules)
        args = (params, place(cache, rules and fam.cache_specs(cfg, rules)),
                inputs["token"], inputs["pos"])
    with torch.enable_grad() if kind == "train" else torch.no_grad():
        return trace(fn, args, fake_mode)


def lower_cell(arch: str, shape_name: str, multi_pod: bool):
    cfg = configs.get(arch)
    reason = skip_reason(cfg, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
                "status": "SKIP", "reason": reason}

    sh = SHAPES[shape_name]
    S, B, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        costs, memory, t_lower = trace_step(
            cfg, kind, input_specs(cfg, shape_name), mesh=mesh,
            cache=abstract_cache(cfg, B, S) if kind == "decode" else None)
        rf = roofline.analyze(costs, chips=chips,
                              model_flops=roofline.model_flops_for(cfg, shape_name))

    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
        "status": "OK", "chips": chips, "kind": kind,
        "lower_s": round(t_lower, 1), "memory": memory,
        "kernel_calls": dict(costs.calls), "roofline": rf.to_dict(),
    }


def run_cell(arch, shape_name, multi_pod, out_dir):
    tag = f"{arch}_{shape_name}_{mesh_name(multi_pod)}"
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{tag}.json"
    try:
        rec = lower_cell(arch, shape_name, multi_pod)
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    path.write_text(json.dumps(rec, indent=2))
    status = rec["status"]
    extra = ""
    if status == "OK":
        r = rec["roofline"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
                 f"{r['t_collective_s']:.2e})s"
                 f" mem/dev={rec['memory']['peak_estimate_per_device']/2**30:.2f}GiB"
                 f" trace={rec['lower_s']:.0f}s")
    elif status == "FAIL":
        extra = " " + rec["error"][:160]
    print(f"[{status}] {tag}{extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    ok = fail = skip = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                rec = run_cell(arch.replace("_", "-"), shape_name, mp,
                               args.out)
                ok += rec["status"] == "OK"
                fail += rec["status"] == "FAIL"
                skip += rec["status"] == "SKIP"
    print(f"\ndry-run complete: {ok} OK, {skip} SKIP, {fail} FAIL")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
