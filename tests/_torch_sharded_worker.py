"""One rank of ``tests/test_torch_sharded.py``: the port's sharded entry
points on a (2, 2) ("data", "model") mesh of gloo processes, each against
the same entry point run unsharded in this process, in float32.

    python tests/_torch_sharded_worker.py RANK PORT WORLD OUT_JSON

Rank 0 also runs each case unsharded and writes, per case, the largest
distance between the sharded and the unsharded results beside the size of
the unsharded ones (``OUT_JSON``). Parameters are drawn on every rank from
one generator and distributed (``launch.train.distribute_tree``), so both
runs start equal. The unsharded run of an MoE family is given the same
rules on plain tensors: its dispatch groups come from the rules (``G`` = the
dp size), so without them it would compute another function.
"""

import dataclasses
import json
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.coord import quorum_allreduce
from repro_torch.data import DataConfig
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.shardings import P, make_rules
from repro_torch.models import family, layers as L
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.tree import tree_items, tree_map

B, S, DECODE = 4, 16, 2
TRAIN_STEPS = (200, 201)          # full learning rate in a 300-step schedule
ARCHS = ("qwen3-1.7b", "zamba2-1.2b", "granite-moe-3b-a800m", "seamless-m4t-medium",
         "internvl2-26b")


def f32(arch, **kw):
    return dataclasses.replace(configs.smoke(arch), param_dtype="float32",
                               compute_dtype="float32", **kw)


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def distance(got, want) -> dict:
    """Largest absolute distance over matching leaves, and the largest
    magnitude of ``want``."""
    err = scale = 0.0
    for (_, g), (_, w) in zip(tree_items(got), tree_items(want)):
        err = max(err, float((whole(g).float() - w.float()).abs().max()))
        scale = max(scale, float(w.float().abs().max()))
    return {"err": err, "scale": scale}


def reference_rules(cfg, rules):
    return rules if cfg.family == "moe" else None


def train_case(mesh, rules, ref: bool):
    """qwen3's train step, twice, 2 microbatches and remat: loss, grad norm
    and every parameter and moment after the steps."""
    cfg = f32("qwen3-1.7b", microbatches=2, remat=True)
    fam = family(cfg)
    opt = AdamWConfig(lr=1e-3)
    draw = lambda: fam.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p1 = train.distribute_tree(draw(), mesh, fam.param_specs(cfg, rules), rules)
    o1 = adamw.init(p1, opt)
    sharded = train.make_train_step(cfg, opt, rules=rules, total_steps=300)
    if ref:
        p0 = draw()
        o0 = adamw.init(p0, opt)
        plain = train.make_train_step(cfg, opt, total_steps=300)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=2 * B, seed=1)
    out = {"loss": [], "grad_norm": []}
    for step in TRAIN_STEPS:
        batch = train.train_batch(cfg, dcfg, step, "cpu")
        sb = train.distribute_tree(batch, mesh, train.batch_spec_tree(batch), rules)
        p1, o1, m1 = sharded(p1, o1, sb, step)
        if ref:
            p0, o0, m0 = plain(p0, o0, batch, step)
            for k in ("loss", "grad_norm"):
                out[k].append([float(m1[k]), float(m0[k])])
    out["placements_kept"] = all(isinstance(t, DTensor) for _, t in tree_items(p1))
    p1, o1 = whole_tree(p1), whole_tree({"m": o1["m"], "v": o1["v"]})
    if ref:
        out["params"] = distance(p1, p0)
        out["moments"] = distance(o1, {"m": o0["m"], "v": o0["v"]})
    return out


def whole_tree(tree):
    return tree_map(whole, tree)


def grads_case(arch, mesh, rules, ref: bool):
    """The loss and every gradient leaf (remat is the train case's)."""
    cfg = f32(arch)
    fam = family(cfg)
    params = fam.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = train.train_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                              seed=2), 0, "cpu")
    loss = lambda r: (lambda p, b: fam.loss_fn(cfg, p, b, r))
    sp = train.distribute_tree(params, mesh, fam.param_specs(cfg, rules), rules)
    sb = train.distribute_tree(batch, mesh, train.batch_spec_tree(batch), rules)
    l1, g1 = train.value_and_grad(loss(rules), sp, sb)
    l1, g1 = float(whole(l1)), whole_tree(g1)
    if not ref:
        return {}
    l0, g0 = train.value_and_grad(loss(reference_rules(cfg, rules)), params, batch)
    return {"loss": [l1, float(l0)], "grads": distance(g1, g0)}


def no_mask_case(mesh, rules, ref: bool):
    """qwen3's loss over a batch without a mask (the mean of equal shards'
    means)."""
    cfg = f32("qwen3-1.7b")
    fam = family(cfg)
    params = fam.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = train.train_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                              seed=4), 0, "cpu")
    del batch["mask"]
    sp = train.distribute_tree(params, mesh, fam.param_specs(cfg, rules), rules)
    sb = train.distribute_tree(batch, mesh, train.batch_spec_tree(batch), rules)
    with torch.no_grad():
        l1 = float(whole(fam.loss_fn(cfg, sp, sb, rules)))
        return {"loss": [l1, float(fam.loss_fn(cfg, params, batch))]} if ref else {}


def serve_case(arch, mesh, rules, ref: bool):
    """Prefill plus greedy decode steps: every step's logits and the final
    cache; the greedy tokens."""
    cfg = f32(arch)
    fam = family(cfg)
    params = fam.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = serve.make_batch(cfg, torch.Generator().manual_seed(2), B, S)
    pos0 = S + serve.prefix_len(cfg)

    def run(params, batch, rules):
        prefill = serve.make_prefill_step(cfg, cache_len=pos0 + DECODE, rules=rules)
        decode = serve.make_decode_step(cfg, rules=rules)
        logits_seen, tokens = [], []
        with torch.no_grad():
            logits, cache = prefill(params, batch)
            for i in range(DECODE + 1):
                logits = whole(logits)
                logits_seen.append(logits)
                tok = logits[:, -1].argmax(-1)[:, None]
                tokens.append(tok)
                if i == DECODE:
                    break
                pos = torch.full((B,), pos0 + i, dtype=torch.int64)
                if isinstance(batch["tokens"], DTensor):
                    tok = train.distribute_tree({"t": tok}, mesh, {"t": P("DP")},
                                                rules)["t"]
                logits, cache = decode(params, cache, tok, pos)
        return logits_seen, cache, torch.cat(tokens, 1)

    sp = train.distribute_tree(params, mesh, fam.param_specs(cfg, rules), rules)
    sb = train.distribute_tree(batch, mesh, train.batch_spec_tree(batch), rules)
    l1, c1, t1 = run(sp, sb, rules)
    c1 = whole_tree(c1)
    if not ref:
        return {}
    l0, c0, t0 = run(params, batch, reference_rules(cfg, rules))
    return {"logits": distance(dict(enumerate(l1)), dict(enumerate(l0))),
            "cache": distance(c1, c0),
            "tokens_equal": bool(torch.equal(t0, t1))}


def moe_groups_case(mesh, rules, ref: bool):
    """granite-moe's loss and gradients at G = 2 (group-local dispatch):
    sharded against plain tensors under the same rules, and the plain loss
    without rules (G = 1) beside them."""
    cfg = f32("granite-moe-3b-a800m")
    fam = family(cfg)
    params = fam.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=3)
    batch = train.train_batch(cfg, dcfg, 0, "cpu")
    loss = lambda r: (lambda p, b: fam.loss_fn(cfg, p, b, r))
    sp = train.distribute_tree(params, mesh, fam.param_specs(cfg, rules), rules)
    sb = train.distribute_tree(batch, mesh, train.batch_spec_tree(batch), rules)
    l1, g1 = train.value_and_grad(loss(rules), sp, sb)
    l1, g1 = float(whole(l1)), whole_tree(g1)
    if not ref:
        return {}
    l0, g0 = train.value_and_grad(loss(rules), params, batch)
    return {"loss": [l1, float(l0)], "grads": distance(g1, g0),
            "loss_g1": float(fam.loss_fn(cfg, params, batch)),
            "groups": rules._size(rules.dp_axes)}


def grad_shard_case(mesh, rules):
    """The collectives that take each of qwen3's fresh gradients to its
    parameter's placements (the train step's ``grad_shard``), per leaf."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = f32("qwen3-1.7b")
    fam = family(cfg)
    specs = fam.param_specs(cfg, rules)
    params = train.distribute_tree(
        fam.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), mesh, specs, rules)
    batch = train.train_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B),
                              0, "cpu")
    batch = train.distribute_tree(batch, mesh, train.batch_spec_tree(batch), rules)
    _, grads = train.value_and_grad(lambda p, b: fam.loss_fn(cfg, p, b, rules), params, batch)
    out = {}
    for (path, g), (_, spec), (_, p) in zip(tree_items(grads), tree_items(specs),
                                            tree_items(params)):
        with CommDebugMode() as comm:
            L.shard(g, spec, rules)
        out["/".join(path)] = {
            "param_sharded_on_every_dim": all(pl.is_shard() for pl in p.placements),
            "param_replicated": all(pl.is_replicate() for pl in p.placements),
            "comms": {getattr(k, "__name__", str(k)): n for k, n in comm.get_comm_counts().items()}}
    return out


def quorum_case(mesh):
    """``quorum_allreduce`` over the dp mesh dim's group: rank r of the
    data dim contributes r + 1."""
    r = mesh.get_local_rank("data")
    got = quorum_allreduce({"g": torch.full((3,), float(r + 1))}, torch.tensor([1.0, 1.0]),
                           group=mesh.get_group("data"))
    return {"mean": got["g"].tolist()}


def main():
    rank, port, world, out_path = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh_for(world)
        rules = make_rules(mesh)
        ref = rank == 0
        cases = {"train": lambda: train_case(mesh, rules, ref),
                 "moe_groups": lambda: moe_groups_case(mesh, rules, ref),
                 "quorum": lambda: quorum_case(mesh),
                 "no_mask": lambda: no_mask_case(mesh, rules, ref),
                 "grad_shard": lambda: grad_shard_case(mesh, rules)}
        for arch in ARCHS:
            cases[f"grads/{arch}"] = lambda a=arch: grads_case(a, mesh, rules, ref)
            cases[f"serve/{arch}"] = lambda a=arch: serve_case(a, mesh, rules, ref)
        out = {"mesh": list(mesh.shape)}
        for name, case in cases.items():
            t0 = time.time()
            out[name] = {**case(), "seconds": time.time() - t0}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
