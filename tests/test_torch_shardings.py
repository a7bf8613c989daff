"""The port's sharding rules (``repro_torch.launch.shardings``) and every
family's specs against the JAX package's, in pure Python.

For all ten configurations at full size, under ``Rules`` of a (16, 16)
pod, a (2, 16, 16) multi-pod, a (4, 2) and a (1, 1) mesh, each with fsdp
on and off: the port's ``param_specs``, ``cache_specs`` (at the decode_32k
batch and length) and ``adamw.state_specs``, each resolved against the
port's own shapes (``abstract_params``, ``abstract_opt_state``,
``abstract_cache``), equal the JAX package's resolved against its shapes,
entry by entry. JAX's ``Rules`` is built directly, so no JAX mesh is
needed. Then ``make_rules`` of a torch ``DeviceMesh`` against JAX's
``make_rules`` of a stand-in with ``axis_names`` and ``devices.shape``, and
``placements`` on a one-rank gloo mesh.
"""

import dataclasses
import functools
import socket
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import shardings as jax_sh  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import family as jax_family  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import family  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

import jax  # noqa: E402

ARCHS = sorted(configs.ALIASES)
MESHES = {                       # name -> (axis names, shape)
    "pod": (("data", "model"), (16, 16)),
    "multi_pod": (("pod", "data", "model"), (2, 16, 16)),
    "4x2": (("data", "model"), (4, 2)),
    "1x1": (("data", "model"), (1, 1)),
}
DECODE_B, DECODE_S = 128, 32_768      # SHAPES["decode_32k"]


def rules_pair(mesh: str, fsdp: bool):
    names, shape = MESHES[mesh]
    sizes = dict(zip(names, shape))
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    return (jax_sh.Rules(axis_sizes=sizes, dp_axes=dp, tp_axis="model", fsdp_on=fsdp),
            sh.Rules(axis_sizes=sizes, dp_axes=dp, tp_axis="model", fsdp_on=fsdp))


@functools.cache
def shapes(arch):
    """The JAX package's and the port's parameter, optimizer-state and
    decode-cache shapes of ``arch``, each as {path: shape}."""
    jcfg, cfg = jax_configs.get(arch), configs.get(arch)
    jax_leaves = lambda tree: {tuple(str(k.key) for k in path): tuple(leaf.shape)
                               for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    port_leaves = lambda tree: {path: tuple(leaf.shape) for path, leaf in tree_items(tree)}
    want = {"params": jax_leaves(jax_train.abstract_params(jcfg)),
            "opt": jax_leaves(jax_train.abstract_opt_state(jcfg, JaxAdamWConfig())),
            "cache": jax_leaves(jax_serve.abstract_cache(jcfg, DECODE_B, DECODE_S))}
    got = {"params": port_leaves(train.abstract_params(cfg)),
           "opt": port_leaves(train.abstract_opt_state(cfg, AdamWConfig())),
           "cache": port_leaves(serve.abstract_cache(cfg, DECODE_B, DECODE_S))}
    return want, got


def resolved_jax(shape_of, specs, rules):
    return {tuple(str(k.key) for k in path): tuple(jax_sh.resolve_spec(shape_of[
                tuple(str(k.key) for k in path)], spec, rules))
            for path, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}


def resolved_port(shape_of, specs, rules):
    return {path: tuple(sh.resolve_spec(shape_of[path], spec, rules))
            for path, spec in tree_items(specs)}


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_specs_equal_jax(arch, mesh, fsdp):
    """Parameters, optimizer state and decode cache: the same shapes and,
    under the same rules, the same resolved spec for every leaf."""
    want_shapes, got_shapes = shapes(arch)
    assert got_shapes == want_shapes
    jrules, rules = rules_pair(mesh, fsdp)
    jcfg, cfg = jax_configs.get(arch), configs.get(arch)
    jfam, fam = jax_family(jcfg), family(cfg)
    jp, p = jfam.param_specs(jcfg, jrules), fam.param_specs(cfg, rules)
    for what, jspecs, specs in (
            ("params", jp, p),
            ("opt", jax_adamw.state_specs(jp), adamw.state_specs(p)),
            ("cache", jfam.cache_specs(jcfg, jrules), fam.cache_specs(cfg, rules))):
        want = resolved_jax(want_shapes[what], jspecs, jrules)
        got = resolved_port(got_shapes[what], specs, rules)
        assert got == want, what
    # the rules' roles resolve as JAX's do
    assert (rules.dp, rules.tp) == (jrules.dp, jrules.tp)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo process group for the module's meshes."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def same(rules, jax_rules) -> bool:
    """Field for field (the two packages' Rules are different classes)."""
    return dataclasses.asdict(rules) == dataclasses.asdict(jax_rules)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("names", [("data", "model"), ("pod", "data", "model"), ("data",)])
def test_make_rules_equal_jax(one_rank, names, fsdp):
    """From a torch DeviceMesh of these dimension names (one rank each), and
    from stand-ins of the production shapes."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1,) * len(names), mesh_dim_names=names)
    stand_in = types.SimpleNamespace(axis_names=names, devices=np.empty((1,) * len(names)))
    assert same(sh.make_rules(mesh, fsdp=fsdp), jax_sh.make_rules(stand_in, fsdp=fsdp))
    for shape in ((16, 16), (2, 16, 16), (4, 2)):
        if len(shape) != len(names):
            continue
        port_stand_in = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
        jax_stand_in = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
        assert same(sh.make_rules(port_stand_in, fsdp=fsdp),
                    jax_sh.make_rules(jax_stand_in, fsdp=fsdp))


@pytest.mark.parametrize("spec,want", [
    (sh.P("data", "model"), (Shard(0), Shard(1))),
    (sh.P(None, "model"), (Replicate(), Shard(1))),
    (sh.P(("data", "model"), None), (Shard(0), Shard(0))),
    (sh.P(None, None), (Replicate(), Replicate())),
    (sh.P(("pod", "data"), "model"), (Shard(0), Shard(1))),      # no pod axis here
])
def test_placements_on_one_rank_mesh(one_rank, spec, want):
    """One placement per mesh dimension; a tensor laid out by them on the
    mesh holds the whole tensor on its one rank."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    got = sh.placements(mesh, spec)
    assert got == want
    t = torch.arange(24.0).reshape(4, 6)
    d = distribute_tensor(t, mesh, got, src_data_rank=None)
    assert d.placements == want and torch.equal(d.full_tensor(), t)


def test_placements_nest_tuple_axes(one_rank):
    """A dim split over ("pod", "data") is Shard on both, in mesh order;
    an axis used twice raises."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    assert sh.placements(mesh, sh.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError):
        sh.placements(mesh, sh.P("data", "data"))


def test_mesh_builders_are_functions(one_rank):
    """Importing launch.mesh touches no process group; make_mesh_for puts a
    (dp, tp) ("data", "model") mesh on what exists."""
    mesh = port_mesh.make_mesh_for(1)
    assert tuple(mesh.mesh_dim_names) == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert callable(port_mesh.make_production_mesh)


def test_kernel_wrappers_refuse_dtensors(one_rank):
    """A DTensor reaching K2's or K3's entry point or ctypes wrapper raises
    (they take local shards), rather than running the plain version."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    on_mesh = lambda t: distribute_tensor(t, mesh, (Replicate(), Replicate()))
    q = on_mesh(torch.zeros(1, 4, 2, 16))
    for call in (lambda: fa.flash_attention(q, q, q), lambda: fa.flash_attention_cuda(q, q, q),
                 lambda: fa.flash_attention_bwd_cuda(q, q, q, q, None)):
        with pytest.raises(TypeError, match="DTensor"):
            call()
    x, dt = on_mesh(torch.zeros(1, 1, 4, 2, 8)), on_mesh(torch.zeros(1, 1, 4, 2))
    bm = on_mesh(torch.zeros(1, 1, 4, 8))
    for call in (lambda: ssd.ssd_intra_chunk(x, dt, dt, bm, bm),
                 lambda: ssd.ssd_intra_chunk_cuda(x, dt, dt, bm, bm)):
        with pytest.raises(TypeError, match="DTensor"):
            call()
