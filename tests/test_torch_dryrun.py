"""The port's dry-run and roofline (``repro_torch.launch.dryrun``,
``launch.roofline``, ``launch.op_analysis``, ``configs.base.input_specs``)
against the JAX package's.

  * exact copies: ``skip_reason``, ``model_flops_for`` and ``input_specs``
    (keys, shapes, dtype names) over every architecture x shape;
  * parity with the JAX dry-run on the three cells of
    ``tests/test_dryrun_small.py`` (smoke configs, 2 microbatches, a (4, 2)
    ("data", "model") mesh of 8 ranks, batch 8 x 64, decode cache 8 x 128):
    the per-device FLOP within FLOPS_RTOL of ``roofline.analyze(...).flops``;
    bytes and collective bytes are reported beside JAX's and not held (XLA
    fuses elementwise chains, eager PyTorch runs each operator alone, and
    GSPMD and DTensor pick other collectives);
  * the kernel ops' fakes on fake CUDA tensors (shapes and dtypes of the
    plain versions' outputs on the CPU) and their FLOP formulas against the
    closed forms of PERF.md §6 at the kernel table's shapes;
  * ``lower_cell`` end to end on the fake (16, 16) CPU mesh.

Every trace over a fake process group runs in a subprocess, so that no
default group is left in an xdist worker; torch runs on one thread.
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402
from pathlib import Path  # noqa: E402

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES, input_specs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("qwen3_1p7b", "train"), ("mamba2_780m", "decode"),
         ("granite_moe_3b_a800m", "train"))
# Both sides count 2·m·n·k for every matrix product on the per-device
# shapes, and since the port reduces a tp-split product's partial sums where
# GSPMD does (layers.proj_out, layers.whole_gradient) they count the same
# products: equal on jax 0.9. The band leaves room for an XLA that rewrites
# a small product; a product run on whole weights on every tp rank, or a
# global count, lies 4-31% above (PERF.md §6).
FLOPS_RTOL = 0.005
EXPECTED_KEYS = {"arch", "shape", "mesh", "status", "chips", "kind", "lower_s",
                 "memory", "roofline"}
MEMORY_KEYS = {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "alias_bytes_per_device",
               "peak_estimate_per_device"}


def env():
    return {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}


def start(code: str, extra_env=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                            env={**env(), **(extra_env or {})}, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(proc: subprocess.Popen, timeout=600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# exact copies
# ---------------------------------------------------------------------------

def test_shapes_and_archs_are_the_references():
    assert SHAPES == jbase.SHAPES
    assert configs.ARCHS == jconfigs.ARCHS


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_skip_reason_model_flops_and_input_specs_equal_the_references(arch):
    # the reference's dryrun sets XLA_FLAGS when imported; keep this process's
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    for shape in jbase.SHAPES:
        assert dryrun.skip_reason(cfg, shape) == jdryrun.skip_reason(jcfg, shape)
        assert roofline.model_flops_for(cfg, shape) == jroofline.model_flops_for(jcfg, shape)
        got, want = input_specs(cfg, shape), jbase.input_specs(jcfg, shape)
        assert list(got) == list(want), shape
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(spec.shape), (shape, key)
            assert str(got[key].dtype).removeprefix("torch.") == str(spec.dtype), (shape, key)


def test_roofline_terms_use_the_h100_constants():
    costs = dryrun.op_analysis.Costs(flops=989e12, bytes=2 * 3.35e12,
                                     coll={"all-reduce": 3 * 900e9})
    rf = roofline.analyze(costs, chips=4, model_flops=4 * 989e12)
    assert (rf.t_compute, rf.t_memory, rf.t_collective) == (1.0, 2.0, 3.0)
    assert rf.bottleneck == "collective" and rf.useful_flops_ratio == 1.0
    assert rf.mfu_bound == pytest.approx(1 / 3)
    assert set(rf.to_dict()) == set(jroofline.Roofline(0, 0, 0, {}, 1).to_dict())


# ---------------------------------------------------------------------------
# parity with the JAX dry-run on test_dryrun_small's cells
# ---------------------------------------------------------------------------

JAX_CELLS = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, dataclasses, jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import configs
    from repro.models import family
    from repro.optim import AdamWConfig, adamw
    from repro.launch.shardings import make_rules
    from repro.launch.train import (abstract_params, abstract_opt_state,
                                    batch_spec_tree, make_train_step, tree_shardings)
    from repro.launch.serve import abstract_cache, make_decode_step
    from repro.launch import roofline

    out = {}
    mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = make_rules(mesh)
    for arch, kind in CELLS:
        cfg = dataclasses.replace(configs.smoke(arch), microbatches=2)
        fam = family(cfg)
        opt_cfg = AdamWConfig()
        with mesh:
            ap = abstract_params(cfg)
            ps = fam.param_specs(cfg, rules)
            p_sh = tree_shardings(mesh, ap, ps, rules)
            if kind == "train":
                ao = abstract_opt_state(cfg, opt_cfg)
                o_sh = tree_shardings(mesh, ao, adamw.state_specs(ps), rules)
                batch = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32),
                         "targets": jax.ShapeDtypeStruct((8, 64), jnp.int32),
                         "mask": jax.ShapeDtypeStruct((8, 64), jnp.bfloat16)}
                b_sh = tree_shardings(mesh, batch, batch_spec_tree(batch), rules)
                fn = jax.jit(make_train_step(cfg, rules, opt_cfg),
                             in_shardings=(p_sh, o_sh, b_sh, None),
                             out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1))
                comp = fn.lower(ap, ao, batch, jax.ShapeDtypeStruct((), jnp.int32)).compile()
            else:
                cache = abstract_cache(cfg, 8, 128)
                c_sh = tree_shardings(mesh, cache, fam.cache_specs(cfg, rules), rules)
                fn = jax.jit(make_decode_step(cfg, rules),
                             in_shardings=(p_sh, c_sh, None, None),
                             out_shardings=(None, c_sh), donate_argnums=(1,))
                comp = fn.lower(ap, cache, jax.ShapeDtypeStruct((8, 1), jnp.int32),
                                jax.ShapeDtypeStruct((8,), jnp.int32)).compile()
            rf = roofline.analyze(comp, chips=8, model_flops=1.0)
        out[f"{arch}:{kind}"] = {"flops": rf.flops, "bytes": rf.hbm_bytes,
                                 "coll": rf.coll_by_kind}
    print(json.dumps(out))
"""

PORT_CELLS = """
    import json, dataclasses, torch
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import abstract_cache

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {}
    for arch, kind in CELLS:
        cfg = dataclasses.replace(configs.smoke(arch), microbatches=2)
        with dryrun.fake_group(8):
            mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
            if kind == "train":
                batch = {"tokens": meta((8, 64), torch.int32),
                         "targets": meta((8, 64), torch.int32),
                         "mask": meta((8, 64), torch.bfloat16)}
                costs, memory, seconds = dryrun.trace_step(cfg, kind, batch, mesh=mesh)
            else:
                inputs = {"token": meta((8, 1), torch.int32), "pos": meta((8,), torch.int32)}
                costs, memory, seconds = dryrun.trace_step(
                    cfg, kind, inputs, mesh=mesh, cache=abstract_cache(cfg, 8, 128))
        out[f"{arch}:{kind}"] = {"flops": costs.flops, "bytes": costs.bytes,
                                 "coll": costs.coll, "memory": memory, "seconds": seconds}
    # 2 kv heads on 4 tp ranks: heads stay whole, q/k/v and the attention
    # output (and its gradient) are gathered before they are cut into heads
    cfg = dataclasses.replace(configs.smoke("qwen3_1p7b"), microbatches=2)
    with dryrun.fake_group(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        batch = {"tokens": meta((8, 64), torch.int32), "targets": meta((8, 64), torch.int32),
                 "mask": meta((8, 64), torch.bfloat16)}
        costs, _, _ = dryrun.trace_step(cfg, "train", batch, mesh=mesh)
    out["heads_whole"] = {"flops": costs.flops, "coll": costs.coll}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def parity():
    """The three cells through both dry-runs, one subprocess each, run
    side by side."""
    cells = f"CELLS = {CELLS!r}\n"
    jax_proc = start(cells + textwrap.dedent(JAX_CELLS))
    port_proc = start(cells + textwrap.dedent(PORT_CELLS))
    return finish(jax_proc), finish(port_proc)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_per_device_flops_equal_the_jax_dry_run(parity, arch, kind):
    want, got = (side[f"{arch}:{kind}"] for side in parity)
    print(f"{arch} {kind}: flops {got['flops']:.0f} (JAX {want['flops']:.0f}); bytes "
          f"{got['bytes']:.0f} (JAX {want['bytes']:.0f}, not held); collective bytes "
          f"{got['coll']} (JAX {want['coll']}, not held)")
    assert want["flops"] > 0
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOPS_RTOL)
    assert got["bytes"] > 0
    memory = got["memory"]
    assert set(memory) == MEMORY_KEYS
    assert memory["peak_estimate_per_device"] >= memory["argument_bytes_per_device"] > 0
    if kind == "train":      # sharded: gradients reduced, fsdp weights gathered
        assert sum(got["coll"].values()) > 0
        # the parameters and moments are updated in place: they alias
        assert 0 < memory["alias_bytes_per_device"] <= memory["argument_bytes_per_device"]


def test_heads_that_tp_does_not_split_trace_forward_and_backward(parity):
    got = parity[1]["heads_whole"]
    assert got["flops"] > 0 and got["coll"].get("all-gather", 0) > 0


# ---------------------------------------------------------------------------
# the kernel ops: fakes and FLOP formulas
# ---------------------------------------------------------------------------

def cpu_inputs(shapes, dtypes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(d) for s, d in zip(shapes, dtypes)]


def fake_like(tensors):
    return [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in tensors]


def assert_like(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


@pytest.mark.parametrize("S,Sk,causal", [(40, 40, True), (40, 24, False), (1, 7, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_ops_fakes_give_the_plain_versions_shapes(S, Sk, causal, dtype):
    B, H, KV, hd = 2, 4, 2, 16
    q, k, v, do = cpu_inputs([(B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
                              (B, S, H, hd)], [dtype] * 4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention_plain(*leaves, causal=causal)
    grads = torch.autograd.grad(o, leaves, do)
    lse = torch.empty((B, H, S), dtype=torch.float32)    # the kernel's row log-sum-exp
    with FakeTensorMode():
        fq, fk, fv, fdo = fake_like((q, k, v, do))
        assert_like(fa.flash_attention_cuda(fq, fk, fv, causal=causal, return_lse=True),
                    (o, lse))
        assert_like([fa.flash_attention_cuda(fq, fk, fv, causal=causal)], [o])
        flse = torch.empty(lse.shape, dtype=torch.float32, device="cuda")
        assert_like(fa.flash_attention_bwd_cuda(fq, fk, fv, fdo, flse, causal=causal), grads)
        if causal:           # what the kernel does not take, the fake refuses too
            one = torch.empty((B, 1, KV, hd), dtype=dtype, device="cuda")
            with pytest.raises(ValueError, match="own length"):
                fa.flash_attention_cuda(fq, one, one, causal=True)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_k3_ops_fakes_give_the_plain_versions_shapes(xdtype):
    B, nc, Q, nh, hp, N = 2, 3, 16, 4, 8, 6
    f32 = torch.float32
    args = cpu_inputs([(B, nc, Q, nh, hp), (B, nc, Q, nh), (B, nc, Q, nh), (B, nc, Q, N),
                       (B, nc, Q, N)], [xdtype, f32, f32, f32, f32])
    args[2] = -args[1].abs().cumsum(2)          # seg: a decreasing cumsum
    want = ssd.ssd_intra_chunk_plain(*args)
    grads = cpu_inputs([w.shape for w in want], [f32] * 3, seed=1)
    want_bwd = ssd.ssd_intra_chunk_bwd_plain(*args, *grads)
    with FakeTensorMode():
        fargs, fgrads = fake_like(args), fake_like(grads)
        assert_like(ssd.ssd_intra_chunk_cuda(*fargs), want)
        assert_like(ssd.ssd_intra_chunk_bwd_cuda(*fargs, *fgrads), want_bwd)
        narrow = torch.empty((B, nc, Q, 1), dtype=f32, device="cuda")
        with pytest.raises(ValueError, match=r"\(B,nc,Q,nh\)"):
            ssd.ssd_intra_chunk_cuda(fargs[0], narrow, *fargs[2:])


def counted(fn, *shapes_dtypes):
    """FlopCounterMode's count of ``fn`` on fake CUDA tensors."""
    with FakeTensorMode():
        tensors = [torch.empty(s, dtype=d, device="cuda") for s, d in shapes_dtypes]
        with FlopCounterMode(display=False) as counter:
            fn(*tensors)
    return counter.get_total_flops()


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B,S,H,KV,hd,Sk,causal", [
    (8, 2048, 32, 32, 64, 2048, True),      # the zamba2 serving prefill's shape
    (8, 2048, 16, 16, 64, 512, False),      # seamless's cross-attention
])
def test_k2_flop_formula_is_the_kernel_tables(B, S, H, KV, hd, Sk, causal):
    pairs = S * (S + 1) / 2 if causal else S * Sk
    got = counted(lambda q, k, v: fa.flash_attention_cuda(q, k, v, causal=causal),
                  ((B, S, H, hd), BF16), ((B, Sk, KV, hd), BF16), ((B, Sk, KV, hd), BF16))
    assert got == 4 * B * H * hd * pairs


@pytest.mark.parametrize("B,S,H,KV,hd,Sk,causal", [
    (4, 2048, 16, 8, 128, 2048, True),      # a qwen3-1.7b training microbatch
    (8, 2048, 16, 16, 64, 512, False),      # seamless's cross-attention
])
def test_k2_backward_flop_formula_is_the_kernel_tables(B, S, H, KV, hd, Sk, causal):
    pairs = S * (S + 1) / 2 if causal else S * Sk
    got = counted(lambda q, k, v, do, lse: fa.flash_attention_bwd_cuda(q, k, v, do, lse,
                                                                       causal=causal),
                  ((B, S, H, hd), BF16), ((B, Sk, KV, hd), BF16), ((B, Sk, KV, hd), BF16),
                  ((B, S, H, hd), BF16), ((B, H, S), F32))
    assert got == 10 * B * H * hd * pairs


def k3_shapes(B, nc, Q, nh, hp, N, grads=False):
    x = [((B, nc, Q, nh, hp), BF16), ((B, nc, Q, nh), F32), ((B, nc, Q, nh), F32),
         ((B, nc, Q, N), F32), ((B, nc, Q, N), F32)]
    return x + ([((B, nc, Q, nh, hp), F32), ((B, nc, nh, hp, N), F32), ((B, nc, nh), F32)]
                if grads else [])


def test_k3_flop_formulas_are_the_kernel_tables():
    # K3 at the zamba2 serving prefill's shape: C Bᵀ and M x over the lower
    # triangle, the chunk state in full (chip_smoke.time_k3)
    B, nc, Q, nh, hp, N = 8, 16, 128, 64, 64, 64
    tri = Q * (Q + 1) / 2
    want = B * nc * (2 * N * tri + nh * 2 * hp * tri + nh * 2 * Q * hp * N)
    assert counted(ssd.ssd_intra_chunk_cuda, *k3_shapes(B, nc, Q, nh, hp, N)) == want
    # its backward at a zamba2 training microbatch's (chip_smoke.time_k3_backward)
    B = 4
    f64 = B * nc * (nh * 2 * hp * tri + 2 * N * tri)             # dy xᵀ, C Bᵀ
    x_ds = B * nc * nh * 2 * Q * hp * N                          # x dS
    f32 = B * nc * (nh * (2 * hp * tri + 2 * Q * hp * N) + 4 * N * tri)
    got = counted(ssd.ssd_intra_chunk_bwd_cuda, *k3_shapes(B, nc, Q, nh, hp, N, grads=True))
    assert got == f64 + x_ds + f32


# ---------------------------------------------------------------------------
# lower_cell end to end, on the fake (16, 16) CPU mesh
# ---------------------------------------------------------------------------

def test_dryrun_cli_records_a_production_cell(tmp_path):
    """qwen3-1.7b decode_32k (about 6 s of trace here), qwen3-8b long_500k
    (a SKIP), and an unknown architecture (a FAIL, exit 1), through the
    reference's CLI flags; then lower_cell refusing to run beside a default
    process group. The import changes no process state."""
    proc = start(f"""
        import json, os, sys
        import torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        env = dict(os.environ)
        from repro_torch.launch import dryrun
        assert dict(os.environ) == env and not dist.is_initialized()
        out = {{}}
        for argv in (["--arch", "qwen3-1.7b", "--shape", "decode_32k"],
                     ["--arch", "qwen3-8b", "--shape", "long_500k"],
                     ["--arch", "no-such-arch", "--shape", "train_4k"]):
            try:
                dryrun.main(argv + ["--out", {str(tmp_path)!r}])
            except SystemExit as e:
                out[argv[1]] = e.code
        assert not dist.is_initialized()
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
        try:
            dryrun.lower_cell("qwen3-1.7b", "decode_32k", False)
        except RuntimeError as e:
            out["with_a_group"] = str(e)
        print(json.dumps(out))
    """)
    out = finish(proc)
    assert out["qwen3-1.7b"] == 0 and out["qwen3-8b"] == 0 and out["no-such-arch"] == 1
    assert "process group exists" in out["with_a_group"]
    rec = json.loads((tmp_path / "qwen3-1.7b_decode_32k_16x16.json").read_text())
    assert EXPECTED_KEYS <= set(rec) and rec["status"] == "OK"
    assert (rec["chips"], rec["kind"], rec["mesh"]) == (256, "decode", "16x16")
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == set(jroofline.Roofline(0, 0, 0, {}, 1).to_dict())
    rf = rec["roofline"]
    assert rf["flops"] > 0 and rf["hbm_bytes"] > 0
    assert rf["collective_by_kind"].get("all-reduce", 0) > 0   # flash-decoding over tp
    assert rf["model_flops"] == roofline.model_flops_for(configs.get("qwen3-1.7b"),
                                                         "decode_32k")
    skip = json.loads((tmp_path / "qwen3-8b_long_500k_16x16.json").read_text())
    assert skip["status"] == "SKIP" and "full-attention" in skip["reason"]
    fail = json.loads((tmp_path / "no-such-arch_train_4k_16x16.json").read_text())
    assert fail["status"] == "FAIL" and "unknown architecture" in fail["error"]
