"""The port's dry-run against the JAX package's on the smoke configs: the
per-device FLOP (and, not comparable, bytes) of a train step, a prefill and
a decode step of every architecture on a (4, 2) ("data", "model") mesh of 8
ranks, batch 8 x 64, decode cache 8 x 128, 2 microbatches, as
``tests/test_dryrun_small.py`` sets them; beside each, both packages'
count of the same step unsharded on one device, over 8.

    PYTHONPATH=src python experiments/dryrun_parity.py [ARCH:KIND ...]

(default: the 10 architectures x train, prefill, decode; about 5 minutes on
a CPU). The JAX side runs in a subprocess with 8 host devices, the port's
in another, over a fake process group of 8 ranks.
"""

import json
import os
import subprocess
import sys
import textwrap

ARCHS = ("qwen3_8b", "qwen3_1p7b", "nemotron_4_340b", "phi4_mini_3p8b", "zamba2_1p2b",
         "qwen3_moe_235b_a22b", "granite_moe_3b_a800m", "mamba2_780m",
         "seamless_m4t_medium", "internvl2_26b")
KINDS = ("train", "prefill", "decode")

JAX_SIDE = """
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
    from repro.launch.serve import abstract_cache, make_decode_step, make_prefill_step
    from repro.launch import roofline

    def cell(arch, kind, shape):
        cfg = dataclasses.replace(configs.smoke(arch), microbatches=2)
        devices = jax.devices()[:shape[0] * shape[1]]
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=devices)
        rules, fam, opt_cfg = make_rules(mesh), family(cfg), AdamWConfig()
        f = jnp.dtype(cfg.compute_dtype)

        def stub(batch):
            if cfg.family == "encdec":
                batch["frames"] = jax.ShapeDtypeStruct((8, 64 // cfg.enc_len_ratio, cfg.d_model), f)
            if cfg.family == "vlm":
                batch["image_embeds"] = jax.ShapeDtypeStruct((8, cfg.n_image_tokens, cfg.d_model), f)
            return batch

        with mesh:
            ap = abstract_params(cfg)
            ps = fam.param_specs(cfg, rules)
            p_sh = tree_shardings(mesh, ap, ps, rules)
            tokens = jax.ShapeDtypeStruct((8, 64), jnp.int32)
            if kind == "train":
                ao = abstract_opt_state(cfg, opt_cfg)
                o_sh = tree_shardings(mesh, ao, adamw.state_specs(ps), rules)
                batch = stub({"tokens": tokens, "targets": tokens,
                              "mask": jax.ShapeDtypeStruct((8, 64), jnp.bfloat16)})
                b_sh = tree_shardings(mesh, batch, batch_spec_tree(batch), rules)
                fn = jax.jit(make_train_step(cfg, rules, opt_cfg),
                             in_shardings=(p_sh, o_sh, b_sh, None),
                             out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1))
                comp = fn.lower(ap, ao, batch, jax.ShapeDtypeStruct((), jnp.int32)).compile()
            elif kind == "prefill":
                batch = stub({"tokens": tokens})
                b_sh = tree_shardings(mesh, batch, batch_spec_tree(batch), rules)
                fn = jax.jit(make_prefill_step(cfg, rules), in_shardings=(p_sh, b_sh))
                comp = fn.lower(ap, batch).compile()
            else:
                cache = abstract_cache(cfg, 8, 128)
                c_sh = tree_shardings(mesh, cache, fam.cache_specs(cfg, rules), rules)
                fn = jax.jit(make_decode_step(cfg, rules),
                             in_shardings=(p_sh, c_sh, None, None),
                             out_shardings=(None, c_sh), donate_argnums=(1,))
                comp = fn.lower(ap, cache, jax.ShapeDtypeStruct((8, 1), jnp.int32),
                                jax.ShapeDtypeStruct((8,), jnp.int32)).compile()
            rf = roofline.analyze(comp, chips=len(devices), model_flops=1.0)
        return rf.flops, rf.hbm_bytes

    out = {}
    for name in CELLS:
        arch, kind = name.split(":")
        flops, nbytes = cell(arch, kind, (4, 2))
        out[name] = {"flops": flops, "bytes": nbytes,
                     "unsharded_flops": cell(arch, kind, (1, 1))[0]}
    print(json.dumps(out))
"""

PORT_SIDE = """
    import json, dataclasses, torch
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import abstract_cache

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def cell(arch, kind, mesh):
        cfg = dataclasses.replace(configs.smoke(arch), microbatches=2)
        tokens = meta((8, 64), torch.int32)
        batch = ({"tokens": tokens, "targets": tokens, "mask": meta((8, 64), torch.bfloat16)}
                 if kind == "train" else {"tokens": tokens})
        if cfg.family == "encdec":
            batch["frames"] = meta((8, 64 // cfg.enc_len_ratio, cfg.d_model), cfg.dtype())
        if cfg.family == "vlm":
            batch["image_embeds"] = meta((8, cfg.n_image_tokens, cfg.d_model), cfg.dtype())
        where = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
        if kind == "decode":
            batch = {"token": meta((8, 1), torch.int32), "pos": meta((8,), torch.int32)}
            where["cache"] = abstract_cache(cfg, 8, 128)
        costs, _, _ = dryrun.trace_step(cfg, kind, batch, **where)
        return costs.flops, costs.bytes

    out = {}
    for name in CELLS:
        arch, kind = name.split(":")
        with dryrun.fake_group(8):
            mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
            flops, nbytes = cell(arch, kind, mesh)
        out[name] = {"flops": flops, "bytes": nbytes,
                     "unsharded_flops": cell(arch, kind, None)[0]}
    print(json.dumps(out))
"""


def run_both(cells):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src"), "JAX_PLATFORMS": "cpu"}
    head = f"CELLS = {list(cells)!r}\n"
    procs = [subprocess.Popen([sys.executable, "-c", head + textwrap.dedent(side)], env=env,
                              cwd=root, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for side in (JAX_SIDE, PORT_SIDE)]
    results = []
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(err[-3000:])
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def main(argv):
    cells = argv or [f"{a}:{k}" for a in ARCHS for k in KINDS]
    jax_side, port_side = run_both(cells)
    print(f"{'cell':34} {'JAX FLOP':>14} {'port FLOP':>14} {'port/JAX':>9} "
          f"{'JAX 1 dev / 8':>14} {'port 1 dev / 8':>14} {'JAX bytes':>12} {'port bytes':>12}")
    for name in cells:
        j, p = jax_side[name], port_side[name]
        print(f"{name:34} {j['flops']:14.0f} {p['flops']:14.0f} {p['flops'] / j['flops']:9.4f} "
              f"{j['unsharded_flops'] / 8:14.0f} {p['unsharded_flops'] / 8:14.0f} "
              f"{j['bytes']:12.0f} {p['bytes']:12.0f}")


if __name__ == "__main__":
    main(sys.argv[1:])
