"""Serving example, PyTorch port: batched prefill + greedy decode with the
per-family cache machinery (KV cache for attention archs, O(1) SSD state
for mamba), the twin of ``examples/serve_lm.py``.

On a CUDA device attention runs kernel K2 and the SSD scan kernel K3; on
the CPU their plain versions.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2_780m
      PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3_1p7b --device cpu
"""

import argparse
import time

import torch

from repro_torch import configs, default_device
from repro_torch.launch.serve import (make_batch, make_decode_step,
                                      make_prefill_step, prefix_len)
from repro_torch.models import family

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen3_1p7b")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--prompt-len", type=int, default=64)
ap.add_argument("--gen", type=int, default=32)
ap.add_argument("--device", default=None,
                help="torch device (default: cuda, which must exist)")
args = ap.parse_args()

cfg = configs.smoke(args.arch)
fam = family(cfg)
device = default_device(args.device)
gen = torch.Generator(device).manual_seed(0)
params = fam.init_params(cfg, gen, device=device)
B, S = args.batch, args.prompt_len
batch = make_batch(cfg, gen, B, S)
pos0 = S + prefix_len(cfg)

prefill = make_prefill_step(cfg, cache_len=pos0 + args.gen)
decode = make_decode_step(cfg)


def synchronize():
    if device.type == "cuda":
        torch.cuda.synchronize()


with torch.inference_mode():
    t0 = time.time()
    logits, cache = prefill(params, batch)
    synchronize()
    t_pre = time.time() - t0
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    out = [tok]
    t0 = time.time()
    for i in range(args.gen - 1):
        pos = torch.full((B,), pos0 + i, dtype=torch.int64, device=device)
        logits, cache = decode(params, cache, tok, pos)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out.append(tok)
    synchronize()
    t_dec = time.time() - t0

toks = torch.cat(out, dim=1)
cache_desc = {k: tuple(v.shape) for k, v in cache.items()}
print(f"arch={cfg.name} family={cfg.family}")
print(f"prefill {B}x{S}: {t_pre*1e3:.0f} ms; decode {args.gen} toks: "
      f"{t_dec/max(args.gen-1,1)*1e3:.1f} ms/tok")
print(f"cache: {cache_desc}")
print(f"first sequence: {toks[0].tolist()}")
