"""End-to-end training driver, PyTorch port: a ~100M-param dense LM for a
few hundred steps, with WOC-style weighted-quorum gradient commit, async
checkpointing, and crash-style resume; the twin of
``examples/train_lm.py``.

On a CUDA device attention runs kernel K2 and its backward kernel; on the
CPU their plain versions.

Run (one GPU):
  PYTHONPATH=src python examples/train_lm_torch.py --steps 200
Quick check on the CPU:
  PYTHONPATH=src python examples/train_lm_torch.py --steps 12 --tiny --device cpu
"""

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs, default_device
from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.coord import GradQuorum
from repro_torch.data import DataConfig, host_batch
from repro_torch.launch.train import batch_to, make_train_step
from repro_torch.models import family
from repro_torch.optim import AdamWConfig, adamw

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--tiny", action="store_true")
ap.add_argument("--batch", type=int, default=16)
ap.add_argument("--seq", type=int, default=256)
ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_train_lm_torch"))
ap.add_argument("--resume", action="store_true")
ap.add_argument("--workers", type=int, default=4,
                help="simulated dp workers for the quorum commit")
ap.add_argument("--device", default=None,
                help="torch device (default: cuda, which must exist)")
args = ap.parse_args()

# ~100M params: 12L x 768 (tiny: the smoke config)
base = configs.smoke("qwen3_1p7b")
cfg = base if args.tiny else dataclasses.replace(
    base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
    vocab=32_000)
print(f"model: {cfg.n_layers}L d{cfg.d_model} "
      f"~{cfg.param_count()/1e6:.0f}M params")

device = default_device(args.device)
fam = family(cfg)
opt_cfg = AdamWConfig(lr=3e-4)
params = fam.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
opt_state = adamw.init(params, opt_cfg)
step0 = 0
if args.resume:
    params, opt_state, step0 = restore_latest(args.ckpt, params, opt_state)
    print(f"resumed from step {step0}")

train_step = make_train_step(cfg, opt_cfg, total_steps=args.steps)
dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                  global_batch=args.batch)
writer = AsyncCheckpointer(args.ckpt)

# WOC-as-runtime-feature: per-step commit mask over simulated dp workers
gq = GradQuorum(args.workers)
rng = np.random.default_rng(0)
worker_lat = np.ones(args.workers)
worker_lat[-1] = 2.5          # one chronic straggler

losses = []
for step in range(step0, args.steps):
    lat = worker_lat * (0.8 + 0.4 * rng.random(args.workers))
    gq.observe(lat)
    mask = gq.commit_mask(lat)
    batch = batch_to(gq.scale_batch_mask(host_batch(dcfg, step, 0, 1), mask), device)
    t0 = time.time()
    params, opt_state, metrics = train_step(params, opt_state, batch, step)
    losses.append(float(metrics["loss"]))
    if step % 10 == 0 or step == args.steps - 1:
        cert = gq.certificate(step, mask)
        print(f"step {step:4d} loss {losses[-1]:7.4f} "
              f"gnorm {float(metrics['grad_norm']):7.3f} "
              f"commit {int(sum(cert['committed']))}/{args.workers} "
              f"(w={cert['weight']:.1f}>{cert['threshold']:.1f}) "
              f"dt {time.time()-t0:5.2f}s")
    if (step + 1) % 50 == 0:
        writer.save(step + 1, params, opt_state)

writer.save(args.steps, params, opt_state)
writer.wait()
k = max(len(losses) // 10, 1)
print(f"\nloss: first-{k}-avg {np.mean(losses[:k]):.4f} -> "
      f"last-{k}-avg {np.mean(losses[-k:]):.4f}")
if args.steps - step0 >= 50:      # too few steps to clear warmup otherwise
    assert np.mean(losses[-k:]) < np.mean(losses[:k]), "loss did not improve"
print(f"checkpoints in {args.ckpt}; resume with --resume")
