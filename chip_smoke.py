#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper GPU: builds the kernels, holds each against its plain PyTorch version,
drives the weighted-quorum data plane, WOC's protocol simulator and its
served transport on the card's host, zamba2-1.2b, qwen3-1.7b,
granite-moe-3b-a800m and seamless-m4t-medium serving, and qwen3-1.7b,
zamba2-1.2b, granite-moe-3b-a800m and seamless-m4t-medium training at full
size, then qwen3-1.7b training and zamba2-1.2b serving sharded on a 1x1
("data", "model") mesh over NCCL, then the dry-run (fake tensors, a fake
256-rank process group), and times them.

Usage (from the root of a checkout, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py [--seed N] [--train-steps N]

Phases, each of which raises on failure so that the script exits non-zero:
  1. the card's name and power limit (nvidia-smi), the versions of Python,
     torch, CUDA, nvcc and the driver as {"toolchain": ...}, and the kernel
     build (one nvcc per source, all started together), with each kernel's
     registers and spills as one JSON line {"resource_usage": ...};
  2. K1 (quorum commit) against its plain version on the card, on ragged op
     counts, n from 1 to 1024 with every edge of the kernel's regimes, tied
     arrivals, rows without votes, with and without an explicit threshold and
     the members mask; then -0.0 beside +0.0 and NaN arrivals, on inputs that
     start 16-byte aligned and on slices a[1:] that do not, against the plain
     version on the CPU, and the plain version on the card against the CPU
     on the same rows; K1's wrapper raising NotImplementedError, with no
     launch, where an input requires a gradient, and launching once under
     no_grad; the rank sort of core.weights (_ranks, WeightTracker.ranks and
     weights, node_weights_from_latency) on the card against the CPU on
     -0.0 and ±NaN rows; and the port's quorum slice at a small size on the
     card against the same slice on the CPU;
  3. the quorum main path: a WeightTracker over 4,194,304 objects x 9
     replicas (t_fail = 2) and 20 steps of 65,536 in-flight ops, each step
     weights(r)[ids] -> core.quorum.quorum_commit -> observe; K1's launch
     count must rise by exactly one per step; and the quorum call's host time
     back to back, after the host slept and after a synchronise that waited
     for the device, as long as a weights phase;
     then the protocol path, on the card's host and launching nothing on
     the card: WOC's simulator (``repro_torch.core.runner``) reproduces
     the golden runs of tests/test_scenario.py exactly, runs the paper's
     §5.1 deployment (5 replicas, 2 clients, batch 10, 40,000 ops of the
     90/5/5 mix) for woc, cabinet and epaxos, Fig. 7's 9 replicas (t_fail
     2) and Fig. 5's 0% conflict mix for woc and cabinet, every op
     committed, one run twice with equal results, and a Nemesis(2) fault
     schedule whose history is checked for linearizability and
     state-machine safety, with the reference's verdict; serial only (the
     parallel shard runner forks, which a process with CUDA must not); the
     host CPU's model beside the card;
     then the served path, on the card's host and launching nothing on the
     card: WOC's transport (``repro_torch.transport``), one process per
     replica and per client over localhost sockets, runs
     examples/scenarios/served_kv.json, the §5.1 deployment (40,000
     writes), and a crash of replica 0 restarted in recovery mode, each
     stage waited for on the sockets (``launch.served.crash_restart``);
     every op committed, every history linearizable, the queues bounded;
     with the codec's branch (msgpack or JSON) and the processes' start-up
     seconds, as {"served_path": ...};
  4. K2 (flash attention) and K3 (SSD intra-chunk) against their plain
     versions on the card, ragged edges of their tensor-core tiles included,
     and K2 with keys of their own length (cross-attention at the seamless
     prefill's shape, a ragged GQA pair, one query, one key; twice, bit for
     bit) and the seamless encoder's non-causal self-attention; K2 raising,
     with no launch, for causal attention with Sk != S, also where a
     gradient is wanted; hd 192 (nemotron-4-340b), bf16 and float32,
     causal and with keys of their own length;
     K3's backward kernel against its closed-form plain version evaluated
     in float64 on the same cases, and a gradient of ``ssd_chunked`` with any of x, dt, A, Bm, Cm
     requiring one launching K3 once and its backward exactly once, equal
     to the plain scan's gradient (under no_grad: K3 once, no backward);
     and the smoke zamba2 (float32) served on the card against the same on
     the CPU;
  5. the serving main path: zamba2-1.2b at full width and depth (bf16,
     random weights from --seed), 8 prompts of 2048 tokens, then 32 greedy
     decode steps; K3 must launch 38 times and K2 6 times in the prefill and
     neither in decode; time to first token, prefill and decode rates, peak
     memory, and a profiled prefill;
  6. K2's backward against the plain version's autograd gradient on the
     card (the training shape, every head dim, GQA and ratio 1, ragged and
     non-causal, hd 128 ragged causal and non-causal, hd 192 causal and
     with keys of their own length, float32 and bf16; keys
     of their own length, non-causal: the seamless training cross-attention
     (8, 2048 queries, 512 keys, 16, 16, 64), S 77 against Sk 300 with GQA,
     1024 queries against 512 keys, one key, one query, and the seamless
     encoder's self-attention, each twice bit for bit; causal Sk != S
     raising before any launch), K2's log-sum-exp output, and
     ``layers.attend`` on the card differentiable through it;
  7. the smoke qwen3-1.7b (float32) on the card against the CPU: prefill and
     3 decode steps, 2 train steps (2 microbatches, remat), and a checkpoint
     saved from the card and restored bit for bit;
  8. the dense serving path, as in 5 for qwen3-1.7b at full width and
     depth: K2 must launch 28 times in the prefill and not in decode;
  9. the smoke zamba2 and mamba2 (float32), 2 train steps each on the card
     against the CPU as in 7; then the training paths: qwen3-1.7b, then
     zamba2-1.2b, at full width and depth, 5 steps (``--train-steps``) of
     8 x 2048 tokens from the port's data pipeline through
     ``launch.train.make_train_step`` (2 microbatches, remat, float32
     moments); a qwen3 step must launch K2's backward 56 times, a zamba2
     step K3's backward 76 times, K3 152, K2's backward 12 and K2 24; each
     step with its garbage collections, allocator calls and retries, and
     the card's clock, power and throttle reasons beside it; then the smoke
     granite-moe, qwen3-moe, seamless-m4t and internvl2 (float32) served on
     the card against the CPU (prefill and 3 decode steps, logits and caches
     at 1e-4, equal greedy tokens, the MoE router's choice sets equal
     wherever no near-tie is reported), and, as in 5, granite-moe-3b-a800m
     (K2 32 times in the prefill, not in decode) and seamless-m4t-medium with
     512 frames a request (K2 36 times in the prefill: 12 encoder, 12
     decoder, 12 cross; 12 times a decode step, the cross-attention of one
     query against the 512 cached frames); then the same four smoke configs
     (float32, 2 microbatches, remat), 2 train steps each on the card
     against the CPU as in 7, with the stub frontend's inputs, K2's backward
     launched once an attention layer a microbatch, and the MoE router's
     smallest gap between a token's k-th and (k+1)-th probability held at
     NEAR_TIE or more on the CPU; and the training paths of
     granite-moe-3b-a800m (2 microbatches; a step launches K2 128 times and
     its backward 64) and seamless-m4t-medium (512 frames a sequence, cut
     from one microbatch to two, ENCDEC_TRAIN_CUT; K2 144 times, its
     backward 72: 12 encoder, 12 causal, 12 cross a microbatch), as the
     other training paths, with the model FLOP counted over
     the active experts and, for the encoder, over the frames;
     then, sharded on a 1x1 ("data", "model") mesh over NCCL (world size
     1, a free localhost port, the group destroyed after each phase), through
     the same entry points with ``rules=make_rules(mesh)`` and parameters
     and batches laid out by ``launch.train.distribute_tree``: qwen3-1.7b
     trained 3 steps (one warm-up, 2 timed), its losses and parameters at
     1e-4 of an unsharded run of the same steps (the losses also of the
     unsharded training path's), K2 112 and its backward 56 a step on local
     shards; and zamba2-1.2b served (8 x 2048 prompts, 8 greedy decode
     steps), every step's logits at 1e-4 of the same unsharded and the
     greedy tokens equal, K3 38 and K2 6 a prefill, none a decode step;
     each beside the unsharded path's step time, TTFT, decode ms, peak
     memory and idle share, and whether it is bit-equal;
 10. the dry-run (``launch.dryrun``), after the sharded phases: qwen3-1.7b's
     and zamba2-1.2b's training cells (8 x 2048 tokens, 2 microbatches,
     remat, unsharded) traced once on fake CUDA tensors through the kernel
     ops' fakes, each against one real step on the card: the traced kernel-op
     calls equal the launches a step makes (qwen3: K2 112, its backward 56;
     zamba2: K3 152, its backward 76, K2 24, its backward 12), the traced
     FLOP equal FlopCounterMode's count of the real step exactly, the traced
     argument bytes equal the real parameters', moments' and batch's; the
     roofline's terms beside the training path's median step, the peak
     estimate beside max_memory_allocated (ratios printed, not held); then
     ``lower_cell`` over a fake 256-rank process group on the (16, 16) CUDA
     mesh for qwen3-8b train_4k, zamba2-1.2b prefill_32k and
     nemotron-4-340b prefill_32k (K2 at hd 192): each OK, K2
     (and K3) reaching their ops' fakes on local shards as often as the
     configuration launches them, each record printed as {"dryrun_record": ...};
 11. kernel times beside the plain version's, the bound and the library's,
     as one JSON line {"kernels": [...]}: the kernel's device time from a
     replayed CUDA graph of 10 calls (``ms``; K1's from torch.profiler) and
     from torch.profiler (``kernel_ms``), the time per call through the
     wrapper and of the plain version (CUDA events over back-to-back calls,
     so host overhead included), the library call's from a replayed graph
     too (SDPA's backward captured on its forward's stream), and the card's
     SM clock sampled through NVML while each shape was timed; K2 and its
     backward also at the seamless cross-attention shape and at one
     tensor-parallel shard of nemotron-4-340b (4, 2048, 12, 1, 192), causal;
 12. last line: {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import socket
import threading
import time
import warnings
from pathlib import Path

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.core import quorum as Q  # noqa: E402
from repro_torch.core import weights as W  # noqa: E402
from repro_torch.core.runner import RunConfig, run as run_protocol  # noqa: E402
from repro_torch.core.simulator import Workload  # noqa: E402
from repro_torch.faults import Nemesis  # noqa: E402
from repro_torch.scenario import Scenario, Sharding, run_scenario  # noqa: E402
from repro_torch.shard import ShardedRunConfig, run_sharded  # noqa: E402
from repro_torch.verify import check_history_linearizable, verify_artifacts  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quorum_commit as qc  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch import dryrun, roofline, serve, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for  # noqa: E402
from repro_torch.launch.served import crash_restart, start_up_s  # noqa: E402
from repro_torch.launch.shardings import make_rules  # noqa: E402
from repro_torch.models import family  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.transport import ClusterConfig, run_served  # noqa: E402
from repro_torch.transport import codec as served_codec  # noqa: E402
from repro_torch.transport.net import READ_RESULTS_CAP  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# Main path: the largest cluster of benchmarks/bench_server_scaling.py
# (9 replicas, t_fail = 2) and the largest batch of
# benchmarks/bench_quorum_kernel.py (65,536 ops).
NUM_OBJECTS = 4_194_304
N_REPLICAS = 9
T_FAIL = 2
OPS = 65_536
STEPS = 20
NON_VOTE = 0.10           # share of votes that never arrive
TIMEOUT_MS = 50.0         # latency a non-vote feeds into the EMA

# n at each edge of K1's regimes: a thread a row up to 32, a bitonic network above
COMPARE_N = (1, 2, 3, 5, 7, 9, 16, 17, 31, 32, 33, 64, 65, 128, 512, 1024)
SIGNED_N = (1, 9, 16, 17, 32, 33, 1024)
SIGNED_OPS = 1001
COMPARE_OPS = (1, 127, 1000)
NEAR_T_RTOL = 1e-6        # rows whose prefix sum comes this close to T are excluded
WEIGHT_SUM_RTOL = 1e-6    # float32 sums taken in another order
TIME_SHAPES = ((65_536, 9), (1024, 8), (8192, 8), (8192, 32), (65_536, 16), (1000, 1024))

# Serving main path: zamba2-1.2b as configured (38 layers, d 2048, bf16),
# 8 requests of 2048-token prompts, then 32 greedy decode steps.
SERVE_ARCH = "zamba2-1.2b"
SERVE_BATCH = 8
SERVE_PROMPT = 2048
SERVE_DECODE = 32
SMOKE_PROMPT = 64         # the small hybrid slice, card against CPU
SMOKE_DECODE = 3
# The moe, encdec and vlm families: the four smoke configs served card
# against CPU; granite-moe-3b-a800m and seamless-m4t-medium served at full
# size with the zamba2 traffic (seamless: 512 frames a request, S / 4).
SMALL_FAMILIES = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
                  "seamless-m4t-medium", "internvl2-26b")
MOE_ARCH = "granite-moe-3b-a800m"
ENCDEC_ARCH = "seamless-m4t-medium"
NEAR_TIE = 1e-5           # router probabilities closer than this may pick otherwise
K2_CROSS_SHAPE = (8, 2048, 16, 16, 64, 512)   # seamless prefill: B, S, H, KV, hd, Sk
# added to --seed for the four smoke families' train steps, chosen once. At
# 0 the smoke qwen3-moe's router came within 6.6e-7 of a tie in the CPU half
# of the phase (an x86 host, torch 2.13's CPU build). At 4 the H100 host's
# CPU half reads a smallest gap of 2.42e-5 (qwen3-moe) and 3.56e-5
# (granite-moe), only 2.4 and 3.6 NEAR_TIE, and the x86 host 9.2e-5 and
# 1.5e-4: the second step's routing moves with the host's float32 rounding,
# so another --seed or host can stop the phase at this check.
SMALL_FAMILY_TRAIN_SEED = 4

# Dense paths: qwen3-1.7b as configured (28 layers, d 2048, bf16). Serving
# takes the zamba2 traffic; training takes 5 steps of 8 x 2048 tokens.
DENSE_ARCH = "qwen3-1.7b"
TRAIN_BATCH = 8
TRAIN_SEQ = 2048
TRAIN_STEPS = 5
TRAIN_TOTAL_STEPS = 10_000          # the schedule's length (the JAX default)
SMALL_TRAIN_STEPS = (200, 201)      # full learning rate in a 300-step schedule
K2_TRAIN_SHAPE = (4, 2048, 16, 8, 128)   # one microbatch of qwen3-1.7b
# one tensor-parallel shard (8 ranks) of nemotron-4-340b: 96 heads and 8 kv
# heads of hd 192 (18,432 / 96) over 8, B 4 x S 2048
K2_HD192_SHAPE = (4, 2048, 12, 1, 192)
# hd 192 (nemotron-4-340b) in bf16 and float32, causal (ragged, GQA 12) and
# with keys of their own length (B, S, H, KV, hd, Sk), non-causal
K2_HD192_CASES = [(shape, dtype, causal)
                  for shape, causal in (((1, 1, 2, 2, 192), True),
                                        ((1, 130, 12, 1, 192), True),
                                        ((2, 256, 4, 2, 192), True),
                                        ((1, 130, 8, 2, 192, 70), False),
                                        ((2, 77, 6, 2, 192, 300), False))
                  for dtype in (torch.bfloat16, torch.float32)]
# zamba2-1.2b training: the same traffic; one microbatch's K3 shape, and
# the peak device memory a step may take (parameters, gradients, float32
# accumulator and moments ~19 GB, plus activations under remat)
HYBRID_ARCH = "zamba2-1.2b"
K3_TRAIN_SHAPE = (4, 16, 128, 64, 64, 64)   # B, nc, Q, nh, hp, N; x bf16
HYBRID_TRAIN_PEAK_GIB = 40.0
# The moe and encdec training paths: granite-moe-3b-a800m as configured;
# seamless-m4t-medium cut to 2 microbatches (the step's 8 x 2048 tokens
# unchanged): at its one microbatch the float32 logits (16,384 x 256,206,
# 16.8 GB) and their log-sum-exp's backward asked 15.6 GiB more of an H100's
# 79.2 GiB with 69.0 GiB in use
ENCDEC_TRAIN_CUT = {"microbatches": 2}
# Published H100 SXM peaks at the 700 W limit (NVIDIA data sheet).
# the sharded paths (a 1x1 ("data", "model") mesh over NCCL, world size 1)
SHARDED_TRAIN_STEPS = 3             # one warm-up step, then 2 timed
SHARDED_DECODE = 8
SHARDED_TOL = 1e-4                  # sharded against unsharded, atol and rtol
# the dry-run on the card: production-mesh cells traced over a fake 16x16
# process group (launch.dryrun.lower_cell)
# (nemotron-4-340b's prefill_32k traces in about 10 s beside an H100; its
# train_4k in 9-10 minutes, too long for this script)
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("zamba2-1.2b", "prefill_32k"),
                ("nemotron-4-340b", "prefill_32k"))
# the dry-run's kernel ops, by the names of the launch counts
KERNEL_OPS = {"flash_attention": "flash_attention", "flash_attention_bwd": "flash_attention_bwd",
              "ssd_intra_chunk": "ssd_scan", "ssd_intra_chunk_bwd": "ssd_scan_bwd"}

# The protocol path (WOC's simulator, on the card's host). Its golden runs,
# copied from tests/test_scenario.py:32-74, where the reference pins them:
# the port must reproduce each field exactly.
PROTOCOL_GOLDEN = {
    "flat_woc": dict(          # RunConfig(protocol="woc", total_ops=2000, batch_size=10, seed=3)
        committed_ops=2000, makespan_s=0.040969713431704705,
        throughput_tx_s=48816.54843239117, latency_avg_ms=1.3035649910470413,
        latency_p50_ms=1.242662486132747, latency_p99_ms=2.813452602624127,
        fast_path_frac=0.9545, messages=3501),
    "flat_cabinet": dict(      # same knobs, protocol="cabinet"
        committed_ops=2000, makespan_s=0.12971771712868987,
        throughput_tx_s=15418.09433799893, latency_p50_ms=6.0553194258676335,
        fast_path_frac=0.0, messages=3040),
    "sharded_drift": dict(     # Sharding(n_groups=2, locality="drift", working_set=8,
        committed_ops=2000,    #   p_working=0.9, steal_threshold=2), 3 replicas, seed 5
        makespan_s=0.06748755811196536, throughput_tx_s=29635.09209626308,
        latency_p50_ms=5.645318806117558, fast_path_frac=0.133, messages=3982,
        migrations=19, redirected_ops=100, remote_frac=0.165, steal_hints=71),
    "sharded_uniform": dict(   # ShardedRunConfig(n_groups=2, total_ops=2000, batch_size=10, seed=3)
        committed_ops=2000, makespan_s=0.02649124472521434,
        throughput_tx_s=75496.64127697262, latency_p50_ms=1.3455711655872165,
        fast_path_frac=0.9385, messages=4246),
    "legacy_crash": dict(      # RunConfig(protocol="woc", total_ops=3000, batch_size=10,
        committed_ops=3000,    #   crash_at=0.05, recover_at=0.4, seed=0)
        makespan_s=0.47268602465982446, latency_p99_ms=251.22218468018943,
        fast_path_frac=0.928, messages=6008),
}
# The paper's §5.1 deployment (RunConfig's defaults: 5 replicas, 2 clients,
# batch 10, 5 in flight, 40,000 ops of the 90/5/5 mix) for each protocol;
# Fig. 7's largest cluster (9 replicas, t_fail 2); Fig. 5's 0% conflict mix.
ZERO_CONFLICT = dict(p_independent=1.0, p_common=0.0, p_hot=0.0)
PROTOCOL_RUNS = (("woc", {}), ("cabinet", {}), ("epaxos", {}),
                 ("woc", {"n_replicas": 9, "t_fail": 2}),
                 ("cabinet", {"n_replicas": 9, "t_fail": 2}),
                 ("woc", {"workload": ZERO_CONFLICT}),
                 ("cabinet", {"workload": ZERO_CONFLICT}))
# One draw of tests/test_faults.py's fault-schedule property (woc, the
# paper mix, 3,000 ops): Nemesis(2) crashes and recovers a replica and
# partitions the cluster. The reference passes both checks on it
# (tests/test_torch_protocol.py holds this verdict to the reference's); the
# port must give the same verdict. Other seeds fail in the reference
# (ROADMAP queue 3), so the seed is fixed, not --seed.
NEMESIS_SEED = 2
NEMESIS_VERDICT = ((True, "ok (3000 ops linearizable per object)"),
                   (True, "ok (3000 committed ops verified)"))
PROTOCOL_PHASE_LIMIT_S = 60.0

# The served path (WOC's transport: one process per replica and per client
# over localhost sockets, on the card's host): the served deployment of
# examples/scenarios/served_kv.json; the protocol path's §5.1 deployment
# (RunConfig's defaults: 5 replicas, 2 clients, batch 10, 5 in flight,
# 40,000 writes of the 90/5/5 mix) served; and the crash and restart of
# replica 0 at tests/test_transport.py's configuration, its stages waited
# for on the sockets (``launch.served.crash_restart``).
SERVED_CONFIG = Path(__file__).resolve().parent / "examples" / "scenarios" / "served_kv.json"
SERVED_PAPER = dict(n_replicas=5, n_clients=2, batch_size=10, max_inflight=5,
                    total_ops=40_000, reads_fraction=0.0, p_common=0.05, p_hot=0.05,
                    n_hot=4, time_limit_s=120.0, trace=False)
SERVED_CRASH = dict(n_replicas=5, n_clients=2, total_ops=2400, batch_size=8, seed=13,
                    time_limit_s=60.0, trace=False)
# the phase took 91-104 s beside an H100 80GB HBM3 (host: 8 processors of
# family 6 model 207), of which each cluster's start-up (torch's import in
# five processes at once) 9-12.5 s
SERVED_PHASE_LIMIT_S = 180.0

HBM_BYTES_PER_S = roofline.HBM_BW
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = roofline.PEAK_FLOPS
FP64_OPS_PER_S = 67e12              # float64 on the tensor cores
L2_BYTES = 50 * 2**20
GRAPH_READINGS = 5                  # a kernel's ms: the median of this many graph_ms


def resource_usage() -> dict:
    """Registers and spilled bytes of each kernel instantiation built in this
    run, from nvcc --resource-usage (none for a library already built)."""
    usage: dict[str, str] = {}
    kernel = None
    for out in _build.compiler_output.values():
        for line in out.splitlines():
            if "Function properties for" in line:
                m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)(I\w*?E)?E", line)
                kernel = (m.group(1) + (m.group(2) or "")) if m else line.split()[-1]
            elif kernel and "spill stores" in line:
                usage[kernel] = ", ".join(x.strip() for x in line.split(",")[1:])
            elif kernel and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line)
                usage[kernel] = f"{regs.group(1) if regs else '?'} registers, " + usage.get(kernel, "")
                kernel = None
    if "ssd_scan" in _build.compiler_output:
        usage["ssd_intra_chunk_kernel roles"] = k3_roles("ssd_scan", "ssd_intra_chunk_kernel",
                                                         "ssd_intra_chunk_registers")
    if "ssd_scan_bwd" in _build.compiler_output:
        usage["ssd_bwd_heads_kernel roles"] = k3_roles("ssd_scan_bwd", "ssd_bwd_heads_kernel",
                                                       "ssd_intra_chunk_bwd_registers")
    return usage


def k3_roles(source: str, kernel_name: str, registers: str) -> str:
    """A warp-specialised K3 kernel (the forward's or the backward's heads
    kernel) by role: the registers setmaxnreg gives its producer and
    consumer warpgroups (the library's ``registers(role)``; ptxas's count
    above is the launch count, for both), and the highest register each
    instantiation's SASS names, which shows whether the consumers' code uses
    the budget above the launch count (cuobjdump, beside nvcc). Spills are
    ptxas's, one count for both roles."""
    lib = _build.library(source)
    roles = (f"producer {getattr(lib, registers)(0)} registers, consumers "
             f"{getattr(lib, registers)(1)} (setmaxnreg)")
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, timeout=120).stdout
    highest, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            panels = re.search(r"Li(\d)E", name)
            kernel = (f"{kernel_name}<{'bf16' if 'bfloat16' in name else 'float'}"
                      f"{', ' + panels.group(1) if panels else ''}>"
                      if kernel_name in name else None)
        elif kernel:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            highest[kernel] = max([highest.get(kernel, 0)] + regs)
    return roles + "; highest register in the SASS: " + ", ".join(
        f"{k} R{v}" for k, v in sorted(highest.items()))


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def toolchain() -> dict:
    """The versions this run was built and run with: Python, torch, the CUDA
    torch was built for, nvcc's release line and the card's driver."""
    nvcc = subprocess.run([_build.nvcc(), "--version"], check=True, capture_output=True,
                          text=True, timeout=60).stdout
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "nvcc": next(line for line in nvcc.splitlines() if "release" in line).strip(),
            "driver": driver.strip().splitlines()[0]}


# ---------------------------------------------------------------------------
# inputs, made with numpy from the seed
# ---------------------------------------------------------------------------


def tie_inputs(rng, ops_, n):
    """Arrivals on a coarse integer grid (heavy ties), 30% non-votes, 5% rows
    without any vote; half the rows carry uniform weights, half geometric
    weights in a random rank order; a threshold of 30-70% of the total."""
    a = rng.integers(0, 5, (ops_, n)).astype(np.float32)
    a[rng.random((ops_, n)) < 0.3] = np.inf
    a[rng.random(ops_) < 0.05] = np.inf
    w = rng.uniform(0.1, 8.0, (ops_, n)).astype(np.float32)
    ranks = rng.permuted(np.tile(np.arange(n), (ops_, 1)), axis=1)
    w[::2] = W.geometric_weights_np(n, 1.4)[ranks[::2]]
    thr = (w.astype(np.float64).sum(-1) * rng.uniform(0.3, 0.7, ops_)).astype(np.float32)
    return a, w, thr


def make_steps(rng, num_objects, ops_, n, steps):
    """Per step: unique object ids, arrivals (inf = no vote) and the latencies
    the EMA observes, from per-replica lognormal latencies."""
    base = rng.lognormal(np.log(2.0), 0.5, n)
    ids = np.stack([rng.choice(num_objects, ops_, replace=False)
                    for _ in range(steps)])
    lat = (base * rng.lognormal(0.0, 0.3, (steps, ops_, n))).astype(np.float32)
    vote = rng.random((steps, ops_, n)) >= NON_VOTE
    arrivals = np.where(vote, lat, np.inf).astype(np.float32)
    observed = np.where(vote, lat, TIMEOUT_MS).astype(np.float32)
    return ids, arrivals, observed


def near_threshold(a, w, thr):
    """Rows whose float64 prefix sum, in stable arrival order, lies within
    NEAR_T_RTOL of T: there the float32 crossing depends on summation order."""
    a, w = a.cpu().double().numpy(), w.cpu().double().numpy()
    order = np.argsort(a, axis=-1, kind="stable")
    t_s = np.take_along_axis(a, order, -1)
    csum = np.cumsum(np.where(np.isfinite(t_s), np.take_along_axis(w, order, -1), 0.0), -1)
    T = w.sum(-1) / 2 if thr is None else thr.cpu().double().numpy()
    return torch.from_numpy(np.any(
        np.abs(csum - T[:, None]) <= NEAR_T_RTOL * np.abs(T)[:, None], axis=-1))


def compare(what, got, want, near) -> tuple[float, float]:
    """Exact on committed, commit_time, quorum_size and members, weight_sum at
    WEIGHT_SUM_RTOL, outside the near-threshold rows; returns the largest
    absolute and relative error of the float outputs."""
    keep = ~near.to(got[0].device)
    names = ("commit_time", "quorum_size", "committed", "weight_sum", "members")
    for name, g, e in zip(names, got, want):
        if (g is None) != (e is None):
            raise AssertionError(f"{what}: {name} present in only one result")
        if g is None:
            continue
        if g.dtype != e.dtype or g.shape != e.shape:
            raise AssertionError(f"{what}: {name} {g.dtype}{tuple(g.shape)} vs "
                                 f"{e.dtype}{tuple(e.shape)}")
        g, e = g[keep], e[keep]
        if name == "weight_sum":
            if not torch.allclose(g, e, rtol=WEIGHT_SUM_RTOL, atol=0.0):
                raise AssertionError(f"{what}: weight_sum beyond rtol "
                                     f"{WEIGHT_SUM_RTOL}: {(g - e).abs().max()}")
        elif not torch.equal(g, e):
            bad = (g != e).reshape(len(g), -1).any(-1).nonzero()[:5, 0].tolist()
            raise AssertionError(f"{what}: {name} differs in kept rows {bad}")
    abs_err = rel_err = 0.0
    for g, e in ((got[0], want[0]), (got[3], want[3])):
        g, e = g[keep].double(), e[keep].double()
        fin = torch.isfinite(e) & (e != 0)
        if fin.any():
            diff = (g[fin] - e[fin]).abs()
            abs_err = max(abs_err, float(diff.max()))
            rel_err = max(rel_err, float((diff / e[fin].abs()).max()))
    return abs_err, rel_err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_k1(rng) -> None:
    """K1 against its plain version on the card."""
    rows = excluded = 0
    max_rel = 0.0
    for n in COMPARE_N:
        for ops_ in COMPARE_OPS:
            a_np, w_np, thr_np = tie_inputs(rng, ops_, n)
            a, w, thr = (torch.from_numpy(x).cuda() for x in (a_np, w_np, thr_np))
            for th in (None, thr):
                what = f"K1 n={n} ops={ops_} threshold={th is not None}"
                got = qc.quorum_commit_cuda(a, w, th, members=True)
                torch.cuda.synchronize()
                want = qc.quorum_commit_plain(a, w, th, members=True)
                near = near_threshold(a, w, th)
                max_rel = max(max_rel, compare(what, got, want, near)[1])
                rows += ops_
                excluded += int(near.sum())
            got = ops.quorum_commit(a, w)
            torch.cuda.synchronize()
            compare(f"ops.quorum_commit n={n} ops={ops_}", got + (None,),
                    qc.quorum_commit_plain(a, w)[:4] + (None,),
                    near_threshold(a, w, None))
            got = qc.quorum_commit_cuda(a, w)
            torch.cuda.synchronize()
            compare(f"K1 n={n} ops={ops_} without members", got,
                    qc.quorum_commit_plain(a, w), near_threshold(a, w, None))
    for n in SIGNED_N:
        a_np, w_np, thr_np = tie_inputs(rng, SIGNED_OPS + 1, n)
        a_np[a_np == 0] = np.where(rng.random(int((a_np == 0).sum())) < 0.5, -0.0, 0.0)
        a_np[rng.random(a_np.shape) < 0.05] = np.float32("nan")
        a_np[rng.random(a_np.shape) < 0.02] = -np.float32("nan")
        on_cpu = [torch.from_numpy(x) for x in (a_np, w_np, thr_np)]
        on_card = [x.cuda() for x in on_cpu]
        # offset 1: slices that start n floats into their storage on the card
        for offset, with_threshold in ((0, False), (0, True), (1, False), (1, True)):
            a, w, thr = (x[offset:offset + SIGNED_OPS] for x in on_card)
            ac, wc, thrc = (x[offset:offset + SIGNED_OPS] for x in on_cpu)
            th, thc = (thr, thrc) if with_threshold else (None, None)
            what = f"K1 signed zeros, NaN, n={n} offset={offset} threshold={with_threshold}"
            got = qc.quorum_commit_cuda(a, w, th, members=True)
            torch.cuda.synchronize()
            want = qc.quorum_commit_plain(ac, wc, thc, members=True)
            near = near_threshold(ac, wc, thc)
            max_rel = max(max_rel, compare(what, tuple(x.cpu() for x in got), want, near)[1])
            rows += SIGNED_OPS
            excluded += int(near.sum())
            # the plain version on the card sorts the same canonical keys
            compare(f"plain {what} on the card vs the CPU", tuple(
                x.cpu() for x in qc.quorum_commit_plain(a, w, th, members=True)), want, near)
    print(f"K1 vs plain: {rows} rows, {excluded} within {NEAR_T_RTOL} of T "
          f"excluded, max relative error {max_rel!r}; the plain version on the "
          f"card equals the CPU's on signed zeros and NaN")

    # K1 has no backward kernel: an input that requires a gradient makes the
    # wrapper raise before it launches; under no_grad it launches once
    a_np, w_np, thr_np = tie_inputs(rng, 129, N_REPLICAS)
    a, w, thr = (torch.from_numpy(x).cuda() for x in (a_np, w_np, thr_np))
    for name in ("arrivals", "weights", "threshold"):
        args = {"arrivals": a, "weights": w, "threshold": thr}
        args[name] = args[name].clone().requires_grad_()
        call = lambda: qc.quorum_commit_cuda(args["arrivals"], args["weights"],  # noqa: E731
                                             args["threshold"], members=True)
        hold_grad_raise(call, lambda: qc.launches, f"K1 with {name} requiring a gradient")
        before = qc.launches
        with torch.no_grad():
            got = call()
        torch.cuda.synchronize()
        if qc.launches != before + 1:
            raise AssertionError(f"K1 under no_grad with {name} requiring a gradient "
                                 f"launched {qc.launches - before} times, expected 1")
        compare(f"K1 under no_grad, {name} requiring a gradient", got,
                qc.quorum_commit_plain(a, w, thr, members=True), near_threshold(a, w, thr))
    print("K1 raises NotImplementedError, launching nothing, for arrivals, weights or "
          "threshold requiring a gradient; under no_grad it launches once and agrees")


def signed_rows(rng, rows, n):
    """EMAs on a small integer grid with -0.0 beside +0.0, NaN, -NaN and
    +inf, where the card's torch.sort orders raw values unlike the CPU's."""
    ema = rng.integers(0, 4, (rows, n)).astype(np.float32)
    ema[ema == 0] = np.where(rng.random(int((ema == 0).sum())) < 0.5, -0.0, 0.0)
    ema[rng.random((rows, n)) < 0.1] = np.float32("nan")
    ema[rng.random((rows, n)) < 0.1] = -np.float32("nan")
    ema[rng.random((rows, n)) < 0.05] = np.inf
    return torch.from_numpy(ema)


def check_rank_sort(rng) -> None:
    """core.weights' rank sort on the card equals the CPU's (jnp.argsort's
    order) on rows with -0.0 and ±NaN: ``_ranks``, ``WeightTracker.ranks``
    and ``weights`` and ``node_weights_from_latency``, at n in each of
    torch.sort's regimes on the card, the main path's 9 included."""
    for n in (9, 33, 200, 1024, 5000):
        ema = signed_rows(rng, 4 if n > 1000 else 2000, n)
        what = f"rank sort n={n}"
        if not torch.equal(W._ranks(ema.cuda()).cpu(), W._ranks(ema)):
            raise AssertionError(f"{what}: _ranks on the card differs from the CPU")
        on_card = W.WeightTracker(latency_ema=ema.cuda())
        on_cpu = W.WeightTracker(latency_ema=ema.clone())
        if not torch.equal(on_card.ranks().cpu(), on_cpu.ranks()):
            raise AssertionError(f"{what}: WeightTracker.ranks on the card differs")
        r = 1.4 if n < 64 else 1.05
        torch.testing.assert_close(on_card.weights(r).cpu(), on_cpu.weights(r), rtol=1e-6,
                                   atol=float(np.finfo(np.float32).tiny),
                                   msg=lambda m: f"{what}: weights: {m}")
        for row in ema[:4]:
            torch.testing.assert_close(
                W.node_weights_from_latency(row.cuda(), r).cpu(),
                W.node_weights_from_latency(row, r), rtol=1e-6,
                atol=float(np.finfo(np.float32).tiny),
                msg=lambda m: f"{what}: node_weights_from_latency: {m}")
    print("rank sort on the card equals the CPU on -0.0 and ±NaN rows: _ranks, "
          "WeightTracker.ranks and weights, node_weights_from_latency")


def hold_grad_raise(call, count, what) -> None:
    """``call()`` asks a kernel with no backward for a gradient: it must raise
    NotImplementedError and launch nothing (``count()`` unmoved)."""
    before = count()
    try:
        call()
    except NotImplementedError:
        pass
    else:
        raise AssertionError(f"{what}: no NotImplementedError where a gradient is wanted")
    torch.cuda.synchronize()
    if count() != before:
        raise AssertionError(f"{what}: {count() - before} launches before the raise")


def run_slice(tracker, r, ids, arrivals, observed, on_step=lambda s, w, res: None):
    """The main path: per step weights(r)[ids] -> quorum_commit -> observe.
    Calls ``on_step(step, weights, result)`` after each step, outside the
    timed phases, and keeps nothing, as a caller that uses each result once
    would. Returns, per step, the seconds each phase took (host clock, the
    device synchronised after each phase) and, as ``<phase>_host``, the part
    before the synchronisation."""
    device = tracker.latency_ema.device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    spent = []
    sync()
    for s in range(len(ids)):
        times = {}

        def phase(name, fn):
            t0 = time.perf_counter()
            result = fn()
            t1 = time.perf_counter()
            sync()
            times[name] = time.perf_counter() - t0
            times[name + "_host"] = t1 - t0
            return result

        w = phase("weights", lambda: tracker.weights(r)[ids[s]])
        res = phase("quorum", lambda: Q.quorum_commit(arrivals[s], w))
        phase("observe", lambda: tracker.observe(ids[s], observed[s]))
        spent.append(times)
        on_step(s, w, res)
    return spent


def check_small_slice(rng) -> None:
    """The slice at 64 objects x 5 replicas x 5 steps of 16 ids on the card
    and on the CPU: results equal (weight_sum at rtol), EMA at rtol 1e-6."""
    n = 5
    r = W.solve_steepness(n, 2)
    steps = make_steps(rng, 64, 16, n, 5)
    runs = {}
    for device in ("cuda", "cpu"):
        tracker = W.WeightTracker.init(64, n, device=device)
        data = [torch.from_numpy(x).to(device) for x in steps]
        out = []
        run_slice(tracker, r, *data, on_step=lambda s, w, res: out.append((w, res)))
        runs[device] = (out, tracker)
    for s, ((wg, rg), (wc, rc)) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        torch.testing.assert_close(wg.cpu(), wc, rtol=1e-6, atol=0.0)
        got = (rg.commit_time, rg.quorum_size, rg.committed, rg.weight_sum, rg.members)
        want = (rc.commit_time, rc.quorum_size, rc.committed, rc.weight_sum, rc.members)
        compare(f"slice step {s}", tuple(x.cpu() for x in got), want,
                near_threshold(torch.from_numpy(steps[1][s]), wc, None))
    torch.testing.assert_close(runs["cuda"][1].latency_ema.cpu(),
                               runs["cpu"][1].latency_ema, rtol=1e-6, atol=0.0)
    print("slice 64 objects x 5 replicas x 5 steps: card equals CPU")


def self_times_us(prof, on_device: bool) -> dict[str, float]:
    """Self time (us) by name in a profiler run: kernels and copies on the
    device, or operators and CUDA API calls on the host."""
    from torch.autograd import DeviceType
    kind = DeviceType.CUDA if on_device else DeviceType.CPU
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == kind:
            took = e.self_device_time_total if on_device else e.self_cpu_time_total
            out[e.key] = out.get(e.key, 0.0) + took
    return out


def top_ms(times: dict[str, float], count: int) -> dict[str, float]:
    """The ``count`` largest of ``times`` (us) in ms, by name cut to 80
    characters; a cut name that repeats carries its rank."""
    out: dict[str, float] = {}
    for rank, (k, v) in enumerate(sorted(times.items(), key=lambda kv: -kv[1])[:count]):
        out[k[:80] if k[:80] not in out else f"{k[:74]} #{rank + 1}"] = v / 1e3
    return out


def profile_steps(tracker, r, ids, arrivals, observed) -> dict:
    """Device busy and idle share, the top kernels and K1's device time and
    launches over a few main-path steps, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slice(tracker, r, ids, arrivals, observed)
        wall_us = 1e6 * (time.perf_counter() - t0)
    times = self_times_us(prof, on_device=True)
    busy_us = sum(times.values())
    k1 = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
          and "quorum_commit" in e.key]
    return {"steps": len(ids), "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
            "k1_ms": sum(e.self_device_time_total for e in k1) / 1e3,
            "k1_launches": sum(e.count for e in k1),
            "top_kernels_ms": top_ms(times, 6),
            "top_host_ms": top_ms(self_times_us(prof, on_device=False), 8)}


def quorum_host_probe(arrivals, w, wait_ms: float, reps: int = 20) -> dict:
    """Median host ms of one core.quorum.quorum_commit call, synchronised
    after each: back to back, after the host slept ``wait_ms``, and right
    after a synchronise that waited ``wait_ms`` for the device."""
    def device_wait_ms(cycles):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    cycles = int(1e6 * wait_ms / device_wait_ms(1_000_000))

    def host_ms(before):
        took = []
        for _ in range(reps):
            before()
            t0 = time.perf_counter()
            Q.quorum_commit(arrivals, w)
            took.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        return 1e3 * float(np.median(took))

    def device_wait():
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()

    return {"wait_ms": wait_ms, "device_wait_ms": device_wait_ms(cycles),
            "back_to_back_ms": host_ms(lambda: None),
            "after_host_sleep_ms": host_ms(lambda: time.sleep(wait_ms / 1e3)),
            "after_device_wait_ms": host_ms(device_wait)}


def main_path(rng) -> dict:
    r = W.solve_steepness(N_REPLICAS, T_FAIL)
    t0 = time.perf_counter()
    ids, arrivals, observed = (torch.from_numpy(x).cuda() for x in
                               make_steps(rng, NUM_OBJECTS, OPS, N_REPLICAS, STEPS))
    tracker = W.WeightTracker.init(NUM_OBJECTS, N_REPLICAS, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    committed_share = []
    errors = []

    def check_step(s, w, res):
        if res.members.shape != (OPS, N_REPLICAS) or res.committed.shape != (OPS,):
            raise AssertionError(f"step {s}: result shapes {res.members.shape}")
        c = res.committed
        if not (torch.isfinite(res.commit_time[c]).all()
                and torch.isinf(res.commit_time[~c]).all()
                and ((res.quorum_size[c] >= 1) & (res.quorum_size[c] <= N_REPLICAS)).all()
                and (res.quorum_size[~c] == 0).all()
                and (res.members.sum(-1, dtype=torch.int32) == res.quorum_size).all()
                and (res.weight_sum[c] >= w.sum(-1)[c] / 2 * (1 - NEAR_T_RTOL)).all()):
            raise AssertionError(f"step {s}: inconsistent QuorumResult")
        committed_share.append(float(c.float().mean()))
        if s == STEPS - 1:
            errors.extend(compare(
                "main path, last step, vs plain",
                (res.commit_time, res.quorum_size, res.committed, res.weight_sum,
                 res.members),
                qc.quorum_commit_plain(arrivals[s], w, members=True),
                near_threshold(arrivals[s], w, None)))

    qc.launches = 0
    spent = run_slice(tracker, r, ids, arrivals, observed, on_step=check_step)
    launches = qc.launches
    if launches != STEPS:
        raise AssertionError(f"main path launched K1 {launches} times in {STEPS} steps")
    if min(committed_share) < 0.9:
        raise AssertionError(f"committed share {min(committed_share)} < 0.9 "
                             f"with {NON_VOTE:.0%} non-votes and t_fail={T_FAIL}")
    if not torch.isfinite(tracker.latency_ema).all():
        raise AssertionError("latency EMA not finite")
    max_abs, max_rel = errors
    total_s = sum(x[k] for x in spent for k in ("weights", "quorum", "observe"))

    summary = {
        "objects": NUM_OBJECTS, "replicas": N_REPLICAS, "t_fail": T_FAIL,
        "r": r, "ops_per_step": OPS, "steps": STEPS, "launches": launches,
        "setup_s": setup_s, "ops_per_s": STEPS * OPS / total_s,
        "step_ms": 1e3 * total_s / STEPS,
        **{f"{k}_ms": 1e3 * sum(x[k] for x in spent) / STEPS for k in spent[0]},
        **{f"{k}_median_ms": 1e3 * float(np.median([x[k] for x in spent]))
           for k in spent[0]},
        "committed_share": sum(committed_share) / STEPS,
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profile": profile_steps(tracker, r, ids[:5], arrivals[:5], observed[:5]),
    }
    summary["quorum_host_probe"] = quorum_host_probe(
        arrivals[0], tracker.weights(r)[ids[0]], summary["weights_median_ms"])
    print(f"main path: {STEPS} steps x {OPS} ops over {NUM_OBJECTS} objects x "
          f"{N_REPLICAS} replicas: {summary['ops_per_s']:.0f} ops/s, "
          f"{summary['step_ms']:.3f} ms/step (weights {summary['weights_ms']:.3f}, "
          f"quorum {summary['quorum_ms']:.3f}, observe {summary['observe_ms']:.3f})")
    print(json.dumps({"main_path": summary}))
    return summary


def host_cpu() -> str:
    """The host CPU's model as /proc/cpuinfo gives it: vendor, family, model
    number and model name (some hosts report the name as "unknown"; the
    family and model number still say which part), clock and the count of
    processors."""
    fields, count = {}, 0
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = (part.strip() for part in line.partition(":"))
        count += key == "processor"
        fields.setdefault(key, value)
    return (f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} "
            f"model {fields.get('model', '?')} ({fields.get('model name', '?')}), "
            f"{fields.get('cpu MHz', '?')} MHz, {count} processors")


def protocol_row(r) -> dict:
    """What a protocol run reports: committed ops, the simulated
    throughput and latencies (simulated time, not measured), the fast-path
    share and messages, and the host's wall time and event rate."""
    return {"committed_ops": r.committed_ops, "simulated_tx_s": r.throughput_tx_s,
            "simulated_p50_ms": r.latency_p50_ms, "simulated_p99_ms": r.latency_p99_ms,
            "fast_path_frac": r.fast_path_frac, "messages": r.messages, "events": r.events,
            "wall_s": r.wall_s, "events_per_sec": r.events_per_sec}


def deterministic_fields(r) -> dict:
    """Every field of a run's result but its wall-clock telemetry."""
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name not in ("wall_s", "events_per_sec")}


def protocol_path() -> dict:
    """WOC's protocol simulator (``repro_torch.core.runner``), which computes
    in numpy and plain Python on the card's host and launches nothing on the
    card: the golden runs held exactly, the paper's deployments with every
    op committed, one of them twice with equal results, and one fault
    schedule checked for linearizability and state-machine safety. Serial
    only: the parallel shard runner forks, which a process that has
    initialised CUDA must not."""
    t0 = time.perf_counter()
    reset_launch_counts()
    golden_runs = {
        "flat_woc": lambda: run_protocol(RunConfig(protocol="woc", total_ops=2000,
                                                   batch_size=10, seed=3)),
        "flat_cabinet": lambda: run_scenario(Scenario(protocol="cabinet", total_ops=2000,
                                                      batch_size=10, seed=3)),
        "sharded_drift": lambda: run_scenario(Scenario(
            protocol="woc", n_replicas=3, total_ops=2000, batch_size=10, seed=5,
            sharding=Sharding(n_groups=2, locality="drift", working_set=8, p_working=0.9,
                              steal_threshold=2))),
        "sharded_uniform": lambda: run_sharded(ShardedRunConfig(
            n_groups=2, total_ops=2000, batch_size=10, seed=3)),
        "legacy_crash": lambda: run_protocol(RunConfig(
            protocol="woc", total_ops=3000, batch_size=10, crash_at=0.05, recover_at=0.4,
            seed=0)),
    }
    golden = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)     # crash_at/recover_at
        for name, make in golden_runs.items():
            r = make().result
            got = {field: getattr(r, field) for field in PROTOCOL_GOLDEN[name]}
            if got != PROTOCOL_GOLDEN[name]:
                raise AssertionError(f"protocol golden run {name}: {got} != "
                                     f"{PROTOCOL_GOLDEN[name]}")
            golden[name] = got

    runs = []
    for proto, kw in PROTOCOL_RUNS:
        kw = dict(kw)
        if "workload" in kw:
            kw["workload"] = Workload(**kw["workload"])
        cfg = RunConfig(protocol=proto, **kw)
        r = run_protocol(cfg).result
        if r.committed_ops != cfg.total_ops:
            raise AssertionError(f"protocol {proto} {kw}: {r.committed_ops} of "
                                 f"{cfg.total_ops} ops committed")
        row = {"protocol": proto, "n_replicas": cfg.n_replicas, "t_fail": cfg.t_fail,
               "conflict": cfg.workload.p_hot + cfg.workload.p_common,
               "total_ops": cfg.total_ops, **protocol_row(r)}
        print(json.dumps({"protocol_run": row}))
        runs.append(row)
    first = run_protocol(RunConfig(protocol="woc")).result
    again = run_protocol(RunConfig(protocol="woc")).result
    if deterministic_fields(first) != deterministic_fields(again):
        raise AssertionError("two woc runs of one seed differ")

    faults = Nemesis(NEMESIS_SEED).random_schedule(5)
    art = run_protocol(RunConfig(protocol="woc", total_ops=3000, batch_size=10,
                                 faults=faults, seed=NEMESIS_SEED & 0xFF,
                                 sim_time_cap=30.0))
    verdict = (check_history_linearizable(art.result.history), verify_artifacts(art))
    if art.result.committed_ops != 3000 or verdict != NEMESIS_VERDICT:
        raise AssertionError(f"Nemesis({NEMESIS_SEED}) woc run: "
                             f"{art.result.committed_ops} ops, verdict {verdict}, "
                             f"the reference's {NEMESIS_VERDICT}")
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the protocol path launched kernels: {counts}")
    out = {"host_cpu": host_cpu(), "card": device_line(), "golden": golden,
           "runs": runs, "repeat_equal": True,
           "nemesis": {"seed": NEMESIS_SEED, "faults": [type(e).__name__ for e in faults],
                       "linearizable": verdict[0], "state_machine_safe": verdict[1],
                       **protocol_row(art.result)},
           "launches": counts, "phase_s": time.perf_counter() - t0}
    if out["phase_s"] > PROTOCOL_PHASE_LIMIT_S:
        raise AssertionError(f"the protocol path took {out['phase_s']:.1f} s, over "
                             f"{PROTOCOL_PHASE_LIMIT_S} s")
    print(json.dumps({"protocol_path": out}))
    return out


def hold_served(art, cfg, what, healthy: bool) -> dict:
    """What tests/test_transport.py holds of a served run: every client
    drained and every op committed, the history linearizable and the
    artifacts verified, every channel's queue within its bound and the
    reply tables within theirs; for a healthy cluster also the trace's
    commit counters summing to the op count (when traced), every replica
    applying every op, none recovering or isolated, no dropped frame and no
    reconnect. Returns the run's row."""
    r = art.result
    if r.clients_done != cfg.n_clients or r.committed_ops != cfg.total_ops:
        raise AssertionError(f"served {what}: {r.clients_done} of {cfg.n_clients} clients "
                             f"drained, {r.committed_ops} of {cfg.total_ops} ops committed")
    t0 = time.perf_counter()
    linearizable = check_history_linearizable(r.history)
    check_s = time.perf_counter() - t0
    verified = verify_artifacts(art, check_rsm=False)
    if not (linearizable[0] and verified[0]):
        raise AssertionError(f"served {what}: {linearizable}, {verified}")
    if healthy and cfg.trace:
        by_path = sum(v for k, v in r.metrics["counters"].items()
                      if k.startswith("ops_committed_total"))
        if by_path != cfg.total_ops:
            raise AssertionError(f"served {what}: commit counters sum to {by_path}")
    if len(r.node_stats) != cfg.n_replicas:
        raise AssertionError(f"served {what}: {len(r.node_stats)} replicas reported")
    for ns in r.node_stats:
        if max(ns["read_results"], ns["commit_log"]) > READ_RESULTS_CAP:
            raise AssertionError(f"served {what}: replica {ns['node']}'s reply tables")
        if healthy and (ns["applied"] != cfg.total_ops or ns["recovering"]
                        or ns["isolated"]):
            raise AssertionError(f"served {what}: replica {ns['node']} applied "
                                 f"{ns['applied']}, recovering {ns['recovering']}, "
                                 f"isolated {ns['isolated']}")
        for ch in ns["channels"]:
            if max(ch["queue_hwm"], ch["queue_len"]) > ch["max_queue"] or (
                    healthy and (ch["dropped"] or ch["reconnects"])):
                raise AssertionError(f"served {what}: replica {ns['node']}'s channel {ch}")
    channels = [ch for ns in r.node_stats for ch in ns["channels"]]
    return {"committed_ops": r.committed_ops, "clients_done": r.clients_done,
            "makespan_s": r.makespan_s, "throughput_tx_s": r.throughput_tx_s,
            "fast_path_frac": r.fast_path_frac, "linearizable": linearizable[0],
            "check_s": check_s, "verdict": linearizable[1],
            "dropped_frames": sum(ch["dropped"] for ch in channels),
            "reconnects": sum(ch["reconnects"] for ch in channels)}


def hold_crash_restart(art, cfg, stages) -> dict:
    """``hold_served`` of the crash run, and what tests/test_transport.py
    holds of it besides: replica 0 recovered with applied ops, and every
    survivor's channel to it reconnected. Returns the run's row."""
    row = hold_served(art, cfg, "crash_restart", healthy=False)
    stats = {ns["node"]: ns for ns in art.result.node_stats}
    redials = [next(c for c in stats[i]["channels"] if c["dst"] == 0)["reconnects"]
               for i in range(1, cfg.n_replicas)]
    if stats[0]["recovering"] or stats[0]["applied"] <= 0 or min(redials) < 1:
        raise AssertionError(f"served crash_restart: replica 0 recovering "
                             f"{stats[0]['recovering']}, applied {stats[0]['applied']}; "
                             f"survivors' reconnects to it {redials}")
    return {**row, "replica0_applied": stats[0]["applied"],
            "survivor_reconnects_to_0": redials, "stages_s": stages}


def served_path() -> dict:
    """WOC's served transport (``repro_torch.transport``) on the card's host,
    launching nothing on the card: the served_kv deployment, the §5.1
    deployment over sockets, and replica 0 crashed and restarted; each run
    held as tests/test_transport.py holds it. Its processes are started
    with ``subprocess.Popen`` (fork and exec at once), which is safe after
    CUDA is initialised."""
    t0 = time.perf_counter()
    reset_launch_counts()
    start_up = {"replica_import_s": start_up_s("repro_torch.transport.node_runner"),
                "client_import_s": start_up_s("repro_torch.transport.client_driver")}
    runs = {}
    for name, cfg in (("served_kv", ClusterConfig.from_json(SERVED_CONFIG)),
                      ("paper_5_1", ClusterConfig(**SERVED_PAPER))):
        t1 = time.perf_counter()
        art = run_served(cfg)
        runs[name] = {"wall_s": time.perf_counter() - t1, "total_ops": cfg.total_ops,
                      **hold_served(art, cfg, name, healthy=True)}
    cfg = ClusterConfig(**SERVED_CRASH)
    t1 = time.perf_counter()
    art, stages = crash_restart(cfg)
    wall_s = time.perf_counter() - t1
    runs["crash_restart"] = {"wall_s": wall_s, "total_ops": cfg.total_ops,
                             **hold_crash_restart(art, cfg, stages)}
    start_up["cluster_start_s"] = stages["start_s"]
    start_up["replica_restart_s"] = stages["restart_s"]
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the served path launched kernels: {counts}")
    out = {"codec": "msgpack" if served_codec.msgpack is not None else "json",
           "start_up_s": start_up, "runs": runs, "host_cpu": host_cpu(),
           "card": device_line(), "launches": counts, "phase_s": time.perf_counter() - t0}
    if out["phase_s"] > SERVED_PHASE_LIMIT_S:
        raise AssertionError(f"the served path took {out['phase_s']:.1f} s, over "
                             f"{SERVED_PHASE_LIMIT_S} s")
    print(json.dumps({"served_path": out}))
    return out


def event_ms(fn, iters: int) -> float:
    """Time per call on the device's clock (CUDA events) over back-to-back
    calls; host-bound when a call's host work outlasts its kernels."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10, stream=None) -> float:
    """Device time per call on the device's clock (CUDA events) over one
    replay of a CUDA graph of ``iters`` back-to-back calls: the kernels run
    with no host time between them, which neither the profiler's
    attribution nor the events around eager calls (``event_ms``) can
    promise. The graph is captured on ``stream`` (a new one by default); a
    backward is captured on the stream its forward ran on, where autograd
    runs it."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float | None:
    """Device time per call of the kernels ``fn`` launches (torch.profiler),
    or None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    busy_us = sum(self_times_us(prof, on_device=True).values())
    return busy_us / 1e3 / iters if busy_us else None


def time_k1(rng, ops_, n, members: bool) -> dict:
    """Kernel and plain times at one shape, cycling through enough input
    copies to exceed L2, so that inputs come from device memory, with the
    card's SM clock while they were taken."""
    return clocked(lambda: time_k1_shape(rng, ops_, n, members))


def time_k1_shape(rng, ops_, n, members: bool) -> dict:
    _, arrivals, _ = make_steps(rng, 4 * ops_, ops_, n, 1)
    ranks = rng.permuted(np.tile(np.arange(n), (ops_, 1)), axis=1)
    weights = W.geometric_weights_np(n, W.solve_steepness(n, 1))[ranks]
    moved = 8 * ops_ * n + 13 * ops_ + (ops_ * n if members else 0)
    copies = max(1, min(64, math.ceil(2 * L2_BYTES / moved)))
    bufs = [(torch.from_numpy(arrivals[0]).cuda(), torch.from_numpy(weights).cuda())
            for _ in range(copies)]

    def kernel(i):
        return qc.quorum_commit_cuda(*bufs[i % copies], members=members)

    def plain(i):
        return qc.quorum_commit_plain(*bufs[i % copies], members=members)

    call_ms = event_ms(kernel, 200)
    plain_ms = event_ms(plain, 50)
    kernel_device_ms = device_ms(kernel, 200)
    # the main path's own entry point, back to back, when it is the one timed
    core_ms = event_ms(lambda i: Q.quorum_commit(*bufs[i % copies]), 200) if members else None
    bytes_s = moved / HBM_BYTES_PER_S
    operations_s = 2 * ops_ * n / FP32_OPS_PER_S     # threshold sum and prefix sum
    return {"ops": ops_, "n": n, "members": members,
            "kernel_ms": kernel_device_ms if kernel_device_ms is not None else call_ms,
            "kernel_timed_by": "profiler" if kernel_device_ms is not None else "events",
            "call_ms": call_ms, "core_call_ms": core_ms, "plain_ms": plain_ms,
            "plain_device_ms": device_ms(plain, 50),
            "bound_ms": 1e3 * max(bytes_s, operations_s),
            "bound_by": "bytes" if bytes_s >= operations_s else "operations",
            "bytes": moved}


# ---------------------------------------------------------------------------
# K2, K3 and the serving path (zamba2)
# ---------------------------------------------------------------------------


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def attention_inputs(gen, B, S, H, KV, hd, dtype, Sk=None):
    """q (B,S,H,hd) and k, v (B,Sk,KV,hd), Sk = S unless given."""
    Sk = S if Sk is None else Sk
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def ssd_inputs(gen, B, nc, Q_, nh, hp, N, xdtype=torch.bfloat16):
    """K3's inputs as mixer_forward forms them: x from the conv, dt from a
    softplus, seg the per-chunk cumsum of dt*A, B and C in float32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(B, nc, Q_, nh, hp).to(xdtype)
    dt = torch.nn.functional.softplus(randn(B, nc, Q_, nh) - 2.0)
    A = -torch.exp(0.5 * randn(nh))
    seg = torch.cumsum(dt * A, dim=2)
    return x, dt, seg, randn(B, nc, Q_, N), randn(B, nc, Q_, N)


def row_err(got, ref) -> float:
    """The largest error of one output row (one query and head) over that
    row's own largest magnitude."""
    diff = (got.double() - ref.double()).abs().amax(-1)
    return float((diff / ref.double().abs().amax(-1).clamp_min(1e-30)).max())


def hold_bf16_rows(errors, what, name, got, want, ref, err) -> None:
    """The backward kernels' bf16 rule: against the plain version run in
    float32 on the same bf16 inputs (``ref``), the kernel's largest row
    error ``err(got, ref)`` may be at most twice the bf16 plain version's
    ``err(want, ref)``, or one bf16 ulp (2^-8, the output's own rounding)
    where that is larger. Records both errors in ``errors``."""
    errors[f"{name}_row_rel_err"] = got_err = err(got, ref)
    errors[f"{name}_plain_row_rel_err"] = plain_err = err(want, ref)
    if not got_err <= max(2 * plain_err, 2.0 ** -8):
        raise AssertionError(f"{what} {name} in bf16 is farther from float32, row by "
                             f"row, than twice the plain version: {errors}")


def hold_k2(got, q, k, v, causal) -> dict:
    """K2's output held against its plain version on the same inputs. float32
    at atol/rtol 1e-4. bfloat16 at 2e-2, which is a large part of a late
    causal row's magnitude, and also row by row against the plain version run
    in float32 on the same bf16 inputs: the kernel's error relative to each
    row's magnitude may be at most twice the bf16 plain version's. Returns
    the errors."""
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    errors = {"max_abs_err": max_err(got, want)}
    if q.dtype == torch.bfloat16:
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        errors["row_rel_err"], errors["plain_row_rel_err"] = row_err(got, ref), row_err(want, ref)
        if not errors["row_rel_err"] <= 2 * errors["plain_row_rel_err"]:
            raise AssertionError(f"K2 in bf16 is farther from float32, row by row, "
                                 f"than twice the plain version: {errors}")
    return errors


def check_k2_cases(gen, cases) -> dict:
    """K2 on each (shape, dtype, causal) of ``cases`` held by :func:`hold_k2`;
    a non-causal case also twice, bit for bit. Returns the errors."""
    errors = {}
    for shape, dtype, causal in cases:
        q, k, v = attention_inputs(gen, *shape[:5], dtype, *shape[5:])
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        errors[f"{shape} {str(dtype)[6:]} causal={causal}"] = hold_k2(got, q, k, v, causal)
        if not causal:
            if not torch.equal(got, fa.flash_attention_cuda(q, k, v, causal=causal)):
                raise AssertionError(f"K2 at {shape} differs between two runs")
    return errors


def k2_tile_edge_cases() -> list:
    """bf16 cases (shape, dtype, causal) at the edges of the wgmma kernels'
    tiles: forward blocks of 192 q rows up to hd 64 (128 above) and k tiles of
    128 keys (64 at hd 192); the backward's D/dQ blocks of 128 rows with k
    tiles of 128 keys up to hd 64 (64 above), and its dK/dV blocks of 128 keys
    (64 at hd 192) with q tiles of 64 rows. S and Sk one below and above
    those sizes, one row, GQA 16 at hd 64 (qwen3-moe-235b's 64 heads on 4 kv
    heads, which no path runs yet) and hd 192 ragged; shapes of six entries
    are (B, S, H, KV, hd, Sk), non-causal."""
    bf16 = torch.bfloat16
    cases = [((1, S_, 4, 2, 64), bf16, causal) for S_ in (63, 65, 127, 129, 191, 193)
             for causal in (True, False)]
    cases += [((1, S_, 8, 2, 128), bf16, causal) for S_ in (63, 65, 127, 129)
              for causal in (True, False)]
    cases += [((1, 129, 64, 4, 64), bf16, True), ((1, 1, 64, 4, 64), bf16, True),
              ((1, 257, 4, 1, 192), bf16, True), ((1, 65, 4, 1, 192), bf16, False)]
    own = [(1, 129, 4, 2, 64, 127), (1, 191, 4, 2, 64, 129), (1, 127, 64, 4, 64, 65),
           (1, 65, 4, 2, 128, 63), (1, 127, 8, 2, 128, 129), (1, 130, 4, 1, 192, 65)]
    return cases + [(shape, bf16, False) for shape in own]


def check_k2(gen) -> dict:
    """K2 against its plain version on the card (the plain side's products
    without TF32), as :func:`hold_k2` holds it, hd 192 included."""
    cases = [((2, 2048, 32, 32, 64), torch.bfloat16, True),    # zamba2 prefill, B 2
             ((2, 2048, 32, 32, 64), torch.float32, True),
             ((1, 512, 16, 8, 128), torch.bfloat16, True),     # GQA, hd 128
             ((2, 200, 8, 4, 64), torch.float32, True),        # ragged S
             ((2, 200, 8, 4, 64), torch.bfloat16, True),
             ((1, 384, 4, 2, 32), torch.float32, False),       # non-causal
             ((1, 384, 4, 2, 32), torch.bfloat16, False),
             ((2, 64, 4, 4, 16), torch.float32, True)]         # smoke heads
    # edges of the tensor-core tiles: one row, and 130 rows (two full 64-row
    # tiles and a ragged one), at every head dim but the main path's
    cases += [((1, 1, 2, 2, hd), torch.bfloat16, True) for hd in (16, 32, 128)]
    cases += [((1, 130, 8, 2, hd), torch.bfloat16, True) for hd in (16, 32, 128)]
    # keys of their own length (B, S, H, KV, hd, Sk), non-causal: the
    # seamless prefill's cross-attention, a ragged GQA pair, one query
    # (decode) and one key; and the seamless encoder's self-attention. Each
    # twice, bit for bit.
    own = [K2_CROSS_SHAPE, (2, 77, 6, 2, 64, 300), (8, 1, 16, 16, 64, 512),
           (2, 40, 4, 2, 32, 1)]
    cases += [(shape, dtype, False) for shape in own
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [((8, 512, 16, 16, 64), torch.bfloat16, False)]
    cases += k2_tile_edge_cases()
    errors = check_k2_cases(gen, cases + K2_HD192_CASES)
    # causal needs Sk == S: it raises, also where a gradient is wanted, and
    # nothing is launched
    q, k, v = attention_inputs(gen, 1, 16, 2, 2, 32, torch.float32, Sk=24)
    before = (fa.launches, fa.bwd_launches)
    for call in (lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                 lambda: ops.flash_attention(q, k.clone().requires_grad_(), v, causal=True)):
        try:
            call()
            raise AssertionError("K2 took causal attention with Sk != S")
        except ValueError:
            pass
    if (fa.launches, fa.bwd_launches) != before:
        raise AssertionError("K2 launched where it raised")
    print(f"K2 vs plain on the card, max abs error: {json.dumps(errors)}; keys of their "
          f"own length twice bit for bit; causal Sk != S raises")
    return errors


def hold_k3(got, args) -> list:
    """K3's outputs held against its plain version at atol/rtol 1e-4; returns
    the max abs errors of y, state and decay."""
    errs = []
    for g, w in zip(got, ssd.ssd_intra_chunk_plain(*args)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        errs.append(max_err(g, w))
    return errs


def ssd_output_grads(gen, B, nc, Q_, nh, hp, N):
    """Gradients of K3's three outputs, y, state and decay."""
    return [torch.randn(shape, generator=gen, device="cuda")
            for shape in ((B, nc, Q_, nh, hp), (B, nc, nh, hp, N), (B, nc, nh))]


def hold_k3_backward(got, args, grads) -> dict:
    """K3's backward held against its closed-form plain version evaluated in
    float64 on the same inputs: the float32 gradients (ddt, dseg, dB, dC, and
    dx for a float32 x) at atol/rtol 1e-4, the forward's contract; a bf16 dx
    by :func:`hold_bf16_rows` against the plain version run with x in float32
    (the same bf16 values). The float64 evaluation shares no rounding with the
    kernel, which the plain version in float32 would: ddt and dseg are small
    differences of large sums, and float32 products leave the plain version
    itself about 1e-4 from it. Records, for each float32 gradient, its
    largest error over the limit (``*_over_limit_vs_float64``) and the plain
    float32 version's (``*_plain_over_limit_vs_float64``, not held), and
    the largest difference from the plain float32 version (``*_max_abs_err``).
    Returns the errors."""
    want = ssd.ssd_intra_chunk_bwd_plain(*args, *grads)
    exact = ssd.ssd_intra_chunk_bwd_plain(*(t.double() for t in (*args, *grads)))
    errors = {}
    for name, g, w, e in zip(("dx", "ddt", "dseg", "dB", "dC"), got, want, exact):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"K3 backward {name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}, or not finite")
        errors[f"{name}_max_abs_err"] = max_err(g, w)
        if g.dtype == torch.float32:
            limit = 1e-4 + 1e-4 * e.abs()
            errors[f"{name}_over_limit_vs_float64"] = float(((g - e).abs() / limit).max())
            errors[f"{name}_plain_over_limit_vs_float64"] = float(((w - e).abs() / limit).max())
            torch.testing.assert_close(g.double(), e, atol=1e-4, rtol=1e-4,
                                       msg=lambda m: f"K3 backward {name} vs float64: {m}")
    del exact
    if args[0].dtype == torch.bfloat16:
        ref = ssd.ssd_intra_chunk_bwd_plain(args[0].float(), *args[1:], *grads)[0]
        hold_bf16_rows(errors, "K3 backward", "dx", got[0], want[0], ref, row_err)
    return errors


def check_k3(gen) -> dict:
    """K3 and its backward against their plain versions on the card (1e-4,
    and a bf16 dx by :func:`hold_k3_backward`'s row rule), and the gradient
    of ``ssd_chunked`` through both kernels."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [((2, 16, 128, 64, 64, 64), bf16),      # zamba2 prefill, B 2
             ((1, 4, 128, 48, 64, 128), bf16),      # mamba2-780m, N 128
             ((2, 8, 64, 64, 64, 64), bf16),        # Q 64
             ((1, 2, 128, 4, 128, 128), bf16),      # hp = N = Q = 128
             ((1, 2, 128, 2, 128, 128), f32),       # the same, x split in parts
             # edges of the tensor-core tiles, and rows that are not a
             # multiple of 16 bytes (no TMA, no cp.async)
             ((1, 1, 33, 3, 12, 20), f32),
             ((1, 1, 33, 3, 12, 20), bf16),
             ((2, 1, 16, 16, 8, 4), bf16),
             # the forward's 64-row warpgroup tiles with a ragged Q, nh not a
             # multiple of its 16 heads a block, and rows of x, y and the
             # state that TMA cannot take (ordinary loads and stores)
             ((1, 2, 100, 5, 64, 64), bf16),
             ((1, 3, 128, 20, 64, 64), bf16),
             # K3's backward at nh past its 32 heads a block (two groups)
             ((1, 2, 128, 40, 64, 64), bf16),
             ((1, 2, 48, 6, 9, 7), bf16),
             ((1, 2, 48, 6, 9, 7), f32),
             ((0, 2, 32, 4, 8, 4), bf16)]           # B * nc = 0: nothing to launch
    errors, bwd_errors = {}, {}
    for shape, xdtype in cases:
        args = ssd_inputs(gen, *shape, xdtype=xdtype)
        grads = ssd_output_grads(gen, *shape)
        launched = (ssd.launches, ssd.bwd_launches)
        got = ssd.ssd_intra_chunk_cuda(*args)
        got_bwd = ssd.ssd_intra_chunk_bwd_cuda(*args, *grads)
        torch.cuda.synchronize()
        want_launched = (launched[0] + 1, launched[1] + 1) if shape[0] * shape[1] else launched
        if (ssd.launches, ssd.bwd_launches) != want_launched:
            raise AssertionError(f"K3 {shape}: launches {launched} -> "
                                 f"{(ssd.launches, ssd.bwd_launches)}")
        key = f"{shape} x {str(xdtype)[6:]}"
        if not shape[0] * shape[1]:
            want = ssd.ssd_intra_chunk_plain(*args) + ssd.ssd_intra_chunk_bwd_plain(*args, *grads)
            if [t.shape for t in got + got_bwd] != [t.shape for t in want]:
                raise AssertionError(f"K3 {key}: output shapes differ from the plain version's")
            continue
        errors[key] = hold_k3(got, args)
        bwd_errors[key] = hold_k3_backward(got_bwd, args, grads)
        again = ssd.ssd_intra_chunk_cuda(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K3 {key}: two runs differ")
        again = ssd.ssd_intra_chunk_bwd_cuda(*args, *grads)
        if not all(torch.equal(a, b) for a, b in zip(got_bwd, again)):
            raise AssertionError(f"K3 backward {key}: two runs differ")
    print(f"K3 vs plain on the card, max abs error (y, state, decay), two runs bit for bit: "
          f"{json.dumps(errors)}")
    print(f"K3 backward vs plain on the card: {json.dumps(bwd_errors)}")

    # a gradient of ssd_chunked (mixer_forward's call) with respect to any of
    # x, dt, A, Bm, Cm launches K3 once and its backward exactly once, and
    # equals the plain scan's (1e-3: K3's 1e-4 carried through the
    # inter-chunk recurrence); under no_grad K3 launches once, no backward
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    S_, nh, hp, N, chunk = 256, 4, 64, 64, 128
    inputs = {"x": randn(1, S_, nh, hp), "dt": torch.nn.functional.softplus(randn(1, S_, nh) - 2.0),
              "A": -torch.exp(0.5 * randn(nh)), "Bm": randn(1, S_, N), "Cm": randn(1, S_, N)}
    D = torch.ones(nh, device="cuda")
    wy, ws = randn(1, S_, nh, hp), randn(1, nh, hp, N)
    grad_errors = {}
    for name in inputs:
        args = dict(inputs)
        args[name] = args[name].clone().requires_grad_()
        before = (ssd.launches, ssd.bwd_launches)
        y, s = ssd.ssd_chunked(*args.values(), D, chunk)
        (got,) = torch.autograd.grad((y * wy).sum() + (s * ws).sum(), [args[name]])
        torch.cuda.synchronize()
        if (ssd.launches, ssd.bwd_launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"the gradient of ssd_chunked in {name} launched "
                                 f"{(ssd.launches - before[0], ssd.bwd_launches - before[1])}"
                                 f" (K3, its backward), expected (1, 1)")
        y, s = ssd.ssd_chunked_plain(*args.values(), D, chunk)
        (want,) = torch.autograd.grad((y * wy).sum() + (s * ws).sum(), [args[name]])
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, atol=1e-3 * scale, rtol=1e-3,
                                   msg=lambda m: f"ssd_chunked gradient in {name}: {m}")
        grad_errors[name] = max_err(got, want) / scale
        with torch.no_grad():
            got = ssd.ssd_chunked(*args.values(), D, chunk)
            torch.cuda.synchronize()
            want = ssd.ssd_chunked_plain(*args.values(), D, chunk)
        if (ssd.launches, ssd.bwd_launches) != (before[0] + 2, before[1] + 1):
            raise AssertionError(f"ssd_chunked under no_grad with {name} requiring a "
                                 f"gradient launched other than K3 once")
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)
    print(f"a gradient of ssd_chunked in x, dt, A, Bm or Cm launches K3 and its backward "
          f"once each and equals the plain scan's (max error over the largest "
          f"magnitude: {json.dumps(grad_errors)}); under no_grad K3 launches once")
    return {"forward": errors, "backward": bwd_errors, "ssd_chunked_grad": grad_errors}


def serve_run(cfg, params, batch, decode_steps, cache_len):
    """Prefill then greedy decode through the serving entry points; returns
    the logits of every step, the tokens fed and the cache. Decode starts
    after the prompt and any image prefix."""
    prefill = serve.make_prefill_step(cfg, cache_len=cache_len)
    decode = serve.make_decode_step(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    logits, cache = prefill(params, batch)
    out, fed = [logits], []
    for i in range(decode_steps):
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        fed.append(tok)
        pos = torch.full((B,), serve.prefix_len(cfg) + S + i, dtype=torch.int64,
                         device=tokens.device)
        logits, cache = decode(params, cache, tok, pos)
        out.append(logits)
    return out, fed, cache


def check_small_hybrid(seed) -> float:
    """The smoke zamba2 in float32, prefill plus decode, on the card against
    the CPU: logits at atol/rtol 1e-4 and equal greedy tokens."""
    cfg = dataclasses.replace(configs.smoke(SERVE_ARCH), param_dtype="float32",
                              compute_dtype="float32")
    fam = family(cfg)
    params = fam.init_params(cfg, torch.Generator("cpu").manual_seed(seed),
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab, (2, SMOKE_PROMPT)))
    runs = {}
    launched = (fa.launches, ssd.launches)
    for device in ("cpu", "cuda"):
        on = L.tree_map(lambda t: t.to(device), params)
        runs[device] = serve_run(cfg, on, {"tokens": tokens.to(device)}, SMOKE_DECODE,
                                 SMOKE_PROMPT + SMOKE_DECODE + 1)
    torch.cuda.synchronize()
    if (fa.launches, ssd.launches) == launched:
        raise AssertionError("the small hybrid slice launched no kernel on the card")
    err = 0.0
    for step, (g, w) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"step {step}: {m}")
        err = max(err, max_err(g.cpu(), w))
    for step, (g, w) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"greedy tokens differ at decode step {step}")
    for name, w in runs["cpu"][2].items():
        torch.testing.assert_close(runs["cuda"][2][name].cpu(), w, atol=1e-4, rtol=1e-4)
    print(f"smoke zamba2 (float32) prefill + {SMOKE_DECODE} decode steps: card "
          f"equals CPU, logits max abs error {err!r}, greedy tokens equal")
    return err


class RouteLog:
    """While active, records each call of ``moe.route`` by the device it ran
    on: the chosen experts and the router's probabilities, on the CPU."""

    def __init__(self):
        self.calls = {"cpu": [], "cuda": []}

    def __enter__(self):
        self._route = moe.route

        def recording(params, cfg, xf):
            top_p, top_e, probs = self._route(params, cfg, xf)
            self.calls[xf.device.type].append((top_e.cpu(), probs.detach().cpu()))
            return top_p, top_e, probs
        moe.route = recording
        return self

    def __exit__(self, *exc):
        moe.route = self._route

    def smallest_cpu_gap(self, top_k) -> float:
        """The smallest gap between a token's k-th and (k+1)-th probability
        over every call recorded on the CPU; raises unless it is at least
        NEAR_TIE, so that the card routes every token as the CPU does."""
        gaps = [float((ranked[:, top_k - 1] - ranked[:, top_k]).min())
                for ranked in (probs.sort(-1, descending=True).values
                               for _, probs in self.calls["cpu"])]
        if not gaps or min(gaps) < NEAR_TIE:
            raise AssertionError(f"the CPU's router came within {min(gaps, default=None)} "
                                 f"of a tie")
        return min(gaps)

    def same_choices(self, top_k) -> int:
        """Raise unless the card chose the CPU's expert sets for every token
        whose k-th and (k+1)-th probabilities lie at least NEAR_TIE apart;
        returns the count of near-tied tokens."""
        card, cpu = self.calls["cuda"], self.calls["cpu"]
        if len(card) != len(cpu) or not card:
            raise AssertionError(f"router calls: {len(card)} on the card, {len(cpu)} on the CPU")
        near = 0
        for (got, _), (want, probs) in zip(card, cpu):
            ranked = probs.sort(-1, descending=True).values
            clear = (ranked[:, top_k - 1] - ranked[:, top_k]) >= NEAR_TIE
            near += int((~clear).sum())
            if not torch.equal(got.sort(-1).values[clear], want.sort(-1).values[clear]):
                raise AssertionError("the card's router chose other experts than the CPU's")
        return near


def check_small_families(seed) -> dict:
    """The smoke granite-moe, qwen3-moe, seamless-m4t and internvl2 in
    float32, served on the card against the CPU: prefill plus SMOKE_DECODE
    greedy decode steps, logits and every cache tensor at atol/rtol 1e-4,
    equal greedy tokens; the MoE router's choice sets equal wherever no
    near-tie is reported; K2 launched on the card."""
    out = {}
    for arch in SMALL_FAMILIES:
        cfg = dataclasses.replace(configs.smoke(arch), param_dtype="float32",
                                  compute_dtype="float32")
        params = family(cfg).init_params(cfg, torch.Generator("cpu").manual_seed(seed),
                                         device="cpu")
        batch = serve.make_batch(cfg, torch.Generator("cpu").manual_seed(seed), 2,
                                 SMOKE_PROMPT)
        cache_len = serve.prefix_len(cfg) + SMOKE_PROMPT + SMOKE_DECODE + 1
        runs, launched = {}, fa.launches
        with RouteLog() as routes:
            for device in ("cpu", "cuda"):
                on = L.tree_map(lambda t: t.to(device), params)
                runs[device] = serve_run(cfg, on, {k: t.to(device) for k, t in batch.items()},
                                         SMOKE_DECODE, cache_len)
            torch.cuda.synchronize()
        if fa.launches == launched:
            raise AssertionError(f"the smoke {arch} launched no K2 on the card")
        err = 0.0
        for step, (g, w) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
            torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4,
                                       msg=lambda m: f"{arch} step {step}: {m}")
            err = max(err, max_err(g.cpu(), w))
        for step, (g, w) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"{arch}: greedy tokens differ at decode step {step}")
        err = max(err, assert_trees_close(runs["cuda"][2], runs["cpu"][2], f"{arch} cache"))
        out[arch] = {"max_abs_err": err, "k2_launches": fa.launches - launched}
        if cfg.family == "moe":
            out[arch]["near_tied_tokens"] = routes.same_choices(cfg.top_k)
    print(f"smoke moe, encdec and vlm families (float32), prefill + {SMOKE_DECODE} decode "
          f"steps: card equals CPU, greedy tokens and router choices equal: {json.dumps(out)}")
    return out


# kernel name fragments -> the kind of work profile_device sums them under
KERNEL_KINDS = (("k2_backward", ("attn_bwd_",)), ("k2", ("flash_attention_",)),
                ("k3_backward", ("ssd_bwd_",)),
                ("k3", ("ssd_intra_chunk",)), ("k1", ("quorum_commit",)),
                ("cublas", ("nvjet", "gemm", "gemv", "cutlass", "splitKreduce")))


def kernel_kind(name: str) -> str:
    for kind, fragments in KERNEL_KINDS:
        if any(f in name for f in fragments):
            return kind
    return "plain"     # PyTorch's own elementwise, reduction and copy kernels


def profile_device(fn, watch=()) -> dict:
    """Device busy and idle share and the top kernels over one call of fn;
    the device time by kind of kernel (the port's kernels, cuBLAS, and
    PyTorch's plain kernels); for each name in ``watch``, the device time
    and count of the kernels whose names hold it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    times = self_times_us(prof, on_device=True)
    busy_us = sum(times.values())
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    watched = {w: {"ms": sum(e.self_device_time_total for e in on_device if w in e.key) / 1e3,
                   "calls": sum(e.count for e in on_device if w in e.key)} for w in watch}
    by_kind: dict[str, float] = {}
    for name, us in times.items():
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + us / 1e3
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "watched": watched, "device_ms_by_kind": by_kind,
            "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
            "device_launches": sum(e.count for e in prof.key_averages()
                                   if e.device_type == torch.autograd.DeviceType.CUDA),
            "top_kernels_ms": top_ms(times, 10),
            "top_host_ms": top_ms(self_times_us(prof, on_device=False), 6)}


def launch_counts() -> dict:
    return {"quorum_commit": qc.launches, "flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches, "ssd_scan": ssd.launches,
            "ssd_scan_bwd": ssd.bwd_launches}


def reset_launch_counts() -> None:
    qc.launches = fa.launches = fa.bwd_launches = ssd.launches = ssd.bwd_launches = 0


def expected_serve_launches(cfg) -> tuple[dict, dict]:
    """The kernels' launches in a prefill of ``cfg`` and in one decode step:
    K2 once an attention of the prefill (the encoder's, the decoder's and
    the cross-attention of encdec), K3 once a Mamba layer; a decode step
    launches K2 once a cross-attention (encdec) and nothing else."""
    none = dict.fromkeys(launch_counts(), 0)
    prefill, step = dict(none), dict(none)
    if cfg.family == "hybrid":
        prefill.update(flash_attention=cfg.n_layers // cfg.shared_attn_every,
                       ssd_scan=cfg.n_layers)
    elif cfg.family == "ssm":
        prefill.update(ssd_scan=cfg.n_layers)
    elif cfg.family == "encdec":
        prefill.update(flash_attention=cfg.encoder_layers + 2 * cfg.n_layers)
        step.update(flash_attention=cfg.n_layers)
    else:                                   # dense, moe, vlm
        prefill.update(flash_attention=cfg.n_layers)
    return prefill, step


def serving_path(arch, seed, name) -> dict:
    """``arch`` at full width and depth: 8 x 2048-token prompts (with the
    family's stub frontend inputs: 512 frames a request for encdec, the image
    embeddings for vlm), then SERVE_DECODE greedy decode steps, through the
    serving entry points. The prefill and every decode step must launch the
    kernels :func:`expected_serve_launches` counts (zamba2: K3 38 and K2 6;
    qwen3: K2 28; granite-moe: K2 32; seamless: K2 36, and 12 a decode
    step)."""
    cfg = configs.get(arch)
    fam = family(cfg)
    prefix = serve.prefix_len(cfg)
    cache_len = prefix + SERVE_PROMPT + SERVE_DECODE
    t0 = time.perf_counter()
    params = fam.init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                             device="cuda")
    batch = serve.make_batch(cfg, torch.Generator("cuda").manual_seed(seed),
                             SERVE_BATCH, SERVE_PROMPT)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prefill = serve.make_prefill_step(cfg, cache_len=cache_len)
    decode = serve.make_decode_step(cfg)
    prefill(params, batch)                       # warm-up: cuBLAS plans, allocator
    torch.cuda.synchronize()

    want, per_step = expected_serve_launches(cfg)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    ttft_s = time.perf_counter() - t0
    prefill_launches = launch_counts()
    if prefill_launches != want:
        raise AssertionError(f"prefill launched {prefill_launches}, expected {want}")
    if logits.shape != (SERVE_BATCH, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
    step_s = []
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    for i in range(SERVE_DECODE):
        pos = torch.full((SERVE_BATCH,), prefix + SERVE_PROMPT + i, dtype=torch.int64,
                         device="cuda")
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok, pos)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"decode step {i}: logits not finite")
    after = launch_counts()
    want_after = {k: v + SERVE_DECODE * per_step[k] for k, v in prefill_launches.items()}
    if after != want_after:
        raise AssertionError(f"decode launched {after} after {prefill_launches}, expected "
                             f"{want_after}")
    if not all(torch.isfinite(t).all() for t in cache.values()):
        raise AssertionError("decode cache not finite")
    written = {"shared_k": cache_len} if cfg.family == "hybrid" else {"k": cache_len}
    if cfg.family == "encdec":
        written["mk"] = SERVE_PROMPT // cfg.enc_len_ratio
    for key, length in written.items():
        if cache[key].shape[2] != length or cache[key].abs().amax(dim=(1, 3, 4)).min() == 0:
            raise AssertionError(f"a position of the cache's {key!r} was never written")
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode_s = sum(step_s)
    summary = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "dtype": cfg.compute_dtype,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "decode_steps": SERVE_DECODE,
        "setup_s": setup_s, "ttft_s": ttft_s,
        "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / ttft_s,
        "decode_ms_per_step": 1e3 * decode_s / SERVE_DECODE,
        "decode_median_ms": 1e3 * float(np.median(step_s)),
        "decode_tokens_per_s": SERVE_BATCH * SERVE_DECODE / decode_s,
        "peak_mem_gib": peak, "launches": prefill_launches,
        "launches_per_decode_step": per_step, "cache_len": cache_len,
        "decode_launches": {k: after[k] - prefill_launches[k] for k in after},
        "profile": profile_device(lambda: prefill(params, batch),
                                  watch=("ssd_intra_chunk_kernel",
                                         "flash_attention_bf16_kernel")),
        "decode_profile": profile_device(lambda: decode(
            params, cache, tok, torch.full((SERVE_BATCH,), cache_len - 1,
                                           dtype=torch.int64, device="cuda")),
                                         watch=("flash_attention_",)),
    }
    if cfg.family == "moe":
        summary["capacity"] = {"prefill": moe.capacity(cfg, SERVE_BATCH * SERVE_PROMPT),
                               "decode": moe.capacity(cfg, SERVE_BATCH)}
    if cfg.family == "encdec":
        summary["frames"] = SERVE_PROMPT // cfg.enc_len_ratio
    print(f"serving {cfg.name}: {SERVE_BATCH} x {SERVE_PROMPT}-token prompts, "
          f"time to first token {ttft_s:.3f} s ({summary['prefill_tokens_per_s']:.0f} "
          f"tokens/s), decode {summary['decode_ms_per_step']:.2f} ms/step "
          f"({summary['decode_tokens_per_s']:.1f} tokens/s), peak {peak:.2f} GiB")
    print(json.dumps({name: summary}))
    return summary


# ---------------------------------------------------------------------------
# K2's backward and the dense paths (qwen3-1.7b)
# ---------------------------------------------------------------------------


def plain_grads(q, k, v, do, causal):
    """(dq, dk, dv): the autograd gradient of K2's plain version."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=causal)
    return torch.autograd.grad(out, leaves, do)


def plain_lse(q, k, causal):
    """Each row's float32 log-sum-exp of the scaled, masked logits, (B,H,S)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float().reshape(B, S, KV, H // KV, hd),
                          k.float()) * hd ** -0.5
    if causal:
        keep = torch.arange(S, device=q.device)[:, None] >= torch.arange(S, device=q.device)
        logits = torch.where(keep, logits, -1e30)
    return torch.logsumexp(logits, -1).reshape(B, H, S)


def grad_row_err(got, ref, scale) -> float:
    """:func:`row_err` for a gradient: a row's largest error over its own
    largest magnitude, or over 1e-3 of ``scale`` (the largest magnitude of
    dq, dk and dv) where that is larger; at S = 1 the softmax has one entry
    and dq and dk are exactly zero."""
    ref = ref.double()
    diff = (got.double() - ref).abs().amax(-1)
    return float((diff / ref.abs().amax(-1).clamp_min(scale * 1e-3)).max())


def hold_k2_backward(got, q, k, v, do, causal) -> dict:
    """K2's backward held against the plain version's autograd gradient on
    the same inputs. float32 at atol/rtol 1e-4, the forward's contract.
    bfloat16 by :func:`hold_bf16_rows` against the plain gradient run in
    float32 on the same bf16 inputs, with rows measured by
    :func:`grad_row_err` (the ulp floor holds at S = 1, where the plain
    version computes the zero dq and dk exactly). Returns the errors."""
    want = plain_grads(q, k, v, do, causal)
    errors = {}
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"K2 backward {name}: {g.dtype}{tuple(g.shape)} "
                                 f"vs {w.dtype}{tuple(w.shape)}, or not finite")
        errors[f"{name}_max_abs_err"] = max_err(g, w)
        if q.dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4,
                                       msg=lambda m: f"K2 backward {name}: {m}")
    if q.dtype == torch.bfloat16:
        ref = plain_grads(q.float(), k.float(), v.float(), do.float(), causal)
        scale = max(float(r.abs().max()) for r in ref)
        for g, w, r, name in zip(got, want, ref, ("dq", "dk", "dv")):
            hold_bf16_rows(errors, "K2 backward", name, g, w, r,
                           lambda a, b: grad_row_err(a, b, scale))
    return errors


def check_k2_backward_cases(gen, cases) -> dict:
    """K2's log-sum-exp and backward on each (shape, dtype, causal) of
    ``cases`` against the plain version (:func:`hold_k2_backward`); a
    non-causal case also twice, bit for bit. Returns the errors."""
    errors = {}
    for shape, dtype, causal in cases:
        q, k, v = attention_inputs(gen, *shape[:5], dtype, *shape[5:])
        do = attention_inputs(gen, *shape[:5], dtype, *shape[5:])[0]
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        if not torch.equal(out, fa.flash_attention_cuda(q, k, v, causal=causal)):
            raise AssertionError(f"K2 {shape}: the output moved with the lse buffer")
        lse_err = max_err(lse, plain_lse(q, k, causal))
        if lse_err > (1e-5 if dtype == torch.float32 else 4e-3):
            raise AssertionError(f"K2 {shape} {dtype}: lse error {lse_err}")
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal)
        torch.cuda.synchronize()
        errors[f"{shape} {str(dtype)[6:]} causal={causal}"] = {
            "lse_max_abs_err": lse_err, **hold_k2_backward(got, q, k, v, do, causal)}
        if not causal:
            again = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K2's backward at {shape} differs between two runs")
    return errors


def check_k2_backward(gen) -> dict:
    """K2's log-sum-exp and backward kernel against the plain version on the
    card, hd 192 included, and ``layers.attend`` differentiable through them."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(K2_TRAIN_SHAPE, bf16, True),                 # qwen3-1.7b training
             ((4, 2048, 32, 32, 64), bf16, True),          # zamba2-1.2b training
             ((1, 512, 16, 8, 128), f32, True)]
    cases += [((1, 256, 4, 2, hd), dt, True) for hd in (16, 32, 64, 128) for dt in (f32, bf16)]
    cases += [((2, 200, 4, 4, 64), dt, True) for dt in (f32, bf16)]     # ratio 1, ragged
    cases += [((1, 130, 8, 2, 32), dt, True) for dt in (f32, bf16)]     # GQA, ragged
    cases += [((2, 1, 2, 2, 128), dt, True) for dt in (f32, bf16)]      # one row
    cases += [((1, 384, 4, 2, 64), dt, False) for dt in (f32, bf16)]    # non-causal
    cases += [((2, 200, 6, 2, 16), dt, False) for dt in (f32, bf16)]    # ragged non-causal
    # hd 128: ragged causal and ragged non-causal
    cases += [((1, 130, 8, 2, 128), dt, True) for dt in (f32, bf16)]
    cases += [((2, 200, 4, 2, 128), dt, False) for dt in (f32, bf16)]
    # keys of their own length (B, S, H, KV, hd, Sk), non-causal: the seamless
    # training cross-attention, a ragged GQA pair, 1024 queries (the plain
    # version chunks them), one key, one query; and the seamless encoder's
    # self-attention. Each twice, bit for bit.
    own = [K2_CROSS_SHAPE, (2, 77, 6, 2, 64, 300), (1, 1024, 4, 2, 64, 512),
           (2, 40, 4, 2, 32, 1), (8, 1, 16, 16, 64, 512), (8, 512, 16, 16, 64)]
    cases += [(shape, dt, False) for shape in own for dt in (f32, bf16)]
    cases += k2_tile_edge_cases()
    errors = check_k2_backward_cases(gen, cases + K2_HD192_CASES)
    # causal with Sk != S raises before any launch
    q, k, v = attention_inputs(gen, 1, 16, 2, 2, 32, bf16, Sk=24)
    before = (fa.launches, fa.bwd_launches)
    try:
        fa.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(1, 2, 16, device="cuda"),
                                    causal=True)
        raise AssertionError("K2's backward took causal attention with Sk != S")
    except ValueError:
        pass
    if (fa.launches, fa.bwd_launches) != before:
        raise AssertionError("K2's backward launched where it raised")

    # layers.attend on the card: a graph through K2, nonzero projection grads
    cfg = configs.smoke(DENSE_ARCH)
    params = {name: t.requires_grad_() for name, t in
              L.init_attention(torch.Generator("cuda").manual_seed(1), cfg,
                               torch.bfloat16).items()}
    x = torch.randn(2, 96, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    before = fa.bwd_launches
    q, k, v = L._qkv(params, cfg, x, torch.arange(96, device="cuda").expand(2, 96))
    out = L.attend(q, k, v, causal=True)
    if out.grad_fn is None or "FlashAttention" not in type(out.grad_fn).__name__:
        raise AssertionError(f"layers.attend on the card: grad_fn {out.grad_fn}, not K2's")
    (out.reshape(2, 96, -1) @ params["wo"]).float().square().mean().backward()
    torch.cuda.synchronize()
    if fa.bwd_launches != before + 1:
        raise AssertionError("the backward of layers.attend did not launch K2's backward")
    for name in ("wq", "wk", "wv"):
        if params[name].grad is None or not params[name].grad.abs().max() > 0:
            raise AssertionError(f"no gradient reached {name} through K2")
    print(f"K2 backward vs plain on the card: {json.dumps(errors)}; keys of their own "
          f"length twice bit for bit, causal Sk != S raises; layers.attend "
          f"has grad_fn {type(out.grad_fn).__name__}, wq/wk/wv gradients nonzero")
    return errors


def assert_trees_close(got, want, what, atol=1e-4, rtol=1e-4) -> float:
    err = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(g.cpu(), w.cpu(), atol=atol, rtol=rtol,
                                   msg=lambda m: f"{what}: {m}")
        err = max(err, max_err(g.cpu(), w.cpu()))
    return err


def small_train_steps(cfg, params, seed, what):
    """SMALL_TRAIN_STEPS train steps of ``cfg`` from the CPU ``params`` on
    the CPU and on the card, each step's batch from ``launch.train.train_batch``
    (the stub frontend's inputs drawn on the CPU, so both devices get the
    same): loss, grad_norm and lr at 1e-4, the updated parameters and
    moments at atol/rtol 1e-4. Returns the card's (params, opt_state) and
    the errors."""
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=SMOKE_PROMPT, global_batch=4, seed=seed)
    trained = {}
    for device in ("cpu", "cuda"):
        p = L.tree_map(lambda t: t.to(device, copy=True), params)
        o = adamw.init(p, opt_cfg)
        step_fn = train.make_train_step(cfg, opt_cfg, total_steps=300)
        metrics = []
        for step in SMALL_TRAIN_STEPS:
            p, o, m = step_fn(p, o, train.train_batch(cfg, dcfg, step, device), step)
            metrics.append({k: float(v) for k, v in m.items()})
        trained[device] = (p, o, metrics)
    torch.cuda.synchronize()
    for got, want in zip(trained["cuda"][2], trained["cpu"][2]):
        for k in ("loss", "grad_norm", "lr"):
            if not math.isclose(got[k], want[k], rel_tol=1e-4, abs_tol=1e-4):
                raise AssertionError(f"{what} train step {k}: card {got[k]} CPU {want[k]}")
    (p, o, metrics), (cp, co, _) = trained["cuda"], trained["cpu"]
    return (p, o), {
        "train_metrics": metrics,
        "params_max_abs_err": assert_trees_close(p, cp, f"{what} train params"),
        "moments_max_abs_err": assert_trees_close({"m": o["m"], "v": o["v"]},
                                                  {"m": co["m"], "v": co["v"]},
                                                  f"{what} train moments")}


def check_small_dense(seed) -> dict:
    """The smoke qwen3-1.7b in float32 on the card against the CPU: prefill
    and decode logits at atol/rtol 1e-4 with equal greedy tokens; 2 train
    steps (2 microbatches, remat) with loss, grad_norm and the updated
    parameters at 1e-4; a checkpoint saved from the card restored equal, bit
    for bit."""
    cfg = dataclasses.replace(configs.smoke(DENSE_ARCH), param_dtype="float32",
                              compute_dtype="float32", microbatches=2, remat=True)
    fam = family(cfg)
    params = fam.init_params(cfg, torch.Generator("cpu").manual_seed(seed), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab, (2, SMOKE_PROMPT)))
    fwd, bwd = fa.launches, fa.bwd_launches
    runs = {}
    for device in ("cpu", "cuda"):
        on = L.tree_map(lambda t: t.to(device), params)
        runs[device] = serve_run(cfg, on, {"tokens": tokens.to(device)}, SMOKE_DECODE,
                                 SMOKE_PROMPT + SMOKE_DECODE + 1)
    torch.cuda.synchronize()
    if fa.launches - fwd != cfg.n_layers:
        raise AssertionError(f"the smoke dense prefill launched K2 {fa.launches - fwd} "
                             f"times, expected {cfg.n_layers}")
    out = {"logits_max_abs_err": 0.0}
    for step, (g, w) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"dense step {step}: {m}")
        out["logits_max_abs_err"] = max(out["logits_max_abs_err"], max_err(g.cpu(), w))
    for step, (g, w) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"dense greedy tokens differ at decode step {step}")

    (p, o), errors = small_train_steps(cfg, params, seed, "dense")
    if fa.bwd_launches - bwd != cfg.microbatches * len(SMALL_TRAIN_STEPS) * cfg.n_layers:
        raise AssertionError(f"the smoke train steps launched K2's backward "
                             f"{fa.bwd_launches - bwd} times")
    out.update(errors)

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        ckpt.save(d, SMALL_TRAIN_STEPS[-1] + 1, p, o)
        zeros = L.tree_map(torch.zeros_like, {"p": p, "o": o})
        rp, ro, step = ckpt.restore_latest(d, zeros["p"], zeros["o"])
    if step != SMALL_TRAIN_STEPS[-1] + 1:
        raise AssertionError(f"restored step {step}")
    for g, w in zip(tree_leaves({"p": rp, "o": ro}), tree_leaves({"p": p, "o": o})):
        if g.device != w.device or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError("a checkpoint saved on the card did not restore equal")
    print(f"smoke {DENSE_ARCH} (float32): prefill + {SMOKE_DECODE} decode steps, card "
          f"equals CPU (logits {out['logits_max_abs_err']!r}), greedy tokens equal; "
          f"{len(SMALL_TRAIN_STEPS)} train steps equal (params "
          f"{out['params_max_abs_err']!r}); checkpoint restored bit for bit")
    return out


def check_small_ssm_training(seed) -> dict:
    """The smoke zamba2 and mamba2 in float32 (2 microbatches, remat), held
    as :func:`small_train_steps` holds them, card against CPU; K3's
    backward must launch once a layer a microbatch on the card."""
    out = {}
    for arch in (HYBRID_ARCH, "mamba2-780m"):
        cfg = dataclasses.replace(configs.smoke(arch), param_dtype="float32",
                                  compute_dtype="float32", microbatches=2, remat=True)
        params = family(cfg).init_params(cfg, torch.Generator("cpu").manual_seed(seed),
                                         device="cpu")
        bwd = ssd.bwd_launches
        _, out[arch] = small_train_steps(cfg, params, seed, arch)
        want = cfg.n_layers * cfg.microbatches * len(SMALL_TRAIN_STEPS)
        if ssd.bwd_launches - bwd != want:
            raise AssertionError(f"the smoke {arch} train steps launched K3's backward "
                                 f"{ssd.bwd_launches - bwd} times, expected {want}")
        print(f"smoke {arch} (float32): {len(SMALL_TRAIN_STEPS)} train steps, card equals "
              f"CPU (params {out[arch]['params_max_abs_err']!r}), K3's backward "
              f"launched {want} times")
    return out


def check_small_family_training(seed) -> dict:
    """The smoke granite-moe, qwen3-moe, seamless-m4t and internvl2 in float32
    (2 microbatches, remat), held as :func:`small_train_steps` holds them,
    card against CPU, with the stub frontend's inputs; K2's backward must
    launch once an attention layer a microbatch on the card (seamless: its
    encoder's, its decoder's and its cross-attention). For the MoE configs
    every router call of the CPU run, in every layer, microbatch and step,
    must keep its tokens' k-th and (k+1)-th probabilities NEAR_TIE apart or
    more; the smallest gap is recorded. Parameters and data come from
    ``seed + SMALL_FAMILY_TRAIN_SEED``."""
    seed += SMALL_FAMILY_TRAIN_SEED
    out = {}
    for arch in SMALL_FAMILIES:
        cfg = dataclasses.replace(configs.smoke(arch), param_dtype="float32",
                                  compute_dtype="float32", microbatches=2, remat=True)
        params = family(cfg).init_params(cfg, torch.Generator("cpu").manual_seed(seed),
                                         device="cpu")
        bwd = fa.bwd_launches
        with RouteLog() as routes:
            _, out[arch] = small_train_steps(cfg, params, seed, arch)
        want = (expected_train_launches(cfg)["flash_attention_bwd"]
                * len(SMALL_TRAIN_STEPS))
        out[arch]["k2_backward_launches"] = fa.bwd_launches - bwd
        if fa.bwd_launches - bwd != want:
            raise AssertionError(f"the smoke {arch} train steps launched K2's backward "
                                 f"{fa.bwd_launches - bwd} times, expected {want}")
        if cfg.family == "moe":
            out[arch]["smallest_router_gap"] = routes.smallest_cpu_gap(cfg.top_k)
        print(f"smoke {arch} (float32): {len(SMALL_TRAIN_STEPS)} train steps, card equals "
              f"CPU (params {out[arch]['params_max_abs_err']!r}), K2's backward launched "
              f"{want} times; {json.dumps(out[arch])}")
    return out


def expected_train_launches(cfg) -> dict:
    """The kernels' launches in one train step of ``cfg``: each backward once
    a layer a microbatch, each forward twice under remat (the loss, then the
    recompute in the backward)."""
    M = cfg.microbatches
    forward = 2 if cfg.remat else 1
    if cfg.family == "hybrid":
        attn, ssm = cfg.n_layers // cfg.shared_attn_every, cfg.n_layers
    elif cfg.family == "encdec":      # the encoder's, the decoder's and the cross
        attn, ssm = cfg.encoder_layers + 2 * cfg.n_layers, 0
    else:
        attn, ssm = cfg.n_layers, 0
    return {"quorum_commit": 0, "flash_attention": forward * attn * M,
            "flash_attention_bwd": attn * M, "ssd_scan": forward * ssm * M,
            "ssd_scan_bwd": ssm * M}


def nvml_reader():
    """A function that reads the card's SM clock (MHz), power draw (W) and
    clock throttle reasons (NVML's bitmask) through NVML, or None where NVML
    cannot be loaded. Device 0: the script runs on one card."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    out = ctypes.POINTER
    for fn, args in (("nvmlInit_v2", []),
                     ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, out(ctypes.c_void_p)]),
                     ("nvmlDeviceGetClockInfo",
                      [ctypes.c_void_p, ctypes.c_int, out(ctypes.c_uint)]),
                     ("nvmlDeviceGetPowerUsage", [ctypes.c_void_p, out(ctypes.c_uint)]),
                     ("nvmlDeviceGetCurrentClocksThrottleReasons",
                      [ctypes.c_void_p, out(ctypes.c_ulonglong)])):
        getattr(nvml, fn).argtypes, getattr(nvml, fn).restype = args, ctypes.c_int
    handle = ctypes.c_void_p()
    if nvml.nvmlInit_v2() != 0 or nvml.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle)):
        return None

    def read():
        mhz, mw, reasons = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_ulonglong()
        nvml.nvmlDeviceGetClockInfo(handle, 1, ctypes.byref(mhz))       # NVML_CLOCK_SM
        nvml.nvmlDeviceGetPowerUsage(handle, ctypes.byref(mw))
        nvml.nvmlDeviceGetCurrentClocksThrottleReasons(handle, ctypes.byref(reasons))
        return mhz.value, mw.value / 1e3, reasons.value
    return read


class StepProbe:
    """What a timed step shares its wall time with: Python's garbage
    collections (time, and full collections), the caching allocator's
    cudaMalloc and cudaFree calls and its retries (a retry frees every
    cached block, which synchronises the card, and allocates again), the
    memory it holds, and the card's SM clock, power and throttle reasons,
    sampled through NVML every SAMPLE_S by a thread that ``__exit__`` stops."""
    SAMPLE_S = 0.02
    ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free")

    def __enter__(self):
        self.gc_s, self.gc_full, self._gc_t0 = 0.0, 0, None
        gc.callbacks.append(self._on_gc)
        self.samples, self._stop, self._read = [], threading.Event(), nvml_reader()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        if self._read is not None:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_full += info["generation"] == 2

    def _sample(self):
        while not self._stop.wait(self.SAMPLE_S):
            self.samples.append((time.perf_counter(), *self._read()))

    def _alloc(self):
        stats = torch.cuda.memory_stats()
        return {k: stats.get(k, 0) for k in self.ALLOC_KEYS}

    def begin(self):
        self._begin = (time.perf_counter(), self.gc_s, self.gc_full, self._alloc())

    def end(self) -> dict:
        t0, gc_s, gc_full, alloc = self._begin
        now = self._alloc()
        rec = {"gc_s": self.gc_s - gc_s, "gc_full": self.gc_full - gc_full,
               **{k: now[k] - alloc[k] for k in self.ALLOC_KEYS},
               "reserved_gib": torch.cuda.memory_reserved() / 2**30}
        within = [smp[1:] for smp in self.samples if smp[0] >= t0]
        if within:
            mhz = [m for m, _, _ in within]
            reasons = 0
            for _, _, r in within:
                reasons |= r
            rec.update(sm_mhz_min=min(mhz), sm_mhz_mean=float(np.mean(mhz)),
                       power_w_max=max(w for _, w, _ in within),
                       throttle_reasons=hex(reasons), samples=len(within))
        else:
            rec["sm_mhz_min"] = "not sampled"
        return rec


CLOCK_KEYS = ("sm_mhz_min", "sm_mhz_mean", "power_w_max", "throttle_reasons", "samples")


def clocked(measure) -> dict:
    """``measure()``'s readings, with the card's SM clock, power and throttle
    reasons sampled through NVML while it ran (``StepProbe``)."""
    with StepProbe() as probe:
        probe.begin()
        out = measure()
        seen = probe.end()
    return {**out, "sm_clock": {k: seen[k] for k in CLOCK_KEYS if k in seen}}


def model_flops(cfg, tokens) -> tuple[float, str]:
    """6 N D: the FLOP of a train step over ``tokens`` tokens, and how they
    were counted. A MoE token passes through its top-k experts only
    (``active_param_count``); the encoder of encdec and the cross K/V
    projections of its decoder run over the frames, S / enc_len_ratio a
    sequence, and the rest over the tokens."""
    if cfg.family == "moe":
        return 6 * cfg.active_param_count() * tokens, "6 * active_param_count * tokens"
    if cfg.family == "encdec":
        encoder = cfg.param_count() - dataclasses.replace(cfg, encoder_layers=0).param_count()
        on_frames = encoder + cfg.n_layers * 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
        frames = tokens // cfg.enc_len_ratio
        return (6 * ((cfg.param_count() - on_frames) * tokens + on_frames * frames),
                "6 * (decoder params * tokens + (encoder + cross K/V params) * frames)")
    return 6 * cfg.param_count() * tokens, "6 * param_count * tokens"


def training_path(arch, name, seed, n_steps=TRAIN_STEPS, cut=None) -> dict:
    """``arch`` at full width and depth: ``n_steps`` steps of TRAIN_BATCH x
    TRAIN_SEQ tokens from the port's data pipeline (``launch.train.train_batch``,
    with the stub frontend's inputs: 512 frames a sequence for encdec),
    through ``launch.train.make_train_step`` (the configuration's
    microbatches, remat, bf16 parameters, float32 moments), each with what
    :class:`StepProbe` sees in it, then one profiled step. Each step must
    launch the kernels :func:`expected_train_launches` counts. The step time
    is given as the mean and the median of the steps after the first; steps
    25% above that median are listed as slow. ``cut`` replaces fields of the
    configuration where the path does not fit the card as configured."""
    cfg = dataclasses.replace(configs.get(arch), **(cut or {}))
    fam = family(cfg)
    t0 = time.perf_counter()
    params = fam.init_params(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda")
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    opt_state = adamw.init(params, opt_cfg)
    step_fn = train.make_train_step(cfg, opt_cfg, total_steps=TRAIN_TOTAL_STEPS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_step = expected_train_launches(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, flops_counted_as = model_flops(cfg, tokens)

    steps = []
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with StepProbe() as probe:
        for step in range(n_steps):
            batch = train.train_batch(cfg, dcfg, step, "cuda")
            before = launch_counts()
            probe.begin()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch, step)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            seen = probe.end()
            launched = {k: v - before[k] for k, v in launch_counts().items()}
            rec = {"step": step, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "lr": float(m["lr"]), "step_s": took, "launches": launched, **seen}
            steps.append(rec)
            print(f"{cfg.name} train step {step}: loss {rec['loss']:.4f} grad_norm "
                  f"{rec['grad_norm']:.4f} {took:.3f} s; {json.dumps(seen)}")
            if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
                raise AssertionError(f"train step {step}: loss or grad_norm not finite: {rec}")
            if launched != per_step:
                raise AssertionError(f"{cfg.name} train step {step} launched {launched}, "
                                     f"expected {per_step}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = launch_counts()
    if cfg.family == "hybrid" and not peak <= HYBRID_TRAIN_PEAK_GIB:
        raise AssertionError(f"{cfg.name} training peaked at {peak:.2f} GiB, above "
                             f"{HYBRID_TRAIN_PEAK_GIB}")
    ln_vocab = math.log(cfg.vocab)
    if abs(steps[0]["loss"] - ln_vocab) > 0.5:
        raise AssertionError(f"first loss {steps[0]['loss']} is not within 0.5 of "
                             f"ln {cfg.vocab} = {ln_vocab}")
    if not all(torch.isfinite(t).all() for t in tree_leaves(params)):
        raise AssertionError("trained parameters not finite")
    steady = [s["step_s"] for s in steps[1:]]
    step_s, median_s = float(np.mean(steady)), float(np.median(steady))
    slow = [s for s in steps[1:] if s["step_s"] > 1.25 * median_s]

    batch = train.train_batch(cfg, dcfg, n_steps, "cuda")
    profile = profile_device(lambda: step_fn(params, opt_state, batch, n_steps),
                             watch=("flash_attention_bf16_kernel", "attn_bwd_dkdv_bf16_kernel",
                                    "attn_bwd_dq_bf16_kernel", "ssd_intra_chunk_kernel",
                                    "ssd_bwd_heads_kernel", "ssd_bwd_bc_kernel"))
    summary = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "param_dtype": cfg.param_dtype, "cut": cut or {},
        "moment_dtype": cfg.opt_state_dtype, "microbatches": cfg.microbatches,
        "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "tokens_per_step": tokens, "setup_s": setup_s, "steps": steps,
        "step_s_mean_after_first": step_s, "step_s_median_after_first": median_s,
        "slow_steps": [s["step"] for s in slow],
        "gc_s_after_first": sum(s["gc_s"] for s in steps[1:]), "tokens_per_s": tokens / step_s,
        "tokens_per_s_at_median": tokens / median_s,
        "first_step_s": steps[0]["step_s"], "ln_vocab": ln_vocab,
        "peak_mem_gib": peak, "launches": launches, "launches_per_step": per_step,
        "model_flops_per_step": flops, "model_flops_counted_as": flops_counted_as,
        "bf16_peak_flops": BF16_OPS_PER_S,
        "bf16_peak_source": "NVIDIA H100 SXM data sheet, dense bf16 tensor cores",
        "model_flops_share_of_peak": flops / step_s / BF16_OPS_PER_S,
        "profile": profile,
    }
    if cfg.family == "moe":
        summary["capacity"] = moe.capacity(cfg, tokens // cfg.microbatches)
        summary["active_params"] = cfg.active_param_count()
    if cfg.family == "encdec":
        summary["frames"] = TRAIN_SEQ // cfg.enc_len_ratio
    print(f"training {cfg.name}: {n_steps} steps x {tokens} tokens, "
          f"{step_s:.3f} s/step after the first, median {median_s:.3f}, slow steps "
          f"{summary['slow_steps']} ({tokens / step_s:.0f} tokens/s, "
          f"{summary['model_flops_share_of_peak']:.3f} of the bf16 peak at {flops:.4g} FLOP "
          f"a step, {flops_counted_as}), first loss {steps[0]['loss']:.4f} "
          f"(ln V {ln_vocab:.4f}), peak {peak:.2f} GiB")
    print(json.dumps({name: summary}))
    return summary


# ---------------------------------------------------------------------------
# sharded training and serving on a 1x1 mesh (NCCL, world size 1)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def one_rank_mesh():
    """A 1x1 ("data", "model") DeviceMesh over NCCL, world size 1, on a free
    localhost port; the process group is destroyed on the way out."""
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield make_mesh_for(1)
    finally:
        dist.destroy_process_group()


def tree_distance(got, want) -> dict:
    """Held at SHARDED_TOL leaf by leaf (``got``'s DTensors by their local
    shards, which on one rank are whole); the largest distance, and whether
    every leaf is equal bit for bit."""
    got = [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(got)]
    want = tree_leaves(want)
    err = max(max_err(g, w) for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=SHARDED_TOL, rtol=SHARDED_TOL)
    return {"max_abs_err": err, "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want))}


def sharded_training_path(arch, name, seed, unsharded) -> dict:
    """``arch`` at full width and depth trained SHARDED_TRAIN_STEPS steps
    (one warm-up, then timed) on a 1x1 mesh through
    ``make_train_step(..., rules=make_rules(mesh))``, parameters and
    batches laid out by ``launch.train.distribute_tree``: the losses equal
    the unsharded ``training_path``'s (``unsharded``, the same seed and
    batches) and the parameters an unsharded run's of the same steps, at
    SHARDED_TOL; every step launches K2 and its backward on local shards as
    many times as unsharded. Step time, peak memory, idle share and launches
    beside the unsharded path's."""
    cfg = configs.get(arch)
    fam = family(cfg)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed)
    batches = [train.train_batch(cfg, dcfg, step, "cuda")
               for step in range(SHARDED_TRAIN_STEPS + 1)]
    draw = lambda: fam.init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                                   device="cuda")
    want = draw()
    opt_state = adamw.init(want, opt_cfg)
    step_fn = train.make_train_step(cfg, opt_cfg, total_steps=TRAIN_TOTAL_STEPS)
    want_losses = []
    for step in range(SHARDED_TRAIN_STEPS):
        want, opt_state, m = step_fn(want, opt_state, batches[step], step)
        want_losses.append(float(m["loss"]))
    del opt_state, m
    gc.collect()
    torch.cuda.empty_cache()

    per_step = expected_train_launches(cfg)
    with one_rank_mesh() as mesh:
        rules = make_rules(mesh)
        t0 = time.perf_counter()
        params = train.distribute_tree(draw(), mesh, fam.param_specs(cfg, rules), rules)
        opt_state = adamw.init(params, opt_cfg)
        step_fn = train.make_train_step(cfg, opt_cfg, rules=rules,
                                        total_steps=TRAIN_TOTAL_STEPS)
        on_mesh = [train.distribute_tree(b, mesh, train.batch_spec_tree(b), rules)
                   for b in batches]
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        steps = []
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        for step in range(SHARDED_TRAIN_STEPS):
            before = launch_counts()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, on_mesh[step], step)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            launched = {k: v - before[k] for k, v in launch_counts().items()}
            steps.append({"step": step, "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]), "step_s": took,
                          "launches": launched})
            print(f"{cfg.name} sharded train step {step}: loss {steps[-1]['loss']:.4f} "
                  f"{took:.3f} s; launches {launched}")
            if launched != per_step:
                raise AssertionError(f"{cfg.name} sharded train step {step} launched "
                                     f"{launched}, expected {per_step}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = launch_counts()
        losses = [s["loss"] for s in steps]
        for got, ref, what in ((losses, want_losses, "an unsharded run of the same steps"),
                               (losses, [s["loss"] for s in unsharded["steps"][:len(losses)]],
                                "the unsharded training_path")):
            torch.testing.assert_close(torch.tensor(got), torch.tensor(ref), atol=SHARDED_TOL,
                                       rtol=SHARDED_TOL, msg=lambda m: f"losses against {what}: {m}")
        params_match = tree_distance(params, want)
        del want
        gc.collect()
        profile = profile_device(
            lambda: step_fn(params, opt_state, on_mesh[SHARDED_TRAIN_STEPS], SHARDED_TRAIN_STEPS),
            watch=("flash_attention_bf16_kernel", "attn_bwd_dkdv_bf16_kernel",
                   "attn_bwd_dq_bf16_kernel", "nccl"))
        placements = sorted({str(t.placements) for t in tree_leaves(params)})
    timed = [s["step_s"] for s in steps[1:]]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    summary = {
        "arch": cfg.name, "mesh": [1, 1], "backend": "nccl", "world_size": 1,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "microbatches": cfg.microbatches,
        "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "setup_s": setup_s,
        "steps": steps, "step_s_median_timed": float(np.median(timed)),
        "tokens_per_s": tokens / float(np.median(timed)),
        "peak_mem_gib": peak, "launches": launches, "launches_per_step": per_step,
        "losses": losses, "unsharded_losses": want_losses, "params": params_match,
        "param_placements": placements, "profile": profile,
        "unsharded": {"step_s_median_after_first": unsharded["step_s_median_after_first"],
                      "peak_mem_gib": unsharded["peak_mem_gib"],
                      "device_idle_share": unsharded["profile"]["device_idle_share"],
                      "device_launches": unsharded["profile"]["device_launches"],
                      "launches_per_step": unsharded["launches_per_step"]},
    }
    print(f"sharded training {cfg.name} (1x1 mesh, NCCL): "
          f"{summary['step_s_median_timed']:.3f} s/step against "
          f"{unsharded['step_s_median_after_first']:.3f} unsharded; peak {peak:.2f} GiB "
          f"against {unsharded['peak_mem_gib']:.2f}; idle {profile['device_idle_share']:.3f} "
          f"against {unsharded['profile']['device_idle_share']:.3f}; parameters "
          f"{'bit-equal' if params_match['bit_equal'] else 'within 1e-4'} "
          f"(max {params_match['max_abs_err']:.3g})")
    print(json.dumps({name: summary}))
    return summary


def sharded_serving_path(arch, name, seed, unsharded) -> dict:
    """``arch`` at full width and depth served on a 1x1 mesh through the
    serving entry points with ``rules``: SERVE_BATCH x SERVE_PROMPT-token
    prompts, then SHARDED_DECODE greedy decode steps, against the same
    unsharded (the same parameters and prompts): every step's logits at
    SHARDED_TOL and the greedy tokens equal. The prefill launches K3 and K2
    on local shards as many times as unsharded, a decode step neither. TTFT
    and decode ms a step beside the unsharded ``serving_path``'s."""
    cfg = configs.get(arch)
    fam = family(cfg)
    prefix = serve.prefix_len(cfg)
    cache_len = prefix + SERVE_PROMPT + SHARDED_DECODE
    params = fam.init_params(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda")
    batch = serve.make_batch(cfg, torch.Generator("cuda").manual_seed(seed),
                             SERVE_BATCH, SERVE_PROMPT)
    want_prefill, want_step = expected_serve_launches(cfg)

    def run(params, batch, rules):
        prefill = serve.make_prefill_step(cfg, cache_len=cache_len, rules=rules)
        decode = serve.make_decode_step(cfg, rules=rules)
        whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
        with torch.no_grad():
            prefill(params, batch)               # warm-up: cuBLAS plans, allocator
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch)
            torch.cuda.synchronize()
            ttft = time.perf_counter() - t0
            launched = launch_counts()
            seen, tokens, step_s = [whole(logits)], [], []
            for i in range(SHARDED_DECODE):
                tok = torch.argmax(seen[-1][:, -1], -1)[:, None]
                tokens.append(tok)
                pos = torch.full((SERVE_BATCH,), prefix + SERVE_PROMPT + i,
                                 dtype=torch.int64, device="cuda")
                t0 = time.perf_counter()
                logits, cache = decode(params, cache, tok, pos)
                logits = whole(logits)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                seen.append(logits)
            decoded = {k: v - launched[k] for k, v in launch_counts().items()}
            profile = profile_device(lambda: prefill(params, batch),
                                     watch=("ssd_intra_chunk_kernel",
                                            "flash_attention_bf16_kernel", "nccl"))
        return {"ttft_s": ttft, "step_s": step_s, "logits": seen,
                "tokens": torch.cat(tokens, 1), "prefill_launches": launched,
                "decode_launches": decoded, "profile": profile}

    ref = run(params, batch, None)
    with one_rank_mesh() as mesh:
        rules = make_rules(mesh)
        sp = train.distribute_tree(params, mesh, fam.param_specs(cfg, rules), rules)
        sb = train.distribute_tree(batch, mesh, train.batch_spec_tree(batch), rules)
        torch.cuda.reset_peak_memory_stats()
        got = run(sp, sb, rules)
        peak = torch.cuda.max_memory_allocated() / 2**30
    none = dict.fromkeys(want_step, 0)
    for what, launched, expected in (("prefill", got["prefill_launches"], want_prefill),
                                     ("decode", got["decode_launches"], none)):
        if launched != expected:
            raise AssertionError(f"sharded {what} launched {launched}, expected {expected}")
    errs = []
    for i, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
        torch.testing.assert_close(g, w, atol=SHARDED_TOL, rtol=SHARDED_TOL,
                                   msg=lambda m: f"sharded logits, step {i}: {m}")
        errs.append(max_err(g, w))
    if not torch.equal(got["tokens"], ref["tokens"]):
        raise AssertionError("sharded greedy tokens differ from the unsharded ones")
    bit_equal = all(torch.equal(g, w) for g, w in zip(got["logits"], ref["logits"]))
    summary = {
        "arch": cfg.name, "mesh": [1, 1], "backend": "nccl", "world_size": 1,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "decode_steps": SHARDED_DECODE,
        "cache_len": cache_len, "ttft_s": got["ttft_s"],
        "decode_ms_per_step": 1e3 * float(np.mean(got["step_s"])),
        "decode_median_ms": 1e3 * float(np.median(got["step_s"])),
        "peak_mem_gib": peak, "launches": got["prefill_launches"],
        "decode_launches": got["decode_launches"], "logits_max_abs_err": max(errs),
        "logits_bit_equal": bit_equal, "tokens_equal": True, "profile": got["profile"],
        "unsharded_in_phase": {"ttft_s": ref["ttft_s"],
                               "decode_ms_per_step": 1e3 * float(np.mean(ref["step_s"])),
                               "profile": ref["profile"]},
        "unsharded": {"ttft_s": unsharded["ttft_s"],
                      "decode_ms_per_step": unsharded["decode_ms_per_step"],
                      "device_idle_share": unsharded["profile"]["device_idle_share"]},
    }
    print(f"sharded serving {cfg.name} (1x1 mesh, NCCL): TTFT {got['ttft_s']:.3f} s "
          f"against {unsharded['ttft_s']:.3f} unsharded; decode "
          f"{summary['decode_ms_per_step']:.2f} ms/step against "
          f"{unsharded['decode_ms_per_step']:.2f}; logits "
          f"{'bit-equal' if bit_equal else 'within 1e-4'} (max {max(errs):.3g})")
    print(json.dumps({name: summary}))
    return summary


# ---------------------------------------------------------------------------
# the dry-run (launch.dryrun) on the card
# ---------------------------------------------------------------------------

def traced_launches(calls) -> dict:
    """The kernel ops' ``calls`` in a trace, by the names of the launch
    counts."""
    out = dict.fromkeys(launch_counts(), 0)
    out.update({KERNEL_OPS[k]: v for k, v in calls.items()})
    return out


def dryrun_training_cell(arch, seed, path) -> dict:
    """``arch``'s training cell (TRAIN_BATCH x TRAIN_SEQ tokens, the
    configuration's microbatches, remat) traced unsharded on fake CUDA
    tensors (``launch.dryrun.trace_step``), against one real step of the
    same cell on the card: the traced kernel-op calls equal the launches
    ``expected_train_launches`` counts (and the real step's), the traced
    FLOP equal ``FlopCounterMode``'s count of the real step exactly, and the
    traced argument bytes equal the real parameters', moments' and batch's.
    The roofline's terms beside the training path's (``path``) median step,
    and the peak estimate beside the real step's ``max_memory_allocated``,
    with their ratios (neither held)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = configs.get(arch)
    fam = family(cfg)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed)
    batch = train.train_batch(cfg, dcfg, 0, "cuda")
    inputs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    costs, memory, trace_s = dryrun.trace_step(cfg, "train", inputs, device="cuda")
    traced = traced_launches(costs.calls)

    params = fam.init_params(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda")
    opt_state = adamw.init(params, opt_cfg)
    step_fn = train.make_train_step(cfg, opt_cfg, total_steps=TRAIN_TOTAL_STEPS)
    real_argument = sum(t.numel() * t.element_size()
                        for t in tree_leaves(params) + tree_leaves(opt_state)
                        + list(batch.values()))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with FlopCounterMode(display=False) as counter:
        step_fn(params, opt_state, batch, 0)
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated()
    real = launch_counts()
    real_flops = counter.get_total_flops()
    del params, opt_state
    want = expected_train_launches(cfg)
    for what, got in (("traced kernel-op calls", traced), ("real launches", real)):
        if got != want:
            raise AssertionError(f"dry-run {cfg.name}: {what} {got}, expected {want}")
    if costs.flops != real_flops:
        raise AssertionError(f"dry-run {cfg.name}: traced FLOP {costs.flops!r}, "
                             f"FlopCounterMode on a real step {real_flops!r}")
    if memory["argument_bytes_per_device"] != real_argument:
        raise AssertionError(f"dry-run {cfg.name}: traced argument bytes "
                             f"{memory['argument_bytes_per_device']}, real {real_argument}")
    rf = roofline.analyze(costs, chips=1,
                          model_flops=model_flops(cfg, TRAIN_BATCH * TRAIN_SEQ)[0])
    bound = max(rf.t_compute, rf.t_memory, rf.t_collective)
    median = path["step_s_median_after_first"]
    rec = {"arch": cfg.name, "trace_s": trace_s, "kernel_calls": traced,
           "flops": costs.flops, "flop_counter_flops": real_flops,
           "argument_bytes": memory["argument_bytes_per_device"],
           "real_argument_bytes": real_argument, "memory": memory,
           "roofline": rf.to_dict(), "step_s_median": median,
           "bytes_by_op_top": dict(sorted(costs.by_kind.items(), key=lambda kv: -kv[1])[:10]),
           "roofline_bound_s_over_median_step": bound / median,
           "peak_estimate_gib": memory["peak_estimate_per_device"] / 2**30,
           "max_memory_allocated_gib": real_peak / 2**30,
           "peak_estimate_over_max_allocated": memory["peak_estimate_per_device"] / real_peak}
    print(f"dry-run {cfg.name} (unsharded, fake CUDA tensors, {trace_s:.1f} s): kernel-op "
          f"calls {traced} equal the launches; {costs.flops:.6g} FLOP equal FlopCounterMode's "
          f"on a real step; argument bytes {real_argument} equal; t_compute "
          f"{rf.t_compute:.4f} s, t_memory {rf.t_memory:.4f} s, bottleneck {rf.bottleneck}, "
          f"against the training path's median step {median:.3f} s (ratio "
          f"{bound / median:.3f}); peak estimate {rec['peak_estimate_gib']:.2f} GiB against "
          f"max_memory_allocated {rec['max_memory_allocated_gib']:.2f} GiB")
    return rec


def dryrun_path(seed, training, hybrid_training) -> dict:
    """The dry-run on the card. qwen3-1.7b's and zamba2-1.2b's training
    cells traced unsharded on fake CUDA tensors (:func:`dryrun_training_cell`),
    then ``launch.dryrun.lower_cell`` on the fake (16, 16) CUDA mesh for each
    of DRYRUN_CELLS: each ends OK, its kernel-op calls on local shards
    (``local_map``) as many as the cell's configuration launches unsharded,
    and its record printed."""
    t0 = time.perf_counter()
    out = {"unsharded": [dryrun_training_cell(DENSE_ARCH, seed, training),
                         dryrun_training_cell(HYBRID_ARCH, seed, hybrid_training)]}
    gc.collect()
    torch.cuda.empty_cache()
    out["production_mesh"] = []
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.lower_cell(arch, shape, False)
        if rec["status"] != "OK":
            raise AssertionError(f"dry-run {arch} {shape}: {rec}")
        cfg = configs.get(arch)
        kind = dryrun.SHAPES[shape]["kind"]
        want = (expected_train_launches(cfg) if kind == "train"
                else expected_serve_launches(cfg)[0])
        got = traced_launches(rec["kernel_calls"])
        if got != want:
            raise AssertionError(f"dry-run {arch} {shape} on the 16x16 mesh: kernel-op calls "
                                 f"{got}, expected {want}")
        print(json.dumps({"dryrun_record": rec}))
        out["production_mesh"].append(rec)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"dryrun_path": out}))
    return out


def time_k2(gen, shape=(SERVE_BATCH, SERVE_PROMPT, 32, 32, 64)) -> dict:
    """K2 at ``shape`` (B, S, H, KV, hd), causal, bf16, by default the
    serving prefill's: kernel, plain and SDPA times."""
    B, S, H, KV, hd = shape
    q, k, v = attention_inputs(gen, B, S, H, KV, hd, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, hd) views

    def kernel(i):
        return fa.flash_attention_cuda(q, k, v, causal=True)

    def plain(i):
        return fa.flash_attention_plain(q, k, v, causal=True)

    def library(i):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    got = kernel(0)
    torch.cuda.synchronize()
    errors = hold_k2(got, q, k, v, True)          # held at the main path's shape
    print(f"K2 vs plain at {[B, S, H, KV, hd]} bf16: {json.dumps(errors)}")
    lib_err = max_err(got, library(0).transpose(1, 2))
    ops_ = 4 * B * H * hd * S * (S + 1) / 2          # q k^T and p v, causal half
    moved = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    return timing("flash_attention", list(shape), kernel, plain, library,
                  ops_ / BF16_OPS_PER_S, moved / HBM_BYTES_PER_S,
                  **errors, library_max_abs_err=lib_err)


def time_k2_cross(gen) -> dict:
    """K2 at the seamless prefill's cross-attention (2048 queries against 512
    keys, non-causal): kernel, plain and SDPA times."""
    B, S, H, KV, hd, Sk = K2_CROSS_SHAPE
    q, k, v = attention_inputs(gen, B, S, H, KV, hd, torch.bfloat16, Sk=Sk)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, hd) views

    def kernel(i):
        return fa.flash_attention_cuda(q, k, v, causal=False)

    def plain(i):
        return fa.flash_attention_plain(q, k, v, causal=False)

    def library(i):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=False, enable_gqa=True)

    got = kernel(0)
    torch.cuda.synchronize()
    errors = hold_k2(got, q, k, v, False)         # held at the path's shape
    print(f"K2 vs plain at {list(K2_CROSS_SHAPE)} bf16: {json.dumps(errors)}")
    lib_err = max_err(got, library(0).transpose(1, 2))
    ops_ = 4 * B * H * hd * S * Sk                   # q k^T and p v, no mask
    moved = 2 * (2 * B * S * H * hd + 2 * B * Sk * KV * hd)
    return timing("flash_attention", list(K2_CROSS_SHAPE), kernel, plain, library,
                  ops_ / BF16_OPS_PER_S, moved / HBM_BYTES_PER_S,
                  **errors, library_max_abs_err=lib_err)


def time_k3(gen, shape=None) -> dict:
    """K3 at ``shape`` (B, nc, Q, nh, hp, N), x bf16, by default the serving
    prefill's: kernel and plain times."""
    B, nc, Q_, nh, hp, N = shape or (SERVE_BATCH, SERVE_PROMPT // 128, 128, 64, 64, 64)
    args = ssd_inputs(gen, B, nc, Q_, nh, hp, N)

    def kernel(i):
        return ssd.ssd_intra_chunk_cuda(*args)

    def plain(i):
        return ssd.ssd_intra_chunk_plain(*args)

    got = kernel(0)
    torch.cuda.synchronize()
    errs = hold_k3(got, args)                     # held at the path's shape
    print(f"K3 vs plain at {[B, nc, Q_, nh, hp, N]}: {json.dumps(errs)}")
    tri = Q_ * (Q_ + 1) / 2
    cb_ops = B * nc * 2 * N * tri                       # C B^T, lower triangle
    y_ops = B * nc * nh * 2 * hp * tri                  # M x, lower triangle
    state_ops = B * nc * nh * 2 * Q_ * hp * N           # (w B)^T x
    # as issued: bf16 tensor-core products, 6 for each float32 product of
    # C B^T (both sides split in three parts), 3 for M x and the state (the
    # float32 side split, x bf16)
    issued_s = (6 * cb_ops + 3 * y_ops + 3 * state_ops) / BF16_OPS_PER_S
    f32_s = (cb_ops + y_ops + state_ops) / FP32_OPS_PER_S   # PR 12's CUDA-core figure
    moved = (B * nc * Q_ * nh * hp * (2 + 4) + 2 * B * nc * Q_ * nh * 4
             + 2 * B * nc * Q_ * N * 4 + B * nc * nh * hp * N * 4 + B * nc * nh * 4)
    return timing("ssd_scan", [B, nc, Q_, nh, hp, N], kernel, plain, None,
                  issued_s, moved / HBM_BYTES_PER_S, max_abs_err=max(errs),
                  operations_fp32_cuda_cores_ms=1e3 * f32_s)


def time_k3_backward(gen) -> dict:
    """K3's backward at one zamba2-1.2b training microbatch's shape: kernel
    and the closed-form plain version's times. No single PyTorch call
    computes it."""
    B, nc, Q_, nh, hp, N = K3_TRAIN_SHAPE
    args = ssd_inputs(gen, *K3_TRAIN_SHAPE)
    grads = ssd_output_grads(gen, *K3_TRAIN_SHAPE)

    def kernel(i):
        return ssd.ssd_intra_chunk_bwd_cuda(*args, *grads)

    def plain(i):
        return ssd.ssd_intra_chunk_bwd_plain(*args, *grads)

    got = kernel(0)
    torch.cuda.synchronize()
    errors = hold_k3_backward(got, args, grads)     # held at the training shape
    print(f"K3 backward vs plain at {list(K3_TRAIN_SHAPE)} x bf16: {json.dumps(errors)}")
    tri = Q_ * (Q_ + 1) / 2
    # per head the lower triangles of dy x^T and M^T dy, x dS and B dS^T;
    # per chunk the lower triangle of C B^T, and dC and dB. dy x^T and C B^T
    # at the float64 tensor cores' rate, as the kernel forms them (float32
    # products leave ddt and dseg about 1e-4 from the exact value: see
    # hold_k3_backward). The rest split as the kernel issues them, over the
    # entries the function needs: bf16 wgmma products, six for each of
    # B dS^T's and M^T dy's (both sides split in three parts), three for
    # x dS's (the bf16 x exact); M^T dy over the lower triangle (the kernel's
    # whole 64-row tiles issue more, 12,288 entries for 8,256 at Q 128);
    # dC and dB by float32 FMAs.
    f64_ops = B * nc * (nh * 2 * hp * tri + 2 * N * tri)        # dy x^T, C B^T
    bf16_ops = B * nc * nh * (6 * 2 * hp * tri                  # M^T dy
                              + 6 * 2 * Q_ * N * hp             # B dS^T
                              + 3 * 2 * Q_ * hp * N)            # x dS
    fma_ops = B * nc * 2 * 2 * N * tri                          # dC, dB
    ops_s = (f64_ops / FP64_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
             + fma_ops / FP32_OPS_PER_S)
    # x and dx in bf16; dy, dS, dt, seg, B, C, ddecay read and ddt, dseg, dB,
    # dC written in float32
    moved = (B * nc * Q_ * nh * hp * (2 + 4 + 2) + B * nc * nh * hp * N * 4
             + 4 * B * nc * Q_ * nh * 4 + 4 * B * nc * Q_ * N * 4 + B * nc * nh * 4)
    return timing("ssd_scan_bwd", list(K3_TRAIN_SHAPE), kernel, plain, None,
                  ops_s, moved / HBM_BYTES_PER_S, readings=5,
                  operations_float64_ms=1e3 * f64_ops / FP64_OPS_PER_S,
                  operations_bf16_wgmma_ms=1e3 * bf16_ops / BF16_OPS_PER_S,
                  max_abs_err=max(v for k, v in errors.items() if k.endswith("max_abs_err")),
                  **errors)


def time_k2_backward(gen, shape=K2_TRAIN_SHAPE) -> dict:
    """K2's backward at ``shape`` (B, S, H, KV, hd), causal, bf16, by default
    the training shape: kernel, the plain version's autograd backward, and
    SDPA's backward (the library yardstick)."""
    B, S, H, KV, hd = shape
    q, k, v = attention_inputs(gen, B, S, H, KV, hd, torch.bfloat16)
    do = attention_inputs(gen, B, S, H, KV, hd, torch.bfloat16)[0]
    _, lse = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_out = fa.flash_attention_plain(*leaves, causal=True)
    lib_leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    lib_stream = torch.cuda.Stream()          # autograd runs the backward here
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_leaves, is_causal=True, enable_gqa=True)
    torch.cuda.current_stream().wait_stream(lib_stream)
    lib_do = do.transpose(1, 2).contiguous()

    def kernel(i):
        return fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=True)

    def plain(i):
        return torch.autograd.grad(plain_out, leaves, do, retain_graph=True)

    def library(i):
        return torch.autograd.grad(lib_out, lib_leaves, lib_do, retain_graph=True)

    got = kernel(0)
    torch.cuda.synchronize()
    errors = hold_k2_backward(got, q, k, v, do, True)   # held at the timed shape
    print(f"K2 backward vs plain at {list(shape)} bf16: {json.dumps(errors)}")
    lib_err = max(max_err(g, w.transpose(1, 2)) for g, w in zip(got, library(0)))
    ops_ = 10 * B * H * hd * S * (S + 1) / 2     # five products, causal half
    # q, do, dq and k, v, dk, dv once each in bf16, lse in float32
    moved = 2 * (3 * B * S * H * hd + 4 * B * S * KV * hd) + 4 * B * H * S
    return timing("flash_attention_bwd", list(shape), kernel, plain, library,
                  ops_ / BF16_OPS_PER_S, moved / HBM_BYTES_PER_S, library_stream=lib_stream,
                  max_abs_err=max(errors[f"{n}_max_abs_err"] for n in ("dq", "dk", "dv")),
                  **errors, library_max_abs_err=lib_err)


def time_k2_backward_cross(gen) -> dict:
    """K2's backward at the seamless-m4t-medium training cross-attention
    (2048 queries against 512 keys, non-causal, bf16): kernel, the plain
    version's autograd backward and SDPA's backward."""
    B, S, H, KV, hd, Sk = K2_CROSS_SHAPE
    q, k, v = attention_inputs(gen, B, S, H, KV, hd, torch.bfloat16, Sk=Sk)
    do = attention_inputs(gen, B, S, H, KV, hd, torch.bfloat16)[0]
    _, lse = fa.flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_out = fa.flash_attention_plain(*leaves, causal=False)
    lib_leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    lib_stream = torch.cuda.Stream()          # autograd runs the backward here
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_leaves, is_causal=False, enable_gqa=True)
    torch.cuda.current_stream().wait_stream(lib_stream)
    lib_do = do.transpose(1, 2).contiguous()

    def kernel(i):
        return fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=False)

    def plain(i):
        return torch.autograd.grad(plain_out, leaves, do, retain_graph=True)

    def library(i):
        return torch.autograd.grad(lib_out, lib_leaves, lib_do, retain_graph=True)

    got = kernel(0)
    torch.cuda.synchronize()
    errors = hold_k2_backward(got, q, k, v, do, False)   # held at the path's shape
    print(f"K2 backward vs plain at {list(K2_CROSS_SHAPE)} bf16: {json.dumps(errors)}")
    lib_err = max(max_err(g, w.transpose(1, 2)) for g, w in zip(got, library(0)))
    ops_ = 10 * B * H * hd * S * Sk              # five products, no mask
    # q, do, dq and k, v, dk, dv once each in bf16, lse in float32
    moved = 2 * (3 * B * S * H * hd + 4 * B * Sk * KV * hd) + 4 * B * H * S
    return timing("flash_attention_bwd", list(K2_CROSS_SHAPE), kernel, plain, library,
                  ops_ / BF16_OPS_PER_S, moved / HBM_BYTES_PER_S, library_stream=lib_stream,
                  max_abs_err=max(errors[f"{n}_max_abs_err"] for n in ("dq", "dk", "dv")),
                  **errors, library_max_abs_err=lib_err)


def library_times(library, stream=None) -> dict:
    """The library call's device time from a replayed CUDA graph, as the
    kernel's ``ms`` (``graph_ms``, captured on ``stream``), beside the
    profiler's reading and its time per call (CUDA events)."""
    if library is None:
        return {"library_ms": None}
    return {"library_ms": graph_ms(library, stream=stream), "library_timed_by": "graph",
            "library_profiler_ms": device_ms(library, 10),
            "library_call_ms": event_ms(library, 10)}


def timing(name, shape, kernel, plain, library, ops_s, bytes_s, readings=1,
           library_stream=None, **extra) -> dict:
    """Times of ``kernel``, ``plain`` and ``library`` and the bound: the
    kernel's device time from a replayed CUDA graph (``graph_ms``, the
    median of ``GRAPH_READINGS`` replays, all of which are recorded) and from
    the profiler, which with ``readings`` > 1 is the median of that many
    readings of 30 calls each, all of which are recorded; with the card's
    SM clock while they were taken (``clocked``)."""
    return clocked(lambda: timings(name, shape, kernel, plain, library, ops_s, bytes_s,
                                   readings, library_stream, **extra))


def timings(name, shape, kernel, plain, library, ops_s, bytes_s, readings,
            library_stream, **extra) -> dict:
    read = [device_ms(kernel, 30) for _ in range(readings)]
    kernel_ms = None if None in read else statistics.median(read)
    graph_read = [graph_ms(kernel) for _ in range(GRAPH_READINGS)]
    return {"name": name, "shape": shape,
            "kernel_ms": kernel_ms if kernel_ms is not None else event_ms(kernel, 10),
            "kernel_timed_by": "profiler" if kernel_ms is not None else "events",
            "graph_ms": statistics.median(graph_read), "graph_ms_readings": graph_read,
            **({"kernel_ms_readings": read} if readings > 1 else {}),
            "call_ms": event_ms(kernel, 10), "plain_ms": event_ms(plain, 3),
            "plain_device_ms": device_ms(plain, 3),
            **library_times(library, library_stream),
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "operations_ms": 1e3 * ops_s, "bytes_ms": 1e3 * bytes_s, **extra}


def _state_and_parent(stat: Path) -> tuple[str, int] | None:
    """A process's state letter and parent pid from its /proc stat file."""
    try:
        state, ppid = stat.read_text().rsplit(")", 1)[1].split()[:2]
    except (OSError, ValueError):
        return None                                    # ended while we read
    return state, int(ppid)


def descendants(pid: int) -> list[int]:
    """The live processes below ``pid`` (children first), from /proc."""
    parent = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        seen = _state_and_parent(stat)
        if seen is not None and seen[0] != "Z":
            parent[int(stat.parent.name)] = seen[1]
    found, frontier = [], [pid]
    while frontier:
        frontier = [p for p, pp in parent.items() if pp in frontier]
        found += frontier
    return found


def stop_descendants() -> None:
    """SIGTERM, then after 5 s SIGKILL, every process this one started that
    is still running, as a phase that failed half way can leave (a served
    cluster whose replicas never published their ports), so that the script
    never ends with a process of its own running."""
    left = descendants(os.getpid())
    if not left:
        return
    print(f"chip_smoke: stopping {len(left)} processes left running: {left}",
          file=sys.stderr)
    for sig, wait_s in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 5.0)):
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.time() + wait_s
        while time.time() < deadline:
            with contextlib.suppress(ChildProcessError):
                while os.waitpid(-1, os.WNOHANG)[0] > 0:
                    pass
            # by pid, not by descent: a killed child's children are reparented
            left = [p for p in left
                    if (seen := _state_and_parent(Path(f"/proc/{p}/stat"))) is not None
                    and seen[0] != "Z"]
            if not left:
                return
            time.sleep(0.05)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--train-steps", type=int, default=TRAIN_STEPS,
                        help="steps of each full-size training path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    card = device_line()
    print(card)
    print(json.dumps({"toolchain": toolchain()}))
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s for {sorted(built)}")
    print(json.dumps({"resource_usage": resource_usage()}))

    check_k1(rng)
    check_rank_sort(rng)
    check_small_slice(rng)
    summary = main_path(rng)
    protocol_path()
    served_path()

    torch.backends.cuda.matmul.allow_tf32 = False     # plain sides in full float32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(args.seed)
    check_k2(gen)
    check_k3(gen)
    check_small_hybrid(args.seed)
    serving = serving_path(SERVE_ARCH, args.seed, "serving_path")
    check_k2_backward(gen)
    check_small_dense(args.seed)
    dense = serving_path(DENSE_ARCH, args.seed, "dense_serving_path")
    check_small_ssm_training(args.seed)
    training = training_path(DENSE_ARCH, "training_path", args.seed, args.train_steps)
    torch.cuda.empty_cache()
    hybrid_training = training_path(HYBRID_ARCH, "hybrid_training_path", args.seed,
                                    args.train_steps)
    # the moe, encdec and vlm families after the paths of earlier slices, so
    # that those run in the process state they always ran in
    torch.cuda.empty_cache()
    check_small_families(args.seed)
    moe_serving = serving_path(MOE_ARCH, args.seed, "moe_serving_path")
    torch.cuda.empty_cache()
    encdec_serving = serving_path(ENCDEC_ARCH, args.seed, "encdec_serving_path")
    torch.cuda.empty_cache()
    # their training, after every earlier path
    check_small_family_training(args.seed)
    moe_training = training_path(MOE_ARCH, "moe_training_path", args.seed, args.train_steps)
    torch.cuda.empty_cache()
    encdec_training = training_path(ENCDEC_ARCH, "encdec_training_path", args.seed,
                                    args.train_steps, cut=ENCDEC_TRAIN_CUT)
    torch.cuda.empty_cache()
    # sharded training and serving on a 1x1 mesh, after every unsharded path
    sharded_training = sharded_training_path(DENSE_ARCH, "sharded_training_path", args.seed,
                                             training)
    torch.cuda.empty_cache()
    sharded_serving = sharded_serving_path(SERVE_ARCH, "sharded_serving_path", args.seed,
                                           serving)
    torch.cuda.empty_cache()
    # the dry-run, after the sharded phases (it makes its own fake process group)
    dryrun_path(args.seed, training, hybrid_training)
    torch.cuda.empty_cache()

    shapes = [time_k1(rng, OPS, N_REPLICAS, members=True)]
    shapes += [time_k1(rng, o, n, members=False) for o, n in TIME_SHAPES]
    main = shapes[0]
    k2, k3, k2b, k3b = time_k2(gen), time_k3(gen), time_k2_backward(gen), time_k3_backward(gen)
    k2["shapes"] = [time_k2_cross(gen), time_k2(gen, K2_HD192_SHAPE),
                    time_k2(gen, K2_TRAIN_SHAPE)]
    k2b["shapes"] = [time_k2_backward_cross(gen), time_k2_backward(gen, K2_HD192_SHAPE)]
    k3["shapes"] = [time_k3(gen, K3_TRAIN_SHAPE)]
    kernels = [{
        "name": "quorum_commit", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quorum_commit.cu",
        "replaces": "src/repro/kernels/quorum_commit.py:103",
        "launches": summary["launches"], "max_abs_err": summary["max_abs_err"],
        "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"],
        "call_ms": main["call_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "shape": [OPS, N_REPLICAS], "card": card,
        "shapes": shapes}]
    k2["launches_by_path"] = {
        "zamba2_prefill": serving["launches"]["flash_attention"],
        "qwen3_prefill": dense["launches"]["flash_attention"],
        "granite_prefill": moe_serving["launches"]["flash_attention"],
        "seamless_prefill": encdec_serving["launches"]["flash_attention"],
        f"seamless_decode_{SERVE_DECODE}_steps":
            encdec_serving["decode_launches"]["flash_attention"],
        f"qwen3_train_{args.train_steps}_steps": training["launches"]["flash_attention"],
        f"zamba2_train_{args.train_steps}_steps": hybrid_training["launches"]["flash_attention"],
        f"granite_train_{args.train_steps}_steps": moe_training["launches"]["flash_attention"],
        f"seamless_train_{args.train_steps}_steps":
            encdec_training["launches"]["flash_attention"],
        "zamba2_sharded_prefill": sharded_serving["launches"]["flash_attention"],
        f"qwen3_sharded_train_{SHARDED_TRAIN_STEPS}_steps":
            sharded_training["launches"]["flash_attention"]}
    k2b["launches_per_train_step"] = training["launches_per_step"]["flash_attention_bwd"]
    k2b["launches_by_path"] = {
        f"qwen3_train_{args.train_steps}_steps": training["launches"]["flash_attention_bwd"],
        f"zamba2_train_{args.train_steps}_steps": hybrid_training["launches"]["flash_attention_bwd"],
        f"granite_train_{args.train_steps}_steps": moe_training["launches"]["flash_attention_bwd"],
        f"seamless_train_{args.train_steps}_steps":
            encdec_training["launches"]["flash_attention_bwd"],
        f"qwen3_sharded_train_{SHARDED_TRAIN_STEPS}_steps":
            sharded_training["launches"]["flash_attention_bwd"]}
    k3["launches_by_path"] = {
        "zamba2_prefill": serving["launches"]["ssd_scan"],
        f"zamba2_train_{args.train_steps}_steps": hybrid_training["launches"]["ssd_scan"],
        "zamba2_sharded_prefill": sharded_serving["launches"]["ssd_scan"]}
    k3b["launches_per_train_step"] = hybrid_training["launches_per_step"]["ssd_scan_bwd"]
    for k, replaces, launches in (
            (k2, "src/repro/kernels/flash_attention.py:91",
             serving["launches"]["flash_attention"]),
            (k2b, "src/repro/kernels/flash_attention.py:91",
             training["launches"]["flash_attention_bwd"]),
            (k3, "src/repro/kernels/ssd_scan.py:64", serving["launches"]["ssd_scan"]),
            (k3b, "src/repro/kernels/ssd_scan.py:64",
             hybrid_training["launches"]["ssd_scan_bwd"])):
        kernels.append({
            "name": k["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k['name']}.cu",
            "replaces": replaces, "launches": launches,
            "ms": k["graph_ms"], "card": card, **k})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_descendants()
    sys.exit(code)
