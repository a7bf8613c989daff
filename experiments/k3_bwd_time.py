"""K3's backward alone at the zamba2-1.2b training microbatch's shape (4,
16, 128, 64, 64, 64), x bf16, on one GPU, from whichever ``repro_torch`` is
on ``PYTHONPATH``: the median of 5 readings, each a replayed CUDA graph of 10
calls timed with events (as ``chip_smoke.graph_ms``), with the card's name
and power limit. To compare two trees, time both in one call, in turns:

    PYTHONPATH=parent/src python3 experiments/k3_bwd_time.py
    PYTHONPATH=src python3 experiments/k3_bwd_time.py

``--heads-per-block G`` sets the heads one block of the backward takes
(``ssd_scan.BWD_HEADS_PER_BLOCK``, read at each launch) before timing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import ssd_scan as ssd

SHAPE = (4, 16, 128, 64, 64, 64)   # B, nc, Q, nh, hp, N
CALLS = 10
READINGS = 5


def inputs(gen, B, nc, Q, nh, hp, N):
    """K3's inputs as ``chip_smoke.ssd_inputs`` makes them, x bf16, and the
    gradients of its outputs as ``chip_smoke.ssd_output_grads`` does."""
    def r(*size):
        return torch.randn(size, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(r(B, nc, Q, nh) - 2.0)
    seg = torch.cumsum(dt * -torch.exp(0.5 * r(nh)), dim=2)
    return (r(B, nc, Q, nh, hp).bfloat16(), dt, seg, r(B, nc, Q, N), r(B, nc, Q, N),
            r(B, nc, Q, nh, hp), r(B, nc, nh, hp, N), r(B, nc, nh))


def graph_ms(fn) -> float:
    """One reading: a CUDA graph of CALLS calls, replayed and timed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--heads-per-block", type=int, default=ssd.BWD_HEADS_PER_BLOCK)
    ssd.BWD_HEADS_PER_BLOCK = parser.parse_args().heads_per_block
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    args = inputs(torch.Generator("cuda").manual_seed(0), *SHAPE)
    readings = [graph_ms(lambda: ssd.ssd_intra_chunk_bwd_cuda(*args)) for _ in range(READINGS)]
    print(json.dumps({"package": ssd.__file__, "card": card, "shape": list(SHAPE),
                      "heads_per_block": ssd.BWD_HEADS_PER_BLOCK,
                      "ms": statistics.median(readings), "readings": readings}))


if __name__ == "__main__":
    main()
