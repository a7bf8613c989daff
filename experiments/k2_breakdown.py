"""Where K2's backward spends its time on the card: each of its two bf16
kernels' device ms (D/dQ, then dK/dV) at the shapes `chip_smoke.py` times,
from torch.profiler over 10 calls in a fresh process (median of 5 such
rounds), beside the whole call's replayed-graph ms (median of 5), and each
kernel's rate for the products it issues (D/dQ five, dK/dV four, each
2 B H hd pairs FLOP, pairs S(S+1)/2 causal or S Sk). Needs one GPU.

    PYTHONPATH=src python3 experiments/k2_breakdown.py
"""

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

KERNELS = {"dq": ("attn_bwd_dq_bf16_kernel", 5), "dkdv": ("attn_bwd_dkdv_bf16_kernel", 4)}
ROUNDS, CALLS = 5, 10


def kernel_ms(call) -> dict:
    """Each backward kernel's device ms a call, over ``CALLS`` calls."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(CALLS):
            call(i)
        torch.cuda.synchronize()
    out = dict.fromkeys(KERNELS, 0.0)
    for event in prof.key_averages():
        for name, (symbol, _) in KERNELS.items():
            if symbol in event.key:
                out[name] += event.self_device_time_total / CALLS / 1e3
    return out


def breakdown(gen, shape) -> dict:
    B, S, H, KV, hd, *rest = shape
    Sk = rest[0] if rest else None
    causal = Sk is None
    q, k, v = cs.attention_inputs(gen, B, S, H, KV, hd, torch.bfloat16, Sk)
    do = cs.attention_inputs(gen, B, S, H, KV, hd, torch.bfloat16, Sk)[0]
    _, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)

    def call(i):
        return fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal)

    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    rounds = [kernel_ms(call) for _ in range(ROUNDS)]
    graph = [cs.graph_ms(call) for _ in range(ROUNDS)]
    pairs = S * (S + 1) / 2 if causal else S * Sk
    row = {"shape": list(shape), "causal": causal, "graph_ms": statistics.median(graph),
           "graph_ms_readings": graph}
    for name, (_, products) in KERNELS.items():
        ms = statistics.median(r[name] for r in rounds)
        row[f"{name}_ms"] = ms
        row[f"{name}_ms_readings"] = [r[name] for r in rounds]
        row[f"{name}_tflops"] = products * 2 * B * H * hd * pairs / (ms * 1e-3) / 1e12
    row["dq_share"] = row["dq_ms"] / (row["dq_ms"] + row["dkdv_ms"])
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(cs.device_line())
    _build.build(["flash_attention", "flash_attention_bwd"])
    gen = torch.Generator("cuda").manual_seed(0)
    for shape in (cs.K2_TRAIN_SHAPE, cs.K2_CROSS_SHAPE, cs.K2_HD192_SHAPE):
        print(json.dumps({"k2_backward": breakdown(gen, shape)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
