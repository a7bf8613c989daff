"""K1, the weighted-quorum commit (WOC's hot spot), on Hopper.

Per operation: order the replica vote arrivals (carrying their weights),
add up the weights of finite votes in arrival order, and find the first
STRICT crossing of ``T = sum(w)/2`` -> commit time, quorum size, committed
flag, accumulated weight and, on request, the quorum's members.

Three functions compute it:
  * :func:`quorum_commit_cuda` launches the hand-written CUDA kernel
    ``csrc/quorum_commit.cu``, which replaces the Pallas TPU kernel of
    ``repro/kernels/quorum_commit.py`` (``_kernel`` and ``_bitonic_by_time``);
    that source says what bounds it (memory bytes) and how it is designed;
  * :func:`quorum_commit_plain` is the plain PyTorch version, the stable-sort
    body of ``repro.core.quorum.quorum_commit``;
  * :func:`quorum_commit` picks by the inputs' device: a CUDA tensor
    launches the kernel or raises, a CPU tensor runs the plain version.

Each returns ``(commit_time f32, quorum_size i32, committed bool,
weight_sum f32, members bool (ops, n) or None)``. Weights are assumed
non-negative, as the protocol gives them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_REPLICAS = 1024

# Kernel launches made by quorum_commit_cuda since the count was last reset.
launches = 0


def _check_shapes(arrivals, weights, threshold) -> None:
    if arrivals.ndim != 2 or weights.shape != arrivals.shape:
        raise ValueError("quorum_commit: arrivals and weights must both be "
                         f"(ops, n); got {tuple(arrivals.shape)} and "
                         f"{tuple(weights.shape)}")
    if arrivals.shape[1] < 1:
        raise ValueError("quorum_commit: need at least one replica")
    if threshold is not None and threshold.shape != arrivals.shape[:1]:
        raise ValueError(f"quorum_commit: threshold must be ({arrivals.shape[0]},); "
                         f"got {tuple(threshold.shape)}")


def quorum_commit(arrivals: torch.Tensor, weights: torch.Tensor,
                  threshold: torch.Tensor | None = None, *,
                  members: bool = False):
    """K1 on the inputs' device: the kernel for CUDA, the plain version for
    the CPU. See the module docstring for the outputs."""
    if arrivals.device.type == "cuda":
        return quorum_commit_cuda(arrivals, weights, threshold, members=members)
    if arrivals.device.type == "cpu":
        return quorum_commit_plain(arrivals, weights, threshold, members=members)
    raise ValueError(f"quorum_commit: no implementation for device {arrivals.device}")


def quorum_commit_plain(arrivals: torch.Tensor, weights: torch.Tensor,
                        threshold: torch.Tensor | None = None, *,
                        members: bool = False):
    """Plain PyTorch version of K1, on any device."""
    _check_shapes(arrivals, weights, threshold)
    if threshold is None:
        threshold = torch.sum(weights, dim=-1) / 2.0
    # stable: tied arrivals keep replica order, as jnp.argsort does
    t_sorted, order = torch.sort(arrivals, dim=-1, stable=True)
    w_sorted = torch.gather(weights, -1, order)
    voted = torch.isfinite(t_sorted)
    # votes that never arrive contribute no weight
    csum = torch.cumsum(torch.where(voted, w_sorted, 0.0), dim=-1)
    crossed = csum > threshold[..., None]                # strict (Theorem 1)
    committed = torch.any(crossed & voted, dim=-1)
    # first crossing index; argmax gives 0 when nothing crossed, so mask
    k = torch.argmax(crossed.to(torch.uint8), dim=-1, keepdim=True)
    commit_time = torch.where(committed, torch.gather(t_sorted, -1, k)[:, 0],
                              float("inf"))
    quorum_size = torch.where(committed, k[:, 0] + 1, 0).to(torch.int32)
    weight_sum = torch.where(committed, torch.gather(csum, -1, k)[:, 0], 0.0)
    mask = None
    if members:
        pos_in_sorted = torch.argsort(order, dim=-1)     # position of replica i
        mask = ((pos_in_sorted <= k) & committed[:, None]
                & torch.isfinite(arrivals))
    return commit_time, quorum_size, committed, weight_sum, mask


@functools.cache
def _launcher():
    fn = _build.library("quorum_commit").quorum_commit_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int,
                   ptr, ptr, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def quorum_commit_cuda(arrivals: torch.Tensor, weights: torch.Tensor,
                       threshold: torch.Tensor | None = None, *,
                       members: bool = False):
    """Launch the CUDA kernel on the current stream of the inputs' device.

    Takes contiguous float32 CUDA tensors, arrivals and weights ``(ops, n)``
    with ``1 <= n <= MAX_REPLICAS`` and an optional threshold ``(ops,)``, all
    on one device; raises on anything else and when the launch fails.
    """
    global launches
    _check_shapes(arrivals, weights, threshold)
    tensors = [arrivals, weights] + ([threshold] if threshold is not None else [])
    device = arrivals.device
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError("quorum_commit_cuda: inputs must lie on one CUDA "
                         f"device; got {[str(x.device) for x in tensors]}")
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("quorum_commit_cuda: inputs must be float32; got "
                        f"{[x.dtype for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("quorum_commit_cuda: inputs must be contiguous")
    ops, n = arrivals.shape
    if n > MAX_REPLICAS:
        raise ValueError(f"quorum_commit_cuda: n={n} replicas; the kernel "
                         f"supports at most {MAX_REPLICAS}")

    commit_time = torch.empty(ops, dtype=torch.float32, device=device)
    quorum_size = torch.empty(ops, dtype=torch.int32, device=device)
    committed = torch.empty(ops, dtype=torch.bool, device=device)
    weight_sum = torch.empty(ops, dtype=torch.float32, device=device)
    mask = torch.empty((ops, n), dtype=torch.bool, device=device) if members else None
    if ops == 0:
        return commit_time, quorum_size, committed, weight_sum, mask
    with torch.cuda.device(device):
        err = _launcher()(
            arrivals.data_ptr(), weights.data_ptr(),
            None if threshold is None else threshold.data_ptr(), ops, n,
            commit_time.data_ptr(), quorum_size.data_ptr(),
            committed.data_ptr(), weight_sum.data_ptr(),
            None if mask is None else mask.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quorum_commit_cuda: kernel launch failed with "
                           f"CUDA error {err}")
    launches += 1
    return commit_time, quorum_size, committed, weight_sum, mask
