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

K1 has no backward kernel, and the kernel writes its outputs through
``ctypes``, so they carry no autograd graph: where grad mode is on and an
input requires a gradient, :func:`quorum_commit_cuda` raises
``NotImplementedError`` before it launches. The plain version keeps its
autograd gradient (``weight_sum`` with respect to the weights).
"""

from __future__ import annotations

import contextlib
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


def sort_keys(t: torch.Tensor) -> torch.Tensor:
    """float32 keys whose stable sort orders ``t`` as ``jnp.argsort`` does on
    every device: -0.0 becomes +0.0 (adding +0.0 changes nothing else) and
    every NaN, of either sign and any payload, one positive NaN, which sorts
    after +inf. ``torch.sort`` on the card may order the raw values otherwise
    (-0.0 before +0.0, -NaN first); on the canonical keys every sort agrees.
    The keys stay 32 bits wide, so a radix sort takes no more passes;
    forming them takes two elementwise passes (the add, then the NaN map in
    place)."""
    inf = float("inf")
    return (t + 0.0).nan_to_num_(nan=float("nan"), posinf=inf, neginf=-inf)


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
    # stable on canonical keys: tied arrivals (-0.0 with +0.0, NaN with NaN)
    # keep replica order, as jnp.argsort does; the values are the arrivals'
    order = torch.sort(sort_keys(arrivals), dim=-1, stable=True).indices
    t_sorted = torch.gather(arrivals, -1, order)
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
    on one device; raises ``NotImplementedError`` where a gradient is wanted
    (grad mode on and an input that requires one), and raises on anything
    else and when the launch fails. The outputs are views of one allocation.
    """
    global launches
    if (arrivals.requires_grad or weights.requires_grad
            or (threshold is not None and threshold.requires_grad)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "quorum_commit_cuda: an input requires a gradient, and K1 has no backward "
            "kernel; the kernel's outputs would carry no gradient. Run it under "
            "torch.no_grad() or on detached inputs, or on CPU tensors for the plain "
            "version's gradient")
    _check_shapes(arrivals, weights, threshold)
    # written out rather than as loops over the tensors: this runs every call
    t = arrivals if threshold is None else threshold
    device, f32 = arrivals.device, torch.float32
    if device.type != "cuda" or weights.device != device or t.device != device:
        raise ValueError("quorum_commit_cuda: inputs must lie on one CUDA device; "
                         f"got {arrivals.device}, {weights.device}, {t.device}")
    if arrivals.dtype != f32 or weights.dtype != f32 or t.dtype != f32:
        raise TypeError("quorum_commit_cuda: inputs must be float32; got "
                        f"{arrivals.dtype}, {weights.dtype}, {t.dtype}")
    if not (arrivals.is_contiguous() and weights.is_contiguous() and t.is_contiguous()):
        raise ValueError("quorum_commit_cuda: inputs must be contiguous")
    ops, n = arrivals.shape
    if n > MAX_REPLICAS:
        raise ValueError(f"quorum_commit_cuda: n={n} replicas; the kernel "
                         f"supports at most {MAX_REPLICAS}")

    # one allocation: commit_time, weight_sum, quorum_size (4 bytes a row),
    # committed (1) and the members mask (n)
    out = torch.empty(13 * ops + (ops * n if members else 0), dtype=torch.bool,
                      device=device)
    parts = out.split_with_sizes((4 * ops, 4 * ops, 4 * ops, ops, ops * n if members else 0))
    commit_time = parts[0].view(f32)
    weight_sum = parts[1].view(f32)
    quorum_size = parts[2].view(torch.int32)
    committed = parts[3]
    mask = parts[4].view(ops, n) if members else None
    if ops == 0:
        return commit_time, quorum_size, committed, weight_sum, mask
    index = device.index
    other = index != torch.cuda.current_device()
    with torch.cuda.device(index) if other else contextlib.nullcontext():
        err = _launcher()(
            arrivals.data_ptr(), weights.data_ptr(),
            None if threshold is None else threshold.data_ptr(), ops, n,
            commit_time.data_ptr(), quorum_size.data_ptr(), committed.data_ptr(),
            weight_sum.data_ptr(), None if mask is None else mask.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"quorum_commit_cuda: kernel launch failed with "
                           f"CUDA error {err}")
    launches += 1
    return commit_time, quorum_size, committed, weight_sum, mask
