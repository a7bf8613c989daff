"""K2, causal or non-causal GQA flash attention, on Hopper.

``o = softmax(q kᵀ · hd^-0.5, masked) v``: q ``(B,S,H,hd)`` and k/v
``(B,Sk,KV,hd)``, query head ``h`` reading kv head ``h // (H/KV)``. Causal
attention is self-attention (``Sk == S``); non-causal attention takes keys
of any length ``Sk >= 1`` (an encoder-decoder's cross-attention). Masked
logits are ``-1e30``; the output has q's dtype.

Its gradient is K2's backward (``csrc/flash_attention_bwd.cu``), which the
JAX package takes by differentiating ``repro.models.layers.attend``; it takes
what the forward takes, keys of their own length included, so a CUDA call
that wants a gradient goes through :class:`FlashAttention` whatever ``Sk``
is (causal attention with ``Sk != S`` raises before any launch, forward or
backward).

The functions:
  * :func:`flash_attention_cuda` calls the ``torch.library`` op
    ``repro_torch::flash_attention``, whose body launches the hand-written
    CUDA kernel
    ``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel of
    ``repro/kernels/flash_attention.py`` (``flash_attention`` and its
    ``_kernel``); that source says what bounds it and how it is designed.
    The dtype selects the kernel: bfloat16 runs on the tensor cores
    (``mma.sync`` bf16 products with float32 accumulators, P rounded to
    bf16 for the P V product, K/V tiles in a ``cp.async`` ring), float32 on
    CUDA cores in float32 throughout, as its 1e-4 contract asks. With
    ``return_lse`` it also returns each row's log-sum-exp;
  * :func:`flash_attention_bwd_cuda` calls ``repro_torch::flash_attention_bwd``,
    whose body launches the backward kernels
    (``csrc/flash_attention_bwd.cu``): dq, dk, dv from q, k, v, do and the
    log-sum-exp, by recompute and with no atomics, for any key length that
    the forward takes. bfloat16 runs two
    tensor-core kernels (``mma.sync`` bf16, dS and P rounded to bf16 as
    A operands), float32 two CUDA-core kernels;
  * :class:`FlashAttention` is the ``torch.autograd.Function`` of the two;
  * :func:`flash_attention_plain` is the plain PyTorch version:
    :func:`attend_chunked` for S > ``ATTN_CHUNK`` that divides into chunks,
    else :func:`attend_full`, the choice ``repro.models.layers.attend``
    makes (the JAX ``ref.flash_attention_ref`` makes the same one wherever
    its chunked reshape is defined);
  * :func:`flash_attention` picks by the inputs' device: a CUDA tensor
    launches the kernel (through :class:`FlashAttention` where a gradient
    is wanted) or raises, a CPU tensor runs the plain version, whose autograd
    gradient is the backward kernel's yardstick.

The two ops' bodies are the ctypes launches, with their checks and launch
counts. Each op has a fake (``register_fake``: its outputs' shapes and
dtypes), which a fake or meta tensor runs, having no data to compute on:
the dry-run (``launch.dryrun``) traces the card's own path through it. Each
has a FLOP formula (``register_flop_formula``, :func:`attention_flops`),
which ``torch.utils.flop_counter`` and ``launch.op_analysis`` count.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

# attention chunk size for memory-bounded (flash-style) prefill
ATTN_CHUNK = 512
HEAD_DIMS = (16, 32, 64, 128, 192)   # 16: the smoke configs' heads; 192: nemotron-4-340b
DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches made by flash_attention_cuda and flash_attention_bwd_cuda
# since the counts were last reset.
launches = 0
bwd_launches = 0


def attend_full(q, k, v, *, causal: bool, q_offset: int = 0):
    """Plain grouped attention: fine for short S. q: (B,Sq,H,hd),
    k/v: (B,Sk,KV,hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scale = hd ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    logits = logits * scale
    if causal:
        Sk = k.shape[1]
        qpos = torch.arange(Sq, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(mask[None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return o.reshape(B, Sq, H, hd)


def attend_chunked(q, k, v, *, causal: bool = True):
    """Flash-style chunked attention over query blocks (bounded memory):
    scores exist one (chunk x S) tile at a time."""
    B, S, H, hd = q.shape
    C = min(ATTN_CHUNK, S)
    return torch.cat([attend_full(q[:, i:i + C], k, v, causal=causal,
                                  q_offset=i)
                      for i in range(0, S, C)], dim=1)


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain PyTorch version of K2, on any device."""
    S = q.shape[1]
    if S > ATTN_CHUNK and S % ATTN_CHUNK == 0:
        return attend_chunked(q, k, v, causal=causal)
    return attend_full(q, k, v, causal=causal)


def flash_attention(q, k, v, *, causal: bool = True):
    """K2 on the inputs' device: the kernel for CUDA (differentiable through
    the backward kernel), the plain version for the CPU."""
    no_dtensor("flash_attention", q, k, v)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal)
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    raise ValueError(f"flash_attention: no implementation for device {q.device}")


@functools.cache
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    fn = _build.library("flash_attention_bwd").flash_attention_bwd_launch
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    fn.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def no_dtensor(name: str, *tensors) -> None:
    """Raise for a DTensor: the kernels and their plain versions take each
    rank's local shards (``local_map``), never a DTensor. No DTensor exists
    before ``torch.distributed.tensor`` is imported, and this module does not
    import it: it takes seconds, which every process of the served cluster
    (``repro_torch.transport``) would pay at start-up."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and any(isinstance(t, dtensor.DTensor) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; call it on local shards (local_map)")


def _dims(name: str, q, k, v, do=None, *, causal=True):
    """Raise unless q is ``(B,S,H,hd)``, k and v ``(B,Sk,KV,hd)`` and, for
    the backward, ``do`` q's shape, with ``Sk`` other than ``S`` (and at
    least 1) only for non-causal attention. Returns (B, S, Sk, H, KV, hd)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q must be (B,S,H,hd) and k, v (B,Sk,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (B, hd) or KV == 0 or H % KV:
        raise ValueError(f"{name}: q and k must share B and hd, with H a multiple "
                         f"of KV; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if Sk != S and (causal or Sk == 0):
        raise ValueError(f"{name}: keys of their own length (here {Sk} for {S} "
                         f"queries) only for non-causal attention, and at least 1")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"{name}: do must have q's shape {tuple(q.shape)}; got "
                         f"{tuple(do.shape)}")
    return B, S, Sk, H, KV, hd


def _kernel_takes(name: str, tensors, hd) -> None:
    """Raise unless ``tensors`` are all float32 or all bfloat16 and the head
    dim is one the kernels take."""
    if tensors[0].dtype not in DTYPES or any(x.dtype != tensors[0].dtype for x in tensors):
        raise TypeError(f"{name}: inputs must all be float32 or all bfloat16; got "
                        f"{[x.dtype for x in tensors]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd}; the kernel takes {HEAD_DIMS}")


def _check(name: str, q, k, v, do=None, *, causal=True):
    """Raise unless q ``(B,S,H,hd)``, k and v ``(B,Sk,KV,hd)`` and, for the
    backward, ``do`` (q's shape) are contiguous, 16-byte aligned CUDA tensors
    of one dtype on one device that the kernels take (:func:`_dims`,
    :func:`_kernel_takes`). Returns (B, S, Sk, H, KV, hd)."""
    no_dtensor(name, q, k, v, *(() if do is None else (do,)))
    B, S, Sk, H, KV, hd = _dims(name, q, k, v, do, causal=causal)
    tensors = (q, k, v) if do is None else (q, k, v, do)
    device = q.device
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError(f"{name}: inputs must lie on one CUDA device; got "
                         f"{[str(x.device) for x in tensors]}")
    _kernel_takes(name, tensors, hd)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return B, S, Sk, H, KV, hd


def attention_flops(B: int, S: int, Sk: int, H: int, hd: int, causal: bool) -> int:
    """K2's FLOP: q kᵀ and p v, 2·hd each for every (query, key) pair it
    computes: 4·B·H·hd·S(S+1)/2 causal (the lower triangle, diagonal
    included), 4·B·H·hd·S·Sk otherwise. Its backward's five products
    (q kᵀ and dO vᵀ recomputed, dV, dQ, dK) are 2.5 times that."""
    pairs = S * (S + 1) // 2 if causal else S * Sk
    return 4 * B * H * hd * pairs


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, return_lse: bool = False):
    """K2 through its op ``repro_torch::flash_attention``: the CUDA kernel on
    the current stream of the inputs' device, or the op's fake on fake and
    meta tensors.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device: q ``(B,S,H,hd)``, k and v ``(B,Sk,KV,hd)`` with ``H % KV == 0``
    and ``hd`` in ``HEAD_DIMS``; any S, and ``Sk == S`` when causal, else any
    ``Sk >= 1`` (cross-attention). bfloat16 launches the tensor-core kernel,
    float32 the CUDA-core kernel. Returns the output, and with
    ``return_lse`` also each row's float32 log-sum-exp of the scaled logits,
    ``(B,H,S)``. Raises on anything else and when the launch fails.
    """
    no_dtensor("flash_attention_cuda", q, k, v)
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal, return_lse)
    return (out, lse) if return_lse else out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool, return_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The op's body: check, launch, count. The log-sum-exp is empty,
    ``(0,)``, where ``return_lse`` is false (the kernel writes none)."""
    global launches
    B, S, Sk, H, KV, hd = _check("flash_attention_cuda", q, k, v, causal=causal)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S) if return_lse else (0,), dtype=torch.float32,
                      device=q.device)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr() if return_lse else None,
                          B, S, Sk, H, KV, hd, int(causal),
                          int(q.dtype == torch.bfloat16),
                          torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: kernel launch failed with "
                           f"CUDA error {err}")
    launches += 1
    return out, lse


@_flash_attention_launch.register_fake
def _(q, k, v, causal, return_lse):
    B, S, _, H, _, hd = _dims("flash_attention_cuda", q, k, v, causal=causal)
    _kernel_takes("flash_attention_cuda", (q, k, v), hd)
    return (torch.empty_like(q),
            q.new_empty((B, H, S) if return_lse else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, return_lse, *args, out_shape=None, **kwargs):
    B, S, H, hd = q_shape
    return attention_flops(B, S, k_shape[1], H, hd, causal)


def flash_attention_bwd_cuda(q, k, v, do, lse, *, causal: bool = True):
    """K2's backward through its op ``repro_torch::flash_attention_bwd``:
    the backward kernels on the current stream (the op's fake on fake and
    meta tensors). ``(dq, dk, dv)`` in the inputs' dtype from q, k, v, the
    output's gradient ``do`` (q's shape and dtype) and the forward's float32
    log-sum-exp ``(B,H,S)``; dk and dv have k's shape. Takes what
    :func:`flash_attention_cuda` takes (keys of their own length for
    non-causal attention); raises on anything else and when a launch fails.
    (The forward's output is not needed: the kernel takes rowsum(do * o)
    from the recomputed probabilities, which in bf16 is more accurate than
    from the rounded output; see the source.)"""
    no_dtensor("flash_attention_bwd_cuda", q, k, v, do)
    return tuple(torch.ops.repro_torch.flash_attention_bwd(q, k, v, do, lse, causal))


def _lse_check(name, q, lse, B, H, S):
    if (lse.device != q.device or lse.dtype != torch.float32 or lse.shape != (B, H, S)
            or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be a contiguous float32 "
                         f"{(B, H, S)} tensor on {q.device}; got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                do: torch.Tensor, lse: torch.Tensor,
                                causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's body: check, launch, count."""
    global bwd_launches
    B, S, Sk, H, KV, hd = _check("flash_attention_bwd_cuda", q, k, v, do, causal=causal)
    _lse_check("flash_attention_bwd_cuda", q, lse, B, H, S)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    # D = rowsum(do * o) and (bf16) the renormalised log-sum-exp, for dk/dv
    scratch = torch.empty((2, B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_launcher()(*(x.data_ptr() for x in (q, k, v, do, lse, scratch, dq, dk, dv)),
                              B, S, Sk, H, KV, hd, int(causal),
                              int(q.dtype == torch.bfloat16),
                              torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_cuda: kernel launch failed with "
                           f"CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv


@_flash_attention_bwd_launch.register_fake
def _(q, k, v, do, lse, causal):
    B, S, _, H, _, hd = _dims("flash_attention_bwd_cuda", q, k, v, do, causal=causal)
    _kernel_takes("flash_attention_bwd_cuda", (q, k, v, do), hd)
    _lse_check("flash_attention_bwd_cuda", q, lse, B, H, S)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, v_shape, do_shape, lse_shape, causal, *args, out_shape=None,
      **kwargs):
    B, S, H, hd = q_shape
    return attention_flops(B, S, k_shape[1], H, hd, causal) * 5 // 2


class FlashAttention(torch.autograd.Function):
    """K2 on the card with its gradient: the forward kernel writes each
    row's log-sum-exp and saves ``(q, k, v, lse)``; the backward kernel
    recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, do.contiguous(), lse,
                                              causal=ctx.causal)
        return dq, dk, dv, None
