"""K2, causal or non-causal GQA flash attention, on Hopper.

``o = softmax(q kᵀ · hd^-0.5, masked) v`` for self-attention: q ``(B,S,H,hd)``
and k/v ``(B,S,KV,hd)``, query head ``h`` reading kv head ``h // (H/KV)``.
Masked logits are ``-1e30``; the output has q's dtype.

Three functions compute it:
  * :func:`flash_attention_cuda` launches the hand-written CUDA kernel
    ``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel of
    ``repro/kernels/flash_attention.py`` (``flash_attention`` and its
    ``_kernel``); that source says what bounds it and how it is designed.
    The dtype selects the kernel: bfloat16 runs on the tensor cores
    (``mma.sync`` bf16 products with float32 accumulators, P rounded to
    bf16 for the P V product, K/V tiles in a ``cp.async`` ring), float32 on
    CUDA cores in float32 throughout, as its 1e-4 contract asks;
  * :func:`flash_attention_plain` is the plain PyTorch version:
    :func:`attend_chunked` for S > ``ATTN_CHUNK`` that divides into chunks,
    else :func:`attend_full`, the choice ``repro.models.layers.attend``
    makes (the JAX ``ref.flash_attention_ref`` makes the same one wherever
    its chunked reshape is defined);
  * :func:`flash_attention` picks by the inputs' device: a CUDA tensor
    launches the kernel or raises, a CPU tensor runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# attention chunk size for memory-bounded (flash-style) prefill
ATTN_CHUNK = 512
HEAD_DIMS = (16, 32, 64, 128)   # 16: the smoke configs' heads
DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches made by flash_attention_cuda since the count was last reset.
launches = 0


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
    """K2 on the inputs' device: the kernel for CUDA, the plain version for
    the CPU."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    raise ValueError(f"flash_attention: no implementation for device {q.device}")


@functools.cache
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the inputs' device.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device: q ``(B,S,H,hd)``, k and v ``(B,S,KV,hd)`` with ``H % KV == 0`` and
    ``hd`` in ``HEAD_DIMS``; any S. bfloat16 launches the tensor-core
    kernel, float32 the CUDA-core kernel. Raises on anything else and when
    the launch fails.
    """
    global launches
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention_cuda: q must be (B,S,H,hd) and k, v "
                         f"(B,S,KV,hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd) or KV == 0 or H % KV:
        raise ValueError("flash_attention_cuda: self-attention with H a multiple "
                         f"of KV only; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    tensors = (q, k, v)
    device = q.device
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError("flash_attention_cuda: inputs must lie on one CUDA "
                         f"device; got {[str(x.device) for x in tensors]}")
    if q.dtype not in DTYPES or any(x.dtype != q.dtype for x in tensors):
        raise TypeError("flash_attention_cuda: inputs must all be float32 or all "
                        f"bfloat16; got {[x.dtype for x in tensors]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention_cuda: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("flash_attention_cuda: inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(device):
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, S, H, KV, hd, int(causal),
                          int(q.dtype == torch.bfloat16),
                          torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: kernel launch failed with "
                           f"CUDA error {err}")
    launches += 1
    return out
