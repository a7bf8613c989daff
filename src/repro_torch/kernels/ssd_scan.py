"""K3, the Mamba-2 SSD intra-chunk block, on Hopper, and the chunked SSD
scan around it.

The chunked SSD algorithm (Dao & Gu 2024) splits the sequence into chunks of
length Q. Within a chunk the recurrence is a decay-masked (Q x Q) matrix
product — the intra-chunk block, which carries almost all the FLOPs and is
K3 — and across chunks a short linear recurrence carries the
``(nh, hp, N)`` state.

For the intra-chunk block three functions compute it:
  * :func:`ssd_intra_chunk_cuda` launches the hand-written CUDA kernel
    ``csrc/ssd_scan.cu``, which replaces the Pallas TPU kernel of
    ``repro/kernels/ssd_scan.py`` (``ssd_intra_chunk`` and its ``_kernel``);
    that source says what bounds it and how it is designed. Its products
    run on the TF32 tensor cores in the 3xTF32 split (each float32 operand
    as the sum of two TF32 values), which keeps float32 accuracy;
  * :func:`ssd_intra_chunk_plain` is the plain PyTorch version, the
    intra-chunk terms of ``repro.models.mamba2.ssd_chunked``;
  * :func:`ssd_intra_chunk` picks by the inputs' device: a CUDA tensor
    launches the kernel or raises, a CPU tensor runs the plain version.

K3 has no backward kernel yet (``ROADMAP.md`` queue 2). The kernel writes
its outputs through ``ctypes``, so they carry no autograd graph: where grad
mode is on and an input requires a gradient, :func:`ssd_intra_chunk_cuda`
raises ``NotImplementedError`` before it launches, rather than return a
result whose gradient would silently lack the intra-chunk terms. Under
``torch.no_grad`` or ``torch.inference_mode`` (serving) it launches; the
plain version on the CPU keeps its full autograd gradient.

:func:`ssd_chunked` is the host side around it (the ``seg`` cumsum, the
inter-chunk recurrence as a loop over chunks, ``y_inter`` and the ``D``
skip). It follows ``repro.models.mamba2.ssd_chunked``, dtype promotions
included: ``y_inter`` is rounded to x's dtype before it is added, which
``repro.kernels.ssd_scan.ssd_chunked_pallas`` does not do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_DIM = 128            # largest Q, hp and N the kernel takes
HEADS_PER_BLOCK = 32     # heads that share one C Bᵀ in the kernel

# Kernel launches made by ssd_intra_chunk_cuda since the count was last reset.
launches = 0


def ssd_intra_chunk_plain(x, dt, seg, Bm, Cm):
    """Plain PyTorch version of K3, on any device.

    x: (B,nc,Q,nh,hp) in any float dtype; dt, seg: (B,nc,Q,nh) and Bm, Cm:
    (B,nc,Q,N) in float32. Returns float32 ``(y_intra (B,nc,Q,nh,hp),
    state_in (B,nc,nh,hp,N), chunk_decay (B,nc,nh))``.
    """
    Q = x.shape[2]
    xf = x.float()
    # L[i,j] = exp(seg_i - seg_j) * dt_j for i >= j, selected (never masked
    # by a product: exp overflows above the diagonal, and inf * 0 is NaN)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # (B,nc,Q,Q,nh)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    Lmat = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bcin,bcjn->bcij", Cm, Bm)              # (B,nc,Q,Q)
    M = CB[..., None] * Lmat * dt[:, :, None, :, :]           # (B,nc,Q,Q,nh)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xf)
    # per-chunk state contribution: sum_j exp(seg_Q - seg_j) dt_j B_j x_j
    decay_out = torch.exp(seg[:, :, -1:, :] - seg)            # (B,nc,Q,nh)
    state_in = torch.einsum("bcjn,bcjhp->bchpn", Bm,
                            (dt * decay_out)[..., None] * xf)
    chunk_decay = torch.exp(seg[:, :, -1, :])                 # (B,nc,nh)
    return y_intra, state_in, chunk_decay


def ssd_intra_chunk(x, dt, seg, Bm, Cm):
    """K3 on the inputs' device: the kernel for CUDA, the plain version for
    the CPU."""
    if x.device.type == "cuda":
        return ssd_intra_chunk_cuda(x, dt, seg, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, seg, Bm, Cm)
    raise ValueError(f"ssd_intra_chunk: no implementation for device {x.device}")


@functools.cache
def _launcher():
    fn = _build.library("ssd_scan").ssd_intra_chunk_launch
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    fn.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, seg: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor):
    """Launch the CUDA kernel on the current stream of the inputs' device.

    Takes contiguous CUDA tensors on one device: x ``(B,nc,Q,nh,hp)`` in
    bfloat16 or float32, dt and seg ``(B,nc,Q,nh)`` and Bm, Cm ``(B,nc,Q,N)``
    in float32, with Q, hp and N at most ``MAX_DIM``. Raises
    ``NotImplementedError`` where a gradient is wanted (grad mode on and an
    input that requires one), since K3 has no backward kernel yet; raises on
    anything else and when the launch fails. Outputs as
    :func:`ssd_intra_chunk_plain`.
    """
    global launches
    if torch.is_grad_enabled() and (x.requires_grad or dt.requires_grad or seg.requires_grad
                                    or Bm.requires_grad or Cm.requires_grad):
        raise NotImplementedError(
            "ssd_intra_chunk_cuda: an input requires a gradient, and K3's backward "
            "kernel is not ported yet (ROADMAP.md queue 2, K3's backward); the "
            "kernel's outputs would carry no gradient. Run it under torch.no_grad() "
            "or torch.inference_mode(), or on CPU tensors for the plain version's "
            "gradient")
    if x.ndim != 5:
        raise ValueError(f"ssd_intra_chunk_cuda: x must be (B,nc,Q,nh,hp); got "
                         f"{tuple(x.shape)}")
    B, nc, Q, nh, hp = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, nc, Q, nh) or seg.shape != dt.shape
            or Bm.ndim != 4 or Bm.shape[:3] != (B, nc, Q) or Cm.shape != Bm.shape):
        raise ValueError("ssd_intra_chunk_cuda: dt and seg must be (B,nc,Q,nh) and "
                         f"Bm, Cm (B,nc,Q,N) for x {tuple(x.shape)}; got "
                         f"{tuple(dt.shape)}, {tuple(seg.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    tensors = (x, dt, seg, Bm, Cm)
    device = x.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("ssd_intra_chunk_cuda: inputs must lie on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != torch.float32 for t in tensors[1:])):
        raise TypeError("ssd_intra_chunk_cuda: x must be float32 or bfloat16 and "
                        "dt, seg, Bm, Cm float32; got "
                        f"{[t.dtype for t in tensors]}")
    if not (1 <= Q <= MAX_DIM and 1 <= hp <= MAX_DIM and 1 <= N <= MAX_DIM and nh):
        raise ValueError(f"ssd_intra_chunk_cuda: Q={Q}, hp={hp}, N={N}, nh={nh}; the "
                         f"kernel takes Q, hp and N from 1 to {MAX_DIM}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_intra_chunk_cuda: inputs must be contiguous")
    y = torch.empty((B, nc, Q, nh, hp), dtype=torch.float32, device=device)
    state = torch.empty((B, nc, nh, hp, N), dtype=torch.float32, device=device)
    decay = torch.empty((B, nc, nh), dtype=torch.float32, device=device)
    if B * nc == 0:
        return y, state, decay
    with torch.cuda.device(device):
        err = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                          dt.data_ptr(), seg.data_ptr(), Bm.data_ptr(),
                          Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                          decay.data_ptr(), B, nc, Q, nh, hp, N,
                          min(nh, HEADS_PER_BLOCK),
                          torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_cuda: kernel launch failed with "
                           f"CUDA error {err}")
    launches += 1
    return y, state, decay


def _ssd_chunked(intra, x, dt, A, Bm, Cm, D, chunk, initial_state):
    Bsz, S, nh, hp = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence length {S} is not a multiple "
                         f"of the chunk {Q}")
    nc = S // Q
    dt, Bm, Cm = dt.float(), Bm.float(), Cm.float()
    dtA = dt * A[None, None, :]                               # (B,S,nh)
    xc = x.reshape(Bsz, nc, Q, nh, hp).contiguous()
    dtc = dt.reshape(Bsz, nc, Q, nh).contiguous()
    seg = torch.cumsum(dtA.reshape(Bsz, nc, Q, nh), dim=2)    # (B,nc,Q,nh)
    Bc = Bm.reshape(Bsz, nc, Q, N).contiguous()
    Cc = Cm.reshape(Bsz, nc, Q, N).contiguous()

    y_intra, state_in, chunk_decay = intra(xc, dtc, seg, Bc, Cc)

    s = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, nh, hp, N), dtype=torch.float32, device=x.device))
    states = []                                               # state entering chunk c
    for c in range(nc):
        states.append(s)
        s = s * chunk_decay[:, c, :, None, None] + state_in[:, c]
    states = torch.stack(states, 1)                           # (B,nc,nh,hp,N)

    # inter-chunk output: C_i exp(seg_i) @ incoming state, in x's dtype
    y_inter = (torch.einsum("bcin,bchpn->bcihp", Cc, states)
               * torch.exp(seg)[..., None]).to(x.dtype)
    y = (y_intra + y_inter).reshape(Bsz, S, nh, hp)
    y = y + x * D[None, None, :, None]
    return y.to(x.dtype), s.to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int, initial_state=None):
    """Chunked state-space duality scan; K3 on CUDA tensors, its plain
    version on CPU tensors.

    x: (B,S,nh,hp)  dt: (B,S,nh)  A: (nh,)  Bm/Cm: (B,S,N)  D: (nh,)
    (dt, Bm and Cm are taken in float32, as ``mixer_forward`` gives them).
    Returns y: (B,S,nh,hp), final_state: (B,nh,hp,N), both in x's dtype.
    """
    return _ssd_chunked(ssd_intra_chunk, x, dt, A, Bm, Cm, D, chunk, initial_state)


def ssd_chunked_plain(x, dt, A, Bm, Cm, D, chunk: int, initial_state=None):
    """:func:`ssd_chunked` with the plain intra-chunk block on any device."""
    return _ssd_chunked(ssd_intra_chunk_plain, x, dt, A, Bm, Cm, D, chunk,
                        initial_state)
