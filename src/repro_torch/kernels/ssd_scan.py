"""K3, the Mamba-2 SSD intra-chunk block, on Hopper, and the chunked SSD
scan around it.

The chunked SSD algorithm (Dao & Gu 2024) splits the sequence into chunks of
length Q. Within a chunk the recurrence is a decay-masked (Q x Q) matrix
product — the intra-chunk block, which carries almost all the FLOPs and is
K3 — and across chunks a short linear recurrence carries the
``(nh, hp, N)`` state.

For the intra-chunk block:
  * :func:`ssd_intra_chunk_cuda` calls the ``torch.library`` op
    ``repro_torch::ssd_intra_chunk``, whose body launches the hand-written
    CUDA kernel
    ``csrc/ssd_scan.cu``, which replaces the Pallas TPU kernel of
    ``repro/kernels/ssd_scan.py`` (``ssd_intra_chunk`` and its ``_kernel``);
    that source says what bounds it and how it is designed: a producer
    warpgroup loads each head's x tile by TMA into a ring of stages, two
    consumer warpgroups run ``wgmma`` products with x as the bf16 operand
    and the float32 side (M, the state's (w B)ᵀ, C and B) split into three
    bf16 parts each, which keeps float32 accuracy, and y and the state
    leave by TMA stores that overlap the next head's products;
  * :func:`ssd_intra_chunk_bwd_cuda` calls ``repro_torch::ssd_intra_chunk_bwd``,
    whose body launches K3's backward, ``csrc/ssd_scan_bwd.cu``: a heads
    kernel on the forward's pattern (a producer warpgroup loads each head's
    x, dy and dS by TMA and forms dy's and dS's three bf16 parts, two
    consumer warpgroups run B dSᵀ, x dS and Mᵀ dy as bf16 ``wgmma``
    products over the lower triangle), in which dy xᵀ and C Bᵀ stay float64
    products on the tensor cores (``mma.sync`` m16n8k8), each entry rounded
    once to float32 (ddt and dseg, small differences of large sums, miss
    1e-4 of a float64 evaluation when those two products carry float32's
    rounding error, as :func:`ssd_intra_chunk_bwd_plain`'s do), and a
    block's sums over its 32 heads of dC Bᵀ and of the state's part of dB
    stay on chip until its last head; then a small kernel sums the head
    groups in order and forms dC and dB. The JAX package has no Pallas
    backward: it differentiates ``repro.models.mamba2.ssd_chunked``;
  * :func:`ssd_intra_chunk_plain` is the plain PyTorch version, the
    intra-chunk terms of ``repro.models.mamba2.ssd_chunked``, and
    :func:`ssd_intra_chunk_bwd_plain` the closed form of its gradient, which
    the backward kernel computes;
  * :class:`SSDIntraChunk` is the autograd function of the two kernels: it
    saves only the inputs, and its backward recomputes the rest;
  * :func:`ssd_intra_chunk` picks by the inputs' device: a CUDA tensor
    launches the kernels (through :class:`SSDIntraChunk` where grad mode is
    on and an input requires a gradient) or raises, a CPU tensor runs the
    plain version, whose gradient autograd takes.

As K2's (``kernels.flash_attention``), the two ops' bodies are the ctypes
launches with their checks and launch counts; each op has a fake (its
outputs' shapes and dtypes), which fake and meta tensors run, and a FLOP
formula (:func:`ssd_flops`, :func:`ssd_bwd_flops`).

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
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import no_dtensor

MAX_DIM = 128            # largest Q, hp and N the kernel takes
HEADS_PER_BLOCK = 16     # heads that share one C Bᵀ in the kernel (a block's)
BWD_HEADS_PER_BLOCK = 32 # heads whose partial sums one block of the backward keeps

# Kernel launches made by ssd_intra_chunk_cuda and ssd_intra_chunk_bwd_cuda
# since the counts were last reset.
launches = 0
bwd_launches = 0


def _decay(seg):
    """L[i,j] = exp(seg_i - seg_j) for i >= j and 0 above the diagonal,
    (B,nc,Q,Q,nh). The exponent is -inf above the diagonal before the exp:
    exp(seg_i - seg_j) overflows there, and selecting after the exp would
    give 0 * inf = NaN in the gradient (as jax.grad of
    repro.models.mamba2.ssd_chunked does)."""
    Q = seg.shape[2]
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=seg.device).tril()
    return torch.exp(torch.where(causal[None, None, :, :, None], diff, -torch.inf))


def ssd_intra_chunk_plain(x, dt, seg, Bm, Cm):
    """Plain PyTorch version of K3, on any device.

    x: (B,nc,Q,nh,hp) in any float dtype; dt, seg: (B,nc,Q,nh) and Bm, Cm:
    (B,nc,Q,N) in float32. Returns float32 ``(y_intra (B,nc,Q,nh,hp),
    state_in (B,nc,nh,hp,N), chunk_decay (B,nc,nh))``.
    """
    xf = x.float()
    Lmat = _decay(seg)                                        # (B,nc,Q,Q,nh)
    CB = torch.einsum("bcin,bcjn->bcij", Cm, Bm)              # (B,nc,Q,Q)
    M = CB[..., None] * Lmat * dt[:, :, None, :, :]           # (B,nc,Q,Q,nh)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xf)
    # per-chunk state contribution: sum_j exp(seg_Q - seg_j) dt_j B_j x_j
    decay_out = torch.exp(seg[:, :, -1:, :] - seg)            # (B,nc,Q,nh)
    state_in = torch.einsum("bcjn,bcjhp->bchpn", Bm,
                            (dt * decay_out)[..., None] * xf)
    chunk_decay = torch.exp(seg[:, :, -1, :])                 # (B,nc,nh)
    return y_intra, state_in, chunk_decay


def ssd_intra_chunk_bwd_plain(x, dt, seg, Bm, Cm, dy, dstate, ddecay):
    """Plain PyTorch version of K3's backward, on any device: the closed-form
    gradient of :func:`ssd_intra_chunk_plain`.

    Takes its inputs and the gradients of its three outputs (``dy``
    (B,nc,Q,nh,hp), ``dstate`` (B,nc,nh,hp,N), ``ddecay`` (B,nc,nh)) and
    returns ``(dx, ddt, dseg, dBm, dCm)``: dx in x's dtype, the rest in dt's
    (float32 on the kernels' path; float64 inputs give a float64
    evaluation). Per (b, c, h), with CB = C Bᵀ, L_ij = exp(seg_i - seg_j) and
    M_ij = CB_ij L_ij dt_j for i >= j, w_j = exp(seg_last - seg_j) dt_j and
    dS = dstate:

      dx_j  = sum_{i>=j} M_ij dy_i + w_j dS B_j
      K_ij  = (dy_i . x_j) CB_ij L_ij            (dM_ij = dy_i . x_j)
      dw_j  = x_j . dS B_j
      ddt_j = sum_i K_ij + dw_j exp(seg_last - seg_j)
      dseg_i = sum_j K_ij dt_j - dt_i sum_j K_ji - dw_i w_i,
               plus sum_j dw_j w_j + ddecay exp(seg_last) at i = last
      dCB_ij = sum_h dM_ij L_ij dt_j;  dC = dCB B;
      dB = dCBᵀ C + sum_h w_j x_jᵀ dS
    """
    xf = x.to(dt.dtype)
    Lmat = _decay(seg)                                        # (B,nc,Q,Q,nh)
    CB = torch.einsum("bcin,bcjn->bcij", Cm, Bm)              # (B,nc,Q,Q)
    dt_j = dt[:, :, None, :, :]                               # (B,nc,1,Q,nh)
    M = CB[..., None] * Lmat * dt_j
    dM = torch.einsum("bcihp,bcjhp->bcijh", dy, xf)
    decay_out = torch.exp(seg[:, :, -1:, :] - seg)            # (B,nc,Q,nh)
    w = decay_out * dt
    P = torch.einsum("bcjn,bchpn->bcjhp", Bm, dstate)        # dS B_j
    dx = torch.einsum("bcijh,bcihp->bcjhp", M, dy) + w[..., None] * P
    K = dM * CB[..., None] * Lmat
    colK = K.sum(2)                                           # over i
    dw = (xf * P).sum(-1)
    ddt = colK + dw * decay_out
    dseg = (K * dt_j).sum(3) - dt * colK - dw * w
    last = (dw * w).sum(2) + ddecay * torch.exp(seg[:, :, -1, :])
    dseg = torch.cat([dseg[:, :, :-1], dseg[:, :, -1:] + last[:, :, None]], dim=2)
    dCB = (dM * Lmat * dt_j).sum(-1)
    dC = torch.einsum("bcij,bcjn->bcin", dCB, Bm)
    dB = (torch.einsum("bcij,bcin->bcjn", dCB, Cm)
          + torch.einsum("bcjhp,bchpn->bcjn", w[..., None] * xf, dstate))
    return dx.to(x.dtype), ddt, dseg, dB, dC


class SSDIntraChunk(torch.autograd.Function):
    """K3 on the card with its gradient: the forward kernel, and the
    backward kernel, which recomputes C Bᵀ, L and M from the saved inputs
    ``(x, dt, seg, Bm, Cm)``."""

    @staticmethod
    def forward(ctx, x, dt, seg, Bm, Cm):
        ctx.save_for_backward(x, dt, seg, Bm, Cm)
        return ssd_intra_chunk_cuda(x, dt, seg, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstate, ddecay):
        return ssd_intra_chunk_bwd_cuda(*ctx.saved_tensors, dy.contiguous(),
                                        dstate.contiguous(), ddecay.contiguous())


def ssd_intra_chunk(x, dt, seg, Bm, Cm):
    """K3 on the inputs' device: the kernel for CUDA (differentiable through
    the backward kernel), the plain version for the CPU."""
    no_dtensor("ssd_intra_chunk", x, dt, seg, Bm, Cm)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, seg, Bm, Cm)):
            return SSDIntraChunk.apply(x, dt, seg, Bm, Cm)
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


def _dims(name, x, dt, seg, Bm, Cm, grads=()):
    """Raise unless x is ``(B,nc,Q,nh,hp)``, dt and seg ``(B,nc,Q,nh)``, Bm
    and Cm ``(B,nc,Q,N)`` and, for the backward, ``grads`` (dy, dstate,
    ddecay) ``(B,nc,Q,nh,hp)``, ``(B,nc,nh,hp,N)`` and ``(B,nc,nh)``.
    Returns (B, nc, Q, nh, hp, N)."""
    if x.ndim != 5:
        raise ValueError(f"{name}: x must be (B,nc,Q,nh,hp); got {tuple(x.shape)}")
    B, nc, Q, nh, hp = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, nc, Q, nh) or seg.shape != dt.shape
            or Bm.ndim != 4 or Bm.shape[:3] != (B, nc, Q) or Cm.shape != Bm.shape):
        raise ValueError(f"{name}: dt and seg must be (B,nc,Q,nh) and "
                         f"Bm, Cm (B,nc,Q,N) for x {tuple(x.shape)}; got "
                         f"{tuple(dt.shape)}, {tuple(seg.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if grads:
        want = ((B, nc, Q, nh, hp), (B, nc, nh, hp, N), (B, nc, nh))
        got = tuple(tuple(g.shape) for g in grads)
        if got != want:
            raise ValueError(f"{name}: dy, dstate and ddecay must be {want}; got {got}")
    return B, nc, Q, nh, hp, N


def _kernel_takes(name, tensors, Q, nh, hp, N) -> None:
    """Raise unless x (``tensors[0]``) is bfloat16 or float32 and the rest
    float32, with Q, hp and N from 1 to ``MAX_DIM``."""
    if (tensors[0].dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != torch.float32 for t in tensors[1:])):
        raise TypeError(f"{name}: x must be float32 or bfloat16 and "
                        "everything else float32; got "
                        f"{[t.dtype for t in tensors]}")
    if not (1 <= Q <= MAX_DIM and 1 <= hp <= MAX_DIM and 1 <= N <= MAX_DIM and nh):
        raise ValueError(f"{name}: Q={Q}, hp={hp}, N={N}, nh={nh}; the "
                         f"kernel takes Q, hp and N from 1 to {MAX_DIM}")


def _check(name, x, dt, seg, Bm, Cm, grads=()):
    """Raise unless the inputs (and, for the backward, ``grads``: dy, dstate,
    ddecay) are what the kernels take: contiguous CUDA tensors on one device
    of the shapes :func:`_dims` and the dtypes and sizes
    :func:`_kernel_takes` checks. Returns (B, nc, Q, nh, hp, N)."""
    no_dtensor(name, x, dt, seg, Bm, Cm, *grads)
    B, nc, Q, nh, hp, N = _dims(name, x, dt, seg, Bm, Cm, grads)
    tensors = (x, dt, seg, Bm, Cm, *grads)
    device = x.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: inputs must lie on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    _kernel_takes(name, tensors, Q, nh, hp, N)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return B, nc, Q, nh, hp, N


def ssd_flops(B: int, nc: int, Q: int, nh: int, hp: int, N: int) -> int:
    """K3's FLOP, from its three products over each (b, c) chunk, with
    T = Q(Q+1)/2 the pairs i >= j of the lower triangle:
    C Bᵀ, shared by the heads, 2·N a pair; M x per head, 2·hp a pair; the
    chunk's state contribution (w x)ᵀ B per head, 2·Q·hp·N. In all
    2·B·nc·(T·(N + nh·hp) + nh·Q·hp·N); the decay mask and exponentials are
    not counted, as ``torch.utils.flop_counter`` counts no elementwise op."""
    T = Q * (Q + 1) // 2
    return 2 * B * nc * (T * (N + nh * hp) + nh * Q * hp * N)


def ssd_bwd_flops(B: int, nc: int, Q: int, nh: int, hp: int, N: int) -> int:
    """K3's backward's FLOP, from its products over each (b, c) chunk (T as
    in :func:`ssd_flops`): per head dy xᵀ and Mᵀ dy over the lower
    triangle, 2·hp a pair each, and x dS and B dSᵀ, 2·Q·hp·N each; per
    chunk C Bᵀ, dC = dCB B and dB = dCBᵀ C over the triangle, 2·N a pair
    each. In all 2·B·nc·(nh·(2·T·hp + 2·Q·hp·N) + 3·T·N)."""
    T = Q * (Q + 1) // 2
    return 2 * B * nc * (nh * (2 * T * hp + 2 * Q * hp * N) + 3 * T * N)


def ssd_intra_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, seg: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor):
    """K3 through its op ``repro_torch::ssd_intra_chunk``: the CUDA kernel
    on the current stream of the inputs' device (the op's fake on fake and
    meta tensors).

    Takes contiguous CUDA tensors on one device: x ``(B,nc,Q,nh,hp)`` in
    bfloat16 or float32, dt and seg ``(B,nc,Q,nh)`` and Bm, Cm ``(B,nc,Q,N)``
    in float32, with Q, hp and N at most ``MAX_DIM``; raises on anything
    else and when the launch fails. Outputs as :func:`ssd_intra_chunk_plain`,
    with no autograd graph: :func:`ssd_intra_chunk` takes
    :class:`SSDIntraChunk` where a gradient is wanted.
    """
    no_dtensor("ssd_intra_chunk_cuda", x, dt, seg, Bm, Cm)
    return tuple(torch.ops.repro_torch.ssd_intra_chunk(x, dt, seg, Bm, Cm))


@torch.library.custom_op("repro_torch::ssd_intra_chunk", mutates_args=())
def _ssd_intra_chunk_launch(x: torch.Tensor, dt: torch.Tensor, seg: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's body: check, launch, count."""
    global launches
    B, nc, Q, nh, hp, N = _check("ssd_intra_chunk_cuda", x, dt, seg, Bm, Cm)
    device = x.device
    y, state, decay = _outputs(x, B, nc, Q, nh, hp, N)
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


def _outputs(x, B, nc, Q, nh, hp, N):
    """K3's float32 outputs, uninitialised: y, the chunk states, the decays."""
    return (x.new_empty((B, nc, Q, nh, hp), dtype=torch.float32),
            x.new_empty((B, nc, nh, hp, N), dtype=torch.float32),
            x.new_empty((B, nc, nh), dtype=torch.float32))


@_ssd_intra_chunk_launch.register_fake
def _(x, dt, seg, Bm, Cm):
    dims = _dims("ssd_intra_chunk_cuda", x, dt, seg, Bm, Cm)
    _kernel_takes("ssd_intra_chunk_cuda", (x, dt, seg, Bm, Cm), *dims[2:])
    return _outputs(x, *dims)


@register_flop_formula(torch.ops.repro_torch.ssd_intra_chunk)
def _(x_shape, *args, out_shape=None, **kwargs):
    return ssd_flops(*x_shape, args[2][-1])


@functools.cache
def _bwd_launcher():
    fn = _build.library("ssd_scan_bwd").ssd_intra_chunk_bwd_launch
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    fn.argtypes = [ptr, i32] + [ptr] * 13 + [i32] * 7 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk_bwd_cuda(x, dt, seg, Bm, Cm, dy, dstate, ddecay):
    """K3's backward through its op ``repro_torch::ssd_intra_chunk_bwd``:
    the backward kernels on the current stream of the inputs' device (the
    op's fake on fake and meta tensors). ``(dx, ddt, dseg, dBm, dCm)`` as
    :func:`ssd_intra_chunk_bwd_plain` gives them, from K3's inputs and the
    gradients of its outputs. Takes what :func:`ssd_intra_chunk_cuda` takes,
    and float32 ``dy``, ``dstate`` and ``ddecay`` of y's, state's and
    decay's shapes; raises on anything else and when a launch fails."""
    no_dtensor("ssd_intra_chunk_bwd_cuda", x, dt, seg, Bm, Cm, dy, dstate, ddecay)
    return tuple(torch.ops.repro_torch.ssd_intra_chunk_bwd(x, dt, seg, Bm, Cm, dy,
                                                           dstate, ddecay))


@torch.library.custom_op("repro_torch::ssd_intra_chunk_bwd", mutates_args=())
def _ssd_intra_chunk_bwd_launch(
        x: torch.Tensor, dt: torch.Tensor, seg: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, dy: torch.Tensor, dstate: torch.Tensor, ddecay: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's body: check, launch, count."""
    global bwd_launches
    B, nc, Q, nh, hp, N = _check("ssd_intra_chunk_bwd_cuda", x, dt, seg, Bm, Cm,
                                 (dy, dstate, ddecay))
    device = x.device
    dx, ddt, dseg, dBm, dCm = (torch.empty_like(t) for t in (x, dt, seg, Bm, Cm))
    if B * nc == 0:
        return dx, ddt, dseg, dBm, dCm
    heads = min(nh, BWD_HEADS_PER_BLOCK)
    groups = -(-nh // heads)
    # each head group's partial sums over its heads, written once by the
    # heads kernel and summed by the dC/dB kernel: dC Bᵀ (Q, Q), then the
    # state's part of dB (Q, N)
    scratch = torch.empty((B * nc * groups * Q * (Q + N),), dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        err = _bwd_launcher()(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            *(t.data_ptr() for t in (dt, seg, Bm, Cm, dy, dstate, ddecay, dx, ddt,
                                     dseg, dBm, dCm, scratch)),
            B, nc, Q, nh, hp, N, heads, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_bwd_cuda: kernel launch failed with "
                           f"CUDA error {err}")
    bwd_launches += 1
    return dx, ddt, dseg, dBm, dCm


@_ssd_intra_chunk_bwd_launch.register_fake
def _(x, dt, seg, Bm, Cm, dy, dstate, ddecay):
    dims = _dims("ssd_intra_chunk_bwd_cuda", x, dt, seg, Bm, Cm, (dy, dstate, ddecay))
    _kernel_takes("ssd_intra_chunk_bwd_cuda", (x, dt, seg, Bm, Cm, dy, dstate, ddecay),
                  *dims[2:])
    return tuple(torch.empty_like(t) for t in (x, dt, seg, Bm, Cm))


@register_flop_formula(torch.ops.repro_torch.ssd_intra_chunk_bwd)
def _(x_shape, *args, out_shape=None, **kwargs):
    return ssd_bwd_flops(*x_shape, args[2][-1])


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
