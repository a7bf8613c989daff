"""The rounding of the tensor-core kernels K2 (bf16) and K3, emulated on the CPU.

The CUDA kernels run only on a GPU (``tests/test_torch_cuda.py``,
``chip_smoke.py``). What their designs decide about numbers can be shown
here, in plain torch, against the same limits the card holds them to:

* K3 runs its products as TF32 tensor-core products in the 3xTF32 split:
  each float32 operand ``a`` becomes ``a_hi = tf32(a)`` and
  ``a_lo = tf32(a - a_hi)``, and ``a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi``
  (two products where one side is a bf16 x, which TF32 holds exactly). That
  stays within ``hold_k3``'s 1e-4 of ``ssd_intra_chunk_plain``; one TF32
  product of rounded operands does not, so the limit tells the two apart.
* K2 in bf16 rounds its unnormalised probabilities P to bf16, tile by tile
  of 64 keys, for the P V product, and sums the rounded P. Measured as each
  output row's error over the row's magnitude against float32 on the same
  bf16 inputs, it stays within twice the bf16 plain version's, the limit of
  ``hold_k2``.

Products of TF32 values are exact in float32 (11 x 11 significant bits), so
a float32 product of rounded operands emulates one tensor-core product; the
sums run in another order than on the card.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

K3_TOL = 1e-4      # hold_k3: atol = rtol
K2_BLOCK = 64      # keys in one of K2's k tiles


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def halves(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def split_product(eq, a, b, a_exact=False, b_exact=False):
    """einsum in the 3xTF32 split; an exact side (a bf16 input) is not split,
    so the product takes two tensor-core products instead of three."""
    ah, al = (a.float(), None) if a_exact else halves(a)
    bh, bl = (b.float(), None) if b_exact else halves(b)
    out = torch.einsum(eq, ah, bh)
    if bl is not None:
        out = torch.einsum(eq, ah, bl) + out
    if al is not None:
        out = torch.einsum(eq, al, bh) + out
    return out


def single_product(eq, a, b):
    return torch.einsum(eq, tf32(a), tf32(b))


def ssd_emulated(x, dt, seg, Bm, Cm, split: bool):
    """K3's arithmetic: C Bᵀ, M x and the state product as TF32 products,
    split (``split``) or single; M formed in float32 as the kernel forms it."""
    Q = x.shape[2]
    product = split_product if split else (lambda eq, a, b, **_: single_product(eq, a, b))
    x_exact = x.dtype == torch.bfloat16
    xf = x.float()
    CB = product("bcin,bcjn->bcij", Cm, Bm)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    L = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0)
    M = CB[..., None] * L * dt[:, :, None, :, :]
    y = product("bcijh,bcjhp->bcihp", M, xf, b_exact=x_exact)
    w = dt * torch.exp(seg[:, :, -1:, :] - seg)
    state = product("bcjn,bcjhp->bchpn", Bm, w[..., None] * xf)
    return y, state, torch.exp(seg[:, :, -1, :])


def ssd_inputs(seed, B, nc, Q, nh, hp, N, xdtype):
    """K3's inputs as mixer_forward forms them (the distribution of
    ``chip_smoke.ssd_inputs``), made with numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = torch.from_numpy(rng.normal(size=(B, nc, Q, nh, hp)).astype(f)).to(xdtype)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.normal(size=(B, nc, Q, nh)).astype(f)) - 2.0)
    A = -torch.exp(0.5 * torch.from_numpy(rng.normal(size=nh).astype(f)))
    seg = torch.cumsum(dt * A, dim=2)
    Bm, Cm = (torch.from_numpy(rng.normal(size=(B, nc, Q, N)).astype(f)) for _ in range(2))
    return x, dt, seg, Bm, Cm


K3_SHAPES = [(1, 2, 128, 4, 64, 64, torch.bfloat16),   # the zamba2 prefill's chunk
             (1, 1, 33, 3, 12, 20, torch.float32),     # ragged tiles, float32 x
             (2, 1, 64, 4, 32, 16, torch.bfloat16)]


def test_tf32_split_holds_float32():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32)) * 100
    hi, lo = halves(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    # hi alone keeps 11 significant bits, hi + lo at least 22
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.abs().double() * 2.0 ** -22).all()
    bf = x.bfloat16().float()
    assert torch.equal(tf32(bf), bf)            # a bf16 value is exact in TF32
    assert tf32(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0 + 2.0 ** -10   # ties away


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", K3_SHAPES)
def test_k3_3xtf32_split_holds_the_float32_limit(B, nc, Q, nh, hp, N, xdtype):
    args = ssd_inputs(Q + N, B, nc, Q, nh, hp, N, xdtype)
    for got, want in zip(ssd_emulated(*args, split=True), ssd.ssd_intra_chunk_plain(*args)):
        torch.testing.assert_close(got, want, atol=K3_TOL, rtol=K3_TOL)


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", K3_SHAPES)
def test_k3_single_tf32_fails_the_float32_limit(B, nc, Q, nh, hp, N, xdtype):
    args = ssd_inputs(Q + N, B, nc, Q, nh, hp, N, xdtype)
    y, _, _ = ssd_emulated(*args, split=False)
    want = ssd.ssd_intra_chunk_plain(*args)[0]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(y, want, atol=K3_TOL, rtol=K3_TOL)
    # and by far: the largest error is many times the limit
    assert (y - want).abs().max() > 10 * K3_TOL


def flash_emulated(q, k, v, causal: bool):
    """K2's bf16 arithmetic: float32 scores of bf16 inputs, an online
    softmax over 64-key tiles, P rounded to bf16 for P V, l the sum of the
    rounded P, float32 accumulators, the output rounded to bf16."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    scale = hd ** -0.5
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, hd)
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, K2_BLOCK):
        kb, vb = kf[:, k0:k0 + K2_BLOCK], vf[:, k0:k0 + K2_BLOCK]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        if causal:
            s = torch.where(torch.arange(k0, k0 + kb.shape[1])[None, :] <= qpos, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).bfloat16().float()
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.transpose(1, 2).bfloat16()


def row_err(got, ref) -> float:
    """chip_smoke.row_err: the largest error of one output row over that
    row's own largest magnitude."""
    diff = (got.double() - ref.double()).abs().amax(-1)
    return float((diff / ref.double().abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 512, 4, 2, 64), (1, 2048, 2, 2, 64)])
def test_k2_bf16_p_holds_the_row_limit(B, S, H, KV, hd):
    rng = np.random.default_rng(S + H)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(np.float32)).bfloat16()
               for n in (H, KV, KV))
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    plain = row_err(fa.flash_attention_plain(q, k, v, causal=True), ref)
    got = row_err(flash_emulated(q, k, v, causal=True), ref)
    assert got <= 2 * plain, (got, plain)
    # bf16 P costs about one rounding of the output (2^-8), no more
    assert got < 4 * 2.0 ** -8, got
