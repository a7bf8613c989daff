"""The rounding of the tensor-core kernels K2 (bf16) and K3, emulated on the CPU.

The CUDA kernels run only on a GPU (``tests/test_torch_cuda.py``,
``chip_smoke.py``). What their designs decide about numbers can be shown
here, in plain torch, against the same limits the card holds them to:

* K3 runs its products as bf16 ``wgmma`` products: x, in bf16, is exact,
  and each float32 side (M, the state's (w B)ᵀ, C and B, and a float32 x)
  is the sum of three bf16 parts: ``v0`` and ``v1`` the truncations of ``v``
  and of ``v - v0`` (their high 16 bits), ``v2`` the rounding of
  ``v - v0 - v1``; a product of two split sides keeps the pairs of parts
  (p, q) with p + q <= 2. Emulated k step by k step as issued, that stays
  within ``hold_k3``'s 1e-4 of ``ssd_intra_chunk_plain``; two parts of M
  (a truncation and a rounding) miss it, and one part misses it by far. The TF32 route (the 3xTF32 split: each float32
  operand ``a`` as ``a_hi = tf32(a)`` and ``a_lo = tf32(a - a_hi)``, and
  ``a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi``, two products where one side
  is a bf16 x, which TF32 holds exactly), which both K3 kernels took before
  their wgmma redesigns, holds the limit too; one TF32 product of rounded
  operands does not.
* K3's backward runs its per-head products (B dSᵀ, x dS, Mᵀ dy) as bf16
  wgmma products in the same three-part split, each k step's sum rounded
  toward zero, and C Bᵀ and dM = dy xᵀ in float64, each entry rounded once
  to float32. It stays within ``hold_k3_backward``'s 1e-4 of
  ``ssd_intra_chunk_bwd_plain`` evaluated in float64 (float32 gradients)
  and its bf16 row rule; one bf16 part misses it by far, two miss it over a
  chunk of 128. Its earlier 3xTF32 route held it too, single TF32 products
  missed it by far, and so do C Bᵀ and dM in 3xTF32, over enough
  gradients: the reason both routes keep those two products in float64.
* K2 in bf16 rounds its unnormalised probabilities P to bf16, tile by tile
  of 128 keys (64 at hd 192; 64 before the wgmma kernels), for the P V
  product, and sums the rounded P. Measured as each
  output row's error over the row's magnitude against float32 on the same
  bf16 inputs, it stays within twice the bf16 plain version's, the limit of
  ``hold_k2``.
* K2's backward in bf16 recomputes P from the forward's log-sum-exp,
  renormalises it (D = sum P dP / l and lse' = lse + ln l from a first walk
  over the keys), and rounds dS and P to bf16 as the A operands of its
  products. Each gradient's worst row error stays within twice the bf16
  plain gradient's (or one bf16 ulp), the limit of ``hold_k2_backward``.
  D taken from the bf16 output, or P left unrenormalised, misses that limit
  on inputs pinned below, where the design holds.

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
K2_BLOCK = 64      # keys in one of K2's k tiles before the wgmma kernels, and the backward's


def k2_block(hd: int) -> int:
    """Keys in one k tile of K2's wgmma forward (``FwdTiles::BN``): 128, and
    64 at hd 192, where the output's 96 accumulators a thread leave no room
    for a 128-key score tile."""
    return 64 if hd > 128 else 128


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
    """K3's function by the TF32 route: C Bᵀ, M x and the state product as
    TF32 products, split (``split``, 3xTF32, as K3's backward issues its
    products) or single; M formed in float32."""
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


def ssd_inputs(seed, B, nc, Q, nh, hp, N, xdtype, dt_shift=2.0):
    """K3's inputs as mixer_forward forms them (the distribution of
    ``chip_smoke.ssd_inputs``: dt = softplus(z - ``dt_shift``)), made with
    numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = torch.from_numpy(rng.normal(size=(B, nc, Q, nh, hp)).astype(f)).to(xdtype)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.normal(size=(B, nc, Q, nh)).astype(f)) - dt_shift)
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


# ---------------------------------------------------------------------------
# K3's forward (csrc/ssd_scan.cu), product by product as the kernel issues
# them: wgmma with bf16 operands, each k step of 16 adding the exact sum of
# its products to the float32 accumulator, rounded toward zero (as
# ``mma_chain`` below models the tensor cores), the pairs of parts of one k
# step one after another, smallest first. C Bᵀ (once a chunk): C's and B's
# three parts, the six pairs with p + q <= 2, over N. Per head M = C Bᵀ L dt
# formed in float32 (one exp an entry, 0 above the diagonal), split in
# three, against x: a bf16 x is one exact part, a float32 x three (the six
# pairs again). The state transposed, (w B)ᵀ x, w_j = dt_j exp(seg_last -
# seg_j), w B formed in float32 and split the same way. Emulated over the
# whole k range: the kernel skips the k steps above the diagonal, whose
# products are all 0 and leave a truncated sum as it is.
# ---------------------------------------------------------------------------


def bf16_parts(v: torch.Tensor, n: int = 3):
    """float32 ``v`` as ``n`` bf16 parts as ``split3_bf16`` forms them: each
    but the last the truncation (the high 16 bits) of what the earlier ones
    leave, the last its rounding (every difference exact in float32)."""
    parts, rest = [], v.float()
    for k in range(n):
        if k < n - 1:
            part = (rest.contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32)
        else:
            part = rest.bfloat16().float()
        parts.append(part)
        rest = rest - part
    return parts


SPLIT_PAIRS = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]   # the kernel's issue order


def wgmma_chain(eq, a_parts, b_parts, pairs, k=16, acc=None):
    """einsum ``eq`` (one contracted index) as the kernel's chain of bf16
    wgmma products: per k step of ``k``, for each pair (p, q) of ``pairs`` in
    order, the exact sum of ``a_parts[p]`` times ``b_parts[q]`` over the step
    added to the float32 accumulator (``acc``, else zeros) and rounded
    toward zero."""
    ins, _ = eq.split("->")
    ea, eb = ins.split(",")
    c = next(c for c in ea if c in eb and c not in eq.split("->")[1])
    ia, ib, K = ea.index(c), eb.index(c), a_parts[0].shape[ea.index(c)]
    for k0 in range(0, K, k):
        n = min(k, K - k0)
        for p, q in pairs:
            term = torch.einsum(eq, a_parts[p].narrow(ia, k0, n).double(),
                                b_parts[q].narrow(ib, k0, n).double())
            acc = round_toward_zero((0.0 if acc is None else acc.double()) + term)
    return acc


def ssd_wgmma_emulated(x, dt, seg, Bm, Cm, m_parts: int = 3):
    """(y, state, decay) as csrc/ssd_scan.cu computes them, with ``m_parts``
    bf16 parts of M and of (w B)ᵀ (the kernel's 3)."""
    Q = x.shape[2]
    if x.dtype == torch.bfloat16:
        xp, pairs = [x.float()], [(p, 0) for p in range(m_parts - 1, -1, -1)]
    else:
        xp, pairs = bf16_parts(x), [pq for pq in SPLIT_PAIRS if pq[0] < m_parts]
    CB = wgmma_chain("bcin,bcjn->bcij", bf16_parts(Cm), bf16_parts(Bm), SPLIT_PAIRS)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    M = CB[..., None] * L * dt[:, :, None, :, :]                  # (B,nc,i,j,nh)
    y = wgmma_chain("bcijh,bcjhp->bcihp", bf16_parts(M, m_parts), xp, pairs)
    w = dt * torch.exp(seg[:, :, -1:, :] - seg)                     # (B,nc,j,nh)
    wB = w[..., None] * Bm[:, :, :, None, :]                        # (B,nc,j,nh,N)
    state = wgmma_chain("bcjhn,bcjhp->bchpn", bf16_parts(wB, m_parts), xp, pairs)
    return y, state, torch.exp(seg[:, :, -1, :])


def k3_over(got, want):
    """The largest error of each output over ``hold_k3``'s limit (atol =
    rtol = 1e-4); above 1 is a miss."""
    return [float(((g.double() - w.double()).abs() / (K3_TOL + K3_TOL * w.double().abs())).max())
            for g, w in zip(got, want)]


# the edges of the wgmma tiles: Q 128 with hp 64 over two 64-row
# warpgroups is K3_SHAPES' first; a ragged Q across the 64-row boundary;
# hp and N of two halves with a float32 x
K3_TILE_EDGES = [(1, 2, 100, 3, 64, 64, torch.bfloat16),
                 (1, 1, 128, 2, 128, 128, torch.float32)]


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", K3_SHAPES + K3_TILE_EDGES)
def test_k3_bf16_split_holds_the_float32_limit(B, nc, Q, nh, hp, N, xdtype):
    args = ssd_inputs(Q + N, B, nc, Q, nh, hp, N, xdtype)
    over = k3_over(ssd_wgmma_emulated(*args), ssd.ssd_intra_chunk_plain(*args))
    assert max(over) < 0.5, over        # within half the limit


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", K3_SHAPES)
def test_k3_one_bf16_part_fails_the_float32_limit(B, nc, Q, nh, hp, N, xdtype):
    args = ssd_inputs(Q + N, B, nc, Q, nh, hp, N, xdtype)
    y_over = k3_over(ssd_wgmma_emulated(*args, m_parts=1), ssd.ssd_intra_chunk_plain(*args))[0]
    assert y_over > 10, y_over          # by far


@pytest.mark.parametrize("dt_shift", [2.0, 0.0])
def test_k3_two_bf16_parts_miss_the_float32_limit(dt_shift):
    """Two bf16 parts of M (a truncation, then a rounding) leave 2^-16 of
    each entry, against three's 2^-23: at zamba2's chunk with 32 heads they
    miss the limit, where three parts stay within half of it on the same
    inputs, at ``chip_smoke.ssd_inputs``' dt, softplus(z - 2), and at the
    larger steps of softplus(z)."""
    shape = (2, 4, 128, 32, 64, 64)
    args = ssd_inputs(0, *shape, torch.bfloat16, dt_shift=dt_shift)
    want = ssd.ssd_intra_chunk_plain(*args)
    two = k3_over(ssd_wgmma_emulated(*args, m_parts=2), want)
    three = k3_over(ssd_wgmma_emulated(*args, m_parts=3), want)
    assert two[0] > 1.0 and max(three) < 0.5, (two, three)


# ---------------------------------------------------------------------------
# K3's backward (csrc/ssd_scan_bwd.cu), product by product as the kernels
# issue them. Since its wgmma redesign (``ssd_bwd_wgmma``): bf16 products,
# k steps of 16, the pairs of three parts in SPLIT_PAIRS' order (x dS: x
# exact against dS's parts, smallest first), each step's exact sum added to
# the float32 accumulator and rounded toward zero; dx's accumulator starts
# as w_j T_j; C Bᵀ and dM in float64, rounded once; dC and dB by float32
# FMAs. Before it (``ssd_bwd_emulated``'s TF32 modes, kept for the route's
# record and for the float64 decision below): In TF32, mma.sync m16n8k8 over k in steps of 8,
# each step's TF32 products (lo.hi, hi.lo, then hi.hi in the 3xTF32 split;
# the bf16 x exact, against dS's lo then hi) added to the float32
# accumulator one mma at a time. The tensor cores form each mma's sum
# exactly and round it toward zero (the accumulation studies of NVIDIA's
# tensor cores report truncation), which is emulated here; a chain of them
# is biased toward zero. In TF32: per head T = B dSᵀ (each k step's
# products from zero, added in float32), dw_j =
# x_j . T_j and dx's state part w_j T_j; R = x dS and dB's state part
# w_j R_j summed over heads; dx = w T + Mᵀ dy in the same accumulator; per
# chunk dC = dC Bᵀ B and dB = dC Bᵀᵀ C + (the state part). In float64 on the
# tensor cores, each entry rounded once to float32: C Bᵀ and dM = dy xᵀ,
# whose rounding carries most of ddt's and dseg's error against a float64
# evaluation. Formed in 3xTF32 instead, ddt's worst error comes to about
# five times the design's, and crosses the limit only somewhere in some
# 10^5 gradients (the largest error over many small ones): on the card, over
# the training shape's 524,288, the 3xTF32 kernel missed by 1.56 times the
# limit; here, 98,304 gradients in three draws show a miss (by 1.33), a
# single draw of 32,768 shows one only now and then. Then one exp
# per (i, j) for L, shared by M = C Bᵀ L dt_j, K = dM C Bᵀ L and dC Bᵀ's
# dM L dt_j; the column sums of K in float64, the row sums and the dseg
# difference in float32.
# ---------------------------------------------------------------------------


def round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mma_chain(eq, a, b, a_exact=False, b_exact=False, split=True, acc=None, fresh=False):
    """einsum ``eq`` (one contracted index) as a chain of tensor-core
    products: per k step of 8 the TF32 products, in the kernels' order, each
    added to the float32 accumulator (``acc``, else zeros) exactly and
    rounded toward zero. ``split``: 3xTF32 (two products with an exact
    side), else one product of rounded operands. ``fresh``: each k step's
    products start from zero, and the step is added to ``acc`` in float32."""
    ins, out = eq.split("->")
    ea, eb = ins.split(",")
    k = next(c for c in ea if c in eb and c not in out)
    ia, ib, K = ea.index(k), eb.index(k), a.shape[ea.index(k)]
    for k0 in range(0, K, 8):
        ac, bc = a.narrow(ia, k0, min(8, K - k0)), b.narrow(ib, k0, min(8, K - k0))
        if split:
            ah, al = (ac.float(), None) if a_exact else halves(ac)
            bh, bl = (bc.float(), None) if b_exact else halves(bc)
            pairs = [(x, y) for x, y in ((al, bh), (ah, bl), (ah, bh))
                     if x is not None and y is not None]
        else:
            pairs = [(ac.float() if a_exact else tf32(ac), bc.float() if b_exact else tf32(bc))]
        step = None if fresh else acc
        for x, y in pairs:
            term = torch.einsum(eq, x.double(), y.double())
            step = round_toward_zero((0.0 if step is None else step.double()) + term)
        acc = (step if acc is None else acc + step) if fresh else step
    return acc


def ssd_bwd_emulated(x, dt, seg, Bm, Cm, dy, dstate, ddecay, split: bool = True,
                     float64_products: bool = True, wgmma_parts: int | None = None):
    """(dx, ddt, dseg, dB, dC) as K3's backward kernels compute them.
    ``wgmma_parts`` set: the kernel's route (csrc/ssd_scan_bwd.cu), its
    float32 products as bf16 wgmma products with each float32 side in that
    many bf16 parts (the kernel's 3; see ``ssd_bwd_wgmma``). Else the route
    the kernel took before its wgmma redesign: its TF32 products (mma.sync)
    split (``split``, 3xTF32) or single. ``float64_products``: C Bᵀ and dM in
    float64, rounded once, as both routes form them; else as TF32 products
    too."""
    if wgmma_parts is not None:
        return ssd_bwd_wgmma(x, dt, seg, Bm, Cm, dy, dstate, ddecay, wgmma_parts)
    Q = x.shape[2]
    x_exact = x.dtype == torch.bfloat16
    xf = x.float()
    if float64_products:
        CB = torch.einsum("bcin,bcjn->bcij", Cm.double(), Bm.double()).float()
        dM = torch.einsum("bcihp,bcjhp->bcijh", dy.double(), xf.double()).float()
    else:
        CB = mma_chain("bcin,bcjn->bcij", Cm, Bm, split=split)
        dM = mma_chain("bcihp,bcjhp->bcijh", dy, xf, b_exact=x_exact, split=split)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # (B,nc,i,j,nh)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    dt_j = dt[:, :, None, :, :]
    e = torch.exp(seg[:, :, -1:, :] - seg)
    w = e * dt
    T = mma_chain("bcjn,bchpn->bcjhp", Bm, dstate, split=split, fresh=True)
    dw = (xf * T).sum(-1)
    R = mma_chain("bcjhp,bchpn->bcjhn", xf, dstate, a_exact=x_exact, split=split)
    M = CB[..., None] * (L * dt_j)
    dx = mma_chain("bcijh,bcihp->bcjhp", M, dy, split=split, acc=w[..., None] * T)
    K = dM * CB[..., None] * L
    colK = K.double().sum(2).float()
    ddt = colK + dw * e
    dseg = (K * dt_j).sum(3) - dt * colK - dw * w
    last = (dw * w).sum(2) + ddecay * torch.exp(seg[:, :, -1, :])
    dseg = torch.cat([dseg[:, :, :-1], dseg[:, :, -1:] + last[:, :, None]], dim=2)
    dCB = (dM * (L * dt_j)).sum(-1)
    dC = mma_chain("bcij,bcjn->bcin", dCB, Bm, split=split)
    dB = mma_chain("bcij,bcin->bcjn", dCB, Cm, split=split) + (w[..., None] * R).sum(3)
    return dx.to(x.dtype), ddt, dseg, dB, dC


def split_pairs(parts: int, a_exact: bool = False):
    """The pairs of parts the kernel issues for a product of two sides split
    in ``parts`` bf16 parts (SPLIT_PAIRS' order), or of an exact bf16 side
    (``a_exact``: one part, 0) against a split one (smallest first)."""
    if a_exact:
        return [(0, q) for q in range(parts - 1, -1, -1)]
    return [pq for pq in SPLIT_PAIRS if max(pq) < parts]


def ssd_bwd_wgmma(x, dt, seg, Bm, Cm, dy, dstate, ddecay, parts: int = 3,
                  dw_from_t: bool = False):
    """(dx, ddt, dseg, dB, dC) as csrc/ssd_scan_bwd.cu computes them, with
    ``parts`` bf16 parts of each float32 side of its wgmma products (the
    kernel's 3). C Bᵀ and dM = dy xᵀ in float64, rounded once (mma.sync).
    Per head, k steps of 16, the pairs in issue order, each step's exact sum
    added to the float32 accumulator and rounded toward zero: T = B dSᵀ over
    N (B's and dS's parts), scaled by w_j in float32 into dx, which then
    takes M^T dy over i (M's and dy's parts); R = x dS over hp (a bf16 x
    exact, a float32 x split too), w_j R_j summed over the heads in float32,
    and dw_j = B_j . R_j (``dw_from_t``: x_j . T_j, which misses ddt's limit
    at N 128, T's chain of truncated sums being 8 k steps long there).
    Then K, the row and column sums, dC B^T as in ``ssd_bwd_emulated``, and
    dC = dCB B, dB = dCBᵀ C + (the state part) in float32 (the dC/dB kernel's
    FMAs)."""
    Q, hp = x.shape[2], x.shape[-1]
    x_exact = x.dtype == torch.bfloat16
    xf = x.float()
    xp = [xf] if x_exact else bf16_parts(xf, parts)
    CB = torch.einsum("bcin,bcjn->bcij", Cm.double(), Bm.double()).float()
    dM = torch.einsum("bcihp,bcjhp->bcijh", dy.double(), xf.double()).float()
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # (B,nc,i,j,nh)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    dt_j = dt[:, :, None, :, :]
    e = torch.exp(seg[:, :, -1:, :] - seg)
    w = e * dt
    pairs = split_pairs(parts)
    T = wgmma_chain("bcjn,bchpn->bcjhp", bf16_parts(Bm, parts), bf16_parts(dstate, parts), pairs)
    M = CB[..., None] * (L * dt_j)                            # (B,nc,i,j,nh)
    dx = wgmma_chain("bcijh,bcihp->bcjhp", bf16_parts(M, parts), bf16_parts(dy, parts), pairs,
                     acc=w[..., None] * T)
    # R over each half of hp in a fresh accumulator, w_j R_j added per half;
    # dw_j = x_j . T_j taken as B_j . R_j (R's short chains)
    R_pairs = split_pairs(parts, a_exact=x_exact)
    dBs = dw = None
    for p0 in range(0, hp, 64):
        sl = slice(p0, min(hp, p0 + 64))
        R = wgmma_chain("bcjhp,bchpn->bcjhn", [v[..., sl] for v in xp],
                        bf16_parts(dstate[..., sl, :], parts), R_pairs)
        term, dw_half = w[..., None] * R, (Bm[:, :, :, None, :] * R).sum(-1)
        dBs = term if dBs is None else dBs + term
        dw = dw_half if dw is None else dw + dw_half
    if dw_from_t:
        dw = (xf * T).sum(-1)
    K = dM * CB[..., None] * L
    colK = K.double().sum(2).float()
    ddt = colK + dw * e
    dseg = (K * dt_j).sum(3) - dt * colK - dw * w
    last = (dw * w).sum(2) + ddecay * torch.exp(seg[:, :, -1, :])
    dseg = torch.cat([dseg[:, :, :-1], dseg[:, :, -1:] + last[:, :, None]], dim=2)
    dCB = (dM * (L * dt_j)).sum(-1)
    dC = torch.einsum("bcij,bcjn->bcin", dCB, Bm)
    dB = torch.einsum("bcij,bcin->bcjn", dCB, Cm) + dBs.sum(3)
    return dx.to(x.dtype), ddt, dseg, dB, dC


def ssd_output_grads(seed, B, nc, Q, nh, hp, N):
    """Gradients of y, state and decay (``chip_smoke.ssd_output_grads``)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((B, nc, Q, nh, hp), (B, nc, nh, hp, N), (B, nc, nh))]


def k3_backward_over(got, args, grads):
    """Each gradient's largest error over ``chip_smoke.hold_k3_backward``'s
    limit: float32 ones at atol/rtol 1e-4 against the plain closed form
    evaluated in float64, a bf16 dx by the row rule (its worst row error
    against the plain backward run on the same values in float32 over twice
    the bf16 plain one's, or one bf16 ulp). Above 1 is a miss."""
    want = ssd.ssd_intra_chunk_bwd_plain(*args, *grads)
    exact = ssd.ssd_intra_chunk_bwd_plain(*(t.double() for t in (*args, *grads)))
    over = {}
    for name, g, w, e in zip(("dx", "ddt", "dseg", "dB", "dC"), got, want, exact):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all(), name
        if g.dtype == torch.float32:
            over[name] = float(((g.double() - e).abs() / (K3_TOL + K3_TOL * e.abs())).max())
    if args[0].dtype == torch.bfloat16:
        ref = ssd.ssd_intra_chunk_bwd_plain(args[0].float(), *args[1:], *grads)[0]
        over["dx"] = row_err(got[0], ref) / max(2 * row_err(want[0], ref), 2.0 ** -8)
    return over


def k3_backward_misses(got, args, grads):
    """The gradients that miss ``hold_k3_backward``'s contract: {name: largest
    error over the limit}."""
    return {k: v for k, v in k3_backward_over(got, args, grads).items() if v > 1.0}


K3_BWD_SHAPES = [(1, 1, 128, 2, 64, 64, torch.bfloat16),   # zamba2's chunk, two heads
                 (1, 2, 128, 1, 64, 128, torch.bfloat16),  # mamba2-780m's N
                 (1, 1, 128, 2, 128, 128, torch.float32),  # hp = N = Q = 128, float32 x
                 (1, 1, 33, 3, 12, 20, torch.float32),     # ragged tiles
                 (2, 1, 64, 2, 32, 16, torch.bfloat16)]


def k3_backward_case(B, nc, Q, nh, hp, N, xdtype):
    """Inputs and output gradients of a K3_BWD_SHAPES case, made with numpy."""
    return (ssd_inputs(Q + N + nh, B, nc, Q, nh, hp, N, xdtype),
            ssd_output_grads(Q + hp, B, nc, Q, nh, hp, N))


# mamba2-780m's chunk (N 128) with 48 heads: enough gradients to show dw's
# error through T (``test_k3_backward_dw_from_t_misses_the_limit``)
K3_BWD_N128_HEADS = (1, 4, 128, 48, 64, 128, torch.bfloat16)


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", K3_BWD_SHAPES + [K3_BWD_N128_HEADS])
def test_k3_backward_bf16_parts_hold_the_limit(B, nc, Q, nh, hp, N, xdtype):
    """The kernel's route: three bf16 parts of each float32 side of its
    wgmma products, dy xᵀ and C Bᵀ in float64 rounded once; every gradient
    within half of ``hold_k3_backward``'s limit (a bf16 dx's row error within
    the plain version's)."""
    args, grads = k3_backward_case(B, nc, Q, nh, hp, N, xdtype)
    over = k3_backward_over(ssd_bwd_emulated(*args, *grads, wgmma_parts=3), args, grads)
    assert max(over.values()) <= 0.5, over


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", K3_BWD_SHAPES)
def test_k3_backward_one_bf16_part_fails_the_limit(B, nc, Q, nh, hp, N, xdtype):
    """One bf16 part of each float32 side (its truncation to bf16): some
    float32 gradient misses the limit by more than ten times."""
    args, grads = k3_backward_case(B, nc, Q, nh, hp, N, xdtype)
    misses = k3_backward_misses(ssd_bwd_emulated(*args, *grads, wgmma_parts=1), args, grads)
    assert max(misses.values(), default=0.0) > 10, misses


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", [
    (2, 4, 128, 32, 64, 64, torch.bfloat16),     # zamba2's chunk, 32 heads
    K3_BWD_N128_HEADS,                           # mamba2-780m's, 48 heads
    (1, 1, 128, 2, 128, 128, torch.float32)])    # hp = N = Q = 128, float32 x
def test_k3_backward_two_bf16_parts_miss_the_limit(B, nc, Q, nh, hp, N, xdtype):
    """Two bf16 parts (a truncation, then a rounding: 2^-16 of each value
    left, against three parts' 2^-23) miss the limit over full chunks of
    128 with many heads (ddt and dseg at a bf16 x, dx at a float32 x), where
    three stay within half of it on the same inputs. (With one or two bf16
    heads at N 64, K3_BWD_SHAPES' first, two parts stay within it.)"""
    args, grads = k3_backward_case(B, nc, Q, nh, hp, N, xdtype)
    two = k3_backward_over(ssd_bwd_emulated(*args, *grads, wgmma_parts=2), args, grads)
    three = k3_backward_over(ssd_bwd_emulated(*args, *grads, wgmma_parts=3), args, grads)
    if xdtype == torch.bfloat16:   # a bf16 dx's entry is the row rule's ratio, not a float32 limit
        del two["dx"], three["dx"]
    assert max(two.values()) > 1.0 and max(three.values()) < 0.5, (two, three)


def test_k3_backward_dw_from_t_misses_the_limit():
    """dw_j = x_j . T_j, with T = B dSᵀ a chain of 8 k steps of truncated
    sums at N 128, misses ddt's limit at mamba2-780m's chunk with 48 heads;
    B_j . R_j, R = x dS's chains of 4 (x exact), holds it within half, on the
    same inputs."""
    args = ssd_inputs(0, *K3_BWD_N128_HEADS)
    grads = ssd_output_grads(7, *K3_BWD_N128_HEADS[:-1])
    from_t = k3_backward_over(ssd_bwd_wgmma(*args, *grads, dw_from_t=True), args, grads)
    from_r = k3_backward_over(ssd_bwd_wgmma(*args, *grads), args, grads)
    assert from_t["ddt"] > 1.0 and from_r["ddt"] < 0.5, (from_t, from_r)


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", K3_BWD_SHAPES)
def test_k3_backward_3xtf32_split_holds_the_limit(B, nc, Q, nh, hp, N, xdtype):
    """The route of the kernel before its wgmma redesign (mma.sync TF32 in
    the 3xTF32 split) held the limit too."""
    args = ssd_inputs(Q + N + nh, B, nc, Q, nh, hp, N, xdtype)
    grads = ssd_output_grads(Q + hp, B, nc, Q, nh, hp, N)
    got = ssd_bwd_emulated(*args, *grads, split=True)
    assert k3_backward_misses(got, args, grads) == {}


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", K3_BWD_SHAPES)
def test_k3_backward_single_tf32_fails_the_limit(B, nc, Q, nh, hp, N, xdtype):
    """Single TF32 products on that route failed it by far."""
    args = ssd_inputs(Q + N + nh, B, nc, Q, nh, hp, N, xdtype)
    grads = ssd_output_grads(Q + hp, B, nc, Q, nh, hp, N)
    misses = k3_backward_misses(ssd_bwd_emulated(*args, *grads, split=False), args, grads)
    # and by far: some float32 gradient misses by many times its limit
    assert max(misses.values(), default=0.0) > 10, misses


def test_k3_backward_3xtf32_cb_and_dm_miss_the_limit():
    """C Bᵀ and dM in 3xTF32 (each mma's sum truncated) instead of rounded
    once from float64, on the 3xTF32 route the kernel took before its wgmma
    redesign: over three draws at zamba2's chunk with 32 heads, ddt or dseg
    misses the float64 1e-4, where float64 products stay within half of it.
    The other gradients do not depend on the choice; the wgmma route keeps
    the float64 products for this reason."""
    shape = (2, 4, 128, 32, 64, 64)
    worst = {True: 0.0, False: 0.0}
    for seed in range(3):
        args = ssd_inputs(seed, *shape, torch.bfloat16)
        grads = ssd_output_grads(seed + 100, *shape)
        for float64_products in worst:
            got = ssd_bwd_emulated(*args, *grads, split=True, float64_products=float64_products)
            over = k3_backward_over(got, args, grads)
            worst[float64_products] = max(worst[float64_products], over["ddt"], over["dseg"])
    assert worst[False] > 1.0 and worst[True] < 0.5, worst


def flash_emulated(q, k, v, causal: bool, block: int = K2_BLOCK):
    """K2's bf16 arithmetic: float32 scores of bf16 inputs, an online
    softmax over tiles of ``block`` keys, P rounded to bf16 for P V (the
    running max, and so the rounding, moves tile by tile), l the sum of the
    rounded P, float32 accumulators, the output rounded to bf16. Returns the
    output and each row's log-sum-exp m + ln l, (B,H,S)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    scale = hd ** -0.5
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, hd)
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, block):
        kb, vb = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
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
    return o.transpose(1, 2).bfloat16(), m + torch.log(l)


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
    got = row_err(flash_emulated(q, k, v, causal=True)[0], ref)
    assert got <= 2 * plain, (got, plain)
    # bf16 P costs about one rounding of the output (2^-8), no more
    assert got < 4 * 2.0 ** -8, got


# the wgmma forward's tiles: 128 keys up to hd 128, 64 at hd 192; ragged S
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 512, 4, 2, 64), (1, 2048, 2, 2, 64),
                                         (1, 300, 4, 2, 128), (1, 129, 4, 1, 192),
                                         (2, 127, 4, 4, 16)])
def test_k2_bf16_p_holds_the_row_limit_at_the_wgmma_tile(B, S, H, KV, hd):
    rng = np.random.default_rng(S + H + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(np.float32)).bfloat16()
               for n in (H, KV, KV))
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    plain = row_err(fa.flash_attention_plain(q, k, v, causal=True), ref)
    got = row_err(flash_emulated(q, k, v, causal=True, block=k2_block(hd))[0], ref)
    assert got <= 2 * plain, (got, plain)
    assert got < 4 * 2.0 ** -8, got


# ---------------------------------------------------------------------------
# K2's backward in bf16 (csrc/flash_attention_bwd.cu): products of bf16
# operands are exact in float32; P is exp(s - lse) in float32; the D/dQ
# kernel's first walk sums l = sum P and sum P dP and sets D = sum P dP / l,
# lse' = lse + ln l; P from lse' then gives dS = P (dP - D), rounded to bf16
# for dQ = scale dS K and dK = scale dS^T Q, and P rounded to bf16 for
# dV = P^T dO; the gradients are rounded to bf16 once. The forward's lse is
# the forward kernel's (l sums the bf16-rounded P). Two alternatives, which
# the design replaced: D = rowsum(dO * o) from the bf16 output ("d_from_o",
# P from the forward's lse), and P from the forward's lse with D = sum P dP
# ("no_renorm").
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -8


def flash_bwd_emulated(q, k, v, do, causal: bool, variant: str = "design",
                       fwd_block: int = K2_BLOCK, block: int = K2_BLOCK):
    """(dq, dk, dv) in bf16 as K2's bf16 backward computes them (see above),
    from the lse of a forward over tiles of ``fwd_block`` keys; the first
    walk's sums l and sum P dP add up tiles of ``block`` keys in order."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    lse = flash_emulated(q, k, v, causal, fwd_block)[1]
    kf, vf = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    scale = hd ** -0.5
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    if variant == "design":
        l, pd = torch.zeros(B, H, S), torch.zeros(B, H, S)
        for k0 in range(0, S, block):
            l = l + p[..., k0:k0 + block].sum(-1)
            pd = pd + (p * dp)[..., k0:k0 + block].sum(-1)
        D = pd / l
        p = torch.where(keep, torch.exp(s - (lse + torch.log(l))[..., None]), 0.0)
    elif variant == "no_renorm":
        D = (p * dp).sum(-1)
    elif variant == "d_from_o":
        o = fa.flash_attention_plain(q, k, v, causal=causal)     # bf16, as the forward's
        D = (do.float() * o.float()).sum(-1).transpose(1, 2)
    else:
        raise ValueError(variant)
    ds = (p * (dp - D[..., None])).bfloat16().float()
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), do.float())
    dk, dv = (t.reshape(B, S, H // G, G, hd).sum(3) for t in (dk, dv))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def plain_grads(q, k, v, do, causal):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=causal)
    return torch.autograd.grad(out, leaves, do)


def grad_row_err(got, ref, scale) -> float:
    """chip_smoke.grad_row_err: a row's largest error over its own largest
    magnitude, or over 1e-3 of the gradients' largest magnitude."""
    ref = ref.double()
    diff = (got.double() - ref).abs().amax(-1)
    return float((diff / ref.abs().amax(-1).clamp_min(scale * 1e-3)).max())


def backward_over_limit(seed, B, S, H, KV, hd, causal, variant, fwd_block=K2_BLOCK):
    """Each of dq, dk, dv's worst row error over its limit, max(twice the
    bf16 plain gradient's, one bf16 ulp): at most 1 holds the limit. The lse
    comes from a forward over tiles of ``fwd_block`` keys."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(np.float32)).bfloat16()
                   for n in (H, KV, KV, H))
    ref = plain_grads(q.float(), k.float(), v.float(), do.float(), causal)
    plain = plain_grads(q, k, v, do, causal)
    got = flash_bwd_emulated(q, k, v, do, causal, variant, fwd_block)
    scale = max(float(r.abs().max()) for r in ref)
    return [grad_row_err(g, r, scale) / max(2 * grad_row_err(w, r, scale), BF16_ULP)
            for g, w, r in zip(got, plain, ref)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (2, 64, 4, 4, 16, True), (1, 256, 4, 2, 64, True), (1, 130, 8, 2, 128, True),
    (2, 200, 4, 2, 128, False), (1, 1, 2, 2, 32, True), (2, 96, 2, 1, 64, False),
    (1, 384, 4, 2, 16, False)])
def test_k2_bf16_backward_holds_the_row_limit(B, S, H, KV, hd, causal):
    over = backward_over_limit(S + hd, B, S, H, KV, hd, causal, "design")
    assert max(over) <= 1.0, over


# the same cases, with the lse of the wgmma forward's tiles (128 keys, 64 at
# hd 192), and the new tiles' edges: 127 and 129 keys, one row, hd 192
@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (2, 64, 4, 4, 16, True), (1, 256, 4, 2, 64, True), (1, 130, 8, 2, 128, True),
    (2, 200, 4, 2, 128, False), (1, 1, 2, 2, 32, True), (2, 96, 2, 1, 64, False),
    (1, 384, 4, 2, 16, False), (1, 127, 4, 2, 64, True), (1, 129, 16, 1, 64, True),
    (1, 257, 4, 1, 192, True), (1, 129, 2, 1, 192, False)])
def test_k2_bf16_backward_holds_the_row_limit_at_the_wgmma_tile(B, S, H, KV, hd, causal):
    over = backward_over_limit(S + hd, B, S, H, KV, hd, causal, "design", k2_block(hd))
    assert max(over) <= 1.0, over


# inputs on which an alternative misses the limit: dq's row error, where the
# true dq is a small difference of large terms
@pytest.mark.parametrize("variant,seed,B,S,H,KV,hd", [
    ("d_from_o", 1, 1, 130, 8, 2, 128),
    ("d_from_o", 3, 2, 64, 4, 4, 16),
    ("no_renorm", 19, 2, 64, 4, 4, 16),
    ("no_renorm", 0, 1, 64, 8, 2, 16)])
def test_k2_backward_alternatives_miss_the_row_limit(variant, seed, B, S, H, KV, hd):
    assert backward_over_limit(seed, B, S, H, KV, hd, True, variant)[0] > 1.0
    assert max(backward_over_limit(seed, B, S, H, KV, hd, True, "design")) <= 1.0


# ---------------------------------------------------------------------------
# K1 (quorum commit): the order by keys and the double scans in tree order
# ---------------------------------------------------------------------------
#
# K1 orders a row's votes by keys (order bits of t, replica index), where the
# order bits map float32 monotonically to uint32 after -0.0 becomes +0.0 and
# every NaN one NaN. For n <= 32 one thread takes a row: a vote's position is
# its rank among the keys, the default threshold and the prefix sums are
# sequential double sums (replica order, then stable arrival order). For
# n > 32 a bitonic network sorts the keys (the order is the keys' order, how it
# is reached does not matter), each thread of P/2 = next_pow2(n)/2 adds the
# two positions it holds, a Hillis-Steele scan runs in each warp of 32 and the
# warp totals are added in order; the threshold is a butterfly sum over each
# warp of the thread's two replicas, then the warp totals in order. Emulated
# here in plain torch, step for step, the kernel's outputs equal
# quorum_commit_plain's: exact on commit_time, quorum_size, committed and
# members, weight_sum at rtol 1e-6, outside the rows whose prefix comes within
# 1e-6 of T (chip_smoke.compare's contract).

from repro_torch.kernels import quorum_commit as qc  # noqa: E402

K1_RTOL = 1e-6
K1_NS = [1, 9, 16, 17, 32, 33, 1024]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def k1_keys(t: torch.Tensor, canonical: bool = True) -> torch.Tensor:
    """int64 keys whose order is the kernel's: order bits, then index."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if canonical:
        bits = torch.where(torch.isnan(t), 0x7FC00000, bits)
        bits = torch.where(t == 0, 0, bits)
    neg = (bits & 0x80000000) != 0
    order = torch.where(neg, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    return order * 2048 + torch.arange(t.shape[1])


def hillis_steele(x: torch.Tensor, width: int) -> torch.Tensor:
    """Inclusive scan over groups of ``width`` lanes, lane p adding lane
    p - o's value to its own at o = 1, 2, 4, ... (``__shfl_up_sync``)."""
    x = x.reshape(x.shape[0], -1, width)
    o = 1
    while o < width:
        y = x.clone()
        y[..., o:] = x[..., o:] + x[..., :-o]
        x, o = y, 2 * o
    return x.reshape(x.shape[0], -1)


def butterfly(x: torch.Tensor, width: int) -> torch.Tensor:
    """Sum over groups of ``width`` lanes by ``__shfl_xor_sync``; every lane
    ends with the same value, lane 0's is returned per group."""
    idx = torch.arange(width)
    x = x.reshape(x.shape[0], -1, width)
    o = width // 2
    while o > 0:
        x = x + x[..., idx ^ o]
        o //= 2
    return x[..., 0]


def k1_emulated(t, w, threshold=None, canonical=True):
    """K1's outputs as the kernel computes them (see above)."""
    rows, n = t.shape
    key = k1_keys(t, canonical)
    rank = (key[:, None, :] < key[:, :, None]).sum(-1)      # rank of replica j
    vote = torch.isfinite(t)
    wv = torch.where(vote, w, 0.0)
    if n <= 32:
        total = torch.zeros(rows, dtype=torch.float64)
        for j in range(n):
            total = total + w[:, j].double()
        pos_w = torch.zeros(rows, n, dtype=torch.float64).scatter(1, rank, wv.double())
        pos_t = torch.zeros(rows, n).scatter(1, rank, t)
        prefix = torch.cumsum(pos_w, -1).float()     # sequential, as the thread adds
    else:
        P = next_pow2(n)
        order = torch.argsort(key, dim=-1)
        pos_t = torch.gather(t, 1, order)
        v = torch.zeros(rows, P, dtype=torch.float64)
        v[:, :n] = torch.gather(wv, 1, order).double()
        v0, v1 = v[:, 0::2], v[:, 1::2]
        pair = v0 + v1
        incl = hillis_steele(pair, 32).reshape(rows, -1, 32)
        excl = torch.cat([torch.zeros(rows, incl.shape[1], 1, dtype=torch.float64),
                          incl[..., :-1]], -1)
        offset = torch.zeros(rows, incl.shape[1], dtype=torch.float64)
        for warp in range(1, incl.shape[1]):
            offset[:, warp] = offset[:, warp - 1] + incl[:, warp - 1, -1]
        base = (offset[..., None] + excl).reshape(rows, -1)
        prefix = torch.stack([base + v0, base + pair], -1).reshape(rows, P)[:, :n].float()
        wpad = torch.zeros(rows, P, dtype=torch.float64)
        wpad[:, :n] = w.double()
        mine = 0.0 + wpad[:, 0::2] + wpad[:, 1::2]             # replicas 2i, 2i + 1
        warp_totals = butterfly(mine, 32)
        total = torch.zeros(rows, dtype=torch.float64)
        for warp in range(warp_totals.shape[1]):
            total = total + warp_totals[:, warp]
    T = total.float() / 2.0 if threshold is None else threshold
    crossed = prefix > T[:, None]
    commit = torch.any(crossed & torch.isfinite(pos_t), -1)
    k = torch.argmax(crossed.to(torch.uint8), -1, keepdim=True)
    commit_time = torch.where(commit, torch.gather(pos_t, 1, k)[:, 0], float("inf"))
    quorum_size = torch.where(commit, k[:, 0] + 1, 0).to(torch.int32)
    weight_sum = torch.where(commit, torch.gather(prefix, 1, k)[:, 0], 0.0)
    members = commit[:, None] & vote & (rank <= k)
    return commit_time, quorum_size, commit, weight_sum, members


def k1_inputs(seed, rows, n):
    """Heavy ties on an integer grid, -0.0 beside +0.0, NaN of either sign,
    30% +inf non-votes and rows with no vote; weights in [0.1, 8)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (rows, n)).astype(np.float32)
    a[a == 0] = np.where(rng.random(int((a == 0).sum())) < 0.5, -0.0, 0.0)
    a[rng.random((rows, n)) < 0.05] = np.float32("nan")
    a[rng.random((rows, n)) < 0.03] = -np.float32("nan")
    a[rng.random((rows, n)) < 0.3] = np.inf
    a[rng.random(rows) < 0.05] = np.inf
    w = rng.uniform(0.1, 8.0, (rows, n)).astype(np.float32)
    thr = (w.astype(np.float64).sum(-1) * rng.uniform(0.3, 0.7, rows)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(thr)


def k1_near(t, w, threshold):
    """chip_smoke.near_threshold: rows whose float64 prefix, in stable order,
    lies within K1_RTOL of T."""
    order = torch.sort(t, dim=-1, stable=True)[1]
    t_s = torch.gather(t, 1, order).double()
    csum = torch.cumsum(torch.where(torch.isfinite(t_s),
                                    torch.gather(w, 1, order).double(), 0.0), -1)
    T = w.double().sum(-1) / 2 if threshold is None else threshold.double()
    return torch.any((csum - T[:, None]).abs() <= K1_RTOL * T.abs()[:, None], -1)


def k1_compare(got, want, near):
    """Names of the outputs that differ outside the near-threshold rows."""
    keep = ~near
    names = ("commit_time", "quorum_size", "committed", "weight_sum", "members")
    bad = []
    for name, g, e in zip(names, got, want):
        g, e = g[keep], e[keep]
        same = (torch.allclose(g, e, rtol=K1_RTOL, atol=0.0) if name == "weight_sum"
                else torch.equal(g, e))
        if not same:
            bad.append(name)
    return bad


@pytest.mark.parametrize("with_threshold", [False, True])
@pytest.mark.parametrize("n", K1_NS)
def test_k1_key_order_and_tree_scans_equal_plain(n, with_threshold):
    t, w, thr = k1_inputs(n, 64 if n > 32 else 600, n)
    th = thr if with_threshold else None
    near = k1_near(t, w, th)
    assert near.float().mean() < 0.05             # the comparison is not vacuous
    want = qc.quorum_commit_plain(t, w, th, members=True)
    assert k1_compare(k1_emulated(t, w, th), want, near) == []
    if n > 1:
        # the order really is the stable one: ranks equal the plain argsort's
        rank = (k1_keys(t)[:, None, :] < k1_keys(t)[:, :, None]).sum(-1)
        assert torch.equal(rank, torch.argsort(torch.sort(t, dim=-1, stable=True)[1], dim=-1))


def test_k1_raw_bit_keys_break_the_tie_rule():
    # +0.0 at replica 0 and -0.0 at replica 1 tie, so replica 0 comes first:
    # 1 (not > 2.5), then 4 -> quorum of 2. A raw bit map puts -0.0 first:
    # 3 > 2.5 -> quorum of 1.
    t = torch.tensor([[0.0, -0.0, 1.0]])
    w = torch.tensor([[1.0, 3.0, 1.0]])
    want = qc.quorum_commit_plain(t, w, members=True)
    assert want[1].item() == 2
    assert k1_compare(k1_emulated(t, w), want, torch.zeros(1, dtype=torch.bool)) == []
    assert "quorum_size" in k1_compare(k1_emulated(t, w, canonical=False), want,
                                       torch.zeros(1, dtype=torch.bool))
    # and on the random inputs: -0.0 and -NaN move without canonicalisation
    for n in (9, 33):
        t, w, _ = k1_inputs(n, 600, n)
        want = qc.quorum_commit_plain(t, w, members=True)
        bad = k1_compare(k1_emulated(t, w, canonical=False), want, k1_near(t, w, None))
        assert "quorum_size" in bad, bad
