"""The CUDA kernels against their plain versions, on a GPU.

The kernel has no CPU mode, so every test here takes the ``cuda`` fixture
and skips where ``torch.cuda.is_available()`` is false. The file imports no
JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Exact on ``committed``, ``commit_time``, ``quorum_size`` and ``members``;
``weight_sum`` at rtol 1e-6 (the plain version's prefix sum is a float32
scan in another order). Inputs have tied arrivals, -0.0 beside +0.0, NaN
arrivals, non-votes and rows with no vote; weights are drawn so that no
prefix sum lies near the threshold. K1's cases cover n at each edge of the
kernel's regimes (lanes a row for n <= 32, a bitonic network above), op
counts that are not a multiple of a block's rows, and inputs that start off
16-byte alignment (a slice ``a[1:]``).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import quorum_commit  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quorum_commit as qc  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def tie_inputs(rng, ops_, n, device):
    a = rng.integers(0, 4, (ops_, n)).astype(np.float32)
    a[a == 0] = np.where(rng.random(int((a == 0).sum())) < 0.5, -0.0, 0.0)
    a[rng.random((ops_, n)) < 0.05] = np.float32("nan")
    a[rng.random((ops_, n)) < 0.3] = np.inf
    a[::17] = np.inf
    # integer weights: every prefix sum and threshold is exact in float32
    w = rng.integers(1, 9, (ops_, n)).astype(np.float32)
    w[:, 0] += 0.5          # odd half-units: no prefix sum equals T exactly
    thr = (np.floor(w.sum(-1) * rng.uniform(0.3, 0.7, ops_)) + 0.25).astype(np.float32)
    return (torch.from_numpy(x).to(device) for x in (a, w, thr))


def assert_equal_results(got, want):
    for i, (g, e) in enumerate(zip(got, want)):
        if i == 3:
            torch.testing.assert_close(g, e, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, e), i


@pytest.mark.parametrize("n", [1, 2, 3, 9, 16, 17, 31, 32, 33, 64, 65, 128, 512, 1024])
@pytest.mark.parametrize("ops_", [300, 2053])
@pytest.mark.parametrize("with_threshold", [False, True])
@pytest.mark.parametrize("members", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_matches_plain(cuda, n, ops_, with_threshold, members, offset):
    rng = np.random.default_rng(n)
    a, w, thr = tie_inputs(rng, ops_ + offset, n, cuda)
    # offset 1: contiguous slices that start n floats into their storage
    a, w, thr = a[offset:], w[offset:], thr[offset:]
    th = thr if with_threshold else None
    before = qc.launches
    got = qc.quorum_commit_cuda(a, w, th, members=members)
    torch.cuda.synchronize()
    assert qc.launches == before + 1
    # the plain version on the CPU: its stable sort ties -0.0 with +0.0, as
    # jnp.argsort does
    want = qc.quorum_commit_plain(a.cpu(), w.cpu(), None if th is None else th.cpu(),
                                  members=members)
    assert (got[4] is None) == (not members)
    if not members:
        got, want = got[:4], want[:4]
    assert_equal_results(tuple(x.cpu() for x in got), want)


def test_entry_points_launch_the_kernel(cuda):
    a, w, _ = tie_inputs(np.random.default_rng(0), 129, 9, cuda)
    before = qc.launches
    res = quorum_commit(a, w)
    got = ops.quorum_commit(a, w)
    torch.cuda.synchronize()
    assert qc.launches == before + 2
    want = qc.quorum_commit_plain(a.cpu(), w.cpu(), members=True)
    assert_equal_results(tuple(x.cpu() for x in (
        res.commit_time, res.quorum_size, res.committed, res.weight_sum,
        res.members)), want)
    assert_equal_results(tuple(x.cpu() for x in got), want[:4])
    empty = qc.quorum_commit_cuda(a[:0], w[:0], members=True)
    assert empty[4].shape == (0, 9) and qc.launches == before + 2


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(4, 3, device=cuda)
    with pytest.raises(TypeError):
        qc.quorum_commit_cuda(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        qc.quorum_commit_cuda(a.t().contiguous().t(), a)
    with pytest.raises(ValueError, match="one CUDA device"):
        qc.quorum_commit_cuda(a, a.cpu())
    big = torch.zeros(2, qc.MAX_REPLICAS + 1, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        qc.quorum_commit_cuda(big, big)


# ---------------------------------------------------------------------------
# The rank sort on the card: the port sorts canonical keys
# (quorum_commit.sort_keys), so on rows with -0.0 beside +0.0, NaN and -NaN
# the card ranks and orders exactly as the CPU, whose order is jnp.argsort's
# (tests/test_torch_weights.py): ±0 tie in replica order, NaN last. n covers
# each of torch.sort's regimes on the card (up to 128, up to 4096, above).
# ---------------------------------------------------------------------------

from _signed_rows import signed_rows  # noqa: E402
from repro_torch.core import weights as W  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)


@pytest.mark.parametrize("n", [2, 9, 33, 200, 5000])
def test_rank_sort_on_the_card_equals_the_cpu(cuda, n):
    ema = torch.from_numpy(signed_rows(np.random.default_rng(n), 4 if n > 1000 else 300, n))
    want = W._ranks(ema)
    assert torch.equal(W._ranks(ema.to(cuda)).cpu(), want)
    on_card = W.WeightTracker(latency_ema=ema.to(cuda))
    on_cpu = W.WeightTracker(latency_ema=ema.clone())
    assert torch.equal(on_card.ranks().cpu(), on_cpu.ranks())
    r = 1.4 if n < 64 else 1.05
    torch.testing.assert_close(on_card.weights(r).cpu(), on_cpu.weights(r), rtol=1e-6,
                               atol=TINY)
    for row in ema[:4]:
        torch.testing.assert_close(W.node_weights_from_latency(row.to(cuda), r).cpu(),
                                   W.node_weights_from_latency(row, r), rtol=1e-6, atol=TINY)
    row = torch.tensor([0.0, -0.0, float("nan"), 1.0, -float("nan"), -0.0, 0.0, 2.0])
    assert W._ranks(row.to(cuda)).cpu().argsort().tolist() == [0, 1, 5, 6, 3, 7, 2, 4]


@pytest.mark.parametrize("n", [9, 200, 1024])
def test_plain_k1_on_the_card_orders_signed_zeros_and_nan_as_the_cpu(cuda, n):
    a, w, thr = tie_inputs(np.random.default_rng(n), 700, n, cuda)
    a[torch.rand(a.shape, device=cuda) < 0.05] = -float("nan")
    for th in (None, thr):
        got = qc.quorum_commit_plain(a, w, th, members=True)
        want = qc.quorum_commit_plain(a.cpu(), w.cpu(), None if th is None else th.cpu(),
                                      members=True)
        assert_equal_results(tuple(x.cpu() for x in got), want)
        assert torch.equal(got[0].cpu().view(torch.int32), want[0].view(torch.int32))


# ---------------------------------------------------------------------------
# K2 (flash attention) and K3 (SSD intra-chunk) against their plain versions.
# float32 at 1e-4 (the same float32 arithmetic summed in another order; the
# plain side's matrix products without TF32), bfloat16 at 2e-2 (the plain
# version rounds its logits to bf16 before the softmax, the kernel does not).
# 2e-2 is a large part of a late causal row's magnitude, so bfloat16 is also
# held row by row against the plain version run in float32 on the same bf16
# inputs: each row's error over the row's magnitude may be at most twice the
# bf16 plain version's.
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402


@pytest.fixture
def no_tf32(cuda):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def attention_inputs(seed, B, S, H, KV, hd, dtype, device):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def row_err(got, ref):
    diff = (got.double() - ref.double()).abs().amax(-1)
    return float((diff / ref.double().abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (1, 256, 4, 2, 64, True), (2, 200, 4, 4, 32, True), (1, 130, 8, 2, 128, True),
    (2, 96, 2, 1, 64, False), (1, 1, 2, 2, 32, True), (1, 1024, 2, 2, 64, True),
    (2, 64, 4, 4, 16, True), (1, 130, 12, 1, 192, True), (2, 96, 4, 2, 192, False),
    # the wgmma kernels' tile edges: 192- and 128-row blocks, 128-key tiles
    # (64 at hd 192), one row; GQA 16 at hd 64; hd 192 ragged
    (1, 127, 4, 2, 64, True), (1, 129, 4, 2, 64, False), (1, 191, 4, 2, 64, True),
    (1, 193, 4, 2, 64, True), (1, 127, 8, 2, 128, False), (1, 129, 8, 2, 128, True),
    (1, 129, 64, 4, 64, True), (1, 1, 64, 4, 64, True), (1, 257, 4, 1, 192, True),
    (1, 65, 4, 1, 192, False), (2, 129, 4, 4, 16, True), (2, 193, 4, 2, 32, False)])
def test_flash_attention_kernel_matches_plain(no_tf32, dtype, tol, B, S, H, KV, hd, causal):
    q, k, v = attention_inputs(S + hd, B, S, H, KV, hd, dtype, no_tf32)
    before = fa.launches
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        assert row_err(got, ref) <= 2 * row_err(want, ref)


def ssd_inputs(seed, B, nc, Q, nh, hp, N, xdtype, device):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((B, nc, Q, nh, hp), generator=g, device=device).to(xdtype)
    dt = torch.nn.functional.softplus(torch.randn((B, nc, Q, nh), generator=g,
                                                  device=device)) * 0.1
    A = -torch.exp(0.3 * torch.randn(nh, generator=g, device=device))
    seg = torch.cumsum(dt * A, dim=2)
    Bm, Cm = (torch.randn((B, nc, Q, N), generator=g, device=device) for _ in range(2))
    return x, dt, seg, Bm, Cm


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", [
    (2, 2, 128, 4, 64, 64, torch.bfloat16), (1, 3, 64, 9, 32, 16, torch.float32),
    (1, 2, 128, 2, 128, 128, torch.float32), (1, 1, 33, 3, 12, 20, torch.float32),
    (2, 1, 16, 16, 8, 4, torch.bfloat16),
    # the forward's 64-row warpgroup tiles with a ragged Q, nh past its 16
    # heads a block, and rows that TMA cannot take (ordinary loads, stores)
    (1, 2, 100, 5, 64, 64, torch.bfloat16), (1, 2, 128, 20, 64, 128, torch.bfloat16),
    (1, 2, 48, 6, 9, 7, torch.bfloat16)])
def test_ssd_kernel_matches_plain(no_tf32, B, nc, Q, nh, hp, N, xdtype):
    args = ssd_inputs(Q + N, B, nc, Q, nh, hp, N, xdtype, no_tf32)
    before = ssd.launches
    got = ssd.ssd_intra_chunk_cuda(*args)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    for g, w in zip(got, ssd.ssd_intra_chunk_plain(*args)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    # fixed numerics: a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, ssd.ssd_intra_chunk_cuda(*args)))


def test_entry_points_launch_k2_and_k3(no_tf32):
    q, k, v = attention_inputs(0, 1, 64, 2, 2, 32, torch.float32, no_tf32)
    x, dt, seg, Bm, Cm = ssd_inputs(1, 1, 2, 32, 2, 8, 4, torch.float32, no_tf32)
    fa_before, ssd_before = fa.launches, ssd.launches
    ops.flash_attention(q, k, v, causal=True)
    y, final = ops.ssd(x.reshape(1, 64, 2, 8), dt.reshape(1, 64, 2),
                       -torch.ones(2, device=no_tf32), Bm.reshape(1, 64, 4),
                       Cm.reshape(1, 64, 4), torch.ones(2, device=no_tf32), 32)
    torch.cuda.synchronize()
    assert (fa.launches, ssd.launches) == (fa_before + 1, ssd_before + 1)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()


def test_k2_and_k3_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention_cuda(q, q.cpu(), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="head dim"):
        r = torch.zeros(1, 8, 2, 48, device=cuda)
        fa.flash_attention_cuda(r, r, r)
    args = ssd_inputs(0, 1, 1, 16, 2, 8, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        ssd.ssd_intra_chunk_cuda(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        ssd.ssd_intra_chunk_cuda(args[0], args[1].bfloat16(), *args[2:])
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd.ssd_intra_chunk_cuda(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        x = args[0].transpose(3, 4).contiguous().transpose(3, 4)
        ssd.ssd_intra_chunk_cuda(x, *args[1:])
    big = ssd_inputs(0, 1, 1, 129, 1, 8, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="up to|from 1 to"):
        ssd.ssd_intra_chunk_cuda(*big)


# ---------------------------------------------------------------------------
# K2's log-sum-exp output and its backward kernel against the plain
# version's autograd gradient. float32 at atol/rtol 1e-4, the forward's
# contract. bfloat16 row by row against the plain gradient run in float32 on
# the same bf16 inputs: each gradient's largest row error may be at most twice
# the bf16 plain gradient's, or one bf16 ulp (2^-8), the rounding of the
# output itself, where that is larger. A row's error is taken over its own
# largest magnitude, or over 1e-3 of the largest magnitude of the three
# gradients where that is larger: at S = 1 the softmax has one entry, dq and
# dk are exactly zero, and the plain version computes them exactly.
# ---------------------------------------------------------------------------

from repro_torch.models import layers as L  # noqa: E402


def plain_lse(q, k, causal):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float().reshape(B, S, KV, H // KV, hd),
                          k.float()) * hd ** -0.5
    if causal:
        keep = torch.arange(S, device=q.device)[:, None] >= torch.arange(S, device=q.device)
        logits = torch.where(keep, logits, -1e30)
    return torch.logsumexp(logits, -1).reshape(B, H, S)


def plain_grads(q, k, v, do, causal):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=causal)
    return torch.autograd.grad(out, leaves, do)


BF16_ULP = 2.0 ** -8


def grad_row_err(got, ref, scale):
    ref = ref.double()
    diff = (got.double() - ref).abs().amax(-1)
    return float((diff / ref.abs().amax(-1).clamp_min(scale * 1e-3)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (1, 256, 4, 2, 64, True), (2, 200, 4, 4, 32, True), (1, 130, 8, 2, 128, True),
    (2, 96, 2, 1, 64, False), (1, 1, 2, 2, 32, True), (2, 64, 4, 4, 16, True),
    (1, 384, 4, 2, 16, False), (2, 200, 4, 2, 128, False), (1, 130, 12, 1, 192, True),
    (2, 96, 4, 2, 192, False),
    # the wgmma kernels' tile edges: D/dQ's 128-row blocks and 128-key tiles
    # (64 above hd 64), dK/dV's 128-key blocks (64 at hd 192) and 64-row q
    # tiles, one row; GQA 16 at hd 64; hd 192 ragged
    (1, 63, 4, 2, 64, True), (1, 65, 4, 2, 64, False), (1, 127, 4, 2, 64, True),
    (1, 129, 4, 2, 64, True), (1, 63, 8, 2, 128, False), (1, 129, 8, 2, 128, True),
    (1, 129, 64, 4, 64, True), (1, 1, 64, 4, 64, True), (1, 257, 4, 1, 192, True),
    (1, 65, 4, 1, 192, False), (2, 129, 4, 4, 16, True), (2, 65, 4, 2, 32, False)])
def test_flash_attention_backward_matches_plain(no_tf32, dtype, B, S, H, KV, hd, causal):
    q, k, v = attention_inputs(S + hd, B, S, H, KV, hd, dtype, no_tf32)
    do = attention_inputs(S, B, S, H, KV, hd, dtype, no_tf32)[0]
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, causal=causal))
    torch.testing.assert_close(lse, plain_lse(q, k, causal), atol=1e-5 if dtype ==
                               torch.float32 else 4e-3, rtol=0)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    want = plain_grads(q, k, v, do, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4, msg=name)
    if dtype == torch.bfloat16:
        ref = plain_grads(q.float(), k.float(), v.float(), do.float(), causal)
        scale = max(float(r.abs().max()) for r in ref)
        for g, w, r, name in zip(got, want, ref, ("dq", "dk", "dv")):
            assert grad_row_err(g, r, scale) <= max(2 * grad_row_err(w, r, scale),
                                                    BF16_ULP), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_on_cuda_is_differentiable_through_k2(no_tf32, dtype):
    cfg = type("Cfg", (), dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                               qk_norm=True, rope_theta=1e6))
    g = torch.Generator(no_tf32).manual_seed(0)
    params = {k: t.requires_grad_() for k, t in L.init_attention(g, cfg, dtype).items()}
    x = torch.randn(2, 40, 64, generator=g, device=no_tf32).to(dtype)
    pos = torch.arange(40, device=no_tf32).expand(2, 40)
    fwd, bwd = fa.launches, fa.bwd_launches
    out = L.attention_train(params, cfg, x, pos)
    assert out.grad_fn is not None
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (fwd + 1, bwd + 1)
    for name in ("wq", "wk", "wv", "wo"):
        assert params[name].grad is not None and params[name].grad.abs().max() > 0, name
    # the plain attention on the CPU gives the same gradients (float32)
    if dtype == torch.float32:
        cpu = {k: t.detach().cpu().requires_grad_() for k, t in params.items()}
        L.attention_train(cpu, cfg, x.cpu(), pos.cpu()).square().mean().backward()
        for name in cpu:
            torch.testing.assert_close(params[name].grad.cpu(), cpu[name].grad,
                                       atol=1e-5, rtol=1e-4, msg=name)


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse.double())
    with pytest.raises(TypeError):
        fa.flash_attention_bwd_cuda(q, q, q, q.bfloat16(), lse)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd_cuda(q, q, q, q.transpose(1, 2).contiguous().transpose(1, 2),
                                    lse)


# ---------------------------------------------------------------------------
# K3's backward kernel against the closed-form plain backward, and the
# gradient through SSDIntraChunk. float32 at atol/rtol 1e-4, the forward's
# contract, against the closed form evaluated in float64, as
# chip_smoke.hold_k3_backward holds it: ddt and dseg are small differences
# of large sums, and the plain version's own float32 products leave it up
# to 1.6 limits from the float64 value at N 128; a bf16 dx row by row
# against the plain backward run in float32 on the same bf16 x: its largest
# row error at most twice the bf16 plain version's, or one bf16 ulp (2^-8),
# the rounding of dx itself.
# ---------------------------------------------------------------------------

K3_INPUTS = ("x", "dt", "seg", "Bm", "Cm")


def ssd_output_grads(seed, B, nc, Q, nh, hp, N, device):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device)
            for s in ((B, nc, Q, nh, hp), (B, nc, nh, hp, N), (B, nc, nh))]


@pytest.mark.parametrize("B,nc,Q,nh,hp,N,xdtype", [
    (2, 2, 128, 4, 64, 64, torch.bfloat16), (1, 3, 64, 9, 32, 16, torch.float32),
    (1, 2, 128, 2, 128, 128, torch.float32), (1, 1, 33, 3, 12, 20, torch.float32),
    (1, 1, 33, 3, 12, 20, torch.bfloat16), (2, 1, 16, 16, 8, 4, torch.bfloat16),
    (1, 1, 128, 40, 64, 128, torch.bfloat16), (1, 1, 1, 1, 1, 1, torch.float32),
    # the wgmma kernel's edges: a ragged Q over its two 64-row warpgroups, nh
    # not a multiple of its 32 heads a block, rows TMA cannot take (ordinary
    # loads), N 128 as two panels of dS, hp 128 as two halves with a bf16 x
    (1, 2, 100, 5, 64, 64, torch.bfloat16), (1, 3, 128, 40, 64, 64, torch.bfloat16),
    (1, 2, 48, 6, 9, 7, torch.bfloat16), (1, 2, 48, 6, 9, 7, torch.float32),
    (1, 2, 128, 4, 64, 128, torch.bfloat16), (1, 2, 128, 3, 128, 64, torch.bfloat16)])
def test_ssd_backward_kernel_matches_plain(no_tf32, B, nc, Q, nh, hp, N, xdtype):
    args = ssd_inputs(Q + N, B, nc, Q, nh, hp, N, xdtype, no_tf32)
    grads = ssd_output_grads(Q, B, nc, Q, nh, hp, N, no_tf32)
    before = ssd.bwd_launches
    got = ssd.ssd_intra_chunk_bwd_cuda(*args, *grads)
    torch.cuda.synchronize()
    assert ssd.bwd_launches == before + 1
    want = ssd.ssd_intra_chunk_bwd_plain(*args, *grads)
    exact = ssd.ssd_intra_chunk_bwd_plain(*(t.double() for t in (*args, *grads)))
    for name, g, w, e in zip(K3_INPUTS, got, want, exact):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all(), name
        if g.dtype == torch.float32:
            torch.testing.assert_close(g.double(), e, atol=1e-4, rtol=1e-4, msg=name)
    if xdtype == torch.bfloat16:
        ref = ssd.ssd_intra_chunk_bwd_plain(args[0].float(), *args[1:], *grads)[0]
        assert row_err(got[0], ref) <= max(2 * row_err(want[0], ref), BF16_ULP)
    again = ssd.ssd_intra_chunk_bwd_cuda(*args, *grads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # no atomics


@pytest.mark.parametrize("name", K3_INPUTS)
def test_k3_gives_the_gradient_where_one_is_wanted(no_tf32, name):
    """ssd_intra_chunk with ``name`` requiring a gradient: K3 once forward,
    its backward kernel once, and the plain version's autograd gradient."""
    args = list(ssd_inputs(0, 1, 2, 32, 2, 8, 4, torch.float32, no_tf32))
    i = K3_INPUTS.index(name)
    args[i] = args[i].clone().requires_grad_()
    grads = ssd_output_grads(1, 1, 2, 32, 2, 8, 4, no_tf32)
    fwd, bwd = ssd.launches, ssd.bwd_launches
    outs = ssd.ssd_intra_chunk(*args)
    assert (ssd.launches, ssd.bwd_launches) == (fwd + 1, bwd)
    (got,) = torch.autograd.grad(outs, [args[i]], grads)
    torch.cuda.synchronize()
    assert (ssd.launches, ssd.bwd_launches) == (fwd + 1, bwd + 1)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    want = torch.autograd.grad(ssd.ssd_intra_chunk_plain(*leaves), leaves, grads)[i]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        ssd.ssd_intra_chunk(*args)
    assert (ssd.launches, ssd.bwd_launches) == (fwd + 2, bwd + 1)


def test_ssd_on_cuda_is_differentiable_through_k3(no_tf32):
    """ops.ssd on the card: every input's gradient equals the plain scan's on
    the CPU (float32, 1e-3 of the largest magnitude: K3's 1e-4 carried
    through the inter-chunk recurrence)."""
    x, dt, seg, Bm, Cm = ssd_inputs(3, 1, 2, 64, 3, 16, 8, torch.float32, no_tf32)
    inputs = {"x": x.reshape(1, 128, 3, 16), "dt": dt.reshape(1, 128, 3),
              "A": -torch.linspace(0.5, 2.0, 3, device=no_tf32), "Bm": Bm.reshape(1, 128, 8),
              "Cm": Cm.reshape(1, 128, 8), "D": torch.linspace(0.5, 1.5, 3, device=no_tf32)}
    g = torch.Generator(no_tf32).manual_seed(4)
    wy = torch.randn(1, 128, 3, 16, generator=g, device=no_tf32)
    ws = torch.randn(1, 3, 16, 8, generator=g, device=no_tf32)
    grads = {}
    for device in (no_tf32, torch.device("cpu")):
        leaves = {k: v.detach().to(device).requires_grad_() for k, v in inputs.items()}
        y, s = ops.ssd(*leaves.values(), 64)
        ((y * wy.to(device)).sum() + (s * ws.to(device)).sum()).backward()
        grads[device.type] = {k: v.grad for k, v in leaves.items()}
    for k, want in grads["cpu"].items():
        got = grads["cuda"][k].cpu()
        scale = float(want.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(got, want, atol=1e-3 * scale, rtol=1e-3, msg=k)


def test_k3_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = ssd_inputs(0, 1, 1, 16, 2, 8, 4, torch.float32, cuda)
    dy, ds, dd = ssd_output_grads(0, 1, 1, 16, 2, 8, 4, cuda)
    with pytest.raises(ValueError, match="dy, dstate and ddecay"):
        ssd.ssd_intra_chunk_bwd_cuda(*args, dy[..., :4], ds, dd)
    with pytest.raises(TypeError):
        ssd.ssd_intra_chunk_bwd_cuda(*args, dy.bfloat16(), ds, dd)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd.ssd_intra_chunk_bwd_cuda(*args, dy, ds.cpu(), dd)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_intra_chunk_bwd_cuda(*args, dy.transpose(3, 4).contiguous().transpose(3, 4),
                                     ds, dd)


# ---------------------------------------------------------------------------
# K1 has no backward kernel: where a gradient is wanted its CUDA wrapper
# raises and launches nothing; under no_grad it launches as before.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["arrivals", "weights", "threshold"])
def test_k1_wrapper_raises_where_a_gradient_is_wanted(cuda, name):
    a, w, thr = tie_inputs(np.random.default_rng(1), 129, 9, cuda)
    args = {"arrivals": a, "weights": w, "threshold": thr}
    args[name] = args[name].clone().requires_grad_()
    before = qc.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        qc.quorum_commit_cuda(args["arrivals"], args["weights"], args["threshold"])
    assert qc.launches == before
    with torch.no_grad():
        got = qc.quorum_commit_cuda(args["arrivals"], args["weights"], args["threshold"],
                                    members=True)
        torch.cuda.synchronize()
    assert qc.launches == before + 1
    want = qc.quorum_commit_plain(a.cpu(), w.cpu(), thr.cpu(), members=True)
    assert_equal_results(tuple(x.cpu() for x in got), want)


# ---------------------------------------------------------------------------
# K2 with keys of their own length (cross-attention, non-causal), held as
# test_flash_attention_kernel_matches_plain holds self-attention; the
# encoder's non-causal self-attention; and the raise where a gradient is
# wanted, which K2's backward (self-attention only) cannot give.
# ---------------------------------------------------------------------------


def cross_inputs(seed, B, S, Sk, H, KV, hd, dtype, device):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for shape in ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,Sk,H,KV,hd", [
    (8, 2048, 512, 16, 16, 64), (2, 77, 300, 6, 2, 64), (8, 1, 512, 16, 16, 64),
    (2, 40, 1, 4, 2, 32), (2, 512, 512, 16, 16, 64), (1, 130, 70, 8, 2, 128),
    (2, 33, 65, 4, 4, 16), (1, 130, 70, 8, 2, 192),
    # keys one below and above the wgmma kernels' 128- and 64-key tiles
    (1, 129, 127, 4, 2, 64), (1, 191, 129, 4, 2, 64), (1, 127, 65, 64, 4, 64),
    (1, 65, 63, 4, 2, 128), (1, 127, 129, 8, 2, 128), (1, 130, 65, 4, 1, 192)])
def test_flash_attention_kernel_takes_keys_of_their_own_length(no_tf32, dtype, tol, B, S,
                                                               Sk, H, KV, hd):
    q, k, v = cross_inputs(S + Sk, B, S, Sk, H, KV, hd, dtype, no_tf32)
    before = fa.launches
    got = fa.flash_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=False)
        assert row_err(got, ref) <= 2 * row_err(want, ref)
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, causal=False))


def test_cross_attention_raises_where_a_gradient_is_wanted(no_tf32):
    """Keys of their own length: causal attention raises before any launch,
    forward or backward, also where a gradient is wanted; non-causal
    attention that wants a gradient launches K2 and its backward once each,
    whichever input wants it (and only K2 under no_grad)."""
    q, k, v = cross_inputs(0, 1, 16, 24, 2, 2, 32, torch.float32, no_tf32)
    before = (fa.launches, fa.bwd_launches)
    with pytest.raises(ValueError, match="own length"):
        fa.flash_attention_cuda(q, k, v, causal=True)
    with pytest.raises(ValueError, match="own length"):
        ops.flash_attention(q, k.clone().requires_grad_(), v, causal=True)
    with pytest.raises(ValueError, match="own length"):
        fa.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(1, 2, 16, device=no_tf32),
                                    causal=True)
    assert (fa.launches, fa.bwd_launches) == before
    for leaf in range(3):
        args = [t.clone().requires_grad_(i == leaf) for i, t in enumerate((q, k, v))]
        fwd, bwd = fa.launches, fa.bwd_launches
        out = ops.flash_attention(*args, causal=False)
        out.square().sum().backward()
        torch.cuda.synchronize()
        assert (fa.launches, fa.bwd_launches) == (fwd + 1, bwd + 1)
        assert args[leaf].grad.shape == args[leaf].shape
    with torch.no_grad():
        fwd, bwd = fa.launches, fa.bwd_launches
        ops.flash_attention(*(t.requires_grad_() for t in (q, k, v)), causal=False)
    assert (fa.launches, fa.bwd_launches) == (fwd + 1, bwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Sk,H,KV,hd", [
    (8, 2048, 512, 16, 16, 64),   # seamless-m4t-medium's training cross-attention
    (2, 77, 300, 6, 2, 64),       # ragged lengths, GQA
    (1, 1024, 512, 4, 2, 64),     # the plain version chunks the queries
    (2, 40, 1, 4, 2, 32),         # one key
    (8, 1, 512, 16, 16, 64),      # one query
    (8, 512, 512, 16, 16, 64),    # the encoder's non-causal self-attention
    (1, 130, 70, 8, 2, 128),      # hd 128
    (1, 130, 70, 8, 2, 192),      # hd 192, one warpgroup dV, the other dK
    # keys one below and above the wgmma kernels' 128- and 64-key tiles
    (1, 129, 127, 4, 2, 64), (1, 127, 129, 64, 4, 64), (1, 65, 63, 4, 2, 128),
    (1, 127, 65, 8, 2, 128), (1, 130, 65, 4, 1, 192)])
def test_flash_attention_backward_takes_keys_of_their_own_length(no_tf32, dtype, B, S, Sk, H,
                                                                 KV, hd):
    """K2's backward, non-causal, against the plain version's autograd
    gradient as the self-attention cases above hold it; twice bit for bit."""
    q, k, v = cross_inputs(S + Sk, B, S, Sk, H, KV, hd, dtype, no_tf32)
    do = cross_inputs(S, B, S, Sk, H, KV, hd, dtype, no_tf32)[0]
    out, lse = fa.flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    torch.testing.assert_close(lse, plain_lse(q, k, False), atol=1e-5 if dtype ==
                               torch.float32 else 4e-3, rtol=0)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=False)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    again = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = plain_grads(q, k, v, do, False)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4, msg=name)
    if dtype == torch.bfloat16:
        ref = plain_grads(q.float(), k.float(), v.float(), do.float(), False)
        scale = max(float(r.abs().max()) for r in ref)
        for g, w, r, name in zip(got, want, ref, ("dq", "dk", "dv")):
            assert grad_row_err(g, r, scale) <= max(2 * grad_row_err(w, r, scale),
                                                    BF16_ULP), name


# ---------------------------------------------------------------------------
# The smoke moe, encdec and vlm families in float32, served on the card
# against the same on the CPU: prefill plus 3 greedy decode steps, logits
# and every cache tensor at atol/rtol 1e-4, equal greedy tokens; for the MoE
# configs the router's choice sets equal wherever the k-th and (k+1)-th
# probabilities lie more than NEAR_TIE apart (near-ties are counted, not
# avoided).
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import family, moe  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

NEAR_TIE = 1e-5


def serve_smoke(cfg, params, batch, device, steps=3):
    on = L.tree_map(lambda t: t.to(device), params)
    batch = {k: t.to(device) for k, t in batch.items()}
    pos0 = batch["tokens"].shape[1] + serve.prefix_len(cfg)
    logits, cache = serve.make_prefill_step(cfg, cache_len=pos0 + steps + 1)(on, batch)
    out, fed = [logits], []
    for i in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        fed.append(tok)
        pos = torch.full((tok.shape[0],), pos0 + i, dtype=torch.int64, device=device)
        logits, cache = serve.make_decode_step(cfg)(on, cache, tok, pos)
        out.append(logits)
    return out, fed, cache


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
                                  "seamless-m4t-medium", "internvl2-26b"])
def test_smoke_families_serve_on_the_card_as_on_the_cpu(no_tf32, monkeypatch, arch):
    cfg = dataclasses.replace(configs.smoke(arch), param_dtype="float32",
                              compute_dtype="float32")
    params = family(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = serve.make_batch(cfg, torch.Generator().manual_seed(1), 2, 64)
    routes = {"cpu": [], "cuda": []}
    route = moe.route

    def recording(p, c, xf):
        top_p, top_e, probs = route(p, c, xf)
        routes[xf.device.type].append((top_e.cpu(), probs.cpu()))
        return top_p, top_e, probs
    monkeypatch.setattr(moe, "route", recording)
    before = fa.launches
    runs = {d: serve_smoke(cfg, params, batch, d) for d in ("cpu", "cuda")}
    torch.cuda.synchronize()
    assert fa.launches > before
    for step, (g, w) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4, msg=f"step {step}")
    for g, w in zip(runs["cuda"][1], runs["cpu"][1]):
        assert torch.equal(g.cpu(), w)
    for name, w in runs["cpu"][2].items():
        torch.testing.assert_close(runs["cuda"][2][name].cpu(), w, atol=1e-4, rtol=1e-4)
    assert len(routes["cuda"]) == len(routes["cpu"])
    for (ge, _), (we, probs) in zip(routes["cuda"], routes["cpu"]):
        ranked = probs.sort(-1, descending=True).values
        clear = (ranked[:, cfg.top_k - 1] - ranked[:, cfg.top_k]) >= NEAR_TIE
        assert torch.equal(ge.sort(-1).values[clear], we.sort(-1).values[clear])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
                                  "seamless-m4t-medium", "internvl2-26b"])
def test_smoke_families_train_on_the_card_as_on_the_cpu(no_tf32, monkeypatch, arch):
    """Two train steps (2 microbatches, remat, float32) of the smoke config
    on the card against the CPU from the same parameters and batches (the
    stub frontend's inputs included): loss, grad_norm and lr, the parameters
    and both moments at atol/rtol 1e-4; K2's backward launched once an
    attention layer a microbatch. The CPU router's k-th and (k+1)-th
    probabilities must lie NEAR_TIE apart or more, so that the card routes
    every token alike."""
    from repro_torch.data import DataConfig
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig, adamw
    cfg = dataclasses.replace(configs.smoke(arch), param_dtype="float32",
                              compute_dtype="float32", microbatches=2, remat=True)
    params = family(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=1)
    gaps = []
    route = moe.route

    def recording(p, c, xf):
        top_p, top_e, probs = route(p, c, xf)
        if xf.device.type == "cpu":
            ranked = probs.detach().sort(-1, descending=True).values
            gaps.append(float((ranked[:, c.top_k - 1] - ranked[:, c.top_k]).min()))
        return top_p, top_e, probs
    monkeypatch.setattr(moe, "route", recording)
    opt_cfg = AdamWConfig()
    runs = {}
    for device in ("cpu", "cuda"):
        p = L.tree_map(lambda t: t.to(device, copy=True), params)
        o = adamw.init(p, opt_cfg)
        step_fn = train.make_train_step(cfg, opt_cfg, total_steps=300)
        bwd, metrics = fa.bwd_launches, []
        for step in (200, 201):
            p, o, m = step_fn(p, o, train.train_batch(cfg, dcfg, step, device), step)
            metrics.append({k: float(x) for k, x in m.items()})
        runs[device] = (p, o, metrics, fa.bwd_launches - bwd)
    torch.cuda.synchronize()
    attn = cfg.encoder_layers + 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
    assert runs["cpu"][3] == 0 and runs["cuda"][3] == 2 * cfg.microbatches * attn
    if cfg.family == "moe":
        assert min(gaps) >= NEAR_TIE
    for got, want in zip(runs["cuda"][2], runs["cpu"][2]):
        for k in ("loss", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k
    for tree in (0, 1):
        for g, w in zip(tree_leaves(runs["cuda"][tree]), tree_leaves(runs["cpu"][tree])):
            torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# K2, K3 and their backwards as torch.library ops: the fakes against the
# bodies (opcheck, which runs each op for real and on fake tensors), and the
# FLOP formulas that FlopCounterMode counts
# ---------------------------------------------------------------------------

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Sk,causal", [(96, 96, True), (40, 72, False)])
def test_k2_ops_pass_opcheck(no_tf32, dtype, S, Sk, causal):
    q, k, v = cross_inputs(S + Sk, 2, S, Sk, 4, 2, 64, dtype, no_tf32)
    do = cross_inputs(1, 2, S, Sk, 4, 2, 64, dtype, no_tf32)[0]
    for return_lse in (False, True):
        torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                              (q, k, v, causal, return_lse))
    _, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_bwd.default,
                          (q, k, v, do, lse, causal))


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_k3_ops_pass_opcheck(no_tf32, xdtype):
    dims = (2, 2, 64, 4, 32, 16)
    args = ssd_inputs(5, *dims, xdtype, no_tf32)
    torch.library.opcheck(torch.ops.repro_torch.ssd_intra_chunk.default, args)
    grads = ssd_output_grads(6, *dims, no_tf32)
    torch.library.opcheck(torch.ops.repro_torch.ssd_intra_chunk_bwd.default,
                          (*args, *grads))


def test_flop_counter_counts_the_kernels_formulas(no_tf32):
    B, S, H, KV, hd = 2, 256, 4, 2, 64
    q, k, v = attention_inputs(0, B, S, H, KV, hd, torch.bfloat16, no_tf32)
    before = fa.launches
    with FlopCounterMode(display=False) as counter:
        fa.flash_attention_cuda(q, k, v, causal=True)
    assert fa.launches == before + 1
    assert counter.get_total_flops() == 4 * B * H * hd * S * (S + 1) // 2
    B, nc, Q, nh, hp, N = 2, 2, 128, 4, 64, 32
    args = ssd_inputs(1, B, nc, Q, nh, hp, N, torch.bfloat16, no_tf32)
    before = ssd.launches
    with FlopCounterMode(display=False) as counter:
        ssd.ssd_intra_chunk_cuda(*args)
    assert ssd.launches == before + 1
    tri = Q * (Q + 1) // 2
    assert counter.get_total_flops() == 2 * B * nc * (tri * (N + nh * hp) + nh * Q * hp * N)
