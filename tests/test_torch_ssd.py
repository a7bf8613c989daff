"""K3 and the chunked SSD scan in the port, against the JAX package (CPU).

* The plain intra-chunk block against ``ssd_intra_chunk(..., interpret=True)``
  at atol/rtol 1e-4 (float32 products over Q <= 128 terms summed in another
  order).
* ``ssd_chunked`` against ``repro.models.mamba2.ssd_chunked``, the sequential
  recurrence and the initial-state threading, on the cases of
  ``tests/test_kernels.py`` (SSD scan), at 2e-3 as there.
* A step ``dt·A`` large enough that ``exp`` overflows above the diagonal:
  no NaN.
* K3's gradient: the closed-form plain backward
  (``ssd_intra_chunk_bwd_plain``, the formulas of the backward kernel)
  against autograd of the plain block at 1e-5 of each gradient's largest
  magnitude, on ragged Q, N != hp, nh 1 and nh > 32; the ``SSDIntraChunk``
  wiring on the CPU with its launchers swapped for counting plain versions,
  and ``ops.ssd`` through it against ``jax.grad`` of the JAX model's
  ``ssd_chunked`` for each of x, dt, A, Bm, Cm and D; the plain scan's own
  CPU gradient against ``jax.grad``; and a gradient that stays finite where
  ``exp(seg_i - seg_j)`` overflows above the diagonal (``jax.grad`` of the
  reference is NaN there).
The CUDA kernels are tested on a GPU by ``tests/test_torch_cuda.py``.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan import ssd_intra_chunk  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402


def inputs(seed, B, S, nh, hp, N, dt_scale=0.1, a_scale=0.3):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(B, S, nh, hp)).astype(f)
    dt = (np.log1p(np.exp(rng.normal(size=(B, S, nh)))) * dt_scale).astype(f)
    A = (-np.exp(rng.normal(size=nh) * a_scale)).astype(f)
    Bm = rng.normal(size=(B, S, N)).astype(f)
    Cm = rng.normal(size=(B, S, N)).astype(f)
    return x, dt, A, Bm, Cm


def chunk(x, dt, A, Bm, Cm, Q):
    """The intra-chunk block's inputs, as ssd_chunked forms them."""
    B, S, nh, hp = x.shape
    nc, N = S // Q, Bm.shape[-1]
    seg = np.cumsum((dt * A).reshape(B, nc, Q, nh), axis=2, dtype=np.float32)
    return (x.reshape(B, nc, Q, nh, hp), dt.reshape(B, nc, Q, nh), seg,
            Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,nh,hp,N,Q", [
    (2, 256, 2, 64, 16, 128),
    (1, 256, 3, 24, 40, 64),
    (1, 128, 1, 64, 128, 64),
])
def test_plain_intra_chunk_matches_pallas_interpret(B, S, nh, hp, N, Q):
    args = chunk(*inputs(S + N, B, S, nh, hp, N), Q)
    want = ssd_intra_chunk(*(jnp.asarray(a) for a in args), interpret=True)
    got = ssd.ssd_intra_chunk(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        close(g, w, 1e-4)


@pytest.mark.parametrize("B,S,nh,hp,N,Q", [
    (2, 256, 2, 64, 16, 128),
    (1, 512, 4, 32, 64, 128),
    (1, 128, 1, 64, 128, 64),
])
def test_ssd_chunked_matches_jax(B, S, nh, hp, N, Q):
    x, dt, A, Bm, Cm = inputs(S + nh, B, S, nh, hp, N)
    D = np.ones(nh, np.float32)
    jy, js = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)), Q)
    py, ps = ops.ssd(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)), Q)
    close(py, jy, 2e-3)
    close(ps, js, 2e-3)
    ry, rs = ref.ssd_ref(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)), Q)
    assert torch.equal(ry, py) and torch.equal(rs, ps)


def test_ssd_bfloat16_rounds_y_inter_as_the_model_does():
    """bf16 x: y_inter is rounded to bf16 before it is added (mamba2.py), and
    the outputs come back in bf16; 2e-2 for bf16 rounding."""
    x, dt, A, Bm, Cm = inputs(5, 1, 128, 2, 32, 16)
    D = np.ones(2, np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jy, js = JM.ssd_chunked(jx, *(jnp.asarray(a) for a in (dt, A, Bm, Cm, D)), 32)
    px = torch.from_numpy(np.asarray(jx, np.float32)).bfloat16()
    py, ps = M.ssd_chunked(px, *(torch.from_numpy(a) for a in (dt, A, Bm, Cm, D)), 32)
    assert py.dtype == ps.dtype == torch.bfloat16
    close(py, jy, 2e-2)
    close(ps, js, 2e-2)


def test_ssd_equals_naive_sequential_recurrence():
    B, S, nh, hp, N, Q = 1, 64, 2, 8, 4, 16
    x, dt, A, Bm, Cm = inputs(3, B, S, nh, hp, N, dt_scale=0.2)
    s = np.zeros((B, nh, hp, N), np.float32)
    ys = []
    for t in range(S):
        dec = np.exp(dt[:, t] * A[None, :])
        contrib = np.einsum("bn,bh,bhp->bhpn", Bm[:, t], dt[:, t], x[:, t])
        s = s * dec[..., None, None] + contrib
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], s))
    D = np.zeros(nh, np.float32)
    y, st = ops.ssd(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)), Q)
    close(y, np.stack(ys, 1), 2e-3)
    close(st, s, 2e-3)


def test_ssd_initial_state_threading():
    B, S, nh, hp, N, Q = 1, 128, 1, 16, 8, 32
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        inputs(7, B, S, nh, hp, N, dt_scale=0.2))
    D = torch.zeros(nh)
    y_full, s_full = ops.ssd(x, dt, A, Bm, Cm, D, Q)
    h = S // 2
    y1, s1 = ops.ssd(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], D, Q)
    y2, s2 = ops.ssd(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], D, Q,
                     initial_state=s1)
    close(torch.cat([y1, y2], 1), y_full.numpy(), 2e-3)
    close(s2, s_full.numpy(), 2e-3)


def test_large_decay_overflows_above_the_diagonal_without_nan():
    """dt·A of -60 a step: exp(seg_i - seg_j) above the diagonal is exp(+60·k),
    inf for k >= 2 in float32. The block selects it away; the result is
    finite and equals the JAX model's."""
    x, dt, A, Bm, Cm = inputs(9, 1, 64, 2, 8, 4)
    dt = np.full_like(dt, 6.0)
    A = np.full_like(A, -10.0)
    args = chunk(x, dt, A, Bm, Cm, 32)
    seg = args[2][0, 0, :, 0]
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(seg[0] - seg[-1]))      # i = 0 < j = Q-1
    got = ssd.ssd_intra_chunk_plain(*(torch.from_numpy(a) for a in args))
    assert all(torch.isfinite(g).all() for g in got)
    D = np.ones(2, np.float32)
    py, ps = ops.ssd(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)), 32)
    jy, js = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)), 32)
    assert torch.isfinite(py).all() and torch.isfinite(ps).all()
    close(py, jy, 2e-3)
    close(ps, js, 2e-3)


def test_cpu_tensors_run_the_plain_version_and_the_wrapper_checks():
    args = [torch.from_numpy(a) for a in chunk(*inputs(11, 1, 64, 2, 8, 4), 32)]
    before = ssd.launches
    for g, w in zip(ssd.ssd_intra_chunk(*args), ssd.ssd_intra_chunk_plain(*args)):
        assert torch.equal(g, w)
    assert ssd.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_intra_chunk_cuda(*args)
    with pytest.raises(ValueError, match="no implementation"):
        ssd.ssd_intra_chunk(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match=r"\(B,nc,Q,nh\)"):
        ssd.ssd_intra_chunk_cuda(args[0], args[1][..., :1], *args[2:])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in inputs(1, 1, 48, 1, 4, 4))
        ops.ssd(x, dt, A, Bm, Cm, torch.ones(1), 32)


# ---------------------------------------------------------------------------
# K3's gradient: the closed form of the backward kernel, and the autograd
# function that launches the two kernels on a card, wired here to counting
# plain versions.
# ---------------------------------------------------------------------------

K3_INPUTS = ("x", "dt", "seg", "Bm", "Cm")
# (B, S, nh, hp, N, Q): ragged Q, N != hp, one head, more heads than a
# forward block's 32
GRAD_SHAPES = [(1, 66, 3, 12, 20, 33), (2, 64, 2, 8, 4, 32), (1, 32, 1, 16, 16, 16),
               (1, 32, 33, 4, 8, 16)]


def output_grads(seed, args):
    """Random gradients of y, state and decay for the block's inputs."""
    B, nc, Q, nh, hp = args[0].shape
    N = args[3].shape[-1]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((B, nc, Q, nh, hp), (B, nc, nh, hp, N), (B, nc, nh))]


def close_to_max(got, want, tol):
    """Within ``tol`` of the gradient's largest magnitude, and ``tol``
    relative."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=tol * float(np.abs(want).max()), rtol=tol)


@pytest.mark.parametrize("B,S,nh,hp,N,Q", GRAD_SHAPES)
def test_closed_form_backward_matches_autograd(B, S, nh, hp, N, Q):
    """ssd_intra_chunk_bwd_plain equals autograd of ssd_intra_chunk_plain at
    1e-5 (float32 sums in another order)."""
    args = [torch.from_numpy(a) for a in chunk(*inputs(S + nh, B, S, nh, hp, N), Q)]
    dy, dstate, ddecay = output_grads(S + N, args)
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(ssd.ssd_intra_chunk_plain(*leaves), leaves,
                               (dy, dstate, ddecay))
    got = ssd.ssd_intra_chunk_bwd_plain(*args, dy, dstate, ddecay)
    for name, g, w in zip(K3_INPUTS, got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, name
        close_to_max(g, w.numpy(), 1e-5)


@pytest.fixture
def plain_launchers(monkeypatch):
    """ssd_intra_chunk routed through SSDIntraChunk on CPU tensors, its two
    launchers swapped for the plain forward and backward; returns the
    counts of their calls."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*args):
        calls["fwd"] += 1
        return ssd.ssd_intra_chunk_plain(*args)

    def bwd(*args):
        calls["bwd"] += 1
        return ssd.ssd_intra_chunk_bwd_plain(*args)

    monkeypatch.setattr(ssd, "ssd_intra_chunk_cuda", fwd)
    monkeypatch.setattr(ssd, "ssd_intra_chunk_bwd_cuda", bwd)
    monkeypatch.setattr(ssd, "ssd_intra_chunk", ssd.SSDIntraChunk.apply)
    return calls


@pytest.mark.parametrize("name", K3_INPUTS)
def test_k3_function_gives_each_inputs_gradient(name, plain_launchers):
    """SSDIntraChunk with ``name`` requiring a gradient: one forward launch,
    one backward launch, and the gradient of the plain block (1e-5); the
    wrapper's launch counts stay where they were."""
    args = [torch.from_numpy(a) for a in chunk(*inputs(11, 1, 64, 2, 8, 4), 32)]
    i = K3_INPUTS.index(name)
    args[i] = args[i].clone().requires_grad_()
    grads = output_grads(12, args)
    before = (ssd.launches, ssd.bwd_launches)
    outs = ssd.SSDIntraChunk.apply(*args)
    assert plain_launchers == {"fwd": 1, "bwd": 0}
    for g, w in zip(outs, ssd.ssd_intra_chunk_plain(*args)):
        assert torch.equal(g, w)
    (got,) = torch.autograd.grad(outs, [args[i]], grads)
    assert plain_launchers == {"fwd": 1, "bwd": 1}
    leaves = [a.detach().clone().requires_grad_() for a in args]
    want = torch.autograd.grad(ssd.ssd_intra_chunk_plain(*leaves), leaves, grads)[i]
    assert got.abs().max() > 0
    close_to_max(got, want.numpy(), 1e-5)
    assert (ssd.launches, ssd.bwd_launches) == before


SSD_ARGS = ("x", "dt", "A", "Bm", "Cm", "D")


@functools.cache
def ssd_grad_case(B, S, nh, hp, N, Q):
    """Inputs, output weights and jax.grad of the weighted sum of y and the
    final state of repro.models.mamba2.ssd_chunked, for every input."""
    arrays = dict(zip(SSD_ARGS[:5], inputs(S * nh + N, B, S, nh, hp, N)))
    arrays["D"] = np.linspace(0.5, 1.5, nh).astype(np.float32)
    rng = np.random.default_rng(N)
    wy = rng.normal(size=(B, S, nh, hp)).astype(np.float32)
    ws = rng.normal(size=(B, nh, hp, N)).astype(np.float32)

    def jloss(*a):
        y, s = JM.ssd_chunked(*a, Q)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    grads = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *(jnp.asarray(arrays[k]) for k in SSD_ARGS))
    return arrays, wy, ws, dict(zip(SSD_ARGS, (np.asarray(g) for g in grads)))


@pytest.mark.parametrize("name", SSD_ARGS)
@pytest.mark.parametrize("B,S,nh,hp,N,Q", GRAD_SHAPES)
def test_ssd_through_k3_function_matches_jax_grad(B, S, nh, hp, N, Q, name, plain_launchers):
    """ops.ssd through SSDIntraChunk (the card's path, with the closed-form
    backward): the gradient of a weighted sum of y and the final state with
    respect to each input equals jax.grad of repro.models.mamba2.ssd_chunked
    (float32, 2e-3 of the gradient's largest magnitude, as the forward)."""
    arrays, wy, ws, jgrads = ssd_grad_case(B, S, nh, hp, N, Q)
    want = jgrads[name]
    order = SSD_ARGS
    leaves = [torch.from_numpy(arrays[k]).requires_grad_(k == name) for k in order]
    y, s = ops.ssd(*leaves, Q)
    ((y * torch.from_numpy(wy)).sum() + (s * torch.from_numpy(ws)).sum()).backward()
    # D enters only the skip term, outside the block: no backward launch
    assert plain_launchers == {"fwd": 1, "bwd": int(name != "D")}
    got = leaves[order.index(name)].grad
    assert got is not None and got.abs().max() > 0
    close_to_max(got, want, 2e-3)


def test_gradient_stays_finite_where_exp_overflows_above_the_diagonal():
    """A chunk of 128 steps of dt·A = -1: exp(seg_i - seg_j) above the
    diagonal reaches exp(127), inf in float32. The plain block's autograd
    gradient is finite and equals the closed form (which never forms the
    upper triangle), as the backward kernel does; jax.grad of the reference
    is NaN there (ROADMAP.md queue 3)."""
    x, dt, A, Bm, Cm = inputs(17, 1, 128, 2, 8, 4)
    dt = np.ones_like(dt)
    A = np.ones_like(A) * -1.0
    args = [torch.from_numpy(a) for a in chunk(x, dt, A, Bm, Cm, 128)]
    seg = args[2][0, 0, :, 0].numpy()
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(seg[0] - seg[-1]))      # i = 0 < j = Q-1
    grads = output_grads(18, args)
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(ssd.ssd_intra_chunk_plain(*leaves), leaves, grads)
    want = ssd.ssd_intra_chunk_bwd_plain(*args, *grads)
    for name, g, w in zip(K3_INPUTS, got, want):
        assert torch.isfinite(g).all(), name
        close_to_max(g, w.numpy(), 1e-5)


@pytest.mark.parametrize("name", ("x", "dt", "A", "Bm", "Cm", "D"))
def test_plain_ssd_keeps_its_full_gradient_on_the_cpu(name):
    """ops.ssd on CPU tensors is differentiable through the plain intra-chunk
    block: the gradient of a weighted sum of y and the final state with
    respect to each input equals jax.grad of repro.models.mamba2.ssd_chunked
    (float32, 2e-3 of the gradient's largest magnitude, as the forward)."""
    arrays = dict(zip(("x", "dt", "A", "Bm", "Cm"), inputs(13, 1, 64, 2, 8, 4)))
    arrays["D"] = np.full(2, 0.5, np.float32)
    order = ("x", "dt", "A", "Bm", "Cm", "D")
    rng = np.random.default_rng(14)
    wy = rng.normal(size=(1, 64, 2, 8)).astype(np.float32)
    ws = rng.normal(size=(1, 2, 8, 4)).astype(np.float32)

    def jloss(*a):
        y, s = JM.ssd_chunked(*a, 32)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    want = jax.grad(jloss, argnums=order.index(name))(*(jnp.asarray(arrays[k]) for k in order))
    leaves = [torch.from_numpy(arrays[k]).requires_grad_(k == name) for k in order]
    y, s = ops.ssd(*leaves, 32)
    ((y * torch.from_numpy(wy)).sum() + (s * torch.from_numpy(ws)).sum()).backward()
    got = leaves[order.index(name)].grad
    assert got is not None and got.abs().max() > 0
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3 * scale, rtol=2e-3)
