"""K2 in the port: its plain version against the Pallas kernel and the JAX
reference, its routing and its launch wrapper's checks (on the CPU).

The Pallas kernel runs in interpret mode on the cases of
``tests/test_kernels.py`` (flash attention). Tolerances are those of that
file: 2e-5 in float32 (the same arithmetic summed in another order) and
2e-2 in bfloat16 (the reference rounds the logits to bf16 before the
softmax, the kernel does not). A ragged S, which the Pallas kernel refuses,
is held against ``attend_full`` alone, and so are keys of their own length
(cross-attention) beside the reference's ``attend`` and ``attend_chunked``.
The plain version's autograd gradient,
which the backward kernel is held to on a card, is held here against
``jax.grad`` of the JAX reference. The CUDA kernels are tested on a GPU by
``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(seed, B, S, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    out = []
    for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)):
        j = jnp.asarray(rng.normal(size=shape), jdt)
        out.append((j, convert.to_tensor(np.asarray(j), tdt, device="cpu")))
    return out


def check(got, want, dtype, tol=None):
    tol = tol or DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk", [
    (1, 256, 4, 2, 64, 128, 128),
    (2, 256, 4, 4, 32, 64, 128),
    (1, 512, 8, 2, 64, 128, 256),
])
def test_plain_matches_pallas_interpret_and_ref(dtype, B, S, H, KV, hd, bq, bk):
    (jq, q), (jk, k), (jv, v) = inputs(S + H, B, S, H, KV, hd, dtype)
    got = fa.flash_attention_plain(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    check(got, pallas_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                            interpret=True), dtype)
    check(got, jref.flash_attention_ref(jq, jk, jv, causal=True), dtype)
    check(ref.flash_attention_ref(q, k, v, causal=True),
          jref.flash_attention_ref(jq, jk, jv, causal=True), dtype)


def test_plain_non_causal():
    (jq, q), (jk, k), (jv, v) = inputs(1, 1, 256, 2, 2, 64, "float32")
    got = ops.flash_attention(q, k, v, causal=False)
    check(got, pallas_flash(jq, jk, jv, causal=False, interpret=True), "float32")
    check(got, jref.flash_attention_ref(jq, jk, jv, causal=False), "float32")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_ragged_length(causal):
    """S = 200 divides into no block: the port's kernel takes it, so its plain
    version is held to attend_full."""
    (jq, q), (jk, k), (jv, v) = inputs(2, 2, 200, 4, 2, 32, "float32")
    check(fa.flash_attention(q, k, v, causal=causal),
          JL.attend_full(jq, jk, jv, causal=causal), "float32")


def cross_inputs(seed, B, S, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)):
        j = jnp.asarray(rng.normal(size=shape), jnp.float32)
        out.append((j, convert.to_tensor(np.asarray(j), torch.float32, device="cpu")))
    return out


@pytest.mark.parametrize("B,S,Sk,H,KV,hd", [
    (2, 1, 512, 4, 4, 64),        # decode: one query against the encoder's keys
    (1, 1024, 512, 4, 2, 32),     # S > ATTN_CHUNK: chunked over the queries
    (2, 77, 300, 6, 2, 16),       # ragged lengths, GQA
    (1, 40, 1, 2, 1, 32),         # one key
])
def test_plain_cross_attention_matches_jax(B, S, Sk, H, KV, hd):
    """Keys of their own length (cross-attention, non-causal): the plain
    version, through the entry point, against the reference's attend_full,
    and attend_chunked where the reference's attend takes it."""
    (jq, q), (jk, k), (jv, v) = cross_inputs(S + Sk, B, S, Sk, H, KV, hd)
    got = ops.flash_attention(q, k, v, causal=False)
    assert got.shape == q.shape and got.dtype == q.dtype
    check(got, JL.attend_full(jq, jk, jv, causal=False), "float32")
    check(got, JL.attend(jq, jk, jv, causal=False), "float32")
    if S > fa.ATTN_CHUNK:
        check(got, JL.attend_chunked(jq, jk, jv, causal=False), "float32")


def test_wrapper_takes_keys_of_their_own_length_only_without_a_mask():
    q, k = torch.zeros(1, 8, 2, 64), torch.zeros(1, 24, 2, 64)
    with pytest.raises(ValueError, match="own length"):
        fa.flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(ValueError, match="own length"):
        fa.flash_attention_cuda(q, k[:, :0], k[:, :0], causal=False)
    with pytest.raises(ValueError, match="own length"):
        fa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 8), causal=True)
    # non-causal with 24 keys passes the shape checks and stops at the device,
    # forward and backward
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, k, causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 8), causal=False)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    (_, q), (_, k), (_, v) = inputs(3, 1, 64, 2, 1, 32, "float32")
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=True))
    assert fa.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="no implementation"):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention_cuda(torch.zeros(1, 8, 3, 64), q, q)
    with pytest.raises(ValueError, match=r"\(B,S,H,hd\)"):
        fa.flash_attention_cuda(q[0], q, q)


# ---------------------------------------------------------------------------
# K2's gradient: the plain version's autograd gradient (the yardstick of the
# backward kernel on a card) against jax.grad of the JAX reference, float32,
# at atol 2e-5 of the largest gradient and rtol 2e-5 (the same arithmetic's
# gradient summed in another order).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (1, 256, 4, 2, 64, True), (2, 200, 4, 4, 32, True), (1, 130, 4, 1, 16, False),
    (1, 1024, 2, 1, 128, True), (2, 64, 4, 2, 16, True)])
def test_plain_gradient_matches_jax_grad(B, S, H, KV, hd, causal):
    (jq, q), (jk, k), (jv, v) = inputs(S + hd, B, S, H, KV, hd, "float32")
    do = np.random.default_rng(S).normal(size=(B, S, H, hd)).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jref.flash_attention_ref(q_, k_, v_, causal=causal) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.bwd_launches
    out = ops.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    assert fa.bwd_launches == before          # the CPU runs the plain gradient
    for t, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        w = np.asarray(w)
        assert t.grad.shape == w.shape and t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), w, atol=2e-5 * np.abs(w).max(),
                                   rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("B,S,Sk,H,KV,hd", [
    (2, 1, 512, 4, 2, 64),        # decode: one query against the encoder's keys
    (2, 40, 1, 4, 2, 32),         # one key
    (1, 1024, 512, 4, 2, 32),     # S > ATTN_CHUNK: chunked over the queries
])
def test_plain_cross_attention_gradient_matches_jax_grad(B, S, Sk, H, KV, hd):
    """Keys of their own length (non-causal, GQA): the plain version's
    autograd gradient, which K2's backward is held to on a card, against
    ``jax.grad`` of the reference's ``attend_full`` and ``attend`` (which
    takes ``attend_chunked`` where S > ATTN_CHUNK), at the tolerance above."""
    (jq, q), (jk, k), (jv, v) = cross_inputs(S + Sk + 7, B, S, Sk, H, KV, hd)
    do = np.random.default_rng(S + Sk).normal(size=(B, S, H, hd)).astype(np.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=False)
    out.backward(torch.from_numpy(do))
    for attend in (JL.attend_full, JL.attend):
        want = jax.grad(lambda q_, k_, v_: jnp.sum(attend(q_, k_, v_, causal=False) * do),
                        argnums=(0, 1, 2))(jq, jk, jv)
        for t, w, name in zip(leaves, want, ("dq", "dk", "dv")):
            w = np.asarray(w)
            assert t.grad.shape == w.shape and t.grad.dtype == torch.float32
            np.testing.assert_allclose(t.grad.numpy(), w, atol=2e-5 * np.abs(w).max(),
                                       rtol=2e-5, err_msg=f"{attend.__name__} {name}")


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd_cuda(q, q, q, q[:, :4], lse)
