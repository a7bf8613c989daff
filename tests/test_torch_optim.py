"""The port's optimizer, schedules and int8 gradient compression
(``repro_torch.optim``) against the JAX package's on the same numpy inputs.

AdamW: float32 moments at rtol 1e-6 (the same float32 arithmetic; pow and
sqrt may differ in the last bit), bf16 moments and parameters at one bf16
ulp (a float32 result one ulp apart may round to neighbouring bf16 values).
Schedules: every step 0-10,000 at rtol 1e-6 and atol 1e-7. Compression: q
and the scale equal, the error feedback at 1e-6; plus the cases of
``tests/test_optim.py`` run on the port.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import grad_compress as jax_gc  # noqa: E402
from repro.optim import schedule as jax_schedule  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw, grad_compress, schedule  # noqa: E402


def tree_np(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"layers": {"w": (rng.normal(size=(4, 8)) * scale).astype(dtype),
                       "b": (rng.normal(size=8) * scale).astype(dtype)},
            "embed": (rng.normal(size=(16, 4)) * scale).astype(dtype)}


def to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def to_port(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(moment_dtype):
    jdt = jnp.float32 if moment_dtype == "float32" else jnp.bfloat16
    jcfg = JaxAdamWConfig(lr=1e-2, moment_dtype=moment_dtype, grad_clip=5.0)
    cfg = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype, grad_clip=5.0)
    jp = to_jax(tree_np(0), jdt)
    jstate = jax_adamw.init(jp, jcfg)
    tp, tstate = to_port(jp), adamw.init(to_port(jp), cfg)
    assert tstate["count"].dtype == torch.int32 and tstate["count"].shape == ()
    for step in range(5):
        # steps 3 and 4 have a global norm above grad_clip: clipping is on
        grads = to_jax(tree_np(10 + step, scale=1.0 if step < 3 else 10.0), jdt)
        scale = float(jax_schedule.cosine_with_warmup(jnp.int32(step), warmup=2, total=10))
        jp, jstate, jm = jax_adamw.update(grads, jstate, jp, jcfg, lr_scale=scale)
        tp, tstate, tm = adamw.update(to_port(grads), tstate, tp, cfg, lr_scale=scale)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        for got, want in ((tp, jp), (tstate["m"], jstate["m"]), (tstate["v"], jstate["v"])):
            for g, w in zip(jax.tree.leaves(convert.params_to_numpy(got)),
                            jax.tree.leaves(jax.tree.map(np.asarray, want))):
                assert g.dtype == w.dtype
                g, w = g.astype(np.float32), w.astype(np.float32)
                if moment_dtype == "float32":
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
                else:   # one bf16 ulp of the larger
                    ulp = np.abs(w) * 2.0 ** -7 + 1e-30
                    assert np.all(np.abs(g - w) <= ulp), step


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_updates_large_leaves_a_slice_at_a_time_bit_for_bit(monkeypatch, moment_dtype):
    """Leaves are updated in slices along their first dimension of at most
    ``SLICE_ELEMENTS`` elements (here lowered to 10), or one index: the same
    elementwise arithmetic, so parameters and moments equal the update of
    each leaf in one slice bit for bit, 3-d leaves, slices of several
    indices, 1-d leaves and bf16 parameters included."""
    rng = np.random.default_rng(7)

    def tree(scale):
        return {"experts": torch.from_numpy((rng.normal(size=(3, 4, 5)) * scale)
                                            .astype(np.float32)),
                "w": torch.from_numpy(rng.normal(size=(12, 2)).astype(np.float32))
                .to(torch.bfloat16),
                "b": torch.from_numpy(rng.normal(size=40).astype(np.float32))}
    cfg = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype, grad_clip=5.0)
    params = tree(1.0)
    grads = [tree(10.0 if step else 1.0) for step in range(3)]
    runs = []
    for elements in (adamw.SLICE_ELEMENTS, 10):
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", elements)
        p = {k: t.clone() for k, t in params.items()}
        state = adamw.init(p, cfg)
        for g in grads:
            p, state, _ = adamw.update(g, state, p, cfg, lr_scale=0.5)
        runs.append((p, state["m"], state["v"]))
    for got, want in zip(runs[1], runs[0]):
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_adamw_cases_of_the_reference():
    """``tests/test_optim.py``'s AdamW cases, on the port."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params, cfg)
    for _ in range(300):
        params, state, _ = adamw.update({"w": 2 * (params["w"] - target)}, state,
                                        params, cfg)
    torch.testing.assert_close(params["w"], target, atol=1e-2, rtol=0)

    cfg = AdamWConfig(lr=0.01, weight_decay=0.5)
    params = {"w": torch.ones(4) * 10.0}
    state = adamw.init(params, cfg)
    for _ in range(50):
        params, state, _ = adamw.update({"w": torch.zeros(4)}, state, params, cfg)
    assert float(params["w"].abs().max()) < 10.0

    params = {"w": torch.zeros(3)}
    _, _, m = adamw.update({"w": torch.ones(3) * 1e3}, adamw.init(params, AdamWConfig()),
                           params, AdamWConfig(grad_clip=1.0))
    assert float(m["grad_norm"]) > 1e3

    cfg = AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    state = adamw.init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    p2, s2, _ = adamw.update({"w": torch.ones(8, dtype=torch.bfloat16)}, state, params, cfg)
    assert p2["w"].dtype == torch.bfloat16 and s2["v"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["cosine_with_warmup", "linear_decay"])
def test_schedules_match_jax(name):
    steps = np.arange(0, 10_001)
    for kw in ({}, {"warmup": 10, "total": 100, "min_ratio": 0.1},
               {"warmup": 0, "total": 5000, "min_ratio": 0.3}):
        want = np.asarray(jax.vmap(lambda s: getattr(jax_schedule, name)(s, **kw))(
            jnp.asarray(steps, jnp.int32)))
        got = getattr(schedule, name)(torch.from_numpy(steps).int(), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        for s in (0, 10, 100, 9_999):       # a Python int, as a loop passes it
            np.testing.assert_allclose(float(getattr(schedule, name)(s, **kw)),
                                       float(want[s]), rtol=1e-6, atol=1e-7)
    assert float(schedule.cosine_with_warmup(0, warmup=10, total=100)) == 0.0
    assert abs(float(schedule.cosine_with_warmup(100, warmup=10, total=100,
                                                 min_ratio=0.1)) - 0.1) < 1e-6


@given(seed=st.integers(0, 2**31), scale=st.floats(1e-3, 1e3))
@settings(max_examples=30, deadline=None)
def test_compress_matches_jax(seed, scale):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=257) * scale).astype(np.float32)
    g[:3] = [0.5, -0.5, 1.5]        # halves: q rounds half to even in both
    err = (rng.normal(size=257) * scale * 1e-3).astype(np.float32)
    jq, js, je = jax_gc.compress(jnp.asarray(g), jnp.asarray(err))
    q, s, e = grad_compress.compress(torch.from_numpy(g), torch.from_numpy(err))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose((grad_compress.decompress(q, s) + e).numpy(),
                               g + err, rtol=1e-5, atol=1e-5 * scale)
    assert float(e.abs().max()) <= float(s) * 0.51


def test_compress_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])   # scale 1
    q, s, _ = grad_compress.compress(g, torch.zeros(6))
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def test_compress_tree_matches_jax():
    grads = tree_np(3)
    jq, js, je = jax_gc.compress_tree(to_jax(grads, jnp.float32),
                                      jax_gc.init_error(to_jax(grads, jnp.float32)))
    tg = to_port(grads)
    q, s, e = grad_compress.compress_tree(tg, grad_compress.init_error(tg))
    for got, want in ((q, jq), (s, js), (e, je)):
        for g, w in zip(jax.tree.leaves(convert.params_to_numpy(got)),
                        jax.tree.leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    out = grad_compress.decompress_tree(q, s)
    for g, w in zip(jax.tree.leaves(convert.params_to_numpy(out)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jax_gc.decompress_tree(jq, js)))):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert grad_compress.compressed_bytes(q) == jax_gc.compressed_bytes(jq) == 104


def test_compress_error_feedback_unbiased_over_time():
    """``tests/test_optim.py``'s case, on the port."""
    rng = np.random.default_rng(0)
    err = torch.zeros(32)
    true_sum = np.zeros(32)
    got_sum = np.zeros(32)
    for _ in range(200):
        g = torch.from_numpy(rng.normal(size=32).astype(np.float32))
        q, s, err = grad_compress.compress(g, err)
        true_sum += g.numpy()
        got_sum += grad_compress.decompress(q, s).numpy()
    np.testing.assert_allclose(got_sum + err.numpy(), true_sum, rtol=1e-4, atol=1e-3)
