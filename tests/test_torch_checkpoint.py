"""The port's checkpoint manager (``repro_torch.checkpoint``): the cases of
``tests/test_checkpoint.py``, checkpoints that cross-restore between the two
packages in both directions (float32, exact), and a bf16 checkpoint written
by the JAX package restored by the port bit for bit.

The JAX package cannot restore bf16 leaves: ``np.savez`` stores them as raw
``|V2`` records and its ``_unflatten_into`` casts those, which raises
``ValueError: No cast function available`` (ROADMAP queue 3).
``test_bf16_from_jax_restores_bit_for_bit`` pins the port's side: it reads
the records as bf16 bits.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_latest as jax_restore  # noqa: E402
from repro.checkpoint import save as jax_save  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import AsyncCheckpointer, restore_latest, save  # noqa: E402
from repro_torch.checkpoint.manager import save_shard  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def _tree(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    params = {"layers": {"w": torch.randn(4, 8, generator=g).to(dtype),
                         "b": torch.zeros(8, dtype=dtype)},
              "embed": torch.randn(16, 4, generator=g).to(dtype)}
    return params, adamw.init(params, AdamWConfig())


def zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    params, opt = _tree()
    opt["count"] += 3
    save(tmp_path, 7, params, opt)
    p2, o2, step = restore_latest(tmp_path, zeros_like(params), zeros_like(opt))
    assert step == 7
    assert_trees_equal(p2, params)
    assert_trees_equal(o2, opt)


def test_latest_wins(tmp_path):
    params, opt = _tree()
    save(tmp_path, 5, params, opt)
    save(tmp_path, 9, tree_map(lambda x: x + 1, params), opt)
    p2, _, step = restore_latest(tmp_path, params, opt)
    assert step == 9
    torch.testing.assert_close(p2["embed"], params["embed"] + 1)


def test_torn_write_is_ignored(tmp_path):
    params, opt = _tree()
    save(tmp_path, 5, params, opt)
    save_shard(tmp_path, 6, 0, params, opt)       # no manifest: crash before phase 2
    assert restore_latest(tmp_path, params, opt)[2] == 5
    bad = {"step": 8, "hosts": [4], "weight": 1.0, "threshold": 5.0,
           "committed": True, "files": []}
    (pathlib.Path(tmp_path) / "manifest_00000008.json").write_text(json.dumps(bad))
    assert restore_latest(tmp_path, params, opt)[2] == 5


def test_shape_mismatch_and_missing_dir(tmp_path):
    params, opt = _tree()
    save(tmp_path, 1, params, opt)
    wrong = {"layers": {"w": torch.zeros(2, 2), "b": torch.zeros(8)},
             "embed": torch.zeros(16, 4)}
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_latest(tmp_path, wrong, opt)
    with pytest.raises(KeyError, match="missing"):
        restore_latest(tmp_path, {**params, "extra": torch.zeros(1)}, opt)
    with pytest.raises(FileNotFoundError):
        restore_latest(tmp_path / "nope", params, opt)


def test_async_checkpointer(tmp_path):
    params, opt = _tree(torch.bfloat16)
    w = AsyncCheckpointer(tmp_path)
    for s in (1, 2, 3):
        w.save(s, params, opt)
        saved = params["embed"].clone()
        params["embed"].add_(1)          # the snapshot was taken at save()
    w.wait()
    p2, _, step = restore_latest(tmp_path, params, opt)
    assert step == 3
    assert torch.equal(p2["embed"], saved)


def jax_tree():
    rng = jax.random.PRNGKey(0)
    params = {"layers": {"w": jax.random.normal(rng, (4, 8)), "b": jnp.arange(8.0)},
              "embed": jax.random.normal(jax.random.fold_in(rng, 1), (16, 4))}
    opt = jax_adamw.init(params, JaxAdamWConfig())
    opt = {**opt, "count": opt["count"] + 5,
           "m": jax.tree.map(lambda x: x + 0.25, opt["m"])}
    return params, opt


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    params, opt = jax_tree()
    jax_save(tmp_path, 4, params, opt)
    tp, to = (convert.params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
              for t in (params, opt))
    p2, o2, step = restore_latest(tmp_path, zeros_like(tp), zeros_like(to))
    assert step == 4
    assert_trees_equal(p2, tp)
    assert_trees_equal(o2, to)
    assert o2["count"].dtype == torch.int32 and int(o2["count"]) == 5


def test_port_checkpoint_restores_in_jax(tmp_path):
    params, opt = jax_tree()
    tp, to = (convert.params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
              for t in (params, opt))
    save(tmp_path, 6, tp, to)
    p2, o2, step = jax_restore(tmp_path, jax.tree.map(jnp.zeros_like, params),
                               jax.tree.map(jnp.zeros_like, opt))
    assert step == 6
    for got, want in ((p2, params), (o2, opt)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the same keys in the same files
    with np.load(next(pathlib.Path(tmp_path).glob("step_*/host0.npz"))) as z:
        assert sorted(z.files) == sorted(
            ["p/embed", "p/layers/b", "p/layers/w", "o/count"]
            + [f"o/{m}/{k}" for m in ("m", "v") for k in ("embed", "layers/b", "layers/w")])


def test_bf16_from_jax_restores_bit_for_bit(tmp_path):
    params, opt = jax_tree()
    params = jax.tree.map(lambda x: (x / 3).astype(jnp.bfloat16), params)
    opt = {**opt, "m": jax.tree.map(lambda x: x.astype(jnp.bfloat16), opt["m"])}
    jax_save(tmp_path, 2, params, opt)
    with np.load(next(pathlib.Path(tmp_path).glob("step_*/host0.npz"))) as z:
        assert z["p/embed"].dtype == np.dtype("V2")       # how np.savez stores bf16
    tp, to = (convert.params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
              for t in (params, opt))
    p2, o2, _ = restore_latest(tmp_path, zeros_like(tp), zeros_like(to))
    assert p2["embed"].dtype == torch.bfloat16
    for got, want in ((p2, params), (o2, opt)):
        for a, b in zip(jax.tree.leaves(convert.params_to_numpy(got)),
                        jax.tree.leaves(jax.tree.map(np.asarray, want))):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # and the port writes bf16 as the same records
    save(tmp_path / "port", 2, tp, to)
    with np.load(next(pathlib.Path(tmp_path).glob("step_*/host0.npz"))) as want, \
            np.load(next((pathlib.Path(tmp_path) / "port").glob("step_*/host0.npz"))) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
