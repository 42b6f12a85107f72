"""checkpoint.py: the on-disk format, atomic writes and template restores
(the Coach-level resume paths are in tests/test_coach.py and
tests/test_parallel.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from alphazero_tpu import checkpoint as ck
from alphazero_tpu.parallel import make_mesh


def _payload(seed=0):
    k = jax.random.key(seed)
    return {
        "incumbent": {
            "params": {"Dense_0": {"kernel": jax.random.normal(k, (5, 3))}},
            "step": jnp.asarray(7, jnp.int32),
        },
        "replay": {
            "data": jnp.arange(24, dtype=jnp.float32).reshape(8, 3) + seed,
            "flags": jnp.asarray([True, False, True]),
        },
        "half": jnp.asarray([1.5, -2.25], jnp.bfloat16),
        "rng": jax.random.key_data(k),
    }


def _assert_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip_preserves_values_dtypes_and_sidecar(tmp_path):
    p = _payload()
    path = ck.save_checkpoint(str(tmp_path), 3, p, sidecar={"iteration": 3})
    assert path.endswith("ckpt_000003")
    got, side = ck.restore_checkpoint(str(tmp_path), 3, _payload(seed=1))
    _assert_equal(got, p)
    assert side == {"iteration": 3}
    assert all(isinstance(l, jax.Array) for l in jax.tree_util.tree_leaves(got))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int8, jnp.uint32, jnp.bool_])
def test_every_leaf_dtype_roundtrips(tmp_path, dtype):
    x = (jnp.arange(12) % 3 - 1).reshape(3, 4).astype(dtype)
    ck.save_checkpoint(str(tmp_path), 1, {"x": x})
    got, side = ck.restore_checkpoint(str(tmp_path), 1, {"x": jnp.zeros_like(x)})
    _assert_equal(got, {"x": x})
    assert side is None


def test_write_is_atomic_and_the_sidecar_comes_first(tmp_path, monkeypatch):
    """A crash while the arrays are written leaves the sidecar and a
    ``.tmp`` directory — no ``ckpt_*`` directory the resume could pick."""
    calls = []
    real_save = np.save

    def crashing_save(f, arr):
        calls.append(f)
        if len(calls) == 2:
            raise OSError("disk full")
        real_save(f, arr)

    monkeypatch.setattr(np, "save", crashing_save)
    with pytest.raises(OSError):
        ck.save_checkpoint(str(tmp_path), 5, _payload(), sidecar={"has_rings": False})
    names = sorted(os.listdir(tmp_path))
    assert names == ["ckpt_000005.json", "ckpt_000005.tmp"]
    assert ck.latest_step(str(tmp_path)) is None
    assert ck.newest_ring_step(str(tmp_path)) is None
    # the next save of the same step completes and replaces the leftovers
    monkeypatch.setattr(np, "save", real_save)
    ck.save_checkpoint(str(tmp_path), 5, _payload(), sidecar={"has_rings": True})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000005", "ckpt_000005.json"]
    assert ck.latest_step(str(tmp_path)) == 5


def test_same_step_resave_replaces_the_arrays(tmp_path):
    ck.save_checkpoint(str(tmp_path), 2, _payload(seed=0))
    ck.save_checkpoint(str(tmp_path), 2, _payload(seed=4))
    got, _ = ck.restore_checkpoint(str(tmp_path), 2, _payload())
    _assert_equal(got, _payload(seed=4))


def test_manifest_lists_leaves_by_key_path(tmp_path):
    path = ck.save_checkpoint(str(tmp_path), 1, _payload())
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["incumbent/params/Dense_0/kernel"]["shape"] == [5, 3]
    assert manifest["half"]["dtype"] == "bfloat16"
    assert manifest["replay/flags"]["dtype"] == "bool"


@pytest.mark.parametrize(
    "template, match",
    [
        (lambda p: {**p, "extra": jnp.zeros(2)}, "missing"),
        (lambda p: {k: v for k, v in p.items() if k != "replay"}, "unexpected"),
        (lambda p: {**p, "half": jnp.zeros((2,), jnp.float32)}, "half"),
        (lambda p: {**p, "rng": jnp.zeros((3,), jnp.uint32)}, "rng"),
    ],
)
def test_template_mismatch_raises(tmp_path, template, match):
    """Exact restores refuse a template whose keys, dtypes or shapes
    differ — Coach's optional-subtree fallback keys off this error."""
    ck.save_checkpoint(str(tmp_path), 1, _payload())
    with pytest.raises(ValueError, match=match):
        ck.restore_checkpoint(str(tmp_path), 1, template(_payload()))


def test_partial_restore_takes_a_subtree(tmp_path):
    p = _payload()
    ck.save_checkpoint(str(tmp_path), 1, p)
    got, _ = ck.restore_checkpoint(
        str(tmp_path), 1, {"incumbent": _payload(seed=3)["incumbent"]}, partial=True
    )
    _assert_equal(got, {"incumbent": p["incumbent"]})
    with pytest.raises(ValueError, match="missing"):
        ck.restore_checkpoint(str(tmp_path), 1, {"nope": jnp.zeros(1)}, partial=True)


def test_sharded_restore_follows_the_template(tmp_path):
    """Committed template leaves carry their NamedSharding into the
    restore; uncommitted ones land on the first local device."""
    mesh = make_mesh()
    n = mesh.shape["data"]
    data_b = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    x = jax.device_put(jnp.arange(4 * n, dtype=jnp.float32).reshape(2 * n, 2), data_b)
    y = jax.device_put(jnp.ones((3,), jnp.float32), repl)
    ck.save_checkpoint(str(tmp_path), 9, {"x": x, "y": y, "z": np.arange(3)})
    template = {
        "x": jax.device_put(jnp.zeros_like(x), data_b),
        "y": jax.device_put(jnp.zeros_like(y), repl),
        "z": np.zeros(3, np.int64),
    }
    got, _ = ck.restore_checkpoint(str(tmp_path), 9, template)
    assert got["x"].sharding == data_b and got["y"].sharding == repl
    assert len(got["x"].sharding.device_set) == n
    assert got["z"].sharding.device_set == {jax.local_devices()[0]}
    np.testing.assert_array_equal(np.asarray(got["x"]), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(got["z"]), np.arange(3))


def test_step_listing_and_pruning(tmp_path):
    for s in (1, 2, 3, 4):
        ck.save_checkpoint(
            str(tmp_path), s, {"a": jnp.zeros(1)}, sidecar={"has_rings": s == 1}
        )
    os.makedirs(tmp_path / "ckpt_000007.tmp")  # an interrupted write
    assert ck.latest_step(str(tmp_path)) == 4
    assert ck.newest_ring_step(str(tmp_path)) == 1
    assert ck.newest_ring_step(str(tmp_path), exclude=1) is None
    assert ck.prune_checkpoints(str(tmp_path), 2) == [2]
    assert ck._steps(str(tmp_path)) == [1, 3, 4]
    assert not os.path.exists(tmp_path / "ckpt_000002.json")
    assert ck.latest_step(str(tmp_path / "absent")) is None
