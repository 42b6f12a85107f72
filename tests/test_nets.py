"""The plain-JAX networks (models/nets.py) against two references.

* The linen modules the networks were first written as, kept here as the
  parity reference: same initial variables, same inference and training
  forwards (batch statistics and dropout included), same gradients — bit
  for bit on the CPU. These cases skip where flax is not installed.
* A float32 numpy forward written from the architecture description,
  independent of both implementations.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphazero_tpu.games import ConnectFour
from alphazero_tpu.models import AZConvNet, AZResNet, MLPNet, init_model, make_apply_fn
from alphazero_tpu.models.nets import _path_key

G = ConnectFour()
MODELS = {
    "mlp": lambda dt=jnp.bfloat16: MLPNet(G.num_actions, hidden=(32, 16), dtype=dt),
    "resnet": lambda dt=jnp.bfloat16: AZResNet(
        G.num_actions, channels=16, blocks=2, value_hidden=32, dtype=dt
    ),
    "convnet": lambda dt=jnp.bfloat16: AZConvNet(G.num_actions, channels=8, dtype=dt),
}


def _feats(n=6, seed=3):
    x = jax.random.randint(jax.random.key(seed), (n, 6, 7), -1, 2)
    return jnp.stack([(x == 1), (x == -1)], axis=-1).astype(jnp.float32)


def _reference_modules():
    """The linen definitions of the three networks."""
    nn = pytest.importorskip("flax.linen")

    class MLP(nn.Module):
        num_actions: int
        hidden: tuple
        dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, x, train=False):
            x = x.reshape((x.shape[0], -1)).astype(self.dtype)
            for h in self.hidden:
                x = nn.relu(nn.Dense(h, dtype=self.dtype)(x))
            logits = nn.Dense(self.num_actions, dtype=jnp.float32, name="policy")(x)
            v = nn.Dense(1, dtype=jnp.float32, name="value")(x)
            return logits, jnp.tanh(v)[:, 0]

    class _ResBlock(nn.Module):
        channels: int
        dtype: object

        @nn.compact
        def __call__(self, x, train):
            conv = lambda: nn.Conv(
                self.channels, (3, 3), padding="SAME", use_bias=False, dtype=self.dtype
            )
            bn = lambda: nn.BatchNorm(use_running_average=not train, dtype=jnp.float32)
            y = nn.relu(bn()(conv()(x)))
            y = bn()(conv()(y))
            return nn.relu(x + y.astype(x.dtype))

    class ResNet(nn.Module):
        num_actions: int
        channels: int
        blocks: int
        value_hidden: int
        dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, x, train=False):
            bn = lambda: nn.BatchNorm(use_running_average=not train, dtype=jnp.float32)
            x = x.astype(self.dtype)
            x = nn.Conv(self.channels, (3, 3), padding="SAME", use_bias=False, dtype=self.dtype)(x)
            x = nn.relu(bn()(x)).astype(self.dtype)
            for _ in range(self.blocks):
                x = _ResBlock(self.channels, self.dtype)(x, train)
            p = nn.Conv(2, (1, 1), use_bias=False, dtype=self.dtype)(x)
            p = nn.relu(bn()(p)).reshape((x.shape[0], -1))
            logits = nn.Dense(self.num_actions, dtype=jnp.float32, name="policy")(p)
            v = nn.Conv(1, (1, 1), use_bias=False, dtype=self.dtype)(x)
            v = nn.relu(bn()(v)).reshape((x.shape[0], -1))
            v = nn.relu(nn.Dense(self.value_hidden, dtype=self.dtype)(v))
            v = nn.Dense(1, dtype=jnp.float32, name="value")(v)
            return logits, jnp.tanh(v)[:, 0]

    class ConvNet(nn.Module):
        num_actions: int
        channels: int
        dropout: float = 0.3
        dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, x, train=False):
            bn = lambda: nn.BatchNorm(use_running_average=not train, dtype=jnp.float32)
            x = x.astype(self.dtype)
            for pad in ("SAME", "SAME", "VALID", "VALID"):
                x = nn.Conv(self.channels, (3, 3), padding=pad, use_bias=False, dtype=self.dtype)(x)
                x = nn.relu(bn()(x)).astype(self.dtype)
            x = x.reshape((x.shape[0], -1))
            for h in (1024, 512):
                x = nn.Dense(h, use_bias=False, dtype=self.dtype)(x)
                x = nn.relu(bn()(x)).astype(self.dtype)
                x = nn.Dropout(self.dropout, deterministic=not train)(x)
            logits = nn.Dense(self.num_actions, dtype=jnp.float32, name="policy")(x)
            v = nn.Dense(1, dtype=jnp.float32, name="value")(x)
            return logits, jnp.tanh(v)[:, 0]

    return {
        "mlp": MLP(G.num_actions, hidden=(32, 16)),
        "resnet": ResNet(G.num_actions, channels=16, blocks=2, value_hidden=32),
        "convnet": ConvNet(G.num_actions, channels=8),
    }


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _pair(name, seed=0):
    ref = _reference_modules()[name]
    model = MODELS[name]()
    x = _feats()
    ours = model.init(jax.random.key(seed), x[:1], train=False)
    theirs = ref.init(jax.random.key(seed), x[:1], train=False)
    return model, ref, ours, theirs, x


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("seed", [0, 5])
def test_init_matches_reference(name, seed):
    _, _, ours, theirs, _ = _pair(name, seed)
    _assert_trees_equal(ours, dict(theirs))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_apply_matches_reference(name):
    model, ref, ours, theirs, x = _pair(name)
    if "batch_stats" in ours:
        # non-trivial running statistics, identical on both sides
        ours["batch_stats"] = jax.tree_util.tree_map(
            lambda s: s + 0.1 * jnp.arange(s.size, dtype=s.dtype) % 0.7, ours["batch_stats"]
        )
        theirs = {"params": theirs["params"], "batch_stats": ours["batch_stats"]}
    _assert_trees_equal(
        model.apply(ours, x, train=False), ref.apply(theirs, x, train=False)
    )


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_apply_matches_reference(name):
    """Train mode: batch statistics, running-stat updates and dropout."""
    model, ref, ours, theirs, x = _pair(name)
    rngs = {"dropout": jax.random.key(9)}
    if "batch_stats" in ours:
        out, upd = model.apply(ours, x, train=True, mutable=["batch_stats"], rngs=rngs)
        out_r, upd_r = ref.apply(theirs, x, train=True, mutable=["batch_stats"], rngs=rngs)
        _assert_trees_equal(upd["batch_stats"], dict(upd_r["batch_stats"]))
    else:
        out = model.apply(ours, x, train=True, rngs=rngs)
        out_r = ref.apply(theirs, x, train=True, rngs=rngs)
    _assert_trees_equal(out, out_r)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_gradient_matches_reference(name):
    model, ref, ours, theirs, x = _pair(name)
    rngs = {"dropout": jax.random.key(4)}

    def loss(apply, variables):
        def f(params):
            v = dict(variables, params=params)
            kw = {"mutable": ["batch_stats"]} if "batch_stats" in v else {}
            out = apply(v, x, train=True, rngs=rngs, **kw)
            logits, value = out[0] if kw else out
            return jnp.sum(logits**2) + jnp.sum(value)

        return jax.grad(f)(variables["params"])

    _assert_trees_equal(loss(model.apply, ours), dict(loss(ref.apply, dict(theirs))))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_folded_or_plain_apply_fn_matches_reference(name):
    """``make_apply_fn(fold=False)`` is the module's inference forward."""
    model, ref, ours, theirs, x = _pair(name)
    _assert_trees_equal(
        jax.jit(make_apply_fn(model, fold=False))(ours, x),
        jax.jit(lambda v, f: ref.apply(v, f, train=False))(theirs, x),
    )


# ---------------------------------------------------------------- numpy


def _np_conv(x, w, pad):
    """NHWC x HWIO cross-correlation, 'SAME' or 'VALID'."""
    kh, kw = w.shape[:2]
    if pad == "SAME":
        x = np.pad(x, ((0, 0), (kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2), (0, 0)))
    H, W = x.shape[1] - kh + 1, x.shape[2] - kw + 1
    out = np.zeros((x.shape[0], H, W, w.shape[-1]))
    for i in range(kh):
        for j in range(kw):
            out += x[:, i : i + H, j : j + W, :] @ w[i, j]
    return out


def _np_bn(x, p, s):
    return (x - s["mean"]) / np.sqrt(s["var"] + 1e-5) * p["scale"] + p["bias"]


def _np_forward(name, v, x):
    relu = lambda a: np.maximum(a, 0.0)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    p, s = v["params"], v.get("batch_stats", {})
    x = np.asarray(x, np.float64)
    dense = lambda d, a: a @ d["kernel"] + d.get("bias", 0.0)
    if name == "mlp":
        h = x.reshape(x.shape[0], -1)
        for i in range(2):
            h = relu(dense(p[f"Dense_{i}"], h))
        return dense(p["policy"], h), np.tanh(dense(p["value"], h))[:, 0]
    if name == "resnet":
        h = relu(_np_bn(_np_conv(x, p["Conv_0"]["kernel"], "SAME"), p["BatchNorm_0"], s["BatchNorm_0"]))
        for i in range(2):
            bp, bs = p[f"_ResBlock_{i}"], s[f"_ResBlock_{i}"]
            y = relu(_np_bn(_np_conv(h, bp["Conv_0"]["kernel"], "SAME"), bp["BatchNorm_0"], bs["BatchNorm_0"]))
            y = _np_bn(_np_conv(y, bp["Conv_1"]["kernel"], "SAME"), bp["BatchNorm_1"], bs["BatchNorm_1"])
            h = relu(h + y)
        pl = relu(_np_bn(_np_conv(h, p["Conv_1"]["kernel"], "SAME"), p["BatchNorm_1"], s["BatchNorm_1"]))
        vl = relu(_np_bn(_np_conv(h, p["Conv_2"]["kernel"], "SAME"), p["BatchNorm_2"], s["BatchNorm_2"]))
        vh = relu(dense(p["Dense_0"], vl.reshape(len(x), -1)))
        return dense(p["policy"], pl.reshape(len(x), -1)), np.tanh(dense(p["value"], vh))[:, 0]
    h = x
    for i, pad in enumerate(("SAME", "SAME", "VALID", "VALID")):
        h = relu(_np_bn(_np_conv(h, p[f"Conv_{i}"]["kernel"], pad), p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"]))
    h = h.reshape(len(x), -1)
    for j in range(2):
        h = relu(_np_bn(dense(p[f"Dense_{j}"], h), p[f"BatchNorm_{4 + j}"], s[f"BatchNorm_{4 + j}"]))
    return dense(p["policy"], h), np.tanh(dense(p["value"], h))[:, 0]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("fold", [False, True])
def test_float32_forward_matches_numpy(name, fold):
    """float32 models (and their BN-folded eval) against the numpy
    forward; 1e-4 covers float32 summation-order differences."""
    model = MODELS[name](jnp.float32)
    x = _feats(seed=7)
    v = init_model(model, jax.random.key(2), G.feature_shape)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + 0.05 * (jnp.arange(a.size, dtype=a.dtype) % 3), v["batch_stats"]
        )
    with jax.default_matmul_precision("highest"):
        logits, value = jax.jit(make_apply_fn(model, fold=fold))(v, x)
    want_l, want_v = _np_forward(name, v, x)
    np.testing.assert_allclose(np.asarray(logits), want_l, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(value), want_v, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bfloat16_forward_near_numpy(name):
    """The production bf16 forward stays within bf16 rounding of the
    float64 numpy forward (|logit| ~ 1 at init; 8 mantissa bits through a
    few layers -> a few 1e-2)."""
    model = MODELS[name]()
    x = _feats(seed=8)
    v = init_model(model, jax.random.key(1), G.feature_shape)
    logits, value = jax.jit(make_apply_fn(model, fold=False))(v, x)
    want_l, want_v = _np_forward(name, v, x)
    np.testing.assert_allclose(np.asarray(logits), want_l, atol=0.1)
    np.testing.assert_allclose(np.asarray(value), want_v, atol=0.05)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_variables_layout(name):
    """Layer names, kernel shapes and dtypes the checkpoints and the BN
    fold address."""
    v = init_model(MODELS[name](), jax.random.key(0), G.feature_shape)
    p = v["params"]
    assert p["policy"]["kernel"].shape[-1] == G.num_actions
    assert p["value"]["kernel"].shape[-1] == 1
    assert all(l.dtype == jnp.float32 for l in jax.tree_util.tree_leaves(v))
    if name == "mlp":
        assert sorted(p) == ["Dense_0", "Dense_1", "policy", "value"]
        assert "batch_stats" not in v
    elif name == "resnet":
        assert p["_ResBlock_1"]["Conv_1"]["kernel"].shape == (3, 3, 16, 16)
        assert sorted(v["batch_stats"]["_ResBlock_0"]) == ["BatchNorm_0", "BatchNorm_1"]
        assert sorted(v["batch_stats"]["BatchNorm_2"]) == ["mean", "var"]
    else:
        assert p["Dense_0"]["kernel"].shape == (2 * 3 * 8, 1024)
        assert "bias" not in p["Dense_0"]


def test_param_key_depends_on_path_only():
    """A kernel's init key is the rng folded with a hash of its layer
    path: same path, same key; sibling paths differ."""
    k = jax.random.key(0)
    a = jax.random.key_data(_path_key(k, ("Dense_0", 1)))
    b = jax.random.key_data(_path_key(k, ("Dense_0", 1)))
    c = jax.random.key_data(_path_key(k, ("Dense_1", 1)))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    h = int.from_bytes(hashlib.sha1(b"Dense_0\x01").digest()[:4], "big")
    np.testing.assert_array_equal(
        np.asarray(a), np.asarray(jax.random.key_data(jax.random.fold_in(k, h)))
    )


def test_dropout_only_in_train_mode():
    model = MODELS["convnet"]()
    v = init_model(model, jax.random.key(0), G.feature_shape)
    x = _feats()
    e1 = model.apply(v, x, train=False)
    e2 = model.apply(v, x, train=False, rngs={"dropout": jax.random.key(1)})
    _assert_trees_equal(e1, e2)
    (t1, _), (t2, _) = (
        model.apply(v, x, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.key(k)})[0]
        for k in (1, 2)
    )
    assert not np.array_equal(np.asarray(t1), np.asarray(t2))
