"""Policy/value networks — the NNet family.

Re-design of the reference's NN stack: the ``NNet`` trait
(reference: src/nnet.rs:35-45), the embedded-Python bridge
(examples/utils/python_nnet.rs), the TF1 CNN spec
(examples/connect_four_lib/connect_four_net.py:20-100, treated as an
architecture/loss spec only — defect D10) and the uniform dummy net
(examples/connect_four.rs:12-43 ``DumbConnectFourNnet``).

Interface: every model exposes ``apply_fn(variables, features[B, ...]) ->
(policy_logits[B, A], value[B])`` — a pure function fused straight into the
search step (no inference service thread / channel hop,
async_mcts.rs:117-189). Variables are nested dicts ``{'params': ...,
'batch_stats': ...}`` keyed by layer name (``Dense_0``, ``Conv_1``,
``BatchNorm_2``, ``_ResBlock_0/Conv_0``, ``policy``, ``value``); model
versioning is plain pytree substitution (incumbent vs candidate live side
by side), replacing the reference's checkpoint-reload-on-model-id scheme
(python_nnet.rs:65-75,106-117).

The modules are plain JAX: ``init(rng, sample, train=False)`` and
``apply(variables, x, train=False, mutable=None, rngs=None)`` walk one
forward function that reads each parameter by name (and, at init, creates
it). A parameter's init key is the init rng folded with a SHA-1 hash of
its layer path, so a parameter's value depends only on its name and shape,
never on the order layers are built in.

Compute dtype is bfloat16 on the matmul/conv path, float32 for
normalization statistics and head outputs.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

_relu = jax.nn.relu
_lecun_normal = jax.nn.initializers.lecun_normal()
_BN_MOMENTUM = 0.99
_BN_EPS = 1e-5


class UniformModel:
    """Uniform policy, constant value — the pure-MCTS baseline net
    (examples/connect_four.rs:12-43). The reference's returned value 1.0 for
    every board; 0.0 (neutral) is this framework's default, configurable."""

    def __init__(self, num_actions: int, value: float = 0.0):
        self.num_actions = num_actions
        self.value = value

        def apply_fn(variables: Any, feats: jax.Array) -> Tuple[jax.Array, jax.Array]:
            del variables
            b = feats.shape[0]
            return (
                jnp.zeros((b, num_actions), jnp.float32),
                jnp.full((b,), value, jnp.float32),
            )

        # the search skips feature materialization for feature-free models
        apply_fn.needs_features = False
        self.apply_fn = apply_fn

    def init(self, rng: jax.Array, sample: jax.Array) -> Any:
        del rng, sample
        return {}


def make_uniform_model(game, value: float = 0.0) -> UniformModel:
    return UniformModel(game.num_actions, value)


def _path_key(rng: jax.Array, path: Tuple[Any, ...]) -> jax.Array:
    """Fold a layer path (names, then the layer's key counter) into
    ``rng`` through the first 4 bytes of its SHA-1 digest."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(
        rng, jnp.uint32(int.from_bytes(m.digest()[:4], byteorder="big"))
    )


class _Layers:
    """Named-parameter access for one forward pass.

    With ``init_rng`` set, a parameter missing from ``params`` is created
    (kernels from lecun-normal under the layer's path key, biases and BN
    shifts zero, BN scales one, running stats mean 0 / var 1). In train
    mode BatchNorm normalizes with batch statistics and records updated
    running statistics in ``new_stats``; otherwise it uses the stored ones.
    """

    def __init__(self, params, stats, train: bool, init_rng=None, dropout_rng=None):
        self.params = params
        self.stats = stats
        self.train = train
        self.init_rng = init_rng
        self.dropout_rng = dropout_rng
        self.new_stats = {}

    def _node(self, tree, path):
        for name in path:
            tree = tree.setdefault(name, {}) if self.init_rng is not None else tree[name]
        return tree

    def _param(self, path, name, shape, init):
        node = self._node(self.params, path)
        if self.init_rng is not None and name not in node:
            if init is _lecun_normal:
                node[name] = init(_path_key(self.init_rng, path + (1,)), shape, jnp.float32)
            else:
                node[name] = init(shape, jnp.float32)
        return node[name]

    def dense(self, path, x, features: int, dtype, use_bias: bool = True):
        kernel = self._param(path, "kernel", (x.shape[-1], features), _lecun_normal)
        y = lax.dot_general(
            x.astype(dtype), kernel.astype(dtype), (((x.ndim - 1,), (0,)), ((), ()))
        )
        if use_bias:
            bias = self._param(path, "bias", (features,), jnp.zeros)
            y = y + bias.astype(dtype).reshape((1,) * (y.ndim - 1) + (-1,))
        return y

    def conv(self, path, x, features: int, kernel_size, padding, dtype):
        shape = tuple(kernel_size) + (x.shape[-1], features)
        kernel = self._param(path, "kernel", shape, _lecun_normal)
        return lax.conv_general_dilated(
            x.astype(dtype),
            kernel.astype(dtype),
            (1,) * len(kernel_size),
            padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )

    def batch_norm(self, path, x):
        feat = (x.shape[-1],)
        axes = tuple(range(x.ndim - 1))
        scale = self._param(path, "scale", feat, jnp.ones)
        bias = self._param(path, "bias", feat, jnp.zeros)
        node = self._node(self.stats, path)
        if self.init_rng is not None and "mean" not in node:
            node["mean"] = jnp.zeros(feat, jnp.float32)
            node["var"] = jnp.ones(feat, jnp.float32)
        if self.train:
            # fast variance E[x^2] - E[x]^2 in float32, clipped at 0
            xf = x.astype(jnp.float32)
            mean = xf.mean(axes)
            var = jnp.maximum(0.0, lax.square(xf).mean(axes) - lax.square(mean))
            out = self.new_stats
            for name in path:
                out = out.setdefault(name, {})
            out["mean"] = _BN_MOMENTUM * node["mean"] + (1 - _BN_MOMENTUM) * mean
            out["var"] = _BN_MOMENTUM * node["var"] + (1 - _BN_MOMENTUM) * var
        else:
            mean, var = node["mean"], node["var"]
        y = x - mean
        mul = lax.rsqrt(var + _BN_EPS) * scale
        return (y * mul + bias).astype(jnp.float32)

    def dropout(self, path, x, rate: float):
        if not self.train or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = jax.random.bernoulli(
            _path_key(self.dropout_rng, path + (1,)), p=keep, shape=x.shape
        )
        return lax.select(mask, x / keep, jnp.zeros_like(x))


class _Net:
    """``init``/``apply`` over a model's ``_forward(layers, x)``."""

    def init(self, rng: jax.Array, sample: jax.Array, train: bool = False) -> dict:
        del train  # init always runs the inference forward
        layers = _Layers({}, {}, train=False, init_rng=rng)
        self._forward(layers, sample)
        variables = {"params": layers.params}
        if layers.stats:
            variables["batch_stats"] = layers.stats
        return variables

    def apply(self, variables, x, train: bool = False, mutable=None, rngs=None):
        """``(logits, value)``; with ``mutable=["batch_stats"]`` also the
        updated running statistics ``{"batch_stats": ...}`` (train mode)."""
        layers = _Layers(
            variables["params"],
            variables.get("batch_stats", {}),
            train=train,
            dropout_rng=(rngs or {}).get("dropout"),
        )
        out = self._forward(layers, x)
        if mutable:
            return out, {"batch_stats": layers.new_stats or layers.stats}
        return out


@dataclasses.dataclass(frozen=True)
class MLPNet(_Net):
    """Tiny MLP policy/value net (BASELINE config 2)."""

    num_actions: int
    hidden: Sequence[int] = (256, 256)
    dtype: Any = jnp.bfloat16

    def _forward(self, layers: _Layers, x: jax.Array):
        x = x.reshape((x.shape[0], -1)).astype(self.dtype)
        for i, h in enumerate(self.hidden):
            x = _relu(layers.dense((f"Dense_{i}",), x, h, self.dtype))
        logits = layers.dense(("policy",), x, self.num_actions, jnp.float32)
        v = layers.dense(("value",), x, 1, jnp.float32)
        return logits, jnp.tanh(v)[:, 0]


def _fold_conv_bn(kernel, bn_params, bn_stats, dtype, eps: float = _BN_EPS):
    """Fold an inference BatchNorm into the preceding bias-free conv/dense
    kernel: returns (W * gamma/sqrt(var+eps), beta - mean*gamma/sqrt(...))
    in the compute dtype. Scale applies to the output-channel (last) dim."""
    inv = 1.0 / jnp.sqrt(bn_stats["var"] + eps)
    scale = bn_params["scale"] * inv
    w = kernel * scale.reshape((1,) * (kernel.ndim - 1) + (-1,))
    b = bn_params["bias"] - bn_stats["mean"] * scale
    return w.astype(dtype), b.astype(dtype)


@dataclasses.dataclass(frozen=True)
class AZResNet(_Net):
    """AlphaZero-style conv resnet — the flagship model (BASELINE config 3).

    Stem conv + residual tower + 1x1-conv policy/value heads, BN throughout
    (the modern successor of the reference's plain 4-conv CNN spec,
    connect_four_net.py:20-100: conv3x3x512 stack + BN + ReLU + dense heads,
    pi = softmax(Dense(A)), v = tanh(Dense(1))).
    """

    num_actions: int
    channels: int = 64
    blocks: int = 5
    value_hidden: int = 256
    dtype: Any = jnp.bfloat16

    def _forward(self, layers: _Layers, x: jax.Array):
        dt = self.dtype
        x = x.astype(dt)
        x = layers.conv(("Conv_0",), x, self.channels, (3, 3), "SAME", dt)
        x = _relu(layers.batch_norm(("BatchNorm_0",), x)).astype(dt)
        for i in range(self.blocks):
            blk = (f"_ResBlock_{i}",)
            y = layers.conv(blk + ("Conv_0",), x, self.channels, (3, 3), "SAME", dt)
            y = _relu(layers.batch_norm(blk + ("BatchNorm_0",), y))
            y = layers.conv(blk + ("Conv_1",), y, self.channels, (3, 3), "SAME", dt)
            y = layers.batch_norm(blk + ("BatchNorm_1",), y)
            x = _relu(x + y.astype(x.dtype))

        p = layers.conv(("Conv_1",), x, 2, (1, 1), "SAME", dt)
        p = _relu(layers.batch_norm(("BatchNorm_1",), p)).reshape((x.shape[0], -1))
        logits = layers.dense(("policy",), p, self.num_actions, jnp.float32)

        v = layers.conv(("Conv_2",), x, 1, (1, 1), "SAME", dt)
        v = _relu(layers.batch_norm(("BatchNorm_2",), v)).reshape((x.shape[0], -1))
        v = _relu(layers.dense(("Dense_0",), v, self.value_hidden, dt))
        v = layers.dense(("value",), v, 1, jnp.float32)
        return logits, jnp.tanh(v)[:, 0]

    def folded_apply(self, variables, feats):
        """BN-folded inference forward — the search-side eval path.

        Every BN is folded into its conv (W' = W * gamma/sqrt(var+eps),
        b' = beta - mean * gamma/sqrt(var+eps)), which removes the separate
        f32 normalization passes and their dtype conversions from the
        search's forward. |delta logits| ~1e-2 against the unfolded
        forward (statistically equivalent for search; asserted in
        tests/test_fold.py). Training keeps real BatchNorm; this touches
        only inference."""
        p = variables["params"]
        bs = variables["batch_stats"]
        dt = self.dtype

        def conv(x, wb):
            w, b = wb
            y = jax.lax.conv_general_dilated(
                x, w, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=dt,
            )
            return y + b

        x = feats.astype(dt)
        x = _relu(
            conv(x, _fold_conv_bn(p["Conv_0"]["kernel"], p["BatchNorm_0"], bs["BatchNorm_0"], dt))
        )
        for i in range(self.blocks):
            bp = p[f"_ResBlock_{i}"]
            bss = bs[f"_ResBlock_{i}"]
            y = _relu(
                conv(x, _fold_conv_bn(bp["Conv_0"]["kernel"], bp["BatchNorm_0"], bss["BatchNorm_0"], dt))
            )
            y = conv(y, _fold_conv_bn(bp["Conv_1"]["kernel"], bp["BatchNorm_1"], bss["BatchNorm_1"], dt))
            x = _relu(x + y)

        pl = _relu(
            conv(x, _fold_conv_bn(p["Conv_1"]["kernel"], p["BatchNorm_1"], bs["BatchNorm_1"], dt))
        ).reshape((x.shape[0], -1))
        logits = (
            pl.astype(jnp.float32) @ p["policy"]["kernel"] + p["policy"]["bias"]
        )

        vl = _relu(
            conv(x, _fold_conv_bn(p["Conv_2"]["kernel"], p["BatchNorm_2"], bs["BatchNorm_2"], dt))
        ).reshape((x.shape[0], -1))
        vh = _relu(
            vl @ p["Dense_0"]["kernel"].astype(dt) + p["Dense_0"]["bias"].astype(dt)
        )
        v = vh.astype(jnp.float32) @ p["value"]["kernel"] + p["value"]["bias"]
        return logits, jnp.tanh(v)[:, 0]


@dataclasses.dataclass(frozen=True)
class AZConvNet(_Net):
    """Plain conv net matching the reference's TF1 architecture spec
    (connect_four_net.py:20-100): 4 conv3x3 layers (SAME, SAME, VALID,
    VALID) + BN + ReLU, flatten, Dense(1024)+BN+ReLU+Dropout,
    Dense(512)+BN+ReLU+Dropout, then pi/v heads. Kept for parity with C11;
    AZResNet is the recommended flagship."""

    num_actions: int
    channels: int = 512          # num_channels (connect_four_net.py:14)
    dropout: float = 0.3         # (connect_four_net.py:13)
    dtype: Any = jnp.bfloat16

    def _forward(self, layers: _Layers, x: jax.Array):
        dt = self.dtype
        x = x.astype(dt)
        for i, pad in enumerate(("SAME", "SAME", "VALID", "VALID")):
            x = layers.conv((f"Conv_{i}",), x, self.channels, (3, 3), pad, dt)
            x = _relu(layers.batch_norm((f"BatchNorm_{i}",), x)).astype(dt)
        x = x.reshape((x.shape[0], -1))
        for j, h in enumerate((1024, 512)):
            x = layers.dense((f"Dense_{j}",), x, h, dt, use_bias=False)
            x = _relu(layers.batch_norm((f"BatchNorm_{4 + j}",), x)).astype(dt)
            x = layers.dropout((f"Dropout_{j}",), x, self.dropout)
        logits = layers.dense(("policy",), x, self.num_actions, jnp.float32)
        v = layers.dense(("value",), x, 1, jnp.float32)
        return logits, jnp.tanh(v)[:, 0]

    def folded_apply(self, variables, feats):
        """BN-folded inference forward (see AZResNet.folded_apply — same
        motivation; Dropout is identity at inference)."""
        p = variables["params"]
        bs = variables["batch_stats"]
        dt = self.dtype

        x = feats.astype(dt)
        for i, pad in enumerate(("SAME", "SAME", "VALID", "VALID")):
            w, b = _fold_conv_bn(
                p[f"Conv_{i}"]["kernel"], p[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"], dt
            )
            y = jax.lax.conv_general_dilated(
                x, w, (1, 1), pad,
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=dt,
            )
            x = _relu(y + b)
        x = x.reshape((x.shape[0], -1))
        for j in range(2):
            w, b = _fold_conv_bn(
                p[f"Dense_{j}"]["kernel"],
                p[f"BatchNorm_{4 + j}"],
                bs[f"BatchNorm_{4 + j}"],
                dt,
            )
            x = _relu(x @ w + b)
        logits = x.astype(jnp.float32) @ p["policy"]["kernel"] + p["policy"]["bias"]
        v = x.astype(jnp.float32) @ p["value"]["kernel"] + p["value"]["bias"]
        return logits, jnp.tanh(v)[:, 0]


def make_apply_fn(model, fold: Optional[bool] = None) -> Callable:
    """Inference-mode apply: (variables, feats) -> (logits, value).

    Uses running BN statistics (train=False) — the search-side predict path
    (the analogue of PythonNNet::predict, python_nnet.rs:88-132).

    ``fold`` selects the BN-folded fast eval for models that provide one
    (AZResNet): None = auto (fold unless AZ_NO_FOLD is set), True/False =
    force. Folding is inference-only and statistically equivalent
    (tests/test_fold.py); training always uses the real module."""
    import os

    if fold is None:
        fold = not os.environ.get("AZ_NO_FOLD")
    use_folded = fold and hasattr(model, "folded_apply")

    if use_folded:
        def apply_fn(variables, feats):
            return model.folded_apply(variables, feats)
    else:
        def apply_fn(variables, feats):
            return model.apply(variables, feats, train=False)

    # Stamped into every Coach metrics record so cross-run Elo/loss curves
    # can be compared knowing which eval path (folded vs unfolded BN, ~1e-2
    # logit delta) produced them.
    apply_fn.folded = use_folded
    return apply_fn


def init_model(model, rng: jax.Array, feature_shape) -> Any:
    sample = jnp.zeros((1,) + tuple(feature_shape), jnp.float32)
    return model.init(rng, sample, train=False)
