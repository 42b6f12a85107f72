"""BN-folded inference eval (AZResNet.folded_apply) — statistical
equivalence with the exact unfolded apply, and engine-level equivalence.

Folding removes the separate normalization passes from the search-side
eval path at the price of bounded numerical drift (bf16 rounding of
folded scales), while training keeps the real BatchNorm module."""

import jax
import jax.numpy as jnp
import numpy as np

from alphazero_tpu.config import MCTSConfig
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.models import AZResNet, init_model, make_apply_fn

G = ConnectFour()


def _model_and_vars(channels=16, blocks=2, seed=0):
    model = AZResNet(num_actions=G.num_actions, channels=channels, blocks=blocks)
    variables = init_model(model, jax.random.key(seed), G.feature_shape)
    return model, variables


def test_folded_apply_statistically_equivalent():
    model, variables = _model_and_vars()
    feats = jax.random.uniform(jax.random.key(1), (64,) + G.feature_shape)
    l0, v0 = jax.jit(make_apply_fn(model, fold=False))(variables, feats)
    l1, v1 = jax.jit(make_apply_fn(model, fold=True))(variables, feats)
    # bf16 rounding of the folded scales bounds the drift
    np.testing.assert_allclose(np.asarray(l0), np.asarray(l1), atol=0.05)
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), atol=0.02)
    # the play distributions are near-identical
    p0 = jax.nn.softmax(l0, axis=-1)
    p1 = jax.nn.softmax(l1, axis=-1)
    assert float(jnp.max(jnp.abs(p0 - p1))) < 0.01


def test_folded_apply_is_default_and_opt_out(monkeypatch):
    model, _ = _model_and_vars()
    assert make_apply_fn(model).__name__ == "apply_fn"
    # default folds (env unset), AZ_NO_FOLD opts out
    monkeypatch.delenv("AZ_NO_FOLD", raising=False)
    f_auto = make_apply_fn(model)
    monkeypatch.setenv("AZ_NO_FOLD", "1")
    f_off = make_apply_fn(model)
    feats = jnp.zeros((4,) + G.feature_shape, jnp.float32)
    variables = init_model(model, jax.random.key(0), G.feature_shape)
    la, _ = f_auto(variables, feats)
    lo, _ = f_off(variables, feats)
    # both run; auto is the folded path (tiny numerical difference allowed)
    np.testing.assert_allclose(np.asarray(la), np.asarray(lo), atol=0.05)


def test_search_with_folded_eval_matches_search_quality():
    """Same positions, same sims: the folded eval's visit counts overlap
    the exact eval's on the dominant action (search is robust to ~1e-2
    logit drift), and both engines consume the folded fn identically."""
    model, variables = _model_and_vars(seed=3)
    cfg = MCTSConfig(num_sims=32, max_depth=24)
    exact = make_search_fn(G, make_apply_fn(model, fold=False), cfg)
    folded = make_search_fn(G, make_apply_fn(model, fold=True), cfg)
    state = jax.vmap(lambda _: G.init())(jnp.arange(8))
    c0 = np.asarray(jax.jit(exact)(variables, state).root_counts())
    c1 = np.asarray(jax.jit(folded)(variables, state).root_counts())
    assert (c0.argmax(-1) == c1.argmax(-1)).mean() >= 0.75
    # distributions are close in L1
    d = np.abs(c0 / c0.sum(-1, keepdims=True) - c1 / c1.sum(-1, keepdims=True))
    assert d.sum(-1).mean() < 0.25


def test_azconvnet_folded_apply_equivalent():
    """The C11-parity net folds too (conv+BN stack, dense+BN stack,
    inference Dropout = identity)."""
    from alphazero_tpu.models import AZConvNet

    model = AZConvNet(num_actions=G.num_actions, channels=32)
    variables = init_model(model, jax.random.key(4), G.feature_shape)
    feats = jax.random.uniform(jax.random.key(5), (32,) + G.feature_shape)
    l0, v0 = jax.jit(make_apply_fn(model, fold=False))(variables, feats)
    l1, v1 = jax.jit(make_apply_fn(model, fold=True))(variables, feats)
    np.testing.assert_allclose(np.asarray(l0), np.asarray(l1), atol=0.05)
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), atol=0.02)
