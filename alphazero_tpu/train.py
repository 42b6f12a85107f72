"""Learner: loss + optimizer step.

The on-device ``NNet::train`` (reference: src/nnet.rs:39-41 trait method;
examples/utils/python_nnet.rs:45-86 bridge; loss spec from the TF1 model:
softmax cross-entropy on the policy head + MSE on the value head, Adam
1e-3, with BatchNorm statistics updated per step —
connect_four_net.py:102-112). Model versioning is two resident variable
pytrees (incumbent vs candidate) swapped by the coach's gate, replacing the
reference's reload-checkpoint-on-model-id-change protocol
(python_nnet.rs:65-75; defect D8's mixed-model batches cannot happen —
every search closure carries its own params).

The train step is pure and jit/pjit-friendly: under a data-parallel mesh
sharding the gradient mean is an XLA-inserted psum over the batch axis.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from alphazero_tpu.config import TrainConfig


class TrainState(NamedTuple):
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jax.Array  # i32[]


class TrainMetrics(NamedTuple):
    loss: jax.Array
    policy_loss: jax.Array
    value_loss: jax.Array
    l2_loss: jax.Array


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    if cfg.weight_decay > 0:
        return optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    return optax.adam(cfg.learning_rate)


def init_train_state(model, rng: jax.Array, feature_shape, cfg: TrainConfig) -> TrainState:
    sample = jnp.zeros((1,) + tuple(feature_shape), jnp.float32)
    variables = model.init(rng, sample, train=False)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    tx = make_optimizer(cfg)
    return TrainState(
        params=params,
        batch_stats=batch_stats,
        opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32),
    )


def variables_of(state: TrainState) -> Any:
    v = {"params": state.params}
    if state.batch_stats:
        v["batch_stats"] = state.batch_stats
    return v


def make_train_step(model, cfg: TrainConfig):
    """Build ``train_step(state, feats, pi_t, v_t, rng) -> (state, metrics)``.

    loss = CE(pi_t, policy_logits) + MSE(v_t, value) [+ l2 on kernels]
    (connect_four_net.py:102-112's loss; l2 is this framework's addition,
    gated by cfg.l2_scale).
    """
    tx = make_optimizer(cfg)

    def loss_fn(params, batch_stats, feats, pi_t, v_t, rng):
        if batch_stats:
            (logits, v), updates = model.apply(
                {"params": params, "batch_stats": batch_stats},
                feats,
                train=True,
                mutable=["batch_stats"],
                rngs={"dropout": rng},
            )
            new_bs = updates.get("batch_stats", batch_stats)
        else:
            logits, v = model.apply(
                {"params": params}, feats, train=True, rngs={"dropout": rng}
            )
            new_bs = batch_stats
        # value-only samples (playout-cap randomization, selfplay.py) carry
        # an all-zero pi target: their CE term is identically 0, and the
        # normalizer counts only policy-bearing rows so the policy LR does
        # not dilute with the cheap-search fraction
        p_each = optax.softmax_cross_entropy(logits, pi_t)
        has_pi = (jnp.sum(pi_t, axis=-1) > 0.5).astype(jnp.float32)
        p_loss = jnp.sum(p_each * has_pi) / jnp.maximum(jnp.sum(has_pi), 1.0)
        v_loss = jnp.mean((v - v_t) ** 2)
        l2 = jnp.float32(0.0)
        if cfg.l2_scale > 0:
            l2 = cfg.l2_scale * sum(
                jnp.sum(w * w.astype(jnp.float32))
                for w in jax.tree_util.tree_leaves(params)
                if w.ndim > 1
            )
        total = p_loss + v_loss + l2
        return total, (new_bs, TrainMetrics(total, p_loss, v_loss, l2))

    def train_step(state: TrainState, feats, pi_t, v_t, rng):
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (_, (new_bs, metrics)), grads = grad_fn(
            state.params, state.batch_stats, feats, pi_t, v_t, rng
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return (
            TrainState(params, new_bs, opt_state, state.step + 1),
            metrics,
        )

    return train_step
