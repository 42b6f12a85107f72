"""Policy post-processing ops shared by search, self-play and arena.

These are the vectorized equivalents of the reference's per-leaf policy
masking (reference: src/async_mcts.rs:319-345) and root action-selection
(async_mcts.rs:97-114). Both are pure, fully batched, and branch-free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_NEG_INF = -1e30


def masked_policy(logits: jax.Array, valid: jax.Array) -> jax.Array:
    """Masked softmax with uniform-over-valids fallback.

    Equivalent of async_mcts.rs:319-345: zero out invalid actions and
    renormalize; if the masked policy has no support, fall back to a uniform
    distribution over the valid actions (the reference logs a warn! — here
    the fallback is exact and silent, it only triggers for degenerate
    logits). If nothing is valid (terminal node), returns uniform over all
    actions — callers never descend through terminal nodes, so the row is
    inert.

    Args:
      logits: f32[B, A] raw policy head output.
      valid:  bool[B, A] legal-action mask.
    Returns:
      f32[B, A] probabilities summing to 1 on the valid support.
    """
    masked = jnp.where(valid, logits, _NEG_INF)
    # subtract max for stability; rows with no valid entries give exp(0)=1s
    z = masked - jnp.max(masked, axis=-1, keepdims=True)
    e = jnp.where(valid, jnp.exp(z), 0.0)
    total = jnp.sum(e, axis=-1, keepdims=True)
    nvalid = jnp.sum(valid, axis=-1, keepdims=True)
    uniform_valid = valid.astype(jnp.float32) / jnp.maximum(nvalid, 1)
    uniform_all = jnp.full_like(e, 1.0 / e.shape[-1])
    fallback = jnp.where(nvalid > 0, uniform_valid, uniform_all)
    return jnp.where(total > 0, e / jnp.maximum(total, 1e-30), fallback)


def action_probs(
    counts: jax.Array, temp: jax.Array, rng: jax.Array
) -> jax.Array:
    """Root visit counts -> play distribution (async_mcts.rs:97-114, with
    defect D2 fixed: temp != 0 actually returns counts^(1/temp) normalized).

    temp == 0: one-hot on a uniformly-random argmax over tied max counts
    (the reference's tie-broken greedy, async_mcts.rs:97-105).
    temp > 0: counts^(1/temp) normalized. Counts are pre-scaled by their max
    so the exponentiation cannot overflow for small temps.

    Args:
      counts: f32[B, A] root visit counts.
      temp:   f32 scalar or f32[B] temperature.
      rng:    PRNG key for tie-breaking.
    Returns:
      f32[B, A] distribution over actions.
    """
    temp = jnp.broadcast_to(jnp.asarray(temp, jnp.float32), counts.shape[:1])
    mx = jnp.max(counts, axis=-1, keepdims=True)
    is_max = (counts >= mx) & (mx > 0)
    u = jax.random.uniform(rng, counts.shape)
    pick = jnp.argmax(jnp.where(is_max, u, -1.0), axis=-1)
    onehot = jax.nn.one_hot(pick, counts.shape[-1], dtype=jnp.float32)

    t = jnp.maximum(temp, 1e-6)[:, None]
    scaled = counts / jnp.maximum(mx, 1.0)
    powed = jnp.where(counts > 0, scaled ** (1.0 / t), 0.0)
    total = jnp.sum(powed, axis=-1, keepdims=True)
    dist = jnp.where(total > 0, powed / jnp.maximum(total, 1e-30), onehot)
    return jnp.where(temp[:, None] <= 0, onehot, dist)


def root_prior(game, apply_fn, cfg, params, root_state, rng=None):
    """Masked root prior with optional Dirichlet exploration noise —
    the root-install step shared verbatim by all three search engines
    (the intended-but-broken first root expansion of reference defect D1;
    noise is this framework's optional extension, off by default).

    Returns ``(prior f32[B, A], valid bool[B, A])``.
    """
    valid = jax.vmap(game.valid_moves)(root_state)
    if getattr(apply_fn, "needs_features", True):
        feats = jax.vmap(game.to_features)(root_state)
    else:
        B = jax.tree_util.tree_leaves(root_state)[0].shape[0]
        feats = jnp.zeros((B, 1), jnp.float32)
    logits, _ = apply_fn(params, feats)
    prior = masked_policy(logits, valid)
    if cfg.dirichlet_alpha is not None:
        if rng is None:
            raise ValueError("dirichlet noise requires an rng key")
        noise = jax.random.dirichlet(
            rng,
            jnp.full((valid.shape[-1],), cfg.dirichlet_alpha),
            prior.shape[:1],
        )
        noise = masked_policy(jnp.log(noise + 1e-12), valid)
        prior = (1.0 - cfg.dirichlet_frac) * prior + cfg.dirichlet_frac * noise
    return prior, valid
