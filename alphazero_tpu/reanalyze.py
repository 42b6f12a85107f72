"""Replay-target refresh by re-search ("reanalyze").

No reference analogue (the reference trains each sample exactly with the
policy the search produced when the position was played,
src/coach.rs:130-155). This is the MuZero-Reanalyze idea (Schrittwieser
et al. 2020, app. A) specialized to AlphaZero-style terminal-outcome
training: policy targets go stale as the net improves, so old positions
are periodically RE-SEARCHED with the current net and re-inserted with
fresh policy targets. The value target is NOT refreshed — for board games
the stored game outcome is ground truth, and only the policy is stale.

Mechanics, on-device:

* Self-play records each sample's canonical root STATE (not just its
  features) — ``make_selfplay_fn(record_states=True)`` — into a
  :class:`PositionStore`, a second on-device ring holding pre-symmetry
  positions + their outcome targets.
* A reanalyze pass is one more jitted batched search: sample
  ``batch_size`` stored positions, run the XLA search at the
  full budget with NO root noise and NO temperature (the target should
  be the strongest available play distribution, not an exploration one),
  and emit a one-step :class:`~alphazero_tpu.selfplay.Trajectory` whose
  pi is the normalized root visit counts and whose value is the stored
  outcome. ``replay_insert`` then applies symmetry expansion and ring
  semantics exactly as for fresh self-play samples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from alphazero_tpu.config import MCTSConfig, ReanalyzeConfig
from alphazero_tpu.selfplay import Trajectory, _make_root_counts_fn


class PositionStore(NamedTuple):
    """Ring buffer of canonical positions + their outcome targets.

    Same prefix-sum ring discipline as the replay buffer (replay.py), but
    it stores STATE pytrees (pre-symmetry) instead of feature planes, so
    positions can be re-searched later.
    """

    states: Any        # pytree, each leaf [Cap, ...leaf shape]
    value: jax.Array   # f32[Cap] outcome from the position's to-move view
    born: jax.Array    # i32[Cap] coach iteration the position was recorded
    pos: jax.Array     # i32[] next write slot
    size: jax.Array    # i32[] live position count (<= Cap)


def position_init(game, capacity: int) -> PositionStore:
    proto = game.init()
    states = jax.tree_util.tree_map(
        lambda l: jnp.zeros((capacity,) + jnp.shape(l), jnp.asarray(l).dtype),
        proto,
    )
    return PositionStore(
        states=states,
        value=jnp.zeros((capacity,), jnp.float32),
        born=jnp.zeros((capacity,), jnp.int32),
        pos=jnp.zeros((), jnp.int32),
        size=jnp.zeros((), jnp.int32),
    )


def position_insert(
    store: PositionStore,
    states,
    value: jax.Array,
    valid: jax.Array,
    iteration: jax.Array = 0,
    *,
    stride: int = 1,
) -> PositionStore:
    """Insert the valid positions of a recorded self-play batch.

    ``states``: [T, B, ...] pytree from ``record_states=True`` self-play;
    ``value``/``valid``: the matching Trajectory fields [T, B];
    ``iteration``: the coach iteration stamp (drives the staleness
    metric — ``make_reanalyze_fn`` reports the mean age of refreshed
    positions in iterations).

    ``stride`` (static) records only every ``stride``-th valid sample:
    at production scale one iteration can produce more positions than
    the ring holds (flagship: 4096 games x ~25 moves ≈ 100k+ vs the
    default 65536 slots), so recording everything makes "reanalyze"
    refresh targets that are at most half an iteration old. Subsampling
    stretches the same capacity over ``stride``x more iterations:
    staleness window ≈ capacity · stride / (batch_size · avg_moves).
    ``stride=1`` is bit-identical to the unstrided insert.
    """
    cap = store.value.shape[0]
    n = value.shape[0] * value.shape[1]
    flat = lambda x: x.reshape((n,) + x.shape[2:])
    valid = flat(valid)
    ranks = jnp.cumsum(valid.astype(jnp.int32)) - 1  # rank among valids
    if stride > 1:
        valid = valid & (ranks % stride == 0)
        ranks = jnp.cumsum(valid.astype(jnp.int32)) - 1
    idx = jnp.where(valid, (store.pos + ranks) % cap, cap)  # cap -> dropped
    num = valid.sum().astype(jnp.int32)
    stamp = jnp.full((n,), jnp.asarray(iteration, jnp.int32))
    return PositionStore(
        states=jax.tree_util.tree_map(
            lambda buf, x: buf.at[idx].set(flat(x), mode="drop"),
            store.states,
            states,
        ),
        value=store.value.at[idx].set(flat(value), mode="drop"),
        born=store.born.at[idx].set(stamp, mode="drop"),
        pos=(store.pos + num) % cap,
        size=jnp.minimum(store.size + num, cap),
    )


def make_reanalyze_fn(
    game,
    apply_fn,
    mcts_cfg: MCTSConfig,
    rz_cfg: ReanalyzeConfig,
) -> Callable[..., Tuple[Trajectory, jax.Array, jax.Array]]:
    """Build ``reanalyze(params, store, rng, iteration) ->
    (Trajectory, num_refreshed, age_mean)``.

    The trajectory is [1, batch_size] (one "move" of batch_size samples)
    so it feeds straight into ``replay_insert``. Rows drawn from an empty
    store are invalid-masked; ``num_refreshed`` counts the live ones.
    ``age_mean`` is the mean age in coach iterations (current
    ``iteration`` minus each refreshed position's insert stamp) — the
    staleness metric: if it hovers below ~1 the ring is wrapping within
    an iteration and the pass is refreshing targets that were never
    stale (raise ``capacity`` or ``record_stride``).
    """
    search_cfg = dataclasses.replace(
        mcts_cfg,
        num_sims=int(rz_cfg.num_sims or mcts_cfg.num_sims),
        max_nodes=None,
        dirichlet_alpha=None,  # targets are refreshed noise-free
        tree_reuse=False,
    )
    gumbel = getattr(mcts_cfg, "gumbel", False)
    if gumbel:
        # gumbel training targets are the improved policy pi', so the
        # refreshed targets must be too (mcts/gumbel.py)
        from alphazero_tpu.mcts.gumbel import make_gumbel_search_fn

        gsearch = make_gumbel_search_fn(game, apply_fn, search_cfg)
    else:
        root_counts = _make_root_counts_fn(game, apply_fn, search_cfg)
    feat_v = jax.vmap(game.to_features)
    R = int(rz_cfg.batch_size)

    def reanalyze(params, store: PositionStore, rng: jax.Array, iteration=0):
        k_idx, k_search = jax.random.split(rng)
        idx = jax.random.randint(k_idx, (R,), 0, jnp.maximum(store.size, 1))
        states = jax.tree_util.tree_map(lambda buf: buf[idx], store.states)
        if gumbel:
            pi = gsearch(params, states, k_search).improved_pi
        else:
            counts = root_counts(params, states, k_search)
            # full-budget noise-free visit distribution (temp=1, no tie
            # rng: normalization needs none)
            pi = counts / jnp.maximum(counts.sum(-1, keepdims=True), 1.0)
        valid = jnp.broadcast_to(store.size > 0, (R,))
        traj = Trajectory(
            features=feat_v(states)[None],
            pi=pi[None],
            value=(store.value[idx] * valid)[None],
            valid=valid[None],
        )
        num = valid.sum().astype(jnp.int32)
        age = (jnp.asarray(iteration, jnp.int32) - store.born[idx]).astype(
            jnp.float32
        )
        age_mean = (age * valid).sum() / jnp.maximum(num, 1)
        return traj, num, age_mean

    return reanalyze
