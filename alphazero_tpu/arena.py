"""Batched model-vs-model arena + gating.

Re-design of the reference's sequential arena (reference: src/arena.rs:7-99
``play_game``/``play_games`` + the gate in src/coach.rs:332-390). The
reference plays ``num/2`` games per seating permutation one at a time, each
move a fresh MCTS call. Here ALL arena games advance in lockstep under one
``jit``: the first half seats the candidate first, the second half the
incumbent (the two-element ``permutohedron::Heap`` orderings,
arena.rs:74-79), moves are greedy tie-broken argmax over search visit
counts (the closures built in coach.rs:356-371), and both models are
evaluated in the same fused forward pass with a per-game row select — so
mixed-seating batches are exact (impossible in the reference, whose
inference service ran whole batches under one model_id — defect D8).

Draws: the reference rounds its ``DRAW_EPS`` encoding to 0 at the arena
boundary (arena.rs:51); values here are exact so draws are native.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from alphazero_tpu.config import ArenaConfig, MCTSConfig
from alphazero_tpu.ops import action_probs
from alphazero_tpu.selfplay import _make_root_counts_fn


class ArenaResult(NamedTuple):
    """Aggregate outcome from the CANDIDATE's perspective (the reference
    counts from the new-model player's perspective, arena.rs:80-96)."""

    cand_wins: jax.Array   # i32[]
    inc_wins: jax.Array    # i32[]
    draws: jax.Array       # i32[]
    unfinished: jax.Array  # i32[] games that hit max_moves (should be 0)


def gate(result: ArenaResult, update_threshold) -> bool:
    """Accept the candidate iff wins/(wins+losses) >= threshold
    (coach.rs:383-390). No decisive games -> keep the incumbent.
    ``update_threshold=None`` = continuous (AlphaZero-2017) mode: always
    accept."""
    if update_threshold is None:
        return True
    cw = int(result.cand_wins)
    iw = int(result.inc_wins)
    if cw + iw == 0:
        return False
    return cw / (cw + iw) >= update_threshold


def make_arena_fn(
    game,
    apply_cand: Callable,
    apply_inc: Callable,
    mcts_cfg: MCTSConfig,
    num_games: int,
    max_moves: Optional[int] = None,
    state_sharding=None,
    mcts_cfg_inc: Optional[MCTSConfig] = None,
):
    """Build ``play(params_cand, params_inc, rng) -> ArenaResult``.

    ``apply_cand``/``apply_inc`` may be different model families (e.g. a
    net vs the uniform baseline). Both are evaluated on every leaf batch
    and row-selected by whose turn it is in each game — one compiled
    program regardless of seating.

    ``mcts_cfg_inc`` gives the INCUMBENT side its own search config
    (asymmetric budgets — e.g. the anchor-ladder rungs, where a 50-sim
    agent rates against a 1600-sim pure-MCTS rung): each move runs both
    sides' searches over the full batch and the played counts are
    row-selected by whose turn it is. Each side's search still models
    BOTH players' positions through the combined forward (the per-game
    net select is by the ROOT mover), so semantics match the symmetric
    arena exactly when the configs coincide. PUCT engines only."""
    B = num_games
    T = max_moves or game.max_moves
    if mcts_cfg_inc == mcts_cfg:
        mcts_cfg_inc = None

    def combined_apply(params, feats):
        p_cand, p_inc, cand_to_move = params
        lc, vc = apply_cand(p_cand, feats)
        li, vi = apply_inc(p_inc, feats)
        return (
            jnp.where(cand_to_move[:, None], lc, li),
            jnp.where(cand_to_move, vc, vi),
        )

    transposition = getattr(mcts_cfg, "transposition", False)
    gumbel = getattr(mcts_cfg, "gumbel", False)
    if mcts_cfg_inc is not None and (gumbel or transposition):
        raise ValueError(
            "asymmetric per-side budgets (mcts_cfg_inc) are a PUCT-engine "
            "feature — not supported with gumbel/transposition arenas"
        )

    if gumbel:
        # Gumbel mode plays the sequential-halving winner; per-move Gumbel
        # noise (k_tie) keeps arena games from collapsing onto one line
        # (the role the temp-0 tie-break rng plays for the PUCT engines).
        from alphazero_tpu.mcts.gumbel import make_gumbel_search_fn

        gsearch = make_gumbel_search_fn(game, combined_apply, mcts_cfg)

    if gumbel:
        root_counts = None
    elif mcts_cfg_inc is not None:
        # asymmetric budgets: both searches run on the full batch, the
        # played counts row-select by whose turn it is (each search
        # already models both players via the combined forward, so this
        # is the symmetric semantics per side)
        rc_cand = _make_root_counts_fn(game, combined_apply, mcts_cfg)
        rc_inc = _make_root_counts_fn(game, combined_apply, mcts_cfg_inc)

        def root_counts(params, state):
            cand_to_move = params[2]
            cc = rc_cand(params, state)
            ci = rc_inc(params, state)
            return jnp.where(cand_to_move[:, None], cc, ci)
    else:
        # both players search through the combined two-model forward —
        # per-game row select — in one engine call (the XLA engine, or
        # the DAG engine with ``transposition``)
        root_counts = _make_root_counts_fn(game, combined_apply, mcts_cfg)

    step_v = jax.vmap(game.step)
    term_v = jax.vmap(game.terminal)

    def move_p(ps, carry, t):
        params_cand, params_inc = ps
        state, done, cand_to_move, winner_cand, is_draw, rng = carry
        rng, k_tie = jax.random.split(rng)
        if gumbel:
            action = gsearch(
                (params_cand, params_inc, cand_to_move), state, k_tie
            ).action
        else:
            counts = root_counts(
                (params_cand, params_inc, cand_to_move), state
            )
            # greedy argmax play with random tie-break (temp = 0,
            # coach.rs:356-371's |x| argmax closures)
            pi = action_probs(counts, 0.0, k_tie)
            action = jnp.argmax(pi, axis=-1)
        nxt = step_v(state, action)
        state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(
                done.reshape((-1,) + (1,) * (n.ndim - 1)), o, n
            ),
            nxt,
            state,
        )
        now_done, tv = term_v(state)
        ended = ~done & now_done
        # tv < 0: the player to move lost => the mover won
        mover_won = tv < -0.5
        to_move_won = tv > 0.5
        won_cand = jnp.where(mover_won, cand_to_move, ~cand_to_move)
        winner_cand = jnp.where(
            ended & (mover_won | to_move_won), won_cand, winner_cand
        )
        is_draw = jnp.where(
            ended & ~mover_won & ~to_move_won, True, is_draw
        )
        done = done | now_done
        cand_to_move = jnp.where(done, cand_to_move, ~cand_to_move)
        return (state, done, cand_to_move, winner_cand, is_draw, rng), None

    def play(params_cand: Any, params_inc: Any, rng: jax.Array) -> ArenaResult:
        # seating: first half candidate moves first (arena.rs:74-79 swap)
        cand_first = jnp.arange(B) < (B + 1) // 2
        state = jax.vmap(lambda _: game.init())(jnp.arange(B))
        if state_sharding is not None:
            # pin the game batch to the mesh data axis; GSPMD propagates
            # the sharding through the whole move loop
            state = jax.tree_util.tree_map(
                lambda x: jax.lax.with_sharding_constraint(x, state_sharding),
                state,
            )
            cand_first = jax.lax.with_sharding_constraint(
                cand_first, state_sharding
            )

        move = lambda carry, t: move_p((params_cand, params_inc), carry, t)

        carry0 = (
            state,
            jnp.zeros((B,), bool),
            cand_first,
            jnp.zeros((B,), bool),
            jnp.zeros((B,), bool),
            rng,
        )
        (state, done, _, winner_cand, is_draw, _), _ = jax.lax.scan(
            move, carry0, jnp.arange(T)
        )
        decisive = done & ~is_draw
        return ArenaResult(
            cand_wins=jnp.sum(decisive & winner_cand).astype(jnp.int32),
            inc_wins=jnp.sum(decisive & ~winner_cand).astype(jnp.int32),
            draws=jnp.sum(done & is_draw).astype(jnp.int32),
            unfinished=jnp.sum(~done).astype(jnp.int32),
        )

    return play
