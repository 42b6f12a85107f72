#!/usr/bin/env python
"""Transposition-DAG measurement: strength and wall-clock vs the pure tree.

The C++ quantification (csrc/tt_oracle.cpp, docs/PARITY.md) showed the
reference's `seen` dedup is worth ~0 Elo at 25-100 sims/move and +32/+9
Elo (connect-four/othello) at 400. This script reproduces that match ON
DEVICE with the real engines (mcts/tt.py DAG vs mcts/search.py pure tree)
and measures the DAG engine's wall-clock cost — the numbers behind
``MCTSConfig.transposition``'s "deep-search deployments only" guidance.

1. STRENGTH: lockstep head-to-head at equal sims, seating swap, first
   --temp-moves plies sampled ∝ counts then greedy (the tt_oracle match
   protocol).
2. THROUGHPUT: jitted self-play steady-state with transposition on vs off.

Usage: python bench_tt.py
         [--game connect_four|othello] [--games 512] [--sims 400]
"""

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from alphazero_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from alphazero_tpu.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu.games import ConnectFour, Othello
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.mcts.tt import make_tt_search_fn
from alphazero_tpu.models import make_uniform_model
from alphazero_tpu.ops import action_probs
from alphazero_tpu.selfplay import make_selfplay_fn


def head_to_head(game, sims, num_games, max_depth, temp_moves, seed):
    """T (transposition DAG) vs P (pure tree), equal sims, fresh trees
    every move — returns (t_wins, p_wins, draws)."""
    net = make_uniform_model(game)
    cfg_p = MCTSConfig(num_sims=sims, max_depth=max_depth)
    cfg_t = MCTSConfig(num_sims=sims, max_depth=max_depth, transposition=True)
    search_p = make_search_fn(game, net.apply_fn, cfg_p)
    search_t = make_tt_search_fn(game, net.apply_fn, cfg_t)
    step_v = jax.vmap(game.step)
    term_v = jax.vmap(game.terminal)
    B = num_games
    T = game.max_moves

    def play(rng):
        t_first = jnp.arange(B) < (B + 1) // 2  # seating swap
        state = jax.vmap(lambda _: game.init())(jnp.arange(B))

        def ply(carry, t):
            state, done, t_to_move, winner_t, is_draw, rng = carry
            rng, k_tie = jax.random.split(rng)

            counts_t = search_t({}, state).root_counts()
            counts_p = search_p({}, state).root_counts()
            counts = jnp.where(t_to_move[:, None], counts_t, counts_p)

            temp = jnp.where(t < temp_moves, 1.0, 0.0)
            pi = action_probs(counts, temp, k_tie)
            rng, k_act = jax.random.split(rng)
            action = jax.random.categorical(k_act, jnp.log(pi + 1e-12), axis=-1)
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
            mover_won = tv < -0.5
            to_move_won = tv > 0.5
            won_t = jnp.where(mover_won, t_to_move, ~t_to_move)
            winner_t = jnp.where(ended & (mover_won | to_move_won), won_t, winner_t)
            is_draw = jnp.where(ended & ~mover_won & ~to_move_won, True, is_draw)
            done = done | now_done
            t_to_move = jnp.where(done, t_to_move, ~t_to_move)
            return (state, done, t_to_move, winner_t, is_draw, rng), None

        carry0 = (
            state,
            jnp.zeros((B,), bool),
            t_first,
            jnp.zeros((B,), bool),
            jnp.zeros((B,), bool),
            rng,
        )
        (state, done, _, winner_t, is_draw, _), _ = jax.lax.scan(
            ply, carry0, jnp.arange(T)
        )
        decisive = done & ~is_draw
        return (
            jnp.sum(decisive & winner_t),
            jnp.sum(decisive & ~winner_t),
            jnp.sum(done & is_draw),
        )

    tw, pw, dr = jax.jit(play)(jax.random.key(seed))
    return int(tw), int(pw), int(dr)


def selfplay_time(game, sims, batch, transposition, max_depth, seed, reps=3):
    net = make_uniform_model(game)
    cfg = MCTSConfig(
        num_sims=sims, max_depth=max_depth, transposition=transposition
    )
    sp = jax.jit(
        make_selfplay_fn(game, net.apply_fn, cfg, SelfPlayConfig(batch_size=batch))
    )
    traj, stats = sp({}, jax.random.key(seed))  # compile
    jax.block_until_ready(traj.pi)
    best = float("inf")
    for i in range(reps):
        t0 = time.perf_counter()
        traj, stats = sp({}, jax.random.key(seed + 1 + i))
        jax.block_until_ready(traj.pi)
        best = min(best, time.perf_counter() - t0)
    moves = int(jnp.sum(stats.num_moves))
    return best, moves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--game", default="connect_four",
                    choices=["connect_four", "othello"])
    ap.add_argument("--games", type=int, default=512)
    ap.add_argument("--sims", type=int, default=400)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--temp-moves", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--skip-throughput", action="store_true")
    ap.add_argument("--skip-strength", action="store_true")
    args = ap.parse_args()
    game = ConnectFour() if args.game == "connect_four" else Othello()
    max_depth = args.max_depth or (48 if args.game == "connect_four" else 64)

    out = {"game": args.game, "sims": args.sims}
    if not args.skip_strength:
        tw = pw = dr = 0
        for s in range(args.seeds):
            a, b, c = head_to_head(
                game, args.sims, args.games, max_depth, args.temp_moves,
                seed=211 + s,
            )
            tw, pw, dr = tw + a, pw + b, dr + c
        n = tw + pw + dr
        score = (tw + 0.5 * dr) / max(n, 1)
        eps = 1.0 / (2.0 * max(n, 1))
        sc = min(max(score, eps), 1.0 - eps)
        elo = 400.0 * np.log10(sc / (1.0 - sc))
        out.update(
            {
                "games": n,
                "tt_wins": tw,
                "pure_wins": pw,
                "draws": dr,
                "tt_score": round(score, 4),
                "tt_elo_delta": round(float(elo), 1),
            }
        )

    if not args.skip_throughput:
        t_pure, mv = selfplay_time(
            game, args.sims, args.batch, False, max_depth, seed=7
        )
        t_tt, mv_t = selfplay_time(
            game, args.sims, args.batch, True, max_depth, seed=7
        )
        out.update(
            {
                "selfplay_batch": args.batch,
                "t_pure_s": round(t_pure, 3),
                "t_tt_s": round(t_tt, 3),
                "env_steps_per_s_pure": int(mv / t_pure),
                "env_steps_per_s_tt": int(mv_t / t_tt),
                "tt_cost_x": round(t_tt / t_pure, 3),
            }
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
