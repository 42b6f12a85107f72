#!/usr/bin/env python
"""Tree-reuse measurement: strength and wall-clock vs fresh-tree search.

The reference reuses each episode's tree across moves (coach.rs:104-157);
the rebuild implements the equivalent re-rooting (mcts/reuse.py). This
script quantifies the trade on the current backend:

1. STRENGTH: lockstep head-to-head, pure MCTS (uniform prior, greedy
   argmax play, seating swap): player R carries its tree across ALL plies
   (re-rooted through both players' moves, searching only on its own
   turns) vs player F searching a fresh tree every move. Budgets are
   per-move sims: --sims for R, --fresh-sims for F (default equal — set
   higher for the equal-wall-clock comparison).
2. THROUGHPUT: jitted self-play (play_games) steady-state seconds with
   tree_reuse on vs off, same game batch.

Usage: python bench_reuse.py
         [--games 512] [--sims 100] [--fresh-sims 100] [--batch 1024]
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
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.mcts.reuse import make_reroot_fn
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.mcts.tree import init_tree
from alphazero_tpu.models import make_uniform_model
from alphazero_tpu.ops import action_probs
from alphazero_tpu.selfplay import make_selfplay_fn


def head_to_head(game, sims_r, sims_f, num_games, max_depth, seed):
    """R (tree reuse) vs F (fresh) — returns (r_wins, f_wins, draws)."""
    net = make_uniform_model(game)
    cfg_r = MCTSConfig(num_sims=sims_r, max_depth=max_depth, max_nodes=2 * sims_r + 1)
    cfg_f = MCTSConfig(num_sims=sims_f, max_depth=max_depth)
    search_r = make_search_fn(game, net.apply_fn, cfg_r)
    search_f = make_search_fn(game, net.apply_fn, cfg_f)
    reroot = make_reroot_fn(game, cfg_r.nodes)
    step_v = jax.vmap(game.step)
    term_v = jax.vmap(game.terminal)
    B = num_games
    T = game.max_moves

    def play(rng):
        r_first = jnp.arange(B) < (B + 1) // 2  # seating swap
        state = jax.vmap(lambda _: game.init())(jnp.arange(B))
        tree = init_tree(game, state, cfg_r.nodes)

        def ply(carry, t):
            state, tree, reused, done, r_to_move, winner_r, is_draw, rng = carry
            rng, k_tie = jax.random.split(rng)

            tree2 = search_r.from_tree({}, tree, state, reused=reused)
            counts_r = tree2.root_counts()
            counts_f = search_f({}, state).root_counts()
            counts = jnp.where(r_to_move[:, None], counts_r, counts_f)
            # R's tree only advances on R's plies
            tree = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    r_to_move.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
                ),
                tree2,
                tree,
            )

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
            # R re-roots through every played move (its own and F's)
            tree, reused = reroot(tree, action, state)

            now_done, tv = term_v(state)
            ended = ~done & now_done
            mover_won = tv < -0.5
            to_move_won = tv > 0.5
            won_r = jnp.where(mover_won, r_to_move, ~r_to_move)
            winner_r = jnp.where(ended & (mover_won | to_move_won), won_r, winner_r)
            is_draw = jnp.where(ended & ~mover_won & ~to_move_won, True, is_draw)
            done = done | now_done
            r_to_move = jnp.where(done, r_to_move, ~r_to_move)
            return (state, tree, reused, done, r_to_move, winner_r, is_draw, rng), None

        carry0 = (
            state,
            tree,
            jnp.zeros((B,), bool),
            jnp.zeros((B,), bool),
            r_first,
            jnp.zeros((B,), bool),
            jnp.zeros((B,), bool),
            rng,
        )
        (state, _, _, done, _, winner_r, is_draw, _), _ = jax.lax.scan(
            ply, carry0, jnp.arange(T)
        )
        decisive = done & ~is_draw
        return (
            jnp.sum(decisive & winner_r),
            jnp.sum(decisive & ~winner_r),
            jnp.sum(done & is_draw),
        )

    rw, fw, dr = jax.jit(play)(jax.random.key(seed))
    return int(rw), int(fw), int(dr)


def selfplay_time(game, sims, batch, reuse, max_depth, seed, reps=3):
    net = make_uniform_model(game)
    cfg = MCTSConfig(
        num_sims=sims,
        max_depth=max_depth,
        tree_reuse=reuse,
        max_nodes=(2 * sims + 1) if reuse else None,
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
    ap.add_argument("--games", type=int, default=512)
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--fresh-sims", type=int, default=None)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--max-depth", type=int, default=48)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--skip-throughput", action="store_true")
    args = ap.parse_args()
    sims_f = args.fresh_sims or args.sims
    game = ConnectFour()

    out = {"sims_reuse": args.sims, "sims_fresh": sims_f}
    rw = fw = dr = 0
    for s in range(args.seeds):
        a, b, c = head_to_head(
            game, args.sims, sims_f, args.games, args.max_depth, seed=101 + s
        )
        rw, fw, dr = rw + a, fw + b, dr + c
    n = rw + fw + dr
    score = (rw + 0.5 * dr) / max(n, 1)
    elo = 400.0 * np.log10(score / (1 - score)) if 0 < score < 1 else float("inf")
    out.update(
        {
            "games": n,
            "reuse_wins": rw,
            "fresh_wins": fw,
            "draws": dr,
            "reuse_score": round(score, 4),
            "reuse_elo_delta": round(float(elo), 1),
        }
    )

    if not args.skip_throughput:
        t_fresh, mv = selfplay_time(
            game, args.sims, args.batch, False, args.max_depth, seed=7
        )
        t_reuse, mv_r = selfplay_time(
            game, args.sims, args.batch, True, args.max_depth, seed=7
        )
        out.update(
            {
                "selfplay_batch": args.batch,
                "t_fresh_s": round(t_fresh, 3),
                "t_reuse_s": round(t_reuse, 3),
                "env_steps_per_s_fresh": int(mv / t_fresh),
                "env_steps_per_s_reuse": int(mv_r / t_reuse),
                "reuse_cost_x": round(t_reuse / t_fresh, 3),
            }
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
