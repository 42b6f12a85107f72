#!/usr/bin/env python
"""Gumbel-vs-PUCT strength and wall-clock measurement.

The claim behind ``MCTSConfig.gumbel`` (mcts/gumbel.py, Danihelka et al.
2022) is equal-or-better play at SMALL simulation budgets: sequential
halving spends the root budget optimally and the played move carries a
policy-improvement guarantee, where PUCT at 8-32 sims can burn most of its
budget re-confirming the prior. This script pits the two engines head to
head with the SAME network and measures:

1. STRENGTH: lockstep seating-swapped games, Gumbel playing its halving
   winner (per-move Gumbel noise = its canonical exploration), PUCT
   sampling ∝ counts for --temp-moves plies then greedy (the bench_tt
   protocol). ``--puct-sims`` can give PUCT a LARGER budget to find the
   equal-strength point.
2. THROUGHPUT: jitted steady-state self-play, gumbel on vs off.

Usage:
  python bench_gumbel.py \\
      [--game connect_four] [--ckpt .runs/r2/c4_mlp --model mlp] \\
      [--sims 16] [--puct-sims 16] [--games 512]
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
from alphazero_tpu.games import ConnectFour, Gomoku, Othello
from alphazero_tpu.mcts.gumbel import make_gumbel_search_fn
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.models import make_uniform_model
from alphazero_tpu.ops import action_probs
from alphazero_tpu.selfplay import make_selfplay_fn


def load_net(game, ckpt, model_kind, hidden, channels, blocks):
    if ckpt is None:
        return make_uniform_model(game).apply_fn, {}, "uniform"
    from alphazero_tpu.checkpoint import latest_step, restore_checkpoint
    from alphazero_tpu.config import TrainConfig
    from alphazero_tpu.models import AZResNet, MLPNet, make_apply_fn
    from alphazero_tpu.train import TrainState, init_train_state, variables_of

    if model_kind == "resnet":
        model = AZResNet(
            num_actions=game.num_actions, channels=channels, blocks=blocks
        )
    else:
        model = MLPNet(num_actions=game.num_actions, hidden=(hidden, hidden))
    tstate = init_train_state(
        model, jax.random.key(0), game.feature_shape, TrainConfig()
    )
    step = latest_step(ckpt)
    payload, _ = restore_checkpoint(
        ckpt, step, {"incumbent": tstate._asdict()}, partial=True
    )
    tstate = TrainState(**payload["incumbent"])
    return make_apply_fn(model), variables_of(tstate), f"{ckpt}@{step}"


def head_to_head(
    game, apply_fn, params, g_sims, p_sims, num_games, max_depth,
    temp_moves, top_m, seed,
):
    """G (gumbel) vs P (PUCT), seating swap — returns (g_wins, p_wins, dr)."""
    cfg_g = MCTSConfig(
        num_sims=g_sims, max_depth=max_depth, gumbel=True, gumbel_top_m=top_m
    )
    cfg_p = MCTSConfig(num_sims=p_sims, max_depth=max_depth)
    search_g = make_gumbel_search_fn(game, apply_fn, cfg_g)
    search_p = make_search_fn(game, apply_fn, cfg_p)
    step_v = jax.vmap(game.step)
    term_v = jax.vmap(game.terminal)
    B = num_games
    T = game.max_moves

    def play(rng):
        g_first = jnp.arange(B) < (B + 1) // 2
        state = jax.vmap(lambda _: game.init())(jnp.arange(B))

        def ply(carry, t):
            state, done, g_to_move, winner_g, is_draw, rng = carry
            rng, k_g, k_tie, k_act = jax.random.split(rng, 4)

            a_g = search_g(params, state, k_g).action
            counts_p = search_p(params, state).root_counts()
            temp = jnp.where(t < temp_moves, 1.0, 0.0)
            pi_p = action_probs(counts_p, temp, k_tie)
            a_p = jax.random.categorical(
                k_act, jnp.log(pi_p + 1e-12), axis=-1
            ).astype(jnp.int32)
            action = jnp.where(g_to_move, a_g, a_p)

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
            won_g = jnp.where(mover_won, g_to_move, ~g_to_move)
            winner_g = jnp.where(
                ended & (mover_won | to_move_won), won_g, winner_g
            )
            is_draw = jnp.where(ended & ~mover_won & ~to_move_won, True, is_draw)
            done = done | now_done
            g_to_move = jnp.where(done, g_to_move, ~g_to_move)
            return (state, done, g_to_move, winner_g, is_draw, rng), None

        carry0 = (
            state,
            jnp.zeros((B,), bool),
            g_first,
            jnp.zeros((B,), bool),
            jnp.zeros((B,), bool),
            rng,
        )
        (state, done, _, winner_g, is_draw, _), _ = jax.lax.scan(
            ply, carry0, jnp.arange(T)
        )
        decisive = done & ~is_draw
        return (
            jnp.sum(decisive & winner_g),
            jnp.sum(decisive & ~winner_g),
            jnp.sum(done & is_draw),
        )

    gw, pw, dr = jax.jit(play)(jax.random.key(seed))
    return int(gw), int(pw), int(dr)


def selfplay_time(game, apply_fn, params, sims, batch, gumbel, max_depth,
                  top_m, seed, reps=3):
    cfg = MCTSConfig(
        num_sims=sims, max_depth=max_depth, gumbel=gumbel, gumbel_top_m=top_m
    )
    sp = jax.jit(
        make_selfplay_fn(game, apply_fn, cfg, SelfPlayConfig(batch_size=batch))
    )
    traj, stats = sp(params, jax.random.key(seed))  # compile
    jax.block_until_ready(traj.pi)
    best = float("inf")
    for i in range(reps):
        t0 = time.perf_counter()
        traj, stats = sp(params, jax.random.key(seed + 1 + i))
        jax.block_until_ready(traj.pi)
        best = min(best, time.perf_counter() - t0)
    moves = int(jnp.sum(stats.num_moves))
    return best, moves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--game", default="connect_four",
                    choices=["connect_four", "othello", "gomoku"])
    ap.add_argument("--ckpt", default=None, help="checkpoint dir (default: uniform net)")
    ap.add_argument("--model", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--games", type=int, default=512)
    ap.add_argument("--sims", type=int, default=16, help="gumbel budget")
    ap.add_argument("--puct-sims", type=int, default=None,
                    help="PUCT budget (default: same as --sims)")
    ap.add_argument("--top-m", type=int, default=16)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--temp-moves", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--skip-throughput", action="store_true")
    ap.add_argument("--skip-strength", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    game = {"connect_four": ConnectFour, "othello": Othello, "gomoku": Gomoku}[
        args.game
    ]()
    max_depth = args.max_depth or (48 if args.game == "connect_four" else 64)
    p_sims = args.puct_sims or args.sims
    apply_fn, params, label = load_net(
        game, args.ckpt, args.model, args.hidden, args.channels, args.blocks
    )

    out = {
        "game": args.game,
        "net": label,
        "gumbel_sims": args.sims,
        "puct_sims": p_sims,
        "top_m": args.top_m,
    }
    if not args.skip_strength:
        gw = pw = dr = 0
        for s in range(args.seeds):
            a, b, c = head_to_head(
                game, apply_fn, params, args.sims, p_sims, args.games,
                max_depth, args.temp_moves, args.top_m, seed=431 + s,
            )
            gw, pw, dr = gw + a, pw + b, dr + c
        n = gw + pw + dr
        score = (gw + 0.5 * dr) / max(n, 1)
        eps = 1.0 / (2.0 * max(n, 1))
        sc = min(max(score, eps), 1.0 - eps)
        elo = 400.0 * np.log10(sc / (1.0 - sc))
        out.update(
            {
                "games": n,
                "gumbel_wins": gw,
                "puct_wins": pw,
                "draws": dr,
                "gumbel_score": round(score, 4),
                "gumbel_elo_delta": round(float(elo), 1),
            }
        )

    if not args.skip_throughput:
        t_p, mv_p = selfplay_time(
            game, apply_fn, params, args.sims, args.batch, False, max_depth,
            args.top_m, seed=7,
        )
        t_g, mv_g = selfplay_time(
            game, apply_fn, params, args.sims, args.batch, True, max_depth,
            args.top_m, seed=7,
        )
        out.update(
            {
                "selfplay_batch": args.batch,
                "t_puct_s": round(t_p, 3),
                "t_gumbel_s": round(t_g, 3),
                "env_steps_per_s_puct": int(mv_p / t_p),
                "env_steps_per_s_gumbel": int(mv_g / t_g),
                "gumbel_cost_x": round(t_g / t_p, 3),
            }
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
