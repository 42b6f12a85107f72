#!/usr/bin/env python
"""Pit two trained checkpoints (or a checkpoint vs pure MCTS) head to head.

The standalone evaluation tool on top of the batched arena (arena.py —
the reference's arena::play_games, arena.rs:62-99, which only ever ran
inside Coach's gate): seating-swapped lockstep games, greedy argmax play,
and an Elo-difference estimate from the match score.

Usage:
  # checkpoint vs checkpoint (same game; models may differ)
  python examples/eval_checkpoints.py --game connect_four \\
      --a ckpt_run1 --a-model resnet --b ckpt_run2 --b-model mlp \\
      --games 256 --sims 100

  # checkpoint vs the pure-MCTS baseline
  python examples/eval_checkpoints.py --game othello --a ckpt_oth --a-model mlp

Prints one JSON line: wins/losses/draws from A's perspective + elo_diff.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

sys.path.insert(0, ".")


def load_side(game, ckpt_dir, model_kind, hidden, channels, blocks,
              allow_missing=False):
    """Returns (apply_fn, params, label) — the one checkpoint/model
    loading path shared by every example CLI (eval/analyze/export/play).
    ``allow_missing=True`` falls back to the uniform prior when the
    directory holds no checkpoint (the play CLIs' friendly behavior);
    the default raises."""
    import jax

    from alphazero_tpu.models import (
        AZResNet,
        MLPNet,
        make_apply_fn,
        make_uniform_model,
    )

    if ckpt_dir is None:
        net = make_uniform_model(game)
        return net.apply_fn, {}, "pure-mcts"

    from alphazero_tpu.checkpoint import latest_step, restore_checkpoint
    from alphazero_tpu.config import TrainConfig
    from alphazero_tpu.train import TrainState, init_train_state, variables_of

    if model_kind == "resnet":
        model = AZResNet(num_actions=game.num_actions, channels=channels, blocks=blocks)
    else:
        model = MLPNet(num_actions=game.num_actions, hidden=(hidden, hidden))
    tstate = init_train_state(
        model, jax.random.key(0), game.feature_shape, TrainConfig()
    )
    step = latest_step(ckpt_dir)
    if step is None:
        if allow_missing:
            net = make_uniform_model(game)
            return net.apply_fn, {}, f"pure-mcts (no checkpoint in {ckpt_dir})"
        raise SystemExit(f"no checkpoint found in {ckpt_dir}")
    payload, _ = restore_checkpoint(
        ckpt_dir, step, {"incumbent": tstate._asdict()}, partial=True
    )
    tstate = TrainState(**payload["incumbent"])
    return (
        make_apply_fn(model),
        variables_of(tstate),
        f"{ckpt_dir}@{step}",
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--game", choices=("connect_four", "othello", "gomoku", "hex"),
                    default="connect_four")
    ap.add_argument("--a", default=None, help="checkpoint dir for side A")
    ap.add_argument("--b", default=None, help="checkpoint dir for side B (default: pure MCTS)")
    ap.add_argument("--a-model", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--b-model", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--max-depth", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from alphazero_tpu.arena import make_arena_fn
    from alphazero_tpu.config import MCTSConfig
    from alphazero_tpu.games import ConnectFour, Gomoku, Hex, Othello

    game = {"connect_four": ConnectFour, "othello": Othello, "gomoku": Gomoku,
            "hex": Hex}[
        args.game
    ]()
    apply_a, params_a, label_a = load_side(
        game, args.a, args.a_model, args.hidden, args.channels, args.blocks
    )
    apply_b, params_b, label_b = load_side(
        game, args.b, args.b_model, args.hidden, args.channels, args.blocks
    )

    cfg = MCTSConfig(num_sims=args.sims, max_depth=args.max_depth)
    play = jax.jit(
        make_arena_fn(game, apply_a, apply_b, cfg, num_games=args.games)
    )
    result = play(params_a, params_b, jax.random.key(args.seed))
    aw, bw, dr = int(result.cand_wins), int(result.inc_wins), int(result.draws)
    n = aw + bw + dr
    score = (aw + 0.5 * dr) / max(n, 1)
    eps = 1.0 / (2.0 * max(n, 1))
    s = min(max(score, eps), 1.0 - eps)
    elo = 400.0 * math.log10(s / (1.0 - s))
    print(
        json.dumps(
            {
                "game": args.game,
                "a": label_a,
                "b": label_b,
                "games": n,
                "a_wins": aw,
                "b_wins": bw,
                "draws": dr,
                "score_a": round(score, 4),
                "elo_diff_a_minus_b": round(elo, 1),
                "sims": args.sims,
            }
        )
    )


if __name__ == "__main__":
    main()
