#!/usr/bin/env python
"""Train AlphaZero on Gomoku 9x9 — the third game.

Beyond the reference's scope (its only game is Connect-Four): Gomoku
pairs a LARGE free-placement action space (81) with a zero depth-cutoff
heuristic, with 8-fold dihedral symmetry augmentation feeding the
replay. Everything else — coach,
replay, learner, arena, anchored Elo, checkpoints — is the same
machinery as the other games.

Usage:
  python examples/train_gomoku.py                   # smoke run
  python examples/train_gomoku.py --preset mlp      # MLP training run
  python examples/train_gomoku.py --preset full     # conv resnet run
  python examples/train_gomoku.py --cpu             # force CPU
"""

import argparse
import logging
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["smoke", "mlp", "full"], default="smoke")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--size",
        type=int,
        default=9,
        help="board edge: 9 (small edition, default) or 15 (the standard "
        "production board, A=225)",
    )
    ap.add_argument(
        "--replay-stride",
        type=int,
        default=1,
        metavar="K",
        help="carry the replay/reanalyze rings only in every K-th periodic "
        "checkpoint (intermediate saves are light)",
    )
    ap.add_argument(
        "--gumbel",
        type=int,
        default=None,
        metavar="SIMS",
        help="use the Gumbel sequential-halving engine (mcts/gumbel.py) "
        "with this simulation budget — small budgets (8-32) are the point",
    )
    ap.add_argument(
        "--reanalyze",
        type=int,
        default=None,
        metavar="BATCH",
        help="refresh this many stored positions' policy targets per "
        "iteration by re-searching them with the current net "
        "(reanalyze.py; value targets stay the game outcome)",
    )
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from alphazero_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from alphazero_tpu.coach import Coach
    from alphazero_tpu.config import (
        ArenaConfig,
        AZConfig,
        MCTSConfig,
        ReplayConfig,
        SelfPlayConfig,
        TrainConfig,
    )
    from alphazero_tpu.games import Gomoku
    from alphazero_tpu.models import AZResNet, MLPNet

    game = Gomoku(args.size)

    if args.preset == "smoke":
        model = MLPNet(num_actions=game.num_actions, hidden=(64,))
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=12, max_depth=24),
            selfplay=SelfPlayConfig(batch_size=8, temp_threshold=8, max_moves=60),
            replay=ReplayConfig(capacity=1 << 14),
            train=TrainConfig(batch_size=64, steps_per_iteration=16),
            arena=ArenaConfig(num_games=8, update_threshold=0.55, num_sims=8),
            num_iterations=2,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
        )
    elif args.preset == "mlp":
        model = MLPNet(num_actions=game.num_actions, hidden=(512, 512))
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=50, max_depth=48, dirichlet_alpha=0.15),
            selfplay=SelfPlayConfig(batch_size=256, temp_threshold=8),
            replay=ReplayConfig(capacity=1 << 17),
            train=TrainConfig(batch_size=512, steps_per_iteration=128),
            arena=ArenaConfig(
                num_games=64,
                update_threshold=0.55,
                num_sims=25,
                anchor_interval=3,
            ),
            num_iterations=12,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
        )
    else:
        model = AZResNet(num_actions=game.num_actions, channels=64, blocks=5)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=100, max_depth=48, dirichlet_alpha=0.15),
            selfplay=SelfPlayConfig(batch_size=1024, temp_threshold=8),
            replay=ReplayConfig(capacity=1 << 19),
            train=TrainConfig(batch_size=1024, steps_per_iteration=512),
            arena=ArenaConfig(
                num_games=128,
                update_threshold=0.55,
                num_sims=50,
                anchor_interval=5,
            ),
            num_iterations=30,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_interval=5,
        )

    if args.gumbel is not None:
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            mcts=dataclasses.replace(
                cfg.mcts,
                gumbel=True,
                num_sims=args.gumbel,
                dirichlet_alpha=None,  # exploration comes from the Gumbel sample
            ),
        )

    if args.reanalyze is not None:
        import dataclasses

        from alphazero_tpu.config import ReanalyzeConfig

        cfg = dataclasses.replace(
            cfg,
            reanalyze=ReanalyzeConfig(
                batch_size=args.reanalyze,
                capacity=cfg.replay.capacity // max(game.num_symmetries, 1),
            ),
        )

    if args.replay_stride != 1:
        import dataclasses

        cfg = dataclasses.replace(cfg, replay_save_stride=args.replay_stride)

    coach = Coach(game, model, cfg)
    n = args.iterations if args.iterations is not None else cfg.num_iterations
    records = coach.learn(n)
    last = records[-1]
    print(
        f"done: iterations={last['iteration']} model_id={last['model_id']} "
        f"anchored_elo={coach.anchored_ratings.get(coach.model_id, float('nan'))} "
        f"replay={last['replay_size']}"
    )


if __name__ == "__main__":
    main()
