#!/usr/bin/env python
"""Train AlphaZero on Othello 8x8 — the second-game example (BASELINE
config 4).

Exercises the generic game protocol end-to-end (the role the reference's
``Game`` trait plays, src/game.rs:8-28) on a game with a large action
space (65), pass moves, dihedral symmetry augmentation (8x) and a nonzero
depth-cutoff heuristic. Everything else — search, coach, replay,
learner, arena, Elo, checkpoints — is the same machinery as
Connect-Four.

Usage:
  python examples/train_othello.py                  # smoke run
  python examples/train_othello.py --preset full    # conv resnet run
  python examples/train_othello.py --cpu            # force CPU
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
        "--channels",
        type=int,
        default=128,
        help="AZResNet tower width for --preset full. Default 128 by the "
        "round-5 Elo-per-wall-clock A/B: at equal wall-clock the 128-wide "
        "tower reached 2542+-165 anchored Elo vs 1372+-43 for 64-wide "
        "(Othello is capacity-bound where connect-four is saturated)",
    )
    ap.add_argument(
        "--blocks", type=int, default=5, help="AZResNet depth for --preset full"
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
    from alphazero_tpu.games import Othello
    from alphazero_tpu.models import AZResNet, MLPNet

    game = Othello()

    if args.preset == "smoke":
        model = MLPNet(num_actions=game.num_actions, hidden=(64,))
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=12, max_depth=24),
            selfplay=SelfPlayConfig(batch_size=8, temp_threshold=12, max_moves=70),
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
            mcts=MCTSConfig(num_sims=50, max_depth=64, dirichlet_alpha=0.3),
            selfplay=SelfPlayConfig(batch_size=256, temp_threshold=12),
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
        model = AZResNet(
            num_actions=game.num_actions,
            channels=args.channels,
            blocks=args.blocks,
        )
        # CONTINUOUS (AlphaZero-2017) mode: measured, a gated run
        # deadlocks at generation 0 — the random-init ResNet's BN washes
        # its priors to near-uniform, so the incumbent plays essentially
        # pure 50-sim MCTS, which early sharp-prior candidates lose to
        # (0.15-0.44 win rate for 30 iterations) even though each trained
        # generation beats the previous one (gen2 beat gen1 75-49).
        # Always-adopt training climbs that ladder; the arena still runs
        # every iteration for the Elo curve.
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=100, max_depth=80, dirichlet_alpha=0.3),
            selfplay=SelfPlayConfig(batch_size=1024, temp_threshold=12),
            replay=ReplayConfig(capacity=1 << 19),
            train=TrainConfig(batch_size=1024, steps_per_iteration=1024),
            arena=ArenaConfig(
                num_games=128,
                update_threshold=None,
                num_sims=50,
                anchor_interval=5,
                # the sharpened instrument: dense early passes
                # + pure-MCTS rungs keep anchored SE tight enough to
                # resolve preset-level comparisons
                anchor_warmup=3,
                anchor_warmup_mult=2,
                pool_cross_matches=2,
                # no anchor ladder here: measured on the chip, pure-MCTS
                # scaling is nearly flat on Othello (uniform 400-vs-1600
                # sims = 55-69-4, ~+40 Elo for 4x the budget), so rungs
                # cannot bridge toward net strength and each high-budget
                # rung arena costs ~5 min; warmup + cross matches carry
                # the (relative) comparisons this preset is used for
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

    coach = Coach(game, model, cfg)
    n = args.iterations if args.iterations is not None else cfg.num_iterations
    records = coach.learn(n)
    last = records[-1]
    print(
        f"done: iterations={last['iteration']} model_id={last['model_id']} "
        f"elo={coach.elo.ratings.get(coach.model_id, 0.0):.1f} "
        f"replay={last['replay_size']}"
    )


if __name__ == "__main__":
    main()
