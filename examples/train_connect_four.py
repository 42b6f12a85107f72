#!/usr/bin/env python
"""Train AlphaZero on Connect-Four — the example binary.

The analogue of the reference's example (reference:
examples/connect_four.rs:53-80), which wired ConnectFourGame + a dummy
uniform net into Coach::setup(...15 positional hyperparameters...) +
learn(). Here the same run is a typed config + a Coach over a real net.

Usage:
  python examples/train_connect_four.py                 # tiny smoke run
  python examples/train_connect_four.py --preset full   # conv resnet run
  python examples/train_connect_four.py --cpu           # force CPU
"""

import argparse
import logging
import sys

sys.path.insert(0, ".")


def build_preset(name: str, seed: int = 0, checkpoint_dir=None):
    """``(game, model, cfg)`` of a named preset — shared by ``main`` and
    ``chip_smoke.py``."""
    from alphazero_tpu.config import (
        ArenaConfig,
        AZConfig,
        MCTSConfig,
        ReplayConfig,
        SelfPlayConfig,
        TrainConfig,
    )
    from alphazero_tpu.games import ConnectFour
    from alphazero_tpu.models import AZResNet, MLPNet

    game = ConnectFour()

    if name == "smoke":
        model = MLPNet(num_actions=game.num_actions, hidden=(64,))
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=16, max_depth=24),
            selfplay=SelfPlayConfig(batch_size=16, temp_threshold=15),
            replay=ReplayConfig(capacity=1 << 14),
            train=TrainConfig(batch_size=64, steps_per_iteration=16),
            arena=ArenaConfig(num_games=16, update_threshold=0.55, num_sims=8),
            num_iterations=3,
            seed=seed,
            checkpoint_dir=checkpoint_dir,
        )
    elif name == "mlp":
        # BASELINE config 2: tiny MLP, single-chip self-play + train loop
        model = MLPNet(num_actions=game.num_actions, hidden=(256, 256))
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=50, max_depth=48),
            selfplay=SelfPlayConfig(batch_size=512, temp_threshold=15),
            replay=ReplayConfig(capacity=1 << 17),
            train=TrainConfig(batch_size=512, steps_per_iteration=128),
            arena=ArenaConfig(
                num_games=128,
                update_threshold=0.55,
                num_sims=25,
                anchor_interval=2,
            ),
            num_iterations=20,
            seed=seed,
            checkpoint_dir=checkpoint_dir,
        )
    elif name == "convnet":
        # the C11-parity net (the reference's TF1 architecture spec,
        # connect_four_net.py:20-100: conv3x3x512 stack + dense heads),
        # trained end-to-end to back the parity claim with a run
        from alphazero_tpu.models import AZConvNet

        model = AZConvNet(num_actions=game.num_actions, channels=512)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=50, max_depth=48, dirichlet_alpha=1.0),
            selfplay=SelfPlayConfig(batch_size=1024, temp_threshold=15),
            replay=ReplayConfig(capacity=1 << 18),
            train=TrainConfig(batch_size=512, steps_per_iteration=256),
            arena=ArenaConfig(
                num_games=128,
                update_threshold=0.55,
                num_sims=25,
                anchor_interval=3,
            ),
            num_iterations=10,
            seed=seed,
            checkpoint_dir=checkpoint_dir,
        )
    elif name == "economy":
        # the measured training-economy recipe: the
        # flagship resnet driven by the Gumbel engine at a small budget.
        # Plain gumbel is the 8-seed paired-analysis winner (+174 peak /
        # +179 final anchored Elo vs the PUCT baseline, t=2.7/2.1, at
        # equal wall-clock); the earlier gumbel+PCR composition was
        # re-measured at n=8 and dropped (PCR adds nothing on top —
        # paired t=0.3; train_compare_cpu_seeds.json)
        model = AZResNet(num_actions=game.num_actions, channels=64, blocks=5)
        cfg = AZConfig(
            mcts=MCTSConfig(
                num_sims=32, max_depth=48, gumbel=True, dirichlet_alpha=None
            ),
            selfplay=SelfPlayConfig(
                batch_size=4096,
                temp_threshold=15,
            ),
            replay=ReplayConfig(capacity=1 << 20),
            train=TrainConfig(batch_size=1024, steps_per_iteration=512),
            arena=ArenaConfig(
                num_games=256,
                update_threshold=0.55,
                num_sims=50,
                anchor_interval=5,
                # sharper anchored-Elo instrument (round-5): dense early
                # passes with 4x anchor games while the anchor edge is
                # still competitive, plus 2 pool-vs-pool cross matches
                # per pass (the star graph's SE was +-204-330)
                anchor_warmup=6,
                anchor_warmup_mult=4,
                pool_cross_matches=2,
                # pure-MCTS rungs: generation 1 sweeps the base anchor
                # outright (round-5 measurement), these give the gauge
                # chain an informative first link
                anchor_ladder=(400, 1600),
            ),
            num_iterations=50,
            seed=seed,
            checkpoint_dir=checkpoint_dir,
            # economy extends to the run harness: the replay-bearing
            # whole-state checkpoint (~hundreds of MB at 1<<20 capacity)
            # is saved every 5 iterations (resume granularity stays 5
            # iterations; the final state is always saved).
            checkpoint_interval=5,
            keep_checkpoints=4,
        )
    else:
        # BASELINE config 3: conv resnet, batched self-play 4096 games.
        # Adopted on a 2x2 factorial (seed-1 50-iteration arms at
        # ±25-30 SE): episode recycling + a 2M packed ring —
        # recycle alone shrank the replay window and LOST ~370 Elo at
        # 1M capacity; with the window restored it matches/beats the
        # fixed scan (2325±30 vs 2195±28 final) at +42% sample
        # throughput for the same selfplay wall-clock.
        model = AZResNet(num_actions=game.num_actions, channels=64, blocks=5)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=100, max_depth=48, dirichlet_alpha=1.0),
            selfplay=SelfPlayConfig(
                batch_size=4096, temp_threshold=15, recycle=True
            ),
            replay=ReplayConfig(capacity=1 << 21),
            train=TrainConfig(batch_size=1024, steps_per_iteration=512),
            arena=ArenaConfig(
                num_games=256,
                update_threshold=0.55,
                num_sims=50,
                anchor_interval=5,
                anchor_warmup=6,
                anchor_warmup_mult=4,
                pool_cross_matches=2,
                anchor_ladder=(400, 1600),
            ),
            num_iterations=50,
            seed=seed,
            checkpoint_dir=checkpoint_dir,
        )

    return game, model, cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--preset",
        choices=["smoke", "mlp", "full", "convnet", "economy"],
        default="smoke",
    )
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--seed", type=int, default=0)
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
    ap.add_argument(
        "--replay-stride",
        type=int,
        default=None,
        metavar="K",
        help="carry the replay/reanalyze rings in only every K-th "
        "periodic checkpoint; the rest are light (MBs, not hundreds) — "
        "resume regenerates at most (K-1)*interval iterations of replay "
        "(config.replay_save_stride)",
    )
    ap.add_argument(
        "--recycle",
        action="store_true",
        help="episode-recycling self-play: every search advances a real "
        "move (finished games reset), value targets resolve via the "
        "cross-call fragment carry (selfplay.recycle); the fixed scan "
        "wastes ~15%% of full-preset searches on finished games",
    )
    ap.add_argument(
        "--recycle-steps",
        type=int,
        default=None,
        metavar="S",
        help="searches (= real moves) per game per iteration with "
        "--recycle; defaults to game.max_moves",
    )
    ap.add_argument(
        "--replay-capacity",
        type=int,
        default=None,
        metavar="N",
        help="override the preset's replay ring capacity (samples)",
    )
    args = ap.parse_args()

    import jax

    from alphazero_tpu.utils.compile_cache import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from alphazero_tpu.coach import Coach

    game, model, cfg = build_preset(args.preset, args.seed, args.checkpoint_dir)

    if args.replay_stride is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, replay_save_stride=args.replay_stride)

    if args.recycle:
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            selfplay=dataclasses.replace(
                cfg.selfplay, recycle=True, recycle_steps=args.recycle_steps
            ),
        )

    if args.replay_capacity is not None:
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            replay=dataclasses.replace(
                cfg.replay, capacity=args.replay_capacity
            ),
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
