#!/usr/bin/env python
"""Multi-host training launcher (BASELINE config 5).

Runs the SAME Coach program on every host under multi-controller JAX; the
device mesh spans all hosts and XLA's collectives carry the learner's
gradient psum across devices and hosts. This replaces the reference's in-process
transport (crossbeam channels between search threads and the inference
service, reference: src/async_mcts.rs:22-23, 117-189) with
``jax.distributed`` — there is no hand-written messaging.

One command per host (process_id 0 hosts the coordinator):

  # host 0
  python examples/train_multihost.py --coordinator host0:9876 \
      --num-processes 2 --process-id 0
  # host 1
  python examples/train_multihost.py --coordinator host0:9876 \
      --num-processes 2 --process-id 1

Single-machine simulation of a multi-host topology (what
tests/test_multihost.py runs — 2 processes x 4 virtual CPU devices each,
one 8-device global mesh):

  python examples/train_multihost.py --coordinator localhost:9876 \
      --num-processes 2 --process-id {0,1} --platform cpu --host-devices 4

Process 0 prints one JSON record per iteration; metrics/checkpoints are
written by process 0 only (device state is global and identical).
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--platform", default=None, help="force backend (e.g. cpu)")
    ap.add_argument(
        "--host-devices",
        type=int,
        default=None,
        help="virtual CPU devices per process (topology simulation)",
    )
    ap.add_argument("--game", choices=("connect_four", "othello"), default="connect_four")
    ap.add_argument("--net", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--max-depth", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1024, help="global self-play games")
    ap.add_argument("--temp-threshold", type=int, default=15)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--train-batch", type=int, default=256)
    ap.add_argument("--train-steps", type=int, default=64)
    ap.add_argument("--arena-games", type=int, default=64)
    ap.add_argument("--arena-sims", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--max-moves", type=int, default=None)
    return ap.parse_args(argv)


def build_cfg(args):
    """The run configuration — shared with tests/test_multihost.py so the
    multi-process run is compared against a single-process run of the
    IDENTICAL config."""
    from alphazero_tpu.config import (
        ArenaConfig,
        AZConfig,
        MCTSConfig,
        ReplayConfig,
        SelfPlayConfig,
        TrainConfig,
    )

    return AZConfig(
        mcts=MCTSConfig(num_sims=args.sims, max_depth=args.max_depth),
        selfplay=SelfPlayConfig(
            batch_size=args.batch,
            temp_threshold=args.temp_threshold,
            max_moves=args.max_moves,
        ),
        replay=ReplayConfig(capacity=args.capacity),
        train=TrainConfig(
            batch_size=args.train_batch, steps_per_iteration=args.train_steps
        ),
        arena=ArenaConfig(
            num_games=args.arena_games,
            update_threshold=0.6,
            num_sims=args.arena_sims,
        ),
        num_iterations=args.iterations,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
    )


def build_game_and_model(args):
    from alphazero_tpu.games import ConnectFour, Othello
    from alphazero_tpu.models import AZResNet, MLPNet

    game = ConnectFour() if args.game == "connect_four" else Othello()
    if args.net == "mlp":
        model = MLPNet(num_actions=game.num_actions, hidden=(args.hidden, args.hidden))
    else:
        model = AZResNet(
            num_actions=game.num_actions, channels=args.channels, blocks=args.blocks
        )
    return game, model


def main(argv=None):
    args = parse_args(argv)

    from alphazero_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        platform=args.platform,
        host_device_count=args.host_devices,
    )

    import jax

    from alphazero_tpu.coach import Coach
    from alphazero_tpu.parallel import is_primary, make_mesh

    if is_primary():
        print(
            f"multihost up: {jax.process_count()} processes, "
            f"{jax.device_count()} global devices "
            f"({jax.local_device_count()} local)",
            flush=True,
        )

    mesh = make_mesh()  # all global devices on the data axis
    game, model = build_game_and_model(args)
    cfg = build_cfg(args)
    coach = Coach(game, model, cfg, mesh=mesh)
    for _ in range(cfg.num_iterations):
        record = coach.run_iteration()
        if is_primary():
            print(json.dumps(record), flush=True)
    if cfg.checkpoint_dir and coach.iteration % max(cfg.checkpoint_interval, 1) != 0:
        coach.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
