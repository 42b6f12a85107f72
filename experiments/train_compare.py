#!/usr/bin/env python
"""Training-economy comparison: PUCT baseline vs Gumbel vs playout-cap.

Trains the same connect-four MLP from scratch under each self-play
protocol with identical seeds and iteration counts, and reports the
ANCHORED Elo trajectory (vs the fixed pure-MCTS anchor, pinned at 0 —
the one rating comparable across configs) plus wall-clock per phase.

The question each arm answers:
  * baseline  — the framework's stock PUCT protocol.
  * gumbel    — same search compute spent via sequential halving +
                improved-policy targets (mcts/gumbel.py).
  * pcr       — playout-cap randomization: 25% of move-steps at the full
                budget (policy targets), 75% at a cheap budget
                (value-only samples) — more games per compute (KataGo).

Usage:
  python experiments/train_compare.py \\
      [--preset cpu|device] [--iters 20] [--arms baseline,gumbel,pcr] [--out FILE]

``--preset device`` is the BASELINE config-2 scale for a GPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, ".")



def base_config(preset, iters, seed):
    from alphazero_tpu.config import (
        ArenaConfig,
        AZConfig,
        MCTSConfig,
        ReplayConfig,
        SelfPlayConfig,
        TrainConfig,
    )

    if preset == "cpu":
        return AZConfig(
            mcts=MCTSConfig(num_sims=25, max_depth=48),
            selfplay=SelfPlayConfig(batch_size=256, temp_threshold=15),
            replay=ReplayConfig(capacity=1 << 16),
            train=TrainConfig(batch_size=256, steps_per_iteration=64),
            arena=ArenaConfig(
                num_games=64, update_threshold=None, num_sims=25,
                anchor_interval=2, pool_size=4,
            ),
            num_iterations=iters,
            seed=seed,
        )
    # device preset: BASELINE config-2 scale
    return AZConfig(
        mcts=MCTSConfig(num_sims=25, max_depth=48),
        selfplay=SelfPlayConfig(batch_size=2048, temp_threshold=15),
        replay=ReplayConfig(capacity=1 << 19),
        train=TrainConfig(batch_size=1024, steps_per_iteration=256),
        arena=ArenaConfig(
            num_games=256, update_threshold=None, num_sims=25,
            anchor_interval=2, pool_size=5,
        ),
        num_iterations=iters,
        seed=seed,
    )


def arm_config(cfg, arm):
    """The three protocols, matched so full-budget searches are
    comparable: gumbel spends ~the same sims via halving; pcr mixes
    2x-budget policy searches with cheap value-only moves at a LOWER
    average budget (0.25*50 + 0.75*8 = 18.5 sims/move vs 25)."""
    if arm == "baseline":
        return cfg
    if arm == "gumbel":
        return dataclasses.replace(
            cfg,
            mcts=dataclasses.replace(
                cfg.mcts, gumbel=True, num_sims=16, dirichlet_alpha=None
            ),
        )
    if arm == "gumbel_m4":
        # the round-4 head-to-head sweep: top_m=4 beats the clipped-to-7
        # default by +29..+36 Elo at every budget 8-32 on connect four
        # (fixed net). This arm asks whether the narrower improved-policy
        # TARGET (non-candidates zeroed) also trains better.
        return dataclasses.replace(
            cfg,
            mcts=dataclasses.replace(
                cfg.mcts,
                gumbel=True,
                num_sims=16,
                dirichlet_alpha=None,
                gumbel_top_m=4,
            ),
        )
    if arm == "pcr":
        return dataclasses.replace(
            cfg,
            mcts=dataclasses.replace(cfg.mcts, num_sims=50),
            selfplay=dataclasses.replace(
                cfg.selfplay, full_search_prob=0.25, cheap_sims=8
            ),
            # the gate/rating arenas keep the baseline budget (arena
            # num_sims=25) so strength is measured identically
        )
    if arm == "noise":
        # baseline + root Dirichlet exploration noise — the control for
        # the forced arm (forced playouts exist to counteract noise
        # pollution, Wu 2020 §3.2)
        return dataclasses.replace(
            cfg, mcts=dataclasses.replace(cfg.mcts, dirichlet_alpha=1.0)
        )
    if arm == "forced":
        # noise + KataGo forced playouts (k=2) with policy-target pruning
        return dataclasses.replace(
            cfg,
            mcts=dataclasses.replace(
                cfg.mcts, dirichlet_alpha=1.0, forced_playouts=2.0
            ),
        )
    if arm == "reanalyze":
        # baseline protocol + target refresh: every iteration one extra
        # 512-position batched re-search (= 2 of selfplay's 42 B=256
        # move-step searches, ~+5% search compute) re-inserts stored
        # positions with fresh policy targets from the current net
        from alphazero_tpu.config import ReanalyzeConfig

        return dataclasses.replace(
            cfg,
            reanalyze=ReanalyzeConfig(
                batch_size=512, interval=1, capacity=1 << 15
            ),
        )
    if arm == "gumbel_rz":
        # the two paired-analysis winners composed: gumbel search
        # (improved-policy targets) + reanalyze target refresh (the
        # refreshed targets are gumbel's pi' as well)
        from alphazero_tpu.config import ReanalyzeConfig

        return dataclasses.replace(
            cfg,
            mcts=dataclasses.replace(
                cfg.mcts, gumbel=True, num_sims=16, dirichlet_alpha=None
            ),
            reanalyze=ReanalyzeConfig(
                batch_size=512, interval=1, capacity=1 << 15
            ),
        )
    if arm == "economy":
        # gumbel + playout-cap composed (the `economy` training preset):
        # 25% of move-steps run sequential halving at 32 sims with
        # improved-policy targets, 75% cheap value-only moves at 8 —
        # average 14 sims/move vs the baseline's 25
        return dataclasses.replace(
            cfg,
            mcts=dataclasses.replace(
                cfg.mcts, gumbel=True, num_sims=32, dirichlet_alpha=None
            ),
            selfplay=dataclasses.replace(
                cfg.selfplay, full_search_prob=0.25, cheap_sims=8
            ),
        )
    raise SystemExit(f"unknown arm {arm}")


def run_arm(game, arm, cfg):
    import jax

    from alphazero_tpu.coach import Coach
    from alphazero_tpu.models import MLPNet

    model = MLPNet(num_actions=game.num_actions, hidden=(256, 256))
    coach = Coach(game, model, cfg)
    t0 = time.perf_counter()
    records = coach.learn()
    wall = time.perf_counter() - t0
    curve = [
        {
            "iteration": r["iteration"],
            **(
                {"anchored_elo": r["anchored_elo"]}
                if "anchored_elo" in r
                else {}
            ),
            **(
                {"anchor_win_rate": r["anchor_win_rate"]}
                if "anchor_win_rate" in r
                else {}
            ),
            "t_selfplay": r["t_selfplay"],
        }
        for r in records
    ]
    elos = [c["anchored_elo"] for c in curve if "anchored_elo" in c]
    return {
        "arm": arm,
        "wall_s": round(wall, 1),
        "selfplay_s_total": round(sum(c["t_selfplay"] for c in curve), 1),
        "final_anchored_elo": elos[-1] if elos else None,
        "best_anchored_elo": max(elos) if elos else None,
        "curve": curve,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("cpu", "device"), default="cpu")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arms", default="baseline,gumbel,pcr,economy")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from alphazero_tpu.utils.compile_cache import enable_compile_cache

    if args.preset == "cpu":
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    from alphazero_tpu.games import ConnectFour

    game = ConnectFour()
    results = []
    for arm in args.arms.split(","):
        cfg = arm_config(base_config(args.preset, args.iters, args.seed), arm)
        res = run_arm(game, arm, cfg)
        print(json.dumps({k: v for k, v in res.items() if k != "curve"}))
        results.append(res)

    out = args.out or f"docs/runs/train_compare_{args.preset}.json"
    with open(out, "w") as f:
        json.dump(
            {
                "preset": args.preset,
                "iters": args.iters,
                "seed": args.seed,
                "results": results,
            },
            f,
            indent=1,
        )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
