#!/usr/bin/env python
"""Headline benchmark: MCTS-backed env-steps/s/chip on connect-four.

Runs the steady-state self-play actor (BASELINE config 1 semantics: pure
MCTS, uniform prior, 100 simulations per move) on the GPU and prints ONE
JSON line:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

vs_baseline is measured against the 100k env-steps/s/chip north-star target
(BASELINE.md — the reference itself publishes no numbers).

Batch size is the lockstep operating point (tens of thousands of games);
override with AZ_BENCH_BATCH / AZ_BENCH_SIMS / AZ_BENCH_STEPS. Without a
GPU it prints no metric and exits non-zero: a CPU number is never
recorded as the device metric.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from alphazero_tpu.config import MCTSConfig
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.models import make_uniform_model
from alphazero_tpu.selfplay import make_actor_step_fn
from alphazero_tpu.utils.compile_cache import enable_compile_cache

BASELINE_TARGET = 100_000.0  # env-steps/s/chip (BASELINE.json north_star)


def main():
    if jax.default_backend() != "gpu":
        print(
            f"bench.py: needs a GPU, JAX's default backend is "
            f"{jax.default_backend()!r} (no metric emitted)",
            file=sys.stderr,
        )
        return 1
    enable_compile_cache()

    batch = int(os.environ.get("AZ_BENCH_BATCH", 65536))
    sims = int(os.environ.get("AZ_BENCH_SIMS", 100))
    steps = int(os.environ.get("AZ_BENCH_STEPS", 20))

    game = ConnectFour()
    net = make_uniform_model(game)
    cfg = MCTSConfig(num_sims=sims, max_depth=48)
    init_carry, actor_step = make_actor_step_fn(
        game, net.apply_fn, cfg, batch_size=batch, temp_threshold=15
    )
    step = jax.jit(actor_step)

    carry = init_carry()
    key = jax.random.key(0)
    sync = jax.block_until_ready

    # warmup: compile + enough steps to reach the actor's STEADY STATE.
    # The first ~20 moves after a cold start are all lockstep opening
    # positions — wide shallow trees, short PUCT descents — and run
    # faster than the steady-state mix that includes endgame boards
    # (narrow deep trees -> longer descents). The metric is the plateau.
    warmup = int(os.environ.get("AZ_BENCH_WARMUP", 40))
    for i in range(warmup):
        key, sub = jax.random.split(key)
        carry, pi = step({}, carry, sub)
    sync(pi)

    # variance protocol: the headline is the MEDIAN of `repeats` timed
    # windows, with the min/max spread reported alongside — a real
    # regression must clear the spread.
    repeats = int(os.environ.get("AZ_BENCH_REPEATS", 3))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(steps):
            key, sub = jax.random.split(key)
            carry, pi = step({}, carry, sub)
        sync(pi)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]

    env_steps = steps * batch
    eps = env_steps / dt
    n_chips = max(jax.device_count(), 1)
    eps_per_chip = eps / n_chips
    eps_min = env_steps / max(times) / n_chips
    eps_max = env_steps / min(times) / n_chips

    print(
        json.dumps(
            {
                "metric": "mcts_env_steps_per_sec_per_chip_connect4",
                "value": round(eps_per_chip, 1),
                "unit": "env_steps/s/chip",
                "vs_baseline": round(eps_per_chip / BASELINE_TARGET, 3),
                "detail": {
                    "batch_games": batch,
                    "sims_per_move": sims,
                    "timed_moves": steps,
                    "warmup_moves": warmup,
                    "repeats": repeats,
                    "seconds_median": round(dt, 3),
                    "seconds_all": [round(t, 3) for t in times],
                    "eps_spread": [round(eps_min, 1), round(eps_max, 1)],
                    "protocol": "steady_state_median",
                    "sims_per_sec": round(eps * sims, 0),
                    "backend": jax.default_backend(),
                    "device_kind": jax.devices()[0].device_kind,
                    "devices": n_chips,
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
