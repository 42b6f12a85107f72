#!/usr/bin/env python
"""Scaling benchmark: self-play actor throughput vs device count.

BASELINE configs[4] scores 1-to-N scaling efficiency (target >= 80%); this
harness measures it. Default mode is WEAK scaling — per-device game batch
held constant while the mesh grows (the production regime: more chips run
more lockstep games), games sharded on the ``data`` axis (SURVEY.md §2
episode parallelism; the rayon pool's accelerator-native replacement,
reference: src/coach.rs:202-272). ``AZ_BENCH_MODE=strong`` holds the
GLOBAL batch fixed (``AZ_BENCH_BATCH_GLOBAL``, default 32768) while the
mesh grows; efficiency is speedup(N)/N.

On a multi-GPU host run it as-is. On a single host you can
mechanically validate the harness with virtual CPU devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 AZ_BENCH_CPU=1 \
      python bench_scaling.py

(CPU "devices" share the same cores, so CPU efficiency numbers are NOT
meaningful — the run only proves the sharded program compiles+executes at
every mesh size.)

Prints one JSON line per mesh size plus a summary line with the
1-to-max-devices efficiency.
"""

import json
import os
import sys
import time


def main():
    if os.environ.get("AZ_BENCH_CPU"):
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from alphazero_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from alphazero_tpu.config import MCTSConfig
    from alphazero_tpu.games import ConnectFour
    from alphazero_tpu.models import make_uniform_model
    from alphazero_tpu.parallel import make_mesh, shard_batch
    from alphazero_tpu.selfplay import make_actor_step_fn

    mode = os.environ.get("AZ_BENCH_MODE", "weak")
    per_dev = int(os.environ.get("AZ_BENCH_BATCH_PER_DEV", 8192))
    global_b = int(os.environ.get("AZ_BENCH_BATCH_GLOBAL", 32768))
    sims = int(os.environ.get("AZ_BENCH_SIMS", 100))
    steps = int(os.environ.get("AZ_BENCH_STEPS", 10))

    devs = jax.devices()
    counts = [n for n in (1, 2, 4, 8, 16, 32, 64, 128) if n <= len(devs)]
    if mode == "strong":
        counts = [n for n in counts if global_b % n == 0]

    game = ConnectFour()
    net = make_uniform_model(game)
    cfg = MCTSConfig(num_sims=sims, max_depth=48)

    sync = jax.block_until_ready

    results = []
    for n in counts:
        mesh = make_mesh(devices=devs[:n], axis_names=("data",))
        batch = global_b if mode == "strong" else per_dev * n
        init_carry, actor_step = make_actor_step_fn(
            game, net.apply_fn, cfg, batch_size=batch, temp_threshold=15
        )
        step = jax.jit(actor_step)
        carry = shard_batch(mesh, init_carry())
        key = jax.random.key(0)
        for _ in range(2):  # compile + settle
            key, sub = jax.random.split(key)
            carry, pi = step({}, carry, sub)
        sync(pi)
        t0 = time.perf_counter()
        for _ in range(steps):
            key, sub = jax.random.split(key)
            carry, pi = step({}, carry, sub)
        sync(pi)
        dt = time.perf_counter() - t0
        eps = steps * batch / dt
        results.append((n, eps))
        print(
            json.dumps(
                {
                    "devices": n,
                    "batch_games": batch,
                    "env_steps_per_sec": round(eps, 1),
                    "env_steps_per_sec_per_device": round(eps / n, 1),
                    "seconds": round(dt, 3),
                }
            )
        )

    base = results[0][1]
    n_max, eps_max = results[-1]
    # weak: ideal eps grows with N at fixed per-device batch.
    # strong: ideal eps ALSO grows with N (fixed global batch finishes
    # N x faster) — same ratio either way.
    eff = eps_max / (base * n_max) if base > 0 else 0.0
    print(
        json.dumps(
            {
                "metric": f"selfplay_{mode}_scaling_efficiency",
                "value": round(eff, 3),
                "unit": f"1_to_{n_max}_devices",
                "backend": jax.default_backend(),
                "meaningful": jax.default_backend() != "cpu",
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
