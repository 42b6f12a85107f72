#!/usr/bin/env python
"""Secondary benchmarks: reproduce the engine-comparison numbers in
README.md / docs/ENGINES.md (the driver-facing headline stays bench.py).

Prints one JSON line per measurement: ms/move of the XLA search engine
(mcts/search.py) per game, model and batch, on the default backend, which
each line names. Select a subset with AZ_BENCH_ONLY=substring.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from alphazero_tpu.config import MCTSConfig
from alphazero_tpu.games import ConnectFour, Othello
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.models import (
    AZResNet,
    MLPNet,
    init_model,
    make_apply_fn,
    make_uniform_model,
)
from alphazero_tpu.utils.compile_cache import enable_compile_cache


def timeit(f, n=3):
    jax.block_until_ready(f())
    t0 = time.perf_counter()
    for _ in range(n):
        r = f()
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n


def emit(name, ms, **detail):
    print(json.dumps({"bench": name, "move_ms": round(ms, 1), **detail}))


def main():
    enable_compile_cache()
    only = os.environ.get("AZ_BENCH_ONLY", "")
    cases = []

    c4 = ConnectFour()
    uni4 = make_uniform_model(c4)
    cases.append(("c4_uniform_B4096_100sims", c4, uni4.apply_fn, {}, 4096, {}))

    mlp = MLPNet(num_actions=c4.num_actions, hidden=(256, 256))
    mlp_apply = make_apply_fn(mlp)
    mlp_params = init_model(mlp, jax.random.key(0), c4.feature_shape)
    cases.append(("c4_mlp_B4096_100sims", c4, mlp_apply, mlp_params, 4096, {}))

    res = AZResNet(num_actions=c4.num_actions, channels=64, blocks=5)
    res_apply = make_apply_fn(res)
    res_params = init_model(res, jax.random.key(1), c4.feature_shape)
    cases.append(("c4_resnet_B4096_100sims", c4, res_apply, res_params, 4096, {}))

    oth = Othello()
    unio = make_uniform_model(oth)
    for B in (1024, 4096):
        cases.append(
            (f"oth_uniform_B{B}_100sims", oth, unio.apply_fn, {}, B,
             {"max_depth": 80})
        )

    from alphazero_tpu.games import Gomoku

    gmk = Gomoku()
    unig = make_uniform_model(gmk)
    cases.append(
        ("gomoku_uniform_B4096_100sims", gmk, unig.apply_fn, {}, 4096,
         {"max_depth": 48})
    )

    # Production 15x15 edition (A=225) + the within-family action-space
    # scaling set: Gomoku edges 7/9/15 -> A=49/81/225 share the same
    # dynamics code, so the per-sim cost ratio isolates the dense-plane
    # O(A*C) bet.
    gmk15 = Gomoku(15)
    unig15 = make_uniform_model(gmk15)
    for B in (1024, 4096):
        cases.append(
            (f"gomoku15_uniform_B{B}_100sims", gmk15, unig15.apply_fn, {}, B,
             {"max_depth": 64})
        )
    g15mlp = MLPNet(num_actions=gmk15.num_actions, hidden=(256, 256))
    g15mlp_apply = make_apply_fn(g15mlp)
    g15mlp_params = init_model(
        g15mlp, jax.random.key(3), gmk15.feature_shape
    )
    cases.append(
        ("gomoku15_mlp_B1024_100sims", gmk15, g15mlp_apply, g15mlp_params,
         1024, {"max_depth": 64})
    )
    gmk7 = Gomoku(7)
    unig7 = make_uniform_model(gmk7)
    cases.append(
        ("gomoku7_uniform_B4096_100sims", gmk7, unig7.apply_fn, {}, 4096,
         {"max_depth": 48})
    )

    # Hex: the connection game — the flood-fill terminal (games/hex.py)
    from alphazero_tpu.games import Hex

    hx = Hex()
    unih = make_uniform_model(hx)
    for B in (1024, 4096):
        cases.append(
            (f"hex_uniform_B{B}_100sims", hx, unih.apply_fn, {}, B,
             {"max_depth": 56})
        )
    hmlp = MLPNet(num_actions=hx.num_actions, hidden=(256, 256))
    hmlp_apply = make_apply_fn(hmlp)
    hmlp_params = init_model(hmlp, jax.random.key(2), hx.feature_shape)
    cases.append(
        ("hex_mlp_B1024_100sims", hx, hmlp_apply, hmlp_params, 1024,
         {"max_depth": 56})
    )

    for name, game, apply_fn, params, B, over in cases:
        if only and only not in name:
            continue
        cfg = MCTSConfig(num_sims=100, max_depth=over.get("max_depth", 48))
        state = jax.vmap(lambda _: game.init())(jnp.arange(B))
        search = make_search_fn(game, apply_fn, cfg)
        jfn = jax.jit(lambda p, s: search(p, s).root_counts())
        ms = timeit(lambda: jfn(params, state)) * 1e3
        emit(name, ms, engine="xla", batch=B, backend=jax.default_backend(),
             device_kind=jax.devices()[0].device_kind)


if __name__ == "__main__":
    sys.exit(main())
