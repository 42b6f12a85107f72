#!/usr/bin/env python
"""Bring-up check of the AlphaZero training path on one NVIDIA GPU.

Runs in ONE process on one card, through the public entry points
(``Coach``, ``make_selfplay_fn``/``make_recycling_selfplay_fn``,
``make_arena_fn``, the search engines), at the connect-four ``full``
preset's widths (examples/train_connect_four.py: AZResNet-64x5 with the
BN-folded eval, B=4096 games x 100 sims with recycling, the 2M-row packed
replay ring, learner batch 1024, a 256-game arena gate). Weights are
random from ``--seed``.

Phases (any failure exits non-zero; nothing is caught and reported OK):

  a. device: the default backend must be ``gpu``; prints the card's
     ``nvidia-smi`` name and power limit.
  b. the card against the CPU backend of the same process: uniform-prior
     search root counts (exact, and equal to the C++ oracle on a sample),
     the folded ResNet forward (bf16 tolerance), the NN-backed search
     (agreement measure), each with the precision it ran at.
  c. timings: ms/move of the XLA engine at B=4096 (uniform and ResNet),
     one full-preset ``Coach.run_iteration()`` with its ``PhaseTimer``
     phases, a whole-state checkpoint save, and a resume into a fresh
     ``Coach`` that must restore equal state.
  d. the last stdout line is exactly
     ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

``--four-cards`` runs only the data-parallel path on four cards: a
full-preset ``Coach.run_iteration()`` on ``make_mesh((4, 1))`` against
the same config on one card, and sharded uniform-prior self-play against
unsharded; the last line then has ``"count": 4``.

Usage: ``python chip_smoke.py`` (one card) or
``python chip_smoke.py --four-cards``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The one cut of the full preset, forced by the script's time budget (1200 s
# on one card, compilation included): the pure-MCTS anchor ladder. Its
# 400- and 1600-sim rung arenas take ~6-40 s each on an H100 at 400 W, and
# the first iteration calibrates the chain and rates the incumbent against
# both rungs four times over (anchor_warmup_mult) — about six minutes.
# Widths, batch, sims, ring size, learner steps and the warm-up anchor
# passes are the preset's own; the cut is printed before the last line.
CUT_ANCHOR_LADDER = ()      # preset: anchor_ladder=(400, 1600)

# phase (b) sizes
B = 4096
NN_CPU_GAMES = 1024         # CPU reference side of the NN-backed search
ORACLE_SAMPLE = 32
# NN-backed search agreement thresholds (card vs CPU, same positions)
NN_ARGMAX_AGREE_MIN = 0.90
NN_MEAN_TV_MAX = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _import_repo():
    """The program itself; refuse with a reason when the script runs
    outside its checkout."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import alphazero_tpu  # noqa: F401
        import train_connect_four  # noqa: F401
    except ImportError as e:
        print(
            f"chip_smoke: the alphazero_tpu checkout is not beside this "
            f"script ({e})",
            file=sys.stderr,
        )
        sys.exit(2)


def device_check(count: int):
    """Phase (a). Returns the card's nvidia-smi line."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX's default backend is {backend!r} "
            f"({jax.devices()}) — no result",
            file=sys.stderr,
        )
        sys.exit(2)
    if len(jax.devices()) < count:
        fail(f"needs {count} cards, JAX sees {jax.devices()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    return smi


def full_preset(seed: int, checkpoint_dir=None):
    """The connect-four ``full`` preset with the script's cut."""
    from train_connect_four import build_preset

    game, model, cfg = build_preset("full", seed, checkpoint_dir)
    cfg = dataclasses.replace(
        cfg, arena=dataclasses.replace(cfg.arena, anchor_ladder=CUT_ANCHOR_LADDER)
    )
    return game, model, cfg


def print_cuts(preset_cfg, cfg) -> None:
    log(
        f"cut: anchor_ladder {preset_cfg.arena.anchor_ladder} -> "
        f"{cfg.arena.anchor_ladder} (learner steps "
        f"{cfg.train.steps_per_iteration}, anchor warm-up "
        f"{cfg.arena.anchor_warmup} passes x{cfg.arena.anchor_warmup_mult}: uncut)"
    )


def random_positions(game, n: int, max_moves: int, seed: int):
    """``n`` non-terminal connect-four positions, game i after i % (max_moves+1)
    random legal moves (built on the host CPU backend)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(seed)
    with jax.default_device(cpu):
        state = jax.vmap(lambda _: game.init())(jnp.arange(n))
        step = jax.jit(jax.vmap(game.step))
        valid = jax.jit(jax.vmap(game.valid_moves))
        term = jax.jit(jax.vmap(game.terminal))
        depth = np.arange(n) % (max_moves + 1)
        for t in range(max_moves):
            vm = np.asarray(valid(state))
            acts = np.array([rng.choice(np.nonzero(v)[0]) for v in vm])
            nxt = step(state, jnp.asarray(acts))
            done = np.asarray(term(nxt)[0])
            keep = (t >= depth) | done
            state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    keep.reshape((-1,) + (1,) * (a.ndim - 1)), b, a
                ),
                nxt,
                state,
            )
    return state


def to_device(tree, device):
    import jax

    return jax.tree_util.tree_map(lambda x: jax.device_put(x, device), tree)


def timed(fn, *args, reps: int = 3):
    """(result, median seconds of ``reps`` warm calls); the first call
    compiles and is not timed."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, sorted(times)[len(times) // 2]


# ------------------------------------------------------------- phase (b)


def check_uniform_search(game, seed: int) -> dict:
    """Uniform-prior XLA search at B=4096, 100 sims: root counts on the
    card equal the CPU backend's exactly, and the C++ oracle's on a
    sample. Exactness holds because the backup's f32 einsum is pinned to
    Precision.HIGHEST (no TF32) and every other operand is 0/1 or a
    small integer."""
    import jax
    import numpy as np

    from alphazero_tpu import native
    from alphazero_tpu.config import MCTSConfig
    from alphazero_tpu.games.connect_four import heights
    from alphazero_tpu.mcts.search import make_search_fn
    from alphazero_tpu.models import make_uniform_model

    cfg = MCTSConfig(num_sims=100, max_depth=48)
    search = make_search_fn(game, make_uniform_model(game).apply_fn, cfg)
    root_counts = jax.jit(lambda s: search({}, s).root_counts())
    state = random_positions(game, B, 12, seed)
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    counts_gpu, sec = timed(root_counts, to_device(state, gpu))
    counts_gpu = np.asarray(counts_gpu)
    counts_cpu = np.asarray(root_counts(to_device(state, cpu)))
    n_diff = int((counts_gpu != counts_cpu).any(-1).sum())
    log(
        f"[b] uniform search B={B} sims=100: card vs CPU root counts, "
        f"precision: backup einsum f32 HIGHEST, exact equality required: "
        f"{B - n_diff}/{B} games equal"
    )
    check(n_diff == 0, f"uniform root counts differ card vs CPU in {n_diff} games")
    check((counts_gpu.sum(-1) <= 100).all(), "visit totals exceed num_sims")
    idx = np.random.default_rng(seed).choice(B, ORACLE_SAMPLE, replace=False)
    boards = np.asarray(state.board)
    hts = np.asarray(jax.vmap(heights)(state))
    bad = 0
    for i in idx:
        ref = native.oracle_search(boards[i], hts[i], 100, 1.0, 48)
        check(ref is not None, "C++ oracle unavailable (no g++ toolchain)")
        bad += int(not np.array_equal(ref, counts_gpu[i]))
    log(
        f"[b] uniform search: card vs C++ oracle (csrc/mcts_oracle.cpp) on "
        f"{ORACLE_SAMPLE} sampled positions, exact: "
        f"{ORACLE_SAMPLE - bad}/{ORACLE_SAMPLE} equal"
    )
    check(bad == 0, f"card root counts differ from the C++ oracle at {bad} positions")
    return {"uniform_ms_per_move": sec * 1e3}


def resnet_forward_tolerance(ref) -> float:
    """bf16 keeps 8 significant bits (unit roundoff 2^-9). The folded
    ResNet-64x5 rounds its activations to bf16 at 13 stages (stem, 10
    tower convs, two head convs/dense), and two backends that accumulate
    in different orders can each land one rounding off the exact value
    at every stage: |card - cpu| <= 2 * 13 * 2^-9 relative to the output
    scale."""
    import numpy as np

    return 2 * 13 * 2.0**-9 * max(1.0, float(np.abs(ref).max()))


def check_resnet_forward(game, model, variables, seed: int) -> None:
    import jax
    import numpy as np

    from alphazero_tpu.models import make_apply_fn

    apply_fn = jax.jit(make_apply_fn(model))
    state = random_positions(game, B, 20, seed + 1)
    feats = jax.vmap(game.to_features)(state)
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    lg, vg = apply_fn(to_device(variables, gpu), to_device(feats, gpu))
    lc, vc = apply_fn(to_device(variables, cpu), to_device(feats, cpu))
    lg, vg, lc, vc = (np.asarray(x, np.float64) for x in (lg, vg, lc, vc))
    tol_l, tol_v = resnet_forward_tolerance(lc), resnet_forward_tolerance(vc)
    dl, dv = np.abs(lg - lc).max(), np.abs(vg - vc).max()
    log(
        f"[b] folded ResNet-64x5 forward B={B}, precision: bf16 convs "
        f"(f32 accumulate), f32 heads: max|dlogit|={dl:.3e} (atol {tol_l:.3e}, "
        f"max|logit|={np.abs(lc).max():.3f}), max|dvalue|={dv:.3e} (atol {tol_v:.3e}), "
        f"policy argmax agreement {np.mean(lg.argmax(-1) == lc.argmax(-1)):.4f}"
    )
    check(dl <= tol_l, f"ResNet logits differ card vs CPU by {dl} > {tol_l}")
    check(dv <= tol_v, f"ResNet value differs card vs CPU by {dv} > {tol_v}")


def check_nn_search(game, model, variables, seed: int) -> dict:
    """NN-backed search at B=4096 on the card; the CPU backend searches
    the first NN_CPU_GAMES of the same positions (games are independent,
    so a game's search does not depend on the batch around it).
    Measure: per-game agreement of the most-visited root action, and the
    mean total-variation distance between root visit distributions. The
    two backends' bf16 forwards differ by a few 1e-3 (see the forward
    check), which can flip near-tied PUCT choices inside a search."""
    import jax
    import numpy as np

    from alphazero_tpu.config import MCTSConfig
    from alphazero_tpu.mcts.search import make_search_fn
    from alphazero_tpu.models import make_apply_fn

    cfg = MCTSConfig(num_sims=100, max_depth=48)
    search = make_search_fn(game, make_apply_fn(model), cfg)
    root_counts = jax.jit(lambda p, s: search(p, s).root_counts())
    state = random_positions(game, B, 12, seed + 2)
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    counts_gpu, sec = timed(
        root_counts, to_device(variables, gpu), to_device(state, gpu)
    )
    sub = jax.tree_util.tree_map(lambda x: x[:NN_CPU_GAMES], state)
    counts_cpu = np.asarray(
        root_counts(to_device(variables, cpu), to_device(sub, cpu))
    )
    cg = np.asarray(counts_gpu)[:NN_CPU_GAMES]
    agree = float(np.mean(cg.argmax(-1) == counts_cpu.argmax(-1)))
    pg = cg / cg.sum(-1, keepdims=True)
    pc = counts_cpu / counts_cpu.sum(-1, keepdims=True)
    tv = float(np.mean(0.5 * np.abs(pg - pc).sum(-1)))
    exact = float(np.mean((cg == counts_cpu).all(-1)))
    log(
        f"[b] NN-backed search (folded ResNet-64x5, bf16) B={B} sims=100, "
        f"CPU reference on {NN_CPU_GAMES} games: most-visited action "
        f"agreement {agree:.4f} (min {NN_ARGMAX_AGREE_MIN}), mean root "
        f"visit TV distance {tv:.4f} (max {NN_MEAN_TV_MAX}), identical "
        f"count vectors {exact:.4f}"
    )
    check(agree >= NN_ARGMAX_AGREE_MIN, f"NN search argmax agreement {agree}")
    check(tv <= NN_MEAN_TV_MAX, f"NN search mean TV distance {tv}")
    return {"resnet_ms_per_move": sec * 1e3}


# ------------------------------------------------------------- phase (c)


def _host_state(coach):
    from alphazero_tpu.parallel.distributed import host_copy

    return host_copy(coach._payload())


def run_full_iteration(seed: int) -> dict:
    """One full-preset iteration, a timed checkpoint save, and a resume
    into a fresh Coach that must restore equal state."""
    import jax
    import numpy as np

    from alphazero_tpu.coach import Coach
    from train_connect_four import build_preset

    _, _, preset_cfg = build_preset("full", seed)
    out = {}
    with tempfile.TemporaryDirectory(prefix="az_smoke_ckpt_") as ckpt:
        game, model, cfg = full_preset(seed, checkpoint_dir=ckpt)
        # save once, explicitly timed, instead of inside run_iteration
        cfg = dataclasses.replace(cfg, checkpoint_interval=1 << 30)
        print_cuts(preset_cfg, cfg)
        t0 = time.perf_counter()
        coach = Coach(game, model, cfg)
        rec = coach.run_iteration()
        out["iteration_s_incl_compile"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec2 = coach.run_iteration()
        out["iteration_s"] = time.perf_counter() - t0
        for r in (rec, rec2):
            check(np.isfinite(r["loss_first"]) and np.isfinite(r["loss_last"]), "non-finite loss")
            games = r["arena_wins"] + r["arena_losses"] + r["arena_draws"]
            check(games == cfg.arena.num_games, f"arena played {games} games")
            check("anchored_elo" in r, "the warm-up anchored rating pass did not run")
            check(
                r["selfplay_moves"] == cfg.selfplay.batch_size * game.max_moves,
                "recycling move count",
            )
        log(
            "[c] full-preset iteration 1 (with compile) "
            f"{out['iteration_s_incl_compile']:.2f} s; iteration 2 "
            f"{out['iteration_s']:.2f} s; phases (s): "
            + ", ".join(f"{k}={v}" for k, v in rec2.items() if k.startswith("t_"))
            + f"; loss {rec2['loss_first']:.4f}->{rec2['loss_last']:.4f}, "
            f"replay_size {rec2['replay_size']}, arena "
            f"{rec2['arena_wins']}-{rec2['arena_losses']}-{rec2['arena_draws']}"
        )
        t0 = time.perf_counter()
        coach.save()
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = Coach(game, model, cfg)
        out["resume_s"] = time.perf_counter() - t0
        check(resumed.iteration == coach.iteration, "resumed iteration differs")
        check(resumed.model_id == coach.model_id, "resumed model_id differs")
        a, b = _host_state(coach), _host_state(resumed)
        la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        check(
            jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b),
            "resumed payload structure differs",
        )
        same = all(np.array_equal(x, y) for x, y in zip(la, lb))
        nbytes = sum(np.asarray(x).nbytes for x in la)
        stats = jax.devices()[0].memory_stats() or {}
        log(
            f"[c] device peak_bytes_in_use after the iterations: "
            f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB"
        )
        log(
            f"[c] checkpoint save {out['save_s']:.2f} s ({nbytes / 2**20:.1f} MiB), "
            f"resume into a fresh Coach {out['resume_s']:.2f} s, restored "
            f"state equal: {same}"
        )
        check(same, "resumed state differs from the saved state")
    return out


# ------------------------------------------------------- --four-cards


def four_cards(seed: int) -> None:
    """The data-parallel path on make_mesh((4, 1)) against one card."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from alphazero_tpu.coach import Coach
    from alphazero_tpu.models import make_uniform_model
    from alphazero_tpu.parallel import make_mesh
    from alphazero_tpu.selfplay import ActorCarry, make_recycling_selfplay_fn
    from train_connect_four import build_preset

    mesh = make_mesh((4, 1), devices=jax.devices()[:4])
    game, model, cfg = full_preset(seed)
    _, _, preset_cfg = build_preset("full", seed)
    print_cuts(preset_cfg, cfg)

    # uniform-prior self-play: sharded must equal unsharded exactly
    init_carry, play = make_recycling_selfplay_fn(
        game, make_uniform_model(game).apply_fn, cfg.mcts, cfg.selfplay
    )
    key = jax.random.key(seed)
    one = jax.jit(play)
    _, traj1, stats1 = one({}, jax.jit(init_carry)(), key)
    data_tb = NamedSharding(mesh, P(None, "data"))
    data_b = NamedSharding(mesh, P("data"))
    carry_sd = jax.eval_shape(init_carry)
    carry_sh = ActorCarry(
        state=jax.tree_util.tree_map(lambda _: data_b, carry_sd.state),
        move_count=data_b,
        frag_features=data_tb,
        frag_pi=data_tb,
    )
    sp_sd = jax.eval_shape(play, {}, carry_sd, key)
    four = jax.jit(
        play,
        out_shardings=(
            carry_sh,
            jax.tree_util.tree_map(lambda _: data_tb, sp_sd[1]),
            jax.tree_util.tree_map(lambda _: data_b, sp_sd[2]),
        ),
    )
    _, traj4, stats4 = four({}, jax.jit(init_carry, out_shardings=carry_sh)(), key)
    same_pi = np.array_equal(np.asarray(traj1.pi), np.asarray(traj4.pi))
    moves1 = int(np.asarray(stats1.num_moves).sum())
    moves4 = int(np.asarray(stats4.num_moves).sum())
    eps1 = int(np.asarray(stats1.done).sum())
    eps4 = int(np.asarray(stats4.done).sum())
    log(
        f"[4] uniform recycling self-play B={cfg.selfplay.batch_size} sims="
        f"{cfg.mcts.num_sims}: 4-card vs 1-card root-count targets equal: "
        f"{same_pi}; move totals {moves4} vs {moves1}; games with a "
        f"finished episode {eps4} vs {eps1}"
    )
    check(same_pi and moves1 == moves4 and eps1 == eps4, "sharded uniform self-play differs")

    # the ResNet full-preset iteration: 4-card mesh vs one card
    t0 = time.perf_counter()
    rec4 = Coach(game, model, cfg, mesh=mesh).run_iteration()
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec1 = Coach(game, model, cfg).run_iteration()
    t1 = time.perf_counter() - t0
    # bf16 convs at 1024 vs 4096 games per card may pick other kernels,
    # so searches (and games) can part ways: the learner loss is compared
    # at a tolerance of 0.1 — ~6 standard errors of a 1024-sample
    # minibatch mean at per-sample loss spread ~0.5
    d_first = abs(rec4["loss_first"] - rec1["loss_first"])
    d_last = abs(rec4["loss_last"] - rec1["loss_last"])
    log(
        f"[4] full-preset Coach iteration, 4 cards (data axis sharded, psum "
        f"learner) {t4:.2f} s vs 1 card {t1:.2f} s (both incl. compile); "
        f"loss_first {rec4['loss_first']:.4f} vs {rec1['loss_first']:.4f}, "
        f"loss_last {rec4['loss_last']:.4f} vs {rec1['loss_last']:.4f} "
        f"(tolerance 0.1); selfplay_moves {rec4['selfplay_moves']} vs "
        f"{rec1['selfplay_moves']}; 4-card phases (s): "
        + ", ".join(f"{k}={v}" for k, v in rec4.items() if k.startswith("t_"))
    )
    check(d_first <= 0.1 and d_last <= 0.1, "4-card loss differs beyond tolerance")
    check(rec4["selfplay_moves"] == rec1["selfplay_moves"], "move totals differ")


# ------------------------------------------------------------------- main


def one_card(seed: int) -> None:
    """Phases (b) and (c) on the first card."""
    import jax

    from alphazero_tpu.models import init_model
    from train_connect_four import build_preset

    game, model, _ = build_preset("full", seed)
    variables = init_model(model, jax.random.key(seed), game.feature_shape)
    timings = check_uniform_search(game, seed)
    check_resnet_forward(game, model, variables, seed)
    timings.update(check_nn_search(game, model, variables, seed))
    log(
        f"[c] XLA engine ms/move at B={B}, 100 sims (median of 3 warm "
        f"calls): uniform prior {timings['uniform_ms_per_move']:.2f} ms, "
        f"folded ResNet-64x5 {timings['resnet_ms_per_move']:.2f} ms"
    )
    run_full_iteration(seed)


def result_line(count: int) -> str:
    """The last stdout line: the device as JAX reports it."""
    import jax

    dev = jax.devices()[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": count,
            },
        }
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the 4-card data-parallel path and its 1-card comparison",
    )
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    # the CPU backend must come up beside the card (the reference side of
    # phase (b)); set before the first import of jax
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    _import_repo()
    import jax

    from alphazero_tpu.utils.compile_cache import enable_compile_cache

    smi = device_check(count)
    log(f"card (nvidia-smi name, power.limit): {smi}")
    log(f"jax {jax.__version__}, devices {jax.devices()}")
    log(f"compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()
    (four_cards if args.four_cards else one_card)(args.seed)
    log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print(result_line(count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
