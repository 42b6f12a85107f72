"""Coach loop + checkpoint/resume tests (Coach had zero reference
coverage — SURVEY.md §4)."""

import numpy as np
import pytest

import jax

from alphazero_tpu.coach import Coach
from alphazero_tpu.config import (
    ArenaConfig,
    AZConfig,
    MCTSConfig,
    ReplayConfig,
    SelfPlayConfig,
    TrainConfig,
)
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.replay import replay_total
from alphazero_tpu.models import MLPNet


def tiny_cfg(tmp=None, seed=0):
    return AZConfig(
        mcts=MCTSConfig(num_sims=8, max_depth=16),
        selfplay=SelfPlayConfig(batch_size=4, temp_threshold=6),
        replay=ReplayConfig(capacity=2048),
        train=TrainConfig(batch_size=32, steps_per_iteration=4, learning_rate=1e-3),
        arena=ArenaConfig(num_games=4, update_threshold=0.6, num_sims=4),
        num_iterations=2,
        seed=seed,
        checkpoint_dir=str(tmp) if tmp else None,
    )


def make_coach(tmp=None, seed=0):
    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    return Coach(game, model, tiny_cfg(tmp, seed))


def test_run_iteration_record():
    coach = make_coach()
    rec = coach.run_iteration()
    assert rec["iteration"] == 1
    assert rec["replay_size"] > 0
    assert np.isfinite(rec["loss_last"])
    assert rec["arena_wins"] + rec["arena_losses"] + rec["arena_draws"] <= 4
    assert rec["model_id"] in (0, 1)
    assert rec["accepted"] == (rec["model_id"] == 1)
    # phase timers recorded
    for phase in ("t_selfplay", "t_train", "t_arena"):
        assert phase in rec


def test_learn_multiple_iterations():
    coach = make_coach(seed=1)
    records = coach.learn(2)
    assert [r["iteration"] for r in records] == [1, 2]
    assert records[1]["replay_total"] > records[0]["replay_total"]
    # model_id monotone, incremented only on acceptance
    assert records[1]["model_id"] >= records[0]["model_id"]


def test_checkpoint_resume_roundtrip(tmp_path):
    coach = make_coach(tmp_path, seed=2)
    coach.learn(2)
    saved_params = jax.tree_util.tree_leaves(coach.incumbent.params)
    saved_iter, saved_mid = coach.iteration, coach.model_id
    saved_replay_total = replay_total(coach.replay)

    resumed = make_coach(tmp_path, seed=2)
    assert resumed.iteration == saved_iter
    assert resumed.model_id == saved_mid
    assert replay_total(resumed.replay) == saved_replay_total
    for a, b in zip(saved_params, jax.tree_util.tree_leaves(resumed.incumbent.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resumed coach keeps training without error
    rec = resumed.run_iteration()
    assert rec["iteration"] == saved_iter + 1
    # metrics jsonl exists
    assert (tmp_path / "metrics.jsonl").exists()


def test_elo_tracker_semantics():
    from alphazero_tpu.utils import EloTracker, elo_from_match

    t = EloTracker()
    r = t.record_match(1, 0, wins=8, losses=2, draws=0, accepted=True)
    assert r > 0
    assert t.ratings[1] == r
    r2 = t.record_match(2, 1, wins=0, losses=10, draws=0, accepted=False)
    assert r2 < r
    assert 2 not in t.ratings
    # draws-only match keeps the rating where it is
    assert elo_from_match(100.0, 0, 0, 10) == pytest.approx(100.0)
    # empty match is inert
    assert elo_from_match(50.0, 0, 0, 0) == 50.0


def test_checkpoint_interval(tmp_path):
    """checkpoint_interval=k saves every k-th iteration; learn() always
    persists its final state (resume sees the last iteration)."""
    import dataclasses

    from alphazero_tpu.checkpoint import latest_step

    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    cfg = dataclasses.replace(tiny_cfg(tmp_path, seed=4), checkpoint_interval=2)
    coach = Coach(game, model, cfg)
    coach.run_iteration()
    assert latest_step(str(tmp_path)) is None  # iteration 1 skipped
    coach.run_iteration()
    assert latest_step(str(tmp_path)) == 2
    coach.learn(1)  # iteration 3: off-interval, but learn() saves at the end
    assert latest_step(str(tmp_path)) == 3
    resumed = Coach(game, model, cfg)
    assert resumed.iteration == 3


def test_skip_first_selfplay(tmp_path):
    """The reference's skip_first_play flag (examples/connect_four.rs:73):
    after resume with a non-empty replay, the first iteration trains
    directly on the restored examples."""
    import dataclasses

    coach = make_coach(tmp_path, seed=5)
    coach.learn(1)
    total_before = replay_total(coach.replay)

    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    cfg = dataclasses.replace(tiny_cfg(tmp_path, seed=5), skip_first_selfplay=True)
    resumed = Coach(game, model, cfg)
    rec = resumed.run_iteration()
    assert rec["selfplay_moves"] == 0          # no new games
    assert replay_total(resumed.replay) == total_before
    assert np.isfinite(rec["loss_last"])       # trained on restored replay
    rec2 = resumed.run_iteration()
    assert rec2["selfplay_moves"] > 0          # second iteration plays again


def test_continuous_mode_always_adopts(tmp_path):
    """update_threshold=None = AlphaZero-2017 continuous training: every
    candidate is adopted; the arena still runs for Elo telemetry."""
    import dataclasses

    from alphazero_tpu.config import ArenaConfig

    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    cfg = dataclasses.replace(
        tiny_cfg(seed=6),
        arena=ArenaConfig(num_games=4, update_threshold=None, num_sims=4),
    )
    coach = Coach(game, model, cfg)
    r1 = coach.run_iteration()
    r2 = coach.run_iteration()
    assert r1["accepted"] and r2["accepted"]
    assert (r1["model_id"], r2["model_id"]) == (1, 2)


def test_anchor_arena_logged(tmp_path):
    """arena.anchor_interval plays the incumbent vs the fixed pure-MCTS
    anchor every k iterations and logs anchor_win_rate."""
    import dataclasses

    from alphazero_tpu.config import ArenaConfig

    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    cfg = dataclasses.replace(
        tiny_cfg(seed=8),
        arena=ArenaConfig(
            num_games=4, update_threshold=0.6, num_sims=4, anchor_interval=2
        ),
    )
    coach = Coach(game, model, cfg)
    r1 = coach.run_iteration()
    r2 = coach.run_iteration()
    assert "anchor_win_rate" not in r1
    assert 0.0 <= r2["anchor_win_rate"] <= 1.0


def test_fit_elo_anchored_ml():
    """fit_elo: anchored Bradley-Terry maximum likelihood — 75% score is
    ~+191 Elo, ratings are transitive, sweeps stay finite, the anchor is
    pinned, and ratings can DECREASE (unlike the ladder)."""
    from alphazero_tpu.utils.elo import fit_elo

    r = fit_elo(
        [{"a": 1, "b": "anchor", "wins_a": 75, "wins_b": 25, "draws": 0}],
        "anchor",
    )
    assert r["anchor"] == 0.0
    assert 160 < r[1] < 200
    # add a crushing loss for 1 against a weak newcomer: 1's rating drops
    r2 = fit_elo(
        [
            {"a": 1, "b": "anchor", "wins_a": 75, "wins_b": 25, "draws": 0},
            {"a": 2, "b": "anchor", "wins_a": 25, "wins_b": 75, "draws": 0},
            {"a": 1, "b": 2, "wins_a": 5, "wins_b": 95, "draws": 0},
        ],
        "anchor",
    )
    assert r2[1] < r[1]
    # sweep stays finite (virtual half-draw regularizer)
    r3 = fit_elo(
        [{"a": 3, "b": "anchor", "wins_a": 10, "wins_b": 0, "draws": 0}],
        "anchor",
    )
    assert np.isfinite(r3[3]) and r3[3] > 300


def test_elo_standard_errors():
    """Fisher-information SEs of the anchored fit: the two-player even
    match reproduces the analytic SE, quadrupling the games halves it,
    and a sweep-only record reports an honestly huge uncertainty."""
    import math

    from alphazero_tpu.utils.elo import _ELO_SCALE, elo_standard_errors, fit_elo

    def se_of(n_games):
        ms = [
            {
                "a": 1,
                "b": "anchor",
                "wins_a": n_games // 2,
                "wins_b": n_games // 2,
                "draws": 0,
            }
        ]
        return elo_standard_errors(ms, "anchor", fit_elo(ms, "anchor"))[1]

    # even score, rating 0: info = n·0.25 + virtual 0.5·0.25
    for n in (100, 400):
        assert abs(se_of(n) - _ELO_SCALE / math.sqrt(0.25 * n + 0.125)) < 1e-6
    assert abs(se_of(400) - se_of(100) / 2) < 1.0  # 4x games ≈ half the SE

    # a swept match says little about HOW much stronger: SE stays large
    sweep = [{"a": 1, "b": "anchor", "wins_a": 10, "wins_b": 0, "draws": 0}]
    assert elo_standard_errors(sweep, "anchor", fit_elo(sweep, "anchor"))[1] > 200

    # multi-player graph: every free player gets a finite positive SE
    ms = [
        {"a": 1, "b": "anchor", "wins_a": 30, "wins_b": 10, "draws": 0},
        {"a": 2, "b": "anchor", "wins_a": 10, "wins_b": 30, "draws": 0},
        {"a": 1, "b": 2, "wins_a": 25, "wins_b": 15, "draws": 0},
    ]
    ses = elo_standard_errors(ms, "anchor", fit_elo(ms, "anchor"))
    assert set(ses) == {1, 2}
    assert all(np.isfinite(s) and s > 0 for s in ses.values())
    # the anchor is the gauge — no SE for it
    assert "anchor" not in ses


def test_fit_elo_scales_to_long_runs(monkeypatch):
    """A 1000-generation synthetic match graph (chain + anchor spokes +
    an un-aggregated duplicate-match pile, ~12k raw records) fits, with
    SEs. The fit is O(aggregated edges) per MM sweep: every sweep's
    reductions run over the unique player pairs (not the raw records),
    the sweep count stays within the cap, and the raw pile and its
    per-pair aggregate give the same ratings — so a long production run's
    append-only match sidecar (coach.py pool persistence) stays cheap to
    refit every anchor pass."""
    from alphazero_tpu.utils.elo import elo_standard_errors, fit_elo

    rng = np.random.default_rng(0)
    ms = []
    for g in range(1, 1000):
        # each generation plays its predecessor and (sparsely) the anchor;
        # raw records are intentionally NOT pre-aggregated (duplicates)
        for _ in range(4):
            ms.append(
                {
                    "a": g,
                    "b": g - 1,
                    "wins_a": int(rng.integers(3, 8)),
                    "wins_b": int(rng.integers(1, 5)),
                    "draws": int(rng.integers(0, 3)),
                }
            )
        if g % 10 == 0:
            ms.append(
                {
                    "a": g,
                    "b": "anchor",
                    "wins_a": int(rng.integers(5, 10)),
                    "wins_b": int(rng.integers(1, 5)),
                    "draws": 0,
                }
            )
    sizes = []
    bincount = np.bincount

    def counting_bincount(x, weights=None, minlength=0):
        sizes.append(len(x))
        return bincount(x, weights=weights, minlength=minlength)

    monkeypatch.setattr(np, "bincount", counting_bincount)
    r = fit_elo(ms, "anchor", iters=500)
    monkeypatch.undo()
    pairs = {frozenset((m["a"], m["b"])) for m in ms} | {
        frozenset((g, "anchor")) for g in range(1000)
    }
    assert 0 < len(sizes) <= 2 * 500  # two edge reductions per MM sweep
    assert set(sizes) == {len(pairs)} and len(pairs) < len(ms) // 2
    ses = elo_standard_errors(ms, "anchor", r)
    agg = {}
    for m in ms:
        e = agg.setdefault((m["a"], m["b"]), {"a": m["a"], "b": m["b"], "wins_a": 0, "wins_b": 0, "draws": 0})
        for k in ("wins_a", "wins_b", "draws"):
            e[k] += m[k]
    r_agg = fit_elo(list(agg.values()), "anchor")
    assert r_agg.keys() == r.keys()
    np.testing.assert_allclose([r_agg[k] for k in r], [r[k] for k in r], atol=1e-6)
    assert r["anchor"] == 0.0
    assert len(r) == 1001 and len(ses) == 1000
    assert all(np.isfinite(v) for v in r.values())
    # the chain trends upward: late generations outrate early ones
    assert r[999] > r[10]


def test_anchored_rating_pass(tmp_path):
    """Every anchor_interval iterations the coach plays the pure-MCTS
    anchor + the snapshot pool, refits anchored Elo, and persists the
    match graph across resume."""
    import dataclasses

    game = ConnectFour()
    cfg = dataclasses.replace(
        tiny_cfg(tmp_path, seed=9),
        arena=ArenaConfig(
            num_games=8,
            update_threshold=None,  # continuous: model_id advances
            num_sims=4,
            anchor_interval=1,
            pool_size=2,
        ),
    )
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    coach = Coach(game, model, cfg)
    recs = coach.learn(3)
    for rec in recs:
        assert "anchor_win_rate" in rec
        assert "anchored_elo" in rec and np.isfinite(rec["anchored_elo"])
        assert "anchored_elo_se" in rec and rec["anchored_elo_se"] > 0
    # pool capped at pool_size, newest generation always kept
    assert len(coach.pool) == 2
    assert coach.pool[-1][0] == coach.model_id
    # matches: one vs anchor per pass + pool matches from passes 2,3
    assert sum(m["b"] == "anchor" for m in coach.pool_matches) == 3
    assert any(m["b"] != "anchor" for m in coach.pool_matches)
    n_matches = len(coach.pool_matches)

    resumed = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    assert len(resumed.pool_matches) == n_matches
    assert resumed.anchored_ratings.keys() == coach.anchored_ratings.keys()
    # pool repopulates on the next pass after restart
    assert resumed.pool == []
    rec = resumed.run_iteration()
    assert "anchored_elo" in rec
    assert len(resumed.pool) == 1


def test_pool_in_checkpoint(tmp_path):
    """arena.pool_in_checkpoint persists the anchored-pool snapshots:
    a resumed coach rates against the FULL pool immediately (no
    thin-pool window), and checkpoints written without the option
    restore into a pool-persisting coach via the optional-subtree
    fallback."""
    import dataclasses

    game = ConnectFour()
    base = dataclasses.replace(
        tiny_cfg(tmp_path, seed=21),
        arena=ArenaConfig(
            num_games=8, update_threshold=None, num_sims=4,
            anchor_interval=1, pool_size=2, pool_in_checkpoint=True,
        ),
    )
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), base)
    coach.learn(3)
    assert len(coach.pool) == 2

    resumed = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), base)
    assert [g for g, _ in resumed.pool] == [g for g, _ in coach.pool]
    for (_, a), (_, b) in zip(coach.pool, resumed.pool):
        for la, lb in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    rec = resumed.run_iteration()
    # full pool immediately: pool matches for BOTH restored snapshots
    pool_ms = [m for m in resumed.pool_matches if m["b"] != "anchor"]
    assert len(pool_ms) >= len(coach.pool_matches) - 3 + 2
    assert "anchored_elo" in rec

    # backward compat: a no-pool checkpoint restores with the pool empty
    import shutil

    legacy_dir = tmp_path / "legacy"
    cfg_off = dataclasses.replace(
        base,
        checkpoint_dir=str(legacy_dir),
        arena=dataclasses.replace(base.arena, pool_in_checkpoint=False),
    )
    c2 = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg_off)
    c2.learn(1)
    cfg_on = dataclasses.replace(
        base, checkpoint_dir=str(legacy_dir),
        arena=dataclasses.replace(base.arena, pool_in_checkpoint=True),
    )
    c3 = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg_on)
    assert c3.iteration == c2.iteration
    assert c3.pool == []
    assert int(c3.replay.size) == int(c2.replay.size)


def test_checkpoint_retention(tmp_path):
    """keep_checkpoints prunes all but the newest k checkpoints (sidecars
    too) and resume from the survivors is exact."""
    import dataclasses
    import os

    from alphazero_tpu.checkpoint import latest_step

    cfg = dataclasses.replace(tiny_cfg(tmp_path), keep_checkpoints=2)
    game = ConnectFour()
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    coach.learn(4)
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt_"))
    assert names == ["ckpt_000003", "ckpt_000003.json",
                     "ckpt_000004", "ckpt_000004.json"]
    assert latest_step(str(tmp_path)) == 4

    resumed = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    assert resumed.iteration == 4
    assert resumed.model_id == coach.model_id


def test_learn_sigterm_checkpoints_and_stops(tmp_path):
    """SIGTERM during learn(): the in-flight iteration finishes, the
    whole state checkpoints, the process exits cleanly, and a new Coach
    resumes from the saved iteration (preemption safety)."""
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = f"""
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import logging
logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
sys.path.insert(0, {os.path.join(repo, "tests")!r})
from test_coach import make_coach
coach = make_coach({str(tmp_path)!r})
records = coach.learn(50)
print(f"FINISHED n={{len(records)}} iter={{coach.iteration}}")
"""
    import threading

    p = subprocess.Popen(
        [sys.executable, "-u", "-c", child],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    # hard watchdog: a silently-hanging child would block the readline
    # loop forever; killing it turns a hang into a test failure
    killer = threading.Timer(240, p.kill)
    killer.start()
    try:
        saw_iter1 = False
        for line in p.stdout:
            if "iter=1 " in line or line.startswith("iter=1"):
                saw_iter1 = True
                p.send_signal(signal.SIGTERM)
                break
        assert saw_iter1, "never saw iteration 1"
        out, _ = p.communicate(timeout=240)
    finally:
        killer.cancel()
    assert p.returncode == 0, out
    assert "FINISHED" in out, out
    n_done = int(out.rsplit("FINISHED n=", 1)[1].split()[0])
    assert n_done < 50  # stopped early

    from alphazero_tpu.checkpoint import latest_step

    assert latest_step(str(tmp_path)) == n_done
    resumed = make_coach(tmp_path)
    assert resumed.iteration == n_done


def test_anchor_protocol_standardized_across_engines():
    """The anchored-rating matches must ride the exact-PUCT K=1 pure-tree
    protocol whatever engine training uses — otherwise the anchor's
    pinned-at-0 strength shifts between runs and anchored curves stop
    being comparable. With a non-standard arena engine config the coach
    must build a SEPARATE standardized rating arena."""
    import dataclasses

    game = ConnectFour()
    base = dataclasses.replace(
        tiny_cfg(None, seed=3),
        arena=ArenaConfig(num_games=4, update_threshold=0.6, num_sims=4,
                          anchor_interval=1, pool_size=2),
    )
    model = lambda: MLPNet(num_actions=game.num_actions, hidden=(16,))

    plain = Coach(game, model(), base)
    assert plain._rating_arena is plain._arena  # already standardized

    for variant in (
        dataclasses.replace(base, mcts=dataclasses.replace(
            base.mcts, transposition=True)),
    ):
        coach = Coach(game, model(), variant)
        assert coach._rating_arena is not coach._arena, variant
        rec = coach.run_iteration()  # the pass still runs end-to-end
        assert "anchored_elo" in rec


def test_pool_eviction_keeps_long_baseline():
    """With consecutive generations (continuous mode), eviction must keep
    a spread of old generations, not a sliding recency window."""
    import dataclasses

    game = ConnectFour()
    cfg = dataclasses.replace(
        tiny_cfg(None, seed=1),
        arena=ArenaConfig(num_games=8, update_threshold=0.6, num_sims=4,
                          anchor_interval=1, pool_size=5),
    )
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(16,)), cfg)
    for g in range(1, 21):
        coach._pool_insert(g, {})
    gens = [g for g, _ in coach.pool]
    assert gens[-1] == 20                       # newest always kept
    assert gens == sorted(gens)
    assert gens[0] <= 8                         # a long baseline survives
    assert gens != list(range(16, 21))          # NOT a recency window


def test_partial_restore_params_only(tmp_path):
    """The play/eval tools restore just the incumbent subtree into a
    fresh (uncommitted) template — the partial path must carry concrete
    restore shardings (regression: failed for checkpoints saved on a
    different backend)."""
    from alphazero_tpu.checkpoint import latest_step, restore_checkpoint
    from alphazero_tpu.config import TrainConfig
    from alphazero_tpu.train import TrainState, init_train_state

    coach = make_coach(tmp_path, seed=13)
    coach.learn(1)

    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    fresh = init_train_state(
        model, jax.random.key(99), game.feature_shape, TrainConfig()
    )
    step = latest_step(str(tmp_path))
    payload, _ = restore_checkpoint(
        str(tmp_path), step, {"incumbent": fresh._asdict()}, partial=True
    )
    restored = TrainState(**payload["incumbent"])
    for a, b in zip(
        jax.tree_util.tree_leaves(coach.incumbent.params),
        jax.tree_util.tree_leaves(restored.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_replay_stride_light_resume(tmp_path):
    """replay_save_stride=k: intermediate periodic checkpoints are LIGHT
    (no replay/reanalyze rings, a fraction of the bytes); resume takes
    params/counters from the newest checkpoint and the rings from the
    newest ring-bearing one."""
    import dataclasses
    import json

    cfg = dataclasses.replace(tiny_cfg(tmp_path, seed=6), replay_save_stride=2)
    game = ConnectFour()
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    coach.run_iteration()  # periodic save 1: ring-bearing (phase rule)
    replay_after_1 = replay_total(coach.replay)
    coach.run_iteration()  # periodic save 2: light
    assert json.load(open(tmp_path / "ckpt_000001.json"))["has_rings"] is True
    assert json.load(open(tmp_path / "ckpt_000002.json"))["has_rings"] is False
    # the light checkpoint really omits the ring subtree (its manifest
    # lists every saved leaf by key path)
    meta1 = (tmp_path / "ckpt_000001" / "manifest.json").read_text()
    meta2 = (tmp_path / "ckpt_000002" / "manifest.json").read_text()
    assert "replay" in meta1
    assert "replay" not in meta2
    params_after_2 = jax.tree_util.tree_leaves(coach.incumbent.params)

    resumed = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    assert resumed.iteration == 2
    assert resumed.model_id == coach.model_id
    for a, b in zip(
        params_after_2, jax.tree_util.tree_leaves(resumed.incumbent.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the rings came from step 1 — one iteration of replay regenerates
    assert replay_total(resumed.replay) == replay_after_1
    rec = resumed.run_iteration()
    assert rec["iteration"] == 3


def test_replay_stride_final_save_carries_rings(tmp_path):
    """learn() upgrades a light last periodic save to ring-bearing so the
    run's final state is always fully durable; resume is then exact."""
    import dataclasses
    import json

    cfg = dataclasses.replace(tiny_cfg(tmp_path, seed=7), replay_save_stride=2)
    game = ConnectFour()
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    coach.learn(2)  # save 1 rings, save 2 light, final re-save 2 w/ rings
    assert json.load(open(tmp_path / "ckpt_000002.json"))["has_rings"] is True

    resumed = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    assert resumed.iteration == 2
    assert replay_total(resumed.replay) == replay_total(coach.replay)


def test_replay_stride_retention_protects_ring(tmp_path):
    """Retention never prunes the newest ring-bearing checkpoint — with a
    stride it can be the only durable copy of the replay ring."""
    import dataclasses
    import os

    cfg = dataclasses.replace(
        tiny_cfg(tmp_path, seed=8), replay_save_stride=3, keep_checkpoints=1
    )
    game = ConnectFour()
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    coach.run_iteration()  # save 1: rings
    replay_after_1 = replay_total(coach.replay)
    coach.run_iteration()  # save 2: light (pruned by keep=1)
    coach.run_iteration()  # save 3: light (kept as newest)
    names = {n for n in os.listdir(tmp_path) if n.startswith("ckpt_")}
    assert "ckpt_000001" in names  # protected ring-bearing step
    assert "ckpt_000002" not in names
    assert "ckpt_000003" in names

    resumed = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    assert resumed.iteration == 3
    assert replay_total(resumed.replay) == replay_after_1


def test_light_resume_survives_missing_sidecar(tmp_path):
    """A LIGHT checkpoint whose JSON sidecar is
    lost (historically possible via a crash between the array save and
    the sidecar write; save_checkpoint now writes sidecar-first, but a
    same-step resave can still flip lightness) must not brick resume.
    With no sidecar the exact plan is attempted, fails on the absent
    replay subtree, and _maybe_resume falls back to the light/ring-split
    plan with the unreliable step excluded from ring candidates."""
    import dataclasses
    import os

    cfg = dataclasses.replace(tiny_cfg(tmp_path, seed=11), replay_save_stride=2)
    game = ConnectFour()
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    coach.run_iteration()  # save 1: ring-bearing
    replay_after_1 = replay_total(coach.replay)
    coach.run_iteration()  # save 2: light
    params_after_2 = jax.tree_util.tree_leaves(coach.incumbent.params)
    os.remove(tmp_path / "ckpt_000002.json")  # the crash window

    resumed = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    # params/counters from the light step 2; without its sidecar the
    # iteration counter falls back to the step number
    assert resumed.iteration == 2
    for a, b in zip(
        params_after_2, jax.tree_util.tree_leaves(resumed.incumbent.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # rings from step 1 (step 2 excluded as a ring candidate)
    assert replay_total(resumed.replay) == replay_after_1
    rec = resumed.run_iteration()
    assert rec["iteration"] == 3


def test_light_resume_drops_mismatched_pool(tmp_path):
    """The light restore shares the exact path's
    optional-subtree fallback — a pool template whose stacked shape
    changed (arena.pool_size edited between save and resume) drops the
    pool instead of crashing."""
    import dataclasses

    cfg = dataclasses.replace(tiny_cfg(tmp_path, seed=12), replay_save_stride=2)
    game = ConnectFour()
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    coach.run_iteration()  # ring-bearing
    coach.run_iteration()  # light
    params_after_2 = jax.tree_util.tree_leaves(coach.incumbent.params)

    cfg2 = dataclasses.replace(
        cfg, arena=dataclasses.replace(cfg.arena, pool_size=cfg.arena.pool_size + 3)
    )
    resumed = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg2)
    assert resumed.iteration == 2
    for a, b in zip(
        params_after_2, jax.tree_util.tree_leaves(resumed.incumbent.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rec = resumed.run_iteration()
    assert rec["iteration"] == 3


def test_pool_cross_matches_densify_graph():
    """ArenaConfig.pool_cross_matches: the anchored pass plays extra
    pool-vs-pool arenas (the star graph through
    the incumbent leaves the blowout anchor edge as the only gauge path,
    inflating SE). Cross edges must appear between two NON-incumbent
    generations, ride the standardized rating arena, and be absent when
    the knob is 0 (opt-in rule)."""
    import dataclasses

    from alphazero_tpu.config import ArenaConfig

    game = ConnectFour()

    def run(cross):
        model = MLPNet(num_actions=game.num_actions, hidden=(32,))
        cfg = dataclasses.replace(
            tiny_cfg(seed=9),
            arena=ArenaConfig(
                num_games=4,
                update_threshold=None,  # continuous mode: every iter snapshots
                num_sims=4,
                anchor_interval=1,
                pool_cross_matches=cross,
            ),
        )
        coach = Coach(game, model, cfg)
        for _ in range(4):
            coach.run_iteration()
        return coach

    base = run(0)
    star_edges = [
        m for m in base.pool_matches if m["b"] != "anchor"
    ]
    # star graph: every model-model edge touches the then-incumbent (the
    # larger id of the pair — pool members are older generations)
    cross_cfgd = run(2)
    ids = sorted(
        {m["a"] for m in cross_cfgd.pool_matches}
        | {m["b"] for m in cross_cfgd.pool_matches if m["b"] != "anchor"}
    )
    # an edge is CROSS if neither endpoint was the incumbent of its pass;
    # detect by counting pairs that repeat with swapped orientation or
    # that connect two ids both strictly older than the newest at the time.
    # Simplest robust check: the cross run has strictly more model-model
    # edges than the star run at identical iteration count, and at least
    # one edge exists between two ids that BOTH also appear as "a" of an
    # anchor edge earlier (i.e., both were past incumbents).
    cross_model_edges = [
        m for m in cross_cfgd.pool_matches if m["b"] != "anchor"
    ]
    assert len(cross_model_edges) > len(star_edges)
    past_incumbents = {
        m["a"] for m in cross_cfgd.pool_matches if m["b"] == "anchor"
    }
    newest = max(past_incumbents)
    assert any(
        m["a"] in past_incumbents
        and m["b"] in past_incumbents
        and m["a"] != newest
        and m["b"] != newest
        for m in cross_model_edges
    )
    # ratings + SE still fit over the densified graph
    assert base.anchored_ratings["anchor"] == 0.0
    assert cross_cfgd.anchored_ratings["anchor"] == 0.0


def test_anchor_warmup_densifies_early_gauge():
    """ArenaConfig.anchor_warmup/anchor_warmup_mult: passes also run at
    every iteration <= warmup, and warmup anchor edges carry mult x the
    games — the fix for the round-4 flagship pathology where the first
    pass (empty pool) swept the anchor 128-0 and the entire absolute
    scale rested on that zero-information edge forever."""
    import dataclasses

    from alphazero_tpu.config import ArenaConfig

    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    cfg = dataclasses.replace(
        tiny_cfg(seed=10),
        arena=ArenaConfig(
            num_games=4,
            update_threshold=None,
            num_sims=4,
            anchor_interval=3,
            anchor_warmup=2,
            anchor_warmup_mult=2,
        ),
    )
    coach = Coach(game, model, cfg)
    recs = [coach.run_iteration() for _ in range(3)]
    # passes at 1, 2 (warmup) and 3 (interval)
    assert all("anchored_elo" in r for r in recs)
    anchor_edges = [m for m in coach.pool_matches if m["b"] == "anchor"]
    games_per_edge = [
        m["wins_a"] + m["wins_b"] + m["draws"] for m in anchor_edges
    ]
    # warmup edges: 2x4 games; the interval edge: 4
    assert games_per_edge == [8, 8, 4]
    # pool edges exist from pass 2 onward (pass 1 snapshots into the pool)
    assert any(m["b"] != "anchor" for m in coach.pool_matches)


def test_recycling_coach_trains_and_resumes(tmp_path):
    """selfplay.recycle=True through the Coach: iterations run, replay
    fills, the actor carry (live boards + open-episode fragments)
    checkpoints and resumes mid-episode, and loss decreases."""
    import dataclasses

    cfg = dataclasses.replace(
        tiny_cfg(tmp_path, seed=13),
        selfplay=dataclasses.replace(
            tiny_cfg().selfplay, recycle=True
        ),
    )
    game = ConnectFour()
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    r1 = coach.run_iteration()
    r2 = coach.run_iteration()
    # every search is a real move: moves per iteration == S * B exactly
    S = game.max_moves
    assert r1["selfplay_moves"] == S * cfg.selfplay.batch_size
    assert r2["replay_total"] > r1["replay_total"]
    mc = np.asarray(coach.actor_carry.move_count)

    resumed = Coach(
        game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg
    )
    assert resumed.iteration == 2
    np.testing.assert_array_equal(
        np.asarray(resumed.actor_carry.move_count), mc
    )
    np.testing.assert_array_equal(
        np.asarray(resumed.actor_carry.frag_pi),
        np.asarray(coach.actor_carry.frag_pi),
    )
    r3 = resumed.run_iteration()
    assert r3["iteration"] == 3


def test_recycling_rejects_reanalyze():
    import dataclasses

    import pytest

    from alphazero_tpu.config import ReanalyzeConfig

    cfg = dataclasses.replace(
        tiny_cfg(seed=14),
        selfplay=dataclasses.replace(tiny_cfg().selfplay, recycle=True),
        reanalyze=ReanalyzeConfig(batch_size=4, capacity=64),
    )
    game = ConnectFour()
    with pytest.raises(ValueError):
        Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)


def test_anchor_ladder_builds_informative_gauge_chain(tmp_path):
    """ArenaConfig.anchor_ladder: fixed pure-MCTS rungs at higher budgets.
    One-time chain calibration (anchor -> rung edges, uniform-vs-uniform
    asymmetric-budget arenas) plus incumbent-vs-rung edges each pass;
    chain edges persist in the sidecar and are NOT replayed on resume."""
    import dataclasses

    from alphazero_tpu.config import ArenaConfig

    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    cfg = dataclasses.replace(
        tiny_cfg(tmp_path, seed=15),
        arena=ArenaConfig(
            num_games=4,
            update_threshold=None,
            num_sims=4,
            anchor_interval=1,
            anchor_ladder=(8, 16),
        ),
    )
    coach = Coach(game, model, cfg)
    coach.run_iteration()
    chain = [m for m in coach.pool_matches if isinstance(m["a"], str)]
    assert [(m["a"], m["b"]) for m in chain] == [
        ("anchor", "anchor@8"),
        ("anchor@8", "anchor@16"),
    ]
    rung_edges = [
        m
        for m in coach.pool_matches
        if not isinstance(m["a"], str) and str(m["b"]).startswith("anchor@")
    ]
    assert {m["b"] for m in rung_edges} == {"anchor@8", "anchor@16"}
    # rungs are rated players in the anchored fit, ordered by budget
    r = coach.anchored_ratings
    assert r["anchor"] == 0.0
    assert "anchor@8" in r and "anchor@16" in r
    n_chain = len(chain)
    coach.run_iteration()
    # chain NOT recalibrated on the second pass
    assert (
        len([m for m in coach.pool_matches if isinstance(m["a"], str)])
        == n_chain
    )

    resumed = Coach(game, model, cfg)
    assert [
        (m["a"], m["b"])
        for m in resumed.pool_matches
        if isinstance(m["a"], str)
    ] == [("anchor", "anchor@8"), ("anchor@8", "anchor@16")]
    resumed.run_iteration()  # and the third pass still doesn't recalibrate
    assert (
        len([m for m in resumed.pool_matches if isinstance(m["a"], str)])
        == n_chain
    )


def test_coach_iteration_mlp_batch_256():
    """A small but complete Coach iteration (self-play -> replay -> train
    -> arena gate) at a 256-game batch."""
    from alphazero_tpu.config import MCTSConfig as MC

    game = ConnectFour()
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    cfg = AZConfig(
        mcts=MC(num_sims=16, max_depth=24),
        selfplay=SelfPlayConfig(batch_size=256, temp_threshold=6),
        replay=ReplayConfig(capacity=1 << 14),
        train=TrainConfig(batch_size=128, steps_per_iteration=8),
        arena=ArenaConfig(num_games=64, update_threshold=0.6, num_sims=8),
        seed=0,
    )
    rec = Coach(game, model, cfg).run_iteration()
    assert np.isfinite(rec["loss_last"])
    assert rec["arena_wins"] + rec["arena_losses"] + rec["arena_draws"] <= 64
    assert rec["selfplay_moves"] > 256  # games actually played out
