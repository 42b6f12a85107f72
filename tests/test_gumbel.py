"""Gumbel sequential-halving engine tests (mcts/gumbel.py).

No reference analogue (the engine implements Danihelka et al. 2022, an
extension beyond the reference's PUCT); coverage mirrors the other
engines': schedule correctness, tree invariants, tactical behavior, a
numpy re-derivation cross-check of the dense scoring pass, and
integration through selfplay and the arena.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphazero_tpu.arena import make_arena_fn
from alphazero_tpu.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.mcts.gumbel import (
    considered_visit_sequence,
    considered_visit_table,
    make_gumbel_search_fn,
)
from alphazero_tpu.models import make_uniform_model
from alphazero_tpu.selfplay import make_selfplay_fn

G = ConnectFour()
NET = make_uniform_model(G)


def batched_state(move_lists):
    states = []
    for moves in move_lists:
        s = G.init()
        for m in moves:
            s = G.step(s, jnp.int32(m))
        states.append(s)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def gsearch(move_lists, num_sims=32, rng=0, **kw):
    cfg = MCTSConfig(num_sims=num_sims, gumbel=True, **kw)
    fn = jax.jit(make_gumbel_search_fn(G, NET.apply_fn, cfg))
    root = batched_state(move_lists)
    key = None if rng is None else jax.random.PRNGKey(rng)
    return fn({}, root, key)


# ---- schedule ------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(2, 16), (4, 16), (7, 100), (16, 32), (16, 7)])
def test_schedule_replayable(m, n):
    """The runtime consumes the schedule as 'some action must currently
    hold exactly seq[i] visits'; replaying it greedily must never get
    stuck, and must spend exactly the budget."""
    seq = considered_visit_sequence(m, n)
    assert len(seq) == n
    visits = [0] * m
    for v in seq:
        candidates = [j for j in range(m) if visits[j] == v]
        assert candidates, f"no action due at entry {v}"
        visits[candidates[0]] += 1
    assert sum(visits) == n


def test_schedule_halving_shape():
    """With m=4, n=16: phase 1 gives each of 4 actions n/(2*4)=2 visits,
    phase 2 gives the surviving 2 actions 4 more each."""
    seq = considered_visit_sequence(4, 16)
    assert seq[:8] == [0, 0, 0, 0, 1, 1, 1, 1]
    # halved: two survivors alternate from count 2 upward
    assert seq[8:] == [2, 2, 3, 3, 4, 4, 5, 5]


def test_schedule_table_rows():
    t = considered_visit_table(8, 20)
    assert t.shape == (9, 20)
    assert list(t[0]) == list(range(20))
    assert list(t[1]) == list(range(20))


# ---- search behavior ------------------------------------------------------


def test_root_visits_sum_to_sims():
    res = gsearch([[], [3], [0, 1, 0]], num_sims=24)
    counts = np.asarray(res.tree.root_counts())
    np.testing.assert_array_equal(counts.sum(-1), [24, 24, 24])


def test_top_m_1_funnels_all_visits():
    res = gsearch([[]], num_sims=16, gumbel_top_m=1)
    counts = np.asarray(res.tree.root_counts())[0]
    assert counts.max() == 16
    assert (counts > 0).sum() == 1
    assert int(np.asarray(res.action)[0]) == int(counts.argmax())


def test_equalized_phase_one_visits():
    """Early visits spread across considered actions per the schedule:
    with 7 legal moves and the uniform prior, after the full budget every
    visited count must be reachable from the m=7 schedule multiset."""
    res = gsearch([[]], num_sims=28, gumbel_top_m=16)
    counts = np.asarray(res.tree.root_counts())[0]
    assert counts.sum() == 28
    # schedule row m=7: replay gives the exact visit multiset
    seq = considered_visit_sequence(7, 28)
    visits = [0] * 7
    for v in seq:
        visits[[j for j in range(7) if visits[j] == v][0]] += 1
    assert sorted(counts.tolist()) == sorted(visits)


def test_improved_pi_is_masked_distribution():
    # a column-0-full position: action 0 illegal
    moves = [0, 0, 0, 0, 0, 0]
    res = gsearch([moves, []], num_sims=16)
    pi = np.asarray(res.improved_pi)
    np.testing.assert_allclose(pi.sum(-1), 1.0, rtol=1e-5)
    assert pi[0, 0] == 0.0
    assert np.all(pi >= 0)


def test_finds_immediate_win_eval_mode():
    # player to move has three in column 0 -> playing 0 wins now
    moves = [0, 1, 0, 1, 0, 1]
    res = gsearch([moves], num_sims=16, rng=None)
    assert int(np.asarray(res.action)[0]) == 0
    # and the improved policy concentrates there
    pi = np.asarray(res.improved_pi)[0]
    assert pi.argmax() == 0


def test_finds_immediate_win_with_noise():
    moves = [0, 1, 0, 1, 0, 1]
    wins = 0
    for seed in range(5):
        res = gsearch([moves], num_sims=32, rng=seed)
        wins += int(np.asarray(res.action)[0] == 0)
    assert wins >= 4  # gumbel noise may very rarely out-vote a +1 sigma gap


def test_eval_mode_deterministic():
    a1 = np.asarray(gsearch([[], [3]], num_sims=16, rng=None).action)
    a2 = np.asarray(gsearch([[], [3]], num_sims=16, rng=None).action)
    np.testing.assert_array_equal(a1, a2)


def test_seeded_reproducible():
    r1 = gsearch([[], [3, 3]], num_sims=16, rng=7)
    r2 = gsearch([[], [3, 3]], num_sims=16, rng=7)
    np.testing.assert_array_equal(np.asarray(r1.action), np.asarray(r2.action))
    np.testing.assert_allclose(
        np.asarray(r1.improved_pi), np.asarray(r2.improved_pi)
    )


# ---- dense scoring cross-check against a per-node numpy re-derivation -----


def test_completed_scores_numpy_crosscheck():
    cfg = MCTSConfig(num_sims=20, gumbel=True)
    fn = make_gumbel_search_fn(G, NET.apply_fn, cfg)
    root = batched_state([[], [3, 3]])
    res = jax.jit(fn)({}, root, jax.random.PRNGKey(1))
    tree, vraw = res.tree, np.asarray(res.vraw)

    N = np.asarray(tree.N).astype(np.float64)      # [B, C, A]
    W = np.asarray(tree.W).astype(np.float64)
    P = np.asarray(tree.P).astype(np.float64)
    legal = np.asarray(tree.valid)
    B, C, A = N.shape

    c_visit, c_scale = 50.0, 0.1
    pi_expected = np.zeros((B, C, A))
    score_expected = np.full((B, C, A), -1e30)
    for b in range(B):
        for c in range(C):
            n, w, p, lg = N[b, c], W[b, c], P[b, c], legal[b, c]
            q = w / np.maximum(n, 1.0)
            vis = n > 0.5
            sum_n = n.sum()
            sum_pv = (p * vis).sum()
            wq = (p * vis * q).sum() / max(sum_pv, 1e-8)
            v_mix = (vraw[b, c] + sum_n * wq) / (sum_n + 1.0)
            cq = np.where(vis, q, v_mix)
            cq = (cq - cq.min()) / max(cq.max() - cq.min(), 1e-8)
            sigma = (c_visit + n.max()) * c_scale * cq
            logits = np.where(lg, np.log(np.maximum(p, 1e-30)), -1e30)
            z = np.where(lg, logits + sigma, -1e30)
            e = np.where(lg, np.exp(z - z.max()), 0.0)
            pi = e / max(e.sum(), 1e-30)
            pi_expected[b, c] = pi
            score_expected[b, c] = np.where(
                lg, pi - n / (1.0 + sum_n), -1e30
            )

    score, _, _, _, _, pi_imp = fn._completed_scores(tree, jnp.asarray(vraw))
    got_score = np.transpose(np.asarray(score), (0, 2, 1))
    got_pi = np.transpose(np.asarray(pi_imp), (0, 2, 1))
    np.testing.assert_allclose(got_pi, pi_expected, atol=1e-4)
    ok = score_expected > -1e29
    np.testing.assert_allclose(got_score[ok], score_expected[ok], atol=1e-4)
    assert np.all(got_score[~ok] <= -1e29)


# ---- integration -----------------------------------------------------------


def test_selfplay_gumbel_integration():
    cfg = MCTSConfig(num_sims=12, gumbel=True)
    sp = SelfPlayConfig(batch_size=8, temp_threshold=5)
    play = jax.jit(make_selfplay_fn(G, NET.apply_fn, cfg, sp))
    traj, stats = play({}, jax.random.PRNGKey(0))
    assert bool(np.asarray(stats.done).all())
    pi = np.asarray(traj.pi)
    valid = np.asarray(traj.valid)
    np.testing.assert_allclose(pi[valid].sum(-1), 1.0, rtol=1e-4)
    # outcomes are decisive or exact draws
    out = np.asarray(stats.outcome)
    assert np.all(np.isin(out, [-1.0, 0.0, 1.0]))


def test_arena_gumbel_integration():
    cfg = MCTSConfig(num_sims=8, gumbel=True)
    play = jax.jit(
        make_arena_fn(G, NET.apply_fn, NET.apply_fn, cfg, num_games=8)
    )
    res = play({}, {}, jax.random.PRNGKey(0))
    total = int(res.cand_wins) + int(res.inc_wins) + int(res.draws)
    assert total == 8
    assert int(res.unfinished) == 0


def test_mutual_exclusions():
    with pytest.raises(ValueError):
        make_gumbel_search_fn(
            G, NET.apply_fn, MCTSConfig(gumbel=True, dirichlet_alpha=0.3)
        )
    with pytest.raises(ValueError):
        make_selfplay_fn(
            G,
            NET.apply_fn,
            MCTSConfig(gumbel=True, tree_reuse=True),
            SelfPlayConfig(batch_size=2),
        )
    with pytest.raises(ValueError):
        make_selfplay_fn(
            G,
            NET.apply_fn,
            MCTSConfig(gumbel=True, transposition=True),
            SelfPlayConfig(batch_size=2),
        )


def test_coach_gumbel_with_anchored_rating():
    """The anchored-rating pass must run (and stay on the standardized
    PUCT protocol) when training uses the gumbel engine."""
    from alphazero_tpu.coach import Coach
    from alphazero_tpu.config import (
        ArenaConfig,
        AZConfig,
        ReplayConfig,
        TrainConfig,
    )
    from alphazero_tpu.models import MLPNet

    cfg = AZConfig(
        mcts=MCTSConfig(num_sims=8, gumbel=True),
        selfplay=SelfPlayConfig(batch_size=8, temp_threshold=5),
        replay=ReplayConfig(capacity=2048),
        train=TrainConfig(batch_size=16, steps_per_iteration=4),
        arena=ArenaConfig(num_games=4, anchor_interval=1),
        num_iterations=1,
    )
    coach = Coach(G, MLPNet(num_actions=G.num_actions, hidden=(16,)), cfg)
    # the rating arenas are pinned to PUCT even though training is gumbel
    assert coach._rating_arena is not coach._arena
    (rec,) = coach.learn()
    assert "anchor_win_rate" in rec and "anchored_elo" in rec
