"""Self-play episode generation tests (coverage the reference lacked for
Coach::execute_episode, coach.rs:104-157)."""

import jax
import jax.numpy as jnp
import numpy as np

from alphazero_tpu.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.models import make_uniform_model
from alphazero_tpu.selfplay import make_actor_step_fn, make_selfplay_fn

G = ConnectFour()
NET = make_uniform_model(G)


def run_selfplay(B=8, sims=25, seed=0, temp_threshold=15):
    fn = jax.jit(
        make_selfplay_fn(
            G,
            NET.apply_fn,
            MCTSConfig(num_sims=sims, max_depth=48),
            SelfPlayConfig(batch_size=B, temp_threshold=temp_threshold),
        )
    )
    return fn({}, jax.random.key(seed))


def test_selfplay_shapes_and_termination():
    traj, stats = run_selfplay(B=8)
    T, B = 42, 8
    assert traj.features.shape == (T, B, 6, 7, 2)
    assert traj.pi.shape == (T, B, 7)
    assert traj.value.shape == (T, B)
    assert traj.valid.shape == (T, B)
    assert bool(np.asarray(stats.done).all())
    moves = np.asarray(stats.num_moves)
    assert np.all((moves >= 7) & (moves <= 42))
    # valid mask matches move counts exactly
    valid = np.asarray(traj.valid)
    np.testing.assert_array_equal(valid.sum(0), moves)


def test_value_targets_alternate_and_respect_outcome():
    traj, stats = run_selfplay(B=16, seed=3)
    value = np.asarray(traj.value)
    valid = np.asarray(traj.valid)
    moves = np.asarray(stats.num_moves)
    outcome = np.asarray(stats.outcome)
    for b in range(16):
        m = moves[b]
        if outcome[b] == 0.0:
            assert np.all(value[:, b] == 0.0)
            continue
        # the last mover won (outcome -1 from final to-move perspective)
        assert outcome[b] == -1.0
        assert value[m - 1, b] == 1.0  # winner's final sample
        if m >= 2:
            assert value[m - 2, b] == -1.0  # loser's final sample
        # strict alternation along the whole episode
        signs = value[:m, b]
        assert np.all(signs[:-1] == -signs[1:])
        # masked tail is zero
        assert np.all(value[m:, b] == 0.0)
        assert not valid[m:, b].any()


def test_policy_targets_are_distributions():
    traj, stats = run_selfplay(B=8, seed=1)
    pi = np.asarray(traj.pi)
    valid = np.asarray(traj.valid)
    sums = pi.sum(-1)[valid]
    np.testing.assert_allclose(sums, 1.0, atol=1e-5)


def test_selfplay_deterministic():
    t1, s1 = run_selfplay(B=4, seed=7)
    t2, s2 = run_selfplay(B=4, seed=7)
    np.testing.assert_array_equal(np.asarray(t1.pi), np.asarray(t2.pi))
    np.testing.assert_array_equal(
        np.asarray(s1.num_moves), np.asarray(s2.num_moves)
    )


def test_selfplay_seed_sensitivity():
    t1, s1 = run_selfplay(B=8, seed=0)
    t2, s2 = run_selfplay(B=8, seed=1)
    assert not np.array_equal(np.asarray(s1.num_moves), np.asarray(s2.num_moves)) or (
        not np.array_equal(np.asarray(t1.pi), np.asarray(t2.pi))
    )


def test_actor_step_recycles():
    B = 8
    init_carry, actor_step = make_actor_step_fn(
        G, NET.apply_fn, MCTSConfig(num_sims=15, max_depth=48), B, temp_threshold=15
    )
    step = jax.jit(actor_step)
    carry = init_carry()
    key = jax.random.key(0)
    total_height = []
    for i in range(60):
        key, sub = jax.random.split(key)
        carry, pi = step({}, carry, sub)
        state, move_count = carry
        heights = np.abs(np.asarray(state.board)).sum((1, 2))
        mc = np.asarray(move_count)
        # invariant: piece count equals move count (fresh games recycled to 0)
        np.testing.assert_array_equal(heights, mc)
        total_height.append(mc.copy())
    stacked = np.stack(total_height)
    # at least one game recycled within 60 plies
    assert (stacked[1:] < stacked[:-1]).any()


class TestRecyclingSelfplay:
    """make_recycling_selfplay_fn: every search
    is a real env step; value targets resolve exactly, one call late at
    worst, via the fragment carry."""

    def _build(self, B=8, sims=8, temp_threshold=6):
        from alphazero_tpu.selfplay import make_recycling_selfplay_fn

        mcfg = MCTSConfig(num_sims=sims, max_depth=16)
        spcfg = SelfPlayConfig(batch_size=B, temp_threshold=temp_threshold)
        init_carry, rec = make_recycling_selfplay_fn(
            G, NET.apply_fn, mcfg, spcfg
        )
        return mcfg, spcfg, init_carry, jax.jit(rec)

    def test_first_episode_bit_identical_to_fixed_scan(self):
        """Same seed, same rng discipline: each game's FIRST episode —
        features, pi targets AND walk-back values — must match
        make_selfplay_fn exactly (the bit-correctness requirement)."""
        mcfg, spcfg, init_carry, rec = self._build()
        fixed = jax.jit(make_selfplay_fn(G, NET.apply_fn, mcfg, spcfg))
        key = jax.random.key(7)
        traj_f, stats_f = fixed({}, key)
        _, traj_r, _ = rec({}, init_carry(), key)
        M = G.max_moves
        mf = np.asarray(stats_f.num_moves)
        done_f = np.asarray(stats_f.done)
        for b in range(mf.shape[0]):
            n = int(mf[b])
            np.testing.assert_array_equal(
                np.asarray(traj_f.features)[:n, b],
                np.asarray(traj_r.features)[M : M + n, b],
            )
            np.testing.assert_array_equal(
                np.asarray(traj_f.pi)[:n, b],
                np.asarray(traj_r.pi)[M : M + n, b],
            )
            if done_f[b]:
                np.testing.assert_array_equal(
                    np.asarray(traj_f.value)[:n, b],
                    np.asarray(traj_r.value)[M : M + n, b],
                )

    def test_sample_conservation_across_calls(self):
        """Exact accounting: over k calls every move lands in exactly one
        episode, closed episodes' samples are emitted valid exactly once
        (in-call or as the next call's fragment), and the only samples
        still outstanding are the final open episodes — so
        sum(valid) == k*S*B - sum(final move_count). Connect-four cannot
        truncate (move 42 fills the board), so the identity is exact."""
        B = 8
        mcfg, spcfg, init_carry, rec = self._build(B=B)
        S = G.max_moves  # default recycle_steps
        carry = init_carry()
        total_valid = 0
        k = 4
        for i in range(k):
            carry, traj, stats = rec({}, carry, jax.random.key(100 + i))
            total_valid += int(np.asarray(traj.valid).sum())
            assert np.asarray(stats.num_moves).sum() == S * B
        assert total_valid == k * S * B - int(
            np.asarray(carry.move_count).sum()
        )

    def test_values_alternate_within_fragments(self):
        """Fragment rows are one episode's prefix: consecutive valid rows
        must alternate sign (negamax) unless the outcome was a draw."""
        mcfg, spcfg, init_carry, rec = self._build()
        carry = init_carry()
        carry, _, _ = rec({}, carry, jax.random.key(1))
        _, traj, _ = rec({}, carry, jax.random.key(2))
        M = G.max_moves
        val = np.asarray(traj.value)[:M]
        ok = np.asarray(traj.valid)[:M]
        assert ok.sum() > 0  # fragments actually resolved
        for b in range(ok.shape[1]):
            rows = np.nonzero(ok[:, b])[0]
            for j0, j1 in zip(rows, rows[1:]):
                if j1 == j0 + 1 and val[j1, b] != 0.0:
                    assert val[j0, b] == -val[j1, b]

    def test_search_waste_recovered(self):
        """The point of the feature: valid samples per search ~1 in
        steady state vs the fixed scan's mean_moves/max_moves (~0.8)."""
        B = 8
        mcfg, spcfg, init_carry, rec = self._build(B=B)
        fixed = jax.jit(make_selfplay_fn(G, NET.apply_fn, mcfg, spcfg))
        traj_f, _ = fixed({}, jax.random.key(5))
        fixed_yield = np.asarray(traj_f.valid).sum() / (G.max_moves * B)
        carry = init_carry()
        tot = 0
        for i in range(3):
            carry, traj, _ = rec({}, carry, jax.random.key(40 + i))
            tot += int(np.asarray(traj.valid).sum())
        rec_yield = tot / (3 * G.max_moves * B)
        assert rec_yield > fixed_yield + 0.05, (rec_yield, fixed_yield)

    def test_incompatible_flags_raise(self):
        import pytest

        from alphazero_tpu.selfplay import make_recycling_selfplay_fn

        spcfg = SelfPlayConfig(batch_size=4, temp_threshold=6)
        with pytest.raises(ValueError):
            make_recycling_selfplay_fn(
                G, NET.apply_fn,
                MCTSConfig(num_sims=8, max_depth=16, tree_reuse=True), spcfg,
            )
        with pytest.raises(ValueError):
            make_recycling_selfplay_fn(
                G, NET.apply_fn,
                MCTSConfig(num_sims=8, max_depth=16, forced_playouts=2.0,
                           dirichlet_alpha=1.0),
                spcfg,
            )
        import dataclasses

        with pytest.raises(ValueError):
            make_recycling_selfplay_fn(
                G, NET.apply_fn, MCTSConfig(num_sims=8, max_depth=16),
                dataclasses.replace(
                    spcfg, full_search_prob=0.25, cheap_sims=2
                ),
            )
