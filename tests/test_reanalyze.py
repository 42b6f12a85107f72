"""Reanalyze: replay-target refresh by re-search (reanalyze.py).

No reference analogue (the reference trains each sample with the policy
recorded when it was played, src/coach.rs:130-155); this is the
MuZero-Reanalyze idea specialized to terminal-outcome training — policy
targets are refreshed by re-searching stored positions with the current
net, value targets stay the ground-truth game outcome.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from alphazero_tpu.config import (
    ArenaConfig,
    AZConfig,
    MCTSConfig,
    ReanalyzeConfig,
    ReplayConfig,
    SelfPlayConfig,
    TrainConfig,
)
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.models import MLPNet, make_uniform_model
from alphazero_tpu.reanalyze import (
    PositionStore,
    make_reanalyze_fn,
    position_init,
    position_insert,
)
from alphazero_tpu.selfplay import make_selfplay_fn


G = ConnectFour()


def _played(moves):
    s = G.init()
    for a in moves:
        s = G.step(s, jnp.int32(a))
    return s


def _stack(states):
    return jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *states)


class TestPositionStore:
    def test_insert_ring_semantics(self):
        store = position_init(G, capacity=8)
        # [T=2, B=3] layout with one invalid row
        states = jax.tree_util.tree_map(
            lambda l: l.reshape((2, 3) + l.shape[1:]),
            jax.vmap(lambda i: G.init())(jnp.arange(6)),
        )
        value = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
        valid = jnp.array([[1, 1, 1], [1, 0, 1]], bool)
        store = position_insert(store, states, value, valid)
        assert int(store.size) == 5
        assert int(store.pos) == 5
        # values compacted in (t, b) order, invalid row dropped
        np.testing.assert_array_equal(
            np.asarray(store.value[:5]), [0, 1, 2, 3, 5]
        )
        # overflow wraps FIFO
        store = position_insert(store, states, value + 10, valid)
        assert int(store.size) == 8
        assert int(store.pos) == 2
        np.testing.assert_array_equal(
            np.asarray(store.value[:3]), [13, 15, 2]
        )

    def test_record_stride_subsamples(self):
        """stride=k keeps every k-th valid sample (deterministic, no rng)
        and stamps the insert iteration — the capacity-stretching lever
        for production scale where one iteration can overfill the ring."""
        store = position_init(G, capacity=8)
        states = jax.tree_util.tree_map(
            lambda l: l.reshape((2, 3) + l.shape[1:]),
            jax.vmap(lambda i: G.init())(jnp.arange(6)),
        )
        value = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
        valid = jnp.ones((2, 3), bool)
        store = position_insert(store, states, value, valid, 3, stride=2)
        # valid ranks 0..5; ranks 0, 2, 4 kept
        assert int(store.size) == 3 and int(store.pos) == 3
        np.testing.assert_array_equal(np.asarray(store.value[:3]), [0, 2, 4])
        np.testing.assert_array_equal(np.asarray(store.born[:3]), [3, 3, 3])
        # stride interacts with the valid mask: ranks are among VALIDS
        store2 = position_init(G, capacity=8)
        valid2 = jnp.array([[0, 1, 1], [1, 1, 1]], bool)  # valids: 1,2,3,4,5
        store2 = position_insert(store2, states, value, valid2, 0, stride=2)
        np.testing.assert_array_equal(np.asarray(store2.value[:3]), [1, 3, 5])

    def test_empty_store_rows_masked(self):
        net = make_uniform_model(G)
        rz = make_reanalyze_fn(
            G, net.apply_fn, MCTSConfig(num_sims=4, max_depth=8),
            ReanalyzeConfig(batch_size=4, capacity=8),
        )
        traj, num, age = rz({}, position_init(G, 8), jax.random.key(0))
        assert int(num) == 0
        assert not bool(traj.valid.any())
        assert float(age) == 0.0

    def test_age_metric(self):
        """age_mean reports how stale the refreshed targets are, in coach
        iterations (a value pinned near
        0 means the ring wraps within an iteration)."""
        net = make_uniform_model(G)
        rz = make_reanalyze_fn(
            G, net.apply_fn, MCTSConfig(num_sims=4, max_depth=8),
            ReanalyzeConfig(batch_size=8, capacity=4),
        )
        store = position_init(G, 4)
        states = jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (1, 4) + l.shape), G.init()
        )
        store = position_insert(
            store, states, jnp.ones((1, 4)), jnp.ones((1, 4), bool), 1
        )
        _, num, age = rz({}, store, jax.random.key(0), 4)
        assert int(num) == 8
        assert float(age) == 3.0  # inserted at iter 1, refreshed at iter 4


class TestReanalyzeSearch:
    def test_tactical_refresh(self):
        """Re-searched targets find the forced win the stored (stale,
        uniform-net) policy would miss: win-in-1 positions get their pi
        mass moved onto the winning column."""
        net = make_uniform_model(G)
        rz = make_reanalyze_fn(
            G, net.apply_fn, MCTSConfig(num_sims=64, max_depth=12),
            ReanalyzeConfig(batch_size=4, capacity=8),
        )
        # player to move completes column 0 (three own stones there)
        win_in_1 = _played([0, 1, 0, 2, 0, 3])
        states = jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (1, 4) + l.shape), win_in_1
        )
        store = position_init(G, 8)
        store = position_insert(
            store, states, jnp.ones((1, 4)), jnp.ones((1, 4), bool)
        )
        traj, num, _ = rz({}, store, jax.random.key(1))
        assert int(num) == 4
        pi = np.asarray(traj.pi[0])
        assert (pi.argmax(-1) == 0).all()
        assert (pi[:, 0] > 0.5).all()
        # value target passes through from the store, not the search
        np.testing.assert_allclose(np.asarray(traj.value[0]), 1.0)
        # features rebuilt from the stored state
        np.testing.assert_allclose(
            np.asarray(traj.features[0, 0]), np.asarray(G.to_features(win_in_1))
        )


class TestRecordStates:
    def test_states_match_features_and_streams_unchanged(self):
        net = make_uniform_model(G)
        mcts = MCTSConfig(num_sims=8, max_depth=12)
        sp = SelfPlayConfig(batch_size=4, temp_threshold=4)
        key = jax.random.key(7)
        base = jax.jit(make_selfplay_fn(G, net.apply_fn, mcts, sp))
        rec = jax.jit(
            make_selfplay_fn(G, net.apply_fn, mcts, sp, record_states=True)
        )
        traj0, stats0 = base({}, key)
        traj1, stats1, states = rec({}, key)
        # rng streams / trajectory bit-identical with recording on
        for a, b in zip(traj0, traj1):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(
            np.asarray(stats0.num_moves), np.asarray(stats1.num_moves)
        )
        # each recorded state IS the position the sample was taken from
        feat_v = jax.vmap(jax.vmap(G.to_features))
        np.testing.assert_allclose(
            np.asarray(feat_v(states)), np.asarray(traj1.features)
        )


def tiny_rz_cfg(tmp=None, rz=True, seed=0):
    return AZConfig(
        mcts=MCTSConfig(num_sims=8, max_depth=16),
        selfplay=SelfPlayConfig(batch_size=4, temp_threshold=6),
        replay=ReplayConfig(capacity=2048),
        train=TrainConfig(batch_size=32, steps_per_iteration=4),
        arena=ArenaConfig(num_games=4, update_threshold=0.6, num_sims=4),
        reanalyze=ReanalyzeConfig(batch_size=8, interval=2, capacity=1024)
        if rz
        else None,
        num_iterations=2,
        seed=seed,
        checkpoint_dir=str(tmp) if tmp else None,
    )


class TestCoachIntegration:
    def test_coach_reanalyze_phase(self, tmp_path):
        from alphazero_tpu.coach import Coach
        from alphazero_tpu.replay import replay_total

        cfg = tiny_rz_cfg(tmp_path)
        coach = Coach(G, MLPNet(num_actions=G.num_actions, hidden=(32,)), cfg)
        recs = coach.learn(4)
        # interval=2: passes at iterations 2 and 4 only
        assert ["reanalyzed" in r for r in recs] == [False, True, False, True]
        assert all(r["reanalyzed"] == 8 for r in recs if "reanalyzed" in r)
        assert all("t_reanalyze" in r for r in recs if "reanalyzed" in r)
        # the position ring holds every valid (pre-symmetry) sample
        n_positions = int(coach.positions.size)
        assert n_positions > 0
        # replay got self-play inserts (x num_symmetries) + reanalyze
        # inserts (x num_symmetries)
        assert replay_total(coach.replay) == (
            n_positions * G.num_symmetries + 2 * 8 * G.num_symmetries
        )

        # exact resume: the position ring is part of the checkpoint
        resumed = Coach(
            G, MLPNet(num_actions=G.num_actions, hidden=(32,)), cfg
        )
        assert int(resumed.positions.size) == n_positions
        np.testing.assert_array_equal(
            np.asarray(resumed.positions.value), np.asarray(coach.positions.value)
        )
        rec = resumed.run_iteration()
        assert rec["iteration"] == 5

    def test_mesh_reanalyze_matches_unsharded(self):
        """Reanalyze under the 8-device mesh (position ring sharded on
        `data`, reanalyze searches per-shard) value-matches single-device."""
        from alphazero_tpu.coach import Coach
        from alphazero_tpu.parallel import make_mesh
        from alphazero_tpu.replay import replay_total

        cfg = dataclasses.replace(
            tiny_rz_cfg(),
            selfplay=SelfPlayConfig(batch_size=16, temp_threshold=6),
            reanalyze=ReanalyzeConfig(batch_size=16, interval=1, capacity=1024),
            seed=11,
        )
        out = {}
        for mesh in (None, make_mesh()):
            coach = Coach(
                G, MLPNet(num_actions=G.num_actions, hidden=(32,)), cfg,
                mesh=mesh,
            )
            recs = coach.learn(2)
            out["mesh" if mesh else "single"] = (
                recs,
                int(coach.positions.size),
                replay_total(coach.replay),
                np.asarray(coach.positions.value),
            )
        (ra, pa, ta, va), (rb, pb, tb, vb) = out["single"], out["mesh"]
        assert pa == pb and ta == tb
        np.testing.assert_array_equal(va, vb)
        for a, b in zip(ra, rb):
            assert a["reanalyzed"] == b["reanalyzed"] == 16
            assert a["replay_size"] == b["replay_size"]

    def test_resume_from_pre_reanalyze_checkpoint(self, tmp_path):
        """A checkpoint saved WITHOUT reanalyze restores into a coach that
        has it enabled: everything else resumes, the ring starts empty."""
        from alphazero_tpu.coach import Coach

        cfg_off = tiny_rz_cfg(tmp_path, rz=False)
        coach = Coach(G, MLPNet(num_actions=G.num_actions, hidden=(32,)), cfg_off)
        coach.learn(1)
        it = coach.iteration

        cfg_on = tiny_rz_cfg(tmp_path)
        resumed = Coach(G, MLPNet(num_actions=G.num_actions, hidden=(32,)), cfg_on)
        assert resumed.iteration == it
        assert int(resumed.replay.size) == int(coach.replay.size)
        assert int(resumed.positions.size) == 0
        rec = resumed.run_iteration()
        assert rec["iteration"] == it + 1
