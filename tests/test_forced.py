"""Forced playouts + policy-target pruning (Wu 2020 / KataGo §3.2;
MCTSConfig.forced_playouts — no reference analogue).

At the root, children with n < sqrt(k·P·Σn) are forced to be searched
(guaranteeing Dirichlet-boosted moves a minimum of exploration); the
stored policy target subtracts the forced visits back out so the
targets aren't polluted by the forcing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphazero_tpu.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.mcts.search import make_search_fn, pruned_root_counts
from alphazero_tpu.mcts.tree import PLANE_N, PLANE_P, PLANE_W, Tree
from alphazero_tpu.models import MLPNet, init_model, make_apply_fn, make_uniform_model
from alphazero_tpu.selfplay import make_selfplay_fn


G = ConnectFour()
A = G.num_actions


def _mlp():
    model = MLPNet(num_actions=A, hidden=(16,))
    variables = init_model(model, jax.random.key(3), G.feature_shape)
    return make_apply_fn(model), variables


def _root_tree(n, w, p):
    """Minimal Tree whose root (lane 0) carries the given planes
    (pruned_root_counts reads only ``stats``)."""
    C = 4
    stats = jnp.zeros((1, 4, A, C))
    stats = stats.at[0, PLANE_N, :, 0].set(jnp.asarray(n, jnp.float32))
    stats = stats.at[0, PLANE_W, :, 0].set(jnp.asarray(w, jnp.float32))
    stats = stats.at[0, PLANE_P, :, 0].set(jnp.asarray(p, jnp.float32))
    return Tree(
        stats=stats,
        node=jnp.zeros((1, 2, C)),
        state=None,
        count=jnp.ones((1,), jnp.int32),
        cursor=jnp.ones((1,), jnp.int32),
    )


class TestForcedSearch:
    def test_minimum_exploration_guarantee(self):
        """Forcing guarantees every valid root child
        n >= sqrt(k*P*sum_n) - 2. On a win-in-1 root, plain PUCT piles
        onto the winning column and starves the rest below their forced
        quota; the forced search still meets it everywhere."""
        apply_fn, variables = _mlp()
        k = 2.0
        sims = 128
        win_in_1 = G.init()
        for a in (0, 1, 0, 2, 0, 3):
            win_in_1 = G.step(win_in_1, jnp.int32(a))
        root = jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (2,) + l.shape), win_in_1
        )
        plain = jax.jit(
            make_search_fn(G, apply_fn, MCTSConfig(num_sims=sims, max_depth=24))
        )
        forced = jax.jit(
            make_search_fn(
                G, apply_fn,
                MCTSConfig(num_sims=sims, max_depth=24, forced_playouts=k),
            )
        )
        tp = plain(variables, root)
        tf = forced(variables, root)
        cf = np.asarray(tf.root_counts())
        cp = np.asarray(tp.root_counts())
        pf = np.asarray(
            jnp.where(
                tf.stats[:, PLANE_P, :, 0] <= -5e29, 0.0,
                tf.stats[:, PLANE_P, :, 0],
            )
        )
        quota = np.sqrt(k * pf * cf.sum(-1, keepdims=True))
        assert (cf >= quota - 2.0).all(), (cf, quota)
        # both searched the same total budget
        np.testing.assert_array_equal(cf.sum(-1), cp.sum(-1))
        # the guarantee is not vacuous: plain PUCT leaves at least one
        # child short of its forced quota on this skewed prior
        assert (cp < quota - 2.0).any()

    def test_off_path_is_plain_puct(self):
        apply_fn, variables = _mlp()
        root = jax.vmap(lambda _: G.init())(jnp.arange(2))
        a = make_search_fn(G, apply_fn, MCTSConfig(num_sims=32, max_depth=24))
        b = make_search_fn(
            G, apply_fn,
            MCTSConfig(num_sims=32, max_depth=24, forced_playouts=None),
        )
        np.testing.assert_array_equal(
            np.asarray(jax.jit(a)(variables, root).root_counts()),
            np.asarray(jax.jit(b)(variables, root).root_counts()),
        )


class TestPolicyTargetPruning:
    def test_pruning_properties(self):
        # child 0: most-visited (untouched). child 1: modest visits, all
        # forced-quota prunable. child 2: ONE visit (zeroed). child 3:
        # high-Q child whose PUCT beats the best's — earned, not pruned.
        n = [60.0, 6.0, 1.0, 20.0, 0.0, 0.0, 0.0]
        w = [30.0, -3.0, 0.0, 19.0, 0.0, 0.0, 0.0]
        p = [0.5, 0.2, 0.1, 0.05, 0.0, 0.0, 0.0]
        tree = _root_tree(n, w, p)
        pruned = np.asarray(pruned_root_counts(tree, 2.0, 1.0))[0]
        assert pruned[0] == 60.0                  # best child kept
        assert (pruned <= np.asarray(n)).all()    # only ever subtracts
        assert pruned[2] == 0.0                   # single playout zeroed
        assert pruned[1] < 6.0                    # forced quota removed
        # child 3: q=0.95 while best's puct ~= 0.54 -> gap<0, no pruning
        assert pruned[3] == 20.0
        assert (pruned[4:] == 0.0).all()

    def test_fully_unforced_root_unchanged(self):
        # k=0: nothing was ever forced, targets are the raw counts except
        # the <=1-playout zeroing never fires (all children > 1)
        n = [40.0, 30.0, 20.0, 10.0, 0.0, 0.0, 0.0]
        w = [20.0, 10.0, 5.0, 2.0, 0.0, 0.0, 0.0]
        p = [0.4, 0.3, 0.2, 0.1, 0.0, 0.0, 0.0]
        tree = _root_tree(n, w, p)
        pruned = np.asarray(pruned_root_counts(tree, 0.0, 1.0))[0]
        np.testing.assert_array_equal(pruned, np.asarray(n))


class TestSelfplayIntegration:
    def test_selfplay_with_forced_playouts(self):
        apply_fn, variables = _mlp()
        mcts = MCTSConfig(
            num_sims=16, max_depth=16, forced_playouts=2.0,
            dirichlet_alpha=1.0,
        )
        sp = SelfPlayConfig(batch_size=4, temp_threshold=4)
        play = jax.jit(make_selfplay_fn(G, apply_fn, mcts, sp))
        traj, stats = play(variables, jax.random.key(5))
        pi = np.asarray(traj.pi)
        valid = np.asarray(traj.valid)
        # stored (pruned) targets are distributions on every valid row
        np.testing.assert_allclose(pi[valid].sum(-1), 1.0, atol=1e-5)
        assert (pi >= 0).all()
        assert stats.done.all() or stats.num_moves.max() <= G.max_moves

    def test_incompatibilities(self):
        net = make_uniform_model(G)
        base = MCTSConfig(num_sims=8, max_depth=8, forced_playouts=2.0)
        sp = SelfPlayConfig(batch_size=2)
        for bad_mcts, bad_sp in (
            (dataclasses.replace(base, gumbel=True), sp),
            (dataclasses.replace(base, tree_reuse=True), sp),
            (dataclasses.replace(base, transposition=True), sp),
            (base, dataclasses.replace(sp, full_search_prob=0.5, cheap_sims=2)),
        ):
            with pytest.raises(ValueError):
                make_selfplay_fn(G, net.apply_fn, bad_mcts, bad_sp)

    def test_coach_iteration_with_forced(self, tmp_path):
        from alphazero_tpu.coach import Coach
        from alphazero_tpu.config import (
            ArenaConfig, AZConfig, ReplayConfig, TrainConfig,
        )

        cfg = AZConfig(
            mcts=MCTSConfig(
                num_sims=8, max_depth=16, forced_playouts=2.0,
                dirichlet_alpha=1.0,
            ),
            selfplay=SelfPlayConfig(batch_size=4, temp_threshold=6),
            replay=ReplayConfig(capacity=2048),
            train=TrainConfig(batch_size=32, steps_per_iteration=4),
            arena=ArenaConfig(num_games=4, update_threshold=0.6, num_sims=4),
            seed=2,
            checkpoint_dir=str(tmp_path),
        )
        coach = Coach(G, MLPNet(num_actions=A, hidden=(32,)), cfg)
        rec = coach.run_iteration()
        assert rec["replay_size"] > 0
