"""Transposition-DAG engine (mcts/tt.py) — the reference's `seen` dedup.

The reference's NodeStore keys every state in a concurrent map and
redirects duplicate expansions to the canonical node (node.rs:135,
272-326; async_mcts.rs:293-299 continue-through-canonical). The opt-in
on-device engine must be bit-identical to the sequential C++ DAG oracle
(csrc/tt_oracle.cpp, use_tt=1) — the same oracle whose tree mode
reproduces the golden edge-stats oracle, closing the chain:

    mcts_oracle == tt_oracle(use_tt=0) == search.py
    tt_oracle(use_tt=1) == mcts/tt.py          (this file)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphazero_tpu import native
from alphazero_tpu.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu.games import ConnectFour, Othello
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.mcts.tt import make_tt_search_fn
from alphazero_tpu.models import (
    MLPNet,
    init_model,
    make_apply_fn,
    make_uniform_model,
)
from alphazero_tpu.selfplay import make_selfplay_fn

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _random_position(game, nmoves, rng):
    s = game.init()
    for _ in range(nmoves):
        v = np.asarray(game.valid_moves(s))
        a = int(rng.choice(np.nonzero(v)[0]))
        nxt = game.step(s, jnp.asarray(a))
        done, _ = game.terminal(nxt)
        if bool(done):
            return s
        s = nxt
    return s


def _stack(positions):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *positions)


class TestOracleParity:
    """Bit-exact root counts AND dedup-hit counts vs csrc/tt_oracle.cpp."""

    def test_connect_four_positions_sims_cpuct(self):
        game = ConnectFour()
        model = make_uniform_model(game)
        rng = np.random.default_rng(7)
        for cpuct in (0.7, 1.0, 2.5):
            for sims in (50, 400):
                cfg = MCTSConfig(
                    num_sims=sims, max_depth=48, cpuct=cpuct, transposition=True
                )
                search = jax.jit(make_tt_search_fn(game, model.apply_fn, cfg))
                poss = [_random_position(game, k, rng) for k in (0, 3, 6, 9)]
                tree = search({}, _stack(poss))
                counts = np.asarray(tree.root_counts())
                dedup = np.asarray(tree.dedup)
                for b, s in enumerate(poss):
                    oc, hits = native.tt_oracle_search(
                        "connect_four", np.asarray(s.board), sims, cpuct, 48,
                        use_tt=True,
                    )
                    np.testing.assert_array_equal(
                        counts[b], oc, err_msg=f"cpuct={cpuct} sims={sims} b={b}"
                    )
                    assert int(dedup[b]) == hits

    def test_connect_four_dedup_actually_fires_at_depth(self):
        game = ConnectFour()
        model = make_uniform_model(game)
        cfg = MCTSConfig(num_sims=400, max_depth=48, transposition=True)
        search = jax.jit(make_tt_search_fn(game, model.apply_fn, cfg))
        root = jax.vmap(lambda _: game.init())(jnp.arange(1))
        tree = search({}, root)
        assert int(tree.dedup[0]) > 0
        # budget conserved through redirects: every sim passes through
        # exactly one root child
        assert float(np.asarray(tree.root_counts()).sum()) == 400.0

    def test_othello_positions(self):
        game = Othello()
        model = make_uniform_model(game)
        rng = np.random.default_rng(3)
        cfg = MCTSConfig(num_sims=200, max_depth=64, transposition=True)
        search = jax.jit(make_tt_search_fn(game, model.apply_fn, cfg))
        poss = [_random_position(game, k, rng) for k in (0, 4, 10)]
        tree = search({}, _stack(poss))
        counts = np.asarray(tree.root_counts())
        for b, s in enumerate(poss):
            oc, hits = native.tt_oracle_search(
                "othello", np.asarray(s.board), 200, 1.0, 64, use_tt=True
            )
            np.testing.assert_array_equal(counts[b], oc, err_msg=f"b={b}")
            assert int(tree.dedup[b]) == hits


class TestEngineSemantics:
    def test_no_transpositions_matches_pure_tree_engine(self):
        """At budgets where no transposition is reachable the DAG engine
        must equal mcts/search.py exactly (node stats == edge stats on a
        pure tree)."""
        game = ConnectFour()
        model = make_uniform_model(game)
        cfg = MCTSConfig(num_sims=60, max_depth=48)
        tt_cfg = dataclasses.replace(cfg, transposition=True)
        pure = jax.jit(make_search_fn(game, model.apply_fn, cfg))
        dag = jax.jit(make_tt_search_fn(game, model.apply_fn, tt_cfg))
        rng = np.random.default_rng(11)
        poss = [_random_position(game, k, rng) for k in (2, 5, 8)]
        root = _stack(poss)
        t_dag = dag({}, root)
        assert int(np.asarray(t_dag.dedup).sum()) == 0  # below dedup range
        np.testing.assert_array_equal(
            np.asarray(pure({}, root).root_counts()),
            np.asarray(t_dag.root_counts()),
        )

    def test_nn_model_runs_and_conserves_budget(self):
        game = ConnectFour()
        model = MLPNet(num_actions=game.num_actions, hidden=(32, 32))
        variables = init_model(
            model, jax.random.key(0), game.feature_shape
        )
        apply_fn = make_apply_fn(model)
        cfg = MCTSConfig(num_sims=150, max_depth=48, transposition=True)
        search = jax.jit(make_tt_search_fn(game, apply_fn, cfg))
        root = jax.vmap(lambda _: game.init())(jnp.arange(4))
        tree = search(variables, root)
        counts = np.asarray(tree.root_counts())
        assert (counts.sum(axis=1) == 150).all()
        assert (counts >= 0).all()

    def test_terminal_root_searches_nothing(self):
        game = ConnectFour()
        model = make_uniform_model(game)
        cfg = MCTSConfig(num_sims=30, max_depth=48, transposition=True)
        search = jax.jit(make_tt_search_fn(game, model.apply_fn, cfg))
        # player +1 already has a vertical win in column 0
        board = np.zeros((6, 7), np.int8)
        board[0:4, 0] = 1
        board[0:3, 1] = -1
        root = jax.tree_util.tree_map(
            lambda x: jnp.asarray(board)[None], game.init()
        )
        tree = search({}, root)
        assert float(np.asarray(tree.root_counts()).sum()) == 0.0

    def test_capacity_degrades_gracefully(self):
        game = ConnectFour()
        model = make_uniform_model(game)
        cfg = MCTSConfig(
            num_sims=100, max_depth=48, max_nodes=20, transposition=True
        )
        search = jax.jit(make_tt_search_fn(game, model.apply_fn, cfg))
        root = jax.vmap(lambda _: game.init())(jnp.arange(2))
        tree = search({}, root)  # must not crash / corrupt
        counts = np.asarray(tree.root_counts())
        assert (counts >= 0).all()
        assert int(np.asarray(tree.count).max()) <= 20

    def test_cyclic_state_graph_links_each_edge_once(self):
        """A cyclic game can walk the SAME unexpanded edge repeatedly
        within one descent (links only materialize post-loop); the link
        write must be idempotent or the child-code plane corrupts — a
        duplicated ADD shifts codes to wrong-but-in-range node indices."""
        from dummy_game import ToggleGame

        game = ToggleGame()
        model = make_uniform_model(game)
        cfg = MCTSConfig(num_sims=6, max_depth=8, transposition=True)
        search = jax.jit(make_tt_search_fn(game, model.apply_fn, cfg))
        root = jax.vmap(lambda _: game.init())(jnp.arange(1))
        tree = search({}, root)
        assert int(tree.dedup[0]) > 0  # transpositions did fire
        assert int(tree.count[0]) == 2  # only two distinct states exist
        count = int(tree.count[0])
        code = np.asarray(tree.pstats[0, 1])  # [A, C]
        parity = np.asarray(
            jax.tree_util.tree_leaves(tree.state)[0][0, 0]
        )  # [C]
        for c_slot in range(count):
            for a in range(game.num_actions):
                cd = code[a, c_slot]
                if cd > -0.5:  # live child link
                    child = int(cd)
                    assert cd == child and child < count, f"corrupt code {cd}"
                    assert parity[child] == 1 - parity[c_slot]


class TestIntegration:
    def test_selfplay_rides_the_tt_engine(self):
        game = ConnectFour()
        model = make_uniform_model(game)
        cfg = MCTSConfig(num_sims=20, max_depth=48, transposition=True)
        sp = SelfPlayConfig(batch_size=8, temp_threshold=4, max_moves=12)
        play = jax.jit(make_selfplay_fn(game, model.apply_fn, cfg, sp))
        traj, stats = play({}, jax.random.key(0))
        assert bool(np.asarray(traj.valid).any())
        assert (np.asarray(stats.num_moves) >= 1).all()

    def test_tree_reuse_conflict_rejected(self):
        game = ConnectFour()
        model = make_uniform_model(game)
        cfg = MCTSConfig(num_sims=8, transposition=True, tree_reuse=True)
        with pytest.raises(ValueError, match="mutually exclusive"):
            make_selfplay_fn(game, model.apply_fn, cfg, SelfPlayConfig(batch_size=4))

    def test_arena_tt_mode(self):
        from alphazero_tpu.arena import make_arena_fn

        game = ConnectFour()
        uni = make_uniform_model(game)
        cfg = MCTSConfig(num_sims=15, max_depth=48, transposition=True)
        play = jax.jit(
            make_arena_fn(game, uni.apply_fn, uni.apply_fn, cfg, num_games=8)
        )
        r = play({}, {}, jax.random.key(1))
        total = int(r.cand_wins) + int(r.inc_wins) + int(r.draws)
        assert total == 8
