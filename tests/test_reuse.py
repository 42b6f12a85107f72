"""Tree reuse across moves (mcts/reuse.py + search.from_tree).

The reference persists one AsyncMcts per episode so search statistics
survive across moves (coach.rs:104-157, async_mcts.rs:81). These tests
verify the lockstep re-rooting against an independent numpy BFS
subtree-extraction oracle, the continued search's budget accounting, and
the self-play integration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphazero_tpu.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.mcts.reuse import make_reroot_fn
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.mcts.tree import init_tree
from alphazero_tpu.models import (
    MLPNet,
    init_model,
    make_apply_fn,
    make_uniform_model,
)
from alphazero_tpu.selfplay import make_selfplay_fn

G = ConnectFour()


def _numpy_subtree(tree, b, r):
    """BFS subtree of slot ``r`` in game ``b`` + the old->new rank map
    (root first, then old slot order) — the independent oracle."""
    child = np.asarray(tree.child)
    sub = {r}
    frontier = [r]
    while frontier:
        nxt = []
        for c in frontier:
            for a in range(child.shape[2]):
                k = child[b, c, a]
                if k >= 0 and k not in sub:
                    sub.add(int(k))
                    nxt.append(int(k))
        frontier = nxt
    mapping = {r: 0}
    for i, x in enumerate(sorted(x for x in sub if x != r)):
        mapping[x] = i + 1
    return mapping


def test_reroot_matches_numpy_subtree_extraction():
    net = make_uniform_model(G)
    cfg = MCTSConfig(num_sims=40, max_depth=48)
    search = jax.jit(make_search_fn(G, net.apply_fn, cfg))
    B = 6
    state = jax.vmap(lambda _: G.init())(jnp.arange(B))
    tree = search({}, state)
    action = jnp.asarray(np.asarray(tree.root_counts()).argmax(-1))
    played = jax.vmap(G.step)(state, action)

    reroot = jax.jit(make_reroot_fn(G, cfg.nodes))
    new_tree, reused = reroot(tree, action, played)
    assert np.asarray(reused).all()

    N, W, P, child = map(np.asarray, (tree.N, tree.W, tree.P, tree.child))
    term, tval = np.asarray(tree.term), np.asarray(tree.tval)
    board = np.asarray(tree.state.board)
    nN, nW, nP, nchild = map(
        np.asarray, (new_tree.N, new_tree.W, new_tree.P, new_tree.child)
    )
    nterm, ntval = np.asarray(new_tree.term), np.asarray(new_tree.tval)
    nboard = np.asarray(new_tree.state.board)
    ncount = np.asarray(new_tree.count)
    ncursor = np.asarray(new_tree.cursor)

    for b in range(B):
        r = int(child[b, 0, int(action[b])])
        assert r >= 0
        mapping = _numpy_subtree(tree, b, r)
        assert ncount[b] == len(mapping) == ncursor[b]
        for old, new in mapping.items():
            np.testing.assert_array_equal(N[b, old], nN[b, new])
            np.testing.assert_allclose(W[b, old], nW[b, new])
            np.testing.assert_allclose(P[b, old], nP[b, new])
            assert term[b, old] == nterm[b, new]
            assert tval[b, old] == ntval[b, new]
            np.testing.assert_array_equal(board[b, :, old], nboard[b, :, new])
            for a in range(G.num_actions):
                k = child[b, old, a]
                want = -1 if k < 0 else mapping[int(k)]
                assert nchild[b, new, a] == want
        # dead lanes are empty slots
        for j in range(len(mapping), tree.capacity):
            assert nN[b, j].sum() == 0 and np.all(nchild[b, j] == -1)
        # new root state is the played state
        np.testing.assert_array_equal(
            nboard[b, :, 0], np.asarray(played.board[b]).reshape(-1)
        )


def test_reroot_unexpanded_child_falls_back_to_fresh():
    """With 2 sims, most root children were never materialized: those
    games must come back as a plain init_tree of the played state."""
    net = make_uniform_model(G)
    cfg = MCTSConfig(num_sims=2, max_depth=48)
    search = jax.jit(make_search_fn(G, net.apply_fn, cfg))
    B = 4
    state = jax.vmap(lambda _: G.init())(jnp.arange(B))
    tree = search({}, state)
    counts = np.asarray(tree.root_counts())
    action = jnp.asarray(counts.argmin(-1))  # unvisited action
    played = jax.vmap(G.step)(state, action)
    reroot = jax.jit(make_reroot_fn(G, cfg.nodes))
    new_tree, reused = reroot(tree, action, played)
    assert not np.asarray(reused).any()
    ref = init_tree(G, played, cfg.nodes)
    for a, b in zip(
        jax.tree_util.tree_leaves(new_tree), jax.tree_util.tree_leaves(ref)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_search_from_budget_and_cumulative_counts():
    """Continuing a re-rooted tree adds exactly num_sims root-edge visits
    on top of the carried (cumulative) counts — the reference's
    get_action_prob also read cumulative counts through a reused root."""
    net = make_uniform_model(G)
    cfg = MCTSConfig(num_sims=40, max_depth=48, max_nodes=96)
    search = jax.jit(make_search_fn(G, net.apply_fn, cfg))
    B = 5
    state = jax.vmap(lambda _: G.init())(jnp.arange(B))
    tree = search({}, state)
    action = jnp.asarray(np.asarray(tree.root_counts()).argmax(-1))
    played = jax.vmap(G.step)(state, action)
    reroot = jax.jit(make_reroot_fn(G, cfg.nodes))
    new_tree, reused = reroot(tree, action, played)
    carried = np.asarray(new_tree.root_counts()).sum(-1)
    assert (carried > 0).all()

    cont = jax.jit(
        lambda p, t, s, ru: search.from_tree(p, t, s, reused=ru)
    )
    t2 = cont({}, new_tree, played, reused)
    total = np.asarray(t2.root_counts()).sum(-1)
    np.testing.assert_array_equal(total, carried + cfg.num_sims)
    # reused root keeps its stored expansion prior
    np.testing.assert_allclose(
        np.asarray(t2.P)[:, 0], np.asarray(new_tree.P)[:, 0]
    )


def test_selfplay_with_tree_reuse_runs_and_is_deterministic():
    model = MLPNet(num_actions=G.num_actions, hidden=(16,))
    apply_fn = make_apply_fn(model)
    params = init_model(model, jax.random.key(0), G.feature_shape)
    cfg = MCTSConfig(num_sims=12, max_depth=48, max_nodes=32, tree_reuse=True)
    sp = jax.jit(
        make_selfplay_fn(G, apply_fn, cfg, SelfPlayConfig(batch_size=8, temp_threshold=6))
    )
    traj1, stats1 = sp(params, jax.random.key(3))
    traj2, stats2 = sp(params, jax.random.key(3))
    np.testing.assert_array_equal(np.asarray(traj1.pi), np.asarray(traj2.pi))
    assert np.asarray(stats1.done).all()
    # outcomes are legal game values
    assert set(np.unique(np.asarray(stats1.outcome))) <= {-1.0, 0.0, 1.0}
    # masked samples carry value 0; valid ones are bounded
    v = np.asarray(traj1.value)
    assert np.all(np.abs(v) <= 1.0)


def test_selfplay_reuse_first_move_matches_fresh_engine():
    """Move 0 has nothing to reuse: the reuse path's first-move policy
    must be bit-identical to the fresh-tree self-play (same keys)."""
    net = make_uniform_model(G)
    cfg_fresh = MCTSConfig(num_sims=16, max_depth=48)
    cfg_reuse = MCTSConfig(num_sims=16, max_depth=48, tree_reuse=True)
    spc = SelfPlayConfig(batch_size=4, temp_threshold=6, max_moves=1)
    sp_f = jax.jit(make_selfplay_fn(G, net.apply_fn, cfg_fresh, spc))
    sp_r = jax.jit(make_selfplay_fn(G, net.apply_fn, cfg_reuse, spc))
    tf_, _ = sp_f({}, jax.random.key(5))
    tr_, _ = sp_r({}, jax.random.key(5))
    np.testing.assert_array_equal(np.asarray(tf_.pi), np.asarray(tr_.pi))


def test_selfplay_reuse_with_dirichlet_noise():
    """Per-move root noise re-mixes on reused roots too (standard
    AlphaZero-with-reuse behavior); the episode still runs to completion
    deterministically under a fixed key."""
    net = make_uniform_model(G)
    cfg = MCTSConfig(
        num_sims=10,
        max_depth=48,
        max_nodes=24,
        tree_reuse=True,
        dirichlet_alpha=0.8,
        dirichlet_frac=0.25,
    )
    sp = jax.jit(
        make_selfplay_fn(G, net.apply_fn, cfg, SelfPlayConfig(batch_size=4, temp_threshold=6))
    )
    traj1, stats1 = sp({}, jax.random.key(7))
    traj2, stats2 = sp({}, jax.random.key(7))
    np.testing.assert_array_equal(np.asarray(traj1.pi), np.asarray(traj2.pi))
    assert np.asarray(stats1.done).all()
