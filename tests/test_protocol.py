"""Generic-protocol tests over the trivial CountingGame fixture (the
reference's DummyGame-based NodeStore tests, node.rs:379-656, reimagined:
the arena/search must work for ANY conforming Game), plus the host-model
bridge (PythonNNet-analogue, C10)."""

import jax
import jax.numpy as jnp
import numpy as np

from alphazero_tpu.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu.games.base import Game
from alphazero_tpu.mcts import make_search_fn
from alphazero_tpu.models import make_uniform_model
from alphazero_tpu.models.bridge import HostModelBridge
from alphazero_tpu.selfplay import make_selfplay_fn

from dummy_game import CountingGame


def test_games_satisfy_protocol():
    from alphazero_tpu.games import ConnectFour
    from alphazero_tpu.games.gomoku import Gomoku
    from alphazero_tpu.games.hex import Hex
    from alphazero_tpu.games.othello import Othello

    for game in (ConnectFour(), Othello(), Gomoku(), Hex(), CountingGame()):
        assert isinstance(game, Game)
        # defect D13 (connect_four_game.rs:86-88 vs :219-220): the declared
        # feature_shape must BE the built feature shape — one layout everywhere
        feats = game.to_features(game.init())
        assert tuple(feats.shape) == tuple(game.feature_shape), game
        assert feats.dtype == jnp.float32


def test_search_on_counting_game():
    g = CountingGame(horizon=6)
    net = make_uniform_model(g)
    search = jax.jit(make_search_fn(g, net.apply_fn, MCTSConfig(num_sims=40, max_depth=8)))
    root = jax.vmap(lambda _: g.init())(jnp.arange(3))
    tree = search({}, root)
    counts = np.asarray(tree.root_counts())
    np.testing.assert_array_equal(counts.sum(-1), [40, 40, 40])
    # from counter 0, optimal play reaches an even terminal; with negamax
    # backup the root player's best edge must carry positive Q
    q = np.asarray(tree.root_q())
    assert q.max() > 0


def test_selfplay_on_counting_game():
    g = CountingGame(horizon=6)
    net = make_uniform_model(g)
    sp = jax.jit(
        make_selfplay_fn(
            g,
            net.apply_fn,
            MCTSConfig(num_sims=10, max_depth=8),
            SelfPlayConfig(batch_size=4, temp_threshold=2),
        )
    )
    traj, stats = sp({}, jax.random.key(0))
    assert bool(np.asarray(stats.done).all())
    assert traj.pi.shape == (g.max_moves, 4, 2)


def test_host_model_bridge_in_search():
    """An arbitrary host (numpy) model drives the jitted search via the
    bridge — the PythonNNet embedding scenario (python_nnet.rs:88-132)."""
    from alphazero_tpu.games import ConnectFour

    g = ConnectFour()
    bridge = HostModelBridge(g.num_actions)

    def host_model_v0(feats):
        b = feats.shape[0]
        logits = np.zeros((b, 7), np.float32)
        logits[:, 3] = 5.0  # prefers the center
        return logits, np.zeros(b, np.float32)

    params = bridge.register(0, host_model_v0)
    search = jax.jit(make_search_fn(g, bridge.apply_fn, MCTSConfig(num_sims=20, max_depth=8)))
    root = jax.vmap(lambda _: g.init())(jnp.arange(2))
    tree = search(params, root)
    counts = np.asarray(tree.root_counts())
    assert counts.sum() == 40
    assert (counts.argmax(-1) == 3).all()  # center prior dominates

    # model versioning by id: v1 prefers column 0 instead
    def host_model_v1(feats):
        b = feats.shape[0]
        logits = np.zeros((b, 7), np.float32)
        logits[:, 0] = 5.0
        return logits, np.zeros(b, np.float32)

    params1 = bridge.register(1, host_model_v1)
    tree1 = search(params1, root)
    assert (np.asarray(tree1.root_counts()).argmax(-1) == 0).all()


def test_vmapped_step_exact_at_batch_4096():
    """Per-game placement under vmap at a production batch: each step is
    a dense one-hot write (a per-game dynamic gather/scatter formulation
    once dropped placements at B=4096 on an accelerator backend while
    passing at B<=512). Pinned against host-built references for
    connect-four and Gomoku, and against the unbatched step for Othello."""
    from alphazero_tpu.games import ConnectFour, Gomoku, Othello
    from alphazero_tpu.games.connect_four import ConnectFourState
    from alphazero_tpu.games.gomoku import GomokuState

    B = 4096
    rng = np.random.default_rng(7)

    game = ConnectFour()
    boards = np.zeros((B, 6, 7), np.int8)
    hts = np.zeros((B, 7), np.int64)
    for b in range(B):
        for _ in range(rng.integers(0, 20)):
            c = int(rng.choice(np.nonzero(hts[b] < 6)[0]))
            boards[b, hts[b, c], c] = 1
            hts[b, c] += 1
            boards[b] = -boards[b]
    actions = np.array([int(rng.choice(np.nonzero(hts[b] < 6)[0])) for b in range(B)])
    ref = boards.copy()
    ref[np.arange(B), hts[np.arange(B), actions], actions] = 1
    out = jax.jit(jax.vmap(game.step))(
        ConnectFourState(board=jnp.asarray(boards)), jnp.asarray(actions)
    )
    np.testing.assert_array_equal(np.asarray(out.board), -ref)

    gmk = Gomoku()
    gb = np.zeros((B, 9, 9), np.int8)
    occ = rng.integers(0, 81, (B, 10))
    for b in range(B):
        for j, cell in enumerate(occ[b]):
            gb[b, cell // 9, cell % 9] = 1 if j % 2 == 0 else -1
    acts = np.array([int(rng.choice(np.nonzero(gb[b].reshape(-1) == 0)[0])) for b in range(B)])
    gref = gb.copy()
    gref[np.arange(B), acts // 9, acts % 9] = 1
    gout = jax.jit(jax.vmap(gmk.step))(GomokuState(board=jnp.asarray(gb)), jnp.asarray(acts))
    np.testing.assert_array_equal(np.asarray(gout.board), -gref)

    oth = Othello()
    state = jax.vmap(lambda _: oth.init())(jnp.arange(B))
    oacts = jnp.asarray(rng.integers(0, 65, B))
    got = np.asarray(jax.jit(jax.vmap(oth.step))(state, oacts).board)
    one = jax.jit(oth.step)
    for b in rng.choice(B, 16, replace=False):
        s = jax.tree_util.tree_map(lambda x: x[b], state)
        np.testing.assert_array_equal(got[b], np.asarray(one(s, oacts[b]).board))
