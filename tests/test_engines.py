"""The XLA search engine (mcts/search.py) across games, models, positions,
tree capacity and root noise — against the sequential C++ oracles where
one exists (connect-four: csrc/mcts_oracle.cpp; Othello: the pure-tree
mode of csrc/tt_oracle.cpp), against search invariants elsewhere — plus
sharded-vs-unsharded equality per game and the backup's matmul precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from alphazero_tpu import native
from alphazero_tpu.config import MCTSConfig
from alphazero_tpu.games import ConnectFour, Gomoku, Hex, Othello
from alphazero_tpu.games.connect_four import heights
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.mcts.tt import make_tt_search_fn
from alphazero_tpu.models import MLPNet, init_model, make_apply_fn, make_uniform_model
from alphazero_tpu.parallel import make_mesh

# Othello's search compiles ~10x slower on the CPU than the others; it is
# covered by its oracle test below
GAMES = {
    "connect_four": (ConnectFour(), 48),
    "gomoku9": (Gomoku(), 32),
    "gomoku15": (Gomoku(15), 32),
    "hex": (Hex(), 56),
}


def _positions(game, n, max_moves, seed):
    """``n`` live positions, position i after i % (max_moves + 1) random
    legal moves."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = game.init()
        for _ in range(i % (max_moves + 1)):
            v = np.asarray(game.valid_moves(s))
            nxt = game.step(s, jnp.asarray(int(rng.choice(np.nonzero(v)[0]))))
            if bool(game.terminal(nxt)[0]):
                break
            s = nxt
        out.append(s)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *out)


def _model(game, kind):
    if kind == "uniform":
        return make_uniform_model(game).apply_fn, {}
    model = MLPNet(num_actions=game.num_actions, hidden=(32,))
    return make_apply_fn(model), init_model(model, jax.random.key(1), game.feature_shape)


def _counts(game, apply_fn, params, state, **cfg):
    search = make_search_fn(game, apply_fn, MCTSConfig(**cfg))
    rng = cfg.get("dirichlet_alpha") and jax.random.key(5)
    return np.asarray(
        jax.jit(lambda p, s: search(p, s, rng=rng or None).root_counts())(params, state)
    )


# ------------------------------------------------------------ oracles


@pytest.mark.parametrize("depth", [0, 4, 9, 16])
@pytest.mark.parametrize("sims", [30, 100])
def test_connect_four_matches_cpp_oracle(depth, sims):
    game = ConnectFour()
    state = _positions(game, 6, depth, seed=depth)
    counts = _counts(game, make_uniform_model(game).apply_fn, {}, state,
                     num_sims=sims, max_depth=48)
    boards, hts = np.asarray(state.board), np.asarray(jax.vmap(heights)(state))
    for i in range(6):
        ref = native.oracle_search(boards[i], hts[i], sims, 1.0, 48)
        assert ref is not None, "C++ toolchain missing"
        np.testing.assert_array_equal(counts[i], ref, err_msg=f"game {i}")


def test_othello_matches_pure_tree_oracle():
    game = Othello()
    state = _positions(game, 6, 12, seed=1)  # 0..5 random moves
    state = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b]), state, _positions(game, 2, 12, seed=2)
    )
    counts = _counts(game, make_uniform_model(game).apply_fn, {}, state,
                     num_sims=60, max_depth=64)
    for i in range(8):
        res = native.tt_oracle_search(
            "othello", np.asarray(state.board)[i], 60, 1.0, 64, use_tt=False
        )
        assert res is not None, "C++ toolchain missing"
        np.testing.assert_array_equal(counts[i], res[0], err_msg=f"game {i}")


# --------------------------------------------------------- invariants


def _check_invariants(game, state, counts, sims):
    valid = np.asarray(jax.vmap(game.valid_moves)(state))
    assert (counts[~valid] == 0).all(), "visits on an illegal action"
    np.testing.assert_array_equal(counts.sum(-1), sims)
    assert (counts == np.round(counts)).all()


@pytest.mark.parametrize("game_name", sorted(GAMES))
@pytest.mark.parametrize("kind", ["uniform", "mlp"])
def test_search_invariants(game_name, kind):
    """Every simulation lands on exactly one legal root child."""
    game, depth = GAMES[game_name]
    apply_fn, params = _model(game, kind)
    state = _positions(game, 4, 6, seed=2)
    counts = _counts(game, apply_fn, params, state, num_sims=24, max_depth=depth)
    _check_invariants(game, state, counts, 24)


@pytest.mark.parametrize("game_name", ["connect_four", "gomoku9", "hex"])
def test_capacity_overflow_degrades_gracefully(game_name):
    """A tree smaller than the budget stops expanding but keeps backing
    up evaluated leaves: the visit total stays exact, and the nodes that
    did fit get the same first-visit order as in a roomy tree."""
    game, depth = GAMES[game_name]
    apply_fn, params = _model(game, "uniform")
    state = _positions(game, 3, 5, seed=3)
    small = _counts(game, apply_fn, params, state, num_sims=40, max_depth=depth, max_nodes=9)
    _check_invariants(game, state, small, 40)
    roomy = _counts(game, apply_fn, params, state, num_sims=8, max_depth=depth, max_nodes=9)
    exact = _counts(game, apply_fn, params, state, num_sims=8, max_depth=depth)
    np.testing.assert_array_equal(roomy, exact)


@pytest.mark.parametrize("game_name", ["connect_four", "gomoku9", "hex"])
def test_games_in_a_batch_are_independent(game_name):
    """The dense one-hot engine never mixes rows: each game's counts are
    the same searched alone as inside a batch."""
    game, depth = GAMES[game_name]
    apply_fn, params = _model(game, "mlp")
    state = _positions(game, 4, 7, seed=4)
    batch = _counts(game, apply_fn, params, state, num_sims=16, max_depth=depth)
    for i in (0, 3):
        one = jax.tree_util.tree_map(lambda x: x[i : i + 1], state)
        alone = _counts(game, apply_fn, params, one, num_sims=16, max_depth=depth)
        np.testing.assert_array_equal(alone[0], batch[i])


@pytest.mark.parametrize("game_name", ["connect_four", "gomoku9"])
def test_root_noise_is_keyed(game_name):
    """Dirichlet root noise: the same key gives the same search, and the
    noised search still respects the invariants."""
    game, depth = GAMES[game_name]
    apply_fn, params = _model(game, "uniform")
    state = _positions(game, 4, 3, seed=5)
    cfg = MCTSConfig(num_sims=20, max_depth=depth, dirichlet_alpha=0.5)
    search = jax.jit(lambda p, s, k: make_search_fn(game, apply_fn, cfg)(p, s, rng=k).root_counts())
    a = np.asarray(search(params, state, jax.random.key(1)))
    b = np.asarray(search(params, state, jax.random.key(1)))
    c = np.asarray(search(params, state, jax.random.key(2)))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    _check_invariants(game, state, a, 20)


# ------------------------------------------------------------- sharding


@pytest.mark.parametrize("game_name", sorted(GAMES))
def test_sharded_search_matches_unsharded(game_name):
    """Games sharded over the 8-device data axis (GSPMD) give exactly the
    single-device counts."""
    game, depth = GAMES[game_name]
    apply_fn, params = _model(game, "mlp")
    state = _positions(game, 16, 6, seed=6)
    search = make_search_fn(game, apply_fn, MCTSConfig(num_sims=12, max_depth=depth))
    fn = lambda p, s: search(p, s).root_counts()
    plain = np.asarray(jax.jit(fn)(params, state))
    mesh = make_mesh()
    data_b = NamedSharding(mesh, P("data"))
    sharded_state = jax.tree_util.tree_map(lambda x: jax.device_put(x, data_b), state)
    out = jax.jit(fn, out_shardings=data_b)(params, sharded_state)
    assert len(out.sharding.device_set) == mesh.size
    np.testing.assert_array_equal(np.asarray(out), plain)


# ------------------------------------------------------------ precision


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dots(sub)


@pytest.mark.parametrize("engine", ["xla", "transposition"])
def test_backup_dots_pin_highest_precision(engine):
    """Every matmul in a search step carries Precision.HIGHEST, so a GPU
    cannot run the f32 backup in TF32 (which would round leaf values in
    the W planes and split card results from the CPU and the oracles)."""
    game = ConnectFour()
    cfg = MCTSConfig(num_sims=4, max_depth=8, transposition=engine == "transposition")
    make = make_tt_search_fn if cfg.transposition else make_search_fn
    search = make(game, make_uniform_model(game).apply_fn, cfg)
    state = _positions(game, 2, 2, seed=7)
    jaxpr = jax.make_jaxpr(lambda s: search({}, s).root_counts())(state).jaxpr
    dots = list(_dots(jaxpr))
    assert dots, "no backup matmul found"
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        ), eqn
