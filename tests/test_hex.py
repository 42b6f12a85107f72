"""Hex 7x7 (fourth game) — connectivity oracle cross-check, canonical
transpose-negate semantics, the no-draw theorem under random play,
tactics, and engine integration. Hex exercises the protocol corner no
other game covers: a reachability win condition (on-device flood fill)
and goal-asymmetric players reconciled by a transposing canonical form."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphazero_tpu.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu.games import Hex
from alphazero_tpu.games.hex import SIZE, _NEIGHBORS, _connects_rows
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.models import make_uniform_model
from alphazero_tpu.selfplay import make_selfplay_fn

G = Hex()


def rc(r, c):
    return r * SIZE + c


def bfs_connects_rows(mask):
    """Independent CPU oracle: BFS with hex adjacency, row 0 -> row N-1."""
    seen = {(0, c) for c in range(SIZE) if mask[0, c]}
    dq = collections.deque(seen)
    while dq:
        r, c = dq.popleft()
        for dr, dc in _NEIGHBORS:
            rr, cc = r + dr, c + dc
            if 0 <= rr < SIZE and 0 <= cc < SIZE and mask[rr, cc] and (rr, cc) not in seen:
                seen.add((rr, cc))
                dq.append((rr, cc))
    return any((SIZE - 1, c) in seen for c in range(SIZE))


class TestConnectivity:
    @pytest.mark.parametrize("seed", range(8))
    @pytest.mark.parametrize("density", [0.3, 0.5, 0.7])
    def test_flood_fill_matches_bfs_oracle(self, seed, density):
        rng = np.random.default_rng(seed)
        mask = rng.random((SIZE, SIZE)) < density
        got = bool(jax.jit(_connects_rows)(jnp.asarray(mask)))
        assert got == bfs_connects_rows(mask)

    def test_hex_adjacency_not_square(self):
        # the (r+1, c-1) anti-diagonal IS a hex chain...
        anti = np.zeros((SIZE, SIZE), bool)
        for i in range(SIZE):
            anti[i, SIZE - 1 - i] = True
        assert bool(_connects_rows(jnp.asarray(anti)))
        # ...but the (r+1, c+1) main diagonal is NOT hex-adjacent
        main = np.zeros((SIZE, SIZE), bool)
        for i in range(SIZE):
            main[i, i] = True
        assert not bool(_connects_rows(jnp.asarray(main)))


class TestRules:
    def test_init_and_valid(self):
        s = G.init()
        assert np.asarray(s.board).sum() == 0
        assert np.asarray(G.valid_moves(s)).all()

    def test_step_negates_and_transposes(self):
        s1 = G.step(G.init(), jnp.asarray(rc(2, 3)))
        b = np.asarray(s1.board)
        assert b[3, 2] == -1  # transposed placement, negated
        assert np.count_nonzero(b) == 1
        done, _ = G.terminal(s1)
        assert not bool(done)
        # the occupied cell is invalid for the next player
        assert not np.asarray(G.valid_moves(s1))[rc(3, 2)]

    def test_previous_mover_chain_ends_game(self):
        # the opponent (-1, aiming columns in the canonical frame) owns a
        # full left-right chain -> done, value -1 for the player to move
        board = np.zeros((SIZE, SIZE), np.int8)
        board[3, :] = -1
        done, value = G.terminal(Hex().init()._replace(board=jnp.asarray(board)))
        assert bool(done) and float(value) == -1.0

    def test_no_draw_under_random_play(self):
        """The Hex theorem, empirically: every random game ends with a
        winner (value exactly -1 from the loser-to-move's view), within
        max_moves."""
        B = 64
        step_v = jax.vmap(G.step)
        term_v = jax.vmap(G.terminal)
        valid_v = jax.vmap(G.valid_moves)

        def body(carry, key):
            state, done, value, moves = carry
            valid = valid_v(state)
            logits = jnp.where(valid, 0.0, -1e9)
            a = jax.random.categorical(key, logits, axis=-1)
            nxt = step_v(state, a)
            d2, v2 = term_v(nxt)
            newly = ~done & d2
            value = jnp.where(newly, v2, value)
            moves = moves + (~done).astype(jnp.int32)
            done = done | d2
            # freeze finished games (their recorded value is already taken)
            state = jax.tree_util.tree_map(
                lambda n, o: jnp.where(
                    done.reshape((-1,) + (1,) * (n.ndim - 1)), o, n
                ),
                nxt,
                state,
            )
            return (state, done, value, moves), None

        init = (
            jax.vmap(lambda _: G.init())(jnp.arange(B)),
            jnp.zeros((B,), bool),
            jnp.zeros((B,)),
            jnp.zeros((B,), jnp.int32),
        )
        keys = jax.random.split(jax.random.key(0), G.max_moves)
        (state, done, value, moves), _ = jax.jit(
            lambda c, k: jax.lax.scan(body, c, k)
        )(init, keys)
        assert bool(jnp.all(done)), "some games did not finish by max_moves"
        np.testing.assert_array_equal(np.asarray(value), -1.0)
        assert int(moves.min()) >= 2 * SIZE - 1  # a chain needs >= SIZE own moves

    def test_symmetries_consistent(self):
        feats = G.to_features(G.step(G.init(), jnp.asarray(rc(1, 2))))
        pi = jnp.arange(SIZE * SIZE, dtype=jnp.float32)
        pi = pi / pi.sum()
        f_all, p_all = G.symmetries(feats, pi)
        assert f_all.shape == (2,) + G.feature_shape
        assert p_all.shape == (2, SIZE * SIZE)
        # 180-degree rotation: cell mass moves to the rotated cell
        np.testing.assert_allclose(
            np.asarray(p_all[1]).reshape(SIZE, SIZE),
            np.asarray(pi).reshape(SIZE, SIZE)[::-1, ::-1],
        )
        # applying the rotation twice is the identity
        f2, p2 = G.symmetries(f_all[1], p_all[1])
        np.testing.assert_array_equal(np.asarray(f2[1]), np.asarray(feats))
        np.testing.assert_allclose(np.asarray(p2[1]), np.asarray(pi))


class TestSearch:
    def test_finds_connection_completion(self):
        # +1 (to move) has rows 0..5 chained at column 2; rc(6,1) and
        # rc(6,2) both complete top-to-bottom (hex adjacency gives two
        # finishing cells)
        board = np.zeros((SIZE, SIZE), np.int8)
        board[0:6, 2] = 1
        board[0:6, 5] = -1  # inert: a -1 column chain is not a -1 goal
        root = jax.tree_util.tree_map(
            lambda x: jnp.asarray(board)[None], G.init()
        )
        model = make_uniform_model(G)
        cfg = MCTSConfig(num_sims=200, max_depth=24)
        tree = jax.jit(make_search_fn(G, model.apply_fn, cfg))({}, root)
        counts = np.asarray(tree.root_counts())[0]
        q = np.asarray(tree.root_q())[0]
        best = int(counts.argmax())
        assert best in (rc(6, 1), rc(6, 2))
        assert q[best] == 1.0

    def test_selfplay_smoke(self):
        model = make_uniform_model(G)
        sp = jax.jit(
            make_selfplay_fn(
                G,
                model.apply_fn,
                MCTSConfig(num_sims=8, max_depth=16),
                SelfPlayConfig(batch_size=4, temp_threshold=6),
            )
        )
        traj, stats = sp({}, jax.random.key(0))
        moves = np.asarray(stats.num_moves)
        assert (moves >= 2 * SIZE - 1).all() and (moves <= G.max_moves).all()
        assert np.asarray(stats.done).all()

    def test_gumbel_selfplay_smoke(self):
        model = make_uniform_model(G)
        sp = jax.jit(
            make_selfplay_fn(
                G,
                model.apply_fn,
                MCTSConfig(num_sims=8, max_depth=16, gumbel=True),
                SelfPlayConfig(batch_size=2, temp_threshold=6),
            )
        )
        traj, stats = sp({}, jax.random.key(1))
        assert np.asarray(stats.done).all()
