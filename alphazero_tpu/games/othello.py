"""Othello/Reversi 8x8 as pure-JAX batched board dynamics.

The second ``Game`` implementation (BASELINE config 4), proving the game
protocol generic the way the reference's ``Game`` trait is (reference:
src/game.rs:8-28 — its only shipped impl is Connect-Four). No Othello
exists in the reference; rules follow the standard alpha-zero-general
conventions: action space 65 = 64 squares + pass (action 64), pass legal
only when no placement is, game over when neither player can move (or the
board is full), value = sign of the disc differential.

Everything is shift-algebra: legality and flip masks are computed for all
64 squares at once with statically-unrolled directional shifts (8
directions x up-to-6 chain lengths), so ``vmap`` over thousands of boards
compiles to fused VPU passes — no per-square loops, no dynamic shapes.
State is canonical (player to move owns the +1 discs) and ``step`` returns
the sign-flipped board.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

SIZE = 8
PASS = SIZE * SIZE  # action 64

_DIRS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1),           (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _shift(x: jax.Array, dr: int, dc: int) -> jax.Array:
    """Zero-fill shift: out[r, c] = x[r - dr, c - dc]."""
    out = jnp.zeros_like(x)
    rs = slice(max(dr, 0), SIZE + min(dr, 0))
    rsrc = slice(max(-dr, 0), SIZE + min(-dr, 0))
    cs = slice(max(dc, 0), SIZE + min(dc, 0))
    csrc = slice(max(-dc, 0), SIZE + min(-dc, 0))
    return out.at[rs, cs].set(x[rsrc, csrc])


def _legal_squares(board: jax.Array, player: int) -> jax.Array:
    """bool[8,8]: squares where ``player`` has a legal placement."""
    own = board == player
    opp = board == -player
    empty = board == 0
    legal = jnp.zeros((SIZE, SIZE), bool)
    for dr, dc in _DIRS:
        # chain[j] = the j-th cell along the direction is an opponent disc
        run = _shift(opp, -dr, -dc)        # distance-1 cell is opponent
        beyond = _shift(own, -2 * dr, -2 * dc)
        cap = run & beyond                 # O then P at distance 2
        for k in range(3, SIZE):
            run = run & _shift(opp, -(k - 1) * dr, -(k - 1) * dc)
            cap = cap | (run & _shift(own, -k * dr, -k * dc))
        legal = legal | (empty & cap)
    return legal


def _flip_mask(board: jax.Array, move: jax.Array) -> jax.Array:
    """bool[8,8]: opponent discs flipped by playing one-hot ``move`` as +1."""
    own = board == 1
    opp = board == -1
    flips = jnp.zeros((SIZE, SIZE), bool)
    for dr, dc in _DIRS:
        ray = move
        run_ok = jnp.bool_(True)      # cells 1..k-1 were all opponent discs
        chain = jnp.zeros((SIZE, SIZE), bool)
        for k in range(1, SIZE):
            ray = _shift(ray, dr, dc)  # the cell at distance k from move
            is_opp = jnp.any(ray & opp)
            is_own = jnp.any(ray & own)
            # own disc at distance k closing an all-opponent chain: flip it
            flips = jnp.where(run_ok & is_own, flips | chain, flips)
            chain = chain | (ray & opp)
            run_ok = run_ok & is_opp
    return flips


class OthelloState(NamedTuple):
    """Canonical board: +1 = player to move, -1 = opponent."""

    board: jax.Array  # int8[8, 8]


class Othello:
    """``Game`` protocol implementation (see games/base.py)."""

    name = "othello"
    num_actions = PASS + 1           # 64 squares + pass
    feature_shape = (SIZE, SIZE, 2)
    max_moves = 96                   # 60 placements + pass slack
    num_symmetries = 8               # dihedral group of the board

    def init(self) -> OthelloState:
        board = jnp.zeros((SIZE, SIZE), jnp.int8)
        board = board.at[3, 3].set(1).at[4, 4].set(1)
        board = board.at[3, 4].set(-1).at[4, 3].set(-1)
        return OthelloState(board=board)

    def step(self, state: OthelloState, action: jax.Array) -> OthelloState:
        """Place a +1 disc (flipping captures) or pass; return the flipped
        board. Total: an illegal placement degenerates to a plain disc drop
        with no flips (callers mask such states)."""
        r, c = action // SIZE, action % SIZE
        is_pass = action >= PASS
        # dense one-hot move mask — no per-game dynamic scatter (see
        # ConnectFour.step)
        move = (
            (jnp.arange(SIZE)[:, None] == jnp.minimum(r, SIZE - 1))
            & (jnp.arange(SIZE)[None, :] == jnp.minimum(c, SIZE - 1))
            & ~is_pass
        )
        flips = _flip_mask(state.board, move)
        board = jnp.where(flips | move, jnp.int8(1), state.board)
        return OthelloState(board=(-board).astype(jnp.int8))

    def valid_moves(self, state: OthelloState) -> jax.Array:
        legal = _legal_squares(state.board, 1).reshape(-1)
        can_pass = ~jnp.any(legal)
        return jnp.concatenate([legal, can_pass[None]])

    def terminal(self, state: OthelloState) -> Tuple[jax.Array, jax.Array]:
        """Game over when neither side can place (includes full board).
        Value = sign of the disc differential, player-to-move perspective."""
        me_moves = jnp.any(_legal_squares(state.board, 1))
        opp_moves = jnp.any(_legal_squares(state.board, -1))
        done = ~me_moves & ~opp_moves
        diff = jnp.sum(state.board.astype(jnp.int32))
        value = jnp.where(done, jnp.sign(diff).astype(jnp.float32), 0.0)
        return done, value

    def to_features(self, state: OthelloState) -> jax.Array:
        return jnp.stack(
            [
                (state.board == 1).astype(jnp.float32),
                (state.board == -1).astype(jnp.float32),
            ],
            axis=-1,
        )

    def symmetries(self, features: jax.Array, pi: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """All 8 board symmetries; the pass logit is invariant."""
        grid = pi[:PASS].reshape(SIZE, SIZE)
        feats, pis = [], []
        for k in range(4):
            f = jnp.rot90(features, k, axes=(0, 1))
            g = jnp.rot90(grid, k)
            for flip in (False, True):
                ff = f[:, ::-1, :] if flip else f
                gg = g[:, ::-1] if flip else g
                feats.append(ff)
                pis.append(jnp.concatenate([gg.reshape(-1), pi[PASS:]]))
        return jnp.stack(feats), jnp.stack(pis)

    def eval_heuristic(self, state: OthelloState) -> jax.Array:
        """Depth-cutoff estimate: normalized disc differential."""
        return jnp.sum(state.board.astype(jnp.float32)) / (SIZE * SIZE)
