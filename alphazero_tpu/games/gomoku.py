"""Gomoku (free-style five-in-a-row) as pure-JAX batched dynamics.

Third ``Game`` implementation — beyond the reference's scope (its only
game is Connect-Four, reference: examples/connect_four_lib/
connect_four_game.rs; the trait it fills is src/game.rs:8-28). Gomoku
exercises a corner neither other game does: a LARGE action space with
free placement and a zero depth-cutoff heuristic, with none of
Othello's flip machinery.

The board edge is a constructor parameter: ``Gomoku()`` is the 9x9
edition the round-1..4 goldens pin; ``Gomoku(15)`` is the production
15x15 game (A=225) — the scale test for the engines' dense-plane bet
(the [B, 4, A, C] stat planes and tree-wide score passes are O(A*C)
per simulation; docs/ENGINES.md carries the measured A=49→81→225
scaling). All editions share the same dynamics code; only the shapes
change.

Rules: players alternate placing stones on empty cells; five or more in
a row (horizontally, vertically or diagonally) wins; a full board with
no five is a draw. State is canonical (+1 = player to move) and ``step``
sign-flips, exactly like the other games.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

SIZE = 9  # default edition (the round-1..4 golden boards)
WIN = 5


class GomokuState(NamedTuple):
    """Canonical board: +1 = player to move, -1 = opponent."""

    board: jax.Array  # int8[size, size]


def _has_win(board: jax.Array, player: int, size: int, win: int) -> jax.Array:
    """True iff ``player`` has ``win`` in a row (any of 4 directions;
    inclusive window bounds — same pattern as connect_four._has_win)."""
    p = board == player
    M = size - win + 1
    horiz = p[:, :M]
    vert = p[:M, :]
    diag = p[:M, :M]
    anti = p[win - 1 :, :M]
    for i in range(1, win):
        horiz = horiz & p[:, i : M + i]
        vert = vert & p[i : M + i, :]
        diag = diag & p[i : M + i, i : M + i]
        anti = anti & p[win - 1 - i : size - i, i : M + i]
    return horiz.any() | vert.any() | diag.any() | anti.any()


class Gomoku:
    """``Game`` protocol implementation (see games/base.py).

    ``size`` picks the board edition: 9 (default, the small-board
    edition every golden pins) or any edge >= win (15 = the standard
    production board). ``win`` stays 5 (free-style gomoku)."""

    def __init__(self, size: int = SIZE, win: int = WIN):
        if size < win:
            raise ValueError(f"size={size} smaller than win={win}")
        self.size = size
        self.win = win
        self.name = "gomoku" if size == SIZE else f"gomoku{size}"
        self.num_actions = size * size
        self.feature_shape = (size, size, 2)
        self.max_moves = size * size
        self.num_symmetries = 8  # dihedral group of the square board
        self.heuristic_is_zero = True

    def init(self) -> GomokuState:
        return GomokuState(board=jnp.zeros((self.size, self.size), jnp.int8))

    def step(self, state: GomokuState, action: jax.Array) -> GomokuState:
        """Place a +1 stone at ``action`` (row-major cell); return the
        flipped board. Total: placing on an occupied cell overwrites it
        with +1 (callers mask illegal actions).

        Dense one-hot write — no per-game dynamic scatter (see
        ConnectFour.step)."""
        S = self.size
        r, c = action // S, action % S
        hit = (jnp.arange(S)[:, None] == r) & (jnp.arange(S)[None, :] == c)
        board = jnp.where(hit, jnp.int8(1), state.board)
        return GomokuState(board=(-board).astype(jnp.int8))

    def valid_moves(self, state: GomokuState) -> jax.Array:
        return (state.board == 0).reshape(-1)

    def terminal(self, state: GomokuState) -> Tuple[jax.Array, jax.Array]:
        """From the player-to-move's perspective: the previous mover owns
        the -1 stones, so a -1 five means value -1. Draws exact 0."""
        lose = _has_win(state.board, -1, self.size, self.win)
        win = _has_win(state.board, 1, self.size, self.win)
        full = jnp.all(state.board != 0)
        done = lose | win | full
        value = jnp.where(win, 1.0, jnp.where(lose, -1.0, 0.0))
        return done, value

    def to_features(self, state: GomokuState) -> jax.Array:
        return jnp.stack(
            [
                (state.board == 1).astype(jnp.float32),
                (state.board == -1).astype(jnp.float32),
            ],
            axis=-1,
        )

    def symmetries(self, features: jax.Array, pi: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """All 8 board symmetries (rotations x mirror), pi remapped as a
        size x size grid — the Othello pattern without a pass action."""
        grid = pi.reshape(self.size, self.size)
        feats, pis = [], []
        for k in range(4):
            f = jnp.rot90(features, k, axes=(0, 1))
            g = jnp.rot90(grid, k)
            for flip in (False, True):
                ff = f[:, ::-1, :] if flip else f
                gg = g[:, ::-1] if flip else g
                feats.append(ff)
                pis.append(gg.reshape(-1))
        return jnp.stack(feats), jnp.stack(pis)

    def eval_heuristic(self, state: GomokuState) -> jax.Array:
        return jnp.float32(0.0)
