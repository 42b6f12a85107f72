"""Connect-Four as pure-JAX batched board dynamics.

Re-design of the reference game (reference:
examples/connect_four_lib/connect_four_game.rs:18-238): 6x7 board, win
length 4. The state is canonical — the player to move always holds the +1
pieces — so ``step`` drops a +1 piece and sign-flips the board (fixing
reference defect D12: connect_four_game.rs:198-203 never flipped piece
signs). Win detection uses static-sliced 4-window ANDs over all four
directions with *inclusive* window bounds, fixing the reference's missed
rightmost/topmost windows (defect D11: connect_four_game.rs:114,129 use an
exclusive loop bound). Feature layout is NHWC ``[6, 7, 2]`` everywhere,
resolving the reference's three-way shape disagreement (defect D13:
connect_four_game.rs:86-88 vs :219-220 vs connect_four_net.py:36-38).

The state is the board ALONE: the reference's auxiliary per-column
``heights`` array (connect_four_game.rs:42-54) is derivable and would cost
the search an extra stored plane per tree node, so it is recomputed where
needed (one tiny reduce). Everything is O(1)-shaped and branch-free so
``jax.vmap`` over thousands of boards compiles to a handful of fused VPU
ops.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

ROWS = 6
COLS = 7
WIN = 4  # win length (connect_four_game.rs:15)


class ConnectFourState(NamedTuple):
    """Canonical board: +1 = player to move, -1 = opponent."""

    board: jax.Array  # int8[ROWS, COLS]


def heights(state: ConnectFourState) -> jax.Array:
    """i32[COLS] pieces per column (recomputed, not stored)."""
    return jnp.sum(state.board != 0, axis=0).astype(jnp.int32)


def _has_win(board: jax.Array, player: int) -> jax.Array:
    """True iff ``player`` (+1/-1) has 4 in a row.

    Static slicing over all 4 directions; window starts are inclusive over
    the full range (the correct semantics the reference intended —
    cf. connect_four_game.rs:111-196 and defect D11).
    """
    p = board == player
    horiz = p[:, : COLS - 3] & p[:, 1 : COLS - 2] & p[:, 2 : COLS - 1] & p[:, 3:]
    vert = p[: ROWS - 3, :] & p[1 : ROWS - 2, :] & p[2 : ROWS - 1, :] & p[3:, :]
    diag = (
        p[: ROWS - 3, : COLS - 3]
        & p[1 : ROWS - 2, 1 : COLS - 2]
        & p[2 : ROWS - 1, 2 : COLS - 1]
        & p[3:, 3:]
    )
    anti = (
        p[3:, : COLS - 3]
        & p[2 : ROWS - 1, 1 : COLS - 2]
        & p[1 : ROWS - 2, 2 : COLS - 1]
        & p[: ROWS - 3, 3:]
    )
    return horiz.any() | vert.any() | diag.any() | anti.any()


class ConnectFour:
    """``Game`` protocol implementation (see games/base.py)."""

    name = "connect_four"
    num_actions = COLS
    feature_shape = (ROWS, COLS, 2)
    max_moves = ROWS * COLS
    num_symmetries = 2
    heuristic_is_zero = True  # lets the search skip the cutoff-state pass

    def init(self) -> ConnectFourState:
        return ConnectFourState(board=jnp.zeros((ROWS, COLS), jnp.int8))

    def step(self, state: ConnectFourState, action: jax.Array) -> ConnectFourState:
        """Drop a +1 piece in column ``action``; return the flipped board
        (next player's canonical view). Total: a full column clamps to the
        top row (callers done-mask such states).

        DENSE one-hot arithmetic only — no per-game dynamic gather/scatter.
        An earlier ``board[:, action]`` + ``.at[row, action].set(1)``
        formulation was miscompiled by an accelerator backend under vmap
        at large batch (the placement scatter silently dropped for part of
        a B=4096 batch; correct at B<=512 and on CPU). Guarded by
        tests/test_protocol.py::test_vmapped_step_exact_at_batch_4096 and,
        on a GPU, tests/test_gpu.py."""
        col_mask = jnp.arange(COLS) == action                       # [7]
        heights = jnp.sum(state.board != 0, axis=0)                 # [7]
        row = jnp.minimum(jnp.sum(heights * col_mask), ROWS - 1)
        hit = (jnp.arange(ROWS)[:, None] == row) & col_mask[None, :]
        board = jnp.where(hit, jnp.int8(1), state.board)
        return ConnectFourState(board=(-board).astype(jnp.int8))

    def valid_moves(self, state: ConnectFourState) -> jax.Array:
        return state.board[ROWS - 1, :] == 0  # top cell empty

    def terminal(self, state: ConnectFourState) -> Tuple[jax.Array, jax.Array]:
        """From the player-to-move's perspective: the previous mover owns the
        -1 pieces, so a -1 win means value -1. Draws are exact 0 (fixing the
        reference's DRAW_EPS encoding, connect_four_game.rs:191-195)."""
        lose = _has_win(state.board, -1)
        win = _has_win(state.board, 1)
        full = jnp.all(state.board[ROWS - 1, :] != 0)
        done = lose | win | full
        value = jnp.where(win, 1.0, jnp.where(lose, -1.0, 0.0))
        return done, value

    def to_features(self, state: ConnectFourState) -> jax.Array:
        """NHWC [6,7,2] one-hot planes: (my pieces, opponent pieces) — the
        layout connect_four_game.rs:219-237 intended (defect D13 resolved)."""
        return jnp.stack(
            [
                (state.board == 1).astype(jnp.float32),
                (state.board == -1).astype(jnp.float32),
            ],
            axis=-1,
        )

    def symmetries(self, features: jax.Array, pi: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Identity + horizontal mirror with reversed pi
        (connect_four_game.rs:205-211)."""
        feats = jnp.stack([features, features[:, ::-1, :]])
        pis = jnp.stack([pi, pi[::-1]])
        return feats, pis

    def eval_heuristic(self, state: ConnectFourState) -> jax.Array:
        return jnp.float32(0.0)  # connect_four_game.rs:214-216
