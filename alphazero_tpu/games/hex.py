"""Hex 7x7 as pure-JAX batched dynamics.

Fourth ``Game`` implementation — beyond the reference's scope (its only
game is Connect-Four, reference: examples/connect_four_lib/
connect_four_game.rs; the trait it fills is src/game.rs:8-28). Hex
exercises what no other game here does: a CONNECTION goal whose win
check is graph reachability (an iterative on-device flood fill, not a
fixed line scan), asymmetric player objectives reconciled by the
canonical form, and a no-draw guarantee (the Hex theorem: a full board
is always connected for exactly one player).

Board: the standard N x N rhombus with hex adjacency — cell (r, c)
neighbors (r±1, c), (r, c±1), (r-1, c+1), (r+1, c-1). The player to
move owns the +1 stones and aims to connect row 0 to row N-1; the
opponent's -1 stones aim left column to right column.

Canonical form: because the two goals differ, the usual sign-flip alone
would not preserve semantics. ``step`` therefore negates AND TRANSPOSES
the board: transposition swaps row-connectivity with column-connectivity
(and maps the hex adjacency onto itself), so in EVERY position the
player to move connects top-to-bottom with +1 stones. This is the
canonical trick the `Game` protocol's contract (+1 = player to move)
requires for goal-asymmetric games.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

SIZE = 7

# the six hex-grid neighbor offsets of the rhombus representation
_NEIGHBORS = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, 1), (1, -1))


class HexState(NamedTuple):
    """Canonical board: +1 = player to move (connects rows 0 and N-1),
    -1 = opponent (connects columns 0 and N-1)."""

    board: jax.Array  # int8[SIZE, SIZE]


def _neighbor_or(x: jax.Array) -> jax.Array:
    """bool[S,S] -> bool[S,S]: OR over the six hex neighbors of each cell
    (zero padding at the rim)."""
    padded = jnp.pad(x, ((1, 1), (1, 1)))
    out = jnp.zeros_like(x)
    for dr, dc in _NEIGHBORS:
        out = out | padded[1 + dr : 1 + dr + SIZE, 1 + dc : 1 + dc + SIZE]
    return out


def _connects_rows(p: jax.Array) -> jax.Array:
    """True iff the True cells of ``p`` form a chain from row 0 to row
    N-1 (hex adjacency). Iterated dilation to the fixpoint — the
    dense, batch-friendly form of the union-find/BFS a CPU implementation
    would use
    (dense [S,S] masks, no data-dependent indexing)."""
    reached = p & (jnp.arange(SIZE)[:, None] == 0)

    def cond(c):
        return c[1]

    def body(c):
        reached, _ = c
        nxt = (reached | _neighbor_or(reached)) & p
        return nxt, jnp.any(nxt != reached)

    reached, _ = jax.lax.while_loop(cond, body, (reached, jnp.any(reached)))
    return jnp.any(reached[SIZE - 1, :])


class Hex:
    """``Game`` protocol implementation (see games/base.py)."""

    name = "hex"
    num_actions = SIZE * SIZE
    feature_shape = (SIZE, SIZE, 2)
    max_moves = SIZE * SIZE  # the board fills in 49 moves and a full Hex
    #                          board is always decided (no draw exists)
    num_symmetries = 2  # identity + 180-degree rotation (the only board
    #                     symmetry preserving both players' goals)
    heuristic_is_zero = True

    def init(self) -> HexState:
        return HexState(board=jnp.zeros((SIZE, SIZE), jnp.int8))

    def step(self, state: HexState, action: jax.Array) -> HexState:
        """Place a +1 stone at ``action`` (row-major cell), then negate
        and TRANSPOSE (see module docstring). Total: occupied cells
        overwrite (callers mask illegal actions).

        Dense one-hot write — no per-game dynamic scatter (see
        ConnectFour.step)."""
        r, c = action // SIZE, action % SIZE
        hit = (jnp.arange(SIZE)[:, None] == r) & (jnp.arange(SIZE)[None, :] == c)
        board = jnp.where(hit, jnp.int8(1), state.board)
        return HexState(board=(-board.T).astype(jnp.int8))

    def valid_moves(self, state: HexState) -> jax.Array:
        return (state.board == 0).reshape(-1)

    def terminal(self, state: HexState) -> Tuple[jax.Array, jax.Array]:
        """From the player-to-move's perspective. The previous mover owns
        the -1 stones; in the canonical frame their goal is columns, so a
        -1 left-right chain means value -1. (+1 rows connected can only
        appear in hand-built states — the game would already have ended —
        but is checked for protocol totality.) No draw branch exists:
        that is Hex's theorem, asserted against random play in tests."""
        lose = _connects_rows((state.board == -1).T)
        win = _connects_rows(state.board == 1)
        done = lose | win
        value = jnp.where(win, 1.0, jnp.where(lose, -1.0, 0.0))
        return done, value

    def to_features(self, state: HexState) -> jax.Array:
        return jnp.stack(
            [
                (state.board == 1).astype(jnp.float32),
                (state.board == -1).astype(jnp.float32),
            ],
            axis=-1,
        )

    def symmetries(self, features: jax.Array, pi: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Identity + 180-degree rotation ((r,c) -> (N-1-r, N-1-c) maps
        the hex adjacency onto itself and fixes both edge pairs)."""
        grid = pi.reshape(SIZE, SIZE)
        feats = jnp.stack([features, features[::-1, ::-1, :]])
        pis = jnp.stack([pi, grid[::-1, ::-1].reshape(-1)])
        return feats, pis

    def eval_heuristic(self, state: HexState) -> jax.Array:
        return jnp.float32(0.0)
