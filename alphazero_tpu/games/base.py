"""The ``Game`` protocol — the environment extension point.

This is the accelerator-native re-design of the reference's 9-method ``Game`` trait
(reference: src/game.rs:8-28). Differences, by design:

* **States are always canonical**: the player to move always owns the ``+1``
  pieces. ``step`` applies an action *for player +1* and returns the next
  state already canonicalized (board sign-flipped). This removes the
  reference's separate ``get_canonical_form``/``get_next_state(player, a)``
  pair and fixes its defect D12 (connect_four_game.rs:198-203 flips only the
  ``me`` marker, not the piece signs — SURVEY.md §8).
* **Terminality is explicit**: ``terminal(state) -> (done, value)`` instead of
  the reference's magic ``get_game_ended -> f32`` with a tiny ``DRAW_EPS``
  encoding draws (connect_four_game.rs:191-195). ``value`` is exact
  (-1/0/+1 or any f32) from the *player-to-move*'s perspective, so draws
  propagate as 0 into training targets (fixing defect D7, coach.rs:147-154).
* **Pure functions over single states**: every method is a pure JAX function
  of one (unbatched) state pytree; callers ``jax.vmap`` them over the game
  batch. This is what lets the whole self-play loop live under one ``jit``.
* ``get_symmetries`` (game.rs:24) becomes ``symmetries(features, pi)`` acting
  on the *feature* tensor, since that is what the replay stores.

States must be pytrees of fixed-shape arrays (a NamedTuple of jnp arrays) so
they can be stacked into the MCTS node store and sharded over a mesh. States
must also be cheaply comparable via their canonical array form — the analogue
of the reference's ``Hash + Eq`` bound (game.rs:8) — but no transposition
table is built on them (SURVEY.md §7 hard-parts (c): a pure tree is correct
AlphaZero; the DAG dedup of node.rs:135 is intentionally dropped).
"""

from __future__ import annotations

from typing import Any, Protocol, Tuple, runtime_checkable

import jax

State = Any  # a pytree of jnp arrays


@runtime_checkable
class Game(Protocol):
    """Environment contract. All methods are pure, jit/vmap-compatible."""

    # --- static properties -------------------------------------------------
    name: str
    num_actions: int            # action-space size A (game.rs:15 valid mask len)
    feature_shape: Tuple[int, ...]  # to_features output shape (game.rs:13)
    max_moves: int              # upper bound on game length (for scan loops)
    num_symmetries: int         # |symmetries(features, pi)| (game.rs:24)

    # --- dynamics ----------------------------------------------------------
    def init(self) -> State:
        """Initial canonical state (game.rs:11 get_init_board)."""
        ...

    def step(self, state: State, action: jax.Array) -> State:
        """Apply ``action`` for the player to move (+1); return the next
        canonical state (game.rs:14 get_next_state, already canonicalized).

        Must be total: called with an invalid action (e.g. on a finished
        game under done-masking) it must return *some* state without
        raising — callers mask the result.
        """
        ...

    def valid_moves(self, state: State) -> jax.Array:
        """bool[A] legal-action mask (game.rs:15 get_valid_moves)."""
        ...

    def terminal(self, state: State) -> Tuple[jax.Array, jax.Array]:
        """(done: bool[], value: f32[]) — value from the player-to-move's
        perspective (game.rs:17 get_game_ended; draws are exact 0 here)."""
        ...

    # --- observation -------------------------------------------------------
    def to_features(self, state: State) -> jax.Array:
        """f32[feature_shape] NN input planes (game.rs:27 to_features)."""
        ...

    def symmetries(self, features: jax.Array, pi: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Data augmentation (game.rs:24 get_symmetries).

        Returns (feats[S, *feature_shape], pis[S, A]) with S =
        ``num_symmetries``; index 0 must be the identity.
        """
        ...

    def eval_heuristic(self, state: State) -> jax.Array:
        """Depth-cutoff value estimate, player-to-move perspective
        (game.rs:26 eval_heuristic; async_mcts.rs:241-243 uses it when the
        descent exceeds max_depth)."""
        ...
