"""The batched array tree — the accelerator-native NodeStore.

Re-design of the reference's lock-free node arena (reference:
src/node.rs:129-377 ``NodeStore``) and per-node packed atomic statistics
(node.rs:12-127 ``Node``). In lockstep there is no concurrency to defend
against — every game advances exactly one simulation per lockstep step —
so the packed W/N/virtual-loss ``AtomicU64`` (node.rs:17) and the CAS
spinlock slot lifecycle (node.rs:328-341) dissolve into plain arrays;
virtual loss is unnecessary by construction (SURVEY.md §2). The concurrent
transposition table (node.rs:135) is intentionally dropped (SURVEY.md §7
hard-parts (c)).

**Layout: dense planes, no gathers.** The tree is LANE-MAJOR with the
node-capacity axis C as the minor dimension, and the search never gathers
or scatters — every per-game read or write is a dense pass that XLA fuses
(whether indexed reads would now be cheaper is an open question for the
GPU; see ROADMAP.md):

* ``stats: f32[B, 4, A, C]`` — stat planes (N | W | P_masked | child);
  "read node n's row" is a one-hot multiply + lane-reduce (a dense pass),
  "write node rows" is a static ``dynamic_update_slice`` at the lockstep
  slot cursor, and backup is a batched one-hot matmul.
* ``node: f32[B, 2, C]`` — (is_terminal | terminal_value) planes.
* ``state``: each game-state leaf ``[B, ...s]`` is stored ``[B, prod(s), C]``.

**Slot allocation is lockstep**: every simulation burns slot ``cursor``
(a scalar — identical across games) whether or not the game expanded that
sim; non-expanding games leave the slot unlinked and unreachable. This is
what turns the reference's per-game bump allocator (node.rs:234-244
``len.fetch_add``) into a single static slice index. With the default
capacity ``num_sims + 1`` nothing is ever lost; smaller capacities degrade
gracefully (the sim still backs up its value, the node just isn't
materialized). ``count[b]`` tracks nodes actually materialized per game.

N and child indices live in f32 lanes — exact integers up to 2^24.
Illegal actions carry ``P_masked = INVALID_P`` so PUCT needs no separate
legality plane.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

UNVISITED = -1.0     # child plane sentinel (NodeState::PlaceHolder analogue)
INVALID_P = -1e30    # masked-prior sentinel for illegal actions

# stat plane indices
PLANE_N, PLANE_W, PLANE_P, PLANE_CHILD = 0, 1, 2, 3


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


class Tree(NamedTuple):
    """Batched search trees. B games, C node slots each, A actions.

    Edge statistics live on the parent: plane N/W of edge ``(n, a)`` hold
    the visit count and total value (from node ``n``'s player-to-move
    perspective). ``Q = W / N`` replaces the reference's ``compute_q``
    (node.rs:51-58) without the fixed-point ``WIN_SCALE`` encoding
    (node.rs:13) — floats need no atomics here.
    """

    stats: jax.Array   # f32[B, 4, A, C]
    node: jax.Array    # f32[B, 2, C]
    state: Any         # game-state pytree, leaves [B, L, C]
    count: jax.Array   # i32[B] materialized nodes per game
    cursor: jax.Array  # i32[B] next slot per game (root occupies slot 0;
    #                    advances one slot per simulation in lockstep, but
    #                    re-rooted trees carry different live prefixes, so
    #                    the cursor is per-game)

    @property
    def batch_size(self) -> int:
        return self.stats.shape[0]

    @property
    def capacity(self) -> int:
        return self.stats.shape[3]

    @property
    def num_actions(self) -> int:
        return self.stats.shape[2]

    # --- decoded views (test/diagnostic surface) --------------------------
    @property
    def N(self) -> jax.Array:
        return jnp.swapaxes(self.stats[:, PLANE_N], 1, 2).astype(jnp.int32)

    @property
    def W(self) -> jax.Array:
        return jnp.swapaxes(self.stats[:, PLANE_W], 1, 2)

    @property
    def P(self) -> jax.Array:
        p = jnp.swapaxes(self.stats[:, PLANE_P], 1, 2)
        return jnp.where(p <= INVALID_P * 0.5, 0.0, p)

    @property
    def child(self) -> jax.Array:
        """Decoded child indices [B, C, A]; -1 = unexpanded. The raw plane
        stores a code: -1 unexpanded, idx for live children, -2 - idx for
        terminal children (so the descent needs no terminality gather)."""
        code = jnp.swapaxes(self.stats[:, PLANE_CHILD], 1, 2)
        return jnp.where(code < -1.5, -2.0 - code, code).astype(jnp.int32)

    @property
    def valid(self) -> jax.Array:
        return jnp.swapaxes(self.stats[:, PLANE_P], 1, 2) > INVALID_P * 0.5

    @property
    def term(self) -> jax.Array:
        return self.node[:, 0] > 0.5

    @property
    def tval(self) -> jax.Array:
        return self.node[:, 1]

    def root_counts(self) -> jax.Array:
        """f32[B, A] root visit counts — the search output consumed by
        ``action_probs`` (the analogue of async_mcts.rs:84-94)."""
        return self.stats[:, PLANE_N, :, 0]

    def root_q(self) -> jax.Array:
        """f32[B, A] root edge Q values (diagnostics)."""
        n = self.stats[:, PLANE_N, :, 0]
        w = self.stats[:, PLANE_W, :, 0]
        return w / jnp.maximum(n, 1.0)


def init_tree(game, root_state: Any, capacity: int) -> Tree:
    """Allocate trees with the (batched) root installed in slot 0.

    The analogue of ``NodeStore::from_root`` (node.rs:156-166), except the
    root's legality mask and terminality are computed here and its prior is
    installed by the search (fixing reference defect D1's never-initialized
    root policy, SURVEY.md §8).
    """
    leaves = jax.tree_util.tree_leaves(root_state)
    B = leaves[0].shape[0]
    A = game.num_actions
    C = capacity

    def alloc_leaf(x):
        L = np_prod(x.shape[1:])
        buf = jnp.zeros((B, L, C), x.dtype)
        return buf.at[:, :, 0].set(x.reshape(B, L))

    state = jax.tree_util.tree_map(alloc_leaf, root_state)
    root_valid = jax.vmap(game.valid_moves)(root_state)
    root_done, root_tval = jax.vmap(game.terminal)(root_state)

    stats = jnp.zeros((B, 4, A, C), jnp.float32)
    stats = stats.at[:, PLANE_CHILD].set(UNVISITED)
    # root prior lanes start as "legal with prior 0"; the search overwrites
    # them with the masked NN prior before the first simulation.
    stats = stats.at[:, PLANE_P, :, 0].set(
        jnp.where(root_valid, 0.0, INVALID_P)
    )

    node = jnp.zeros((B, 2, C), jnp.float32)
    node = node.at[:, 0, 0].set(root_done.astype(jnp.float32))
    node = node.at[:, 1, 0].set(root_tval)

    return Tree(
        stats=stats,
        node=node,
        state=state,
        count=jnp.ones((B,), jnp.int32),
        cursor=jnp.ones((B,), jnp.int32),
    )
