"""Tree reuse across moves — batched re-rooting with subtree compaction.

Re-design of the reference's per-episode tree persistence: Coach creates
ONE ``AsyncMcts`` per episode, so statistics accumulated for a position
survive into later moves — after a move the new root is re-found through
the transposition table and the next search continues from its subtree
(reference: src/coach.rs:104-157, src/async_mcts.rs:81
``lookup_state_id``).

The lockstep equivalent cannot keep appending to one arena: the XLA
engine's per-simulation passes are dense over the whole capacity axis, so
an episode-lifetime arena would make every simulation O(episode · sims)
instead of O(sims). Instead, :func:`make_reroot_fn` builds a jittable
``reroot(tree, action, played_state)`` that EXTRACTS the played child's
subtree and compacts it into the low lanes of a fresh-capacity tree (new
root = lane 0), entirely with dense/batched ops:

1. the played child's slot is read from the root's child-code lane;
2. parent pointers are recovered with one batched scatter over the child
   planes (each slot has exactly one parent — the tree is a pure tree,
   no DAG; see tree.py on the dropped transposition table);
3. subtree membership ("is the new root an ancestor-or-self?") is
   resolved by pointer doubling — O(log capacity) gathers of [B, C];
4. kept nodes are ranked (root first, then by old slot order), child
   codes are remapped through the rank map, and every plane is permuted
   by one lane-gather; dead lanes are reset to empty-slot values.

Games whose played child was never materialized fall back to a fresh
``init_tree`` of the played state (``reused=False`` for them), exactly
like an episode's first move. The whole thing runs once per MOVE (not
per simulation), so its few gathers are amortized over ``num_sims``
simulations.

The continued search itself is ``make_search_fn(...).from_tree`` — the
engine is unchanged; reused roots keep their stored expansion prior and
their cumulative visit counts (the reference's ``get_action_prob`` also
read cumulative counts through a reused root, async_mcts.rs:84-94).
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from alphazero_tpu.mcts.tree import (
    PLANE_CHILD,
    Tree,
    UNVISITED,
    init_tree,
)


def _ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def make_reroot_fn(game, capacity: int):
    """Build ``reroot(tree, action, played_state) -> (Tree, reused)``.

    ``action`` i32[B] is the move played from each tree's root;
    ``played_state`` is the batched game state after that move (what the
    new root must represent). ``reused`` bool[B] flags games that carried
    a materialized subtree (False = fresh init fallback).
    """
    C = capacity
    A = game.num_actions
    lane = jnp.arange(C)

    def reroot(tree: Tree, action: jax.Array, played_state: Any):
        B = tree.stats.shape[0]
        bidx = jnp.arange(B)
        code_plane = tree.stats[:, PLANE_CHILD]  # [B, A, C]

        oh_a = jax.nn.one_hot(action, A, dtype=jnp.float32)
        root_code = jnp.sum(code_plane[:, :, 0] * oh_a, axis=1)  # [B]
        # child codes: -1 unexpanded, idx live, -2-idx terminal
        reused = (root_code > -0.5) | (root_code < -1.5)
        r = jnp.where(root_code < -1.5, -2.0 - root_code, root_code)
        r = jnp.where(reused, r, 0.0).astype(jnp.int32)

        dec = jnp.where(code_plane < -1.5, -2.0 - code_plane, code_plane)
        child_idx = dec.astype(jnp.int32)  # [B, A, C]; -1 = none

        # parent pointers: par[b, child] = parent lane (one scatter; every
        # materialized slot has exactly one parent edge)
        parent_lane = jnp.broadcast_to(lane[None, None, :], (B, A, C))
        par = jnp.full((B, C), -1, jnp.int32)
        par = par.at[
            bidx[:, None, None], jnp.where(child_idx >= 0, child_idx, C)
        ].set(parent_lane, mode="drop")

        # subtree membership by pointer doubling: mark[c] = r is an
        # ancestor-or-self of c
        mark = lane[None, :] == r[:, None]
        anc = par
        for _ in range(_ceil_log2(C) + 1):
            anc_c = jnp.clip(anc, 0, C - 1)
            hop = jnp.take_along_axis(mark, anc_c, axis=1)
            mark = mark | (hop & (anc >= 0))
            anc = jnp.where(
                anc >= 0, jnp.take_along_axis(anc, anc_c, axis=1), -1
            )
        keep = mark & reused[:, None]

        # rank kept nodes: root -> 0, the rest by old slot order
        is_root = lane[None, :] == r[:, None]
        keep_nr = keep & ~is_root
        new_idx = jnp.where(is_root, 0, jnp.cumsum(keep_nr.astype(jnp.int32), axis=1))
        new_count = jnp.sum(keep, axis=1).astype(jnp.int32)

        # child-code remap old->new (value rewrite BEFORE the lane permute)
        dec_flat = jnp.clip(child_idx, 0, C - 1).reshape(B, A * C)
        mapped = (
            jnp.take_along_axis(new_idx, dec_flat, axis=1)
            .reshape(B, A, C)
            .astype(jnp.float32)
        )
        new_code = jnp.where(
            code_plane < -1.5,
            -2.0 - mapped,
            jnp.where(code_plane < -0.5, UNVISITED, mapped),
        )
        stats = tree.stats.at[:, PLANE_CHILD].set(new_code)

        # permutation: perm[b, j] = old lane of new slot j (C = dead)
        perm = jnp.full((B, C), C, jnp.int32)
        perm = perm.at[bidx[:, None], jnp.where(keep, new_idx, C)].set(
            jnp.broadcast_to(lane[None, :], (B, C)), mode="drop"
        )
        live = perm < C
        perm_c = jnp.clip(perm, 0, C - 1)

        def permute(x):
            idx = perm_c.reshape((B,) + (1,) * (x.ndim - 2) + (C,))
            return jnp.take_along_axis(
                x, jnp.broadcast_to(idx, x.shape[:-1] + (C,)), axis=-1
            )

        stats_p = permute(stats)
        node_p = permute(tree.node)
        state_p = jax.tree_util.tree_map(permute, tree.state)

        # dead lanes -> empty-slot values (N=W=P=0, child unexpanded)
        dead = ~live
        empty4 = jnp.zeros((4, A), jnp.float32).at[PLANE_CHILD].set(UNVISITED)
        stats_p = jnp.where(
            dead[:, None, None, :], empty4[None, :, :, None], stats_p
        )
        node_p = jnp.where(dead[:, None, :], 0.0, node_p)
        state_p = jax.tree_util.tree_map(
            lambda x: jnp.where(dead[:, None, :], jnp.zeros_like(x), x),
            state_p,
        )

        rerooted = Tree(
            stats=stats_p,
            node=node_p,
            state=state_p,
            count=new_count,
            cursor=new_count,
        )

        # fresh fallback for games without a materialized child
        fresh = init_tree(game, played_state, C)

        def sel(f, rr):
            m = reused.reshape((B,) + (1,) * (rr.ndim - 1))
            return jnp.where(m, rr, f)

        out = jax.tree_util.tree_map(sel, fresh, rerooted)
        return out, reused

    return reroot
