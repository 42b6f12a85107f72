"""Transposition-DAG PUCT search — the reference's `seen` dedup, on device.

The reference keys every canonical state in a concurrent hash map and
redirects duplicate expansions to the canonical node (reference:
src/node.rs:135 ``seen``, node.rs:272-326 upgrade/dedup,
async_mcts.rs:293-299 "continue from canonical node"). Statistics are per
NODE (shared by every DAG parent), so transposed lines pool their visit
information and the "tree" is a DAG.

The production engines deliberately drop this (docs/PARITY.md): head-to-head
measurement (csrc/tt_oracle.cpp) showed the DAG is worth ~0 Elo at the
25-100 sims/move operating points and +32/+9 Elo (connect-four/othello) at
400 sims — so dedup only pays in DEEP-search deployments. This module is
the opt-in engine for exactly that regime (``MCTSConfig.transposition``):
the same intended-AlphaZero semantics as mcts/search.py, but with

* **node-level statistics** ``N/W: f32[B, C]`` instead of parent-edge
  planes (a DAG node's Q must be identical through every parent; the
  canonical board fixes whose turn it is, so W stored from the
  parent-to-move perspective reads directly);
* a **state-exact transposition probe**: the tree's own state planes ARE
  the table — a candidate child state is compared against every
  materialized node in one dense ``[B, L, C]`` pass (exact match, no hash
  collisions; the lockstep analogue of the DHashMap lookup);
* **dedup-continue descents**: when the probe hits, the edge links to the
  canonical node and the descent CONTINUES through it
  (async_mcts.rs:293-299), consuming no node slot — one simulation may
  link several transpositions before expanding.

Because Q now lives per node and children are addressed by index, the
score pass reads child statistics with two lane gathers per simulation —
the one indexed read the gather-free production engines avoid. That is
the measured price of DAG sharing (docs/PARITY.md table), which is why
this engine is opt-in rather than the default.

With no transpositions in range this engine is bit-identical to
mcts/search.py (node stats equal parent-edge stats on a pure tree); with
them it is bit-identical to the sequential C++ DAG oracle
(csrc/tt_oracle.cpp, ``use_tt=1``) — both asserted in tests/test_tt.py.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from alphazero_tpu.config import MCTSConfig, PUCT_EPS
from alphazero_tpu.mcts.tree import INVALID_P, np_prod
from alphazero_tpu.ops import masked_policy, root_prior

ApplyFn = Callable[[Any, jax.Array], Tuple[jax.Array, jax.Array]]

# node-plane indices
NODE_TERM, NODE_TVAL, NODE_LIVE = 0, 1, 2


class TTTree(NamedTuple):
    """Batched search DAGs. B games, C node slots, A actions.

    Unlike ``tree.Tree`` (parent-edge statistics), N and W are per NODE —
    the DAG-sharing currency (node.rs:34-93 ``Node`` owns its counters).
    ``pstats`` keeps the per-(node, action) prior and child code
    (-1 unexpanded, idx live, -2 - idx terminal — same coding as tree.py).
    ``node`` planes: (is_terminal | terminal_value | materialized).
    """

    nstats: jax.Array  # f32[B, 2, C]  (N | W, parent-to-move perspective)
    pstats: jax.Array  # f32[B, 2, A, C]  (P_masked | child code)
    node: jax.Array    # f32[B, 3, C]
    state: Any         # game-state pytree, leaves [B, L, C]
    count: jax.Array   # i32[B] materialized nodes
    cursor: jax.Array  # i32[B] next slot (lockstep +1 per simulation)
    dedup: jax.Array   # i32[B] transposition links made (diagnostics)

    @property
    def capacity(self) -> int:
        return self.nstats.shape[2]

    @property
    def num_actions(self) -> int:
        return self.pstats.shape[2]

    def root_counts(self) -> jax.Array:
        """f32[B, A] visit counts of the root's child NODES (the DAG
        analogue of async_mcts.rs:84-94's child visit read)."""
        code = self.pstats[:, 1, :, 0]  # [B, A]
        idx = jnp.where(code < -1.5, -2.0 - code, code).astype(jnp.int32)
        expanded = (code > -0.5) | (code < -1.5)
        n = jnp.take_along_axis(
            self.nstats[:, 0], jnp.clip(idx, 0, self.capacity - 1), axis=1
        )
        return jnp.where(expanded, n, 0.0)


def make_tt_search_fn(game, apply_fn: ApplyFn, cfg: MCTSConfig):
    """Build ``search(params, root_state, rng) -> TTTree`` with the
    reference's transposition-DAG semantics."""
    A = game.num_actions
    C = cfg.nodes
    D = cfg.max_depth
    cpuct = float(cfg.cpuct)
    zero_heuristic = bool(getattr(game, "heuristic_is_zero", False))

    step_v = jax.vmap(game.step)
    valid_v = jax.vmap(game.valid_moves)
    term_v = jax.vmap(game.terminal)
    feat_v = jax.vmap(game.to_features)
    heur_v = jax.vmap(game.eval_heuristic)

    lane_c = jnp.arange(C)
    template = game.init()
    t_leaves, t_def = jax.tree_util.tree_flatten(template)
    leaf_shapes = [tuple(x.shape) for x in t_leaves]

    def onehot_lane(n):
        return (lane_c[None, :] == n[:, None]).astype(jnp.float32)

    def select_lane(plane2, oh):
        return jnp.sum(plane2 * oh, axis=-1)

    def flatten_state(state):
        """pytree of [B, ...s] -> list of [B, L]."""
        B = jax.tree_util.tree_leaves(state)[0].shape[0]
        return [
            leaf.reshape(B, np_prod(shape))
            for leaf, shape in zip(
                jax.tree_util.tree_leaves(state), leaf_shapes
            )
        ]

    def unflatten_state(flat):
        B = flat[0].shape[0]
        return jax.tree_util.tree_unflatten(
            t_def,
            [x.reshape((B,) + s) for x, s in zip(flat, leaf_shapes)],
        )

    def probe(tree: TTTree, flat_state) -> jax.Array:
        """Exact-state transposition lookup: f32[B, C] one-hot of the
        canonical node holding exactly this state (all-zero row = miss).
        The DHashMap ``seen.find`` (node.rs:284-289) as one dense pass."""
        match = tree.node[:, NODE_LIVE] > 0.5  # only materialized nodes
        for plane, flat in zip(
            jax.tree_util.tree_leaves(tree.state), flat_state
        ):
            match = match & jnp.all(plane == flat[:, :, None], axis=1)
        return match.astype(jnp.float32)

    def dense_scores(tree: TTTree):
        """PUCT over the frozen DAG: per-sim score pass.

        Child N/W are NODE stats read through the child-code plane — the
        two lane gathers this engine pays for DAG sharing. Returns
        (best_a f32[B, C], best_code f32[B, C])."""
        code = tree.pstats[:, 1]  # [B, A, C]
        expanded = (code > -0.5) | (code < -1.5)
        idx = jnp.where(code < -1.5, -2.0 - code, code).astype(jnp.int32)
        idx = jnp.clip(idx, 0, C - 1)
        B = code.shape[0]
        flat = idx.reshape(B, A * C)
        child_n = jnp.take_along_axis(tree.nstats[:, 0], flat, axis=1)
        child_w = jnp.take_along_axis(tree.nstats[:, 1], flat, axis=1)
        child_n = jnp.where(expanded, child_n.reshape(B, A, C), 0.0)
        child_w = jnp.where(expanded, child_w.reshape(B, A, C), 0.0)

        p = tree.pstats[:, 0]
        n_parent = jnp.sum(child_n, axis=1, keepdims=True)  # [B, 1, C]
        q = jnp.where(child_n > 0, child_w / jnp.maximum(child_n, 1.0), 0.0)
        u = cpuct * p * jnp.sqrt(n_parent + PUCT_EPS) / (1.0 + child_n)
        score = jnp.where(p <= INVALID_P * 0.5, jnp.float32(-1e30), q + u)

        best_a = jnp.argmax(score, axis=1)  # [B, C]
        oh_best = (
            jnp.arange(A)[None, :, None] == best_a[:, None, :]
        ).astype(jnp.float32)
        best_code = jnp.sum(code * oh_best, axis=1)
        return best_a.astype(jnp.float32), best_code

    def _simulate(params, tree: TTTree) -> TTTree:
        B = tree.nstats.shape[0]
        bidx = jnp.arange(B)
        best_a, best_code = dense_scores(tree)
        term_plane = tree.node[:, NODE_TERM]
        tval_plane = tree.node[:, NODE_TVAL]
        root_flat = [
            leaf[:, :, 0] for leaf in jax.tree_util.tree_leaves(tree.state)
        ]

        def cond(c):
            return jnp.any(c["active"])

        def body(c):
            active = c["active"]
            oh = onehot_lane(c["node"])
            a = select_lane(best_a, oh).astype(jnp.int32)
            code = select_lane(best_code, oh)

            live = code > -0.5
            ctermc = code < -1.5
            unexp = ~live & ~ctermc
            child_idx = jnp.where(ctermc, -2.0 - code, code).astype(jnp.int32)

            # branch A (live/terminal child): follow the stored edge
            oh_child = onehot_lane(child_idx)
            child_flat = [
                jnp.sum(p_ * oh_child[:, None, :].astype(p_.dtype), axis=-1)
                for p_ in jax.tree_util.tree_leaves(tree.state)
            ]
            child_tval = select_lane(tval_plane, oh_child)

            # branch B (unexpanded): step the carried state, probe the DAG
            # (node.rs:284-289 dedup or node.rs:293-317 materialize)
            new_state_t = step_v(unflatten_state(c["cur"]), a)
            new_flat = flatten_state(new_state_t)
            m = probe(tree, new_flat)  # [B, C] one-hot (or zero row)
            hit = jnp.sum(m, axis=-1) > 0.5
            canon = jnp.argmax(m, axis=-1).astype(jnp.int32)
            canon_term = select_lane(term_plane, m) > 0.5
            canon_tval = select_lane(tval_plane, m)

            # unified "where did this level take us"
            nxt = jnp.where(live | ctermc, child_idx, canon)
            nxt_term = jnp.where(ctermc, True, jnp.where(live, False, canon_term))
            nxt_tval = jnp.where(live | ctermc, child_tval, canon_tval)
            moved = active & (live | ctermc | (unexp & hit))
            expand = active & unexp & ~hit

            depth1 = c["depth"] + 1
            slot = jnp.where(moved, c["depth"], D)
            path = c["path"].at[bidx, slot].set(nxt, mode="drop")

            # transposition link record (applied post-loop): dedup'd edges
            # point at the canonical node, terminal-coded like tree.py.
            # A cyclic state graph can walk the SAME unexpanded edge twice
            # within one descent (links are only applied post-loop, so the
            # edge still reads as unexpanded the second time); the post-loop
            # einsum ADD is not idempotent, so a duplicate record would
            # corrupt the child-code plane — record each edge at most once
            # (the probe is deterministic in-loop, duplicates carry an
            # identical code, dropping them loses nothing).
            dup = jnp.any(
                (c["link_p"] == c["node"][:, None])
                & (c["link_a"] == a[:, None]),
                axis=1,
            )
            is_link = active & unexp & hit & ~dup
            link_code = jnp.where(canon_term, -2.0 - canon.astype(jnp.float32),
                                  canon.astype(jnp.float32))
            lslot = jnp.where(is_link, c["depth"], D)
            link_p = c["link_p"].at[bidx, lslot].set(c["node"], mode="drop")
            link_a = c["link_a"].at[bidx, lslot].set(a, mode="drop")
            link_c = c["link_c"].at[bidx, lslot].set(link_code, mode="drop")

            cut = moved & ~nxt_term & (depth1 >= D)
            go = moved & ~nxt_term & ~cut

            cur = [
                jnp.where(
                    active[:, None],
                    jnp.where((live | ctermc)[:, None], cf.astype(nf.dtype), nf),
                    old,
                )
                for cf, nf, old in zip(child_flat, new_flat, c["cur"])
            ]
            return {
                "node": jnp.where(go, nxt, c["node"]),
                "cur": cur,
                "depth": jnp.where(moved, depth1, c["depth"]),
                "active": go,
                "path": path,
                "link_p": link_p,
                "link_a": link_a,
                "link_c": link_c,
                "links": c["links"] + is_link.astype(jnp.int32),
                "exp_mask": c["exp_mask"] | expand,
                "exp_parent": jnp.where(expand, c["node"], c["exp_parent"]),
                "exp_action": jnp.where(expand, a, c["exp_action"]),
                "term_mask": c["term_mask"] | (moved & nxt_term),
                "cut_mask": c["cut_mask"] | cut,
                "leaf_tval": jnp.where(moved & nxt_term, nxt_tval, c["leaf_tval"]),
            }

        init = {
            "node": jnp.zeros((B,), jnp.int32),
            "cur": root_flat,
            "depth": jnp.zeros((B,), jnp.int32),
            "active": tree.node[:, NODE_TERM, 0] < 0.5,
            "path": jnp.zeros((B, D), jnp.int32),
            "link_p": jnp.full((B, D), -1, jnp.int32),
            "link_a": jnp.zeros((B, D), jnp.int32),
            "link_c": jnp.zeros((B, D), jnp.float32),
            "links": jnp.zeros((B,), jnp.int32),
            "exp_mask": jnp.zeros((B,), bool),
            "exp_parent": jnp.zeros((B,), jnp.int32),
            "exp_action": jnp.zeros((B,), jnp.int32),
            "term_mask": jnp.zeros((B,), bool),
            "cut_mask": jnp.zeros((B,), bool),
            "leaf_tval": jnp.zeros((B,), jnp.float32),
        }
        sel = jax.lax.while_loop(cond, body, init)

        # ---- EXPAND + EVALUATE (the final cur state IS the leaf state:
        # the frontier's stepped board for expansions, the stopping node's
        # board for cutoffs) ----
        leaf_state = unflatten_state(sel["cur"])
        new_valid = valid_v(leaf_state)
        new_done, new_tval = term_v(leaf_state)

        s = tree.cursor
        exp_ok = sel["exp_mask"] & (s < C)

        if getattr(apply_fn, "needs_features", True):
            feats = feat_v(leaf_state)
        else:
            feats = jnp.zeros((B, 1), jnp.float32)
        logits, v_nn = apply_fn(params, feats)
        prior = masked_policy(logits, new_valid)
        p_masked = jnp.where(new_valid, prior, INVALID_P)

        mask_slot = lane_c[None, :] == s[:, None]  # [B, C]
        pwrite = exp_ok[:, None, None, None] & mask_slot[:, None, None, :]
        new_prow = jnp.stack([p_masked, jnp.full_like(p_masked, -1.0)], axis=1)
        pstats = jnp.where(pwrite, new_prow[:, :, :, None], tree.pstats)

        nwrite = exp_ok[:, None, None] & mask_slot[:, None, :]
        new_info = jnp.stack(
            [new_done.astype(jnp.float32), new_tval, jnp.ones((B,), jnp.float32)],
            axis=1,
        )
        node = jnp.where(nwrite, new_info[:, :, None], tree.node)

        state_leaves = [
            jnp.where(nwrite[:, :1], nf[:, :, None].astype(leaf.dtype), leaf)
            for leaf, nf in zip(
                jax.tree_util.tree_leaves(tree.state), sel["cur"]
            )
        ]
        state = jax.tree_util.tree_unflatten(t_def, state_leaves)

        # ---- LINKS: dedup links from the descent + the expansion link,
        # one one-hot matmul into the child-code plane (-1 + (code+1) =
        # code, the same add trick as search.py) ----
        exp_code = jnp.where(new_done, -2.0 - s.astype(jnp.float32),
                             s.astype(jnp.float32))
        link_p = jnp.concatenate(
            [sel["link_p"], jnp.where(exp_ok, sel["exp_parent"], -1)[:, None]],
            axis=1,
        )  # [B, D+1]
        link_a = jnp.concatenate(
            [sel["link_a"], sel["exp_action"][:, None]], axis=1
        )
        link_c = jnp.concatenate([sel["link_c"], exp_code[:, None]], axis=1)
        on = (link_p >= 0).astype(jnp.float32)
        oh_la = (
            jnp.arange(A)[None, None, :] == link_a[:, :, None]
        ).astype(jnp.float32)  # [B, D+1, A]
        oh_lp = (
            lane_c[None, None, :] == link_p[:, :, None]
        ).astype(jnp.float32)  # [B, D+1, C]
        w_la = ((link_c + 1.0) * on)[:, :, None] * oh_la  # [B, D+1, A]
        link_add = jnp.einsum(
            "bda,bdc->bac", w_la, oh_lp,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        pstats = pstats.at[:, 1].add(link_add)

        # ---- BACKUP onto the path NODES (node-stats: the leaf and every
        # ancestor node gets n += 1, w += sign * v; parent-to-move storage
        # flips once more at odd distance — csrc/tt_oracle.cpp backup) ----
        # the expansion's new node joins the path post-loop (path[depth++];
        # loop-exit depth is <= D-1 for expanding games, so it fits)
        depth = sel["depth"]
        pslot = jnp.where(exp_ok, depth, D)
        path = sel["path"].at[bidx, pslot].set(s, mode="drop")
        depth = depth + exp_ok.astype(jnp.int32)

        v_expand = jnp.where(new_done, new_tval, v_nn)
        if zero_heuristic:
            v_cut = jnp.zeros((B,), jnp.float32)
        else:
            v_cut = heur_v(leaf_state)
        v_leaf = jnp.where(
            exp_ok,
            v_expand,
            jnp.where(
                sel["term_mask"],
                sel["leaf_tval"],
                jnp.where(sel["cut_mask"], v_cut, 0.0),
            ),
        )
        # out-of-capacity expansions still back up their evaluated value
        # along the existing path (graceful degradation, tree.py contract)
        v_leaf = jnp.where(
            sel["exp_mask"] & ~exp_ok, v_expand, v_leaf
        )

        did_sim = sel["exp_mask"] | sel["term_mask"] | sel["cut_mask"]
        d_pos = jnp.arange(D)[None, :]
        on_path = ((d_pos < depth[:, None]) & did_sim[:, None]).astype(
            jnp.float32
        )
        sign = jnp.where((depth[:, None] - d_pos) % 2 == 1, -1.0, 1.0)
        coeff = jnp.stack(
            [on_path, sign * v_leaf[:, None] * on_path], axis=1
        )  # [B, 2, D]
        oh_pn = (
            lane_c[None, None, :] == path[:, :, None]
        ).astype(jnp.float32)  # [B, D, C]
        upd = jnp.einsum(
            "bkd,bdc->bkc", coeff, oh_pn,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        nstats = tree.nstats + upd

        return TTTree(
            nstats=nstats,
            pstats=pstats,
            node=node,
            state=state,
            count=tree.count + exp_ok.astype(jnp.int32),
            cursor=s + 1,
            dedup=tree.dedup + sel["links"],
        )

    def init_dag(root_state) -> TTTree:
        leaves = jax.tree_util.tree_leaves(root_state)
        B = leaves[0].shape[0]

        def alloc_leaf(x):
            L = np_prod(x.shape[1:])
            buf = jnp.zeros((B, L, C), x.dtype)
            return buf.at[:, :, 0].set(x.reshape(B, L))

        state = jax.tree_util.tree_map(alloc_leaf, root_state)
        root_valid = valid_v(root_state)
        root_done, root_tval = term_v(root_state)

        pstats = jnp.zeros((B, 2, A, C), jnp.float32)
        pstats = pstats.at[:, 1].set(-1.0)
        pstats = pstats.at[:, 0, :, 0].set(
            jnp.where(root_valid, 0.0, INVALID_P)
        )
        node = jnp.zeros((B, 3, C), jnp.float32)
        node = node.at[:, NODE_TERM, 0].set(root_done.astype(jnp.float32))
        node = node.at[:, NODE_TVAL, 0].set(root_tval)
        node = node.at[:, NODE_LIVE, 0].set(1.0)
        return TTTree(
            nstats=jnp.zeros((B, 2, C), jnp.float32),
            pstats=pstats,
            node=node,
            state=state,
            count=jnp.ones((B,), jnp.int32),
            cursor=jnp.ones((B,), jnp.int32),
            dedup=jnp.zeros((B,), jnp.int32),
        )

    def search(
        params,
        root_state: Any,
        rng: Optional[jax.Array] = None,
        num_sims: Optional[int] = None,
    ) -> TTTree:
        sims = cfg.num_sims if num_sims is None else num_sims
        tree = init_dag(root_state)
        prior, root_valid = root_prior(
            game, apply_fn, cfg, params, root_state, rng
        )
        p_masked = jnp.where(root_valid, prior, INVALID_P)
        tree = tree._replace(
            pstats=tree.pstats.at[:, 0, :, 0].set(p_masked)
        )
        return jax.lax.fori_loop(0, sims, lambda i, t: _simulate(params, t), tree)

    return search
