"""Lockstep vectorized PUCT search — the accelerator-native AsyncMcts.

Re-design of the reference's parallel tree search (reference:
src/async_mcts.rs:14-372). The reference keeps a CPU busy around a slow NN
by running ``num_threads`` searcher threads against one batching inference
service thread connected by channels (async_mcts.rs:117-217). On an
accelerator the whole construction inverts: ``B`` independent game trees
advance **one simulation per step, in lockstep, under one ``jit``**. The
engine is built to be **gather/scatter-free**: every per-game read and
write of the tree is a dense pass over fixed-shape planes. Concretely,
per simulation:

* one dense pass computes PUCT scores for the WHOLE tree (tree stats are
  frozen during a descent, so scores are valid for every level);
* each descent level reads its node row by one-hot multiply + lane-reduce
  (dense), never by gather; terminality of children is folded into the
  child plane as a code (unexpanded = -1, terminal child = -2 - idx);
* expansion writes land at the lockstep scalar slot cursor via static
  ``dynamic_update_slice`` — no scatter (see tree.py on slot burning);
* the parent->child link is a fused dense add into the child plane;
* backup is a batched one-hot matmul added to the N/W planes with
  **negamax sign alternation** — fixing defect D5 (async_mcts.rs:361-370
  applied the same value at every level);
* the NN forward pass on all B leaves is inlined (replacing the channel
  round-trip async_mcts.rs:305-315).

Intended-semantics fidelity (SURVEY.md §8): PUCT formula node.rs:352-356
verbatim (``Q + cpuct * P[a] * sqrt(N_parent + EPS) / (1 + N_child)``,
EPS = 1e-6); depth cutoff backs up ``eval_heuristic`` (async_mcts.rs:
241-243); terminal children break the descent and back up their stored
value (async_mcts.rs:246-249); masked-softmax priors with
uniform-over-valids fallback (async_mcts.rs:319-345). Cross-validated
bit-for-bit against the sequential C++ oracle (csrc/mcts_oracle.cpp).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from alphazero_tpu.config import MCTSConfig, PUCT_EPS
from alphazero_tpu.mcts.tree import (
    INVALID_P,
    PLANE_CHILD,
    PLANE_N,
    PLANE_P,
    PLANE_W,
    Tree,
    init_tree,
    np_prod,
)
from alphazero_tpu.ops import masked_policy, root_prior

# apply_fn(params, features[B, ...]) -> (logits[B, A], value[B])
ApplyFn = Callable[[Any, jax.Array], Tuple[jax.Array, jax.Array]]


def dense_puct_scores(stats: jax.Array, cpuct: float) -> jax.Array:
    """PUCT scores for every edge of every tree: f32[B, A, C]
    (node.rs:343-370 best_child, computed tree-wide in one fused pass).

    Q of an unvisited edge is 0; illegal actions (INVALID_P prior) go to
    -inf."""
    n = stats[:, PLANE_N]
    w = stats[:, PLANE_W]
    p = stats[:, PLANE_P]
    q = w / jnp.maximum(n, 1.0)
    n_parent = jnp.sum(n, axis=1, keepdims=True)
    u = cpuct * p * jnp.sqrt(n_parent + PUCT_EPS) / (1.0 + n)
    # illegal edges get a large FINITE negative: the one-hot row-select
    # multiplies unselected lanes by 0, and -inf * 0 = NaN would poison it
    return jnp.where(p <= INVALID_P * 0.5, jnp.float32(-1e30), q + u)


def _forced_root_mask(stats: jax.Array, k: float) -> jax.Array:
    """KataGo forced playouts (Wu 2020 §3.2): root children with
    n < sqrt(k * P * sum_n) must be searched. f32[B, A] 0/1 mask over the
    ROOT's actions (lane 0). P is the (noised) root prior, so
    Dirichlet-boosted moves are guaranteed a minimum of exploration."""
    n = stats[:, PLANE_N, :, 0]
    p = stats[:, PLANE_P, :, 0]
    p = jnp.where(p <= INVALID_P * 0.5, 0.0, p)
    n_total = jnp.sum(n, axis=-1, keepdims=True)
    n_forced = jnp.sqrt(k * p * n_total)
    return ((n < n_forced) & (p > 0)).astype(jnp.float32)


def pruned_root_counts(tree, k: float, cpuct: float) -> jax.Array:
    """Policy-target pruning (Wu 2020 §3.2's counterpart to the forcing):
    f32[B, A] root visit counts with the forced exploration subtracted
    back out, for use as the TRAINING TARGET (the play distribution keeps
    the raw counts).

    Per non-most-visited child: subtract up to n_forced playouts, but
    never below the count at which the child's PUCT would exceed the
    most-visited child's final PUCT (such visits were earned, not
    forced), and zero out any non-best child left with <= 1 playout."""
    stats = tree.stats
    n = stats[:, PLANE_N, :, 0]
    w = stats[:, PLANE_W, :, 0]
    p = stats[:, PLANE_P, :, 0]
    p = jnp.where(p <= INVALID_P * 0.5, 0.0, p)
    q = w / jnp.maximum(n, 1.0)
    n_total = jnp.sum(n, axis=-1, keepdims=True)
    sqrt_total = jnp.sqrt(n_total + PUCT_EPS)
    puct = jnp.where(p > 0, q + cpuct * p * sqrt_total / (1.0 + n), -jnp.inf)

    best = jnp.argmax(n, axis=-1)
    is_best = jax.nn.one_hot(best, n.shape[-1], dtype=bool)
    puct_best = jnp.sum(jnp.where(is_best, puct, 0.0), axis=-1, keepdims=True)

    n_forced = jnp.sqrt(k * p * n_total)
    # count floor where PUCT(c) == PUCT(best):  q + cpuct·p·sqrt/(1+n) = b
    gap = puct_best - q
    n_keep = jnp.where(
        gap > 0, cpuct * p * sqrt_total / jnp.maximum(gap, 1e-9) - 1.0, n
    )
    n_keep = jnp.clip(n_keep, 0.0, n)
    pruned = n - jnp.minimum(n_forced, n - n_keep)
    pruned = jnp.where(pruned <= 1.0, 0.0, pruned)
    return jnp.where(is_best, n, jnp.maximum(pruned, 0.0))


def make_engine_parts(game, apply_fn: ApplyFn, cfg: MCTSConfig, _ablate: str = ""):
    """The XLA engine's machinery, exposed for engines that share its tree
    mechanics but score differently (mcts/gumbel.py): returns a dict with
    ``select(tree, best_a_f, best_code) -> sel`` (the lockstep descent
    along per-node best-action planes) and
    ``expand_backup(params, tree, sel) -> (Tree, aux)`` (expansion + NN
    eval + negamax backup; ``aux`` carries v_nn/exp_ok/slot for engines
    that store extra per-node data). ``make_search_fn`` composes these
    with the PUCT score pass."""
    A = game.num_actions
    C = cfg.nodes
    D = cfg.max_depth
    cpuct = float(cfg.cpuct)
    # games whose cutoff heuristic is identically zero skip a full
    # state-plane pass per simulation
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
        """f32[B, C] one-hot over the lane (capacity) dim."""
        return (lane_c[None, :] == n[:, None]).astype(jnp.float32)

    def select_lane(plane2, oh):
        """Dense lane-select: [B, C] x [B, C] -> [B]."""
        return jnp.sum(plane2 * oh, axis=-1)

    def select_state(state, oh):
        """One node's game state for every tree: [B, C] one-hot -> pytree."""
        out = []
        for leaf, shape in zip(jax.tree_util.tree_leaves(state), leaf_shapes):
            acc = jnp.sum(
                leaf.astype(jnp.float32) * oh[:, None, :], axis=-1
            )
            out.append(acc.astype(leaf.dtype).reshape((oh.shape[0],) + shape))
        return jax.tree_util.tree_unflatten(t_def, out)

    def best_planes(tree: Tree, score: jax.Array):
        """Reduce dense per-edge scores to per-node best-action planes.

        Because tree statistics are frozen during a descent, the argmax is
        a function of the node alone — so ``best_a``/``best_code`` are
        reduced ONCE per simulation to [B, C] planes, and each descent
        level costs two thin lane-selects instead of full [B, A, C]
        passes. Returns (best_a f32[B, C], best_code f32[B, C])."""
        code_plane = tree.stats[:, PLANE_CHILD]  # [B, A, C]
        best_a = jnp.argmax(score, axis=1)  # [B, C]
        oh_best = (
            jnp.arange(A)[None, :, None] == best_a[:, None, :]
        ).astype(jnp.float32)
        best_code = jnp.sum(code_plane * oh_best, axis=1)  # [B, C]
        return best_a.astype(jnp.float32), best_code

    def _select(tree: Tree, best_a_f: jax.Array, best_code: jax.Array):
        """Descend every tree to its frontier along the (frozen) per-node
        best-action planes; record paths and the per-game disposition."""
        B = best_a_f.shape[0]
        bidx = jnp.arange(B)

        def cond(c):
            return jnp.any(c["active"])

        def body(c):
            oh = onehot_lane(c["node"])
            a = select_lane(best_a_f, oh).astype(jnp.int32)
            code = select_lane(best_code, oh)

            active = c["active"]
            slot = jnp.where(active, c["depth"], D)
            path_n = c["path_n"].at[bidx, slot].set(c["node"], mode="drop")
            path_a = c["path_a"].at[bidx, slot].set(a, mode="drop")
            depth1 = c["depth"] + 1

            unexp = code < -0.5
            cterm = code < -1.5  # terminal child: code = -2 - idx
            unexp = unexp & ~cterm
            child = jnp.where(cterm, -2.0 - code, code).astype(jnp.int32)
            cutoff = ~unexp & ~cterm & (depth1 >= D)
            go = active & ~unexp & ~cterm & ~cutoff

            exp_now = active & unexp
            stop_leaf = active & (cterm | cutoff)
            return {
                "node": jnp.where(go, child, c["node"]),
                "depth": jnp.where(active, depth1, c["depth"]),
                "active": go,
                "path_n": path_n,
                "path_a": path_a,
                "exp_mask": c["exp_mask"] | exp_now,
                "exp_parent": jnp.where(exp_now, c["node"], c["exp_parent"]),
                "exp_action": jnp.where(exp_now, a, c["exp_action"]),
                "term_mask": c["term_mask"] | (active & cterm),
                "cut_mask": c["cut_mask"] | (active & cutoff),
                "leaf_node": jnp.where(stop_leaf, child, c["leaf_node"]),
            }

        init = {
            "node": jnp.zeros((B,), jnp.int32),
            "depth": jnp.zeros((B,), jnp.int32),
            "active": tree.node[:, 0, 0] < 0.5,  # terminal roots never search
            "path_n": jnp.zeros((B, D), jnp.int32),
            "path_a": jnp.zeros((B, D), jnp.int32),
            "exp_mask": jnp.zeros((B,), bool),
            "exp_parent": jnp.zeros((B,), jnp.int32),
            "exp_action": jnp.zeros((B,), jnp.int32),
            "term_mask": jnp.zeros((B,), bool),
            "cut_mask": jnp.zeros((B,), bool),
            "leaf_node": jnp.zeros((B,), jnp.int32),
        }
        return jax.lax.while_loop(cond, body, init)

    def expand_backup(params, tree: Tree, sel, probe=jnp.float32(0.0)):
        """Expansion + fused NN evaluation + negamax backup for a finished
        descent ``sel`` — the engine's write half, shared by every scoring
        rule. Returns ``(Tree, aux)`` with aux = (exp_ok, slot, v_nn)."""
        B = tree.stats.shape[0]
        # ---- EXPAND (async_mcts.rs:279-356, minus the lock protocol) ----
        oh_parent = onehot_lane(sel["exp_parent"])
        parent_state = select_state(tree.state, oh_parent)
        if _ablate == "2xboard":
            alt = select_state(tree.state, onehot_lane((sel["exp_parent"] + 1) % C))
            probe = probe + jax.tree_util.tree_leaves(alt)[0].astype(jnp.float32).sum()
        new_state = step_v(parent_state, sel["exp_action"])
        new_valid = valid_v(new_state)
        new_done, new_tval = term_v(new_state)

        s = tree.cursor  # i32[B] per-game slot (lockstep +1 per sim)
        exp_ok = sel["exp_mask"] & (s < C)

        # ---- EVALUATE: NN fused into the step (vs async_mcts.rs:305-315's
        # channel round-trip to the inference service thread) ----
        if getattr(apply_fn, "needs_features", True):
            feats = feat_v(new_state)
        else:
            feats = jnp.zeros((B, 1), jnp.float32)
        logits, v_nn = apply_fn(params, feats)
        prior = masked_policy(logits, new_valid)
        p_masked = jnp.where(new_valid, prior, INVALID_P)

        # All tree writes are dense streaming passes (no dynamic-update
        # surgery on the lane dim, which degrades to tile read-modify-write):
        # the slot-row install, the parent->child link and the backup add
        # below fuse into ONE pass over `stats`.
        mask_slot = lane_c[None, :] == s[:, None]               # [B,C]
        write_mask = (
            exp_ok[:, None, None, None] & mask_slot[:, None, None, :]
        )  # [B,1,1,C]
        new_row4 = jnp.stack(
            [
                jnp.zeros_like(prior),
                jnp.zeros_like(prior),
                p_masked,
                jnp.full_like(prior, -1.0),
            ],
            axis=1,
        )  # [B, 4, A]
        stats = jnp.where(write_mask, new_row4[:, :, :, None], tree.stats)

        node_mask = exp_ok[:, None, None] & mask_slot[:, None, :]
        new_info = jnp.stack([new_done.astype(jnp.float32), new_tval], axis=1)
        node = jnp.where(node_mask, new_info[:, :, None], tree.node)

        state_leaves = []
        for leaf, x, shape in zip(
            jax.tree_util.tree_leaves(tree.state),
            jax.tree_util.tree_leaves(new_state),
            leaf_shapes,
        ):
            L = np_prod(shape)
            state_leaves.append(
                jnp.where(
                    node_mask[:, :1],  # [B,1,C]
                    x.reshape(B, L, 1).astype(leaf.dtype),
                    leaf,
                )
            )
        state = jax.tree_util.tree_unflatten(t_def, state_leaves)

        # parent -> child link: dense add into the child-code plane.
        # unexpanded slots hold exactly -1, so adding (code + 1) sets them.
        # (The backup-path lanes and the slot lane are disjoint from the
        # link's (parent, action) lane, so the fused adds commute.)
        s_f = s.astype(jnp.float32)
        link_code = jnp.where(new_done, -2.0 - s_f, s_f)
        oh_a = (
            jnp.arange(A)[None, :] == sel["exp_action"][:, None]
        ).astype(jnp.float32)
        link_add = (
            (link_code + 1.0) * exp_ok.astype(jnp.float32)
        )[:, None, None] * oh_a[:, :, None] * oh_parent[:, None, :]

        count = tree.count + exp_ok.astype(jnp.int32)
        cursor = s + 1

        # leaf value, from the leaf's player-to-move perspective
        v_expand = jnp.where(new_done, new_tval, v_nn)
        oh_leaf = onehot_lane(sel["leaf_node"])
        v_term = select_lane(tree.node[:, 1], oh_leaf)
        if zero_heuristic:
            v_cut = jnp.zeros((B,), jnp.float32)
        else:
            v_cut = heur_v(select_state(tree.state, oh_leaf))
        v_leaf = jnp.where(
            sel["exp_mask"],
            v_expand,
            jnp.where(sel["term_mask"], v_term, v_cut),
        )

        # ---- BACKUP: batched one-hot matmul into the N/W planes with
        # negamax alternation (fixing D5; replaces the per-node atomic
        # unvisit walk, async_mcts.rs:361-370 / node.rs:83-92) ----
        depth = sel["depth"]  # number of edges on the path
        did_sim = sel["exp_mask"] | sel["term_mask"] | sel["cut_mask"]
        d_pos = jnp.arange(D)[None, :]
        on_path = ((d_pos < depth[:, None]) & did_sim[:, None]).astype(jnp.float32)
        # edge d's node player sits (depth - d) plies above the leaf:
        # odd distance flips the sign once.
        sign = jnp.where((depth[:, None] - d_pos) % 2 == 1, -1.0, 1.0)
        coeff = jnp.stack([on_path, sign * v_leaf[:, None] * on_path], axis=1)  # [B,2,D]
        oh_pa = (
            jnp.arange(A)[None, None, :] == sel["path_a"][:, :, None]
        ).astype(jnp.float32)  # [B, D, A]
        oh_pn = (
            lane_c[None, None, :] == sel["path_n"][:, :, None]
        ).astype(jnp.bfloat16)  # [B, D, C] (exact 0/1)
        # HIGHEST: the f32 leaf values must reach the W planes unrounded
        # (a GPU runs a DEFAULT-precision f32 dot in TF32, which keeps
        # ~3 decimal digits and would split CPU and GPU search results)
        upd = jnp.einsum(
            "bkda,bdc->bkac",
            coeff[:, :, :, None] * oh_pa[:, None, :, :],
            oh_pn,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [B, 2, A, C]
        if _ablate == "2xbackup":
            upd2 = jnp.einsum(
                "bkda,bdc->bkac",
                (coeff * (1 + 1e-7))[:, :, :, None] * oh_pa[:, None, :, :],
                oh_pn,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            probe = probe + upd2[:, 0, 0, 0].sum()
        # one fused add pass over stats: backup (N|W planes) + child link
        zeros_p = jnp.zeros((B, 1, A, C), jnp.float32)
        stats = stats + jnp.concatenate(
            [upd, zeros_p, link_add[:, None]], axis=1
        )

        node = node.at[:, 1, 0].add(1e-20 * probe / (1e20 + jnp.abs(probe)))
        out = Tree(stats=stats, node=node, state=state, count=count, cursor=cursor)
        return out, (exp_ok, s, v_nn)

    def _simulate(params, tree: Tree) -> Tree:
        """One simulation for every game: select -> expand -> evaluate ->
        backup (the vectorized search_iteration, async_mcts.rs:219-371)."""
        score = dense_puct_scores(tree.stats, cpuct)
        best_a_f, best_code = best_planes(tree, score)
        sel = _select(tree, best_a_f, best_code)

        # perf-attribution knobs: duplicate one stage with an epsilon
        # perturbation (defeats CSE) and fold it in at 1e-20 weight (a
        # numerical no-op); the marginal steady-state time is that stage's
        # cost under full dynamics.
        probe = jnp.float32(0.0)
        if _ablate == "2xscore":
            probe = dense_puct_scores(tree.stats, cpuct * (1 + 1e-7))[:, 0, 0].sum()
        elif _ablate == "2xselect":
            a2, c2 = best_planes(tree, score * (1 + 1e-7))
            probe = _select(tree, a2, c2)["depth"].sum().astype(jnp.float32)

        tree, _ = expand_backup(params, tree, sel, probe)
        return tree

    return {
        "A": A,
        "C": C,
        "D": D,
        "zero_heuristic": zero_heuristic,
        "onehot_lane": onehot_lane,
        "select_lane": select_lane,
        "select_state": select_state,
        "best_planes": best_planes,
        "select": _select,
        "expand_backup": expand_backup,
        "simulate": _simulate,
    }


def make_search_fn(
    game,
    apply_fn: ApplyFn,
    cfg: MCTSConfig,
    _ablate: str = "",
):
    """Build ``search(params, root_state, rng) -> Tree``.

    ``root_state`` is a batched game-state pytree (leaves ``[B, ...]``).
    The returned function is jit/vmap/shard_map-friendly: fixed shapes,
    ``lax`` control flow only. Root priors are installed up front
    (async_mcts.rs's intended first-expansion of the root, defect D1), with
    optional Dirichlet exploration noise (not present in the reference;
    off by default).
    """
    A = game.num_actions
    C = cfg.nodes
    parts = make_engine_parts(game, apply_fn, cfg, _ablate)
    _simulate = parts["simulate"]

    forced_k = getattr(cfg, "forced_playouts", None)
    if forced_k is not None:
        best_planes = parts["best_planes"]
        _select_parts = parts["select"]
        expand_backup = parts["expand_backup"]
        lane0 = (jnp.arange(C) == 0).astype(jnp.float32)  # root is lane 0

        def _simulate(params, tree):
            # forced children outrank every real PUCT score at the root;
            # ties among forced resolve by their underlying PUCT
            score = dense_puct_scores(tree.stats, cfg.cpuct)
            bonus = _forced_root_mask(tree.stats, float(forced_k))
            score = score + 1e9 * bonus[:, :, None] * lane0
            best_a_f, best_code = best_planes(tree, score)
            sel = _select_parts(tree, best_a_f, best_code)
            tree, _ = expand_backup(params, tree, sel)
            return tree

    def search(
        params,
        root_state: Any,
        rng: Optional[jax.Array] = None,
        num_sims: Optional[int] = None,
    ) -> Tree:
        sims = cfg.num_sims if num_sims is None else num_sims
        tree = init_tree(game, root_state, C)

        # install root prior (the intended-but-broken first root expansion,
        # defect D1) + optional Dirichlet noise
        prior, root_valid = root_prior(game, apply_fn, cfg, params, root_state, rng)
        p_masked = jnp.where(root_valid, prior, INVALID_P)
        tree = tree._replace(stats=tree.stats.at[:, PLANE_P, :, 0].set(p_masked))

        return jax.lax.fori_loop(0, sims, lambda i, t: _simulate(params, t), tree)

    def search_from(
        params,
        tree: Tree,
        root_state: Any,
        rng: Optional[jax.Array] = None,
        reused: Optional[jax.Array] = None,
        num_sims: Optional[int] = None,
    ) -> Tree:
        """Continue searching an EXISTING tree (the tree-reuse path,
        reference coach.rs:104-157: one AsyncMcts per episode keeps its
        statistics across moves and re-roots via lookup_state_id,
        async_mcts.rs:81).

        ``tree`` is a re-rooted (root = lane 0) or freshly-initialized
        Tree over ``root_state``; ``reused`` flags the games whose root
        already carries an installed prior from its original expansion —
        those keep it (the reference never re-evaluated a reused root).
        Fresh games get the NN root prior. With ``dirichlet_alpha`` set,
        fresh noise is re-mixed into EVERY root each move (the standard
        AlphaZero-with-reuse behavior; the base prior for reused roots is
        their stored expansion prior)."""
        import dataclasses as _dc

        sims = cfg.num_sims if num_sims is None else num_sims
        cfg_plain = _dc.replace(cfg, dirichlet_alpha=None)
        base, root_valid = root_prior(
            game, apply_fn, cfg_plain, params, root_state, None
        )
        if reused is not None:
            stored = tree.stats[:, PLANE_P, :, 0]
            stored_prior = jnp.where(stored > INVALID_P * 0.5, stored, 0.0)
            base = jnp.where(reused[:, None], stored_prior, base)
        if cfg.dirichlet_alpha is not None:
            if rng is None:
                raise ValueError("dirichlet noise requires an rng key")
            noise = jax.random.dirichlet(
                rng, jnp.full((A,), cfg.dirichlet_alpha), base.shape[:1]
            )
            noise = masked_policy(jnp.log(noise + 1e-12), root_valid)
            base = (1.0 - cfg.dirichlet_frac) * base + cfg.dirichlet_frac * noise
        p_masked = jnp.where(root_valid, base, INVALID_P)
        tree = tree._replace(stats=tree.stats.at[:, PLANE_P, :, 0].set(p_masked))
        return jax.lax.fori_loop(0, sims, lambda i, t: _simulate(params, t), tree)

    search.from_tree = search_from
    return search
