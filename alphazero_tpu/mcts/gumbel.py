"""Gumbel sequential-halving search — the low-simulation opt-in engine.

Implements "Policy improvement by planning with Gumbel" (Danihelka,
Guez, Schrittwieser & Silver, ICLR 2022) on the batched array tree. The
reference has no equivalent (its root rule is plain PUCT,
reference: src/node.rs:343-370); this engine is the framework's extension
for simulation-starved deployments: with n simulations it guarantees a
policy improvement over the raw prior, where PUCT at small n can pick
actions the NN value head already refutes.

The algorithm, mapped onto the lockstep engine (mcts/search.py):

* **Root**: sample Gumbel noise ``g[a]`` once per search. Simulations
  follow a *sequential-halving* schedule: the top ``m`` actions by
  ``g + logits`` are visited equally, then the half with the best
  ``g + logits + sigma(q̂)`` survives, budget rebalanced, until one action
  remains. The schedule is a precomputed table (``considered_visit_table``)
  indexed by the simulation counter — at sim ``i`` an action is *due* iff
  its root visit count equals the table entry, and the due action with the
  best score is searched. This is exactly the fixed-budget schedule of the
  paper's Algorithm 2, made data-independent so it jits.
* **Interior nodes**: the paper's deterministic selection — visit the
  action maximising ``pi'(a) - N(a) / (1 + sum_b N(b))`` where
  ``pi' = softmax(logits + sigma(completedQ))`` — computed DENSELY for the
  whole tree per simulation, exactly like the PUCT engine's score pass
  (tree stats are frozen during a descent, so per-node argmax planes are
  valid at every level and the descent stays gather-free).
* ``completedQ``: visited edges keep ``Q = W/N``; unvisited edges take the
  *mixed value* estimate ``(v_node + sum_N * weightedQ) / (sum_N + 1)``
  (paper §4 / App. D). ``v_node`` (each node's own NN value) is the one
  statistic the PUCT tree does not store — kept here in a ``vraw f32[B, C]``
  side plane written at expansion time.
* ``sigma(q) = (c_visit + maxN) * c_scale * q`` on per-node [0, 1]-rescaled
  completed values (the paper's monotone transform with its published
  defaults c_visit=50, c_scale=0.1-on-rescaled-values).

The search returns the recommended action (the halving winner — play it
directly, no temperature sampling: exploration comes from the Gumbel
sample) and the **improved policy** ``pi'`` at the root, which is the
training target (a better target than normalized visit counts at small n).

Descent, expansion, NN fusion and negamax backup are shared with the XLA
engine via ``make_engine_parts`` — this module only swaps the scoring rule,
so the tree mechanics stay oracle-verified.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from alphazero_tpu.config import MCTSConfig
from alphazero_tpu.mcts.search import ApplyFn, make_engine_parts
from alphazero_tpu.mcts.tree import (
    INVALID_P,
    PLANE_N,
    PLANE_P,
    PLANE_W,
    Tree,
    init_tree,
)
from alphazero_tpu.ops import masked_policy

# python float, not a jnp scalar: a module-level jnp constant would
# initialize the backend at import time (see ops/policy.py)
_NEG = -1e30


def considered_visit_sequence(m: int, n: int) -> list:
    """The sequential-halving visit schedule for ``m`` considered actions
    and ``n`` simulations (paper Algorithm 2 with the fixed-budget
    extension of App. A): each phase gives every surviving action
    ``max(1, floor(n / (ceil(log2 m) * m_phase)))`` extra visits, then
    halves the survivor set (never below 2) until the budget is spent.

    Entry ``i`` is the visit count an action must currently have to be
    *due* at simulation ``i`` — so the runtime rule "search the due action
    with the best score" replays this schedule without any dynamic set."""
    if m <= 1:
        return list(range(n))
    log2m = max(1, math.ceil(math.log2(m)))
    seq: list = []
    visits = [0] * m
    considered = m
    while len(seq) < n:
        extra = max(1, n // (log2m * considered))
        for _ in range(extra):
            seq.extend(visits[:considered])
            for j in range(considered):
                visits[j] += 1
        considered = max(2, considered // 2)
    return seq[:n]


def considered_visit_table(top_m: int, n: int) -> np.ndarray:
    """i32[top_m + 1, n] — row ``m`` is the schedule for ``m`` considered
    actions (rows 0/1: a single action revisited every simulation). Games
    with fewer legal actions than ``top_m`` index their own row, so a game
    with 2 legal moves splits the whole budget between them."""
    return np.asarray(
        [considered_visit_sequence(m, n) for m in range(top_m + 1)],
        np.int32,
    )


class GumbelResult(NamedTuple):
    tree: Tree
    vraw: jax.Array         # f32[B, C] per-node NN value (own to-move persp.)
    gumbel: jax.Array       # f32[B, A] the root Gumbel sample (zeros = eval mode)
    action: jax.Array       # i32[B] sequential-halving winner — play this
    improved_pi: jax.Array  # f32[B, A] root pi' = softmax(logits + sigma(cQ))
    #                         — the policy training target


def make_gumbel_search_fn(game, apply_fn: ApplyFn, cfg: MCTSConfig):
    """Build ``gsearch(params, root_state, rng, num_sims) -> GumbelResult``.

    ``rng=None`` runs in *evaluation mode*: the Gumbel sample is zero, so
    root selection and the final recommendation are the deterministic
    argmax of ``logits + sigma(q̂)`` (the paper's match-play setting).
    """
    A = game.num_actions
    C = cfg.nodes
    top_m = max(1, min(int(getattr(cfg, "gumbel_top_m", 16)), A))
    c_visit = float(getattr(cfg, "gumbel_c_visit", 50.0))
    c_scale = float(getattr(cfg, "gumbel_value_scale", 0.1))
    if cfg.dirichlet_alpha is not None:
        raise ValueError(
            "gumbel search replaces Dirichlet root noise (exploration is "
            "the Gumbel sample) — set dirichlet_alpha=None"
        )

    parts = make_engine_parts(game, apply_fn, cfg)
    feat_v = jax.vmap(game.to_features)
    valid_v = jax.vmap(game.valid_moves)
    lane_c = jnp.arange(C)

    def completed_scores(tree: Tree, vraw: jax.Array):
        """Dense per-node improved policy + interior scores, whole tree.

        Returns ``(score f32[B, A, C], logits, sigma, legal, n)`` where the
        non-root planes of ``score`` already carry the paper's
        deterministic interior rule and lane 0 is overwritten by the caller
        with the root rule (which needs the simulation index)."""
        n = tree.stats[:, PLANE_N]        # [B, A, C]
        w = tree.stats[:, PLANE_W]
        p_raw = tree.stats[:, PLANE_P]
        legal = p_raw > INVALID_P * 0.5
        p = jnp.where(legal, p_raw, 0.0)
        q = w / jnp.maximum(n, 1.0)
        vis = (n > 0.5).astype(jnp.float32)

        sum_n = jnp.sum(n, axis=1)        # [B, C]
        sum_pv = jnp.sum(p * vis, axis=1)
        wq = jnp.sum(p * vis * q, axis=1) / jnp.maximum(sum_pv, 1e-8)
        v_mix = (vraw + sum_n * wq) / (sum_n + 1.0)          # [B, C]
        cq = jnp.where(n > 0.5, q, v_mix[:, None, :])        # [B, A, C]

        # per-node rescale of completed values to [0, 1] (paper App. D's
        # normalized q̂; constant nodes — all-unvisited — rescale to 0, so
        # sigma vanishes and pi' falls back to the prior)
        cq_min = jnp.min(cq, axis=1, keepdims=True)
        cq_max = jnp.max(cq, axis=1, keepdims=True)
        cq = (cq - cq_min) / jnp.maximum(cq_max - cq_min, 1e-8)

        maxn = jnp.max(n, axis=1)         # [B, C]
        sigma = (c_visit + maxn)[:, None, :] * c_scale * cq
        logits = jnp.where(legal, jnp.log(jnp.maximum(p, 1e-30)), _NEG)

        # pi' = masked softmax over actions of logits + sigma
        z = jnp.where(legal, logits + sigma, _NEG)
        z = z - jnp.max(z, axis=1, keepdims=True)
        e = jnp.where(legal, jnp.exp(z), 0.0)
        pi_imp = e / jnp.maximum(jnp.sum(e, axis=1, keepdims=True), 1e-30)

        score = pi_imp - n / (1.0 + sum_n[:, None, :])
        score = jnp.where(legal, score, _NEG)
        return score, logits, sigma, legal, n, pi_imp

    def root_scores(table: jax.Array, i, gumbel, logits0, sigma0, legal0, n0):
        """The root rule at simulation ``i``: among actions whose visit
        count matches the schedule, argmax of ``g + logits + sigma(q̂)``."""
        num_legal = jnp.sum(legal0, axis=1).astype(jnp.int32)  # [B]
        m_eff = jnp.clip(num_legal, 1, top_m)
        col = jax.lax.dynamic_slice_in_dim(table, i, 1, axis=1)[:, 0]
        oh_m = jnp.arange(top_m + 1)[None, :] == m_eff[:, None]
        cv = jnp.sum(jnp.where(oh_m, col[None, :], 0), axis=1)  # i32[B]
        due = jnp.abs(n0 - cv[:, None].astype(jnp.float32)) < 0.5
        base = gumbel + logits0 + sigma0
        return jnp.where(legal0 & due, base, _NEG)

    def search(
        params,
        root_state: Any,
        rng: Optional[jax.Array] = None,
        num_sims: Optional[int] = None,
    ) -> GumbelResult:
        sims = cfg.num_sims if num_sims is None else num_sims
        table = jnp.asarray(considered_visit_table(top_m, max(sims, 1)))

        leaves = jax.tree_util.tree_leaves(root_state)
        B = leaves[0].shape[0]
        tree = init_tree(game, root_state, C)

        valid = valid_v(root_state)
        if getattr(apply_fn, "needs_features", True):
            feats = feat_v(root_state)
        else:
            feats = jnp.zeros((B, 1), jnp.float32)
        logits_nn, v0 = apply_fn(params, feats)
        prior = masked_policy(logits_nn, valid)
        p_masked = jnp.where(valid, prior, INVALID_P)
        tree = tree._replace(
            stats=tree.stats.at[:, PLANE_P, :, 0].set(p_masked)
        )
        vraw = jnp.zeros((B, C), jnp.float32).at[:, 0].set(v0)

        if rng is None:
            gumbel = jnp.zeros((B, A), jnp.float32)
        else:
            gumbel = jax.random.gumbel(rng, (B, A), jnp.float32)

        def body(i, carry):
            tree, vraw = carry
            score, logits, sigma, legal, n, _ = completed_scores(tree, vraw)
            rs = root_scores(
                table, i, gumbel,
                logits[:, :, 0], sigma[:, :, 0], legal[:, :, 0], n[:, :, 0],
            )
            score = score.at[:, :, 0].set(rs)
            best_a_f, best_code = parts["best_planes"](tree, score)
            sel = parts["select"](tree, best_a_f, best_code)
            tree, (exp_ok, slot, v_nn) = parts["expand_backup"](params, tree, sel)
            mask_slot = lane_c[None, :] == slot[:, None]
            vraw = jnp.where(
                exp_ok[:, None] & mask_slot, v_nn[:, None], vraw
            )
            return tree, vraw

        tree, vraw = jax.lax.fori_loop(0, sims, body, (tree, vraw))

        # final recommendation: among the max-visited root actions (the
        # halving survivors), argmax of g + logits + sigma(q̂)
        _, logits, sigma, legal, n, pi_imp = completed_scores(tree, vraw)
        logits0, sigma0 = logits[:, :, 0], sigma[:, :, 0]
        legal0, n0 = legal[:, :, 0], n[:, :, 0]
        maxn0 = jnp.max(jnp.where(legal0, n0, -1.0), axis=1, keepdims=True)
        due = legal0 & (n0 >= maxn0 - 0.5)
        fin = jnp.where(due, gumbel + logits0 + sigma0, _NEG)
        action = jnp.argmax(fin, axis=1).astype(jnp.int32)

        return GumbelResult(
            tree=tree,
            vraw=vraw,
            gumbel=gumbel,
            action=action,
            improved_pi=pi_imp[:, :, 0],
        )

    search._completed_scores = completed_scores  # test/diagnostic surface
    return search
