"""Coach — the self-play / train / gate outer loop.

Re-design of the reference's orchestrator (reference: src/coach.rs:18-397).
Per iteration (coach.rs:169-396):

  (a) self-play  — one jitted batched run replaces ``num_eps`` rayon
      episodes with fresh AsyncMcts each (coach.rs:240-272);
  (b) replay     — on-device ring insert with fused symmetry augmentation
      replaces deque trimming + bincode save (coach.rs:275-293);
  (c) train      — the candidate starts from the incumbent and takes
      ``steps_per_iteration`` minibatch steps in ONE jitted scan (replacing
      the flatten/shuffle/AOS->SOA pass + the tx_train channel hop into the
      service thread, coach.rs:296-329);
  (d) arena gate — batched candidate-vs-incumbent with seating swap;
      accept iff win-rate >= update_threshold (coach.rs:332-390), with an
      Elo tracker on top;
  (e) checkpoint — whole-state save (params+opt+replay+rng+counters),
      exact resume (vs. examples-only persistence, coach.rs:55-81).

Model versioning: integer ``model_id`` increments only on acceptance, and
the incumbent/candidate are two resident TrainStates — no checkpoint
reloads mid-run (python_nnet.rs:65-75's mechanism) and no mixed-model
inference batches (defect D8 is structurally impossible).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from alphazero_tpu.arena import gate, make_arena_fn
from alphazero_tpu.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from alphazero_tpu.config import AZConfig, MCTSConfig
from alphazero_tpu.models.nets import make_apply_fn
from alphazero_tpu.replay import (
    replay_init,
    replay_insert,
    replay_sample,
    replay_total,
)
from alphazero_tpu.selfplay import make_selfplay_fn
from alphazero_tpu.train import TrainState, init_train_state, make_train_step, variables_of
from alphazero_tpu.utils import EloTracker, MetricsLogger, PhaseTimer


def _gen_key(k):
    """JSON round-trip for match-graph player keys (int generation ids or
    the literal 'anchor')."""
    if isinstance(k, str) and k.startswith("anchor"):
        return k  # "anchor" or a ladder rung "anchor@SIMS"
    return int(k)


def make_train_phase(model, tcfg, steps: int, game=None):
    """Whole training phase under one jit: scan over minibatch steps, each
    sampling the (device-resident) replay with its own key."""
    train_step = make_train_step(model, tcfg)

    def phase(tstate: TrainState, replay, rng):
        def body(ts, key):
            k_sample, k_drop = jax.random.split(key)
            feats, pi_t, v_t = replay_sample(
                replay, k_sample, tcfg.batch_size, game
            )
            ts, metrics = train_step(ts, feats, pi_t, v_t, k_drop)
            return ts, metrics.loss

        keys = jax.random.split(rng, steps)
        tstate, losses = jax.lax.scan(body, tstate, keys)
        return tstate, losses

    return phase


class Coach:
    """Host-side driver over jitted phases (the L4 orchestration layer).

    ``mesh`` turns every phase into a sharded SPMD program (BASELINE
    config 5): self-play games, replay slots and learner minibatches live
    on the ``data`` axis (gradient means become XLA-inserted psum), parameters are tensor-parallel on the ``model`` axis where
    divisible (see parallel/param_shardings) and replicated otherwise.
    Multi-host is the same code under ``jax.distributed.initialize``."""

    def __init__(self, game, model, cfg: AZConfig, mesh=None):
        self.game = game
        self.model = model
        self.cfg = cfg
        self.mesh = mesh

        apply_fn = make_apply_fn(model)
        self._eval_folded = bool(getattr(apply_fn, "folded", False))

        self.rng = jax.random.key(cfg.seed)
        init_state_fn = lambda: init_train_state(
            model, jax.random.key(cfg.seed + 1), game.feature_shape, cfg.train
        )
        init_replay_fn = lambda: replay_init(game, cfg.replay)

        rz_cfg = cfg.reanalyze
        self._recycle = bool(getattr(cfg.selfplay, "recycle", False))
        init_actor_fn = None
        if self._recycle:
            if rz_cfg is not None:
                raise ValueError(
                    "selfplay.recycle is incompatible with reanalyze "
                    "(the position ring records the fixed scan's [T, B] "
                    "root states)"
                )
            from alphazero_tpu.selfplay import make_recycling_selfplay_fn

            init_actor_fn, sp_fn = make_recycling_selfplay_fn(
                game, apply_fn, cfg.mcts, cfg.selfplay
            )
        else:
            sp_fn = make_selfplay_fn(
                game, apply_fn, cfg.mcts, cfg.selfplay, mesh=mesh,
                record_states=rz_cfg is not None,
            )
        insert_fn = lambda r, t: replay_insert(r, game, t)
        if rz_cfg is not None:
            from alphazero_tpu.reanalyze import (
                make_reanalyze_fn, position_init, position_insert,
            )

            rz_fn = make_reanalyze_fn(game, apply_fn, cfg.mcts, rz_cfg)
            pos_init_fn = lambda: position_init(game, rz_cfg.capacity)
        train_fn = make_train_phase(
            model, cfg.train, cfg.train.steps_per_iteration, game=game
        )
        # arena evaluation is noise-free greedy play: strip root Dirichlet
        # (with it, the search would demand an rng the arena never
        # supplies) and forced playouts (a training-target device — it
        # deliberately distorts visit counts the arena would play from)
        arena_cfg = dataclasses.replace(
            cfg.mcts,
            num_sims=cfg.arena.num_sims or cfg.mcts.num_sims,
            dirichlet_alpha=None,
            forced_playouts=None,
        )

        self.positions = None
        self._reanalyze = None
        self.actor_carry = None
        if mesh is None:
            self.incumbent = init_state_fn()
            self.replay = init_replay_fn()
            if self._recycle:
                self.actor_carry = jax.jit(init_actor_fn)()
                # the carry-in buffers are dead after the call — donating
                # them saves a fragment-buffer copy per iteration
                self._selfplay = jax.jit(sp_fn, donate_argnums=1)
            else:
                self._selfplay = jax.jit(sp_fn)
            # the pre-insert buffer is dead after the call — donating it
            # saves a full replay-capacity copy (hundreds of MB of HBM
            # traffic per iteration at production sizes)
            self._insert = jax.jit(insert_fn, donate_argnums=0)
            self._train_phase = jax.jit(train_fn)
            if rz_cfg is not None:
                import functools

                self.positions = pos_init_fn()
                self._reanalyze = jax.jit(rz_fn)
                self._pos_insert = jax.jit(
                    functools.partial(
                        position_insert, stride=rz_cfg.record_stride
                    ),
                    donate_argnums=0,
                )
            arena_sharding = None
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from alphazero_tpu.parallel import param_shardings
            from alphazero_tpu.replay import ReplayState

            data_tb = NamedSharding(mesh, P(None, "data"))  # [T, B, ...]
            data_b = NamedSharding(mesh, P("data"))         # [B/Cap, ...]
            repl = NamedSharding(mesh, P())

            state_sd = jax.eval_shape(init_state_fn)
            tstate_sh = TrainState(
                params=param_shardings(mesh, state_sd.params),
                batch_stats=param_shardings(mesh, state_sd.batch_stats),
                opt_state=jax.tree_util.tree_map(
                    lambda _: repl, state_sd.opt_state
                ),
                step=repl,
            )
            replay_sh = ReplayState(
                data=data_b, pos=repl, size=repl, total=repl,
            )
            # jit-create the live state directly under its shardings: the
            # outputs are global arrays, which makes the same code correct
            # under multi-controller jax.distributed (a host-side
            # device_put of process-local arrays would not be)
            self.incumbent = jax.jit(init_state_fn, out_shardings=tstate_sh)()
            self.replay = jax.jit(init_replay_fn, out_shardings=replay_sh)()

            if self._recycle:
                from alphazero_tpu.selfplay import ActorCarry

                carry_sd = jax.eval_shape(init_actor_fn)
                carry_sh = ActorCarry(
                    state=jax.tree_util.tree_map(
                        lambda _: data_b, carry_sd.state
                    ),
                    move_count=data_b,
                    # fragment buffers are [M, B, ...] like the trajectory
                    frag_features=data_tb,
                    frag_pi=data_tb,
                )
                self.actor_carry = jax.jit(
                    init_actor_fn, out_shardings=carry_sh
                )()
                sp_sd = jax.eval_shape(
                    sp_fn,
                    variables_of(self.incumbent),
                    carry_sd,
                    jax.random.key(0),
                )
                sp_sh = (
                    carry_sh,
                    jax.tree_util.tree_map(lambda _: data_tb, sp_sd[1]),
                    jax.tree_util.tree_map(lambda _: data_b, sp_sd[2]),
                )
                self._selfplay = jax.jit(
                    sp_fn, out_shardings=sp_sh, donate_argnums=1
                )
            else:
                sp_sd = jax.eval_shape(
                    sp_fn, variables_of(self.incumbent), jax.random.key(0)
                )
                sp_sh = (
                    jax.tree_util.tree_map(lambda _: data_tb, sp_sd[0]),
                    jax.tree_util.tree_map(lambda _: data_b, sp_sd[1]),
                )
                if rz_cfg is not None:
                    # recorded root states are [T, B, ...] like the
                    # trajectory
                    sp_sh = sp_sh + (
                        jax.tree_util.tree_map(lambda _: data_tb, sp_sd[2]),
                    )
                self._selfplay = jax.jit(sp_fn, out_shardings=sp_sh)
            self._insert = jax.jit(
                insert_fn, out_shardings=replay_sh, donate_argnums=0
            )
            if rz_cfg is not None:
                from alphazero_tpu.reanalyze import PositionStore

                import functools

                pos_sd = jax.eval_shape(pos_init_fn)
                pos_sh = PositionStore(
                    states=jax.tree_util.tree_map(
                        lambda _: data_b, pos_sd.states
                    ),
                    value=data_b,
                    born=data_b,
                    pos=repl,
                    size=repl,
                )
                self.positions = jax.jit(pos_init_fn, out_shardings=pos_sh)()
                self._reanalyze = jax.jit(
                    rz_fn,
                    out_shardings=(
                        jax.tree_util.tree_map(lambda _: data_tb, jax.eval_shape(
                            rz_fn, variables_of(self.incumbent),
                            pos_sd, jax.random.key(0), 0,
                        )[0]),
                        repl,
                        repl,
                    ),
                )
                self._pos_insert = jax.jit(
                    functools.partial(
                        position_insert, stride=rz_cfg.record_stride
                    ),
                    out_shardings=pos_sh,
                    donate_argnums=0,
                )
            self._train_phase = jax.jit(
                train_fn, out_shardings=(tstate_sh, repl)
            )
            arena_sharding = data_b

        self._arena = jax.jit(
            make_arena_fn(
                game,
                apply_fn,
                apply_fn,
                arena_cfg,
                cfg.arena.num_games,
                state_sharding=arena_sharding,
            )
        )
        self._anchor_arena = None
        if cfg.arena.anchor_interval:
            from alphazero_tpu.models import make_uniform_model

            # the anchored-rating pass is a STANDARDIZED protocol: the
            # pure-MCTS anchor (and the incumbent, in this pass only)
            # always plays exact-PUCT K=1 on the pure tree, whatever
            # engine training uses — otherwise the anchor's strength
            # (pinned at Elo 0) would silently shift with the training
            # engine (gumbel, the DAG's +32 Elo at 400 sims) and anchored
            # curves would stop being comparable across runs.
            anchor_cfg = dataclasses.replace(
                arena_cfg, gumbel=False, transposition=False
            )
            self._anchor_arena = jax.jit(
                make_arena_fn(
                    game,
                    apply_fn,
                    make_uniform_model(game).apply_fn,
                    anchor_cfg,
                    cfg.arena.num_games,
                    state_sharding=arena_sharding,
                )
            )
            # anchor-ladder rungs (ArenaConfig.anchor_ladder): fixed
            # pure-MCTS agents at higher budgets. The strongest rung is
            # where generation 1 actually lands once the base anchor is
            # swept from the very first pass (measured round 5) — without
            # it the gauge chain has no informative first link. Each rung
            # gets an incumbent arena (net@anchor-sims vs uniform@rung-
            # sims) and a chain arena from the previous rung, both via
            # the asymmetric-budget arena (arena.py mcts_cfg_inc).
            self._rung_arenas = {}
            self._rung_chain = []
            uni_apply = make_uniform_model(game).apply_fn
            prev_name, prev_sims = "anchor", anchor_cfg.num_sims
            for sims in tuple(getattr(cfg.arena, "anchor_ladder", ()) or ()):
                rung_cfg = dataclasses.replace(anchor_cfg, num_sims=int(sims))
                name = f"anchor@{int(sims)}"
                self._rung_arenas[name] = jax.jit(
                    make_arena_fn(
                        game,
                        apply_fn,
                        uni_apply,
                        anchor_cfg,
                        cfg.arena.num_games,
                        state_sharding=arena_sharding,
                        mcts_cfg_inc=rung_cfg,
                    )
                )
                self._rung_chain.append(
                    (
                        prev_name,
                        name,
                        jax.jit(
                            make_arena_fn(
                                game,
                                uni_apply,
                                uni_apply,
                                dataclasses.replace(
                                    anchor_cfg, num_sims=prev_sims
                                ),
                                cfg.arena.num_games,
                                state_sharding=arena_sharding,
                                mcts_cfg_inc=rung_cfg,
                            )
                        ),
                    )
                )
                prev_name, prev_sims = name, int(sims)
            # incumbent-vs-pool rating matches ride the same standardized
            # protocol as the anchor edges (one consistent match graph);
            # this is the gate arena itself unless training uses a
            # non-standard engine configuration
            self._rating_arena = self._arena
            if anchor_cfg != arena_cfg:
                self._rating_arena = jax.jit(
                    make_arena_fn(
                        game,
                        apply_fn,
                        apply_fn,
                        anchor_cfg,
                        cfg.arena.num_games,
                        state_sharding=arena_sharding,
                    )
                )
        # host-visible scalars out of sharded stats must come through a jit
        # (fully-replicated outputs): host-side jnp.sum over a sharded
        # global array is not addressable under multi-controller
        self._stats_reduce = jax.jit(
            lambda nm, dn: (jnp.sum(nm), jnp.sum(~dn))
        )
        self.iteration = 0
        self.model_id = 0
        self._selfplay_ran = False
        self.elo = EloTracker()
        # anchored-rating state: pool of past-generation variable
        # snapshots + the accumulated match graph (vs pool and vs the
        # fixed pure-MCTS anchor, pinned at Elo 0 by fit_elo)
        self.pool = []           # [(model_id, variables)]
        self.pool_matches = []   # [{a, b, wins_a, wins_b, draws}]
        self._pool_ckpt = bool(
            cfg.arena.pool_in_checkpoint and cfg.arena.anchor_interval
        )
        self.anchored_ratings = {}
        self.metrics = MetricsLogger(cfg.checkpoint_dir)
        self.timer = PhaseTimer()

        # optional native host archive of training samples — the durable
        # twin of the reference's `{iteration}.examples` files
        # (coach.rs:159-167); requires the C++ toolchain.
        self.example_store = None
        if cfg.checkpoint_dir and jax.process_count() == 1:
            # (multi-controller runs skip the host archive: it would need a
            # cross-process gather of the sharded trajectory; the
            # whole-state checkpoint — which includes the replay — is the
            # durable record there)
            try:
                from alphazero_tpu import native

                if native.available():
                    self.example_store = native.ExampleStore(
                        cfg.replay.capacity,
                        feat_size=int(
                            __import__("math").prod(game.feature_shape)
                        ),
                        num_actions=game.num_actions,
                    )
            except Exception:
                self.example_store = None

        if cfg.checkpoint_dir:
            self._maybe_resume()

    # ------------------------------------------------------------------
    def _payload(self, rings: bool = True):
        """Checkpoint pytree. ``rings=False`` builds the LIGHT payload
        (``replay_save_stride``): params/opt/rng/pool only — the replay
        and reanalyze rings dominate checkpoint bytes (hundreds of MB at
        production capacity vs MBs for everything else) and are the only
        regenerable state."""
        rng_data = jax.random.key_data(self.rng)
        if self.mesh is not None:
            # the key evolves host-side (identical on every controller);
            # checkpointing needs the one global replicated view of it
            from alphazero_tpu.parallel import replicate_host_value

            rng_data = replicate_host_value(rng_data, self.mesh)
        payload = {
            "incumbent": self.incumbent._asdict(),
            "rng": rng_data,
        }
        if rings:
            payload["replay"] = self.replay._asdict()
            if self.positions is not None:
                # the reanalyze position ring resumes exactly with the run
                payload["positions"] = self.positions._asdict()
            if self.actor_carry is not None:
                # the recycling actor's live boards + open-episode
                # fragments: resume continues mid-episode. Regenerable
                # like the rings (a light resume starts fresh episodes),
                # so it rides the ring group.
                payload["actor"] = self.actor_carry._asdict()
        if self._pool_ckpt:
            payload["pool"] = self._pool_payload()
        return payload

    def _pool_payload(self):
        """Anchored-pool snapshots as a FIXED-SHAPE stacked pytree
        (zero-padded to pool_size, ids -1 where empty) so it can serve as
        the restore template whatever the live pool length is."""
        import numpy as np

        P = max(self.cfg.arena.pool_size, 1)
        zeros = jax.tree_util.tree_map(
            lambda l: np.zeros(l.shape, l.dtype), variables_of(self.incumbent)
        )
        ids = np.full((P,), -1, np.int32)
        snaps = []
        for i, (gen_id, snap) in enumerate(self.pool[:P]):
            ids[i] = gen_id
            snaps.append(snap)
        snaps += [zeros] * (P - len(snaps))
        stacked = jax.tree_util.tree_map(
            lambda *ls: np.stack([np.asarray(l) for l in ls]), *snaps
        )
        out = {"ids": ids, "vars": stacked}
        if self.mesh is not None:
            from alphazero_tpu.parallel import replicate_host_value

            out = jax.tree_util.tree_map(
                lambda l: replicate_host_value(l, self.mesh), out
            )
        return out

    def _restore_dropping_optional(self, step, template):
        """restore_checkpoint with the optional-subtree fallback: if the
        exact-template restore fails (checkpoint predates the reanalyze
        position ring / anchored-pool snapshots, or a field inside one,
        or the stacked pool template's shape changed with
        arena.pool_size), drop the SMALLEST set of optional subtrees
        that restores, keep the rest, and start the dropped ones empty.
        Shared by the exact and light resume plans."""
        try:
            return restore_checkpoint(self.cfg.checkpoint_dir, step, template)
        except Exception:
            import itertools
            import logging

            optional = [
                k for k in ("positions", "pool", "actor") if k in template
            ]
            if not optional:
                raise
            payload = None
            for r in range(1, len(optional) + 1):
                for drop in itertools.combinations(optional, r):
                    t2 = {k: v for k, v in template.items() if k not in drop}
                    try:
                        payload, sidecar = restore_checkpoint(
                            self.cfg.checkpoint_dir, step, t2
                        )
                        dropped = drop
                        break
                    except Exception:
                        continue
                if payload is not None:
                    break
            if payload is None:
                raise
            logging.getLogger(__name__).warning(
                "checkpoint predates optional subtree(s) %s — resuming "
                "with them empty (they repopulate as the run proceeds)",
                list(dropped),
            )
            return payload, sidecar

    def _resume_light(self, step, template, exclude_ring=None) -> None:
        """The light/ring-split resume plan (replay_save_stride): restore
        everything but the rings from ``step``, then the replay/reanalyze
        rings from the newest ring-bearing step — at most
        (stride-1)*interval iterations of replay regenerate.
        ``exclude_ring`` skips a step whose lightness classification is
        unreliable (used when the exact plan just failed on it)."""
        import logging

        from alphazero_tpu.checkpoint import newest_ring_step

        light_t = {
            k: v
            for k, v in template.items()
            if k not in ("replay", "positions", "actor")
        }
        payload, sidecar = self._restore_dropping_optional(step, light_t)
        ring_step = newest_ring_step(self.cfg.checkpoint_dir, exclude=exclude_ring)
        if ring_step is not None:
            rings_t = {
                k: template[k]
                for k in ("replay", "positions", "actor")
                if k in template
            }
            try:
                rings, _ = restore_checkpoint(
                    self.cfg.checkpoint_dir, ring_step, rings_t, partial=True
                )
            except Exception:
                try:
                    # ring checkpoint may predate the reanalyze ring (or a
                    # field inside it) — take the replay alone
                    rings, _ = restore_checkpoint(
                        self.cfg.checkpoint_dir,
                        ring_step,
                        {"replay": template["replay"]},
                        partial=True,
                    )
                except Exception:
                    # replay layout changed (e.g. the round-5 packed-row
                    # ring vs a pre-round-5 checkpoint): resume with empty
                    # rings rather than failing — params/counters survive
                    rings = {}
            payload.update(rings)
            if rings:
                logging.getLogger(__name__).warning(
                    "light checkpoint %d: replay/reanalyze rings restored "
                    "from ring-bearing checkpoint %d (%d iterations older)",
                    step,
                    ring_step,
                    step - ring_step,
                )
            else:
                logging.getLogger(__name__).warning(
                    "light checkpoint %d: ring checkpoint %d is "
                    "incompatible (layout change) — resuming with empty "
                    "rings (they repopulate)",
                    step,
                    ring_step,
                )
        else:
            logging.getLogger(__name__).warning(
                "light checkpoint %d with no ring-bearing checkpoint "
                "on disk — resuming with empty rings (they repopulate)",
                step,
            )
        self._finish_resume(payload, sidecar, step)

    def _maybe_resume(self) -> None:
        step = latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return
        template = self._payload()
        from alphazero_tpu.checkpoint import read_sidecar

        pre = read_sidecar(self.cfg.checkpoint_dir, step)
        if pre is not None and not pre.get("has_rings", True):
            self._resume_light(step, template)
            return
        try:
            payload, sidecar = self._restore_dropping_optional(step, template)
        except Exception:
            # The step may be a LIGHT checkpoint whose sidecar is missing
            # or describes a different same-step save (a crash inside the
            # save window) — the full template then fails on the absent
            # replay ring. Last resort: the light/ring-split plan, with
            # this step excluded from ring candidates since its
            # classification just proved unreliable. If that fails too,
            # the chained traceback carries the original error.
            import logging

            self._resume_light(step, template, exclude_ring=step)
            logging.getLogger(__name__).warning(
                "checkpoint %d failed the exact restore but resumed via "
                "the light/ring-split plan (sidecar missing or "
                "misclassified lightness)",
                step,
            )
            return
        self._finish_resume(payload, sidecar, step)

    def _finish_resume(self, payload, sidecar, step) -> None:
        """Install a restored checkpoint payload + sidecar (shared by the
        exact and the light/ring-split resume plans)."""
        self.incumbent = TrainState(**payload["incumbent"])
        if "replay" in payload:
            from alphazero_tpu.replay import ReplayState

            self.replay = ReplayState(**payload["replay"])
        if "positions" in payload:
            from alphazero_tpu.reanalyze import PositionStore

            self.positions = PositionStore(**payload["positions"])
        if "actor" in payload and self.actor_carry is not None:
            from alphazero_tpu.selfplay import ActorCarry

            self.actor_carry = ActorCarry(**payload["actor"])
        if "pool" in payload:
            import numpy as np

            from alphazero_tpu.parallel.distributed import host_copy

            pool_h = host_copy(payload["pool"])
            for i, gen_id in enumerate(np.asarray(pool_h["ids"])):
                if gen_id >= 0:
                    self.pool.append(
                        (
                            int(gen_id),
                            jax.tree_util.tree_map(
                                lambda l: np.asarray(l[i]), pool_h["vars"]
                            ),
                        )
                    )
            self.pool.sort(key=lambda t: t[0])
        self.rng = jax.random.wrap_key_data(payload["rng"])
        if sidecar:
            self.iteration = sidecar.get("iteration", step)
            self.model_id = sidecar.get("model_id", 0)
            for rec in sidecar.get("elo_history", []):
                self.elo.history.append(rec)
            self.elo.ratings.update(
                {int(k): v for k, v in sidecar.get("elo_ratings", {}).items()}
            )
            self.pool_matches = [
                {**m, "a": _gen_key(m["a"]), "b": _gen_key(m["b"])}
                for m in sidecar.get("pool_matches", [])
            ]
            if self.pool_matches:
                from alphazero_tpu.utils.elo import fit_elo

                self.anchored_ratings = fit_elo(self.pool_matches, "anchor", 0.0)
        else:
            self.iteration = step

    def _archive_examples(self, traj) -> None:
        """Mirror the iteration's raw samples into the native store and
        persist them as `{iteration}.examples` (save_train_examples,
        coach.rs:159-167 — written inside the checkpoint dir, fixing D6)."""
        import numpy as np

        valid = np.asarray(traj.valid).reshape(-1)
        feats = np.asarray(traj.features).reshape(valid.shape[0], -1)[valid]
        pis = np.asarray(traj.pi).reshape(valid.shape[0], -1)[valid]
        vals = np.asarray(traj.value).reshape(-1)[valid]
        self.example_store.append(feats, pis, vals)
        import os

        self.example_store.save(
            os.path.join(self.cfg.checkpoint_dir, f"{self.iteration}.examples")
        )

    def save(self, rings: bool = True) -> None:
        if not self.cfg.checkpoint_dir:
            return
        save_checkpoint(
            self.cfg.checkpoint_dir,
            self.iteration,
            self._payload(rings=rings),
            sidecar={
                "iteration": self.iteration,
                "model_id": self.model_id,
                # light checkpoints (replay_save_stride) omit the replay/
                # reanalyze rings; resume reads this flag to pick its plan
                "has_rings": rings,
                "elo_history": self.elo.history,
                "elo_ratings": self.elo.ratings,
                # anchored-rating match graph persists across restarts
                # (the pool's params do not — it repopulates at the next
                # anchor passes; history keeps the fit comparable)
                "pool_matches": self.pool_matches,
            },
        )
        self._last_save_rings = rings
        if self.cfg.keep_checkpoints and jax.process_index() == 0:
            from alphazero_tpu.checkpoint import prune_checkpoints

            prune_checkpoints(
                self.cfg.checkpoint_dir, self.cfg.keep_checkpoints
            )

    # ------------------------------------------------------------------
    def _split(self, n=2):
        keys = jax.random.split(self.rng, n + 1)
        self.rng = keys[0]
        return keys[1:]

    def run_iteration(self) -> dict:
        """One full coach iteration; returns the metrics record."""
        cfg = self.cfg
        (k_sp, k_train, k_arena) = self._split(3)

        # the reference's skip_first_play (examples/connect_four.rs:73):
        # on the first iteration after (re)start, train straight on the
        # restored replay instead of generating new games
        skip_sp = (
            cfg.skip_first_selfplay
            and not self._selfplay_ran
            and int(self.replay.size) > 0
        )
        self._selfplay_ran = True
        selfplay_moves = 0
        selfplay_truncated = 0
        if not skip_sp:
            with self.timer.phase("selfplay"):
                if self._recycle:
                    self.actor_carry, traj, stats = self._selfplay(
                        variables_of(self.incumbent), self.actor_carry, k_sp
                    )
                    sp_out = (traj, stats)
                else:
                    sp_out = self._selfplay(variables_of(self.incumbent), k_sp)
                    traj, stats = sp_out[0], sp_out[1]
                jax.block_until_ready(traj.features)
            moves_sum, trunc_sum = self._stats_reduce(stats.num_moves, stats.done)
            selfplay_moves = int(moves_sum)
            # games that hit max_moves unfinished: their samples are masked
            # out by selfplay (no outcome to train on) — surface the count
            selfplay_truncated = int(trunc_sum)
            with self.timer.phase("replay_insert"):
                self.replay = self._insert(self.replay, traj)
                if self._reanalyze is not None:
                    self.positions = self._pos_insert(
                        self.positions, sp_out[2], traj.value, traj.valid,
                        self.iteration,
                    )
                jax.block_until_ready(self.replay.pos)
            if self.example_store is not None:
                self._archive_examples(traj)
        reanalyzed = None
        reanalyze_age = None
        if (
            self._reanalyze is not None
            and (self.iteration + 1) % cfg.reanalyze.interval == 0
        ):
            (k_rz,) = self._split(1)
            with self.timer.phase("reanalyze"):
                rz_traj, rz_num, rz_age = self._reanalyze(
                    variables_of(self.incumbent), self.positions, k_rz,
                    self.iteration,
                )
                self.replay = self._insert(self.replay, rz_traj)
                jax.block_until_ready(self.replay.pos)
            reanalyzed = int(rz_num)
            # staleness metric: mean age (iterations) of the refreshed
            # positions — ~0 means the ring wraps within an iteration
            # and reanalyze is refreshing targets that were never stale
            reanalyze_age = round(float(rz_age), 3)
        with self.timer.phase("train"):
            candidate, losses = self._train_phase(self.incumbent, self.replay, k_train)
            jax.block_until_ready(losses)
        with self.timer.phase("arena"):
            result = self._arena(
                variables_of(candidate), variables_of(self.incumbent), k_arena
            )
            jax.block_until_ready(result.cand_wins)

        cw, iw, dr = int(result.cand_wins), int(result.inc_wins), int(result.draws)
        accepted = gate(result, cfg.arena.update_threshold)
        cand_id = self.model_id + 1
        rating = self.elo.record_match(cand_id, self.model_id, cw, iw, dr, accepted)
        if accepted:
            self.incumbent = candidate
            self.model_id = cand_id

        self.iteration += 1
        anchor = None
        anchored_elo = None
        anchored_se = None
        if self._anchor_arena is not None and (
            self.iteration % cfg.arena.anchor_interval == 0
            or self.iteration <= (cfg.arena.anchor_warmup or 0)
        ):
            anchor, anchored_elo, anchored_se = self._anchored_rating_pass()

        phases = self.timer.reset()
        record = {
            "iteration": self.iteration,
            "model_id": self.model_id,
            "accepted": accepted,
            "arena_wins": cw,
            "arena_losses": iw,
            "arena_draws": dr,
            "win_rate": cw / max(cw + iw, 1),
            "candidate_elo": rating,
            "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]),
            "replay_size": int(self.replay.size),
            "replay_total": replay_total(self.replay),
            "selfplay_moves": selfplay_moves,
            "selfplay_truncated": selfplay_truncated,
            "eval_folded": self._eval_folded,
            **({"reanalyzed": reanalyzed} if reanalyzed is not None else {}),
            **(
                {"reanalyze_age_mean": reanalyze_age}
                if reanalyze_age is not None
                else {}
            ),
            **({"anchor_win_rate": round(anchor, 4)} if anchor is not None else {}),
            **(
                {"anchored_elo": round(anchored_elo, 2)}
                if anchored_elo is not None
                else {}
            ),
            **(
                # ±1 Fisher-information standard error of the anchored fit
                {"anchored_elo_se": round(anchored_se, 2)}
                if anchored_se is not None
                else {}
            ),
            **{f"t_{k}": round(v, 3) for k, v in phases.items()},
        }
        self.metrics.log(record)
        interval = max(self.cfg.checkpoint_interval, 1)
        if self.iteration % interval == 0:
            # with replay_save_stride=k, only every k-th periodic save
            # carries the rings (phased so the FIRST periodic save does —
            # an early preemption still resumes with its replay)
            stride = max(self.cfg.replay_save_stride, 1)
            idx = self.iteration // interval
            self.save(rings=(idx % stride) == (1 % stride))
        return record

    def _anchored_rating_pass(self):
        """Anchored Elo: play the incumbent vs the fixed pure-MCTS anchor
        and vs every pool snapshot, refit the full match graph (anchor
        pinned at 0), then snapshot the incumbent into the pool.

        Unlike the per-gate EloTracker ladder (whose ratings chain off
        each accepted gate and only ratchet upward), these ratings are a
        maximum-likelihood fit of ALL recorded matches against fixed and
        past opponents — they can go down, and they are comparable across
        the whole run."""
        from alphazero_tpu.utils.elo import elo_standard_errors, fit_elo

        me = self.model_id
        inc_vars = variables_of(self.incumbent)

        # warmup iterations repeat the anchor arena (anchor_warmup_mult):
        # the earliest gen-vs-anchor edge is on every path to the pinned
        # gauge, so its variance propagates into every rating
        in_warmup = self.iteration <= (self.cfg.arena.anchor_warmup or 0)
        reps = max(int(self.cfg.arena.anchor_warmup_mult), 1) if in_warmup else 1
        aw = al = ad = 0
        for _ in range(reps):
            (k_anchor,) = self._split(1)
            with self.timer.phase("anchor"):
                ar = self._anchor_arena(inc_vars, {}, k_anchor)
                jax.block_until_ready(ar.cand_wins)
            aw += int(ar.cand_wins)
            al += int(ar.inc_wins)
            ad += int(ar.draws)
        anchor_wr = aw / max(aw + al, 1)
        self.pool_matches.append(
            {"a": me, "b": "anchor", "wins_a": aw, "wins_b": al, "draws": ad}
        )

        if self._rung_chain and not any(
            isinstance(m["a"], str) for m in self.pool_matches
        ):
            # one-time ladder calibration: the rungs are FIXED agents, so
            # the chain edges anchor -> rung1 -> rung2 are permanent (they
            # persist in the sidecar and survive resume — the isinstance
            # probe above sees them and skips this block)
            mult = max(int(self.cfg.arena.anchor_warmup_mult), 1)
            for lo, hi, chain_arena in self._rung_chain:
                w = l = d = 0
                for _ in range(mult):
                    (k_ch,) = self._split(1)
                    with self.timer.phase("anchor"):
                        crr = chain_arena({}, {}, k_ch)
                        jax.block_until_ready(crr.cand_wins)
                    w += int(crr.cand_wins)
                    l += int(crr.inc_wins)
                    d += int(crr.draws)
                self.pool_matches.append(
                    {"a": lo, "b": hi, "wins_a": w, "wins_b": l, "draws": d}
                )
        for rung, rung_arena in self._rung_arenas.items():
            # retire a rung for the incumbent once swept twice in a row
            # (no losses, no draws) — it carries no more information
            hist = [
                m
                for m in self.pool_matches
                if m["b"] == rung and not isinstance(m["a"], str)
            ]
            if len(hist) >= 2 and all(
                m["wins_b"] == 0 and m["draws"] == 0 for m in hist[-2:]
            ):
                continue
            rw = rl = rd = 0
            for _ in range(reps):
                (k_r,) = self._split(1)
                with self.timer.phase("anchor"):
                    rr = rung_arena(inc_vars, {}, k_r)
                    jax.block_until_ready(rr.cand_wins)
                rw += int(rr.cand_wins)
                rl += int(rr.inc_wins)
                rd += int(rr.draws)
            self.pool_matches.append(
                {"a": me, "b": rung, "wins_a": rw, "wins_b": rl, "draws": rd}
            )

        snap_shardings = jax.tree_util.tree_map(lambda l: l.sharding, inc_vars)
        for gen_id, snap_host in self.pool:
            if gen_id == me:
                continue
            (k_m,) = self._split(1)
            # pool snapshots live on the host (they would otherwise pin
            # pool_size full copies of the variables in HBM for the whole
            # run); stage each one onto the incumbent's shardings only for
            # the duration of its arena
            snap_vars = jax.device_put(snap_host, snap_shardings)
            with self.timer.phase("anchor"):
                pr = self._rating_arena(inc_vars, snap_vars, k_m)
                jax.block_until_ready(pr.cand_wins)
            self.pool_matches.append(
                {
                    "a": me,
                    "b": gen_id,
                    "wins_a": int(pr.cand_wins),
                    "wins_b": int(pr.inc_wins),
                    "draws": int(pr.draws),
                }
            )

        n_cross = int(self.cfg.arena.pool_cross_matches or 0)
        if n_cross > 0 and len(self.pool) >= 2:
            # Pool-vs-pool cross matches (ArenaConfig.pool_cross_matches):
            # the star-through-the-incumbent graph leaves the anchor edge
            # as the only path to the gauge, and at flagship strength that
            # edge is a blowout with ~zero Fisher information. Densify the
            # graph where the information is: the pool pair with the
            # fewest recorded games, ties broken toward the closest fitted
            # ratings (π(1−π) is maximal near 50%), then lexicographic for
            # determinism. Uses the same standardized rating arena and the
            # same rng stream discipline as the incumbent edges.
            from itertools import combinations

            games_between = {}
            for m in self.pool_matches:
                k = frozenset((m["a"], m["b"]))
                games_between[k] = (
                    games_between.get(k, 0)
                    + m["wins_a"] + m["wins_b"] + m["draws"]
                )
            rat = self.anchored_ratings
            pool_by_id = dict(self.pool)
            cands = sorted(
                (
                    (g1, g2)
                    for (g1, g2) in combinations(sorted(pool_by_id), 2)
                    if g1 != me and g2 != me
                ),
                key=lambda pair: (
                    games_between.get(frozenset(pair), 0),
                    abs(rat.get(pair[0], 0.0) - rat.get(pair[1], 0.0)),
                    pair,
                ),
            )
            for g1, g2 in cands[:n_cross]:
                (k_c,) = self._split(1)
                va = jax.device_put(pool_by_id[g1], snap_shardings)
                vb = jax.device_put(pool_by_id[g2], snap_shardings)
                with self.timer.phase("anchor"):
                    cr = self._rating_arena(va, vb, k_c)
                    jax.block_until_ready(cr.cand_wins)
                self.pool_matches.append(
                    {
                        "a": g1,
                        "b": g2,
                        "wins_a": int(cr.cand_wins),
                        "wins_b": int(cr.inc_wins),
                        "draws": int(cr.draws),
                    }
                )

        self.anchored_ratings = fit_elo(self.pool_matches, "anchor", 0.0)
        se = elo_standard_errors(
            self.pool_matches, "anchor", self.anchored_ratings
        ).get(me)
        self._pool_insert(me, inc_vars)
        return anchor_wr, self.anchored_ratings.get(me), se

    def _pool_insert(self, gen_id, snap_vars) -> None:
        """Keep the newest snapshot; evict toward evenly spaced
        generations (drop the member whose neighbors are closest, never
        the newest). Snapshots are held as host (numpy) copies — HBM only
        sees one of them at a time, during its anchored-pass arena.
        ``host_copy`` (not plain ``device_get``) so model-sharded params
        survive multi-controller runs, where a leaf can span
        non-addressable devices."""
        from alphazero_tpu.parallel.distributed import host_copy

        snap_vars = host_copy(snap_vars)
        self.pool = [(g, v) for g, v in self.pool if g != gen_id]
        self.pool.append((gen_id, snap_vars))
        self.pool.sort(key=lambda t: t[0])
        limit = max(self.cfg.arena.pool_size, 1)
        while len(self.pool) > limit:
            gens = [g for g, _ in self.pool]
            # gap around each evictable member (all but the newest); ties
            # evict the YOUNGEST tied member (<=) — with consecutive
            # generations every gap ties, and evicting the oldest would
            # degenerate the pool into a sliding recency window instead of
            # the intended long-baseline spread (e.g. limit 4 keeps
            # [1, 3, 5, newest], not the last four)
            best_i, best_gap = 0, None
            for i in range(len(gens) - 1):
                lo = gens[i - 1] if i > 0 else 2 * gens[0] - gens[1]
                gap = gens[i + 1] - lo
                if best_gap is None or gap <= best_gap:
                    best_i, best_gap = i, gap
            del self.pool[best_i]

    def learn(self, num_iterations: Optional[int] = None):
        """The outer loop (Coach::learn, coach.rs:169-396).

        Preemption-safe: SIGTERM (a cluster scheduler's eviction signal) is caught
        for the duration of the loop; the in-flight iteration finishes,
        the whole state checkpoints, and learn() returns normally — a
        restarted Coach over the same checkpoint_dir resumes exactly.
        The reference had no failure handling at all (SURVEY.md §5).

        Caveat: the jitted iteration cannot be interrupted mid-flight, so
        the eviction grace window must cover ONE iteration's wall time.
        Configs whose iterations outlast the grace period should rely on
        a small ``checkpoint_interval`` instead (at most one interval of
        work is lost on hard kill)."""
        import logging
        import signal
        import threading

        n = num_iterations if num_iterations is not None else self.cfg.num_iterations
        records = []
        caught = []
        prev_handler = None
        in_main = threading.current_thread() is threading.main_thread()
        if in_main:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: caught.append(signum)
            )
        try:
            for _ in range(n):
                records.append(self.run_iteration())
                if caught:
                    log = logging.getLogger(__name__)
                    if self.cfg.checkpoint_dir:
                        log.warning(
                            "SIGTERM: checkpointing at iteration %d and "
                            "stopping (resume from %s)",
                            self.iteration,
                            self.cfg.checkpoint_dir,
                        )
                    else:
                        log.warning(
                            "SIGTERM: stopping at iteration %d — no "
                            "checkpoint_dir configured, training state is "
                            "NOT saved",
                            self.iteration,
                        )
                    break
            if records and (
                self.iteration % max(self.cfg.checkpoint_interval, 1) != 0
                or not getattr(self, "_last_save_rings", True)
            ):
                # the run's final state is always durable WITH the rings —
                # covers both the off-interval case and a last periodic
                # save that was light (replay_save_stride)
                self.save(rings=True)
        finally:
            if in_main:
                # signal.signal returns None for handlers installed at the
                # C level; restoring None would raise TypeError
                signal.signal(
                    signal.SIGTERM,
                    prev_handler if prev_handler is not None else signal.SIG_DFL,
                )
        return records
