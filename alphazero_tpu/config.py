"""Typed configuration for the whole framework.

The reference has no config system: 15 positional ``Coach::setup`` args plus
4 ``learn`` args hard-coded in the example binary
(reference: examples/connect_four.rs:55-77) and scattered consts
(node.rs:12-13, connect_four_game.rs:13-16). Here every knob lives in one
nested frozen dataclass so a run is reproducible from a single object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# PUCT exploration epsilon, kept verbatim from the reference
# (reference: src/node.rs:12  `EPS: f32 = 1e-6`).
PUCT_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """Search hyperparameters (reference: src/async_mcts.rs:14-24).

    The reference's ``num_threads`` (intra-tree thread parallelism with
    virtual loss, async_mcts.rs:191-217) has no analogue: the lockstep
    vectorized search issues exactly one simulation per game per step, so
    virtual loss is unnecessary by construction (SURVEY.md §2 parallelism
    table).
    """

    num_sims: int = 100          # simulations per move (async_mcts.rs:17)
    cpuct: float = 1.0           # exploration constant (async_mcts.rs:20)
    max_depth: int = 64          # descent depth cutoff -> eval_heuristic
    #                              (async_mcts.rs:241-243); also the path
    #                              buffer length, so it bounds backup length.
    max_nodes: Optional[int] = None  # tree capacity per game; default
    #                              num_sims + 1 (one expansion per sim).
    #                              Reference pre-allocates `reserve_space`
    #                              (examples/connect_four.rs:57: 1M nodes).
    dirichlet_alpha: Optional[float] = None  # root noise; the reference has
    #                              none — optional extension, default off.
    dirichlet_frac: float = 0.25
    forced_playouts: Optional[float] = None  # opt-in KataGo forced
    #                              playouts + policy target pruning (Wu
    #                              2020 §3.2; no reference analogue): at
    #                              the ROOT, any child with
    #                              n < sqrt(k·P·Σn) is forced to be
    #                              searched (k = this value; KataGo used
    #                              2), guaranteeing noise-boosted moves a
    #                              minimum of exploration; the stored
    #                              policy target then PRUNES the forced
    #                              visits back out (tree.pruned_root_counts)
    #                              so the targets aren't polluted by the
    #                              forcing. Pair with dirichlet_alpha.

    transposition: bool = False  # opt-in transposition-DAG dedup (the
    #                              reference's `seen` table, node.rs:135 /
    #                              272-326): node-level shared statistics,
    #                              duplicate expansions redirect to the
    #                              canonical node and continue the descent.
    #                              Runs on the dedicated mcts/tt.py engine
    #                              (bit-exact vs csrc/tt_oracle.cpp).
    #                              Measured worth ~0 Elo at 25-100
    #                              sims/move and +32/+9 Elo (c4/othello)
    #                              at 400 — enable for DEEP-search
    #                              deployments only; it pays two lane
    #                              gathers per simulation the default
    #                              engines avoid (docs/PARITY.md).

    gumbel: bool = False         # opt-in Gumbel sequential-halving search
    #                              (Danihelka et al. 2022; mcts/gumbel.py) —
    #                              no reference analogue. Guaranteed policy
    #                              improvement at small num_sims: the root
    #                              runs a Gumbel-top-m sequential-halving
    #                              schedule, interior nodes the paper's
    #                              deterministic rule, the played action is
    #                              the halving winner (no temperature
    #                              sampling; exploration = the Gumbel
    #                              sample) and the policy target is the
    #                              improved policy pi'. Use with num_sims
    #                              in the 8-64 range.
    gumbel_top_m: int = 16       # max root actions considered (clipped to
    #                              the game's action count / legality)
    gumbel_c_visit: float = 50.0  # sigma transform offset (paper's c_visit)
    gumbel_value_scale: float = 0.1  # sigma scale on [0,1]-rescaled
    #                              completed values (paper's c_scale)

    tree_reuse: bool = False     # carry the search tree across the moves of
    #                              an episode (the reference's per-episode
    #                              AsyncMcts persistence, coach.rs:104-157):
    #                              after each move the played child's
    #                              subtree is re-rooted (mcts/reuse.py) and
    #                              the next search continues from its
    #                              cumulative statistics. Pair with
    #                              max_nodes ~ 2*num_sims so carried
    #                              subtrees fit.

    @property
    def nodes(self) -> int:
        return self.max_nodes if self.max_nodes is not None else self.num_sims + 1


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    """Self-play episode generation (reference: src/coach.rs:104-157)."""

    batch_size: int = 1024       # games stepped in lockstep (replaces
    #                              num_eps × rayon threads, coach.rs:202-272)
    temp_threshold: int = 15     # temp=1 before this move index, 0 after
    #                              (coach.rs:122-126)
    max_moves: Optional[int] = None  # defaults to game.max_moves

    full_search_prob: Optional[float] = None  # playout cap randomization
    #                              (KataGo, Wu 2020 §3.1; no reference
    #                              analogue): per move-step, with this
    #                              probability the batch searches at the
    #                              FULL mcts.num_sims budget and records
    #                              policy targets; otherwise it searches at
    #                              cheap_sims (no Dirichlet noise) and the
    #                              move advances the game with a VALUE-ONLY
    #                              sample (pi target = zeros, which
    #                              contributes zero policy loss — see
    #                              train.py). Policy targets need deep
    #                              search, value targets need many games;
    #                              this buys games-per-compute. None = off.
    cheap_sims: Optional[int] = None  # the reduced budget (required when
    #                              full_search_prob is set); KataGo used
    #                              ~num_sims/6 at full_search_prob=0.25

    recycle: bool = False        # episode-recycling self-play
    #                              (selfplay.make_recycling_selfplay_fn):
    #                              finished games reset to the initial
    #                              position instead of burning searches on
    #                              inert terminal roots (the fixed-T scan
    #                              wastes ~15% of full-preset searches that
    #                              way). Value targets resolve exactly via
    #                              the cross-call fragment carry; first
    #                              episodes are bit-identical to the fixed
    #                              scan per seed. Incompatible with
    #                              tree_reuse / forced_playouts /
    #                              transposition / PCR / reanalyze.
    recycle_steps: Optional[int] = None  # searches (= real moves) per
    #                              iteration per game; defaults to
    #                              game.max_moves, must be >= it


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Replay history (reference: coach.rs:18-34, 275-289).

    The reference keeps a deque of per-iteration deques with
    ``max_history_length`` iterations × ``max_queue_length`` samples. Here
    the replay is a single fixed-capacity on-device ring buffer; capacity
    plays the role of history_length × queue_length.
    """

    capacity: int = 1 << 18


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Learner (reference: examples/connect_four_lib/connect_four_net.py:13-15
    — epochs=10, batch=64, lr=1e-3, Adam)."""

    batch_size: int = 256
    learning_rate: float = 1e-3
    steps_per_iteration: int = 256   # minibatch SGD steps per coach iteration
    weight_decay: float = 0.0
    l2_scale: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    """Model gating (reference: src/arena.rs + coach.rs:332-390)."""

    num_games: int = 128         # total head-to-head games; half with each
    #                              seating order (arena.rs:74-79)
    update_threshold: Optional[float] = 0.6  # accept iff
    #                              new_wins/(new+old) >= this
    #                              (coach.rs:383-390, AlphaGo-Zero-style
    #                              gating). None = CONTINUOUS mode: always
    #                              adopt the candidate (AlphaZero-2017 —
    #                              no gate; the arena still runs for Elo
    #                              telemetry). Continuous mode escapes the
    #                              cold-start deadlock where generation-1
    #                              candidates lose to the near-uniform
    #                              incumbent-with-search while still
    #                              improving against each other.
    num_sims: Optional[int] = None  # arena search budget; defaults to MCTS's
    anchor_interval: Optional[int] = None  # every k iterations, run the
    #                              ANCHORED RATING pass: play the incumbent
    #                              against the FIXED pure-MCTS anchor
    #                              (uniform prior, same sims) and against
    #                              every pool snapshot, refit the whole
    #                              match graph with fit_elo (anchor pinned
    #                              at 0), log anchor_win_rate +
    #                              anchored_elo, then snapshot the
    #                              incumbent into the pool. These are the
    #                              headline ratings; the per-gate
    #                              EloTracker ladder is only a diagnostic.
    pool_size: int = 5           # max past-generation snapshots kept for
    #                              anchored rating matches (evicted to
    #                              keep generations roughly evenly spaced,
    #                              newest always kept)
    anchor_ladder: tuple = ()    # extra FIXED pure-MCTS anchor rungs at
    #                              these simulation budgets (e.g.
    #                              (400, 1600)). The base anchor stays the
    #                              pinned Elo-0 gauge; rungs are players
    #                              "anchor@SIMS" in the match graph. Once
    #                              per run the chain anchor->rung1->rung2
    #                              is calibrated (uniform-vs-uniform
    #                              asymmetric-budget arenas, warmup_mult x
    #                              games — rungs are fixed agents, so
    #                              these edges are permanent); every
    #                              anchored pass the incumbent also plays
    #                              each rung until it has swept it twice
    #                              (then the rung is retired for the
    #                              incumbent). Motive: a strong net sweeps
    #                              the base anchor from iteration 1
    #                              (measured round 5), leaving the gauge
    #                              chain with no informative first link —
    #                              the strongest rung is where generation
    #                              1 actually lands.
    anchor_warmup: int = 0       # ALSO run the anchored pass at every
    #                              iteration <= this. The round-4 flagship
    #                              artifacts show anchor_win_rate = 1.0
    #                              from the very first pass (iteration 5,
    #                              empty pool): the whole absolute scale
    #                              rests forever on one 128-0 swept edge,
    #                              which both inflates SE (±204-330) and
    #                              caps the fitted rating through the
    #                              virtual-draw regularizer. Dense passes
    #                              across the steep early iterations give
    #                              the gauge an informative chain
    #                              (measured and simulated).
    anchor_warmup_mult: int = 1  # during warmup iterations, repeat the
    #                              anchor arena this many times (the
    #                              gen-1-vs-anchor edge sits on EVERY path
    #                              to the gauge — it deserves more games
    #                              than a pool edge).
    pool_cross_matches: int = 0  # extra POOL-VS-POOL arenas per anchored
    #                              pass. The default match graph is a star
    #                              through each iteration's incumbent, and
    #                              at flagship strength the incumbent-vs-
    #                              anchor edge is a blowout carrying ~no
    #                              Fisher information — SE grew to
    #                              ±204-330 Elo.
    #                              Each cross match picks the pool pair
    #                              with the fewest recorded games (ties:
    #                              closest fitted ratings — near-50%
    #                              matchups carry the most information)
    #                              and plays a full rating arena between
    #                              the two snapshots. Opt-in: 0 adds no
    #                              rng splits (OFF path bit-identical).
    pool_in_checkpoint: bool = False  # persist the pool's parameter
    #                              snapshots inside the whole-state
    #                              checkpoint (zero-padded to pool_size).
    #                              Default off: the match graph always
    #                              persists (sidecar) and dominates the
    #                              anchored fit, but a freshly resumed run
    #                              rates against a thinner pool until it
    #                              repopulates; turning this on closes
    #                              that window at the cost of pool_size
    #                              extra parameter copies per checkpoint.


@dataclasses.dataclass(frozen=True)
class ReanalyzeConfig:
    """Replay-target refresh by re-search (no reference analogue; the
    MuZero-Reanalyze / SampledMuZero idea specialized to AlphaZero-style
    terminal-outcome training).

    Self-play additionally records every sampled position's canonical
    STATE (not just its features) into a position ring. Every ``interval``
    iterations the coach re-searches ``batch_size`` stored positions with
    the CURRENT net at the full budget, noise-free, and inserts the
    refreshed samples into the replay: policy target = the fresh root
    visit distribution, value target = the position's original game
    outcome (ground truth for board games — only the policy is stale).
    Old positions thereby keep contributing learner-grade policy targets
    as the net improves, buying sample efficiency at the cost of one
    extra batched search per pass."""

    batch_size: int = 1024       # positions re-searched per pass
    interval: int = 1            # run the pass every k coach iterations
    capacity: int = 1 << 16      # position-ring slots (pre-symmetry)
    num_sims: Optional[int] = None  # re-search budget; defaults to MCTS's
    record_stride: int = 1       # record every k-th valid sample. SIZING
    #                              RULE: the staleness window in iterations
    #                              is capacity*record_stride /
    #                              (selfplay.batch_size * avg game length)
    #                              — keep it >= a few iterations or the
    #                              ring wraps mid-iteration and the pass
    #                              refreshes targets that were never stale
    #                              (the coach reports the measured window
    #                              as `reanalyze_age_mean` per pass)


@dataclasses.dataclass(frozen=True)
class AZConfig:
    """Top-level run configuration."""

    mcts: MCTSConfig = dataclasses.field(default_factory=MCTSConfig)
    selfplay: SelfPlayConfig = dataclasses.field(default_factory=SelfPlayConfig)
    replay: ReplayConfig = dataclasses.field(default_factory=ReplayConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    arena: ArenaConfig = dataclasses.field(default_factory=ArenaConfig)
    reanalyze: Optional[ReanalyzeConfig] = None  # replay-target refresh by
    #                              re-search (off by default; see
    #                              ReanalyzeConfig)
    num_iterations: int = 10     # coach outer-loop iterations (num_iters,
    #                              examples/connect_four.rs:66)
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 1  # save the whole-state checkpoint every k
    #                              iterations (the replay buffer dominates
    #                              checkpoint bytes; large runs set k>1).
    #                              learn() always saves after its last
    #                              iteration regardless.
    replay_save_stride: int = 1  # 1 = every save carries the replay +
    #                              reanalyze rings (exact resume). k>1 =
    #                              only every k-th periodic save does; the
    #                              rest are LIGHT (params/opt/rng/pool +
    #                              sidecar — MBs instead of the rings'
    #                              hundreds). Resume restores the rings
    #                              from the newest ring-bearing checkpoint
    #                              and everything else from the newest
    #                              checkpoint, so at most (k-1)*interval
    #                              iterations of replay regenerate. The
    #                              final/preemption save always carries
    #                              the rings; retention never prunes the
    #                              newest ring-bearing checkpoint.
    keep_checkpoints: Optional[int] = None  # retention: after every save,
    #                              delete all but the newest k checkpoints
    #                              (sidecars included). None keeps
    #                              everything — the reference's behavior
    #                              (it never pruned its .examples files,
    #                              coach.rs:159-167); long production runs
    #                              set a small k so the multi-GB
    #                              replay-bearing checkpoints don't fill
    #                              the disk.
    skip_first_selfplay: bool = False  # skip self-play on the first
    #                              iteration after (re)start when the replay
    #                              already holds samples — train directly on
    #                              the restored examples (the reference's
    #                              `skip_first_play` learn() flag,
    #                              examples/connect_four.rs:73).
