"""alphazero_tpu — an accelerator-native AlphaZero framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the Rust reference
``AnimatedRNG/alphazero-rs`` (see SURVEY.md). Instead of the reference's
thread-and-channel architecture (lock-free node arena ``src/node.rs``, async
inference service thread ``src/async_mcts.rs:117-189``, rayon episode pool
``src/coach.rs:202-272``), everything here is vectorized: pure-JAX batched
game dynamics, an array-based MCTS stepping thousands of trees in lockstep
under ``jit``, the NN forward pass fused into the search loop, and a
self-play -> replay -> data-parallel learner -> arena pipeline sharded over
a ``jax.sharding.Mesh``.

Public surface:
  - :mod:`alphazero_tpu.games`    — the ``Game`` protocol + Connect-Four / Othello
  - :mod:`alphazero_tpu.mcts`     — vectorized tree + PUCT search
  - :mod:`alphazero_tpu.models`   — policy/value networks (uniform, MLP, ResNet)
  - :mod:`alphazero_tpu.replay`   — on-device replay ring buffer
  - :mod:`alphazero_tpu.coach`    — self-play / train / gate outer loop
  - :mod:`alphazero_tpu.arena`    — batched model-vs-model evaluation + Elo
  - :mod:`alphazero_tpu.parallel` — mesh / sharding utilities
"""

from alphazero_tpu.config import (
    AZConfig,
    ArenaConfig,
    MCTSConfig,
    ReanalyzeConfig,
    ReplayConfig,
    SelfPlayConfig,
    TrainConfig,
)

__version__ = "0.1.0"

__all__ = [
    "AZConfig",
    "ArenaConfig",
    "MCTSConfig",
    "ReanalyzeConfig",
    "ReplayConfig",
    "SelfPlayConfig",
    "TrainConfig",
    "__version__",
]
