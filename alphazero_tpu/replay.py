"""On-device replay ring buffer.

Re-design of the reference's replay machinery: ``Coach.history`` — a deque
of per-iteration sample deques with FIFO trimming (reference:
src/coach.rs:18-34, 275-289) that is flattened, shuffled and AOS->SOA
converted on every train call (coach.rs:296-326). Here the replay is a
single fixed-capacity SoA ring buffer that lives in HBM: insertion is one
masked scatter (with symmetry expansion fused in — coach.rs:130-135 stored
symmetries at episode time), sampling is one gather with a fresh PRNG key.
Nothing ever crosses the host boundary.

FIFO semantics: the ring overwrite IS the history eviction — capacity plays
the role of ``max_history_length × max_queue_length``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from alphazero_tpu.config import ReplayConfig
from alphazero_tpu.selfplay import Trajectory


_LIMB_BITS = 30  # total = hi * 2^30 + lo; both limbs stay far from i32 range


class ReplayState(NamedTuple):
    """Packed ring: one row per sample, ``[features... | pi... | value]``.

    One packed f32[Cap, F+A+1] row (92 floats for connect-four) keeps
    each sample contiguous: insert is ONE scatter instead of three, and
    sampling is one row gather. Devices that tile an array's two minor
    dimensions would otherwise pad a narrow ``pi f32[Cap, 7]`` many times
    over."""

    data: jax.Array      # f32[Cap, F+A+1] packed rows
    pos: jax.Array       # i32[] next write slot
    size: jax.Array      # i32[] live sample count (<= Cap)
    total: jax.Array     # i32[2] lifetime samples as (hi, lo) base-2^30
    #                      limbs — a week-long multi-chip run exceeds i32,
    #                      and JAX's default 32-bit mode silently downgrades
    #                      int64, so the wide counter is kept in two limbs


def replay_total(replay: ReplayState) -> int:
    """Lifetime inserted-sample count as a Python int."""
    hi, lo = (int(x) for x in replay.total)
    return (hi << _LIMB_BITS) | lo


def _row_width(game) -> int:
    import math

    return math.prod(game.feature_shape) + game.num_actions + 1


def replay_init(game, cfg: ReplayConfig) -> ReplayState:
    cap = cfg.capacity
    return ReplayState(
        data=jnp.zeros((cap, _row_width(game)), jnp.float32),
        pos=jnp.zeros((), jnp.int32),
        size=jnp.zeros((), jnp.int32),
        total=jnp.zeros((2,), jnp.int32),
    )


def replay_unpack(replay: ReplayState, game):
    """(features, pi, value) views of the whole ring (tests/tools)."""
    import math

    F = math.prod(game.feature_shape)
    A = game.num_actions
    feats = replay.data[:, :F].reshape((-1,) + tuple(game.feature_shape))
    return feats, replay.data[:, F : F + A], replay.data[:, F + A]


def replay_insert(
    replay: ReplayState, game, traj: Trajectory
) -> ReplayState:
    """Insert all valid samples of a trajectory, expanded through
    ``game.symmetries`` (the vectorized coach.rs:130-135).

    Valid samples are compacted to consecutive ring slots via a prefix sum,
    so insertion order (and therefore eviction order) is deterministic:
    time-major, then batch, then symmetry index.
    """
    cap = replay.data.shape[0]

    sym_v = jax.vmap(game.symmetries)  # over flattened samples
    T, B = traj.valid.shape
    flat = lambda x: x.reshape((T * B,) + x.shape[2:])
    feats, pis = sym_v(flat(traj.features), flat(traj.pi))
    S = feats.shape[1]
    n = T * B * S
    feats = feats.reshape((n, -1))
    pis = pis.reshape((n, pis.shape[-1]))
    vals = jnp.repeat(flat(traj.value), S)
    valid = jnp.repeat(flat(traj.valid), S)
    rows = jnp.concatenate([feats, pis, vals[:, None]], axis=1)

    offs = jnp.cumsum(valid.astype(jnp.int32)) - 1
    idx = jnp.where(valid, (replay.pos + offs) % cap, cap)  # cap -> dropped
    num = valid.sum().astype(jnp.int32)

    lo = replay.total[1] + num
    total = jnp.stack(
        [replay.total[0] + (lo >> _LIMB_BITS), lo & ((1 << _LIMB_BITS) - 1)]
    )
    return ReplayState(
        data=replay.data.at[idx].set(rows, mode="drop"),
        pos=(replay.pos + num) % cap,
        size=jnp.minimum(replay.size + num, cap),
        total=total,
    )


def replay_sample(
    replay: ReplayState, rng: jax.Array, batch_size: int, game
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Uniform sample with replacement over the live region — the analogue
    of the reference's shuffle-then-epoch pass (coach.rs:311-315 +
    connect_four_net.py:127-151's minibatch loop). One row gather from the
    packed ring, split into (features, pi, value) on the way out."""
    import math

    idx = jax.random.randint(
        rng, (batch_size,), 0, jnp.maximum(replay.size, 1)
    )
    rows = replay.data[idx]
    F = math.prod(game.feature_shape)
    A = game.num_actions
    feats = rows[:, :F].reshape((batch_size,) + tuple(game.feature_shape))
    return feats, rows[:, F : F + A], rows[:, F + A]
