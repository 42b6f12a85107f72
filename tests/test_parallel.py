"""Mesh/sharding tests on the virtual 8-device CPU mesh (SURVEY.md §4:
multi-host strategy via xla_force_host_platform_device_count).

Validates that the data-parallel sharding of self-play, replay and the
learner (a) compiles and executes over a real Mesh, and (b) is
value-identical to the unsharded computation — the collectives XLA inserts
must not change semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from alphazero_tpu.config import MCTSConfig, ReplayConfig, SelfPlayConfig, TrainConfig
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.models import MLPNet, make_uniform_model
from alphazero_tpu.parallel import batch_sharding, make_mesh, param_shardings, shard_batch
from alphazero_tpu.replay import replay_init, replay_insert, replay_sample
from alphazero_tpu.selfplay import make_selfplay_fn
from alphazero_tpu.train import init_train_state, make_train_step, variables_of

G = ConnectFour()


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["data"] == 8
    mesh2 = make_mesh((4, 2))
    assert mesh2.shape == {"data": 4, "model": 2}


def test_sharded_selfplay_matches_unsharded():
    net = make_uniform_model(G)
    sp = make_selfplay_fn(
        G,
        net.apply_fn,
        MCTSConfig(num_sims=8, max_depth=16),
        SelfPlayConfig(batch_size=16, temp_threshold=6),
    )
    key = jax.random.key(0)
    traj_ref, stats_ref = jax.jit(sp)({}, key)

    mesh = make_mesh()
    data_p = NamedSharding(mesh, P(None, "data"))
    sp_sharded = jax.jit(
        sp,
        out_shardings=(
            jax.tree_util.tree_map(
                lambda _: data_p, jax.eval_shape(sp, {}, key)[0]
            ),
            None,
        ),
    )
    traj_sh, stats_sh = sp_sharded({}, key)
    np.testing.assert_array_equal(np.asarray(traj_ref.pi), np.asarray(traj_sh.pi))
    np.testing.assert_array_equal(
        np.asarray(stats_ref.num_moves), np.asarray(stats_sh.num_moves)
    )
    # outputs actually live sharded over the mesh
    assert len(traj_sh.pi.sharding.device_set) == 8


def test_sharded_train_step_matches_unsharded():
    model = MLPNet(num_actions=7, hidden=(32,))
    cfg = TrainConfig(learning_rate=1e-3)
    state = init_train_state(model, jax.random.key(0), G.feature_shape, cfg)
    step = make_train_step(model, cfg)
    feats = jax.random.uniform(jax.random.key(1), (64, 6, 7, 2))
    pi_t = jax.nn.one_hot(jax.random.randint(jax.random.key(2), (64,), 0, 7), 7)
    v_t = jnp.sign(jax.random.normal(jax.random.key(3), (64,)))
    rng = jax.random.key(4)

    ref_state, ref_m = jax.jit(step)(state, feats, pi_t, v_t, rng)

    mesh = make_mesh()
    bp = batch_sharding(mesh)
    sh_state, sh_m = jax.jit(step)(
        state,
        jax.device_put(feats, bp),
        jax.device_put(pi_t, bp),
        jax.device_put(v_t, bp),
        rng,
    )
    # gradient psum across shards must reproduce the single-device update
    np.testing.assert_allclose(
        float(ref_m.loss), float(sh_m.loss), rtol=1e-6
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(ref_state.params),
        jax.tree_util.tree_leaves(sh_state.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-6)


def test_tensor_parallel_param_shardings():
    model = MLPNet(num_actions=7, hidden=(64,))
    cfg = TrainConfig()
    state = init_train_state(model, jax.random.key(0), G.feature_shape, cfg)
    mesh = make_mesh((4, 2))
    shardings = param_shardings(mesh, state.params)
    placed = jax.tree_util.tree_map(jax.device_put, state.params, shardings)
    # the 64-wide hidden kernel shards over the 2-way model axis
    kernel = placed["Dense_0"]["kernel"]
    assert len(kernel.sharding.device_set) in (2, 8)
    # forward pass under the mesh still works and matches
    feats = jax.random.uniform(jax.random.key(1), (16, 6, 7, 2))
    ref_logits, ref_v = model.apply({"params": state.params}, feats, train=False)
    sh_logits, sh_v = jax.jit(
        lambda p, f: model.apply({"params": p}, f, train=False)
    )(placed, jax.device_put(feats, batch_sharding(mesh)))
    np.testing.assert_allclose(
        np.asarray(ref_logits), np.asarray(sh_logits), rtol=2e-5, atol=1e-5
    )


def test_sharded_replay_roundtrip():
    mesh = make_mesh()
    replay = replay_init(G, ReplayConfig(capacity=1024))
    rep_sh = NamedSharding(mesh, P("data"))
    replay = replay._replace(data=jax.device_put(replay.data, rep_sh))
    net = make_uniform_model(G)
    sp = jax.jit(
        make_selfplay_fn(
            G,
            net.apply_fn,
            MCTSConfig(num_sims=4, max_depth=8),
            SelfPlayConfig(batch_size=8, temp_threshold=4),
        )
    )
    traj, _ = sp({}, jax.random.key(0))
    replay = jax.jit(lambda r, t: replay_insert(r, G, t))(replay, traj)
    assert int(replay.size) > 0
    feats, pi, v = replay_sample(replay, jax.random.key(1), 32, G)
    assert feats.shape == (32, 6, 7, 2)
    assert np.isfinite(np.asarray(pi)).all()


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_mesh_coach_matches_unsharded():
    """A full Coach iteration under the 8-device mesh (BASELINE config 5's
    pipeline: sharded self-play -> replay -> DP learner -> arena gate)
    produces the same record as the single-device Coach."""
    from alphazero_tpu.coach import Coach
    from alphazero_tpu.config import ArenaConfig, AZConfig
    from alphazero_tpu.models import MLPNet

    cfg = AZConfig(
        mcts=MCTSConfig(num_sims=8, max_depth=16),
        selfplay=SelfPlayConfig(batch_size=16, temp_threshold=6),
        replay=ReplayConfig(capacity=2048),
        train=TrainConfig(batch_size=32, steps_per_iteration=4),
        arena=ArenaConfig(num_games=8, update_threshold=0.6, num_sims=4),
        seed=7,
    )
    records = {}
    for mesh in (None, make_mesh()):
        model = MLPNet(num_actions=G.num_actions, hidden=(32,))
        coach = Coach(G, model, cfg, mesh=mesh)
        records["mesh" if mesh else "single"] = coach.run_iteration()

    a, b = records["single"], records["mesh"]
    for k in ("replay_size", "selfplay_moves", "arena_wins", "arena_losses",
              "arena_draws", "accepted", "model_id"):
        assert a[k] == b[k], (k, a[k], b[k])
    np.testing.assert_allclose(a["loss_first"], b["loss_first"], atol=1e-5)
    np.testing.assert_allclose(a["loss_last"], b["loss_last"], atol=1e-5)


def test_mesh_checkpoint_resume_preserves_shardings(tmp_path):
    """Sharded save -> sharded restore: every leaf comes back on the mesh
    placement __init__ chose (committed-template shardings drive the
    restore; no host-side restore + silent replication)."""
    from alphazero_tpu.coach import Coach
    from alphazero_tpu.config import ArenaConfig, AZConfig
    from alphazero_tpu.models import MLPNet
    from alphazero_tpu.replay import replay_total

    cfg = AZConfig(
        mcts=MCTSConfig(num_sims=6, max_depth=16),
        selfplay=SelfPlayConfig(batch_size=16, temp_threshold=4),
        replay=ReplayConfig(capacity=2048),
        train=TrainConfig(batch_size=32, steps_per_iteration=2),
        arena=ArenaConfig(num_games=8, update_threshold=0.6, num_sims=4),
        seed=11,
        checkpoint_dir=str(tmp_path),
    )
    mesh = make_mesh()
    model = MLPNet(num_actions=G.num_actions, hidden=(32,))
    coach = Coach(G, model, cfg, mesh=mesh)
    coach.learn(1)
    saved_total = replay_total(coach.replay)
    saved_params = jax.tree_util.tree_leaves(coach.incumbent.params)

    model2 = MLPNet(num_actions=G.num_actions, hidden=(32,))
    resumed = Coach(G, model2, cfg, mesh=mesh)
    assert resumed.iteration == 1
    assert replay_total(resumed.replay) == saved_total
    for a, b in zip(
        saved_params, jax.tree_util.tree_leaves(resumed.incumbent.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # restored replay rows are actually data-sharded over the mesh,
    # not replicated: each of the 8 devices holds 1/8 of the ring
    feat = resumed.replay.data
    assert len(feat.sharding.device_set) == 8
    shard_rows = {s.data.shape[0] for s in feat.addressable_shards}
    assert shard_rows == {feat.shape[0] // 8}
    # params replicated on the mesh as placed by __init__
    p0 = jax.tree_util.tree_leaves(resumed.incumbent.params)[0]
    assert p0.sharding.is_fully_replicated
    # resumed coach trains on
    rec = resumed.run_iteration()
    assert rec["iteration"] == 2


def test_sharded_gumbel_selfplay_matches_unsharded():
    """The gumbel engine is pure XLA, so it must shard through GSPMD like
    the general engine: value-identical under the 8-device mesh."""
    net = make_uniform_model(G)
    sp = make_selfplay_fn(
        G,
        net.apply_fn,
        MCTSConfig(num_sims=8, max_depth=16, gumbel=True),
        SelfPlayConfig(batch_size=16, temp_threshold=6),
    )
    key = jax.random.key(0)
    traj_ref, stats_ref = jax.jit(sp)({}, key)

    mesh = make_mesh()
    data_p = NamedSharding(mesh, P(None, "data"))
    sp_sharded = jax.jit(
        sp,
        out_shardings=(
            jax.tree_util.tree_map(
                lambda _: data_p, jax.eval_shape(sp, {}, key)[0]
            ),
            None,
        ),
    )
    traj_sh, stats_sh = sp_sharded({}, key)
    np.testing.assert_array_equal(np.asarray(traj_ref.pi), np.asarray(traj_sh.pi))
    np.testing.assert_array_equal(
        np.asarray(stats_ref.num_moves), np.asarray(stats_sh.num_moves)
    )
    assert len(traj_sh.pi.sharding.device_set) == 8


def test_host_copy_returns_numpy_for_sharded_trees():
    """host_copy must hand back plain numpy for every leaf — sharded
    jax.Arrays, replicated arrays, and already-host values alike (the
    pool-snapshot fetch path, coach.py::_pool_insert)."""
    from alphazero_tpu.parallel.distributed import host_copy

    mesh = make_mesh()
    sharded = shard_batch(mesh, jnp.arange(16.0).reshape(16, 1))
    tree = {
        "sharded": sharded,
        "replicated": jax.device_put(
            jnp.ones((3,)), NamedSharding(mesh, P())
        ),
        "host": np.arange(4),
    }
    out = host_copy(tree)
    for leaf in jax.tree_util.tree_leaves(out):
        assert isinstance(leaf, np.ndarray) and not isinstance(leaf, jax.Array)
    np.testing.assert_array_equal(out["sharded"], np.arange(16.0).reshape(16, 1))
    np.testing.assert_array_equal(out["replicated"], np.ones((3,)))


def test_mesh_pool_in_checkpoint(tmp_path):
    """Anchored-pool snapshots persist and restore under a mesh
    (per-leaf replicate_host_value on save, host_copy on restore)."""
    import dataclasses

    from alphazero_tpu.coach import Coach
    from alphazero_tpu.config import ArenaConfig, AZConfig, TrainConfig
    from alphazero_tpu.models import MLPNet

    cfg = AZConfig(
        mcts=MCTSConfig(num_sims=6, max_depth=16),
        selfplay=SelfPlayConfig(batch_size=16, temp_threshold=4),
        replay=ReplayConfig(capacity=2048),
        train=TrainConfig(batch_size=32, steps_per_iteration=2),
        arena=ArenaConfig(
            num_games=8, update_threshold=None, num_sims=4,
            anchor_interval=1, pool_size=2, pool_in_checkpoint=True,
        ),
        seed=13,
        checkpoint_dir=str(tmp_path),
    )
    mesh = make_mesh()
    coach = Coach(G, MLPNet(num_actions=G.num_actions, hidden=(32,)), cfg, mesh=mesh)
    coach.learn(3)
    assert len(coach.pool) == 2

    resumed = Coach(
        G, MLPNet(num_actions=G.num_actions, hidden=(32,)), cfg, mesh=mesh
    )
    assert [g for g, _ in resumed.pool] == [g for g, _ in coach.pool]
    for (_, a), (_, b) in zip(coach.pool, resumed.pool):
        for la, lb in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        ):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    rec = resumed.run_iteration()
    assert "anchored_elo" in rec


def test_sharded_recycling_selfplay_matches_unsharded():
    """The recycling actor under the mesh: sharded == unsharded exactly
    (games never interact; the fragment carry shards on its B axis)."""
    from alphazero_tpu.selfplay import ActorCarry, make_recycling_selfplay_fn

    net = make_uniform_model(G)
    init_carry, rec = make_recycling_selfplay_fn(
        G,
        net.apply_fn,
        MCTSConfig(num_sims=8, max_depth=16),
        SelfPlayConfig(batch_size=16, temp_threshold=6),
    )
    key = jax.random.key(3)
    carry0 = jax.jit(init_carry)()
    carry_ref, traj_ref, stats_ref = jax.jit(rec)({}, carry0, key)

    mesh = make_mesh()
    data_tb = NamedSharding(mesh, P(None, "data"))
    data_b = NamedSharding(mesh, P("data"))
    carry_sd = jax.eval_shape(init_carry)
    carry_sh = ActorCarry(
        state=jax.tree_util.tree_map(lambda _: data_b, carry_sd.state),
        move_count=data_b,
        frag_features=data_tb,
        frag_pi=data_tb,
    )
    carry0_sh = jax.jit(init_carry, out_shardings=carry_sh)()
    sp_sd = jax.eval_shape(rec, {}, carry_sd, key)
    rec_sharded = jax.jit(
        rec,
        out_shardings=(
            carry_sh,
            jax.tree_util.tree_map(lambda _: data_tb, sp_sd[1]),
            jax.tree_util.tree_map(lambda _: data_b, sp_sd[2]),
        ),
    )
    carry_sh_out, traj_sh, stats_sh = rec_sharded({}, carry0_sh, key)
    np.testing.assert_array_equal(
        np.asarray(traj_ref.pi), np.asarray(traj_sh.pi)
    )
    np.testing.assert_array_equal(
        np.asarray(traj_ref.value), np.asarray(traj_sh.value)
    )
    np.testing.assert_array_equal(
        np.asarray(carry_ref.move_count), np.asarray(carry_sh_out.move_count)
    )
    assert len(traj_sh.pi.sharding.device_set) == 8
