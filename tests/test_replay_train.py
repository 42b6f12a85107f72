"""Replay ring buffer + learner step tests (reference coverage analogue:
the history management in coach.rs:275-326 and the TF1 loss spec, neither
of which had tests)."""

import jax
import jax.numpy as jnp
import numpy as np

from alphazero_tpu.config import MCTSConfig, ReplayConfig, SelfPlayConfig, TrainConfig
from alphazero_tpu.games import ConnectFour
from alphazero_tpu.models import AZResNet, MLPNet, make_uniform_model
from alphazero_tpu.replay import replay_init, replay_insert, replay_sample, replay_total
from alphazero_tpu.selfplay import Trajectory, make_selfplay_fn
from alphazero_tpu.train import init_train_state, make_train_step, variables_of

G = ConnectFour()


def tiny_traj(T=3, B=2, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.rand(T, B, 6, 7, 2).astype(np.float32)
    pi = rng.dirichlet(np.ones(7), size=(T, B)).astype(np.float32)
    value = rng.choice([-1.0, 1.0], size=(T, B)).astype(np.float32)
    valid = np.ones((T, B), bool)
    valid[2, 1] = False
    return Trajectory(
        features=jnp.asarray(feats),
        pi=jnp.asarray(pi),
        value=jnp.asarray(value),
        valid=jnp.asarray(valid),
    )


def test_replay_insert_counts_and_symmetry_expansion():
    replay = replay_init(G, ReplayConfig(capacity=64))
    traj = tiny_traj()
    replay = replay_insert(replay, G, traj)
    # 5 valid samples × 2 symmetries
    assert int(replay.size) == 10
    assert int(replay.pos) == 10
    assert replay_total(replay) == 10
    # mirrored sample sits right after its identity twin
    from alphazero_tpu.replay import replay_unpack

    fs, ps, vs = replay_unpack(replay, G)
    f, p, v = np.asarray(fs), np.asarray(ps), np.asarray(vs)
    np.testing.assert_array_equal(f[1], f[0][:, ::-1, :])
    np.testing.assert_array_equal(p[1], p[0][::-1])
    assert v[0] == v[1]


def test_replay_ring_wrap():
    replay = replay_init(G, ReplayConfig(capacity=8))
    for seed in range(3):
        replay = replay_insert(replay, G, tiny_traj(seed=seed))
    assert int(replay.size) == 8
    assert replay_total(replay) == 30
    assert int(replay.pos) == 30 % 8


def test_replay_sample_bounds():
    replay = replay_init(G, ReplayConfig(capacity=32))
    replay = replay_insert(replay, G, tiny_traj())
    feats, pi, v = replay_sample(replay, jax.random.key(0), 16, G)
    assert feats.shape == (16, 6, 7, 2)
    assert pi.shape == (16, 7)
    assert np.all(np.abs(np.asarray(v)) <= 1.0)
    # sampled rows must be real inserted rows (nonzero features)
    assert np.asarray(feats).reshape(16, -1).sum(-1).min() > 0


def test_train_step_reduces_loss_mlp():
    model = MLPNet(num_actions=7, hidden=(32,))
    cfg = TrainConfig(learning_rate=1e-2, l2_scale=0.0)
    state = init_train_state(model, jax.random.key(0), G.feature_shape, cfg)
    step = jax.jit(make_train_step(model, cfg))
    feats = jax.random.uniform(jax.random.key(1), (64, 6, 7, 2))
    # one-hot policy targets: CE is fully reducible, so the loss must drop
    pi_t = jax.nn.one_hot(
        jax.random.randint(jax.random.key(2), (64,), 0, 7), 7
    )
    v_t = jnp.sign(jax.random.normal(jax.random.key(3), (64,)))
    losses = []
    for i in range(30):
        state, m = step(state, feats, pi_t, v_t, jax.random.key(i))
        losses.append(float(m.loss))
    assert losses[-1] < losses[0] * 0.7
    assert int(state.step) == 30


def test_train_step_updates_batch_stats_resnet():
    model = AZResNet(num_actions=7, channels=8, blocks=1, value_hidden=16)
    cfg = TrainConfig(learning_rate=1e-3)
    state = init_train_state(model, jax.random.key(0), G.feature_shape, cfg)
    bs_before = jax.tree_util.tree_leaves(state.batch_stats)
    assert bs_before, "resnet must carry batch_stats"
    step = jax.jit(make_train_step(model, cfg))
    feats = jax.random.uniform(jax.random.key(1), (16, 6, 7, 2))
    pi_t = jnp.full((16, 7), 1 / 7)
    v_t = jnp.zeros((16,))
    state2, m = step(state, feats, pi_t, v_t, jax.random.key(2))
    changed = any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(
            jax.tree_util.tree_leaves(state.batch_stats),
            jax.tree_util.tree_leaves(state2.batch_stats),
        )
    )
    assert changed
    # inference apply consumes the running stats without error
    logits, v = model.apply(variables_of(state2), feats, train=False)
    assert logits.shape == (16, 7) and v.shape == (16,)
    assert np.all(np.abs(np.asarray(v)) <= 1.0)


def test_end_to_end_selfplay_to_train():
    """Full slice: self-play -> replay -> train step, all jitted."""
    net = make_uniform_model(G)
    sp = jax.jit(
        make_selfplay_fn(
            G,
            net.apply_fn,
            MCTSConfig(num_sims=15, max_depth=48),
            SelfPlayConfig(batch_size=4, temp_threshold=15),
        )
    )
    traj, stats = sp({}, jax.random.key(0))
    replay = replay_init(G, ReplayConfig(capacity=1024))
    replay = jax.jit(lambda r, t: replay_insert(r, G, t))(replay, traj)
    assert int(replay.size) > 0

    model = MLPNet(num_actions=7, hidden=(32,))
    cfg = TrainConfig(learning_rate=1e-3)
    tstate = init_train_state(model, jax.random.key(1), G.feature_shape, cfg)
    step = jax.jit(make_train_step(model, cfg))
    feats, pi_t, v_t = replay_sample(replay, jax.random.key(2), 32, G)
    tstate, m = step(tstate, feats, pi_t, v_t, jax.random.key(3))
    assert np.isfinite(float(m.loss))


def test_azconvnet_reference_architecture_trains():
    """AZConvNet is the reference TF1 model's architecture spec
    (connect_four_net.py:20-112 — 4x conv3x3 SAME/SAME/VALID/VALID + BN +
    dense 1024/512 + dropout + pi/v heads): forward shapes, dropout rng
    path and one finite train step."""
    from alphazero_tpu.models import AZConvNet, make_apply_fn
    from alphazero_tpu.models.nets import init_model

    game = ConnectFour()
    model = AZConvNet(num_actions=game.num_actions, channels=32)
    variables = init_model(model, jax.random.key(0), game.feature_shape)
    apply_fn = make_apply_fn(model)
    feats = jnp.zeros((4,) + game.feature_shape, jnp.float32)
    logits, v = apply_fn(variables, feats)
    assert logits.shape == (4, game.num_actions) and v.shape == (4,)

    tcfg = TrainConfig(batch_size=8, steps_per_iteration=1)
    state = init_train_state(model, jax.random.key(1), game.feature_shape, tcfg)
    step = jax.jit(make_train_step(model, tcfg))
    f = jax.random.normal(jax.random.key(2), (8,) + game.feature_shape)
    pi_t = jnp.full((8, game.num_actions), 1.0 / game.num_actions)
    v_t = jnp.zeros((8,))
    state2, metrics = step(state, f, pi_t, v_t, jax.random.key(3))
    assert np.isfinite(float(metrics.loss))
    # dropout + BN actually engaged (batch_stats updated)
    bs0 = jax.tree_util.tree_leaves(state.batch_stats)
    bs1 = jax.tree_util.tree_leaves(state2.batch_stats)
    assert any(
        not np.allclose(np.asarray(a), np.asarray(b)) for a, b in zip(bs0, bs1)
    )
