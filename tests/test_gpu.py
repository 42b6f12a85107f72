"""Card-only checks (``gpu`` marker): the search, the folded ResNet forward
and a Coach iteration on an NVIDIA GPU against the CPU backend of the same
process. They call the same check functions as ``chip_smoke.py`` phase
(b), at its sizes, and skip (with a reason) where JAX has no GPU. Run on a
card with:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -q -m gpu -p no:xdist
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

chip_smoke._import_repo()

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def resnet():
    from alphazero_tpu.models import init_model
    from train_connect_four import build_preset

    game, model, _ = build_preset("full", 0)
    return game, model, init_model(model, jax.random.key(0), game.feature_shape)


def test_uniform_search_matches_cpu_and_oracle(gpu_device):
    from alphazero_tpu.games import ConnectFour

    out = chip_smoke.check_uniform_search(ConnectFour(), 0)
    assert out["uniform_ms_per_move"] > 0


def test_folded_resnet_forward_matches_cpu(gpu_device, resnet):
    chip_smoke.check_resnet_forward(*resnet, 0)


def test_nn_backed_search_agrees_with_cpu(gpu_device, resnet):
    out = chip_smoke.check_nn_search(*resnet, 0)
    assert out["resnet_ms_per_move"] > 0


@pytest.mark.parametrize("game_name", ["connect_four", "gomoku", "othello", "hex"])
def test_vmapped_step_matches_cpu_at_batch_4096(gpu_device, game_name):
    """Game dynamics under vmap at a production batch: identical boards
    on the card and on the CPU backend."""
    from alphazero_tpu.games import ConnectFour, Gomoku, Hex, Othello

    game = {"connect_four": ConnectFour, "gomoku": Gomoku, "othello": Othello, "hex": Hex}[game_name]()
    cpu = jax.devices("cpu")[0]
    state = chip_smoke.random_positions(game, 4096, 10, seed=3) if game_name == "connect_four" else (
        jax.device_put(jax.vmap(lambda _: game.init())(jnp.arange(4096)), cpu)
    )
    valid = np.asarray(jax.vmap(game.valid_moves)(state))
    rng = np.random.default_rng(1)
    acts = jnp.asarray([rng.choice(np.nonzero(v)[0]) for v in valid])
    step = jax.jit(jax.vmap(game.step))
    on_card = step(jax.device_put(state, gpu_device), jax.device_put(acts, gpu_device))
    on_cpu = step(state, jax.device_put(acts, cpu))
    for a, b in zip(jax.tree_util.tree_leaves(on_card), jax.tree_util.tree_leaves(on_cpu)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_coach_iteration_runs_on_the_card(gpu_device):
    """A small complete Coach iteration (self-play -> replay -> train ->
    arena gate) placed on the card."""
    from alphazero_tpu.coach import Coach
    from alphazero_tpu.config import ArenaConfig, AZConfig, MCTSConfig, ReplayConfig, SelfPlayConfig, TrainConfig
    from alphazero_tpu.games import ConnectFour
    from alphazero_tpu.models import MLPNet

    game = ConnectFour()
    cfg = AZConfig(
        mcts=MCTSConfig(num_sims=16, max_depth=24),
        selfplay=SelfPlayConfig(batch_size=256, temp_threshold=6),
        replay=ReplayConfig(capacity=1 << 14),
        train=TrainConfig(batch_size=128, steps_per_iteration=8),
        arena=ArenaConfig(num_games=64, update_threshold=0.6, num_sims=8),
    )
    coach = Coach(game, MLPNet(num_actions=game.num_actions, hidden=(32,)), cfg)
    rec = coach.run_iteration()
    assert coach.replay.data.devices() == {gpu_device}
    assert np.isfinite(rec["loss_last"]) and rec["selfplay_moves"] > 256
