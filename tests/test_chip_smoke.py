"""chip_smoke.py's contract off the card, and the compile-cache rule.

The script's phases need an NVIDIA GPU (tests/test_gpu.py runs them
there); what is checked here: it refuses to run without a GPU or outside
its checkout and then prints no result, its last line has the agreed
format, the ``--four-cards`` option selects that phase and nothing else,
and the entry points' compilation-cache directory follows one rule.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

chip_smoke._import_repo()  # the package and examples/ on sys.path


def _run_script(cwd, script, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, script],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_refuses_without_a_gpu():
    out = _run_script(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert out.stdout.strip() == ""  # no result line, no phase output
    assert "needs a GPU" in out.stderr


def test_refuses_outside_its_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "checkout" in out.stderr


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line(count)
    assert "\n" not in line
    obj = json.loads(line)
    dev = jax.devices()[0]
    assert obj == {
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": count},
    }


@pytest.mark.parametrize(
    "argv, phase, count",
    [([], "one_card", 1), (["--four-cards"], "four_cards", 4), (["--seed", "3"], "one_card", 1)],
)
def test_option_selects_only_its_phase(monkeypatch, capsys, argv, phase, count):
    from alphazero_tpu.utils import compile_cache

    called = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "cache")
    monkeypatch.setattr(chip_smoke, "device_check", lambda n: called.append(("device", n)) or "card, 700 W")
    monkeypatch.setattr(chip_smoke, "one_card", lambda seed: called.append(("one_card", seed)))
    monkeypatch.setattr(chip_smoke, "four_cards", lambda seed: called.append(("four_cards", seed)))
    assert chip_smoke.main(argv) == 0
    seed = 3 if "--seed" in argv else 0
    assert called == [("device", count), (phase, seed)]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["device"]["count"] == count
    assert any("card, 700 W" in l for l in lines[:-1])  # name + limit before the last line


def test_the_only_cut_is_the_rating_ladder():
    """The smoke config differs from the full preset only in the allowed
    cut: widths, batch, sims, ring size and learner steps are the
    preset's own."""
    import dataclasses

    from train_connect_four import build_preset

    _, model, preset = build_preset("full", 0)
    _, model2, cfg = chip_smoke.full_preset(0)
    assert model2 == model
    assert cfg.mcts == preset.mcts and cfg.selfplay == preset.selfplay
    assert cfg.replay == preset.replay
    assert cfg.train == preset.train
    assert (cfg.train.batch_size, cfg.train.steps_per_iteration) == (1024, 512)
    assert cfg.arena.anchor_ladder == () and preset.arena.anchor_ladder == (400, 1600)
    assert dataclasses.replace(cfg.arena, anchor_ladder=(400, 1600)) == preset.arena
    assert (cfg.selfplay.batch_size, cfg.mcts.num_sims, cfg.replay.capacity) == (4096, 100, 1 << 21)


def test_resnet_forward_tolerance_rule():
    import numpy as np

    assert chip_smoke.resnet_forward_tolerance(np.array([0.5])) == 26 * 2.0**-9
    assert chip_smoke.resnet_forward_tolerance(np.array([-4.0, 2.0])) == 4 * 26 * 2.0**-9


def test_random_positions_are_legal_and_live():
    from alphazero_tpu.games import ConnectFour

    game = ConnectFour()
    state = chip_smoke.random_positions(game, 24, 9, seed=1)
    done, _ = jax.vmap(game.terminal)(state)
    assert not bool(done.any())
    stones = (state.board != 0).sum(axis=(1, 2))
    assert stones.tolist() == [i % 10 for i in range(24)]


# ------------------------------------------------------- compile cache


@pytest.mark.parametrize("env_dir", [None, "/some/shared/cache"])
def test_compile_cache_rule(monkeypatch, env_dir):
    from alphazero_tpu.utils import compile_cache

    prev = jax.config.jax_compilation_cache_dir
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert compile_cache.enable_compile_cache() == env_dir
        assert updates == []  # JAX reads the variable itself; nothing set
    assert jax.config.jax_compilation_cache_dir == prev


def test_compile_cache_dir_is_the_checkouts_own():
    from alphazero_tpu.utils import compile_cache

    assert compile_cache.CHECKOUT == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
