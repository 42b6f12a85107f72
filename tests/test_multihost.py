"""Multi-controller (multi-host) execution tests.

The real thing, not a simulation of the API: two OS processes are spawned
via examples/train_multihost.py (the shipped launcher), each given 4
virtual CPU devices, joined through ``jax.distributed.initialize`` into
ONE 8-device global mesh. The pair must reproduce the single-process
Coach run of the identical config exactly — the multi-host claim
(SURVEY.md §5 comm backend; BASELINE config 5) backed by an executable
artifact.

Replaces nothing in the reference (it is single-process by design,
src/async_mcts.rs:117-189 channels); this is the multi-controller scale-out
path those channels map to.
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = [
    "--net", "mlp", "--hidden", "32",
    "--sims", "8", "--max-depth", "16",
    "--batch", "16", "--temp-threshold", "6",
    "--capacity", "2048", "--train-batch", "32", "--train-steps", "4",
    "--arena-games", "8", "--seed", "7",
]


def _launch_pair(extra, timeout=540):
    """Run the 2-process launcher; return process 0's JSON records
    (shared recipe: alphazero_tpu.parallel.distributed)."""
    from alphazero_tpu.parallel.distributed import launch_local_multihost

    return launch_local_multihost(TINY + extra, timeout=timeout)


def _reference_record(tmp_path):
    """Single-process run of the IDENTICAL config (the launcher's own
    config builder, so there is no drift between the two sides)."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import train_multihost as tm
    finally:
        sys.path.pop(0)
    args = tm.parse_args(
        ["--coordinator", "unused", "--num-processes", "1", "--process-id", "0"]
        + TINY
        + ["--iterations", "1"]
    )
    game, model = tm.build_game_and_model(args)
    cfg = tm.build_cfg(args)
    from alphazero_tpu.coach import Coach

    return Coach(game, model, cfg).run_iteration()


def test_two_process_coach_matches_single_process(tmp_path):
    ckpt = str(tmp_path / "mh_ckpt")
    records = _launch_pair(["--iterations", "1", "--checkpoint-dir", ckpt])
    ref = _reference_record(tmp_path)

    got = records[-1]
    for k in (
        "iteration", "model_id", "accepted",
        "arena_wins", "arena_losses", "arena_draws",
        "replay_size", "replay_total", "selfplay_moves",
    ):
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert got["loss_first"] == pytest.approx(ref["loss_first"], abs=1e-6)
    assert got["loss_last"] == pytest.approx(ref["loss_last"], abs=1e-6)

    # the pair wrote a real (multiprocess) checkpoint...
    from alphazero_tpu.checkpoint import latest_step

    assert latest_step(ckpt) == 1

    # ...that a NEW process pair resumes from: iteration continues at 2
    records2 = _launch_pair(["--iterations", "1", "--checkpoint-dir", ckpt])
    assert records2[-1]["iteration"] == 2
    assert latest_step(ckpt) == 2
