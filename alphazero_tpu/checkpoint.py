"""Checkpoint / resume.

The reference has two mechanisms (SURVEY.md §5): bincode'd replay-history
files ``{iteration}.examples`` picked up by numeric stem on restart
(reference: src/coach.rs:55-81, 159-167 — with defect D6's absolute-path
join writing to filesystem root), and per-model ``{model_id}.pth.tar``
files owned by the Python net (python_nnet.rs:65-82). Crucially the
reference never persists the iteration counter or model_id.

Here one checkpoint per iteration captures the WHOLE training state:
incumbent params + optimizer + batch stats, the on-device replay ring, the
PRNG key, and the iteration/model-id counters — so resume is exact. The
Elo/metrics history rides along as a JSON sidecar.

On disk a checkpoint is a directory ``ckpt_NNNNNN/`` holding one ``.npy``
file per pytree leaf plus ``manifest.json`` (leaf key path -> file, dtype,
shape). It is written under ``ckpt_NNNNNN.tmp/`` and renamed into place,
so a crash never leaves a half-written ``ckpt_*`` directory.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional, Tuple

import jax
import numpy as np

_CKPT_RE = re.compile(r"^ckpt_(\d+)$")
_MANIFEST = "manifest.json"


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"ckpt_{step:06d}")


def _leaf_keys(tree: Any):
    """``[(key string, leaf)]`` in pytree order; keys are '/'-joined
    dict keys / attribute names / sequence indices."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for k in path:
            for attr in ("key", "name", "idx"):
                if hasattr(k, attr):
                    parts.append(str(getattr(k, attr)))
                    break
        out.append(("/".join(parts), leaf))
    return out


def _sync(tag: str) -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)


def save_checkpoint(
    directory: str, step: int, payload: Any, sidecar: Optional[dict] = None
) -> str:
    """Save a pytree payload as checkpoint ``step`` (+ JSON sidecar).

    Multi-controller: every process calls this. Leaves are gathered to
    host copies on every process (``parallel.distributed.host_copy``);
    process 0 writes them and the sidecar, and all processes leave
    together once the files are in place.

    Ordering invariant: the sidecar is written BEFORE the array directory
    is renamed into place, so a crash anywhere in this function leaves
    either (a) a dangling ``.json`` with no ``ckpt_*`` dir — invisible to
    ``latest_step``/``newest_ring_step``, which key off the dirs — or (b)
    a complete pair. The reverse order had a window where a LIGHT
    (``has_rings: false``) checkpoint existed without its sidecar and
    resume misclassified it as ring-bearing. ``Coach._maybe_resume``
    additionally falls back to the light/ring-split plan if an exact
    restore fails, covering same-step resaves that flip lightness."""
    from alphazero_tpu.parallel.distributed import host_copy

    path = _ckpt_path(directory, step)
    leaves = _leaf_keys(host_copy(payload))
    if jax.process_index() == 0:
        os.makedirs(directory, exist_ok=True)
        if sidecar is not None:
            with open(path + ".json", "w") as f:
                json.dump(sidecar, f)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {}
        for i, (key, leaf) in enumerate(leaves):
            arr = np.asarray(leaf)
            fname = f"{i:05d}.npy"
            # store the raw bits: np.save cannot describe extension dtypes
            # such as bfloat16, so the dtype name rides in the manifest
            np.save(
                os.path.join(tmp, fname),
                arr.reshape(-1).view(np.dtype(f"u{arr.dtype.itemsize}")),
            )
            manifest[key] = {
                "file": fname,
                "dtype": arr.dtype.name,
                "shape": list(arr.shape),
            }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(path, ignore_errors=True)  # same-step resave
        os.replace(tmp, path)
    _sync(f"ckpt_save_{step}")
    return path


def read_sidecar(directory: str, step: int) -> Optional[dict]:
    """The JSON sidecar for ``step``, or None. Cheap (no array reads):
    used to decide the restore plan (``has_rings``) before any arrays."""
    path = _ckpt_path(directory, step) + ".json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1))
        for name in os.listdir(directory)
        if (m := _CKPT_RE.match(name))
    )


def newest_ring_step(
    directory: str, exclude: Optional[int] = None
) -> Optional[int]:
    """Newest checkpoint whose sidecar does not mark it LIGHT
    (``has_rings: false``). Checkpoints written before the
    ``replay_save_stride`` feature carry no flag and count as
    ring-bearing (they always saved the rings). ``exclude`` skips one
    step whose classification is known-unreliable (a checkpoint whose
    exact restore just failed — its sidecar may be missing or describe
    a different same-step save)."""
    for step in reversed(_steps(directory)):
        if step == exclude:
            continue
        sidecar = read_sidecar(directory, step)
        if sidecar is None or sidecar.get("has_rings", True):
            return step
    return None


def prune_checkpoints(directory: str, keep: int) -> list:
    """Delete all but the newest ``keep`` checkpoints (and their JSON
    sidecars). Returns the pruned step numbers. Call from process 0 only
    in multi-controller runs, after ``save_checkpoint`` has returned.

    The newest RING-BEARING checkpoint is never pruned, even when older
    than the retention window: with ``replay_save_stride > 1`` it is the
    only durable copy of the replay/reanalyze rings that resume needs."""
    if keep < 1:
        return []
    steps = _steps(directory)
    protect = newest_ring_step(directory)
    pruned = [s for s in steps[:-keep] if s != protect]
    for step in pruned:
        path = _ckpt_path(directory, step)
        shutil.rmtree(path, ignore_errors=True)
        try:
            os.remove(path + ".json")
        except FileNotFoundError:
            pass
    return pruned


def latest_step(directory: str) -> Optional[int]:
    """Newest checkpoint step by numeric stem (the resume rule of
    coach.rs:61-76, applied to whole-state checkpoints)."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(
    directory: str, step: int, template: Any, partial: bool = False
) -> Tuple[Any, Optional[dict]]:
    """Restore payload (shaped like ``template``) + sidecar for ``step``.

    The checkpoint's leaves must match the template's key paths, shapes
    and dtypes exactly (``ValueError`` otherwise). ``partial=True``
    restores only the subtrees present in ``template`` (e.g. just the
    incumbent params for inference/play tools, skipping the replay
    buffer); without it the checkpoint may hold nothing the template
    lacks.

    Template leaves that are committed ``jax.Array``s carry their sharding
    into the restore: a mesh-sharded Coach resumes with every leaf placed
    exactly where ``__init__`` put it (each process builds its addressable
    shards from the files — required for multi-chip/multi-host resume).
    Other leaves restore onto the first local device."""
    path = _ckpt_path(directory, step)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    keyed = _leaf_keys(template)
    keys = [k for k, _ in keyed]
    missing = sorted(set(keys) - set(manifest))
    extra = sorted(set(manifest) - set(keys))
    if missing or (extra and not partial):
        raise ValueError(
            f"checkpoint {path} does not match the template: "
            f"missing {missing[:5]}, unexpected {extra[:5]}"
        )
    device = jax.local_devices()[0]
    leaves = []
    for key, tleaf in keyed:
        entry = manifest[key]
        want_dtype = np.dtype(tleaf.dtype if hasattr(tleaf, "dtype") else np.asarray(tleaf).dtype)
        if tuple(entry["shape"]) != tuple(np.shape(tleaf)) or entry["dtype"] != want_dtype.name:
            raise ValueError(
                f"checkpoint leaf {key}: saved {entry['dtype']}{entry['shape']}, "
                f"template {want_dtype.name}{list(np.shape(tleaf))}"
            )
        raw = np.load(os.path.join(path, entry["file"]))
        host = raw.view(want_dtype).reshape(entry["shape"])
        if isinstance(tleaf, jax.Array) and getattr(tleaf, "committed", False):
            leaves.append(
                jax.make_array_from_callback(
                    host.shape, tleaf.sharding, lambda idx, h=host: h[idx]
                )
            )
        else:
            leaves.append(jax.device_put(host, device))
    payload = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves
    )
    return payload, read_sidecar(directory, step)
