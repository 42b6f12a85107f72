"""Multi-controller (multi-host) execution.

The reference's transport layer is in-process crossbeam channels
(reference: src/async_mcts.rs:22-23, 117-189) — its "hosts" are threads in
one address space. The accelerator-native replacement (SURVEY.md §5 "Distributed
communication backend") is multi-controller JAX: every host runs the SAME
Coach program under ``jax.distributed.initialize``, the device mesh spans
all hosts, and XLA's collectives (gradient ``psum`` on the ``data`` axis)
ride the devices' interconnect (NVLink within a host) and the
network across hosts. There is no message-passing
code to write: the jitted phases are already global-SPMD programs, so
multi-host is the single-controller code executed by N controllers.

What this module adds is the (small) host-side protocol around that:

* :func:`initialize` — process bring-up: wire the coordinator, optionally
  force a platform and virtual CPU device count (for testing a "multi-host"
  topology on one machine — the same mechanism the test suite uses for the
  virtual 8-device mesh, SURVEY.md §4).
* :func:`is_primary` / :func:`primary_only` — the process-0 gate for
  host-side side effects (metrics JSONL, checkpoint sidecars, progress
  printing). Device-side state needs no gating: it is global and identical
  by construction.
* :func:`replicate_host_value` — lift a host-local (assumed
  process-identical) array into a fully-replicated global array so it can
  participate in multiprocess checkpointing.

Tested by tests/test_multihost.py: two OS processes x 4 virtual CPU
devices each form one 8-device mesh and must reproduce the single-process
Coach iteration exactly.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import jax


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    platform: Optional[str] = None,
    host_device_count: Optional[int] = None,
) -> None:
    """Bring up this controller and join the multi-process runtime.

    Must run before any JAX computation. ``platform="cpu"`` +
    ``host_device_count=K`` gives this process K virtual CPU devices —
    the single-machine simulation of a K-chip host (the driver's
    ``xla_force_host_platform_device_count`` mechanism).
    """
    if host_device_count is not None:
        jax.config.update("jax_num_cpu_devices", host_device_count)
    if platform is not None:
        jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_primary() -> bool:
    """True on the process that owns host-side side effects (metrics,
    sidecars, stdout)."""
    return jax.process_index() == 0


def primary_only(fn):
    """Decorator: run ``fn`` only on process 0 (returns None elsewhere)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None

    return wrapped


def launch_local_multihost(
    args: list,
    num_processes: int = 2,
    devices_per_process: int = 4,
    timeout: float = 540.0,
):
    """Spawn ``num_processes`` OS processes of examples/train_multihost.py
    joined into one local multi-controller mesh (each with
    ``devices_per_process`` virtual CPU devices); return process 0's JSON
    records. Shared by tests/test_multihost.py and
    ``__graft_entry__.dryrun_multihost`` — the single copy of the launch
    recipe (port pick, env scrub, timeout kill)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # the parent may force a CPU topology of its own (test conftest) —
    # children must build theirs from the launcher flags alone
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.join(repo, "examples", "train_multihost.py"),
                "--coordinator", f"localhost:{port}",
                "--num-processes", str(num_processes),
                "--process-id", str(pid),
                "--platform", "cpu",
                "--host-devices", str(devices_per_process),
            ]
            + list(args),
            env=env,
            cwd=repo,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(num_processes)
    ]
    # One shared deadline across the whole gang: poll in short slices so a
    # process that dies early surfaces immediately (and takes the rest of
    # the gang down with it) instead of blocking the full timeout on
    # process 0 first.
    import time

    deadline = time.monotonic() + timeout
    outs: list = [None] * len(procs)
    pending = list(range(len(procs)))
    failed = None
    try:
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise subprocess.TimeoutExpired(procs[pending[0]].args, timeout)
            idx = pending[0]
            try:
                outs[idx] = procs[idx].communicate(timeout=min(remaining, 5.0))
            except subprocess.TimeoutExpired:
                # rotate: give every live process a slice of the deadline
                pending = pending[1:] + [idx]
                continue
            pending.remove(idx)
            if procs[idx].returncode != 0:
                failed = idx
                break
    finally:
        if pending or failed is not None:
            for q in procs:
                if q.poll() is None:
                    q.kill()
    if failed is not None:
        out, err = outs[failed]
        raise RuntimeError(
            f"multihost process {failed} failed rc={procs[failed].returncode}\n"
            f"stdout:\n{out}\nstderr:\n{err}"
        )
    records = [
        json.loads(line)
        for line in outs[0][0].splitlines()
        if line.startswith("{")
    ]
    if not records:
        raise RuntimeError(f"no JSON records from process 0:\n{outs[0][0]}")
    return records


def host_copy(tree: Any) -> Any:
    """Fetch a (possibly globally sharded) pytree to host numpy.

    ``jax.device_get`` raises on arrays spanning non-addressable devices
    (multi-controller runs with model-sharded params); such leaves are
    gathered across processes first so every process gets the full value.
    """
    from jax.experimental import multihost_utils

    import numpy as np

    def fetch(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            return np.asarray(multihost_utils.process_allgather(x, tiled=True))
        return jax.device_get(x)

    return jax.tree_util.tree_map(fetch, tree)


def replicate_host_value(x: Any, mesh) -> jax.Array:
    """Lift a host-local array (identical on every process, e.g. the PRNG
    key state) into a fully-replicated global array on ``mesh`` so that
    multiprocess checkpointing sees one global view."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.jit(
        lambda v: v, out_shardings=NamedSharding(mesh, P())
    )(x)
