"""Device mesh / sharding utilities — the communication backend.

The reference's only transport is in-process crossbeam channels + shared
memory (reference: src/async_mcts.rs:22-23, 117-189; src/coach.rs:180-182;
SURVEY.md §5 "Distributed communication backend: none"). The accelerator-native
equivalent is a ``jax.sharding.Mesh`` with named axes:

* ``data`` — the game/sample batch axis. Self-play trees, replay slots and
  learner minibatches shard here; gradient means become XLA-inserted
  ``psum`` collectives.
* ``model`` — optional tensor-parallel axis for large nets: parameter
  leaves whose trailing (output-channel) dimension divides the axis size
  are sharded there.

Everything is single-controller ``jit``-with-shardings: pick the mesh,
annotate in/out shardings, let XLA insert the collectives. Multi-host
extension is the same code under ``jax.distributed.initialize`` (the mesh
simply spans hosts; data stays host-local along ``data``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a mesh over the available devices.

    ``shape=None`` puts every device on the leading (data) axis. A 2D
    ``shape=(d, m)`` splits devices into data × model."""
    devs = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, tuple(axis_names[: arr.ndim]))


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding for an array whose leading dim is the game/sample batch."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree: Any, axis: str = "data") -> Any:
    """Device_put every leaf with its leading dim sharded over ``axis``."""
    sh = batch_sharding(mesh, axis)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def param_shardings(mesh: Mesh, params: Any, axis: str = "model") -> Any:
    """Tensor-parallel parameter shardings: shard the trailing
    (output-feature) dimension over ``axis`` when divisible, else
    replicate. With a size-1 model axis this degrades to pure DP."""
    size = mesh.shape[axis] if axis in mesh.shape else 1

    def spec(x):
        if size > 1 and x.ndim >= 1 and x.shape[-1] % size == 0 and x.shape[-1] >= size:
            return NamedSharding(mesh, P(*((None,) * (x.ndim - 1) + (axis,))))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(spec, params)
