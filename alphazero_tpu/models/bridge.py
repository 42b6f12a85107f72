"""Host-model bridge — plug any external Python model into the search.

The analogue of the reference's generic embedded-Python NNet bridge
(reference: examples/utils/python_nnet.rs:1-132 ``PythonNNet`` over a
``PythonModel`` trait): the reference embedded CPython inside Rust to call
an arbitrary model's ``predict_model``; here the framework *is* Python, so
the bridge goes the other way — it lifts an arbitrary host callable (a
torch CPU module, an onnx session, a numpy heuristic...) into the jitted
search via ``jax.pure_callback``.

This is the escape hatch, not the fast path: every call crosses the
host<->device boundary exactly like the reference's channel hop into its
inference-service thread (async_mcts.rs:305-315), so it serializes the
search on the callback. Native JAX models fused into the step are the
production path; the bridge exists for parity and for wrapping legacy
models during migration.

Model versioning parity: the reference reloads a checkpoint whenever the
requested ``model_id`` changes (python_nnet.rs:65-75,106-117).
``HostModelBridge`` mirrors that with a host-side registry keyed by the
integer model id carried in ``params``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# host_fn(features[np, B, ...]) -> (logits[np, B, A], value[np, B])
HostPredictFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


class HostModelBridge:
    """Wrap host predict callables as an ``apply_fn(params, feats)``.

    ``params`` is ``{"model_id": int32 scalar}``; the bridge dispatches to
    the registered callable for that id (registry lookups happen on host,
    inside the callback). Register new versions with ``register``.
    """

    def __init__(self, num_actions: int):
        self.num_actions = num_actions
        self._models: Dict[int, HostPredictFn] = {}

    def register(self, model_id: int, fn: HostPredictFn) -> dict:
        """Register a host model version; returns its params handle."""
        self._models[int(model_id)] = fn
        return self.params_for(model_id)

    @staticmethod
    def params_for(model_id: int) -> dict:
        return {"model_id": jnp.asarray(model_id, jnp.int32)}

    def apply_fn(self, params, feats: jax.Array):
        b = feats.shape[0]

        def host_call(model_id, feats_np):
            fn = self._models[int(model_id)]
            logits, value = fn(np.asarray(feats_np))
            return (
                np.asarray(logits, np.float32).reshape(b, self.num_actions),
                np.asarray(value, np.float32).reshape(b),
            )

        out_shape = (
            jax.ShapeDtypeStruct((b, self.num_actions), jnp.float32),
            jax.ShapeDtypeStruct((b,), jnp.float32),
        )
        return jax.pure_callback(
            host_call, out_shape, params["model_id"], feats, vmap_method="sequential"
        )

