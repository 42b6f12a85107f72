from alphazero_tpu.models.nets import (
    AZConvNet,
    AZResNet,
    MLPNet,
    UniformModel,
    init_model,
    make_apply_fn,
    make_uniform_model,
)

__all__ = [
    "UniformModel",
    "make_uniform_model",
    "MLPNet",
    "AZResNet",
    "AZConvNet",
    "make_apply_fn",
    "init_model",
]
