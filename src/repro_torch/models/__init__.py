"""The model zoo of the 10 assigned architectures on PyTorch
(counterpart of ``repro.models``)."""

from repro_torch.models.transformer import (
    decode_step,
    forward_train,
    init_cache,
    init_params,
    lm_features,
    param_specs,
    prefill,
)

__all__ = ["init_params", "forward_train", "init_cache", "prefill",
           "decode_step", "lm_features", "param_specs"]
