"""The backbone zoo's serving path on PyTorch, the counterpart of
``repro.models``: the dense family (the others raise
``NotImplementedError``)."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    init_params,
    forward,
    init_decode_state,
    prefill,
    decode_step,
)
