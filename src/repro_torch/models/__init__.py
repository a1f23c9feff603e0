"""The backbone zoo's serving path on PyTorch, the counterpart of
``repro.models``: the dense family and Mamba1 (``ssm``: its block, conv
and state), the others raising ``NotImplementedError``."""
from repro_torch.models import ssm  # noqa: F401
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    init_params,
    forward,
    init_decode_state,
    prefill,
    decode_step,
)
