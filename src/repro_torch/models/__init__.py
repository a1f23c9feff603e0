"""The backbone zoo's serving path on PyTorch, the counterpart of
``repro.models``: the dense family, the moe family (``moe``: the router
and the capacity dispatch), the ssm family under Mamba1 and Mamba2
(``ssm``: the blocks, conv, SSD and state) and the hybrid (zamba2's
Mamba2 layers and shared attention block); the VLM and audio families
raise ``NotImplementedError``."""
from repro_torch.models import moe, ssm  # noqa: F401
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    init_params,
    forward,
    init_decode_state,
    prefill,
    decode_step,
)
