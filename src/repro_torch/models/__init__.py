"""The backbone zoo's serving path on PyTorch, the counterpart of
``repro.models``: the dense family, the VLM (M-RoPE and the vision stub's
``embeds``), the moe family (``moe``: the router and the capacity
dispatch), the ssm family under Mamba1 and Mamba2 (``ssm``: the blocks,
conv, SSD and state), the hybrid (zamba2's Mamba2 layers and shared
attention block) and audio (whisper's encoder, ``encode_audio``, and
cross attention); and the training loss ``lm_loss``."""
from repro_torch.models import moe, ssm  # noqa: F401
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    init_params,
    forward,
    init_decode_state,
    prefill,
    decode_step,
    encode_audio,
    lm_loss,
)
