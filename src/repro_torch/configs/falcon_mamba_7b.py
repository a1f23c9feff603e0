"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) vocab=65024, ssm_state=16.

Mamba1 architecture [arXiv:2410.05355].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    head_dim=1,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_version=1,
    tie_embeddings=True,   # falcon-mamba ties input/output embeddings
    rope_theta=0.0,
)

SMOKE_CONFIG = ModelConfig(
    name="falcon-mamba-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    head_dim=1,
    ssm_state=8,
    ssm_expand=2,
    ssm_conv=4,
    ssm_version=1,
    ssm_chunk=16,
    tie_embeddings=True,
    rope_theta=0.0,
    remat=False,
)
