"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  Mamba2 blocks + shared attention block applied
every 6 layers [arXiv:2411.15242].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_version=2,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_version=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    attn_every=2,
    rope_theta=10_000.0,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    remat=False,
)
