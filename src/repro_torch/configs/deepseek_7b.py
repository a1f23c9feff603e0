"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400.  llama-arch [arXiv:2401.02954].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    rope_theta=10_000.0,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    remat=False,
)
