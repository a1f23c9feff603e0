"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352.  RoPE SwiGLU GQA [arXiv:2404.14219].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="phi3-smoke",
    family="dense",
    num_layers=3,
    d_model=80,
    num_heads=4,
    num_kv_heads=1,
    d_ff=192,
    vocab_size=512,
    rope_theta=10_000.0,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    remat=False,
)
