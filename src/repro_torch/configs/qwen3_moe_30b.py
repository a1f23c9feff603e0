"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=48,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    rope_theta=10_000.0,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    remat=False,
)
