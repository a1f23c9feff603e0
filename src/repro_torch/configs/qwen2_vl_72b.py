"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  M-RoPE, dynamic-resolution vision frontend (STUB: input_specs
provides precomputed patch embeddings + 3D position ids) [arXiv:2409.12191].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    use_bias=True,          # qwen2 uses qkv bias
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    vision_stub=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    use_bias=True,
    mrope=True,
    mrope_sections=(4, 2, 2),
    rope_theta=10_000.0,
    vision_stub=True,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    remat=False,
)
