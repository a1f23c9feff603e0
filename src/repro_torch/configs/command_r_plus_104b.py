"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000.  GQA, no-bias, parallel attn+FFN block, LayerNorm
[hf:CohereForAI/c4ai-command-r-v01 lineage].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    norm_type="layernorm",
    parallel_block=True,
    use_bias=False,
    tie_embeddings=True,   # command-r ties embeddings
    rope_theta=75_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="command-r-smoke",
    family="dense",
    num_layers=3,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    norm_type="layernorm",
    parallel_block=True,
    use_bias=False,
    tie_embeddings=True,
    rope_theta=10_000.0,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    remat=False,
)
