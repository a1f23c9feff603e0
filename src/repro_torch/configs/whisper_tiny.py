"""whisper-tiny [audio] — 4L d_model=384 6H d_ff=1536 vocab=51865.
Enc-dec; conv frontend is a STUB (input_specs provides precomputed frame
embeddings) [arXiv:2212.04356].

Positional encoding note (DESIGN.md §7): the backbone uses RoPE in place of
whisper's learned absolute positions — the assignment specifies the
transformer backbone only, and RoPE extends cleanly to the 32k decode shapes.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    encoder_layers=4,
    encoder_seq=1500,
    cross_attn=True,
    use_bias=True,
    norm_type="layernorm",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    encoder_layers=2,
    encoder_seq=32,
    cross_attn=True,
    use_bias=True,
    norm_type="layernorm",
    rope_theta=10_000.0,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    remat=False,
)
