"""Model configuration for the analytics-backbone zoo, a copy of
``repro.models.config`` (plain Python, no JAX), so that both packages read
the same names.

One frozen dataclass covers all six families (dense / ssm / hybrid / moe / vlm /
audio).  Family-specific fields are zero/None when unused.  Configs for the ten
assigned architectures live in ``repro_torch.configs``.  Some fields concern
only the JAX package's tracing and mesh (``remat``, ``scan_layers``,
``use_pallas``, ``attn_q_chunk``, ``attn_kv_chunk``, ``TP_DEGREE``'s head
padding): the port keeps them so that a config reads the same on both
sides, and does not read them.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "ssm", "hybrid", "moe", "vlm", "audio"]

# Tensor-parallel degree of the production mesh (model axis).  Head counts are
# zero-padded and non-divisible vocab/kv dims are replicated against this
# (DESIGN.md §5) — the mesh's model axis is fixed at 16 in both the single-pod
# and multi-pod configurations.
TP_DEGREE = 16


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                 # 0 -> d_model // num_heads
    real_vocab_size: int = 0          # >0: vocab_size is padded; mask pads

    # --- normalization / block style ---
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    parallel_block: bool = False      # command-r style: attn and mlp in parallel
    use_bias: bool = False
    tie_embeddings: bool = False

    # --- positional ---
    rope_theta: float = 10_000.0
    mrope: bool = False               # qwen2-vl M-RoPE (3 position streams)
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # fractions of head_dim/2

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_version: int = 1              # 1 = mamba1 (falcon-mamba), 2 = mamba2 (zamba2)
    ssm_head_dim: int = 64            # mamba2 head dim
    ssm_chunk: int = 256              # chunked-scan chunk length

    # --- hybrid (zamba2): shared attention block applied every attn_every layers ---
    attn_every: int = 0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500           # post-conv audio frame count (stub frontend)
    cross_attn: bool = False

    # --- compute ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attn_q_chunk: int = 512           # blockwise attention tiling (pure-JAX path)
    attn_kv_chunk: int = 1024
    remat: bool = True                # rematerialize each layer in the scan
    scan_layers: bool = True          # stack homogeneous layers and lax.scan
    use_pallas: bool = False          # TPU target: route hotspots to Pallas kernels
    logits_softcap: float = 0.0

    # vlm stub: patch-embedding input instead of token ids for the vision stream
    vision_stub: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        assert self.family in ("dense", "ssm", "hybrid", "moe", "vlm", "audio")
        if self.family in ("dense", "vlm", "moe", "audio"):
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.family == "moe":
            assert self.num_experts > 0 and self.experts_per_token > 0
        if self.family == "hybrid":
            assert self.attn_every > 0 and self.ssm_state > 0
        if self.family == "ssm":
            assert self.ssm_state > 0

    # ---- derived sizes ----
    @property
    def d_head(self) -> int:
        return self.head_dim

    @property
    def num_padded_heads(self) -> int:
        """Query heads zero-padded up to a TP_DEGREE multiple (inert pads)."""
        h = max(self.num_heads, 1)
        return -(-h // TP_DEGREE) * TP_DEGREE if h % TP_DEGREE else h

    @property
    def shard_kv_heads(self) -> bool:
        return self.num_kv_heads % TP_DEGREE == 0

    @property
    def shard_vocab(self) -> bool:
        return self.vocab_size % TP_DEGREE == 0

    def with_padded_vocab(self) -> "ModelConfig":
        """Pad the vocab to a TP_DEGREE multiple (PerfFlags.pad_vocab): the
        embedding rows/logit columns beyond the real vocab are masked to
        -inf in the unembed, so the softmax/CE are unchanged while the
        vocab dim becomes shardable (kills the unsharded-logits all-reduce
        in the loss backward — see EXPERIMENTS.md whisper note)."""
        if self.vocab_size % TP_DEGREE == 0:
            return self
        padded = -(-self.vocab_size // TP_DEGREE) * TP_DEGREE
        return dataclasses.replace(self, vocab_size=padded,
                                   real_vocab_size=self.vocab_size)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, -(-self.d_model // 16))  # ceil(d_model/16), mamba1 default

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6·N·D)."""
        D, V = self.d_model, self.vocab_size
        n = V * D  # embeddings
        if not self.tie_embeddings:
            n += V * D
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        dense_mlp = 3 * D * self.d_ff
        norm = 2 * D

        def mamba1():
            di, ds, dtr = self.d_inner, self.ssm_state, self.dt_rank
            return (D * 2 * di + di * self.ssm_conv + di * (dtr + 2 * ds)
                    + dtr * di + di * ds + di + di * D + D)

        def mamba2():
            di, ds = self.d_inner, self.ssm_state
            nh = self.ssm_num_heads
            return (D * (2 * di + 2 * ds + nh) + (di + 2 * ds) * self.ssm_conv
                    + nh + nh + di + di * D + D)

        if self.family == "ssm":
            n += self.num_layers * (mamba1() if self.ssm_version == 1 else mamba2())
            n += D  # final norm
            return n
        if self.family == "hybrid":
            n += self.num_layers * (mamba2() + norm)
            n += (attn + dense_mlp + norm)  # one shared attention block
            n += D
            return n
        if self.family == "moe":
            per_expert = 3 * D * self.d_ff
            n += self.num_layers * (attn + self.num_experts * per_expert
                                    + D * self.num_experts + norm)
            n += D
            return n
        # dense / vlm / audio decoder
        dec_layers = self.num_layers
        n += dec_layers * (attn + dense_mlp + norm)
        if self.is_encdec:
            n += self.encoder_layers * (attn + dense_mlp + norm)
            n += dec_layers * (attn + D)  # cross attention + its norm
            n += D  # encoder final norm
        n += D
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        D = self.d_model
        per_expert = 3 * D * self.d_ff
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * per_expert
        return self.param_count() - inactive
