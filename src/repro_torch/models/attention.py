"""Attention: GQA projections, prefill and decode, the counterpart of
``repro.models.attention``.

The port runs the config's own ``num_heads`` query heads.  The reference
pads them to ``cfg.num_padded_heads`` (a multiple of its mesh's
tensor-parallel degree), maps each pad to kv head 0 (``kv_map``) and
zeroes it (``head_mask``); ``repro_torch.convert.params_from_numpy``
drops the pads' columns of ``wq`` and rows of ``wo``, which leaves the
output unchanged.  Query head h then reads kv head h // (H / KV), the
grouping of the CUDA kernels.

Tensors are head-major, the kernels' layout: q (B, H, S, hd), k and v
(B, KV, S, hd), contiguous; the reference holds them sequence-major
(B, S, heads, hd).  ``blockwise_attention`` (prefill) runs
``kernels.flash_attention`` and ``decode_attention`` runs
``kernels.decode_attention``: on a CPU tensor their plain versions, on a
CUDA tensor the hand-written kernels.  ``full_attention`` is the oracle
and launches no kernel.  Softmax is in float32 with p kept in float32, and
the output is cast back to q's dtype, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, _dtype, apply_mrope,
                                       apply_rope, dense_init)

NEG_INF = -1e30


def kv_map(cfg: ModelConfig) -> np.ndarray:
    """(H_pad,) the reference's static map: query head -> kv head (pads
    map to kv 0)."""
    G = cfg.num_heads // cfg.num_kv_heads
    m = np.arange(cfg.num_padded_heads) // G
    return np.where(np.arange(cfg.num_padded_heads) < cfg.num_heads, m, 0).astype(np.int32)


def head_mask(cfg: ModelConfig) -> np.ndarray | None:
    """(H_pad,) 1 for the real heads and 0 for the reference's pads, or
    None where there are no pads."""
    if cfg.num_padded_heads == cfg.num_heads:
        return None
    return (np.arange(cfg.num_padded_heads) < cfg.num_heads).astype(np.float32)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    p = {
        "wq": dense_init(gen, (d, h * hd), d, dt),
        "wk": dense_init(gen, (d, kv * hd), d, dt),
        "wv": dense_init(gen, (d, kv * hd), d, dt),
        "wo": dense_init(gen, (h * hd, d), h * hd, dt),
    }
    if cfg.use_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n * hd,), dtype=dt, device=gen.device)
    return p


def qkv_project(p: Params, x: torch.Tensor, cfg: ModelConfig, positions):
    """x: (B,S,D) -> q: (B,H,S,hd), k, v: (B,KV,S,hd), contiguous, with
    RoPE (M-RoPE where ``cfg.mrope``, then ``positions`` is (3,B,S))."""
    B, S, _ = x.shape
    dt = _dtype(cfg)
    x = x.to(dt)
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    q = q.view(B, S, cfg.num_heads, cfg.head_dim)
    k = k.view(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.view(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous())


def full_attention(q, k, v, cfg: ModelConfig, *,
                   causal: bool = True) -> torch.Tensor:
    """Reference O(S^2)-memory attention (small shapes / oracles only):
    q (B,H,S,hd), k/v (B,KV,T,hd) -> (B,H,S,hd), kv heads expanded by
    ``kv_map``."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    kvm = torch.as_tensor(kv_map(cfg)[:H].astype(np.int64), device=q.device)
    kx = k.float()[:, kvm]
    vx = v.float()[:, kvm]
    s = torch.einsum("bhqd,bhtd->bhqt", q.float(), kx) * hd ** -0.5
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= \
            torch.arange(T, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqt,bhtd->bhqd", p, vx)
    return o.to(q.dtype)


def blockwise_attention(q, k, v, cfg: ModelConfig, *,
                        causal: bool = True) -> torch.Tensor:
    """Prefill attention through the flash kernel: q (B,H,S,hd), k/v
    (B,KV,T,hd) -> (B,H,S,hd).  The reference's q and kv chunking
    (``cfg.attn_q_chunk``, ``cfg.attn_kv_chunk``) is the kernel's tiling
    here."""
    return flash_kernel.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, length,
                     cfg: ModelConfig) -> torch.Tensor:
    """One new token against a KV cache through the decode kernel: q
    (B,H,hd); k/v_cache (B,KV,T,hd); length (B,) int32, the valid prefix
    of each row.  Returns (B,H,hd)."""
    return decode_kernel.decode_attention(q, k_cache, v_cache, length)


def attn_output(p: Params, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """o (B,H,S,hd) -> (B,S,D) through ``wo``."""
    B, _, S, _ = o.shape
    dt = _dtype(cfg)
    o = o.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return o.to(dt) @ p["wo"].to(dt)
