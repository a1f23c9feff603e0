"""Common building blocks of the backbone zoo, the counterpart of
``repro.models.layers``: norms, RoPE and M-RoPE, the MLP, the embedding
and unembedding, and the init helpers.

Parameters are plain dicts of tensors, as in the reference, but held
ready to compute: every tensor that the reference casts to ``cfg.dtype``
at each use (the matmul weights, the biases, the embedding) is cast once
when the parameters are made, and the norms stay in
``cfg.param_dtype``, read in float32 as the reference reads them.  The
casts are the reference's, so the numbers are the same; at yi-6b in
bfloat16 the weights take 12 GB instead of the reference's 24 GB of
float32 parameters.  The functions still cast to ``cfg.dtype`` where the
reference does, which costs nothing on tensors already in it.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Params = dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis_size: int,
               dtype) -> torch.Tensor:
    """Truncated-normal fan-in init (a standard normal cut at +-2, scaled
    by 1/sqrt(fan_in)), drawn in float32 on ``gen``'s device, then cast to
    ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / np.sqrt(max(in_axis_size, 1))).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.normal_(generator=gen).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, d: int | None = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=_pdtype(cfg), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=_pdtype(cfg), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.cache
def _freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` in float32 on ``device``, copied there once: a copy
    from host memory at every layer would wait for the card each time."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, N, H) rotated by ``angles`` (B, S, H/2), in float32."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, N, H); positions: (B, S) integers."""
    freqs = _freqs(x.shape[-1], theta, x.device)                 # (H/2,)
    return _rotate(x, positions[..., None].float() * freqs)


@functools.cache
def _mrope_streams(sections: tuple[int, int, int], half: int,
                   device: torch.device) -> torch.Tensor:
    """(half,) the position stream of each rotary frequency (section 0
    temporal, 1 height, 2 width), on ``device``, copied there once, as
    ``_freqs`` is."""
    sec = np.asarray(sections, np.int64)
    sec = (sec * half / sec.sum()).astype(np.int64)
    sec[2] = half - sec[0] - sec[1]
    src = np.concatenate([np.full(int(s), i, np.int64)
                          for i, s in enumerate(sec)])
    return torch.as_tensor(src, device=device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, S, N, H); positions3: (3, B, S) — (temporal, height, width)
    position streams.  The rotary half-dim is partitioned into three
    sections, each rotated by its own position stream (interleaved as in
    the HF reference).
    """
    h = x.shape[-1]
    freqs = _freqs(h, theta, x.device)                           # (half,)
    src = _mrope_streams(tuple(sections), h // 2, x.device)
    pos = positions3[src]                                        # (half,B,S)
    return _rotate(x, pos.permute(1, 2, 0).float() * freqs)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             gated: bool = True) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    p = {"wi": dense_init(gen, (d, f), d, dt)}
    if gated:
        p["wg"] = dense_init(gen, (d, f), d, dt)
    p["wo"] = dense_init(gen, (f, d), f, dt)
    if cfg.use_bias:
        p["bi"] = torch.zeros((f,), dtype=dt, device=gen.device)
        p["bo"] = torch.zeros((d,), dtype=dt, device=gen.device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = _dtype(cfg)
    x = x.to(dt)
    h = x @ p["wi"].to(dt)
    if "bi" in p:
        h = h + p["bi"].to(dt)
    if "wg" in p:
        g = x @ p["wg"].to(dt)
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    o = h @ p["wo"].to(dt)
    if "bo" in p:
        o = o + p["bo"].to(dt)
    return o


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = _dtype(cfg)
    p = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                               cfg.d_model, dt)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens, p["tok"].to(_dtype(cfg)))


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["head"] if "head" in p else p["tok"].T
    logits = x.to(_dtype(cfg)) @ w.to(_dtype(cfg))
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.real_vocab_size:  # padded vocab: pad columns can never win
        pad_mask = torch.arange(cfg.vocab_size, device=logits.device) \
            >= cfg.real_vocab_size
        logits = logits.masked_fill(pad_mask, -1e30)
    return logits
