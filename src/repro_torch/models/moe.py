"""Mixture-of-Experts FFN, the counterpart of ``repro.models.moe`` on one
device: token-choice top-k routing in float32 and a capacity-limited
dispatch into fixed ``(E, C)`` buffers, built from a stable argsort over
the expert ids, with the reference's static shapes.

Every decision is the reference's, to the token:

- ``chunk = min(MOE_CHUNK, T)`` tokens a dispatch and capacity
  ``C = max(MIN_CAPACITY, ceil(chunk * k / E * capacity_factor))``; a
  token count that is no multiple of ``chunk`` is padded with zero rows,
  which are routed like real tokens (they fill slots, and come after the
  real tokens in the stable order, so their overflow drops only
  themselves), and the aux and z losses are the mean over the chunks;
- among equal probabilities the lowest expert id wins, as in
  ``jax.lax.top_k`` (a zero pad row is a full tie): a stable descending
  sort, where ``torch.topk`` promises no order;
- a (token, expert) entry past its expert's ``C`` slots is dropped, and
  the gather of the experts' output reads a dropped entry's row
  ``E * C`` clamped to ``E * C - 1``, as XLA clamps the reference's
  out-of-bounds index, before ``valid`` zeroes it.

Nothing here waits on the host (no boolean-mask indexing, ``nonzero``,
``bincount`` or ``.item()``).  The expert products are batched matmuls
(``torch.bmm``) in ``cfg.dtype``, as the reference's einsums are jnp
outside any Pallas kernel.  The reference's expert-parallel branch
(``_moe_chunk_ep``, its ``shard_map`` body and ``PerfFlags.moe_tp_dispatch``)
has no counterpart on one card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _dtype, dense_init

MOE_CHUNK = 8192          # tokens a dispatch chunk
MIN_CAPACITY = 4


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The router (D, E) in float32, whatever ``cfg.param_dtype`` is, as
    the reference's; ``wi`` and ``wg`` (E, D, F) and ``wo`` (E, F, D) cast
    once to ``cfg.dtype``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = _dtype(cfg)
    return {"router": dense_init(gen, (d, e), d, torch.float32),
            "wi": dense_init(gen, (e, d, f), d, dt),
            "wg": dense_init(gen, (e, d, f), d, dt),
            "wo": dense_init(gen, (e, f, d), f, dt)}


def capacity(cfg: ModelConfig, chunk: int) -> int:
    """Slots an expert a chunk of ``chunk`` tokens."""
    return max(MIN_CAPACITY, int(math.ceil(
        chunk * cfg.experts_per_token / cfg.num_experts
        * cfg.capacity_factor)))


def _route(tokens_f32: torch.Tensor, router_w: torch.Tensor, k: int):
    """tokens (T, D) float32 -> (probs (T, k), ids (T, k), aux, zloss)."""
    logits = tokens_f32 @ router_w                                  # (T, E)
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux (Switch): E * sum_e f_e * p_e
    f_e = torch.zeros(E, dtype=torch.float32, device=logits.device)
    f_e.index_add_(0, top_i.reshape(-1),
                   torch.ones(top_i.numel(), device=logits.device))
    f_e = f_e / f_e.sum().clamp_min(1.0)
    aux = E * (f_e * probs.mean(0)).sum()
    zloss = torch.logsumexp(logits, dim=-1).square().mean()
    return top_p, top_i, aux, zloss


def _dispatch_indices(ids: torch.Tensor, E: int, C: int):
    """ids (T, k) expert assignments -> (dest (T*k,), valid (T*k,)): dest
    in [0, E*C) addresses the packed (E, C) buffer, a slot being the
    entry's rank within its expert in the stable order of the flat ids,
    and an entry past its expert's C slots is dropped (dest E*C, valid
    False)."""
    flat = ids.reshape(-1)
    Tk = flat.numel()
    order = torch.argsort(flat, stable=True)                        # (Tk,)
    sorted_e = flat[order]
    start = torch.searchsorted(
        sorted_e, torch.arange(E, device=ids.device, dtype=sorted_e.dtype),
        side="left")                                                # (E,)
    slot = torch.arange(Tk, device=ids.device) - start[sorted_e]
    valid_sorted = slot < C
    dest_sorted = torch.where(valid_sorted,
                              sorted_e * C + slot.clamp_max(C - 1), E * C)
    inv = torch.argsort(order, stable=True)
    return dest_sorted[inv], (dest_sorted != E * C)[inv]


def _expert_ffn(xb: torch.Tensor, wi, wg, wo, dt) -> torch.Tensor:
    """xb (E, M, D); weights (E, D, F) / (E, F, D) -> (E, M, D)."""
    xb = xb.to(dt)
    h = torch.bmm(xb, wg.to(dt))
    u = torch.bmm(xb, wi.to(dt))
    return torch.bmm(F.silu(h) * u, wo.to(dt))


def _moe_chunk_local(tokens, router_w, wi, wg, wo, cfg: ModelConfig,
                     C: int):
    """Dispatch and expert compute for one chunk of tokens (T, D)."""
    T, D = tokens.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    top_p, top_i, aux, zloss = _route(tokens.float(), router_w, k)
    dest, valid = _dispatch_indices(top_i, E, C)
    src = tokens[:, None].expand(T, k, D).reshape(T * k, D)    # (T*k, D)
    # row E*C takes every dropped entry; the expert rows are unique
    buf = torch.zeros((E * C + 1, D), dtype=tokens.dtype,
                      device=tokens.device).index_copy_(0, dest, src)
    xb = buf[:E * C].view(E, C, D)
    yb = _expert_ffn(xb, wi, wg, wo, _dtype(cfg)).reshape(E * C, D)
    y = yb[dest.clamp_max(E * C - 1)] * valid[:, None].to(yb.dtype)
    y = y.view(T, k, D) * top_p[..., None].to(y.dtype)
    return y.sum(1), aux, zloss


def moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (out (B, S, D), aux loss, z loss)."""
    B, S, D = x.shape
    router_w = p["router"].float()
    tokens = x.reshape(B * S, D)
    T = tokens.shape[0]
    chunk = min(MOE_CHUNK, T)
    C = capacity(cfg, chunk)
    if T % chunk:                     # pad to a chunk multiple with zeros
        tokens = F.pad(tokens, (0, 0, 0, chunk - T % chunk))
    ys, auxs, zls = [], [], []
    for tc in tokens.view(-1, chunk, D):
        y, aux, zl = _moe_chunk_local(tc, router_w, p["wi"], p["wg"],
                                      p["wo"], cfg, C)
        ys.append(y)
        auxs.append(aux)
        zls.append(zl)
    out = torch.cat(ys)[:T].view(B, S, D)
    return out, torch.stack(auxs).mean(), torch.stack(zls).mean()
