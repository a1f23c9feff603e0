"""Selective state-space blocks, the counterpart of ``repro.models.ssm``:
Mamba1 (falcon-mamba) and Mamba2's SSD (zamba2).

Mamba1's sequence path runs the selective scan through
``kernels.mamba_scan.mamba_scan``: on a CPU tensor its plain version, on a
CUDA tensor the hand-written kernel, one launch a call, which also writes
the end state where a prefill keeps it (``return_final_state``); the
(B, L, d_inner, N) state never reaches device memory.  The reference
scans in chunks of ``cfg.ssm_chunk`` steps and takes only a multiple of
it past one chunk; the kernel takes any L.

Mamba2's sequence path is ``ssd_chunked``, the reference's chunked matmul
form (``_ssd_chunked``) in float32 ``torch.matmul``: the reference has no
Pallas kernel for it, so neither does the port.  Its chunks are
``cfg.ssm_chunk`` steps with a shorter last one, so any L runs, where the
reference takes only a multiple of the chunk past one chunk.

Both decode paths are the O(1) one-step update in eager PyTorch, as in
the reference (which has no kernel for them).

Dtypes follow the reference at each point: the projections in
``cfg.dtype``; the convolution summed in float32 and cast back; dt, the
scan or SSD and the ``D`` skip in float32; Mamba1's ``silu(z)`` gate in
``cfg.dtype``, Mamba2's gated RMSNorm in float32.  The parameters are held
as ``layers`` holds them: the projections in ``cfg.dtype``, the leaves of
``PARAM_DTYPE_LEAVES`` in ``cfg.param_dtype`` (the reference reads those
in float32 at each use).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _dtype, _pdtype, dense_init

#: Mamba1's and Mamba2's parameters the reference reads in float32 at each
#: use, held in ``cfg.param_dtype`` (a cast to ``cfg.dtype`` would change
#: the numbers); the others are cast once to ``cfg.dtype``
PARAM_DTYPE_LEAVES = ("conv_w", "conv_b", "A_log", "dt_bias", "D",
                      "norm_scale")


def check_version(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is a Mamba1 or a Mamba2 model."""
    if cfg.ssm_version not in (1, 2):
        raise ValueError(f"{cfg.name}: ssm_version {cfg.ssm_version} is "
                         f"neither Mamba1 (1) nor Mamba2 (2)")


def _check_prompt(L: int, cfg: ModelConfig) -> None:
    """A prefill's conv state holds the last W-1 inputs of the
    convolution: refuse a prompt shorter than that."""
    if L < cfg.ssm_conv - 1:
        raise ValueError(f"a prompt of {L} tokens is shorter than the "
                         f"{cfg.ssm_conv - 1} that the conv state holds")


# ---------------------------------------------------------------------------
# depthwise causal conv1d
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None) -> torch.Tensor:
    """x: (B, L, C); w: (C, W) depthwise; returns (B, L, C) in x's dtype,
    summed in float32 as W shifted products."""
    W, L = w.shape[-1], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + L].float() * wf[:, i]
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None):
    """One decode step.  x_t: (B, C); conv_state: (B, W-1, C).  Returns
    (out (B, C) in x_t's dtype, the new conv state (B, W-1, C))."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)         # (B, W, C)
    out = torch.einsum("bwc,cw->bc", window.float(), w.float())
    if b is not None:
        out = out + b.float()
    return out.to(x_t.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------

def init_mamba1(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The reference's distributions, drawn on ``gen``'s device: the
    projections truncated normal at fan-in scale in ``cfg.dtype``,
    ``conv_w`` likewise in ``cfg.param_dtype``; ``dt_bias`` the inverse
    softplus of 0.01, ``A_log`` log(1..N) a channel, ``D`` ones,
    ``conv_b`` zeros."""
    d, di, n, dtr, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.dt_rank, cfg.ssm_conv)
    dt, pdt, dev = _dtype(cfg), _pdtype(cfg), gen.device
    p = {"in_proj": dense_init(gen, (d, 2 * di), d, dt),
         "conv_w": dense_init(gen, (di, cw), cw, pdt),
         "conv_b": torch.zeros((di,), dtype=pdt, device=dev),
         "x_proj": dense_init(gen, (di, dtr + 2 * n), di, dt),
         "dt_proj": dense_init(gen, (dtr, di), dtr, dt)}
    p["dt_bias"] = torch.full((di,), float(np.log(np.expm1(
        np.float32(0.01)))), dtype=torch.float32, device=dev).to(pdt)
    p["A_log"] = torch.log(torch.arange(
        1, n + 1, dtype=torch.float32, device=dev)).repeat(di, 1).to(pdt)
    p["D"] = torch.ones((di,), dtype=pdt, device=dev)
    p["out_proj"] = dense_init(gen, (di, d), di, dt)
    return p


def _x_proj(p: Params, xc: torch.Tensor, cfg: ModelConfig):
    """xc (..., di) in ``cfg.dtype`` -> (dt (..., di) float32, B, C)."""
    dt_ = _dtype(cfg)
    dtr, n = cfg.dt_rank, cfg.ssm_state
    proj = xc @ p["x_proj"].to(dt_)
    dt_raw, Bm, Cm = torch.split(proj, [dtr, n, n], dim=-1)
    dt = F.softplus((dt_raw @ p["dt_proj"].to(dt_)).float()
                    + p["dt_bias"].float())
    return dt, Bm, Cm


def mamba1_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: dict | None = None,
                 return_final_state: bool = False):
    """x: (B, L, D).  Without ``state``, the block over the sequence (one
    scan launch on the card); with ``return_final_state`` also the
    decode state it ends in, {"h": (B, di, N) float32, "conv": (B, W-1, di)
    in ``cfg.dtype``, the last W-1 inputs of the convolution}, which needs
    L >= W-1.  With ``state`` (that layout), x is one token (L = 1) and
    the block takes one step.  Returns (out (B, L, D) in ``cfg.dtype``,
    the new state or None)."""
    L = x.shape[1]
    dt_ = _dtype(cfg)
    xz = x.to(dt_) @ p["in_proj"].to(dt_)
    xs, z = xz.chunk(2, dim=-1)
    A = -torch.exp(p["A_log"].float())                             # (di, N)
    D = p["D"].float()

    if state is None:
        W = cfg.ssm_conv
        if return_final_state:
            _check_prompt(L, cfg)
        xc = F.silu(causal_conv1d(xs, p["conv_w"], p["conv_b"]))
        dt, Bm, Cm = _x_proj(p, xc, cfg)
        u = xc.float()
        out = scan_kernel.mamba_scan(u, dt, Bm.float(), Cm.float(), A,
                                     final_state=return_final_state)
        y, h = out if return_final_state else (out, None)
        y = y + u * D
        new_state = None
        if return_final_state:
            new_state = {"h": h,
                         "conv": xs[:, L - (W - 1):].to(dt_).contiguous()}
    else:
        xc_t, conv_state = conv1d_step(xs[:, 0], state["conv"], p["conv_w"],
                                       p["conv_b"])
        xc = F.silu(xc_t)                                           # (B, di)
        dt, Bm, Cm = _x_proj(p, xc, cfg)                            # (B, di)
        da = torch.exp(dt[..., None] * A)                           # (B,di,N)
        db = (dt * xc.float())[..., None] * Bm.float()[:, None, :]
        h = da * state["h"] + db
        y = torch.einsum("bdn,bn->bd", h, Cm.float())
        y = (y + xc.float() * D)[:, None]
        new_state = {"h": h, "conv": conv_state}

    y = y.to(dt_) * F.silu(z)
    return y @ p["out_proj"].to(dt_), new_state


def mamba1_state_init(cfg: ModelConfig, batch: int, device) -> dict:
    """A zero Mamba1 decode state: h (batch, di, N) float32 and conv
    (batch, W-1, di) in ``cfg.dtype``."""
    return {"h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=_dtype(cfg), device=device)}


# ---------------------------------------------------------------------------
# Mamba2 / SSD (zamba2)
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The reference's distributions, drawn on ``gen``'s device: the two
    projections truncated normal at fan-in scale in ``cfg.dtype``,
    ``conv_w`` likewise in ``cfg.param_dtype``; ``A_log`` log(1..16)
    spread over the heads, ``dt_bias`` the inverse softplus of 0.01, ``D``
    and ``norm_scale`` ones, ``conv_b`` zeros."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, cw = cfg.ssm_num_heads, cfg.ssm_conv
    dt, pdt, dev = _dtype(cfg), _pdtype(cfg), gen.device
    conv_ch = di + 2 * n
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * n + nh), d, dt),
        "conv_w": dense_init(gen, (conv_ch, cw), cw, pdt),
        "conv_b": torch.zeros((conv_ch,), dtype=pdt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=dev)).to(pdt),
        "dt_bias": torch.full((nh,), float(np.log(np.expm1(np.float32(
            0.01)))), dtype=torch.float32, device=dev).to(pdt),
        "D": torch.ones((nh,), dtype=pdt, device=dev),
        "norm_scale": torch.ones((di,), dtype=pdt, device=dev),
        "out_proj": dense_init(gen, (di, d), di, dt)}


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                chunk: int):
    """The SSD's chunked matmul form, all float32.  x: (B, L, nh, hd); dt:
    (B, L, nh); Bm, Cm: (B, L, N); A: (nh,) negative; h0: (B, nh, hd, N).
    Returns (y (B, L, nh, hd), the end state (B, nh, hd, N)).

    Each chunk of ``chunk`` steps (the last one shorter where L is not a
    multiple) adds its intra-chunk term (C_i . B_j weighted by the decay
    from step j to step i, j <= i, over x dt) to the carried state's term
    (C_i . h decayed to step i), then carries h to its end, as the
    reference's ``_ssd_chunked`` does."""
    L = x.shape[1]
    ys, h = [], h0
    for s in range(0, L, chunk):
        x_c, dt_c = x[:, s:s + chunk], dt[:, s:s + chunk]
        B_c, C_c = Bm[:, s:s + chunk], Cm[:, s:s + chunk]
        c = x_c.shape[1]
        cl = torch.cumsum(dt_c * A, dim=1)              # (B, c, nh) <= 0
        # intra-chunk, (B, nh, i, j): exp(cl_i - cl_j) for i >= j, else 0
        clh = cl.transpose(1, 2)                         # (B, nh, c)
        seg = clh[:, :, :, None] - clh[:, :, None, :]
        causal = torch.ones((c, c), dtype=torch.bool,
                            device=x.device).tril()
        seg = seg.masked_fill_(~causal, float("-inf")).exp_()
        cb = torch.matmul(C_c, B_c.transpose(1, 2))     # (B, i, j)
        scores = seg.mul_(cb[:, None])                   # (B, nh, i, j)
        xdt = (x_c * dt_c[..., None]).transpose(1, 2)   # (B, nh, c, hd)
        y = torch.matmul(scores, xdt)                    # (B, nh, i, hd)
        # the carried state's term: C_i . h, decayed to step i
        y = y + torch.matmul(C_c[:, None], h.transpose(2, 3)) \
            * torch.exp(clh)[..., None]
        ys.append(y.transpose(1, 2))
        # the carry: h decayed over the chunk plus each step's x dt B,
        # decayed from its step to the chunk's end
        w = torch.exp(cl[:, -1:] - cl) * dt_c            # (B, c, nh)
        xw = (x_c * w[..., None]).permute(0, 2, 3, 1)   # (B, nh, hd, c)
        h = h * torch.exp(cl[:, -1])[:, :, None, None] \
            + torch.matmul(xw, B_c[:, None])
    return torch.cat(ys, dim=1), h


def _gated_norm_out(p: Params, y: torch.Tensor, z: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Mamba2's gated RMSNorm, in float32 over all d_inner channels, then
    the out-projection in ``cfg.dtype``."""
    dt_ = _dtype(cfg)
    y = y.float() * F.silu(z.float())
    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"].float()
    return y.to(dt_) @ p["out_proj"].to(dt_)


def mamba2_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: dict | None = None,
                 return_final_state: bool = False):
    """x: (B, L, D).  Without ``state``, the block over the sequence
    (``ssd_chunked``, no kernel); with ``return_final_state`` also the
    decode state it ends in, {"h": (B, nh, hd, N) float32, "conv":
    (B, W-1, di+2N) in ``cfg.dtype``, the last W-1 inputs of the
    convolution (x, B and C before it)}, which needs L >= W-1.  With
    ``state`` (that layout), x is one token (L = 1) and the block takes
    one step.  dt, A and D are per head and broadcast over the head's hd
    channels.  Returns (out (B, L, D) in ``cfg.dtype``, the new state or
    None)."""
    B, L, _ = x.shape
    di, n, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                     cfg.ssm_head_dim)
    dt_ = _dtype(cfg)
    proj = x.to(dt_) @ p["in_proj"].to(dt_)
    z, xBC, dt_raw = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    A = -torch.exp(p["A_log"].float())                             # (nh,)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())      # (B, L, nh)
    D = p["D"].float()[:, None]                                  # (nh, 1)

    if state is None:
        W = cfg.ssm_conv
        if return_final_state:
            _check_prompt(L, cfg)
        xc = F.silu(causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
        xs, Bm, Cm = torch.split(xc, [di, n, n], dim=-1)
        xh = xs.float().reshape(B, L, nh, hd)
        h0 = torch.zeros((B, nh, hd, n), dtype=torch.float32, device=x.device)
        y, h = ssd_chunked(xh, dt, Bm.float(), Cm.float(), A, h0,
                           min(cfg.ssm_chunk, L))
        y = (y + xh * D).reshape(B, L, di)
        new_state = None
        if return_final_state:
            new_state = {"h": h,
                         "conv": xBC[:, L - (W - 1):].to(dt_).contiguous()}
    else:
        xc_t, conv_state = conv1d_step(xBC[:, 0], state["conv"], p["conv_w"],
                                       p["conv_b"])
        xs, Bm, Cm = torch.split(F.silu(xc_t), [di, n, n], dim=-1)
        xh = xs.float().reshape(B, nh, hd)
        dt1 = dt[:, 0]                                           # (B, nh)
        da = torch.exp(dt1 * A)
        h = state["h"] * da[:, :, None, None] \
            + (xh * dt1[..., None])[..., None] * Bm.float()[:, None, None]
        y = torch.matmul(h, Cm.float()[:, None, :, None])[..., 0]
        y = (y + xh * D).reshape(B, 1, di)
        new_state = {"h": h, "conv": conv_state}

    return _gated_norm_out(p, y, z, cfg), new_state


def mamba2_state_init(cfg: ModelConfig, batch: int, device) -> dict:
    """A zero Mamba2 decode state: h (batch, nh, hd, N) float32 and conv
    (batch, W-1, di+2N) in ``cfg.dtype``."""
    return {"h": torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state),
                                dtype=_dtype(cfg), device=device)}
