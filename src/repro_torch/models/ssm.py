"""Mamba1 selective state-space block (falcon-mamba), the counterpart of
``repro.models.ssm``'s Mamba1 half.

The sequence path runs the selective scan through
``kernels.mamba_scan.mamba_scan``: on a CPU tensor its plain version, on a
CUDA tensor the hand-written kernel, one launch a call, which also writes
the end state where a prefill keeps it (``return_final_state``); the
(B, L, d_inner, N) state never reaches device memory.  The reference
scans in chunks of ``cfg.ssm_chunk`` steps and takes only a multiple of
it past one chunk; the kernel takes any L.  The decode path is the O(1)
one-step update in eager PyTorch, as in the reference (which has no
kernel for it).

Dtypes follow the reference at each point: the projections in
``cfg.dtype``; the convolution summed in float32 and cast back; dt, the
scan and the ``D`` skip in float32; the ``silu(z)`` gate in
``cfg.dtype``.  The parameters are held as ``layers`` holds them: the
four projections in ``cfg.dtype``, ``conv_w``, ``conv_b``, ``A_log``,
``dt_bias`` and ``D`` in ``cfg.param_dtype`` (the reference reads those in
float32 at each use).

Mamba2 (zamba2) waits for the hybrid slice of ``ROADMAP.md``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _dtype, _pdtype, dense_init

#: Mamba1 parameters the reference reads in float32 at each use, held in
#: ``cfg.param_dtype`` (a cast to ``cfg.dtype`` would change the numbers);
#: the others are cast once to ``cfg.dtype``
PARAM_DTYPE_LEAVES = ("conv_w", "conv_b", "A_log", "dt_bias", "D")
#: the slice of ROADMAP.md's Queue 1 item 2(a) that ports Mamba2
MAMBA2_SLICE = "the hybrid slice (zamba2: Mamba2 SSD and the shared " \
               "attention block)"


def check_version(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a Mamba1 model."""
    if cfg.ssm_version != 1:
        raise NotImplementedError(
            f"{cfg.name}: Mamba{cfg.ssm_version} (ssm_version "
            f"{cfg.ssm_version}) is not ported yet; ROADMAP.md Queue 1 item "
            f"2(a) queues it as {MAMBA2_SLICE}")


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
    check_version(cfg)
    L = x.shape[1]
    dt_ = _dtype(cfg)
    xz = x.to(dt_) @ p["in_proj"].to(dt_)
    xs, z = xz.chunk(2, dim=-1)
    A = -torch.exp(p["A_log"].float())                             # (di, N)
    D = p["D"].float()

    if state is None:
        W = cfg.ssm_conv
        if return_final_state and L < W - 1:
            raise ValueError(f"a prompt of {L} tokens is shorter than the "
                             f"{W - 1} that the conv state holds")
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
