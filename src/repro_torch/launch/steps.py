"""The train step, the counterpart of ``repro.launch.steps``'s
``build_train_step`` on one card: no mesh, shardings, donation or
abstract shapes (PyTorch runs eagerly).

``build_train_step(cfg)`` applies the active ``PerfFlags``
(``bf16_params``: parameters held in bfloat16, the optimizer keeping a
float32 master; ``pad_vocab``: ``cfg.with_padded_vocab()``) and returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
``lm_loss`` and ``backward()`` through autograd (on the card, the flash
kernel's backward), then ``adamw_update`` under ``torch.no_grad()``.  The
metrics ``loss``, ``ntok``, ``moe_aux``, ``moe_z``, ``grad_norm`` and
``lr`` are tensors: the step makes no host sync.  The parameters are
held in ``train_step.cfg.param_dtype`` (``init_train_params``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.perf import get_flags


def init_train_params(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Random parameters to train: ``models.init_params``'s draws, every
    tensor held in ``cfg.param_dtype`` (a moe router in float32), as the
    reference holds its parameters; the forward casts them to
    ``cfg.dtype`` at use."""
    return M.init_params(dataclasses.replace(cfg, dtype=cfg.param_dtype),
                         seed, device=device)


def build_train_step(cfg: ModelConfig, opt_cfg: OptConfig | None = None, *,
                     device="cuda"):
    """The train step of ``cfg`` under the active ``PerfFlags`` (see the
    module docstring); ``train_step.cfg`` is the config it trains."""
    opt_cfg = opt_cfg or OptConfig()
    flags = get_flags()
    if flags.bf16_params:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if flags.pad_vocab:
        cfg = cfg.with_padded_vocab()
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        flat, paths = T.flatten(params)
        held = [p.detach().requires_grad_() for p in flat]
        loss, metrics = M.lm_loss(T.unflatten(paths, held), batch, cfg,
                                  device=dev)
        loss.backward()
        # a leaf the loss does not read (whisper's cross-attention biases)
        # has a zero gradient, as under the reference's autodiff
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in held]
        with torch.no_grad():
            params, opt_state, om = adamw_update(
                T.unflatten(paths, [p.detach() for p in held]),
                T.unflatten(paths, grads), opt_state, opt_cfg)
        return params, opt_state, {
            **{k: v.detach() for k, v in metrics.items()}, **om}

    train_step.cfg = cfg
    return train_step
