"""AdamW with a warmup-then-cosine schedule and global-norm clipping, the
counterpart of ``repro.optim.adamw`` over the port's parameter trees
(nested dicts and lists of tensors, ``repro_torch.tree``).

The step, the clip scale, the learning rate and the bias corrections stay
tensors on the parameters' device, so an update makes no host sync.  The
update is functional: it returns new tensors and leaves its inputs as
they are.  Call it under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or a number) as a float32
    tensor: linear warmup to ``cfg.lr`` over ``warmup_steps``, then a
    cosine from ``cfg.lr`` down to ``min_lr_frac`` of it at
    ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params, master_weights: bool = False) -> dict:
    """Zero float32 moments ``m`` and ``v`` shaped like ``params``, the
    step a zero int32 tensor on their device; with ``master_weights``
    (``PerfFlags.bf16_params``) a float32 copy of the parameters, which
    the update applies to."""
    flat = T.leaves(params)
    dev = flat[0].device if flat else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    st = {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
          "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if master_weights:
        st["master"] = T.tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return st


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm over every leaf of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in T.leaves(tree)))


def adamw_update(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step: returns (new params, new state, {"grad_norm",
    "lr"}), ``grad_norm`` before clipping.  Weight decay applies to the
    leaves with at least one dimension, as in the reference.  With a
    ``master`` in ``state`` the step updates the float32 master and the
    parameters are its casts to their own dtypes."""
    step = state["step"] + 1
    masters = state.get("master")
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(step, cfg)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.beta1, stepf)
    b2c = 1 - torch.pow(cfg.beta2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.beta1 * m + (1 - cfg.beta1) * g
        v = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 1:     # decay matrices and vectors, not scalars
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    flat_p, paths = T.flatten(params)
    flat_g = T.leaves_at(grads, paths)
    flat_m = T.leaves_at(state["m"], paths)
    flat_v = T.leaves_at(state["v"], paths)
    flat_w = flat_p if masters is None else T.leaves_at(masters, paths)
    out = [upd(w, g, m, v) for w, g, m, v in zip(flat_w, flat_g, flat_m,
                                                  flat_v)]
    new_m = T.unflatten(paths, [o[1] for o in out])
    new_v = T.unflatten(paths, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    if masters is None:
        return T.unflatten(paths, [o[0] for o in out]), {
            "m": new_m, "v": new_v, "step": step}, metrics
    new_master = T.unflatten(paths, [o[0] for o in out])
    new_p = T.unflatten(paths, [o[0].to(p.dtype)
                                for o, p in zip(out, flat_p)])
    return new_p, {"m": new_m, "v": new_v, "master": new_master,
                   "step": step}, metrics
