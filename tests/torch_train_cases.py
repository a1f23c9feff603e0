"""Shared pieces of the training differentials
(``test_torch_train_loss_*.py``): one reference train step at a smoke
config in float32 (``jax.value_and_grad`` of ``repro.models.lm_loss`` and
one ``repro.optim.adamw_update``), read out as numpy, and the port's
counterpart from the same numpy parameters and batch
(``repro_torch.models.lm_loss``, ``backward()``, and
``repro_torch.launch.steps.build_train_step``)."""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro import models as R
from repro import optim as RO
from repro.configs import get_smoke_config
from repro.perf import PerfFlags as RFlags
from repro.perf import perf_flags as r_perf_flags
from repro_torch import tree as T
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as PM
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.perf import PerfFlags, perf_flags

B, S = 2, 32
#: warmup 0, so the first step's learning rate is the full 1e-3
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)


def config(arch: str, vocab: int = 0):
    """The smoke config of ``arch`` in float32 (``vocab``: another vocab
    size)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return dataclasses.replace(cfg, vocab_size=vocab) if vocab else cfg


def batch(cfg, seed: int, loss_mask: bool) -> dict:
    """Tokens (B, S) below the real vocab, an audio model's frames, and a
    0/1 ``loss_mask`` where asked, as numpy."""
    rng = np.random.default_rng(seed)
    real = cfg.real_vocab_size or cfg.vocab_size
    out = {"tokens": rng.integers(0, real, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (0.2 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if loss_mask:
        out["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def reference(arch: str, seed: int = 0, loss_mask: bool = False,
              pad_vocab: bool = False, vocab: int = 0):
    """The reference's train step at ``arch``'s float32 smoke config
    (``pad_vocab``: under ``PerfFlags(pad_vocab=True)``, the padded
    config): (cfg, batch, params, loss, metrics, grads, new params, new
    optimizer state, update metrics), every array numpy."""
    cfg = config(arch, vocab)
    if pad_vocab:
        cfg = cfg.with_padded_vocab()
    b = batch(cfg, seed, loss_mask)
    params = R.init_params(cfg, jax.random.PRNGKey(seed))
    opt_cfg = RO.OptConfig(**OPT)

    @jax.jit
    def step(params, batch):
        (loss, metrics), grads = jax.value_and_grad(
            R.lm_loss, has_aux=True)(params, batch, cfg)
        new, opt, om = RO.adamw_update(params, grads,
                                       RO.init_opt_state(params), opt_cfg)
        return loss, metrics, grads, new, opt, om

    with r_perf_flags(RFlags(pad_vocab=pad_vocab)):
        out = step(params, b)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (cfg, b, to_np(params)) + tuple(to_np(x) for x in out)


def port_grads(cfg, params_np, b):
    """The port's loss, metrics and gradients (a tree like its params)
    from the reference's numpy parameters and batch, on the CPU."""
    params = params_from_numpy(cfg, params_np, device="cpu")
    flat, paths = T.flatten(params)
    held = [p.requires_grad_() for p in flat]
    loss, metrics = PM.lm_loss(T.unflatten(paths, held), b, cfg,
                               device="cpu")
    grads = torch.autograd.grad(loss, held, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(held, grads)]
    return loss.detach(), metrics, T.unflatten(paths, grads)


def port_step(cfg, params_np, b, pad_vocab: bool = False):
    """One ``build_train_step`` step of the port from the reference's
    parameters and a fresh optimizer state: (params, opt state, metrics).
    ``cfg`` is the config before the flags."""
    with perf_flags(PerfFlags(pad_vocab=pad_vocab)):
        step = build_train_step(cfg, OptConfig(**OPT), device="cpu")
    params = params_from_numpy(step.cfg, params_np, device="cpu")
    return step(params, init_opt_state(params), b)


def leaf_err(got, want) -> float:
    """max |got - want| over max(1e-6, max |want|): the error of a leaf
    relative to its own scale."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def tree_errs(cfg, got_tree, want_np) -> dict:
    """{key path: leaf_err} of the port's tree against the reference's
    tree (numpy, mapped through ``params_from_numpy``'s layout)."""
    want = opt_state_from_numpy(cfg, {"m": want_np, "step": 0},
                                device="cpu")["m"]
    got_l, paths = T.flatten(got_tree)
    want_l = T.leaves_at(want, paths)
    assert len(got_l) == len(T.leaves(want))
    return {"/".join(map(str, p)): leaf_err(g, w)
            for p, g, w in zip(paths, got_l, want_l)}


def update_errs(cfg, got_tree, want_np, grads_np, floor: float) -> tuple:
    """(max relative error of the updated parameters where the gradient
    is determined, max absolute difference anywhere).  AdamW's first step
    moves an element by lr x g / (|g| + eps): where the reference's |g| is
    below ``floor`` x the largest |g| of the tree (a key bias's gradient,
    zero in exact arithmetic, is float32 noise on both sides) its
    direction is noise, so those elements are held only to the absolute
    bound."""
    conv = functools.partial(opt_state_from_numpy, cfg, device="cpu")
    got, paths = T.flatten(got_tree)
    want = T.leaves_at(conv({"m": want_np, "step": 0})["m"], paths)
    grads = T.leaves_at(conv({"m": grads_np, "step": 0})["m"], paths)
    gmax = max(float(g.abs().max()) for g in grads)
    rel = absolute = 0.0
    for a, w, g in zip(got, want, grads):
        d = (a.detach().float() - w).abs()
        absolute = max(absolute, float(d.max()))
        keep = g.abs() >= floor * gmax
        if keep.any():
            rel = max(rel, float((d[keep] / (1 + w.abs()[keep])).max()))
    return rel, absolute


# Tolerances, float32 on both sides; the measured maxima over the ten
# smoke configs (seed 0, a loss mask, and whisper's padded vocab) in
# brackets.  Each side sums in its own order, so nothing is bit-equal.
#: loss, moe_aux and moe_z, relative [4.8e-7 / 6.4]
LOSS_TOL = 1e-6
#: grad_norm, relative [4.3e-7]
GNORM_TOL = 2e-6
#: each gradient leaf and each moment, max error over the leaf's largest
#: |value| [4.3e-6]
GRAD_TOL = 2e-5
#: the updated parameters where |g| >= FLOOR x the tree's largest |g|,
#: |d| / (1 + |p|) [8.1e-8]; everywhere else only the update's own bound,
#: 2 lr [4.7e-5]
PARAM_TOL, FLOOR = 1e-6, 1e-5


def check_loss(arch, **kw):
    """loss, ntok, moe_aux and moe_z of the port's ``lm_loss`` and of its
    train step against the reference's."""
    cfg, b, p, loss, met, *_ = reference(arch, **kw)
    got, metrics, _ = port_grads(cfg, p, b)
    step_metrics = port_step(config(arch, kw.get("vocab", 0)), p, b,
                             pad_vocab=kw.get("pad_vocab", False))[2]
    for m in (dict(metrics, loss=got), step_metrics):
        assert abs(float(m["loss"]) - float(loss)) <= \
            LOSS_TOL * abs(float(loss)), (arch, float(m["loss"]), loss)
        assert float(m["ntok"]) == float(met["ntok"])
        for name in ("moe_aux", "moe_z"):
            assert abs(float(m[name].detach()) - float(met[name])) <= \
                LOSS_TOL * max(1.0, abs(float(met[name]))), (arch, name)


def check_grads(arch, **kw):
    """Every gradient leaf, through ``params_from_numpy``'s layout (the
    reference's pad heads dropped: their gradients are zero), and the
    train step's ``grad_norm`` over the port's leaves, which must equal
    the reference's over its padded tree."""
    cfg, b, p, loss, met, grads, new, opt, om = reference(arch, **kw)
    _, _, got = port_grads(cfg, p, b)
    errs = tree_errs(cfg, got, grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (arch, worst, errs[worst])
    gnorm = float(port_step(config(arch, kw.get("vocab", 0)), p, b,
                            pad_vocab=kw.get("pad_vocab", False))[2][
        "grad_norm"])
    assert abs(gnorm - float(om["grad_norm"])) <= \
        GNORM_TOL * float(om["grad_norm"]), (arch, gnorm, om["grad_norm"])


def check_update(arch, **kw):
    """One AdamW update of ``build_train_step``: the step, the learning
    rate, the moments m and v, and the parameters."""
    cfg, b, p, loss, met, grads, new, opt, om = reference(arch, **kw)
    params, state, metrics = port_step(config(arch, kw.get("vocab", 0)), p,
                                       b, pad_vocab=kw.get("pad_vocab",
                                                           False))
    assert int(state["step"]) == int(opt["step"]) == 1
    assert float(metrics["lr"]) == float(om["lr"])
    for name in ("m", "v"):
        errs = tree_errs(cfg, state[name], opt[name])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_TOL, (arch, name, worst, errs[worst])
    rel, absolute = update_errs(cfg, params, new, grads, FLOOR)
    assert rel <= PARAM_TOL and absolute <= 2 * OPT["lr"], \
        (arch, rel, absolute)
