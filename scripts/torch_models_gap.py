"""How far the PyTorch port's zoo lies from the JAX reference's, both on
the CPU: the measure behind the tolerances of
``tests/test_torch_models.py``, ``tests/test_torch_models_ssm.py`` and
``tests/test_torch_models_hybrid.py``.

For each dense smoke config (yi-6b, deepseek-7b, phi3-medium-14b,
command-r-plus-104b), falcon-mamba-7b's (Mamba1, and Mamba2 as
``falcon_mamba_7b/mamba2``), zamba2-2.7b's (hybrid) and each of six seeds,
the reference's parameters (``repro.models.init_params``) cross to the
port through ``params_from_numpy``; both run ``forward`` over 2 x 16
tokens, ``prefill`` of 16 and of 12 into 16 slots, and 4
``decode_step``s (the port's from the reference's prefill state), and
the port also decodes from its own prefill.  Prints, per config, the largest ``|port - ref| / (1 + |ref|)``
over the seeds of the forward logits, prefill logits, prefill state (the
caches and the ssm layers' h and conv) and decode logits, and of the port's
decode against its own forward.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_models_gap.py --dtype bfloat16
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_models_gap.py --only zamba2_2p7b
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import numpy as np

from repro import models as R
from repro.configs import get_smoke_config
from repro_torch import models as P
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, params_from_numpy)

ARCHS = ("yi_6b", "deepseek_7b", "phi3_medium_14b", "command_r_plus_104b",
         "falcon_mamba_7b", "falcon_mamba_7b/mamba2", "zamba2_2p7b")
B, S, STEPS = 2, 16, 4
SEEDS = 6


def _np32(a) -> np.ndarray:
    """A torch tensor, jax array or numpy array as float32 numpy."""
    return np.asarray(a.float().numpy() if hasattr(a, "numpy") and
                      hasattr(a, "float") else a, np.float32)


def gap(got, want) -> float:
    got, want = _np32(got), _np32(want)
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def state_leaves(state: dict) -> dict:
    """The tensors of a decode state in the reference's layout: the
    caches k and v and the ssm layers' h and conv, where it has them."""
    return {**state.get("ssm", {}), **state.get("kv", {})}


def one(cfg, seed, fns) -> dict:
    init, forward, prefill, decode = fns
    params = init(cfg, jax.random.PRNGKey(seed))
    port = params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    prompt = S - STEPS
    whole = P.forward(port, {"tokens": tokens}, cfg, device="cpu")[0]
    out = {"forward": gap(whole, forward(params, {"tokens": tokens}, cfg)[0]),
           "prefill": 0.0, "state": 0.0}
    for n_tok in (S, prompt):              # the prompt's state stays
        want, ref_state = prefill(params, {"tokens": tokens[:, :n_tok]}, cfg,
                                  S)
        got, own = P.prefill(port, {"tokens": tokens[:, :n_tok]}, cfg,
                             max_len=S, device="cpu")
        out["prefill"] = max(out["prefill"], gap(got, want))
        mine = state_leaves(decode_state_to_numpy(own))
        out["state"] = max(out["state"], *(
            gap(t, state_leaves(ref_state)[n]) for n, t in mine.items()))
    state = decode_state_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_state), device="cpu")
    out["decode"] = out["decode_vs_forward"] = 0.0
    for i in range(prompt, S):
        want, ref_state = decode(params, ref_state, tokens[:, i], cfg)
        got, state = P.decode_step(port, state, tokens[:, i], cfg,
                                   device="cpu")
        out["decode"] = max(out["decode"], gap(got, want))
        got, own = P.decode_step(port, own, tokens[:, i], cfg, device="cpu")
        out["decode_vs_forward"] = max(out["decode_vs_forward"],
                                       gap(got, whole[:, i]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--only", nargs="+", choices=ARCHS, default=ARCHS,
                    help="the configs to measure (all by default)")
    args = ap.parse_args(argv)
    fns = (jax.jit(R.init_params, static_argnums=0),
           jax.jit(R.forward, static_argnums=2),
           jax.jit(R.prefill, static_argnums=(2, 3)),
           jax.jit(R.decode_step, static_argnums=3))
    worst = {}
    for arch in args.only:
        name, _, version = arch.partition("/mamba")
        cfg = dataclasses.replace(get_smoke_config(name), dtype=args.dtype)
        if version:
            cfg = dataclasses.replace(cfg, ssm_version=int(version))
        mine = {}
        for seed in range(SEEDS):
            for k, v in one(cfg, seed, fns).items():
                mine[k] = max(mine.get(k, 0.0), v)
        print(f"{arch} {args.dtype}, worst of {SEEDS} seeds: "
              + ", ".join(f"{k} {v:.4g}" for k, v in mine.items()),
              flush=True)
        for k, v in mine.items():
            worst[k] = max(worst.get(k, 0.0), v)
    print("all: " + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()))


if __name__ == "__main__":
    main()
