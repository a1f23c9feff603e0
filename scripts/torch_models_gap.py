"""How far the PyTorch port's zoo lies from the JAX reference's, both on
the CPU: the measure behind the tolerances of
``tests/test_torch_models.py``, ``tests/test_torch_models_ssm.py``,
``tests/test_torch_models_hybrid.py`` and ``tests/test_torch_models_moe.py``.

For each dense smoke config (yi-6b, deepseek-7b, phi3-medium-14b,
command-r-plus-104b), falcon-mamba-7b's (Mamba1, and Mamba2 as
``falcon_mamba_7b/mamba2``), zamba2-2.7b's (hybrid), the two MoE configs'
(phi3.5-moe-42b, qwen3-moe-30b) and each of six seeds,
the reference's parameters (``repro.models.init_params``) cross to the
port through ``params_from_numpy``; both run ``forward`` over 2 x 16
tokens, ``prefill`` of 16 and of 12 into 16 slots, and 4
``decode_step``s (the port's from the reference's prefill state), and
the port also decodes from its own prefill.  Prints, per config, the largest ``|port - ref| / (1 + |ref|)``
over the seeds of the forward logits, prefill logits, prefill state (the
caches and the ssm layers' h and conv) and decode logits, and of the port's
decode against its own forward.  A MoE config's own decode runs at
``capacity_factor = E / k``, where no token is dropped (at the config's
1.25 a forward's tokens compete for slots that a step's few never fill);
and for it the script also counts the (token, layer) expert sets of the
forward that differ between the packages (``swaps``, of ``routed``), each
side's set routed from its own layer input (a swap moves a token's output
by O(1), not by ulps), the largest gap of the router's probabilities so
routed (``router``), and the forward's gap on the positions that no
parting of the routing reaches (``forward_unparted``: a token whose
expert set or kept entries differ in a layer, and the rest of its row).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_models_gap.py --dtype bfloat16
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_models_gap.py --only zamba2_2p7b
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import numpy as np
import torch

from repro import models as R
from repro.configs import get_smoke_config
from repro.models import model as RMODEL
from repro.models import moe as RMOE
from repro_torch import models as P
from repro_torch.models import moe as PMOE
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, params_from_numpy)

ARCHS = ("yi_6b", "deepseek_7b", "phi3_medium_14b", "command_r_plus_104b",
         "falcon_mamba_7b", "falcon_mamba_7b/mamba2", "zamba2_2p7b",
         "phi3p5_moe_42b", "qwen3_moe_30b")
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


#: each moe layer's input of the last forward on either side, in order
SEEN = {"ref": [], "port": []}


def record_moe_inputs() -> None:
    """Wrap both packages' ``moe_block`` to append each call's input to
    ``SEEN``: the reference's, jitted with its layers under lax.scan,
    through an ordered callback, which changes no value.  Called before
    the reference's entry points are first traced."""
    ref_base, port_base = RMODEL.moe_block, PMOE.moe_block

    def ref_spy(p, x, cfg):
        jax.debug.callback(lambda v: SEEN["ref"].append(np.asarray(v)), x,
                           ordered=True)
        return ref_base(p, x, cfg)

    def port_spy(p, x, cfg):
        SEEN["port"].append(x.float().numpy())
        return port_base(p, x, cfg)

    RMODEL.moe_block, PMOE.moe_block = ref_spy, port_spy


def expert_swaps(params, port, cfg):
    """Over the last forward's moe layers, each side routing its own layer
    input with its own package: the largest gap of the router's
    probabilities, the (token, layer) expert sets that differ, how many
    were routed, and the (B, S) positions a parting reaches (a token
    whose set or kept entries differ in a layer, and the rest of its
    row, where attention carries it)."""
    k, E = cfg.experts_per_token, cfg.num_experts
    C = PMOE.capacity(cfg, B * S)
    swaps = routed = 0
    router_gap = 0.0
    parted = np.zeros(B * S, bool)
    for layer, (r, p) in enumerate(zip(SEEN["ref"], SEEN["port"])):
        rx = jax.numpy.asarray(r.reshape(-1, cfg.d_model), np.float32)
        rw = params["layers"]["moe"]["router"][layer]
        px = torch.from_numpy(p.reshape(-1, cfg.d_model))
        pw = port["layers"][layer]["moe"]["router"]
        router_gap = max(router_gap, float(np.abs(
            np.asarray(jax.nn.softmax(rx @ rw, axis=-1))
            - torch.softmax(px @ pw, dim=-1).numpy()).max()))
        ref_ids = RMOE._route(rx, rw, k)[1]
        port_ids = PMOE._route(px, pw, k)[1]
        ref_kept = np.where(np.asarray(RMOE._dispatch_indices(
            ref_ids, E, C)[1]).reshape(-1, k), np.asarray(ref_ids), -1)
        port_kept = np.where(PMOE._dispatch_indices(
            port_ids, E, C)[1].numpy().reshape(-1, k), port_ids.numpy(), -1)
        ref_ids, port_ids = np.asarray(ref_ids), port_ids.numpy()
        swapped = (np.sort(ref_ids, 1) != np.sort(port_ids, 1)).any(1)
        swaps += int(swapped.sum())
        routed += ref_ids.shape[0]
        parted |= swapped | (np.sort(ref_kept, 1)
                             != np.sort(port_kept, 1)).any(1)
    tainted = np.logical_or.accumulate(parted.reshape(B, S), axis=1)
    return router_gap, swaps, routed, tainted


def own_decode_gap(port, tokens, cfg) -> float:
    """The port's decode from its own prefill against its own forward; a
    MoE config at ``capacity_factor = E / k``."""
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    prompt = S - STEPS
    whole = P.forward(port, {"tokens": tokens}, cfg, device="cpu")[0]
    got, own = P.prefill(port, {"tokens": tokens[:, :prompt]}, cfg,
                         max_len=S, device="cpu")
    worst = gap(got, whole[:, prompt - 1])
    for i in range(prompt, S):
        got, own = P.decode_step(port, own, tokens[:, i], cfg, device="cpu")
        worst = max(worst, gap(got, whole[:, i]))
    return worst


def one(cfg, seed, fns) -> dict:
    init, forward, prefill, decode = fns
    params = init(cfg, jax.random.PRNGKey(seed))
    port = params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    prompt = S - STEPS
    for seen in SEEN.values():
        seen.clear()
    whole = P.forward(port, {"tokens": tokens}, cfg, device="cpu")[0]
    want = forward(params, {"tokens": tokens}, cfg)[0]
    jax.effects_barrier()
    out = {"forward": gap(whole, want), "prefill": 0.0, "state": 0.0}
    if cfg.family == "moe":
        out["router"], out["swaps"], out["routed"], tainted = expert_swaps(
            params, port, cfg)
        out["forward_unparted"] = gap(_np32(whole)[~tainted],
                                      _np32(want)[~tainted])
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
    out["decode"] = 0.0
    for i in range(prompt, S):
        want, ref_state = decode(params, ref_state, tokens[:, i], cfg)
        got, state = P.decode_step(port, state, tokens[:, i], cfg,
                                   device="cpu")
        out["decode"] = max(out["decode"], gap(got, want))
    out["decode_vs_forward"] = own_decode_gap(port, tokens, cfg)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--only", nargs="+", choices=ARCHS, default=ARCHS,
                    help="the configs to measure (all by default)")
    args = ap.parse_args(argv)
    record_moe_inputs()
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
        mine, counts = {}, {}
        for seed in range(SEEDS):
            got = one(cfg, seed, fns)
            for k in ("swaps", "routed"):
                if k in got:
                    counts.setdefault(k, []).append(got.pop(k))
            for k, v in got.items():
                mine[k] = max(mine.get(k, 0.0), v)
        print(f"{arch} {args.dtype}, worst of {SEEDS} seeds: "
              + ", ".join(f"{k} {v:.4g}" for k, v in mine.items())
              + ("" if not counts else
                 f"; (token, layer) expert sets that differ, seeds 0-"
                 f"{SEEDS - 1}: {counts['swaps']} of {counts['routed']}"),
              flush=True)
        for k, v in mine.items():
            worst[k] = max(worst.get(k, 0.0), v)
    print("all: " + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()))


if __name__ == "__main__":
    main()
