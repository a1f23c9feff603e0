"""The dense zoo's serving path (``repro_torch.models``) against the JAX
reference (``repro.models``) on the CPU, at the four dense smoke configs
in float32 and in their own bfloat16: ``forward`` logits; ``prefill``
logits and cache; a chain of ``decode_step``s fed the reference's own
prefill state, logits at every step and the caches at the end; and the
port's decode against the port's forward.  The reference's parameters
(``repro.models.init_params``) cross through ``params_from_numpy``; its
attention runs its plain jnp path (``use_pallas`` is never read), the
port's the kernels' plain versions.

Tolerances, ``|port - ref| <= TOL * (1 + |ref|)`` elementwise:

- float32, 2e-4: the reference's own decode-against-forward bound
  (``tests/test_models.py::test_decode_matches_forward``); the port is
  within 4.3e-6 over six seeds
  (``scripts/torch_models_gap.py --dtype float32``).
- bfloat16, 2**-4: both sides compute in bfloat16 but round at different
  points (XLA on the CPU rounds every op of silu's expansion, its exp, add,
  divide and product, where PyTorch's silu rounds once; the residual adds
  and casts likewise), so single roundings part by one bfloat16 ulp (2**-8
  to 2**-7 of the value) and add up over the three layers to a few ulps:
  at most 0.050 in that measure over six seeds of the four configs, and
  0.010 between the port's own decode and forward
  (``scripts/torch_models_gap.py --dtype bfloat16``).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_smoke_config
from repro_torch import models as P
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, params_from_numpy)

ARCHS = ("yi_6b", "deepseek_7b", "phi3_medium_14b", "command_r_plus_104b")
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}
B, S, STEPS = 2, 16, 4          # prompt of S - STEPS, then STEPS steps

_forward = jax.jit(R.forward, static_argnums=2)
_prefill = jax.jit(R.prefill, static_argnums=(2, 3))
_decode = jax.jit(R.decode_step, static_argnums=3)
_init = jax.jit(R.init_params, static_argnums=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=what)


@functools.cache
def _case(arch, dtype):
    """The reference's outputs at one config: forward logits, prefill
    logits and state, and a decode chain's logits and last state."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = _init(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(ARCHS.index(arch)).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    prompt = S - STEPS
    logits, state = _prefill(params, {"tokens": tokens[:, :prompt]}, cfg, S)
    prefill = (np.asarray(logits, np.float32), _np(state))
    steps = []
    for i in range(prompt, S):
        logits, state = _decode(params, state, tokens[:, i], cfg)
        steps.append(np.asarray(logits, np.float32))
    return dict(
        cfg=cfg, params=_np(params), tokens=tokens,
        forward=np.asarray(_forward(params, {"tokens": tokens}, cfg)[0],
                           np.float32),
        prefill=prefill, steps=steps, state=_np(state))


def _port(case):
    return params_from_numpy(case["cfg"], case["params"], device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    case = _case(arch, dtype)
    cfg = case["cfg"]
    logits, aux = P.forward(_port(case), {"tokens": case["tokens"]}, cfg,
                            device="cpu")
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == getattr(torch, dtype)
    assert float(aux["moe_aux"]) == 0.0 and float(aux["moe_z"]) == 0.0
    _close(logits, case["forward"], dtype, "forward logits")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    case = _case(arch, dtype)
    cfg = case["cfg"]
    want_logits, want_state = case["prefill"]
    logits, state = P.prefill(_port(case),
                              {"tokens": case["tokens"][:, :S - STEPS]},
                              cfg, max_len=S, device="cpu")
    assert state["pos"] == S - STEPS
    assert state["kv"]["k"].shape == (cfg.num_layers, B, cfg.num_kv_heads,
                                      S, cfg.head_dim)
    assert state["kv"]["k"].dtype == getattr(torch, dtype)
    _close(logits, want_logits, dtype, "prefill logits")
    got = decode_state_to_numpy(state)
    assert int(got["pos"]) == int(want_state["pos"])
    for n in ("k", "v"):
        _close(got["kv"][n], want_state["kv"][n], dtype, f"prefill cache {n}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_reference(arch, dtype):
    """Both sides decode from the reference's prefill state."""
    case = _case(arch, dtype)
    cfg = case["cfg"]
    params = _port(case)
    state = decode_state_from_numpy(cfg, case["prefill"][1], device="cpu")
    for i, want in enumerate(case["steps"]):
        logits, state = P.decode_step(
            params, state, case["tokens"][:, S - STEPS + i], cfg,
            device="cpu")
        assert logits.shape == (B, cfg.vocab_size)
        _close(logits, want, dtype, f"decode step {i}")
    got = decode_state_to_numpy(state)
    assert int(got["pos"]) == int(case["state"]["pos"]) == S
    for n in ("k", "v"):
        _close(got["kv"][n], case["state"]["kv"][n], dtype, f"cache {n}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, dtype):
    """The port's prefill and decode steps give the port's forward logits
    at the same positions (tests/test_models.py:58)."""
    case = _case(arch, dtype)
    cfg = case["cfg"]
    params = _port(case)
    tokens = torch.from_numpy(case["tokens"])
    whole = P.forward(params, {"tokens": tokens}, cfg, device="cpu")[0]
    prompt = S - STEPS
    logits, state = P.prefill(params, {"tokens": tokens[:, :prompt]}, cfg,
                              max_len=S, device="cpu")
    _close(logits, whole[:, prompt - 1].float().numpy(), dtype, "prefill")
    for i in range(prompt, S):
        logits, state = P.decode_step(params, state, tokens[:, i], cfg,
                                      device="cpu")
        _close(logits, whole[:, i].float().numpy(), dtype, f"position {i}")
