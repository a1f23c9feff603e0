"""The Mamba1 zoo's serving path (``repro_torch.models`` at falcon-mamba's
smoke config: 4 layers, d_model 64, d_inner 128, N 8, ``ssm_chunk`` 16)
against the JAX reference (``repro.models``) on the CPU, in float32 and in
bfloat16: ``forward`` logits; ``prefill`` logits and state (``ssm.h``,
``ssm.conv``) at prompts of 12 and 16 tokens; a chain of ``decode_step``s
fed the reference's own prefill state; the port's decode against the
port's forward; and the pieces of ``repro_torch.models.ssm``
(``causal_conv1d``, ``conv1d_step``, ``mamba1_block`` over a sequence and
over one step) against ``repro.models.ssm``, and the scan wrapper's end
state (``mamba_scan(..., final_state=True)``) against
``_mamba1_scan_chunked``'s.  The reference's parameters cross through
``params_from_numpy``; the port's scan runs its plain version, serial,
where the reference's is chunked and associative.

Tolerances, ``|port - ref| <= TOL * (1 + |ref|)`` elementwise:

- float32, 2e-4, as in ``tests/test_torch_models.py``; the port is within
  2.1e-6 over six seeds (``scripts/torch_models_gap.py --dtype float32``).
- bfloat16, 2**-5 on logits and 2**-4 on the decode state: both sides
  round at different points (silu, softplus and the residual adds as
  ``test_torch_models.py`` says), single roundings part by a bfloat16 ulp
  and add up over the four layers: at most 0.0135 on logits and 0.0455 on
  the state (the conv state is the in-projection's bfloat16 output) over
  six seeds (``scripts/torch_models_gap.py --dtype bfloat16``).  The
  port's own decode equals its forward bit for bit there; the hold is
  the logits' bound.
- The pieces: 1e-5 in float32; in bfloat16 one bfloat16 ulp, 2**-7
  relative (each side rounds its float32 sums once).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_smoke_config
from repro.models import ssm as RS
from repro_torch import models as P
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, params_from_numpy)
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.models import ssm as PS

ARCH = "falcon_mamba_7b"
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -5}
STATE_TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}
PIECE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
B, S, STEPS = 2, 16, 4          # prompt of S - STEPS, then STEPS steps
PROMPTS = (S - STEPS, S)

_forward = jax.jit(R.forward, static_argnums=2)
_prefill = jax.jit(R.prefill, static_argnums=(2, 3))
_decode = jax.jit(R.decode_step, static_argnums=3)
_init = jax.jit(R.init_params, static_argnums=0)
_conv = jax.jit(RS.causal_conv1d)
_block = jax.jit(RS.mamba1_block, static_argnums=2,
                 static_argnames="return_final_state")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _cfg(dtype):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


@functools.cache
def _case(dtype):
    """The reference's outputs: forward logits, prefill logits and state
    at each prompt, and a decode chain's logits and last state."""
    cfg = _cfg(dtype)
    params = _init(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(27).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefills = {}
    for n in PROMPTS:
        logits, state = _prefill(params, {"tokens": tokens[:, :n]}, cfg, S)
        prefills[n] = (np.asarray(logits, np.float32), _np(state))
    state = prefills[S - STEPS][1]
    steps = []
    for i in range(S - STEPS, S):
        logits, state = _decode(params, state, tokens[:, i], cfg)
        steps.append(np.asarray(logits, np.float32))
    return dict(
        cfg=cfg, params=_np(params), tokens=tokens,
        forward=np.asarray(_forward(params, {"tokens": tokens}, cfg)[0],
                           np.float32),
        prefill=prefills, steps=steps, state=_np(state))


def _port(case):
    return params_from_numpy(case["cfg"], case["params"], device="cpu")


def _close_state(got, want, dtype, what):
    got = decode_state_to_numpy(got)
    assert int(got["pos"]) == int(want["pos"])
    for n in ("h", "conv"):
        assert got["ssm"][n].shape == want["ssm"][n].shape
        _close(got["ssm"][n], want["ssm"][n], STATE_TOL[dtype],
               f"{what} {n}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype):
    case = _case(dtype)
    cfg = case["cfg"]
    logits, aux = P.forward(_port(case), {"tokens": case["tokens"]}, cfg,
                            device="cpu")
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == getattr(torch, dtype)
    assert float(aux["moe_aux"]) == 0.0 and float(aux["moe_z"]) == 0.0
    _close(logits, case["forward"], TOL[dtype], "forward logits")


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype, prompt):
    case = _case(dtype)
    cfg = case["cfg"]
    want_logits, want_state = case["prefill"][prompt]
    logits, state = P.prefill(_port(case),
                              {"tokens": case["tokens"][:, :prompt]}, cfg,
                              max_len=S, device="cpu")
    assert state["pos"] == prompt
    L, di, N, W = (cfg.num_layers, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv)
    assert state["ssm"]["h"].shape == (L, B, di, N)
    assert state["ssm"]["h"].dtype == torch.float32
    assert state["ssm"]["conv"].shape == (L, B, W - 1, di)
    assert state["ssm"]["conv"].dtype == getattr(torch, dtype)
    _close(logits, want_logits, TOL[dtype], "prefill logits")
    _close_state(state, want_state, dtype, "prefill state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_chain_matches_reference(dtype):
    """Both sides decode from the reference's prefill state."""
    case = _case(dtype)
    cfg = case["cfg"]
    params = _port(case)
    state = decode_state_from_numpy(cfg, case["prefill"][S - STEPS][1],
                                    device="cpu")
    for i, want in enumerate(case["steps"]):
        logits, state = P.decode_step(
            params, state, case["tokens"][:, S - STEPS + i], cfg,
            device="cpu")
        assert logits.shape == (B, cfg.vocab_size)
        _close(logits, want, TOL[dtype], f"decode step {i}")
    assert state["pos"] == S
    _close_state(state, case["state"], dtype, "decoded state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_forward(dtype):
    """The port's prefill and decode steps give the port's forward logits
    at the same positions (tests/test_models.py:58)."""
    case = _case(dtype)
    cfg = case["cfg"]
    params = _port(case)
    tokens = torch.from_numpy(case["tokens"])
    whole = P.forward(params, {"tokens": tokens}, cfg, device="cpu")[0]
    prompt = S - STEPS
    logits, state = P.prefill(params, {"tokens": tokens[:, :prompt]}, cfg,
                              device="cpu")
    _close(logits, whole[:, prompt - 1].float().numpy(), TOL[dtype],
           "prefill")
    for i in range(prompt, S):
        logits, state = P.decode_step(params, state, tokens[:, i], cfg,
                                      device="cpu")
        _close(logits, whole[:, i].float().numpy(), TOL[dtype],
               f"position {i}")


def _block_params(cfg, seed):
    """The reference's Mamba1 parameters with random ``conv_b``, ``D`` and
    ``dt_bias`` (zeros and ones would hide a wrong term), and the port's
    copy of them (as ``params_from_numpy`` holds them)."""
    p, _ = RS.init_mamba1(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    di = cfg.d_inner
    p = dict(p, conv_b=jnp.asarray(rng.standard_normal(di) * 0.3,
                                   jnp.float32),
             D=jnp.asarray(1 + rng.standard_normal(di) * 0.3, jnp.float32),
             dt_bias=p["dt_bias"] + jnp.asarray(rng.standard_normal(di),
                                                jnp.float32))
    held = ("conv_w", "conv_b", "A_log", "dt_bias", "D")
    port = {n: torch.tensor(np.asarray(a, np.float32)).to(
        torch.float32 if n in held else getattr(torch, cfg.dtype))
        for n, a in p.items()}
    return p, port


def _x(cfg, seed, *shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, cfg.dtype), torch.tensor(x).to(getattr(torch,
                                                               cfg.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d_matches_reference(dtype):
    cfg = _cfg(dtype)
    p, port = _block_params(cfg, 1)
    jx, tx = _x(cfg, 1, B, 11, cfg.d_inner)
    want = _conv(jx, p["conv_w"], p["conv_b"])
    got = PS.causal_conv1d(tx, port["conv_w"], port["conv_b"])
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, PIECE_TOL[dtype], "causal_conv1d")
    nob = PS.causal_conv1d(tx, port["conv_w"], None)
    _close(nob, _conv(jx, p["conv_w"], None), PIECE_TOL[dtype],
           "causal_conv1d without bias")


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1d_step_matches_reference(dtype):
    cfg = _cfg(dtype)
    p, port = _block_params(cfg, 2)
    W = cfg.ssm_conv
    jx, tx = _x(cfg, 2, B, cfg.d_inner)
    js, ts = _x(cfg, 3, B, W - 1, cfg.d_inner)
    want, want_state = RS.conv1d_step(jx, js, p["conv_w"], p["conv_b"])
    got, state = PS.conv1d_step(tx, ts, port["conv_w"], port["conv_b"])
    assert got.dtype == tx.dtype and state.shape == (B, W - 1, cfg.d_inner)
    _close(got, want, PIECE_TOL[dtype], "conv1d_step")
    _close(state, want_state, 0.0, "conv1d_step state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba1_block_matches_reference(dtype):
    """Over a sequence (with the end state) and then one step from it.
    The block's output passes through two bfloat16 products, so it is
    held at the logits' bound."""
    cfg = _cfg(dtype)
    p, port = _block_params(cfg, 4)
    L = cfg.ssm_chunk
    jx, tx = _x(cfg, 4, B, L + 1, cfg.d_model)
    want, want_state = _block(p, jx[:, :L], cfg, return_final_state=True)
    got, state = PS.mamba1_block(port, tx[:, :L], cfg,
                                 return_final_state=True)
    assert got.shape == (B, L, cfg.d_model) and got.dtype == tx.dtype
    _close(got, want, TOL[dtype], "mamba1_block")
    for n in ("h", "conv"):
        assert state[n].dtype == (torch.float32 if n == "h" else tx.dtype)
        _close(state[n], want_state[n], STATE_TOL[dtype], f"end state {n}")
    alone, none = PS.mamba1_block(port, tx[:, :L], cfg)
    assert none is None and torch.equal(alone, got)
    want, want_state = _block(p, jx[:, L:], cfg, want_state)
    got, state = PS.mamba1_block(port, tx[:, L:], cfg, state=state)
    assert got.shape == (B, 1, cfg.d_model)
    _close(got, want, TOL[dtype], "mamba1_block step")
    for n in ("h", "conv"):
        _close(state[n], want_state[n], STATE_TOL[dtype], f"step state {n}")


@pytest.mark.parametrize("L,chunk", [(16, 16), (48, 16), (12, 12)])
def test_scan_final_state_matches_reference(L, chunk):
    """``mamba_scan(..., final_state=True)``: y and the end state against
    the reference's chunked scan from zero (its h_final)."""
    rng = np.random.default_rng(L)
    D, N = 24, 8
    u = rng.standard_normal((B, L, D)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, L, D)))).astype(
        np.float32) * 0.1
    Bm, Cm = (rng.standard_normal((B, L, N)).astype(np.float32) * 0.5
              for _ in range(2))
    A = -np.exp(rng.standard_normal((D, N)).astype(np.float32) * 0.3)
    want_y, want_h = RS._mamba1_scan_chunked(
        *(jnp.asarray(a) for a in (u, dt, Bm, Cm, A)),
        jnp.zeros((B, D, N), jnp.float32), chunk)
    args = [torch.from_numpy(a) for a in (u, dt, Bm, Cm, A)]
    y, h = scan_kernel.mamba_scan(*args, final_state=True)
    assert h.shape == (B, D, N) and h.dtype == torch.float32
    _close(y, want_y, 1e-5, "y")
    _close(h, want_h, 1e-5, "h_L")
    assert torch.equal(scan_kernel.mamba_scan(*args), y)


def test_prefill_refuses_a_prompt_shorter_than_the_conv_state():
    """Below ``ssm_conv - 1`` tokens the reference's prefill returns a
    conv state its own decode refuses; the port raises.  At W - 1 tokens
    and at a length that is no multiple of ``ssm_chunk`` (which the
    reference's chunked scan refuses) the port serves, its prefill and
    decode equal to its forward."""
    cfg = _cfg("float32")
    params = P.init_params(cfg, seed=5, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 21)))
    with pytest.raises(ValueError, match="shorter"):
        P.prefill(params, {"tokens": tokens[:, :2]}, cfg, device="cpu")
    whole = P.forward(params, {"tokens": tokens}, cfg, device="cpu")[0]
    for n in (cfg.ssm_conv - 1, 20):
        logits, state = P.prefill(params, {"tokens": tokens[:, :n]}, cfg,
                                  device="cpu")
        _close(logits, whole[:, n - 1].numpy(), 1e-5, f"prefill of {n}")
        logits, state = P.decode_step(params, state, tokens[:, n], cfg,
                                      device="cpu")
        _close(logits, whole[:, n].numpy(), 1e-5, f"step after {n}")


def test_scan_goes_through_the_kernel_wrapper(monkeypatch):
    """Once a layer a pass through the scan wrapper (on the card each call
    is one launch), the end state asked for by prefill alone; a decode
    step calls it never."""
    calls = []
    scan = scan_kernel.mamba_scan

    def counted(*a, final_state=False):
        calls.append(final_state)
        return scan(*a, final_state=final_state)

    monkeypatch.setattr(scan_kernel, "mamba_scan", counted)
    cfg = _cfg("float32")
    params = P.init_params(cfg, seed=6, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 8)))
    P.forward(params, {"tokens": tokens}, cfg, device="cpu")
    assert calls == [False] * cfg.num_layers
    logits, state = P.prefill(params, {"tokens": tokens}, cfg, device="cpu")
    assert calls == [False] * cfg.num_layers + [True] * cfg.num_layers
    h = state["ssm"]["h"]
    for _ in range(3):
        logits, state = P.decode_step(params, state, logits.argmax(-1), cfg,
                                      device="cpu")
    assert len(calls) == 2 * cfg.num_layers
    assert state["pos"] == 11 and state["ssm"]["h"] is h     # in place


def test_init_params_follows_the_reference_layout():
    cfg = _cfg("bfloat16")
    a = P.init_params(cfg, seed=3, device="cpu")
    ref = jax.eval_shape(lambda: R.init_params(cfg, jax.random.PRNGKey(0)))
    assert a["embed"].keys() == ref["embed"].keys() == {"tok"}
    assert len(a["layers"]) == cfg.num_layers
    held = ("conv_w", "conv_b", "A_log", "dt_bias", "D")
    for group, sub in a["layers"][0].items():
        assert sub.keys() == ref["layers"][group].keys()
        for n, t in sub.items():
            assert tuple(t.shape) == ref["layers"][group][n].shape[1:]
            assert t.dtype == (torch.float32 if group == "ln1" or n in held
                               else torch.bfloat16), (group, n)
    m = a["layers"][0]["mamba"]
    want = _np(RS.init_mamba1(jax.random.PRNGKey(0), cfg)[0])
    for n in ("conv_b", "A_log", "dt_bias", "D"):
        np.testing.assert_allclose(m[n].numpy(), want[n], rtol=1e-6)
    assert not torch.equal(m["in_proj"], a["layers"][1]["mamba"]["in_proj"])


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs")
    cfg = _cfg("bfloat16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.init_params(cfg)
    params = P.init_params(cfg, device="cpu")
    batch = {"tokens": np.zeros((B, 4), np.int32)}
    state = P.init_decode_state(cfg, B, 8, device="cpu")
    for call in (lambda: P.forward(params, batch, cfg),
                 lambda: P.prefill(params, batch, cfg),
                 lambda: P.init_decode_state(cfg, B, 8),
                 lambda: P.decode_step(params, state, batch["tokens"][:, 0],
                                       cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
