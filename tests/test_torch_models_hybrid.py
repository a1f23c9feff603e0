"""The hybrid zoo's serving path (``repro_torch.models`` at zamba2's smoke
config: 4 Mamba2 layers in 2 super-blocks of ``attn_every`` 2, each
followed by the shared dense block; d_model 64, d_inner 128, 8 heads of
16, N 16, ``ssm_chunk`` 16; 4 query heads, which the reference pads to
16) and the ssm family under Mamba2 (falcon-mamba's smoke config with
``ssm_version=2``), against the JAX reference (``repro.models``) on the
CPU, in float32 and in bfloat16: ``forward`` logits over 32 tokens (two
chunks); ``prefill`` logits and state (every layer's ``ssm.h`` and
``ssm.conv``, and each super-block's K/V) at prompts of 13, 16 and 32
tokens; a chain of ``decode_step``s fed the reference's own prefill
state; the port's decode against the port's forward; and the pieces of
``repro_torch.models.ssm`` (``ssd_chunked``, ``mamba2_block`` over a
sequence and over one step) against ``repro.models.ssm``.  The
reference's parameters cross through ``params_from_numpy``; the shared
block's attention runs the plain versions of the flash and decode
kernels.

Where the reference does not run (a prompt past one chunk and no multiple
of it, L = 20: its ``assert nc * chunk == L``), the port's prefill and
decode are held to the port's own forward.

Tolerances, ``|port - ref| <= TOL * (1 + |ref|)`` elementwise:

- float32, 2e-4, as in ``tests/test_torch_models.py``; the port is within
  4.5e-6 over six seeds (``scripts/torch_models_gap.py --dtype float32
  --only zamba2_2p7b falcon_mamba_7b/mamba2``).
- bfloat16, 2**-3 on logits and on the decode state: both sides round at
  different points (the bfloat16 silu of the conv's output parts from
  the reference's by an ulp on a third of the elements, and the
  residual adds as ``test_torch_models.py`` says), and the single
  roundings add up over the layers and the shared block's two passes:
  at most 0.0686 on logits and 0.0814 on the state over six seeds
  (``scripts/torch_models_gap.py --dtype bfloat16 --only zamba2_2p7b
  falcon_mamba_7b/mamba2``), past the dense family's 2**-4.  The port's
  own decode is held to its forward at the same bound.
- The pieces: 1e-5 in float32; in bfloat16 the block's output at the
  logits' bound and the SSD (float32 throughout) at 1e-5.
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
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.models import ssm as PS

#: zamba2's hybrid, and the ssm family under Mamba2
ARCHS = ("zamba2_2p7b", "falcon_mamba_7b/mamba2")
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -3}
PIECE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -3}
B, S, STEPS = 2, 32, 4          # forward over S; a chain of STEPS steps
PROMPTS = (13, 16, 32)          # the reference's lengths at chunk 16
CHAIN = PROMPTS[0]              # the decode chain starts here

_forward = jax.jit(R.forward, static_argnums=2)
_prefill = jax.jit(R.prefill, static_argnums=(2, 3))
_decode = jax.jit(R.decode_step, static_argnums=3)
_init = jax.jit(R.init_params, static_argnums=0)
_block = jax.jit(RS.mamba2_block, static_argnums=2,
                 static_argnames="return_final_state")
_ssd = jax.jit(RS._ssd_chunked, static_argnums=6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _cfg(arch, dtype="float32"):
    name, _, version = arch.partition("/mamba")
    cfg = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    if version:
        cfg = dataclasses.replace(cfg, ssm_version=int(version))
    return cfg


@functools.cache
def _ref_params(arch):
    """The reference's parameters, made once an arch: its init reads
    ``cfg.param_dtype`` and not ``cfg.dtype``."""
    return _init(_cfg(arch), jax.random.PRNGKey(0))


@functools.cache
def _case(arch, dtype):
    """The reference's outputs: forward logits, prefill logits and state
    at each prompt, and a decode chain's logits and last state."""
    cfg = _cfg(arch, dtype)
    params = _ref_params(arch)
    tokens = np.random.default_rng(28).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefills = {}
    for n in PROMPTS:
        logits, state = _prefill(params, {"tokens": tokens[:, :n]}, cfg,
                                 S + STEPS)
        prefills[n] = (np.asarray(logits, np.float32), _np(state))
    state = prefills[CHAIN][1]
    steps = []
    for i in range(CHAIN, CHAIN + STEPS):
        logits, state = _decode(params, state, tokens[:, i], cfg)
        steps.append(np.asarray(logits, np.float32))
    return dict(
        cfg=cfg, params=_np(params), tokens=tokens,
        forward=np.asarray(_forward(params, {"tokens": tokens}, cfg)[0],
                           np.float32),
        prefill=prefills, steps=steps, state=_np(state))


def _port(case):
    return params_from_numpy(case["cfg"], case["params"], device="cpu")


def _close_state(got, want, tol, what):
    got = decode_state_to_numpy(got)
    assert int(got["pos"]) == int(want["pos"])
    assert got.keys() == want.keys()
    for group in ("ssm", "kv"):
        for n, t in got.get(group, {}).items():
            assert t.shape == want[group][n].shape, (what, n)
            _close(t, want[group][n], tol, f"{what} {n}")


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
    _close(logits, case["forward"], TOL[dtype], "forward logits")


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype, prompt):
    """Logits, every layer's h and conv and, for the hybrid, each
    super-block's K/V."""
    case = _case(arch, dtype)
    cfg = case["cfg"]
    want_logits, want_state = case["prefill"][prompt]
    logits, state = P.prefill(_port(case),
                              {"tokens": case["tokens"][:, :prompt]}, cfg,
                              max_len=S + STEPS, device="cpu")
    assert state["pos"] == prompt
    L, nh, hd, N, W = (cfg.num_layers, cfg.ssm_num_heads, cfg.ssm_head_dim,
                       cfg.ssm_state, cfg.ssm_conv)
    assert state["ssm"]["h"].shape == (L, B, nh, hd, N)
    assert state["ssm"]["h"].dtype == torch.float32
    assert state["ssm"]["conv"].shape == (L, B, W - 1,
                                          cfg.d_inner + 2 * N)
    assert state["ssm"]["conv"].dtype == getattr(torch, dtype)
    if cfg.family == "hybrid":
        n_super = L // cfg.attn_every
        assert n_super == 2
        for n in ("k", "v"):
            assert state["kv"][n].shape == (n_super, B, cfg.num_kv_heads,
                                            S + STEPS, cfg.head_dim)
            assert state["kv"][n].dtype == getattr(torch, dtype)
            assert not state["kv"][n][:, :, :, prompt:].any()
    else:
        assert "kv" not in state
    _close(logits, want_logits, TOL[dtype], "prefill logits")
    _close_state(state, want_state, TOL[dtype], "prefill state")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_reference(arch, dtype):
    """Both sides decode from the reference's prefill state."""
    case = _case(arch, dtype)
    cfg = case["cfg"]
    params = _port(case)
    state = decode_state_from_numpy(cfg, case["prefill"][CHAIN][1],
                                    device="cpu")
    for i, want in enumerate(case["steps"]):
        logits, state = P.decode_step(
            params, state, case["tokens"][:, CHAIN + i], cfg, device="cpu")
        assert logits.shape == (B, cfg.vocab_size)
        _close(logits, want, TOL[dtype], f"decode step {i}")
    assert state["pos"] == CHAIN + STEPS
    _close_state(state, case["state"], TOL[dtype], "decoded state")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, dtype):
    """The port's prefill of 13 tokens and its decode steps through the
    rest of the 32 give the port's forward logits at the same positions,
    across the chunk boundary at 16 (tests/test_models.py:58)."""
    case = _case(arch, dtype)
    cfg = case["cfg"]
    params = _port(case)
    tokens = torch.from_numpy(case["tokens"])
    whole = P.forward(params, {"tokens": tokens}, cfg, device="cpu")[0]
    logits, state = P.prefill(params, {"tokens": tokens[:, :CHAIN]}, cfg,
                              max_len=S, device="cpu")
    _close(logits, whole[:, CHAIN - 1].float().numpy(), TOL[dtype],
           "prefill")
    for i in range(CHAIN, S):
        logits, state = P.decode_step(params, state, tokens[:, i], cfg,
                                      device="cpu")
        _close(logits, whole[:, i].float().numpy(), TOL[dtype],
               f"position {i}")


def _block_params(cfg, seed):
    """The reference's Mamba2 parameters with random ``conv_b``, ``D``,
    ``dt_bias`` and ``norm_scale`` (zeros and ones would hide a wrong
    term), and the port's copy of them (as ``params_from_numpy`` holds
    them)."""
    p, _ = RS.init_mamba2(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    nh, ch = cfg.ssm_num_heads, cfg.d_inner + 2 * cfg.ssm_state

    def noise(n, scale):
        return jnp.asarray(rng.standard_normal(n) * scale, jnp.float32)

    p = dict(p, conv_b=noise(ch, 0.3), D=1 + noise(nh, 0.3),
             dt_bias=p["dt_bias"] + noise(nh, 1.0),
             norm_scale=1 + noise(cfg.d_inner, 0.3))
    port = {n: torch.tensor(np.asarray(a, np.float32)).to(
        torch.float32 if n in PS.PARAM_DTYPE_LEAVES
        else getattr(torch, cfg.dtype)) for n, a in p.items()}
    return p, port


def _x(cfg, seed, *shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, cfg.dtype), torch.tensor(x).to(getattr(torch,
                                                               cfg.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_block_matches_reference(arch, dtype):
    """Over two chunks (with the end state), then one step from it; and
    without the end state, the same output."""
    cfg = _cfg(arch, dtype)
    p, port = _block_params(cfg, 4)
    L = 2 * cfg.ssm_chunk
    jx, tx = _x(cfg, 4, B, L + 1, cfg.d_model)
    want, want_state = _block(p, jx[:, :L], cfg, return_final_state=True)
    got, state = PS.mamba2_block(port, tx[:, :L], cfg,
                                 return_final_state=True)
    assert got.shape == (B, L, cfg.d_model) and got.dtype == tx.dtype
    _close(got, want, PIECE_TOL[dtype], "mamba2_block")
    assert state["h"].shape == (B, cfg.ssm_num_heads, cfg.ssm_head_dim,
                                cfg.ssm_state)
    assert state["conv"].shape == (B, cfg.ssm_conv - 1,
                                   cfg.d_inner + 2 * cfg.ssm_state)
    for n in ("h", "conv"):
        assert state[n].dtype == (torch.float32 if n == "h" else tx.dtype)
        _close(state[n], want_state[n], PIECE_TOL[dtype], f"end state {n}")
    alone, none = PS.mamba2_block(port, tx[:, :L], cfg)
    assert none is None and torch.equal(alone, got)
    want, want_state = _block(p, jx[:, L:], cfg, want_state)
    got, state = PS.mamba2_block(port, tx[:, L:], cfg, state=state)
    assert got.shape == (B, 1, cfg.d_model)
    _close(got, want, PIECE_TOL[dtype], "mamba2_block step")
    for n in ("h", "conv"):
        _close(state[n], want_state[n], PIECE_TOL[dtype], f"step state {n}")


def _ssd_inputs(L, nh=3, hd=4, N=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, nh)))).astype(
        np.float32) * 0.5
    Bm, Cm = (rng.standard_normal((B, L, N)).astype(np.float32)
              for _ in range(2))
    A = -np.exp(rng.standard_normal(nh).astype(np.float32) * 0.5)
    h0 = rng.standard_normal((B, nh, hd, N)).astype(np.float32)
    return x, dt, Bm, Cm, A, h0


@pytest.mark.parametrize("L,chunk", [(16, 16), (48, 16), (12, 12), (1, 1)])
def test_ssd_chunked_matches_reference(L, chunk):
    """y and the end state from a nonzero h0, at the lengths the
    reference takes."""
    args = _ssd_inputs(L, seed=L)
    want_y, want_h = _ssd(*(jnp.asarray(a) for a in args), chunk)
    y, h = PS.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    assert y.shape == (B, L, 3, 4) and h.shape == (B, 3, 4, 5)
    _close(y, want_y, 1e-5, "y")
    _close(h, want_h, 1e-5, "h")


def test_ssd_chunked_takes_a_shorter_last_chunk():
    """L = 20 over chunks of 16 (which the reference refuses): the same y
    and end state as the reference's 16 steps, then its 4 from that
    state."""
    x, dt, Bm, Cm, A, h0 = _ssd_inputs(20, seed=7)
    y, h = PS.ssd_chunked(*(torch.from_numpy(a)
                            for a in (x, dt, Bm, Cm, A, h0)), 16)
    first = (a[:, :16] for a in (x, dt, Bm, Cm))
    y1, h1 = _ssd(*(jnp.asarray(a) for a in first), jnp.asarray(A),
                  jnp.asarray(h0), 16)
    rest = (a[:, 16:] for a in (x, dt, Bm, Cm))
    y2, h2 = _ssd(*(jnp.asarray(a) for a in rest), jnp.asarray(A), h1, 4)
    _close(y, np.concatenate([np.asarray(y1), np.asarray(y2)], 1), 1e-5,
           "y")
    _close(h, h2, 1e-5, "h")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_past_a_chunk_off_its_multiple(arch):
    """At L = 20 (no multiple of ``ssm_chunk`` 16; the reference's
    ``_ssd_chunked`` asserts there) the port serves: its prefill and
    decode equal its forward."""
    cfg = _cfg(arch)
    params = P.init_params(cfg, seed=5, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 24)))
    whole = P.forward(params, {"tokens": tokens}, cfg, device="cpu")[0]
    logits, state = P.prefill(params, {"tokens": tokens[:, :20]}, cfg,
                              max_len=24, device="cpu")
    _close(logits, whole[:, 19].numpy(), 1e-5, "prefill of 20")
    for i in range(20, 24):
        logits, state = P.decode_step(params, state, tokens[:, i], cfg,
                                      device="cpu")
        _close(logits, whole[:, i].numpy(), 1e-5, f"position {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_refuses_a_prompt_shorter_than_the_conv_state(arch):
    """Below ``ssm_conv - 1`` tokens the reference's prefill returns a
    conv state of 1 row where its own decode wants 3; the port raises.
    At W - 1 tokens it serves, its prefill and decode equal to its
    forward."""
    cfg = _cfg(arch)
    params = P.init_params(cfg, seed=6, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 8)))
    with pytest.raises(ValueError, match="shorter"):
        P.prefill(params, {"tokens": tokens[:, :2]}, cfg, device="cpu")
    whole = P.forward(params, {"tokens": tokens}, cfg, device="cpu")[0]
    W = cfg.ssm_conv
    logits, state = P.prefill(params, {"tokens": tokens[:, :W - 1]}, cfg,
                              max_len=8, device="cpu")
    _close(logits, whole[:, W - 2].numpy(), 1e-5, f"prefill of {W - 1}")
    logits, state = P.decode_step(params, state, tokens[:, W - 1], cfg,
                                  device="cpu")
    _close(logits, whole[:, W - 1].numpy(), 1e-5, f"step after {W - 1}")


def test_layers_off_a_multiple_of_attn_every_are_refused():
    """zamba2 with 5 layers over ``attn_every`` 2: the reference's reshape
    into super-blocks fails; every entry point of the port raises."""
    cfg = dataclasses.replace(_cfg("zamba2_2p7b"), num_layers=5)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: R.forward(
            R.init_params(cfg, jax.random.PRNGKey(0)),
            {"tokens": np.zeros((1, 4), np.int32)}, cfg))
    ok = P.init_params(_cfg("zamba2_2p7b"), device="cpu")
    calls = [lambda: P.init_params(cfg, device="cpu"),
             lambda: P.forward(ok, {"tokens": np.zeros((1, 4), np.int32)},
                               cfg, device="cpu"),
             lambda: P.prefill(ok, {"tokens": np.zeros((1, 4), np.int32)},
                               cfg, device="cpu"),
             lambda: P.init_decode_state(cfg, 1, 4, device="cpu"),
             lambda: params_from_numpy(cfg, {}, device="cpu")]
    for call in calls:
        with pytest.raises(ValueError, match="attn_every"):
            call()


def test_attention_and_scan_wrappers_per_super_block(monkeypatch):
    """Once a super-block a pass through the flash wrapper, once a
    super-block a step through the decode wrapper (on the card each call
    is one launch), the scan wrapper never; a step writes each layer's h
    and the caches in place."""
    calls = {"flash": 0, "decode": 0, "scan": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(flash_kernel, "flash_attention",
                        counted("flash", flash_kernel.flash_attention))
    monkeypatch.setattr(decode_kernel, "decode_attention",
                        counted("decode", decode_kernel.decode_attention))
    monkeypatch.setattr(scan_kernel, "mamba_scan",
                        counted("scan", scan_kernel.mamba_scan))
    cfg = _cfg("zamba2_2p7b")
    n_super = cfg.num_layers // cfg.attn_every
    params = P.init_params(cfg, seed=7, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, 8)))
    P.forward(params, {"tokens": tokens}, cfg, device="cpu")
    logits, state = P.prefill(params, {"tokens": tokens}, cfg, max_len=11,
                              device="cpu")
    assert calls == {"flash": 2 * n_super, "decode": 0, "scan": 0}
    h, k = state["ssm"]["h"], state["kv"]["k"]
    for _ in range(3):
        logits, state = P.decode_step(params, state, logits.argmax(-1), cfg,
                                      device="cpu")
    assert calls == {"flash": 2 * n_super, "decode": 3 * n_super, "scan": 0}
    assert state["pos"] == 11
    assert state["ssm"]["h"] is h and state["kv"]["k"] is k
    assert k[:, :, :, 10].any()
    with pytest.raises(ValueError, match="full"):
        P.decode_step(params, state, logits.argmax(-1), cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_the_reference_layout(arch):
    """The layers' and the shared block's leaves, shapes (the shared
    block's query heads unpadded) and dtypes, and Mamba2's constant
    leaves' values."""
    cfg = _cfg(arch, "bfloat16")
    a = P.init_params(cfg, seed=3, device="cpu")
    ref = jax.eval_shape(lambda: R.init_params(cfg, jax.random.PRNGKey(0)))
    assert a.keys() == ref.keys()
    assert len(a["layers"]) == cfg.num_layers
    for group, sub in a["layers"][0].items():
        assert sub.keys() == ref["layers"][group].keys()
        for n, t in sub.items():
            assert tuple(t.shape) == ref["layers"][group][n].shape[1:]
            assert t.dtype == (
                torch.float32 if group == "ln1" or n in PS.PARAM_DTYPE_LEAVES
                else torch.bfloat16), (group, n)
    if cfg.family == "hybrid":
        width = cfg.num_heads * cfg.head_dim
        shared = a["shared_attn"]
        assert shared.keys() == ref["shared_attn"].keys()
        for group, sub in shared.items():
            for n, t in sub.items():
                shape = list(ref["shared_attn"][group][n].shape)
                if group == "attn" and n == "wq":
                    shape[-1] = width
                if group == "attn" and n == "wo":
                    shape[0] = width
                assert list(t.shape) == shape, (group, n)
                assert t.dtype == (torch.float32 if group.startswith("ln")
                                   else torch.bfloat16), (group, n)
    m = a["layers"][0]["mamba"]
    want = _np(RS.init_mamba2(jax.random.PRNGKey(0), cfg)[0])
    for n in ("conv_b", "A_log", "dt_bias", "D", "norm_scale"):
        np.testing.assert_allclose(m[n].numpy(), want[n], rtol=1e-6)
    assert not torch.equal(m["in_proj"], a["layers"][1]["mamba"]["in_proj"])


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs")
    cfg = _cfg("zamba2_2p7b", "bfloat16")
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
