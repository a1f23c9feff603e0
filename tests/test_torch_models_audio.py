"""The audio zoo's serving path (``repro_torch.models`` at whisper's smoke
config: 2 encoder and 2 decoder layers, d_model 64, 4 heads over 4 kv
heads of 16, which the reference pads to 16; LayerNorm, qkv and MLP
biases; ``encoder_seq`` 32) against the JAX reference (``repro.models``)
on the CPU, in float32 and in bfloat16.

The reference initialises every bias to zero; here each is drawn
nonzero from a seed before the tree crosses through
``params_from_numpy`` (``torch_zoo_cases.nonzero_biases``): the
LayerNorms', the self attention's and the MLP's, which the reference
adds, and the cross attention's ``bq``, ``bk`` and ``bv``, which it
holds and never adds (nor RoPE there), so a port that dropped the first
or added the second would part.  The conv frontend is the reference's
stub: frames (B, T, D) drawn from a seed, at T = ``encoder_seq`` = 32
and at T = 24, where the reference's prefill makes the cross caches at
T (not at ``encoder_seq``) and the port must too.

Each T holds ``encode_audio`` alone, ``forward`` logits over B 2 x S 16
tokens, ``prefill`` of 12 into 16 slots (logits, the self caches, the
cross caches ``enc_kv`` and their ``len``) and a chain of 4
``decode_step``s fed the reference's own prefill state (logits and the
last state); the port's decode is held to its own forward.

Tolerances, ``|port - ref| <= TOL * (1 + |ref|)`` elementwise: float32
2e-4, as in ``tests/test_torch_models.py``, the port within 1.2e-6 over
six seeds; bfloat16 2**-4, the dense family's bound, the port within
0.025 over six seeds at both lengths (``scripts/torch_models_gap.py
--dtype bfloat16 --only whisper_tiny``).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_smoke_config
from repro.models import model as RMODEL
from repro_torch import models as P
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, params_from_numpy)
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from torch_zoo_cases import close, nonzero_biases

ARCH = "whisper_tiny"
DTYPES = ("float32", "bfloat16")
FRAMES = (32, 24)               # encoder_seq, and a shorter clip
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}
B, S, STEPS = 2, 16, 4          # prompt of S - STEPS, then STEPS steps
PROMPT = S - STEPS

_init = jax.jit(R.init_params, static_argnums=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


@functools.cache
def _ref_params():
    """The reference's tree with every bias nonzero (its init reads
    ``cfg.param_dtype`` and not ``cfg.dtype``)."""
    return nonzero_biases(_np(_init(_cfg(), jax.random.PRNGKey(0))), 0)


def _tokens():
    return np.random.default_rng(1).integers(
        0, _cfg().vocab_size, (B, S)).astype(np.int32)


def _frames(T):
    return np.random.default_rng(T).standard_normal(
        (B, T, _cfg().d_model)).astype(np.float32)


@functools.cache
def _case(T, dtype):
    """The reference's outputs: the encoder's, forward logits, prefill
    logits and state, a decode chain's logits and last state."""
    cfg = _cfg(dtype)
    params = _ref_params()
    encode = jax.jit(lambda p, f: RMODEL.encode_audio(p, f, cfg))
    forward = jax.jit(lambda p, b: R.forward(p, b, cfg)[0])
    prefill = jax.jit(lambda p, b: R.prefill(p, b, cfg, S))
    decode = jax.jit(lambda p, st, t: R.decode_step(p, st, t, cfg))
    tokens, frames = _tokens(), _frames(T)
    enc = np.asarray(encode(params, frames), np.float32)
    logits = np.asarray(forward(params, {"tokens": tokens, "frames": frames}),
                        np.float32)
    pre_logits, state = prefill(params, {"tokens": tokens[:, :PROMPT],
                                         "frames": frames})
    pre = dict(logits=np.asarray(pre_logits, np.float32), state=_np(state))
    steps = []
    for i in range(PROMPT, S):
        lg, state = decode(params, state, tokens[:, i])
        steps.append(np.asarray(lg, np.float32))
    return dict(cfg=cfg, encoded=enc, forward=logits, prefill=pre,
                steps=steps, state=_np(state))


def _port(dtype):
    return params_from_numpy(_cfg(dtype), _ref_params(), device="cpu")


def _close_state(got, want, tol, what):
    """Self and cross caches within ``tol``, ``pos`` and ``len`` exact."""
    got = decode_state_to_numpy(got)
    assert got.keys() == want.keys() == {"pos", "kv", "enc_kv"}
    assert int(got["pos"]) == int(want["pos"])
    np.testing.assert_array_equal(got["enc_kv"]["len"],
                                  want["enc_kv"]["len"])
    for group in ("kv", "enc_kv"):
        for n in ("k", "v"):
            assert got[group][n].shape == want[group][n].shape
            close(got[group][n], want[group][n], tol, f"{what} {group} {n}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", FRAMES)
def test_encode_audio_matches_reference(T, dtype):
    case = _case(T, dtype)
    cfg = case["cfg"]
    enc = P.encode_audio(_port(dtype), _frames(T), cfg, device="cpu")
    assert enc.shape == (B, T, cfg.d_model)
    assert enc.dtype == getattr(torch, dtype)
    close(enc, case["encoded"], TOL[dtype], "encoder output")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", FRAMES)
def test_forward_matches_reference(T, dtype):
    case = _case(T, dtype)
    cfg = case["cfg"]
    logits, aux = P.forward(_port(dtype), {"tokens": _tokens(),
                                           "frames": _frames(T)}, cfg,
                            device="cpu")
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == getattr(torch, dtype)
    assert float(aux["moe_aux"]) == float(aux["moe_z"]) == 0.0
    close(logits, case["forward"], TOL[dtype], "forward logits")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", FRAMES)
def test_prefill_matches_reference(T, dtype):
    """The logits, the self caches in their first 12 of 16 slots, and
    the cross caches at the frames' T with ``len`` = T."""
    case = _case(T, dtype)
    cfg = case["cfg"]
    want = case["prefill"]
    logits, state = P.prefill(_port(dtype), {"tokens": _tokens()[:, :PROMPT],
                                             "frames": _frames(T)}, cfg,
                              max_len=S, device="cpu")
    assert state["pos"] == PROMPT
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert state["kv"]["k"].shape == (L, B, KV, S, hd)
    assert state["enc_kv"]["k"].shape == (L, B, KV, T, hd)
    assert state["enc_kv"]["len"].dtype == torch.int32
    assert state["enc_kv"]["len"].tolist() == [T] * B
    for group in ("kv", "enc_kv"):
        for n in ("k", "v"):
            assert state[group][n].dtype == getattr(torch, dtype)
            assert state[group][n].is_contiguous()
    close(logits, want["logits"], TOL[dtype], "prefill logits")
    _close_state(state, want["state"], TOL[dtype], "prefill")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", FRAMES)
def test_decode_chain_matches_reference(T, dtype):
    """Both sides decode from the reference's prefill state: a layer's
    self attention over its cache, then its cross attention over the
    cross cache's ``len`` frames; the cross caches stay as they were."""
    case = _case(T, dtype)
    cfg = case["cfg"]
    params = _port(dtype)
    state = decode_state_from_numpy(cfg, case["prefill"]["state"],
                                    device="cpu")
    cross = {n: t.clone() for n, t in state["enc_kv"].items()}
    for i, want in zip(range(PROMPT, S), case["steps"]):
        logits, state = P.decode_step(params, state, _tokens()[:, i], cfg,
                                      device="cpu")
        assert logits.shape == (B, cfg.vocab_size)
        close(logits, want, TOL[dtype], f"decode step {i}")
    assert state["pos"] == S
    _close_state(state, case["state"], TOL[dtype], "after the steps")
    for n, t in cross.items():
        assert torch.equal(state["enc_kv"][n], t), n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", FRAMES)
def test_decode_matches_forward(T, dtype):
    """The port's prefill and decode steps give the port's forward
    logits at the same positions (tests/test_models.py:58)."""
    cfg = _cfg(dtype)
    params = _port(dtype)
    tokens, frames = torch.from_numpy(_tokens()), _frames(T)
    whole = P.forward(params, {"tokens": tokens, "frames": frames}, cfg,
                      device="cpu")[0]
    logits, state = P.prefill(params, {"tokens": tokens[:, :PROMPT],
                                       "frames": frames}, cfg, max_len=S,
                              device="cpu")
    close(logits, whole[:, PROMPT - 1].float().numpy(), TOL[dtype],
          "prefill")
    for i in range(PROMPT, S):
        logits, state = P.decode_step(params, state, tokens[:, i], cfg,
                                      device="cpu")
        close(logits, whole[:, i].float().numpy(), TOL[dtype],
              f"position {i}")


def test_cross_attention_reads_no_bias():
    """The port's logits do not move when the cross attention's ``bq``,
    ``bk`` and ``bv`` do (the reference never adds them), and do when
    ``wk`` does; the self attention's ``bk`` moves them."""
    cfg = _cfg()
    batch = {"tokens": _tokens(), "frames": _frames(24)}
    params = _port("float32")
    base = P.forward(params, batch, cfg, device="cpu")[0]
    for group, name, moves in (("xattn", "bq", False), ("xattn", "bk", False),
                               ("xattn", "bv", False), ("xattn", "wk", True),
                               ("attn", "bk", True)):
        lp = params["layers"][1]
        saved = lp[group][name]
        lp[group] = dict(lp[group], **{name: saved + 1.0})
        got = P.forward(params, batch, cfg, device="cpu")[0]
        lp[group] = dict(lp[group], **{name: saved})
        assert torch.equal(got, base) != moves, (group, name)


def test_audio_launches(monkeypatch):
    """A forward or prefill runs the flash wrapper once an encoder layer
    (not causal) and twice a decoder layer (causal self attention, then
    non-causal cross attention over the T frames); a step runs the decode
    wrapper twice a decoder layer (its cache, then the cross cache over
    ``len`` frames)."""
    calls = {"flash": [], "decode": []}
    flash = flash_kernel.flash_attention
    decode = decode_kernel.decode_attention

    def counted_flash(q, k, v, *, causal):
        calls["flash"].append((causal, k.shape[2]))
        return flash(q, k, v, causal=causal)

    def counted_decode(q, k_cache, v_cache, length):
        calls["decode"].append((k_cache.shape[2], length.tolist()))
        return decode(q, k_cache, v_cache, length)

    monkeypatch.setattr(flash_kernel, "flash_attention", counted_flash)
    monkeypatch.setattr(decode_kernel, "decode_attention", counted_decode)
    cfg = get_smoke_config(ARCH)
    L, E = cfg.num_layers, cfg.encoder_layers
    params = P.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": _tokens()[:, :8], "frames": _frames(24)}
    P.forward(params, batch, cfg, device="cpu")
    logits, state = P.prefill(params, batch, cfg, max_len=11, device="cpu")
    one_pass = [(False, 24)] * E + [(True, 8), (False, 24)] * L
    assert calls == {"flash": one_pass * 2, "decode": []}
    for _ in range(3):
        logits, state = P.decode_step(params, state, logits.argmax(-1), cfg,
                                      device="cpu")
    assert calls["decode"] == [
        step for n in (9, 10, 11)
        for step in [(11, [n] * B), (24, [24] * B)] * L]
    assert state["pos"] == 11 and state.keys() == {"pos", "kv", "enc_kv"}


def test_init_params_follows_the_reference_layout():
    """The port's own init: the reference's tree (decoder layers with
    ``lnx`` and ``xattn``, ``enc_layers``, ``enc_norm``) with 4 query
    heads (not its 16), LayerNorms in ``cfg.param_dtype``, the biases
    zero in ``cfg.dtype``; a fresh decode state holds zeroed cross caches
    at ``encoder_seq``."""
    cfg = get_smoke_config(ARCH)
    a = P.init_params(cfg, seed=3, device="cpu")
    ref = jax.eval_shape(lambda: R.init_params(cfg, jax.random.PRNGKey(0)))
    width = cfg.num_heads * cfg.head_dim
    assert a.keys() == ref.keys() == {"embed", "final_norm", "layers",
                                      "enc_layers", "enc_norm"}
    assert len(a["layers"]) == cfg.num_layers
    assert len(a["enc_layers"]) == cfg.encoder_layers
    assert a["layers"][0].keys() == ref["layers"].keys() == {
        "ln1", "attn", "ln2", "lnx", "xattn", "mlp"}
    assert a["enc_layers"][0].keys() == ref["enc_layers"].keys() == {
        "ln1", "attn", "ln2", "mlp"}
    for stack in ("layers", "enc_layers"):
        for group, sub in a[stack][0].items():
            assert sub.keys() == ref[stack][group].keys(), group
            for n, t in sub.items():
                shape = list(ref[stack][group][n].shape[1:])
                if n in ("wq", "bq"):
                    shape[-1] = width
                if n == "wo" and group in ("attn", "xattn"):
                    shape[0] = width
                assert list(t.shape) == shape, (stack, group, n)
                assert t.dtype == (torch.float32 if group.startswith("ln")
                                   else torch.bfloat16), (group, n)
                if n.startswith("b") or n == "bias":
                    assert not t.any(), (group, n)
    assert a["enc_norm"]["bias"].dtype == torch.float32
    state = P.init_decode_state(cfg, 3, 20, device="cpu")
    assert state["enc_kv"]["k"].shape == (cfg.num_layers, 3,
                                          cfg.num_kv_heads, cfg.encoder_seq,
                                          cfg.head_dim)
    assert not state["enc_kv"]["k"].any()
    assert state["enc_kv"]["len"].dtype == torch.int32
    assert state["enc_kv"]["len"].tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="no encoder"):
        P.encode_audio(a, _frames(24), get_smoke_config("yi_6b"),
                       device="cpu")
