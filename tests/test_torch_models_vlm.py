"""The VLM zoo's serving path (``repro_torch.models`` at qwen2-vl's smoke
config: 3 layers, d_model 64, 4 query heads over 2 kv heads of 16, which
the reference pads to 16; qkv and MLP biases; M-RoPE with sections
(4, 2, 2) of the 8 rotary frequencies) against the JAX reference
(``repro.models``) on the CPU, in float32 and in bfloat16.

The reference initialises every bias to zero; here each is drawn
nonzero from a seed before the tree crosses through
``params_from_numpy`` (``torch_zoo_cases.nonzero_biases``), so a dropped
bias shows.  Three worlds, B 2 x S 16:

- ``tokens``: the tokens alone (positions three copies of ``arange``);
- ``embeds``: the vision stub's patch embeddings (B, S, D) with explicit
  (3, B, S) positions that differ across the streams: an image block of
  t 1 x h 2 x w 4 patches at (0, h, w), then text at the image's largest
  position + 1 on all three streams, as Qwen2-VL lays them out;
- ``both``: embeddings and tokens together, no positions: the embeddings
  win, as in the reference.

Each holds ``forward`` logits, ``prefill`` of 12 into 16 slots (logits
and caches) and a chain of 4 ``decode_step``s fed the reference's own
prefill state (logits and the last caches; a step's token sits at
``pos`` on all three streams, as in the reference); the port's decode is
held to its own forward on the tokens world.

Tolerances, ``|port - ref| <= TOL * (1 + |ref|)`` elementwise: float32
2e-4, as in ``tests/test_torch_models.py``, the port within 1.5e-6 over
six seeds; bfloat16 2**-4, the dense family's bound, the port within
0.030 over six seeds and both of the first two worlds
(``scripts/torch_models_gap.py --dtype bfloat16 --only qwen2_vl_72b``).
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
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from torch_zoo_cases import close, nonzero_biases

ARCH = "qwen2_vl_72b"
DTYPES = ("float32", "bfloat16")
WORLDS = ("tokens", "embeds", "both")
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}
B, S, STEPS = 2, 16, 4          # prompt of S - STEPS, then STEPS steps
PROMPT = S - STEPS
IMAGE = (1, 2, 4)               # the image's (t, h, w) grid of patches

_init = jax.jit(R.init_params, static_argnums=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def image_then_text(n_img: int, n: int) -> np.ndarray:
    """(3, B, n) M-RoPE positions: ``n_img`` patches of the ``IMAGE``
    grid at (t, h, w), then text at the image's largest position + 1,
    the same on all three streams."""
    t, h, w = IMAGE
    assert n_img == t * h * w
    grid = np.stack(np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                                indexing="ij")).reshape(3, -1)
    text = grid.max() + 1 + np.arange(n - n_img)
    pos = np.concatenate([grid, np.broadcast_to(text, (3, n - n_img))], 1)
    return np.broadcast_to(pos[:, None], (3, B, n)).astype(np.int32)


@functools.cache
def _ref_params():
    """The reference's tree with every bias nonzero (its init reads
    ``cfg.param_dtype`` and not ``cfg.dtype``)."""
    return nonzero_biases(_np(_init(_cfg(), jax.random.PRNGKey(0))), 0)


def _batch(world, n):
    """The world's batch over its first ``n`` positions."""
    cfg = _cfg()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    embeds = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if world == "tokens":
        return {"tokens": tokens[:, :n]}
    if world == "embeds":
        return {"embeds": embeds[:, :n],
                "positions": image_then_text(8, S)[:, :, :n]}
    return {"tokens": tokens[:, :n], "embeds": embeds[:, :n]}


def _tokens():
    return np.random.default_rng(1).integers(
        0, _cfg().vocab_size, (B, S)).astype(np.int32)


@functools.cache
def _case(world, dtype):
    """The reference's outputs: forward logits, prefill logits and state,
    a decode chain's logits and last state."""
    cfg = _cfg(dtype)
    params = _ref_params()
    forward = jax.jit(lambda p, b: R.forward(p, b, cfg)[0])
    prefill = jax.jit(lambda p, b: R.prefill(p, b, cfg, S))
    decode = jax.jit(lambda p, st, t: R.decode_step(p, st, t, cfg))
    logits = np.asarray(forward(params, _batch(world, S)), np.float32)
    pre_logits, state = prefill(params, _batch(world, PROMPT))
    pre = dict(logits=np.asarray(pre_logits, np.float32), state=_np(state))
    steps = []
    for i in range(PROMPT, S):
        lg, state = decode(params, state, _tokens()[:, i])
        steps.append(np.asarray(lg, np.float32))
    return dict(cfg=cfg, forward=logits, prefill=pre, steps=steps,
                state=_np(state))


def _port(dtype):
    return params_from_numpy(_cfg(dtype), _ref_params(), device="cpu")


def _caches(state):
    return decode_state_to_numpy(state)["kv"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_forward_matches_reference(world, dtype):
    case = _case(world, dtype)
    cfg = case["cfg"]
    logits, aux = P.forward(_port(dtype), _batch(world, S), cfg,
                            device="cpu")
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == getattr(torch, dtype)
    assert float(aux["moe_aux"]) == float(aux["moe_z"]) == 0.0
    close(logits, case["forward"], TOL[dtype], "forward logits")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_prefill_matches_reference(world, dtype):
    case = _case(world, dtype)
    cfg = case["cfg"]
    want = case["prefill"]
    logits, state = P.prefill(_port(dtype), _batch(world, PROMPT), cfg,
                              max_len=S, device="cpu")
    assert state.keys() == {"pos", "kv"} and state["pos"] == PROMPT
    assert state["kv"]["k"].shape == (cfg.num_layers, B, cfg.num_kv_heads,
                                      S, cfg.head_dim)
    assert state["kv"]["k"].dtype == getattr(torch, dtype)
    close(logits, want["logits"], TOL[dtype], "prefill logits")
    got = _caches(state)
    for n in ("k", "v"):
        close(got[n], want["state"]["kv"][n], TOL[dtype],
              f"prefill cache {n}")
        assert not got[n][:, :, PROMPT:].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_decode_chain_matches_reference(world, dtype):
    """Both sides decode tokens from the reference's prefill state."""
    case = _case(world, dtype)
    cfg = case["cfg"]
    params = _port(dtype)
    state = decode_state_from_numpy(cfg, case["prefill"]["state"],
                                    device="cpu")
    for i, want in zip(range(PROMPT, S), case["steps"]):
        logits, state = P.decode_step(params, state, _tokens()[:, i], cfg,
                                      device="cpu")
        assert logits.shape == (B, cfg.vocab_size)
        close(logits, want, TOL[dtype], f"decode step {i}")
    assert state["pos"] == int(case["state"]["pos"]) == S
    got = _caches(state)
    for n in ("k", "v"):
        close(got[n], case["state"]["kv"][n], TOL[dtype], f"cache {n}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_forward(dtype):
    """The port's prefill and decode steps give the port's forward
    logits at the same positions (tests/test_models.py:58): the tokens
    world, where a step's three streams at ``pos`` are the forward's."""
    cfg = _cfg(dtype)
    params = _port(dtype)
    tokens = torch.from_numpy(_tokens())
    whole = P.forward(params, {"tokens": tokens}, cfg, device="cpu")[0]
    logits, state = P.prefill(params, {"tokens": tokens[:, :PROMPT]}, cfg,
                              max_len=S, device="cpu")
    close(logits, whole[:, PROMPT - 1].float().numpy(), TOL[dtype],
          "prefill")
    for i in range(PROMPT, S):
        logits, state = P.decode_step(params, state, tokens[:, i], cfg,
                                      device="cpu")
        close(logits, whole[:, i].float().numpy(), TOL[dtype],
              f"position {i}")


def test_the_inputs_are_the_references():
    """The embeddings win over the tokens (bit for bit), a prompt of
    embeddings alone takes B and S from them, default positions are
    three copies of ``arange``, and malformed inputs raise."""
    cfg = _cfg()
    params = _port("float32")
    both = _batch("both", S)
    alone = {"embeds": both["embeds"]}
    got = P.forward(params, both, cfg, device="cpu")[0]
    assert torch.equal(got, P.forward(params, alone, cfg, device="cpu")[0])
    arange = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    assert torch.equal(got, P.forward(params, dict(alone, positions=arange),
                                      cfg, device="cpu")[0])
    image = P.forward(params, dict(alone, positions=image_then_text(8, S)),
                      cfg, device="cpu")[0]
    assert not torch.allclose(image, got, rtol=1e-3, atol=1e-3)
    _, state = P.prefill(params, {"embeds": both["embeds"][:1, :5]}, cfg,
                         max_len=7, device="cpu")
    assert state["kv"]["k"].shape[1::2] == (1, 7) and state["pos"] == 5
    bad = (({"embeds": both["embeds"], "positions": arange[:2]}, ValueError),
           ({"embeds": both["embeds"],
             "positions": arange.astype(np.float32)}, TypeError),
           ({"embeds": both["embeds"][..., :8]}, ValueError),
           ({"embeds": both["tokens"]}, ValueError))
    for batch, error in bad:
        with pytest.raises(error):
            P.forward(params, batch, cfg, device="cpu")


def test_the_biases_move_the_logits():
    """Each kind of nonzero bias moves the reference's logits far past
    the tolerance, so the differentials above would see one dropped."""
    cfg = _cfg()
    forward = jax.jit(lambda p: R.forward(p, _batch("embeds", S), cfg)[0])
    zero = _np(_init(cfg, jax.random.PRNGKey(0)))
    base = np.asarray(forward(zero))
    for name in ("bq", "bk", "bv", "bi", "bo"):
        group = "mlp" if name in ("bi", "bo") else "attn"
        assert not zero["layers"][group][name].any()
        sub = dict(zero["layers"][group],
                   **{name: _ref_params()["layers"][group][name]})
        tree = dict(zero, layers=dict(zero["layers"], **{group: sub}))
        moved = np.abs(np.asarray(forward(tree)) - base).max()
        assert moved > 50 * TOL["float32"], name


def test_vlm_launches_what_dense_layers_do(monkeypatch):
    """Once a layer a pass through the flash wrapper, once a layer a step
    through the decode wrapper, with embeddings and M-RoPE positions."""
    calls = {"flash": 0, "decode": 0}
    flash = flash_kernel.flash_attention
    decode = decode_kernel.decode_attention

    def counted_flash(*a, **k):
        calls["flash"] += 1
        assert k["causal"]
        return flash(*a, **k)

    def counted_decode(*a):
        calls["decode"] += 1
        return decode(*a)

    monkeypatch.setattr(flash_kernel, "flash_attention", counted_flash)
    monkeypatch.setattr(decode_kernel, "decode_attention", counted_decode)
    cfg = get_smoke_config(ARCH)
    params = P.init_params(cfg, seed=0, device="cpu")
    batch = _batch("embeds", S)
    P.forward(params, batch, cfg, device="cpu")
    logits, state = P.prefill(params, batch, cfg, max_len=S + 3,
                              device="cpu")
    assert calls == {"flash": 2 * cfg.num_layers, "decode": 0}
    for _ in range(3):
        logits, state = P.decode_step(params, state, logits.argmax(-1), cfg,
                                      device="cpu")
    assert calls == {"flash": 2 * cfg.num_layers,
                     "decode": 3 * cfg.num_layers}
    assert state["pos"] == S + 3 and state.keys() == {"pos", "kv"}


def test_init_params_follows_the_reference_layout():
    """The port's own init: the reference's tree with 4 query heads
    (not its 16), the biases zero in ``cfg.dtype`` as the reference's
    init makes them."""
    cfg = get_smoke_config(ARCH)
    a = P.init_params(cfg, seed=3, device="cpu")
    ref = jax.eval_shape(lambda: R.init_params(cfg, jax.random.PRNGKey(0)))
    width = cfg.num_heads * cfg.head_dim
    lp = a["layers"][0]
    assert len(a["layers"]) == cfg.num_layers
    assert lp.keys() == ref["layers"].keys() == {"ln1", "attn", "ln2", "mlp"}
    for group, sub in lp.items():
        assert sub.keys() == ref["layers"][group].keys(), group
        for n, t in sub.items():
            shape = list(ref["layers"][group][n].shape[1:])
            if n in ("wq", "bq"):
                shape[-1] = width
            if n == "wo" and group == "attn":
                shape[0] = width
            assert list(t.shape) == shape, (group, n)
            assert t.dtype == (torch.float32 if group.startswith("ln")
                               else torch.bfloat16), (group, n)
            if n.startswith("b"):
                assert not t.any(), (group, n)
