"""The MoE zoo's serving path (``repro_torch.models`` with
``repro_torch.models.moe`` at phi3.5-moe's smoke config, 4 experts top-2,
and qwen3-moe's, 8 experts top-2; 2 layers, d_model 64) against the JAX
reference (``repro.models``, ``repro.models.moe``) on the CPU, in float32
and in bfloat16.

The pieces, fed the same numpy-seeded inputs: ``_route`` (the top-k ids
exactly, the zero-row full tie included; the weights, aux and z loss);
``_dispatch_indices`` (``dest`` and ``valid`` exactly, on the routed ids
at T = 32, where qwen3's capacity of 10 drops entries, and on skewed ids
that drop at either config); ``moe_block`` over one chunk of 32 tokens
and over B 2 x S 4,100 = 8,200 tokens, two chunks of 8,192, the second
padded with 8,184 zero rows, which are routed and fill slots.  The model:
``forward`` (logits, ``moe_aux`` and ``moe_z``), ``prefill`` (logits and
caches) and a chain of ``decode_step``s fed the reference's own prefill
state; the reference's parameters cross through ``params_from_numpy``.
The port's decode is held to its own forward at ``capacity_factor = E /
k`` only: there ``C`` is the whole chunk and nothing drops, where at the
config's 1.25 a forward's 32 tokens compete for slots that a step's 2
never fill, so the reference's own decode parts from its forward.

Tolerances, ``|port - ref| <= TOL * (1 + |ref|)`` elementwise:

- float32, 2e-4, as in ``tests/test_torch_models.py``: the port is within
  2.6e-6 over six seeds, and no (token, layer) expert set differs
  (``scripts/torch_models_gap.py --dtype float32 --only phi3p5_moe_42b
  qwen3_moe_30b``); the tests assert that none differs here either.
- bfloat16, 2**-4, the dense family's bound, on every position that no
  routing parting reaches.  The router reads ``ln2``'s bfloat16 output,
  which parts between the packages by an ulp here and there (the dense
  family's roundings), and where two experts are near-tied an ulp swaps
  them: the token then runs another expert, by O(1), and may take the
  slot that drops another token.  Over six seeds the gap script found
  2 and 3 of 384 (token, layer) sets swapped (phi3.5-moe seeds 1 and 3,
  qwen3-moe seeds 0 and 1), the router's probabilities at most 0.0050
  apart, and the logits at most 1.05 apart where a parting reaches and
  0.037 where none does (``--dtype bfloat16 --only phi3p5_moe_42b
  qwen3_moe_30b``).  This file's inputs are the gap script's seed 0, so
  qwen3-moe's swap in bfloat16: 2 sets in the forward (4 parted, 16 of
  its 32 positions reached), 1 in the prefill (4 of 24) and 1 in the
  decode chain.  The test records each moe layer's input on both sides,
  routes each with its own package, and holds (a) that the router's
  probabilities agree within ``ROUTER_TOL`` everywhere, (b) that every
  swapped set is a near tie the reference itself ranks within 2 x
  ``ROUTER_TOL`` (so the port ranked its own probabilities right), (c)
  that every other parted set (an entry dropped on one side only) lies
  in a layer call with a swap, and (d) the outputs at 2**-4 on the
  positions no parting reaches, at least a quarter of them: a parting at
  a token reaches the rest of its row (attention carries it on).
- The pieces: 1e-6 on the router's weights, 1e-5 on aux, z and float32
  outputs; in bfloat16 ``moe_block`` at 2**-4, its ids exact (the same
  input routes the same in float32).
"""
import contextlib
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_smoke_config
from repro.models import model as RMODEL
from repro.models import moe as RM
from repro_torch import models as P
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, params_from_numpy)
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import moe as PM

ARCHS = ("phi3p5_moe_42b", "qwen3_moe_30b")
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}
PIECE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -4}
#: the router's probabilities, each side from its own layer input: at
#: most 3.6e-7 and 0.0050 apart over six seeds (the gap script's
#: ``router``)
ROUTER_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
B, S, STEPS = 2, 16, 4          # prompt of S - STEPS, then STEPS steps
PROMPT = S - STEPS

_init = jax.jit(R.init_params, static_argnums=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what, where=None):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if where is not None:
        got, want = got[where], want[where]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _cfg(arch, dtype="float32", **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)


@contextlib.contextmanager
def _layer_inputs():
    """Record each moe layer's input on either side, in call order: the
    reference's through an ordered callback out of its jitted scan (which
    changes no value)."""
    seen = {"ref": [], "port": []}
    ref_base, port_base = RMODEL.moe_block, PM.moe_block

    def ref_spy(p, x, cfg):
        jax.debug.callback(
            lambda v: seen["ref"].append(np.asarray(v, np.float32)), x,
            ordered=True)
        return ref_base(p, x, cfg)

    def port_spy(p, x, cfg):
        seen["port"].append(x.float().numpy())
        return port_base(p, x, cfg)

    RMODEL.moe_block, PM.moe_block = ref_spy, port_spy
    try:
        yield seen
    finally:
        RMODEL.moe_block, PM.moe_block = ref_base, port_base


@functools.cache
def _ref_params(arch):
    """The reference's parameters, made once an arch: its init reads
    ``cfg.param_dtype`` and not ``cfg.dtype``."""
    return _init(_cfg(arch), jax.random.PRNGKey(0))


@functools.cache
def _case(arch, dtype):
    """The reference's outputs and each moe layer's input: forward
    logits and losses, prefill logits and state, a decode chain's logits
    and last state.  Each entry point is jitted afresh here, with the
    spy in place when it is traced."""
    cfg = _cfg(arch, dtype)
    params = _ref_params(arch)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    forward = jax.jit(lambda p, t: R.forward(p, {"tokens": t}, cfg))
    prefill = jax.jit(lambda p, t: R.prefill(p, {"tokens": t}, cfg, S))
    decode = jax.jit(lambda p, st, t: R.decode_step(p, st, t, cfg))
    with _layer_inputs() as seen:
        logits, aux = forward(params, tokens)
        jax.effects_barrier()
    fwd = dict(logits=np.asarray(logits, np.float32),
               aux={n: float(v) for n, v in aux.items()},
               inputs=seen["ref"])
    with _layer_inputs() as seen:
        logits, state = prefill(params, tokens[:, :PROMPT])
        jax.effects_barrier()
    pre = dict(logits=np.asarray(logits, np.float32), state=_np(state),
               inputs=seen["ref"])
    steps = []
    with _layer_inputs() as seen:
        for i in range(PROMPT, S):
            logits, state = decode(params, state, tokens[:, i])
            steps.append(np.asarray(logits, np.float32))
        jax.effects_barrier()
    chain = dict(steps=steps, state=_np(state), inputs=seen["ref"])
    return dict(cfg=cfg, params=_np(params), tokens=tokens, forward=fwd,
                prefill=pre, chain=chain)


def _port(case):
    return params_from_numpy(case["cfg"], case["params"], device="cpu")


# ---------------------------------------------------------------------------
# routing partings between the packages
# ---------------------------------------------------------------------------

def _routing(side, x, router, cfg):
    """(probabilities (T, E), ids (T, k), kept (T, k): the ids with a
    dropped entry -1) of a layer input x (..., D), routed by ``side``'s
    own ``_route`` and ``_dispatch_indices``, one chunk."""
    x = x.reshape(-1, cfg.d_model)
    T, E, k = x.shape[0], cfg.num_experts, cfg.experts_per_token
    assert T <= PM.MOE_CHUNK
    C = PM.capacity(cfg, T)
    if side == "ref":
        xj, rj = jnp.asarray(x), jnp.asarray(router)
        probs = np.asarray(jax.nn.softmax(xj @ rj, axis=-1))
        ids = RM._route(xj, rj, k)[1]
        valid = np.asarray(RM._dispatch_indices(ids, E, C)[1])
        ids = np.asarray(ids)
    else:
        xt, rt = torch.from_numpy(x), torch.tensor(router)
        probs = torch.softmax(xt @ rt, dim=-1).numpy()
        ids = PM._route(xt, rt, k)[1]
        valid = PM._dispatch_indices(ids, E, C)[1].numpy()
        ids = ids.numpy()
    return probs, ids, np.where(valid.reshape(T, k), ids, -1)


def _partings(ref_inputs, port_inputs, routers, cfg, shape):
    """Route every layer call of one run on both sides, each from its
    own input, and hold the routing: probabilities within ``ROUTER_TOL``,
    every swapped expert set a near tie of the reference's, every other
    parted set in a call with a swap.  ``routers`` is the router of each
    call in order; ``shape`` (B, n) the tokens of a call.  Returns the
    parted tokens (B, n) of each call, and the swap count."""
    tol = ROUTER_TOL[cfg.dtype]
    assert len(ref_inputs) == len(port_inputs) == len(routers)
    parted, swaps = [], 0
    for r_in, p_in, router in zip(ref_inputs, port_inputs, routers):
        assert r_in.shape == p_in.shape
        r_p, r_ids, r_kept = _routing("ref", r_in, router, cfg)
        p_p, p_ids, p_kept = _routing("port", p_in, router, cfg)
        np.testing.assert_allclose(p_p, r_p, rtol=0, atol=tol,
                                   err_msg="router probabilities")
        swapped = (np.sort(r_ids, 1) != np.sort(p_ids, 1)).any(1)
        for t in np.nonzero(swapped)[0]:
            lost = np.setdiff1d(r_ids[t], p_ids[t])
            won = np.setdiff1d(p_ids[t], r_ids[t])
            margin = r_p[t, lost].min() - r_p[t, won].max()
            assert margin <= 2 * tol, (t, r_ids[t], p_ids[t], margin)
        kept = (np.sort(r_kept, 1) != np.sort(p_kept, 1)).any(1)
        assert swapped.any() or not kept.any(), "a drop parted alone"
        swaps += int(swapped.sum())
        parted.append(kept | swapped)
    if cfg.dtype == "float32":      # ids, dest and valid exactly equal
        assert swaps == 0 and not np.any(parted)
    return [p.reshape(shape) for p in parted], swaps


def _tainted(parted_by_layer, n_layers):
    """(B, n) positions a parting reaches: any layer's, then the rest of
    the row (attention carries it to later tokens)."""
    calls = [np.any(parted_by_layer[i:i + n_layers], axis=0)
             for i in range(0, len(parted_by_layer), n_layers)]
    tainted = np.logical_or.accumulate(np.concatenate(calls, axis=1), axis=1)
    assert tainted.mean() <= 0.75, "the routing parted too widely"
    return tainted


def _routers(case, calls):
    layers = case["params"]["layers"]["moe"]["router"]
    return [layers[i % len(layers)] for i in range(calls)]


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def _tokens_f32(cfg, seed, T):
    """Layer-input-like rows in ``cfg.dtype`` (as ``ln2`` gives them),
    read as float32 as the router reads them."""
    x = np.random.default_rng(seed).standard_normal((T, cfg.d_model))
    return torch.tensor(x, dtype=torch.float32).to(
        getattr(torch, cfg.dtype)).float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, dtype):
    """32 rows and 3 zero rows (a full tie: the lowest ids win, as in
    ``jax.lax.top_k``)."""
    cfg = _cfg(arch, dtype)
    k = cfg.experts_per_token
    router = np.array(_ref_params(arch)["layers"]["moe"]["router"][0])
    x = np.concatenate([_tokens_f32(cfg, 1, 32),
                        np.zeros((3, cfg.d_model), np.float32)])
    want = RM._route(jnp.asarray(x), jnp.asarray(router), k)
    got = PM._route(torch.from_numpy(x), torch.from_numpy(router), k)
    assert got[1].dtype == torch.int64 and got[0].dtype == torch.float32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1][-3:].numpy(),
                                  np.tile(np.arange(k), (3, 1)))
    _close(got[0], want[0], 1e-6, "top_p")
    for i, what in ((2, "aux"), (3, "zloss")):
        assert got[i].shape == ()
        _close(got[i], want[i], PIECE_TOL["float32"], what)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_indices_match_reference(arch):
    """``dest`` and ``valid`` exactly, at T = 32: on the ids routed from
    32 random rows; from 2 rows 16 times each (qwen3: an expert's 16
    entries overflow its C = 10); and on skewed ids, every token on
    experts 0 and 1, which overflow at either config."""
    cfg = _cfg(arch)
    E, k = cfg.num_experts, cfg.experts_per_token
    router = jnp.asarray(_ref_params(arch)["layers"]["moe"]["router"][0])
    rows = _tokens_f32(cfg, 2, 32)
    routed = [np.asarray(RM._route(jnp.asarray(x), router, k)[1])
              for x in (rows, np.repeat(rows[:2], 16, axis=0))]
    skewed = np.tile(np.arange(k), (32, 1))
    skewed[::3] = skewed[::3, ::-1]
    C = PM.capacity(cfg, 32)
    assert C == {"phi3p5_moe_42b": 20, "qwen3_moe_30b": 10}[arch]
    for ids, must_drop in ((routed[0], False),
                           (routed[1], arch == "qwen3_moe_30b"),
                           (skewed, True)):
        want_dest, want_valid = RM._dispatch_indices(jnp.asarray(ids), E, C)
        dest, valid = PM._dispatch_indices(torch.from_numpy(ids), E, C)
        np.testing.assert_array_equal(dest.numpy(), np.asarray(want_dest))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
        assert valid.dtype == torch.bool
        if must_drop:
            assert (~valid).any()
            assert (dest[~valid] == E * C).all()
        assert (dest[valid] < E * C).all()
        assert len(set(dest[valid].tolist())) == int(valid.sum())


def test_capacity_is_the_references():
    """``capacity`` is the reference's expression for ``C``
    (``moe.py:162``) over chunks and capacity factors."""
    for arch in ARCHS:
        for cf in (1.0, 1.25, 2.0, 4.0 / 3.0):
            cfg = _cfg(arch, capacity_factor=cf)
            E, k = cfg.num_experts, cfg.experts_per_token
            for chunk in (1, 2, 7, 32, 100, 8192):
                want = max(RM.MIN_CAPACITY, int(np.ceil(
                    chunk * k / E * cfg.capacity_factor)))
                assert PM.capacity(cfg, chunk) == want
    assert (PM.MOE_CHUNK, PM.MIN_CAPACITY) == (RM.MOE_CHUNK,
                                                RM.MIN_CAPACITY)


def _block_inputs(arch, dtype, seed, shape):
    cfg = _cfg(arch, dtype)
    p, _ = RM.init_moe(jax.random.PRNGKey(seed), cfg)
    port = {n: torch.tensor(np.asarray(a, np.float32)).to(
        torch.float32 if n == "router" else getattr(torch, dtype))
        for n, a in p.items()}
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return (cfg, p, port, jnp.asarray(x, dtype),
            torch.tensor(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, dtype):
    """One chunk of B 2 x S 16 = 32 tokens: the output, aux and z loss."""
    cfg, p, port, xj, xt = _block_inputs(arch, dtype, 3, (2, 16))
    want = jax.jit(RM.moe_block, static_argnums=2)(p, xj, cfg)
    got = PM.moe_block(port, xt, cfg)
    assert got[0].shape == xt.shape and got[0].dtype == xt.dtype
    _close(got[0], want[0], PIECE_TOL[dtype], "moe_block out")
    _close(got[1], want[1], PIECE_TOL["float32"], "aux")
    _close(got[2], want[2], PIECE_TOL["float32"], "zloss")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_pads_the_last_chunk(arch, dtype):
    """B 2 x S 4,100 = 8,200 tokens: two chunks of 8,192, the second 8
    tokens and 8,184 zero rows, which route to experts 0 and 1 (a full
    tie), overflow them and count in the mean of aux and z over the
    chunks."""
    cfg, p, port, xj, xt = _block_inputs(arch, dtype, 4, (2, 4100))
    T = 2 * 4100
    assert T % PM.MOE_CHUNK == 8 and 2 * PM.MOE_CHUNK - T == 8184
    want = jax.jit(RM.moe_block, static_argnums=2)(p, xj, cfg)
    got = PM.moe_block(port, xt, cfg)
    _close(got[0], want[0], PIECE_TOL[dtype], "moe_block out")
    _close(got[1], want[1], PIECE_TOL["float32"], "aux")
    _close(got[2], want[2], PIECE_TOL["float32"], "zloss")
    # the pad rows weigh in: the first chunk alone gives its own z, a
    # zero row's is log(E)**2, and the second chunk's (8 real rows of
    # 8,192) all but that
    alone = PM.moe_block(port, xt.reshape(1, T, -1)[:, :PM.MOE_CHUNK], cfg)
    pads = math.log(cfg.num_experts) ** 2
    assert abs(2 * float(got[2]) - float(alone[2]) - pads) < 0.01 * pads


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    case = _case(arch, dtype)
    cfg = case["cfg"]
    with _layer_inputs() as seen:
        logits, aux = P.forward(_port(case), {"tokens": case["tokens"]},
                                cfg, device="cpu")
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == getattr(torch, dtype)
    parted, _ = _partings(case["forward"]["inputs"], seen["port"],
                          _routers(case, cfg.num_layers), cfg, (B, S))
    clean = ~_tainted(parted, cfg.num_layers)
    _close(logits, case["forward"]["logits"], TOL[dtype], "forward logits",
           where=clean)
    for n in ("moe_aux", "moe_z"):
        want = case["forward"]["aux"][n]
        assert aux[n].dtype == torch.float32 and want > 0.1
        _close(aux[n], want, TOL[dtype], n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    case = _case(arch, dtype)
    cfg = case["cfg"]
    want = case["prefill"]
    with _layer_inputs() as seen:
        logits, state = P.prefill(_port(case),
                                  {"tokens": case["tokens"][:, :PROMPT]},
                                  cfg, max_len=S, device="cpu")
    assert state.keys() == {"pos", "kv"} and state["pos"] == PROMPT
    assert state["kv"]["k"].shape == (cfg.num_layers, B, cfg.num_kv_heads,
                                      S, cfg.head_dim)
    assert state["kv"]["k"].dtype == getattr(torch, dtype)
    parted, _ = _partings(want["inputs"], seen["port"],
                          _routers(case, cfg.num_layers), cfg, (B, PROMPT))
    tainted = _tainted(parted, cfg.num_layers)
    _close(logits, want["logits"], TOL[dtype], "prefill logits",
           where=~tainted[:, -1])
    got = decode_state_to_numpy(state)
    assert int(got["pos"]) == int(want["state"]["pos"])
    clean = np.pad(~tainted, ((0, 0), (0, S - PROMPT)),
                   constant_values=True)            # (B, T) cache slots
    for n in ("k", "v"):
        _close(got["kv"][n].transpose(1, 2, 0, 3, 4),
               want["state"]["kv"][n].transpose(1, 2, 0, 3, 4),
               TOL[dtype], f"prefill cache {n}", where=clean)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_reference(arch, dtype):
    """Both sides decode from the reference's prefill state; a step
    routes its B tokens among themselves (C = 4, nothing drops)."""
    case = _case(arch, dtype)
    cfg = case["cfg"]
    params = _port(case)
    state = decode_state_from_numpy(cfg, case["prefill"]["state"],
                                    device="cpu")
    logits = []
    with _layer_inputs() as seen:
        for i in range(PROMPT, S):
            lg, state = P.decode_step(params, state, case["tokens"][:, i],
                                      cfg, device="cpu")
            assert lg.shape == (B, cfg.vocab_size)
            logits.append(lg)
    parted, _ = _partings(case["chain"]["inputs"], seen["port"],
                          _routers(case, cfg.num_layers * STEPS), cfg,
                          (B, 1))
    tainted = _tainted(parted, cfg.num_layers)
    for i, (lg, want) in enumerate(zip(logits, case["chain"]["steps"])):
        _close(lg, want, TOL[dtype], f"decode step {i}",
               where=~tainted[:, i])
    got = decode_state_to_numpy(state)
    assert int(got["pos"]) == int(case["chain"]["state"]["pos"]) == S
    clean = np.concatenate([np.ones((B, PROMPT), bool), ~tainted], axis=1)
    for n in ("k", "v"):
        _close(got["kv"][n].transpose(1, 2, 0, 3, 4),
               case["chain"]["state"]["kv"][n].transpose(1, 2, 0, 3, 4),
               TOL[dtype], f"cache {n}", where=clean)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, dtype):
    """The port's prefill and decode steps give the port's forward
    logits at the same positions (tests/test_models.py:58), at
    ``capacity_factor = E / k``: C is then the whole chunk and no entry
    drops.  At the config's own 1.25 a forward's tokens compete for
    capacity that a decode step's never fill, and the reference's decode
    parts from its forward just as the port's does."""
    case = _case(arch, dtype)
    cfg = dataclasses.replace(
        case["cfg"],
        capacity_factor=case["cfg"].num_experts
        / case["cfg"].experts_per_token)
    assert PM.capacity(cfg, B * S) >= B * S
    params = _port(case)
    tokens = torch.from_numpy(case["tokens"])
    whole = P.forward(params, {"tokens": tokens}, cfg, device="cpu")[0]
    logits, state = P.prefill(params, {"tokens": tokens[:, :PROMPT]}, cfg,
                              max_len=S, device="cpu")
    _close(logits, whole[:, PROMPT - 1].float().numpy(), TOL[dtype],
           "prefill")
    for i in range(PROMPT, S):
        logits, state = P.decode_step(params, state, tokens[:, i], cfg,
                                      device="cpu")
        _close(logits, whole[:, i].float().numpy(), TOL[dtype],
               f"position {i}")


def test_moe_layers_launch_what_dense_layers_do(monkeypatch):
    """Once a layer a pass through the flash wrapper, once a layer a step
    through the decode wrapper; the router, dispatch and experts through
    no kernel wrapper."""
    calls = {"flash": 0, "decode": 0}
    flash = flash_kernel.flash_attention
    decode = decode_kernel.decode_attention

    def counted_flash(*a, **k):
        calls["flash"] += 1
        return flash(*a, **k)

    def counted_decode(*a):
        calls["decode"] += 1
        return decode(*a)

    monkeypatch.setattr(flash_kernel, "flash_attention", counted_flash)
    monkeypatch.setattr(decode_kernel, "decode_attention", counted_decode)
    cfg = get_smoke_config("qwen3_moe_30b")
    params = P.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 8)))
    _, aux = P.forward(params, {"tokens": tokens}, cfg, device="cpu")
    assert float(aux["moe_aux"]) > 0 and float(aux["moe_z"]) > 0
    logits, state = P.prefill(params, {"tokens": tokens}, cfg, max_len=11,
                              device="cpu")
    assert calls == {"flash": 2 * cfg.num_layers, "decode": 0}
    for _ in range(3):
        logits, state = P.decode_step(params, state, logits.argmax(-1), cfg,
                                      device="cpu")
    assert calls == {"flash": 2 * cfg.num_layers,
                     "decode": 3 * cfg.num_layers}
    assert state["pos"] == 11 and state.keys() == {"pos", "kv"}


def test_init_params_follows_the_reference_layout():
    """The port's own init: the reference's tree (the router float32, the
    experts in ``cfg.dtype``), at both smoke configs."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        a = P.init_params(cfg, seed=3, device="cpu")
        ref = jax.eval_shape(lambda: R.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
        lp = a["layers"][0]
        assert lp.keys() == ref["layers"].keys() == {"ln1", "attn", "ln2",
                                                     "moe"}
        assert lp["moe"].keys() == ref["layers"]["moe"].keys()
        for n, t in lp["moe"].items():
            assert tuple(t.shape) == ref["layers"]["moe"][n].shape[1:], n
            assert t.dtype == (torch.float32 if n == "router"
                               else torch.bfloat16), n
        E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
        w = P.init_params(cfg, seed=3, device="cpu")["layers"][1]["moe"]
        assert torch.equal(w["wi"], a["layers"][1]["moe"]["wi"])
        # fan-in scale: wi over D, wo over F
        assert abs(float(w["wi"].float().std()) * math.sqrt(D)
                   - 0.8796) < 0.05
        assert abs(float(w["wo"].float().std()) * math.sqrt(F)
                   - 0.8796) < 0.05
        assert w["router"].shape == (D, E)
