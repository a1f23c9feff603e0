"""The zoo's pieces around the differential of ``test_torch_models.py``:
the copied configs, the parameter and state converters (the reference's
pad heads dropped without changing its logits; Mamba1's tree and state;
the hybrid's Mamba2 layers, unstacked shared block and two-part state;
the MoE layers' float32 router and experts), the building blocks against
the reference's, the port's own init, where attention goes, the head
widths the CUDA kernels take, and the families not ported yet."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro import models as R
from repro.models import attention as RA
from repro.models import layers as RL
import repro_torch.configs as PC
from repro_torch import models as P
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, params_from_numpy)
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL

DENSE = ("yi_6b", "deepseek_7b", "phi3_medium_14b", "command_r_plus_104b")
MOE = ("phi3p5_moe_42b", "qwen3_moe_30b")
#: the families not ported yet
OTHERS = ("qwen2_vl_72b", "whisper_tiny")
TOL = 2e-4                      # float32, as in test_torch_models.py

_init = jax.jit(R.init_params, static_argnums=0)
_forward = jax.jit(R.forward, static_argnums=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _tokens(cfg, seed, B=2, S=16):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_are_the_references(arch):
    for get in ("get_config", "get_smoke_config"):
        want, got = getattr(RC, get)(arch), getattr(PC, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.num_padded_heads, got.param_count(),
                got.active_param_count()) == (
            want.num_padded_heads, want.param_count(),
            want.active_param_count())
    assert PC.ARCH_IDS == RC.ARCH_IDS
    assert PC._ALIASES == RC._ALIASES


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_numpy_drops_pads_and_casts_once(arch):
    cfg = RC.get_smoke_config(arch)
    tree = _np(_init(cfg, jax.random.PRNGKey(1)))
    params = params_from_numpy(cfg, tree, device="cpu")
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    assert cfg.num_padded_heads == 16 > H
    assert len(params["layers"]) == cfg.num_layers
    for layer, lp in enumerate(params["layers"]):
        a = lp["attn"]
        assert a["wq"].shape == (D, H * hd) and a["wo"].shape == (H * hd, D)
        assert a["wk"].shape == a["wv"].shape == (D, KV * hd)
        ref = tree["layers"]["attn"]
        np.testing.assert_array_equal(
            a["wq"].float().numpy(),
            torch.tensor(ref["wq"][layer][:, :H * hd]).bfloat16().float())
        np.testing.assert_array_equal(
            a["wo"].float().numpy(),
            torch.tensor(ref["wo"][layer][:H * hd]).bfloat16().float())
        assert not ref["wq"][layer][:, H * hd:].any()    # pads are zero
        for group, sub in lp.items():
            for t in sub.values():
                assert t.dtype == (torch.float32 if group.startswith("ln")
                                   else torch.bfloat16)
    assert params["embed"]["tok"].dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32


def test_head_padding_is_inert_in_the_port():
    """The counterpart of tests/test_models.py::test_head_padding_is_inert:
    phi3's smoke config pads 4 query heads to 16 over 1 kv head.  Garbage
    in the pad heads' wq columns and wo rows leaves the reference's logits
    unchanged (its head_mask zeroes the pads); the converter drops exactly
    those columns and rows, and the port, running 4 heads, gives the
    reference's logits."""
    cfg = _f32(RC.get_smoke_config("phi3_medium_14b"))
    assert (cfg.num_heads, cfg.num_padded_heads) == (4, 16)
    params = _init(cfg, jax.random.PRNGKey(0))
    width = cfg.num_heads * cfg.head_dim
    rng = np.random.default_rng(0)
    attn = params["layers"]["attn"]
    noisy = dict(attn,
                 wq=attn["wq"].at[..., width:].set(
                     rng.standard_normal(attn["wq"][..., width:].shape)),
                 wo=attn["wo"].at[:, width:].set(
                     rng.standard_normal(attn["wo"][:, width:].shape)))
    noisy = dict(params, layers=dict(params["layers"], attn=noisy))
    batch = {"tokens": _tokens(cfg, 0)}
    want = np.asarray(_forward(params, batch, cfg)[0])
    np.testing.assert_allclose(np.asarray(_forward(noisy, batch, cfg)[0]),
                               want, rtol=1e-6, atol=1e-6)
    clean = params_from_numpy(cfg, _np(params), device="cpu")
    dropped = params_from_numpy(cfg, _np(noisy), device="cpu")
    for a, b in zip(clean["layers"], dropped["layers"]):
        for n in ("wq", "wo"):
            assert torch.equal(a["attn"][n], b["attn"][n])
    got = P.forward(dropped, batch, cfg, device="cpu")[0].numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_decode_state_round_trip(dtype):
    cfg = dataclasses.replace(RC.get_smoke_config("yi_6b"), dtype=dtype)
    params = _init(cfg, jax.random.PRNGKey(2))
    _, state = jax.jit(R.prefill, static_argnums=(2, 3))(
        params, {"tokens": _tokens(cfg, 2, S=10)}, cfg, 12)
    state = _np(state)
    port = decode_state_from_numpy(cfg, state, device="cpu")
    L, B, T, KV, hd = state["kv"]["k"].shape
    assert port["pos"] == 10
    assert port["kv"]["k"].shape == (L, B, KV, T, hd)
    assert port["kv"]["k"].dtype == getattr(torch, dtype)
    assert port["kv"]["k"].is_contiguous()
    back = decode_state_to_numpy(port)
    assert back["pos"] == np.int32(10)
    for n in ("k", "v"):
        np.testing.assert_array_equal(back["kv"][n],
                                      np.asarray(state["kv"][n], np.float32))


@pytest.mark.parametrize("norm", ("rmsnorm", "layernorm"))
def test_apply_norm_matches_reference(norm):
    cfg = dataclasses.replace(_f32(RC.get_smoke_config("yi_6b")),
                              norm_type=norm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    want = RL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg)
    got = PL.apply_norm({k: torch.tensor(v) for k, v in p.items()},
                        torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("theta", (10_000.0, 5_000_000.0))
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9)).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = PL.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(PL.rope_freqs(16, theta),
                                  RL.rope_freqs(16, theta))


def test_apply_mrope_matches_reference():
    cfg = RC.get_smoke_config("qwen2_vl_72b")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, cfg.head_dim)).astype(np.float32)
    pos3 = rng.integers(0, 64, (3, 2, 7)).astype(np.int32)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), cfg.rope_theta,
                          cfg.mrope_sections)
    got = PL.apply_mrope(torch.tensor(x), torch.tensor(pos3),
                         cfg.rope_theta, cfg.mrope_sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("gated", (True, False))
def test_apply_mlp_matches_reference(gated):
    cfg = dataclasses.replace(_f32(RC.get_smoke_config("yi_6b")),
                              use_bias=True)
    p, _ = RL.init_mlp(jax.random.PRNGKey(6), cfg, gated=gated)
    rng = np.random.default_rng(6)
    p = dict(p, bi=jnp.asarray(rng.standard_normal(cfg.d_ff), jnp.float32),
             bo=jnp.asarray(rng.standard_normal(cfg.d_model), jnp.float32))
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = RL.apply_mlp(p, jnp.asarray(x), cfg)
    got = PL.apply_mlp({k: torch.tensor(np.asarray(v)) for k, v in p.items()},
                       torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tied,softcap,pad", [(False, 0.0, False),
                                              (True, 30.0, True)])
def test_embed_and_unembed_match_reference(tied, softcap, pad):
    cfg = dataclasses.replace(_f32(RC.get_smoke_config("yi_6b")),
                              tie_embeddings=tied, logits_softcap=softcap,
                              vocab_size=500)
    if pad:
        cfg = cfg.with_padded_vocab()
        assert cfg.real_vocab_size == 500 and cfg.vocab_size == 512
    p, _ = RL.init_embed(jax.random.PRNGKey(7), cfg)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    tokens = _tokens(cfg, 7, S=5)
    x = RL.embed_tokens(p, jnp.asarray(tokens), cfg)
    got = PL.embed_tokens(tp, torch.tensor(tokens).long(), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(x))
    want = RL.unembed(p, x * 40.0, cfg)
    got = PL.unembed(tp, got * 40.0, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", (True, False))
def test_full_attention_oracle(causal):
    """The port's oracle equals the reference's (pad heads zero) and the
    flash wrapper's plain path."""
    cfg = _f32(RC.get_smoke_config("yi_6b"))
    H, KV, hd, Hp = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.num_padded_heads)
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 12, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, KV, hd)).astype(np.float32)
            for _ in range(2))
    qp = np.concatenate([q, np.zeros((2, 12, Hp - H, hd), np.float32)], 2)
    want = np.asarray(RA.full_attention(jnp.asarray(qp), jnp.asarray(k),
                                        jnp.asarray(v), cfg,
                                        causal=causal))[:, :, :H]
    tq, tk, tv = (torch.tensor(a).transpose(1, 2).contiguous()
                  for a in (q, k, v))
    got = PA.full_attention(tq, tk, tv, cfg, causal=causal)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=1e-5,
                               atol=1e-5)
    flash = PA.blockwise_attention(tq, tk, tv, cfg, causal=causal)
    np.testing.assert_allclose(flash.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_init_params_follows_the_reference_layout():
    cfg = PC.get_smoke_config("yi_6b")
    a = P.init_params(cfg, seed=3, device="cpu")
    ref = jax.eval_shape(lambda: R.init_params(cfg, jax.random.PRNGKey(0)))
    width = cfg.num_heads * cfg.head_dim
    assert a["embed"].keys() == ref["embed"].keys()
    assert len(a["layers"]) == cfg.num_layers
    for group, sub in a["layers"][0].items():
        assert sub.keys() == ref["layers"][group].keys()
        for n, t in sub.items():
            shape = list(ref["layers"][group][n].shape[1:])
            if n == "wq":
                shape[-1] = width
            if n == "wo" and group == "attn":
                shape[0] = width
            assert list(t.shape) == shape, (group, n)
            assert t.dtype == (torch.float32 if group.startswith("ln")
                               else torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(
        a["layers"][1]["mlp"].values(),
        P.init_params(cfg, seed=3, device="cpu")["layers"][1]["mlp"].values()))
    assert not torch.equal(a["embed"]["tok"],
                           P.init_params(cfg, seed=4, device="cpu")
                           ["embed"]["tok"])
    big = PL.dense_init(torch.Generator().manual_seed(0), (512, 512), 512,
                        torch.float32)
    # a standard normal cut at +-2 has standard deviation 0.8796
    assert abs(float(big.std()) * 512 ** 0.5 - 0.8796) < 0.01
    assert float(big.abs().max()) <= 2 / 512 ** 0.5
    emb = PL.embed_init(torch.Generator().manual_seed(0), (512, 512),
                        torch.float32)
    assert abs(float(emb.std()) - 0.02) < 0.0005


def test_attention_goes_through_the_kernel_wrappers(monkeypatch):
    """Once a layer a pass through the flash wrapper, once a layer a step
    through the decode wrapper (on the card each call is one launch)."""
    calls = {"flash": 0, "decode": 0}
    flash, decode = flash_kernel.flash_attention, decode_kernel.decode_attention

    def counted_flash(*a, **k):
        calls["flash"] += 1
        return flash(*a, **k)

    def counted_decode(q, k_cache, v_cache, length):
        calls["decode"] += 1
        assert length.dtype == torch.int32 and length.shape == (q.shape[0],)
        return decode(q, k_cache, v_cache, length)

    monkeypatch.setattr(flash_kernel, "flash_attention", counted_flash)
    monkeypatch.setattr(decode_kernel, "decode_attention", counted_decode)
    cfg = PC.get_smoke_config("command_r_plus_104b")
    params = P.init_params(cfg, seed=0, device="cpu")
    tokens = torch.tensor(_tokens(cfg, 9, S=8))
    P.forward(params, {"tokens": tokens}, cfg, device="cpu")
    logits, state = P.prefill(params, {"tokens": tokens}, cfg, max_len=11,
                              device="cpu")
    assert calls == {"flash": 2 * cfg.num_layers, "decode": 0}
    for _ in range(3):
        logits, state = P.decode_step(params, state, logits.argmax(-1), cfg,
                                      device="cpu")
    assert calls == {"flash": 2 * cfg.num_layers,
                     "decode": 3 * cfg.num_layers}
    assert state["pos"] == 11
    with pytest.raises(ValueError, match="full"):
        P.decode_step(params, state, logits.argmax(-1), cfg, device="cpu")


def test_dense_head_widths_fit_the_cuda_kernels():
    """The CUDA attention paths take hd a multiple of 8 up to 256.  The
    four dense configs have hd 128, the MoE configs 128 (phi3.5-moe) and
    64 (qwen3-moe).  Of their smoke configs, phi3's has hd 20 (80 wide
    over 4 heads): the plain versions serve it on the CPU, and on the card
    the wrappers refuse it rather than answer; the others have hd 16."""
    full = {arch: PC.get_config(arch).head_dim for arch in DENSE + MOE}
    assert full == dict.fromkeys(DENSE, 128) | {"phi3p5_moe_42b": 128,
                                                "qwen3_moe_30b": 64}
    for hd in set(full.values()):
        for dtype in (torch.float32, torch.bfloat16):
            flash_kernel.flash_plan(hd, dtype)
        decode_kernel.check_width(hd)
    widths = {arch: PC.get_smoke_config(arch).head_dim
              for arch in DENSE + MOE}
    assert widths == {"yi_6b": 16, "deepseek_7b": 16, "phi3_medium_14b": 20,
                      "command_r_plus_104b": 16, "phi3p5_moe_42b": 16,
                      "qwen3_moe_30b": 16}
    for hd in set(widths.values()) - {20}:
        flash_kernel.flash_plan(hd, torch.bfloat16)
        decode_kernel.check_width(hd)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_kernel.flash_plan(20, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        decode_kernel.check_width(20)


@pytest.mark.parametrize("arch", OTHERS)
def test_other_families_are_not_ported(arch):
    name, _, version = arch.partition("/mamba")
    cfg = PC.get_smoke_config(name)
    if version:
        cfg = dataclasses.replace(cfg, ssm_version=int(version))
    calls = [lambda: P.init_params(cfg, device="cpu"),
             lambda: P.forward({}, {}, cfg, device="cpu"),
             lambda: P.prefill({}, {}, cfg, device="cpu"),
             lambda: P.init_decode_state(cfg, 1, 4, device="cpu"),
             lambda: P.decode_step({}, {}, None, cfg, device="cpu"),
             lambda: params_from_numpy(cfg, {}, device="cpu"),
             lambda: decode_state_from_numpy(cfg, {}, device="cpu")]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", MOE)
def test_params_from_numpy_holds_the_moe_tree(arch, dtype):
    """A moe layer's router stays float32 in either dtype (the reference
    routes on float32 logits); ``wi``, ``wg`` and ``wo`` are cast once to
    ``cfg.dtype``, the attention as a dense layer's, the norms in
    ``cfg.param_dtype``; every value exact."""
    cfg = dataclasses.replace(RC.get_smoke_config(arch), dtype=dtype)
    tree = _np(_init(cfg, jax.random.PRNGKey(15)))
    params = params_from_numpy(cfg, tree, device="cpu")
    dt = getattr(torch, dtype)
    H, hd, E, D, F = (cfg.num_heads, cfg.head_dim, cfg.num_experts,
                      cfg.d_model, cfg.d_ff)
    assert len(params["layers"]) == cfg.num_layers
    for layer, lp in enumerate(params["layers"]):
        assert lp.keys() == tree["layers"].keys() == {"ln1", "attn", "ln2",
                                                      "moe"}
        moe = lp["moe"]
        assert moe.keys() == {"router", "wi", "wg", "wo"}
        assert moe["router"].shape == (D, E)
        assert moe["wi"].shape == moe["wg"].shape == (E, D, F)
        assert moe["wo"].shape == (E, F, D)
        for group, sub in lp.items():
            for n, t in sub.items():
                want = tree["layers"][group][n][layer]
                if group == "attn" and n == "wq":
                    want = want[:, :H * hd]
                if group == "attn" and n == "wo":
                    want = want[:H * hd]
                assert t.dtype == (
                    torch.float32 if group.startswith("ln")
                    or (group, n) == ("moe", "router") else dt), (group, n)
                assert torch.equal(t, torch.tensor(want).to(t.dtype)), n
        assert moe["router"].dtype == torch.float32
        np.testing.assert_array_equal(moe["router"].numpy(),
                                      tree["layers"]["moe"]["router"][layer])
    assert params["embed"]["tok"].dtype == dt


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_state_round_trip(arch, dtype):
    """A moe model's state is a dense one's: ``pos`` and a cache a layer,
    (L,B,KV,T,hd) in ``cfg.dtype``, into the port's layout and back
    unchanged; a fresh state has the same shapes and dtypes, zeroed."""
    cfg = dataclasses.replace(RC.get_smoke_config(arch), dtype=dtype)
    params = _init(cfg, jax.random.PRNGKey(16))
    _, state = jax.jit(R.prefill, static_argnums=(2, 3))(
        params, {"tokens": _tokens(cfg, 16, S=10)}, cfg, 12)
    state = _np(state)
    port = decode_state_from_numpy(cfg, state, device="cpu")
    L, B, T, KV, hd = state["kv"]["k"].shape
    assert L == cfg.num_layers and port.keys() == {"pos", "kv"}
    assert port["pos"] == 10
    back = decode_state_to_numpy(port)
    assert back["pos"] == np.int32(10) and back.keys() == {"pos", "kv"}
    for n in ("k", "v"):
        t = port["kv"][n]
        assert t.shape == (L, B, KV, T, hd) and t.is_contiguous()
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(back["kv"][n],
                                      np.asarray(state["kv"][n], np.float32))
    fresh = P.init_decode_state(cfg, B, T, device="cpu")
    assert fresh["pos"] == 0 and fresh.keys() == port.keys()
    for n, t in fresh["kv"].items():
        assert t.shape == port["kv"][n].shape and not t.any()
        assert t.dtype == port["kv"][n].dtype


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_params_from_numpy_holds_the_mamba1_tree(dtype):
    """The four projections and the embedding cast once to ``cfg.dtype``;
    the norms and the leaves the reference reads in float32 at each use
    (``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``) held in
    ``cfg.param_dtype``, their values exact."""
    cfg = dataclasses.replace(RC.get_smoke_config("falcon_mamba_7b"),
                              dtype=dtype)
    tree = _np(_init(cfg, jax.random.PRNGKey(11)))
    params = params_from_numpy(cfg, tree, device="cpu")
    dt = getattr(torch, dtype)
    held = {"conv_w", "conv_b", "A_log", "dt_bias", "D"}
    assert len(params["layers"]) == cfg.num_layers
    assert params["embed"]["tok"].dtype == dt
    assert params["final_norm"]["scale"].dtype == torch.float32
    for layer, lp in enumerate(params["layers"]):
        assert lp.keys() == {"ln1", "mamba"}
        assert lp["ln1"]["scale"].dtype == torch.float32
        assert lp["mamba"].keys() == tree["layers"]["mamba"].keys()
        for n, t in lp["mamba"].items():
            assert t.dtype == (torch.float32 if n in held else dt), n
            want = torch.tensor(tree["layers"]["mamba"][n][layer])
            assert torch.equal(t, want.to(t.dtype)), n


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_mamba1_decode_state_round_trip(dtype):
    """The reference's prefill state crosses in its own layout (h
    (L,B,di,N) float32, conv (L,B,W-1,di) in ``cfg.dtype``) and back."""
    cfg = dataclasses.replace(RC.get_smoke_config("falcon_mamba_7b"),
                              dtype=dtype)
    params = _init(cfg, jax.random.PRNGKey(12))
    _, state = jax.jit(R.prefill, static_argnums=(2, 3))(
        params, {"tokens": _tokens(cfg, 12, S=10)}, cfg, 12)
    state = _np(state)
    port = decode_state_from_numpy(cfg, state, device="cpu")
    L, B, di, N = state["ssm"]["h"].shape
    assert port["pos"] == 10 and port.keys() == {"pos", "ssm"}
    assert port["ssm"]["h"].shape == (L, B, di, N)
    assert port["ssm"]["h"].dtype == torch.float32
    assert port["ssm"]["conv"].shape == (L, B, cfg.ssm_conv - 1, di)
    assert port["ssm"]["conv"].dtype == getattr(torch, dtype)
    back = decode_state_to_numpy(port)
    assert back["pos"] == np.int32(10)
    for n in ("h", "conv"):
        assert port["ssm"][n].is_contiguous()
        np.testing.assert_array_equal(
            back["ssm"][n], np.asarray(state["ssm"][n], np.float32))
    fresh = P.init_decode_state(cfg, B, 99, device="cpu")
    assert fresh["pos"] == 0
    for n, t in fresh["ssm"].items():
        assert t.shape == port["ssm"][n].shape and not t.any()
        assert t.dtype == port["ssm"][n].dtype


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_params_from_numpy_holds_the_hybrid_tree(dtype):
    """zamba2's smoke config: each Mamba2 layer's projections in
    ``cfg.dtype`` and ``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``
    and ``norm_scale`` in ``cfg.param_dtype``, values exact; the shared
    block one unstacked dense layer, its 4 query heads out of the
    reference's 16 (the pads zero), its norms in ``cfg.param_dtype``."""
    cfg = dataclasses.replace(RC.get_smoke_config("zamba2_2p7b"),
                              dtype=dtype)
    tree = _np(_init(cfg, jax.random.PRNGKey(13)))
    params = params_from_numpy(cfg, tree, device="cpu")
    dt = getattr(torch, dtype)
    held = {"conv_w", "conv_b", "A_log", "dt_bias", "D", "norm_scale"}
    assert params.keys() == tree.keys() == {"embed", "final_norm",
                                            "layers", "shared_attn"}
    assert len(params["layers"]) == cfg.num_layers
    for layer, lp in enumerate(params["layers"]):
        assert lp.keys() == {"ln1", "mamba"}
        assert lp["mamba"].keys() == tree["layers"]["mamba"].keys()
        assert held < lp["mamba"].keys()
        for n, t in lp["mamba"].items():
            assert t.dtype == (torch.float32 if n in held else dt), n
            want = torch.tensor(tree["layers"]["mamba"][n][layer])
            assert torch.equal(t, want.to(t.dtype)), n
    H, hd, D = cfg.num_heads, cfg.head_dim, cfg.d_model
    assert (H, cfg.num_padded_heads) == (4, 16)
    shared, ref = params["shared_attn"], tree["shared_attn"]
    assert shared.keys() == ref.keys() == {"ln1", "attn", "ln2", "mlp"}
    assert shared["attn"]["wq"].shape == (D, H * hd)
    assert shared["attn"]["wo"].shape == (H * hd, D)
    assert not ref["attn"]["wq"][:, H * hd:].any()
    assert not ref["attn"]["wo"][H * hd:].any()
    for group, sub in shared.items():
        for n, t in sub.items():
            want = ref[group][n]
            if group == "attn" and n == "wq":
                want = want[:, :H * hd]
            if group == "attn" and n == "wo":
                want = want[:H * hd]
            assert t.dtype == (torch.float32 if group.startswith("ln")
                               else dt), (group, n)
            assert torch.equal(t, torch.tensor(want).to(t.dtype)), (group, n)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_hybrid_decode_state_round_trip(dtype):
    """The reference's hybrid prefill state (the Mamba2 layers' h
    (L,B,nh,hd,N) float32 and conv (L,B,W-1,di+2N) in ``cfg.dtype``, a
    cache a super-block) crosses into the port's layout and back
    unchanged; a fresh state has the same shapes and dtypes, zeroed."""
    cfg = dataclasses.replace(RC.get_smoke_config("zamba2_2p7b"),
                              dtype=dtype)
    params = _init(cfg, jax.random.PRNGKey(14))
    _, state = jax.jit(R.prefill, static_argnums=(2, 3))(
        params, {"tokens": _tokens(cfg, 14, S=10)}, cfg, 12)
    state = _np(state)
    port = decode_state_from_numpy(cfg, state, device="cpu")
    L, B, nh, hd, N = state["ssm"]["h"].shape
    n_super, _, T, KV, khd = state["kv"]["k"].shape
    assert (L, n_super) == (cfg.num_layers, cfg.num_layers // cfg.attn_every)
    assert (nh, hd, N) == (cfg.ssm_num_heads, cfg.ssm_head_dim,
                           cfg.ssm_state)
    assert port["pos"] == 10 and port.keys() == {"pos", "ssm", "kv"}
    assert port["ssm"]["h"].dtype == torch.float32
    assert port["ssm"]["conv"].shape == (L, B, cfg.ssm_conv - 1,
                                         cfg.d_inner + 2 * N)
    assert port["kv"]["k"].shape == (n_super, B, KV, T, khd)
    back = decode_state_to_numpy(port)
    assert back["pos"] == np.int32(10)
    for group in ("ssm", "kv"):
        for n, t in port[group].items():
            assert t.is_contiguous()
            assert t.dtype == (torch.float32 if n == "h"
                               else getattr(torch, dtype))
            np.testing.assert_array_equal(
                back[group][n], np.asarray(state[group][n], np.float32))
    fresh = P.init_decode_state(cfg, B, T, device="cpu")
    assert fresh["pos"] == 0 and fresh.keys() == port.keys()
    for group in ("ssm", "kv"):
        for n, t in fresh[group].items():
            assert t.shape == port[group][n].shape and not t.any()
            assert t.dtype == port[group][n].dtype


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs")
    cfg = PC.get_smoke_config("yi_6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.init_params(cfg)
    params = P.init_params(cfg, device="cpu")
    batch = {"tokens": _tokens(cfg, 10, S=4)}
    for call in (lambda: P.forward(params, batch, cfg),
                 lambda: P.prefill(params, batch, cfg),
                 lambda: P.init_decode_state(cfg, 2, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
