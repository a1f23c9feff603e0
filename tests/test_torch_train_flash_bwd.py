"""The flash backward's plain version, ``kernels.ref.flash_attention_bwd_ref``,
against the reference's gradients on the CPU: ``jax.vjp`` of
``repro.kernels.ref.flash_attention_ref`` (the Pallas kernel's oracle) and
of ``repro.models.attention.blockwise_attention`` (the jnp path the
reference trains through; the Pallas kernel has no VJP).  Causal and not,
S != T, H / KV of 1, 4 and 8, hd 16, 64, 80 and 128, ragged S; and the
port's ``torch.autograd.Function`` (``flash_attention.FlashAttention``),
which the wrapper takes under grad, giving the plain gradients on the CPU.

Tolerance: float32 on both sides, summed in different orders; |d| <=
TOL x (1 + |ref|) with TOL = 2e-5 (measured at most 1.5e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models.config import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TOL = 2e-5

#: (B, H, KV, S, T, hd, causal)
SHAPES = [
    (2, 4, 4, 32, 32, 16, True),
    (2, 4, 1, 37, 37, 64, True),       # H / KV 4, ragged S
    (1, 8, 1, 24, 40, 80, False),      # H / KV 8, S < T
    (2, 8, 2, 40, 24, 128, True),      # S > T
    (1, 4, 4, 13, 29, 64, False),
    (2, 8, 1, 19, 19, 16, False),
]


def _inputs(shape, seed=0):
    B, H, KV, S, T, hd, _ = shape
    rng = np.random.default_rng(seed + S * 7 + T + hd)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, H, S, hd), f(B, KV, T, hd), f(B, KV, T, hd), f(B, H, S, hd)


def _vjp(fn, q, k, v, do):
    """The gradients of ``fn`` at (q, k, v) against ``do``, through
    ``jax.vjp`` under one ``jax.jit``."""
    return jax.jit(lambda q, k, v, do: jax.vjp(fn, q, k, v)[1](do))(
        q, k, v, do)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _port(q, k, v, do, causal):
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o = ref.flash_attention_ref(*t[:3], causal=causal)
    lse = ref.flash_attention_lse_ref(*t[:2], causal=causal)
    return ref.flash_attention_bwd_ref(*t[:3], o, lse, t[3], causal=causal)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_against_vjp_of_the_reference_oracle(shape):
    q, k, v, do = _inputs(shape)
    causal = shape[-1]
    want = _vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal), q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), _port(q, k, v, do, causal),
                          want):
        _close(g, w, f"{name} {shape}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_against_vjp_of_blockwise_attention(shape):
    """The reference's training path: ``blockwise_attention`` over
    sequence-major (B, S, heads, hd) tensors with 16 query heads (no
    padded heads), chunked at 16 queries and 8 keys."""
    B, H, KV, S, T, hd, causal = shape
    H16 = 16
    cfg = ModelConfig(name="bwd", family="dense", num_layers=1,
                      d_model=H16 * hd, num_heads=H16,
                      num_kv_heads=H16 * KV // H, d_ff=8, vocab_size=8,
                      head_dim=hd, attn_q_chunk=16, attn_kv_chunk=8)
    shape16 = (B, H16, cfg.num_kv_heads, S, T, hd, causal)
    q, k, v, do = _inputs(shape16)
    seq = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in _vjp(
        lambda q, k, v: jattn.blockwise_attention(q, k, v, cfg,
                                                  causal=causal),
        seq(q), seq(k), seq(v), seq(do))]
    for name, g, w in zip(("dq", "dk", "dv"), _port(q, k, v, do, causal),
                          want):
        _close(g, w, f"{name} {shape16}")


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_on_the_cpu_gives_the_plain_gradients(causal):
    """Under grad the wrapper runs ``FlashAttention``: its forward is the
    plain forward bit for bit, its backward ``flash_attention_bwd``, here
    the plain version: the gradients equal autograd through the plain
    forward, and nothing launches."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(SHAPES[1]))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    out = fa.flash_attention(*leaves, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = ref.flash_attention_ref(*plain, causal=causal)
    want.backward(do)
    assert torch.equal(out.detach(), want.detach())
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=TOL, atol=TOL)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before


def test_wrapper_backward_checks_and_dispatch():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    o = ref.flash_attention_ref(q, k, v)
    lse = ref.flash_attention_lse_ref(q, k)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_attention_bwd(q, k, v, o, lse, do[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="o must be"):
        fa.flash_attention_bwd(q, k, v, o.to(torch.bfloat16), lse, do)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd(q, k, v, o, lse[:, :, :-1], do)
    meta = [t.to("meta") for t in (q, k, v, o, lse, do)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention_bwd(*meta)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_bwd_plan(12, torch.float32)
    assert fa.flash_bwd_plan(72, torch.bfloat16).hdp == 128
    bf16 = [t.to(torch.bfloat16) for t in (q, k, v, o)]
    assert all(g.dtype == torch.bfloat16 for g in fa.flash_attention_bwd(
        *bf16, lse, do.to(torch.bfloat16)))


def test_backward_refuses_lengths_past_its_int_bounds(monkeypatch):
    """The backward forms its blocks' row and key bounds (q0 + 32, k0 +
    32) and its loops' last q0 and k0 in int, as the forward does: past
    ``MAX_LEN`` the wrapper raises before any launch and the launcher's
    guard (its mirror, ``kernel_audit``) refuses; at ``MAX_LEN`` the
    audit's int model stays within INT_MAX.  A plan whose shared memory
    is not the kernel's layout is reported."""
    from repro_torch.analysis import kernel_audit as ka

    top = fa.MAX_LEN
    q = torch.empty((1, 1, top + 1, 64), device="meta")
    kv = torch.empty((1, 1, 8, 64), device="meta")
    lse = torch.empty((1, 1, top + 1), device="meta")
    with pytest.raises(ValueError, match="row and key bounds"):
        fa.flash_attention_bwd(q, kv, kv, q, lse, q)
    for dtype in ("float32", "bfloat16"):
        shape = dict(B=1, H=1, KV=1, S=top, T=top, hd=64, causal=False)
        findings = ka.check_launch("flash_attention_bwd", shape, dtype)
        assert findings and all("too large to enumerate" in v.msg
                                for v in findings), findings
        findings = ka.check_launch("flash_attention_bwd",
                                   dict(shape, S=top + 1, T=top + 1), dtype)
        assert any("guard refuses" in v.msg for v in findings)
    real = fa.flash_bwd_plan
    monkeypatch.setattr(fa, "flash_bwd_plan", lambda hd, dt: real(
        hd, dt)._replace(smem=real(hd, dt).smem + 16))
    findings = ka.check_launch("flash_attention_bwd", dict(
        B=2, H=4, KV=2, S=40, T=40, hd=64, causal=True))
    assert any("the kernel lays out" in v.msg for v in findings), findings
