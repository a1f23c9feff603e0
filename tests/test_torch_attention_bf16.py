"""The softmax weight p in bfloat16 attention: the Pallas kernels keep it
float32.

``_flash_kernel`` and ``_decode_kernel`` cast v to float32 before the PV
product (``v = v_ref[0, 0].astype(jnp.float32)``), so their
``p.astype(v.dtype)`` leaves p float32 for bfloat16 inputs too.  The
port's plain versions compute p in float32 as well, and for bfloat16
inputs they and the Pallas kernels (interpret mode) agree bit for bit on
at least 99 % of the outputs; the rest differ by one bfloat16 rounding,
from summation order.  Rounding p to bfloat16 before the product breaks
that: about a third of the outputs then differ.  The CUDA kernels are held
to the same share against the plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 8)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from torch_cases import DECODE_CASES, FLASH_CASES, attention_inputs

#: the share of bfloat16 outputs that must be bit-equal
SHARE = 0.99


def _bf16(arrays):
    return (tuple(jnp.asarray(a, jnp.bfloat16) for a in arrays),
            tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays))


def _share(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float((got == want).mean())


@pytest.mark.parametrize("B,H,KV,S,T,hd,causal", [
    c[:7] for c in FLASH_CASES] + [(1, 4, 2, 128, 128, 80, True),
                                   (1, 2, 1, 128, 256, 40, False)])
def test_flash_bf16_plain_equals_pallas_bit_for_bit(B, H, KV, S, T, hd,
                                                    causal):
    (jq, jk, jv), (tq, tk, tv) = _bf16(
        attention_inputs(S + T + hd, B, H, KV, S, T, hd))
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    assert _share(got, want) >= SHARE


@pytest.mark.parametrize("B,H,KV,T,hd", [c[:5] for c in DECODE_CASES])
def test_decode_bf16_plain_equals_pallas_bit_for_bit(B, H, KV, T, hd):
    (jq, jk, jv), (tq, tk, tv) = _bf16(
        attention_inputs(T + hd, B, H, KV, 0, T, hd))
    length = np.random.default_rng(T).integers(1, T + 1, B).astype(np.int32)
    length[0] = T
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(length),
                                 block_k=128, interpret=True)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(length))
    assert got.dtype == torch.bfloat16
    assert _share(got, want) >= SHARE


def test_bf16_p_would_break_the_share():
    """The fault the port's kernels had: p rounded to bfloat16 before the
    PV product leaves far fewer outputs equal to the Pallas kernel's."""
    B, H, KV, S, T, hd = 1, 2, 2, 128, 128, 64
    (jq, jk, jv), (tq, tk, tv) = _bf16(
        attention_inputs(7, B, H, KV, S, T, hd))
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                block_k=64, interpret=True)
    s = torch.einsum("bhqd,bhkd->bhqk", tq.float(), tk.float()) * hd ** -0.5
    s = torch.where(torch.ones(S, T, dtype=torch.bool).tril(), s,
                    torch.full_like(s, ref.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    rounded = (p.to(torch.bfloat16).float() @ tv.float()) / l
    kept = (p @ tv.float()) / l
    assert _share(kept.to(torch.bfloat16), want) >= SHARE
    assert _share(rounded.to(torch.bfloat16), want) < 0.8
