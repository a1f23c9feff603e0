"""The design of the flash-attention CUDA kernel, on the CPU.

``csrc/flash_attention.cu`` runs only on a card; what can be held here
is held here: the plan of tiles it is built for (``flash_plan``), the
wrapper's rule on head widths, and the arithmetic the kernel does on
the tensor cores, emulated with torch on the CPU at a small causal GQA
shape:

- float32 as 3xTF32: each operand split into hi = TF32(x) (nearest, ties
  away, as ``cvt.rna.tf32.f32``) and lo = x - hi, which the tensor core
  reads truncated to TF32; each product lo*hi + hi*lo + hi*hi.  This keeps
  the 2e-5 contract against the plain version, and one TF32 product does
  not;
- bfloat16: p in two bfloat16 pieces, p_hi = bf16(p) and p_lo =
  bf16(p - p_hi), against the same V; this leaves at least 99 % of the
  bfloat16 outputs equal to the plain version's, bit for bit, and a single
  bfloat16 p does not.

The plain version is also held to the Pallas kernel (interpret mode) at
head widths the old kernel refused (40, 80, 136)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention, ops, ref
from torch_cases import attention_inputs, attention_tol

HEAD_DIMS = range(8, 257, 8)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_plan_fits_the_card(hd, dtype):
    plan = flash_attention.flash_plan(hd, dtype)
    assert plan.hdp % 16 == 0 and hd <= plan.hdp < hd + 16
    assert plan.rows % 64 == 0 and plan.rows > 0
    assert plan.keys > 0 and plan.keys % 16 == 0 and plan.stages >= 2
    assert plan.splits in (1, 2)
    assert plan.smem == flash_attention.smem_bytes(
        plan.hdp, dtype == torch.bfloat16, plan.rows, plan.keys, plan.splits,
        plan.stages)
    assert plan.smem <= flash_attention.MAX_SMEM
    # the O accumulator, the score tile (and P's two pieces for two tiles)
    # within the 255 registers a thread, with room for addresses and
    # fragments
    assert plan.acc_regs <= 192
    if dtype == torch.bfloat16:
        assert plan.stages == 3        # scored, in P V, loading
    elif plan.stages > 2:
        assert plan.smem <= flash_attention.SMEM_PAIR


def test_flash_plan_shrinks_the_key_tile_past_hd_128():
    wide = flash_attention.flash_plan(256, torch.float32)
    narrow = flash_attention.flash_plan(128, torch.float32)
    assert wide.keys < narrow.keys and wide.rows < narrow.rows
    assert flash_attention.flash_plan(80, torch.bfloat16).hdp == 80
    assert flash_attention.flash_plan(40, torch.bfloat16).hdp == 48
    # the benchmark's float32 hd 64: two warp sets split the keys
    bench = flash_attention.flash_plan(64, torch.float32)
    assert (bench.rows, bench.splits) == (64, 2)
    assert flash_attention.flash_plan(64, torch.bfloat16).splits == 1


@pytest.mark.parametrize("hd", [4, 12, 100, 257, 264, 512])
def test_wrapper_refuses_head_widths_the_kernel_lacks(hd):
    """Off a multiple of 8 or past 256 the kernel has no build: the plan
    and the wrapper on a device other than the CPU raise (the CPU runs the
    plain version, which takes any width)."""
    with pytest.raises(ValueError, match=f"hd={hd}"):
        flash_attention.flash_plan(hd, torch.float32)
    meta = [torch.empty((1, 2, 8, hd), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match=f"hd={hd}"):
        ops.flash_attention(*meta)
    cpu = [torch.zeros((1, 2, 8, hd)) for _ in range(3)]
    assert ops.flash_attention(*cpu).shape == (1, 2, 8, hd)


@pytest.mark.parametrize("hd", [8, 80, 136, 256])
def test_wrapper_takes_every_multiple_of_8_to_256(hd):
    meta = [torch.empty((1, 2, 8, hd), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(*meta)


# -- the kernel's arithmetic, emulated -------------------------------------

def _tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, by a bit mask on the float32 pattern: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """x truncated to TF32: what the tensor core reads of a float32."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, product):
    """a @ b (float32) as the kernel's product: "3xtf32" (lo*hi + hi*lo +
    hi*hi), "tf32" (one TF32 product), or "bf16" (both operands exact in
    bfloat16, so the plain float32 product)."""
    if product == "bf16":
        return a @ b
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    if product == "tf32":
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate_flash(q, k, v, *, causal, product, p_pieces=2):
    """The kernel's arithmetic in torch on the CPU: key tiles of the plan's
    width, scores in log2 units, an online softmax with float32 (m, l,
    acc), p in the PV product as float32 ("3xtf32", "tf32") or as
    ``p_pieces`` bfloat16 pieces ("bf16"); returns q's dtype."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    bk = flash_attention.flash_plan(hd, q.dtype).keys
    qf = q.to(torch.float32).reshape(B, KV, H // KV, S, hd)
    kf, vf = k.to(torch.float32)[:, :, None], v.to(torch.float32)[:, :, None]
    scale2 = np.float32(1.4426950408889634) / np.float32(np.sqrt(hd))
    m = torch.full((B, KV, H // KV, S, 1), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, T, bk):
        keys = torch.arange(k0, min(k0 + bk, T))[None, :]
        s = _mm(qf, kf[..., k0:k0 + bk, :].transpose(-1, -2), product) \
            * scale2
        if causal:
            s = torch.where(keys <= rows, s, torch.full_like(s, ref.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = vf[..., k0:k0 + bk, :]
        if product == "bf16":
            hi = p.to(torch.bfloat16).to(torch.float32)
            pv = hi @ vt
            if p_pieces == 2:
                pv = pv + (p - hi).to(torch.bfloat16).to(torch.float32) @ vt
        else:
            pv = _mm(p, vt, product)
        acc = acc * corr + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).reshape(B, H, S, hd).to(q.dtype)


SHAPE = dict(B=1, H=4, KV=2, S=256, T=256, hd=64)


def _inputs(dtype, seed=3):
    s = SHAPE
    return tuple(torch.from_numpy(a).to(dtype) for a in attention_inputs(
        seed, s["B"], s["H"], s["KV"], s["S"], s["T"], s["hd"]))


def test_3xtf32_keeps_the_float32_contract_and_one_tf32_product_does_not():
    q, k, v = _inputs(torch.float32)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    tol = attention_tol(False)["atol"]
    three = emulate_flash(q, k, v, causal=True, product="3xtf32")
    one = emulate_flash(q, k, v, causal=True, product="tf32")
    torch.testing.assert_close(three, want, **attention_tol(False))
    assert (three - want).abs().max() < tol / 4
    assert (one - want).abs().max() > 10 * tol


def test_two_piece_bf16_p_keeps_the_outputs_and_one_piece_does_not():
    q, k, v = _inputs(torch.bfloat16)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    two = emulate_flash(q, k, v, causal=True, product="bf16")
    one = emulate_flash(q, k, v, causal=True, product="bf16", p_pieces=1)
    share = lambda got: float((got == want).float().mean())  # noqa: E731
    assert share(two) >= 0.99
    assert share(one) < 0.9
    torch.testing.assert_close(two.float(), want.float(),
                               **attention_tol(True))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [40, 80, 136])
def test_plain_matches_pallas_at_new_head_widths(hd, causal, bf16):
    B, H, KV, S, T = 1, 4, 2, 128, 128
    arrays = attention_inputs(hd, B, H, KV, S, T, hd)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                causal=causal, block_q=64, block_k=64,
                                interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays),
                              causal=causal)
    assert got.dtype == tdt and got.shape == (B, H, S, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **attention_tol(bf16))
