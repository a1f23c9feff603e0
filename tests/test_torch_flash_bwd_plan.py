"""The flash backward's plan and its logsumexp on the CPU, no card and no
JAX: ``flash_attention.flash_bwd_plan`` at every head width in both
dtypes (tiles, stages, shared memory within a block's 227 KB, a grid that
fills 132 SMs at the training shapes, the kernel audit's transcription
of the same plan); the plain logsumexp ``ref.flash_attention_lse_ref``
against a float64 numpy logsumexp of the masked scaled scores; the
kernel's arithmetic given that logsumexp (P = exp(s - lse), D =
rowsum(do o), dS = P (dP - D)) emulated in float64 against the plain
gradients; the plain backward, which takes the logsumexp and recomputes
the forward, bit-equal to autograd of the plain forward; and
``FlashAttention`` saving the forward's logsumexp and handing it to the
backward.

Tolerances: the logsumexp 1e-5 x (1 + |lse|) (float32 scores and sums
against float64); the emulated gradients 2e-5 x (1 + |ref|), as
tests/test_torch_train_flash_bwd.py holds the plain backward."""

import numpy as np
import pytest
import torch

from repro_torch.analysis import kernel_audit as ka
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

LSE_TOL = 1e-5
GRAD_TOL = 2e-5
#: the shapes of tests/test_torch_train_flash_bwd.py: (B, H, KV, S, T, hd,
#: causal)
SHAPES = [
    (2, 4, 4, 32, 32, 16, True),
    (2, 4, 1, 37, 37, 64, True),
    (1, 8, 1, 24, 40, 80, False),
    (2, 8, 2, 40, 24, 128, True),
    (1, 4, 4, 13, 29, 64, False),
    (2, 8, 1, 19, 19, 16, False),
]
#: an H100's SMs, and its block's shared memory at most
N_SMS, MAX_SMEM = 132, 232448


def _inputs(shape, seed=0):
    B, H, KV, S, T, hd, _ = shape
    rng = np.random.default_rng(seed + S * 7 + T + hd)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, H, S, hd), f(B, KV, T, hd), f(B, KV, T, hd), f(B, H, S, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_plan_geometry_at_every_head_width(dtype):
    bf16 = dtype == torch.bfloat16
    for hd in range(8, 257, 8):
        p = fa.flash_bwd_plan(hd, dtype)
        assert p.hdp == next(w for w in (32, 64, 128, 256) if hd <= w)
        # a warpgroup's 64 keys (dk / dv) and 64 rows (dq)
        assert (p.keys, p.q_rows) == (64, 64)
        assert p.cols == (2 if p.hdp > 128 else 1)
        assert p.threads == 128 * p.cols
        if p.hdp <= 128:
            assert p.rows >= 32 and p.q_keys >= 32, (hd, p)
        # streamed tiles divide the blocks' 64 and fill wgmma's or
        # mma.sync's steps
        for tile in (p.rows, p.q_keys):
            assert tile in (16, 32, 64) and 64 % tile == 0
            assert not bf16 or tile >= 32
        assert p.stages in (2, 3)
        assert (p.smem, p.q_smem) == fa.bwd_smem_bytes(
            p.hdp, bf16, p.rows, p.q_keys, p.stages)
        assert max(p.smem, p.q_smem) <= MAX_SMEM, (hd, p)
        # a third stage only where both passes still fit twice an SM
        three = fa.bwd_smem_bytes(p.hdp, bf16, p.rows, p.q_keys, 3)
        assert (p.stages == 3) == (max(three) <= fa.SMEM_PAIR)
        # the audit's transcription of the kernel's plan agrees
        assert (ka._bwd_rows(p.hdp, bf16), ka._bwd_qkeys(p.hdp, bf16),
                ka._bwd_cols(p.hdp), ka._bwd_stages(p.hdp, bf16)) == \
            (p.rows, p.q_keys, p.cols, p.stages)
        assert ka._bwd_smem(p.hdp, bf16, p.rows, p.q_keys, p.stages) == \
            (p.smem, p.q_smem)
    for bad in (4, 12, 264):
        with pytest.raises(ValueError):
            fa.flash_bwd_plan(bad, dtype)
    with pytest.raises(TypeError):
        fa.flash_bwd_plan(64, torch.float16)


@pytest.mark.parametrize("label,shape", ka.TRAIN_SHAPES,
                         ids=[label for label, _ in ka.TRAIN_SHAPES])
def test_grids_fill_the_card_at_the_training_shapes(label, shape):
    """Each pass that does the products has at least a block an SM: the
    dk / dv pass a block per (64-key tile, query head, b), the dq pass a
    block per (64-row tile, head, b); and the audit's launches are those
    grids."""
    B, H, S, T = (shape[x] for x in ("B", "H", "S", "T"))
    for dtype in ("float32", "bfloat16"):
        p = fa.flash_bwd_plan(shape["hd"], ka._torch_dtype(dtype))
        kv_grid = -(-T // p.keys) * H * B
        q_grid = -(-S // p.q_rows) * H * B
        assert min(kv_grid, q_grid) >= N_SMS, (label, kv_grid, q_grid)
        launches = {L.kernel: L for L in ka.launches(
            ka.case("flash_attention_bwd", dtype, **shape),
            ka.plan_args(ka.case("flash_attention_bwd", dtype, **shape),
                         N_SMS))}
        assert launches["flash_bwd_dkdv"].grid == (-(-T // p.keys), H, B)
        assert launches["flash_bwd_dq"].grid == (-(-S // p.q_rows), H, B)
        assert ("flash_bwd_sum" in launches) == (shape["H"] > shape["KV"])


def _lse64(q, k, causal):
    """logsumexp of the scaled scores in float64, over the keys the mask
    leaves (row i sees keys j <= i when causal)."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // KV, axis=1)
    s = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64), kk) * hd ** -0.5
    if causal:
        s = np.where(np.arange(S)[:, None] >= np.arange(T)[None, :], s,
                     -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("shape", SHAPES + [(1, 2, 1, 40, 24, 32, True),
                                            (1, 2, 2, 24, 40, 32, True)],
                         ids=str)
def test_plain_lse_against_a_float64_logsumexp(shape):
    q, k, _, _ = _inputs(shape)
    got = ref.flash_attention_lse_ref(torch.from_numpy(q),
                                      torch.from_numpy(k), causal=shape[-1])
    assert got.dtype == torch.float32 and got.shape == shape[:2] + \
        (shape[3],)
    want = _lse64(q, k, shape[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=LSE_TOL,
                               atol=LSE_TOL)


def _emulate(q, k, v, o, lse, do, causal):
    """The kernel's arithmetic in float64 from the forward's lse: P =
    2^(s scale log2 e - lse log2 e), D = rowsum(do o), dS = P (dP - D),
    dq = scale dS k, dk = scale dS^T q and dv = P^T do per query head,
    then dk and dv summed over each kv head's heads in head order, as the
    sum pass does."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    log2e = 1.4426950408889634
    scale = hd ** -0.5
    f = lambda t: t.double().numpy()  # noqa: E731
    q, k, v, o, lse, do = map(f, (q, k, v, o, lse, do))
    kh, vh = np.repeat(k, G, axis=1), np.repeat(v, G, axis=1)
    s = np.einsum("bhsd,bhtd->bhst", q, kh)
    p = np.exp2(s * scale * log2e - lse[..., None] * log2e)
    if causal:
        p = np.where(np.arange(S)[:, None] >= np.arange(T)[None, :], p, 0.0)
    D = (do * o).sum(-1)
    dp = np.einsum("bhsd,bhtd->bhst", do, vh)
    ds = p * (dp - D[..., None])
    dq = scale * np.einsum("bhst,bhtd->bhsd", ds, kh)
    dk_h = scale * np.einsum("bhst,bhsd->bhtd", ds, q)
    dv_h = np.einsum("bhst,bhsd->bhtd", p, do)
    dk = dk_h.reshape(B, KV, G, T, hd).sum(2)
    dv = dv_h.reshape(B, KV, G, T, hd).sum(2)
    return dq, dk, dv


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_arithmetic_from_the_lse_against_the_plain_gradients(
        shape):
    """The formulas the kernel runs, fed the plain forward's output and
    logsumexp (natural log), give the plain version's gradients: the lse
    convention and the D pass hold."""
    causal = shape[-1]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape))
    o = ref.flash_attention_ref(q, k, v, causal=causal)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"),
                          _emulate(q, k, v, o, lse, do, causal), want):
        np.testing.assert_allclose(g, w.double().numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"{name} {shape}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_given_the_lse_is_autograd_bit_for_bit(shape):
    """``ref.flash_attention_bwd_ref`` takes the logsumexp as the kernel
    does and recomputes the forward: its gradients are autograd's of the
    plain forward, the same bits as before it took the argument."""
    causal = shape[-1]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape))
    o = ref.flash_attention_ref(q, k, v, causal=causal)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*leaves, causal=causal), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the wrapper's CPU dispatch is the plain version itself
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_saves_the_lse_and_hands_it_to_the_backward(
        monkeypatch, causal):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(SHAPES[3]))
    seen = []
    real = ref.flash_attention_bwd_ref

    def spy(q_, k_, v_, o_, lse_, do_, **kw):
        seen.append((o_, lse_))
        return real(q_, k_, v_, o_, lse_, do_, **kw)

    monkeypatch.setattr(ref, "flash_attention_bwd_ref", spy)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    out = fa.flash_attention(*leaves, causal=causal)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    lse = ref.flash_attention_lse_ref(q, k, causal=causal)
    assert torch.equal(saved[3], out.detach()) and torch.equal(saved[4], lse)
    out.backward(do)
    assert len(seen) == 1
    assert torch.equal(seen[0][0], out.detach())
    assert torch.equal(seen[0][1], lse)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before
    # flash_attention_lse: the same output bits and that logsumexp
    o2, lse2 = fa.flash_attention_lse(q, k, v, causal=causal)
    assert torch.equal(o2, fa.flash_attention(q, k, v, causal=causal))
    assert torch.equal(lse2, lse)
