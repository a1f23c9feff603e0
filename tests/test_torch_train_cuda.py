"""The training path on the card: the flash backward kernel
(``csrc/flash_attention_bwd.cu``) against its plain version, bit-equal
from run to run, and a float32 train step of ``build_train_step`` against
the same step on the CPU.  Needs an NVIDIA GPU and nvcc; the module
imports neither ``jax`` nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch.steps import build_train_step, init_train_params
from repro_torch.optim import OptConfig, init_opt_state

#: the gradients' tolerance, |d| <= tol x (1 + |plain|): float32, and
#: bfloat16 (one rounding of the outputs, 2**-8 relative)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the updated parameters where |m| >= FLOOR x the tree's largest |m|,
#: |d| / (1 + |p|), the CPU differentials' tolerance and floor
PARAM_TOL, FLOOR = 1e-6, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 2, 33, 65, 64, True),
                                   (1, 8, 1, 40, 31, 128, False),
                                   (2, 6, 6, 100, 100, 8, True),
                                   (1, 4, 2, 33, 31, 256, True)], ids=str)
def test_backward_kernel_against_the_plain_version(card, dtype, shape):
    B, H, KV, S, T_, hd, causal = shape
    gen = torch.Generator(device=card).manual_seed(S + T_ + hd)
    q, k, v = (torch.randn(B, n, L, hd, generator=gen, device=card).to(dtype)
               for n, L in ((H, S), (KV, T_), (KV, T_)))
    do = torch.randn(q.shape, generator=gen, device=card).to(dtype)
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    before = fa.BWD_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpu(card):
    cfg = dataclasses.replace(get_smoke_config("yi_6b"), dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=gen)}
    out = {}
    for dev in ("cpu", "cuda"):
        step = build_train_step(cfg, opt, device=dev)
        params = init_train_params(step.cfg, 0, device="cpu")
        params = T.tree_map(lambda p: p.to(dev), params)
        out[dev] = step(params, init_opt_state(params), batch)
    assert fa.BWD_LAUNCHES > 0
    for name in ("loss", "grad_norm"):
        torch.testing.assert_close(out["cuda"][2][name].cpu(),
                                   out["cpu"][2][name], rtol=1e-5, atol=1e-5)
    # the moments against each leaf's scale, as the CPU differentials
    # hold them (tests/torch_train_cases.py)
    for name in ("m", "v"):
        for a, b in zip(T.leaves(out["cuda"][1][name]),
                        T.leaves(out["cpu"][1][name])):
            assert float((a.cpu() - b).abs().max()) <= \
                2e-5 * max(1e-6, float(b.abs().max()))
    # the parameters relatively where the gradient sets the update's sign
    # (the CPU's first moment, (1 - beta1) x the clipped gradient, at
    # least FLOOR x its largest |value|), as the CPU differentials hold
    # them to the reference; elsewhere a gradient of float32 noise moves
    # an element by up to lr either way, so only the update's bound 2 lr
    m_cpu = T.leaves(out["cpu"][1]["m"])
    mmax = max(float(m.abs().max()) for m in m_cpu)
    for a, b, m in zip(T.leaves(out["cuda"][0]), T.leaves(out["cpu"][0]),
                       m_cpu):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2 * opt.lr
        keep = m.abs() >= FLOOR * mmax
        if keep.any():
            assert float((d[keep] / (1 + b.abs()[keep])).max()) \
                <= PARAM_TOL
