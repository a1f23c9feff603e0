"""The launch-bounds audit on the card: each source's exported
``<symbol>_plan_ok`` (the launcher's own guard, compiled) answers as the
Python mirror ``kernel_audit.launcher_accepts`` does, on the planners'
plans and their perturbations, and a guarded launch of each kernel leaves
its guard bands and inputs untouched.  Needs an NVIDIA GPU and nvcc; the
module imports neither ``jax`` nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_audit_cuda.py
"""
import pytest
import torch

from repro_torch.analysis import kernel_audit as ka


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ka.KERNELS)
def test_compiled_guard_agrees_with_the_mirror(card, kernel):
    cases = [ka.routed(c) for c in ka.sweep()
             if c.kernel == kernel and ka.launches_at_all(c)]
    for c in cases[::5]:
        args = ka.plan_args(c, card)
        assert ka.compiled_accepts(c.kernel, args), str(c)
        for label, a in ka.perturbations(c.kernel, args):
            assert ka.compiled_accepts(c.kernel, a) == \
                ka.launcher_accepts(c.kernel, a), (str(c), label)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ka.KERNELS)
def test_guarded_launch_keeps_its_bounds(card, kernel):
    for c in ka.guard_band_cases()[kernel][:3]:
        r = ka.guard_band_run(c, "cuda", seed=0)
        assert (r["guard_bytes"], r["input_bytes"], r["counters_left"]) == \
            (0, 0, 0), str(c)
        for got, want in zip(r["outputs"], r["plain"]):
            if got.dtype == torch.int32:
                assert torch.equal(got, want), str(c)
            else:
                tol = 2e-2 if got.dtype == torch.bfloat16 else 1e-4
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
