"""Five CUDA kernels have no backward, so their wrappers refuse gradients;
flash attention has one, so its wrapper passes them.

``kernels.build.refuse_grad`` raises ``RuntimeError`` under grad mode when
an input requires grad.  Each of the five wrappers without a backward
calls it on its non-CPU path, after the CPU branch and before anything is
allocated or launched: on ``meta`` tensors (whose checks read no values)
an input that requires grad stops at the guard, and under
``torch.no_grad()`` the same call goes past it to the device check.
Flash attention under grad goes through its ``torch.autograd.Function``
(``flash_attention.FlashAttention``) instead, never reaches the guard,
and on ``meta`` stops at the device check, launching nothing.  The CPU
path is unchanged: the plain versions are torch ops and pass gradients.
The card half (a raise for a CUDA input, or flash's gradient against the
plain version's; bit-equal output under ``no_grad``) is
``chip_smoke.py``'s phase 22 and the ``cuda`` test below."""
import pytest
import torch

from repro_torch.kernels import (build, decode_attention, flash_attention,
                                 mamba_scan, ops, reid_topk)


def _t(device, *shape, dtype=torch.float32, grad=False, fill=None):
    if device == "meta":
        t = torch.empty(shape, dtype=dtype, device=device)
    elif fill is not None:
        t = torch.full(shape, fill, dtype=dtype, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(sum(shape))
        t = torch.randn(shape, generator=gen, device=device).to(dtype)
    return t.requires_grad_(grad) if dtype.is_floating_point else t


def _calls(device, grad):
    """kernel name -> (a call of its wrapper on small inputs, its launch
    counter)."""
    f = dict(grad=grad)
    i32 = dict(dtype=torch.int32)

    def tags(n):
        return _t(device, n, **i32, fill=0)

    admit = _t(device, 3, 4, dtype=torch.bool, fill=True)
    return {
        "flash_attention": (
            lambda: ops.flash_attention(_t(device, 1, 2, 8, 16, **f),
                                        _t(device, 1, 1, 8, 16, **f),
                                        _t(device, 1, 1, 8, 16, **f)),
            lambda: flash_attention.LAUNCHES),
        "decode_attention": (
            lambda: ops.decode_attention(_t(device, 1, 2, 16, **f),
                                         _t(device, 1, 1, 8, 16, **f),
                                         _t(device, 1, 1, 8, 16, **f),
                                         _t(device, 1, **i32, fill=8)),
            lambda: decode_attention.LAUNCHES),
        "mamba_scan": (
            lambda: ops.mamba_scan(_t(device, 1, 8, 4, **f),
                                   _t(device, 1, 8, 4, **f),
                                   _t(device, 1, 8, 2, **f),
                                   _t(device, 1, 8, 2, **f),
                                   _t(device, 4, 2, **f)),
            lambda: mamba_scan.LAUNCHES),
        "reid_topk_segment_masked": (
            lambda: ops.reid_topk_segments(_t(device, 3, 8, **f), tags(3),
                                           admit, _t(device, 5, 8, **f),
                                           tags(5), tags(5), 2),
            lambda: reid_topk.LAUNCHES),
        "reid_topk_tiles": (
            lambda: ops.reid_topk_tiles(_t(device, 3, 8, **f), tags(3),
                                        admit, _t(device, 5, 8, **f),
                                        tags(5), tags(5), 2),
            lambda: reid_topk.TILE_LAUNCHES),
        "reid_topk": (
            lambda: ops.reid_topk(_t(device, 3, 8, **f),
                                  _t(device, 5, 8, **f), 2),
            lambda: reid_topk.UNMASKED_LAUNCHES),
    }


KERNELS = sorted(_calls("cpu", False))
#: the one wrapper with a backward kernel
WITH_BACKWARD = "flash_attention"


def test_six_wrappers():
    """Six wrappers; flash's under grad is ``FlashAttention``'s output."""
    assert len(KERNELS) == 6 and WITH_BACKWARD in KERNELS
    call, _ = _calls("cpu", True)[WITH_BACKWARD]
    out = call()
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert call().grad_fn is None


def test_refuse_grad_raises_under_grad_mode():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match=r"^some_kernel: .*no backward"):
        build.refuse_grad("some_kernel", torch.ones(2), x)


def test_refuse_grad_quiet_under_no_grad():
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        build.refuse_grad("some_kernel", x)


def test_refuse_grad_quiet_without_an_input_that_requires_grad():
    build.refuse_grad("some_kernel", torch.ones(3),
                      torch.ones(3, requires_grad=True).detach())


def test_refuse_grad_quiet_with_grad_mode_off_globally():
    x = torch.ones(3, requires_grad=True)
    with torch.set_grad_enabled(False):
        build.refuse_grad("some_kernel", x)
    with torch.inference_mode():
        build.refuse_grad("some_kernel", x)


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_refuses_grad_on_its_device_path(name):
    """An input that requires grad stops at the guard, named, and nothing
    launches; flash's goes through its autograd Function to the device
    check (``meta`` has no kernel), and nothing launches."""
    call, launches = _calls("meta", True)[name]
    before = launches()
    if name == WITH_BACKWARD:
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
    else:
        with pytest.raises(RuntimeError, match=rf"^{name}: .*no backward"):
            call()
    assert launches() == before


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_goes_past_the_guard_without_grad(name):
    """Under ``no_grad``, and on inputs that need no grad, the call passes
    the guard and stops only at the device check (``meta`` has no
    kernel)."""
    for grad, ctx in ((True, torch.no_grad), (False, torch.enable_grad)):
        call, launches = _calls("meta", grad)[name]
        with ctx(), pytest.raises(ValueError, match="no kernel for device"):
            call()


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_calls_the_guard_with_its_name(name, monkeypatch):
    seen = []

    def record(kernel, *tensors):
        seen.append(kernel)
        raise LookupError("guard reached")

    monkeypatch.setattr(build, "refuse_grad", record)
    if name == WITH_BACKWARD:
        # flash has a backward and no longer calls the guard, under grad
        # or not
        for grad in (True, False):
            call, _ = _calls("meta", grad)[name]
            with pytest.raises(ValueError, match="no kernel for device"):
                call()
        assert seen == []
        return
    call, _ = _calls("meta", False)[name]
    with pytest.raises(LookupError, match="guard reached"):
        call()
    assert seen == [name]


@pytest.mark.parametrize("name", KERNELS)
def test_cpu_path_does_not_reach_the_guard(name, monkeypatch):
    def boom(kernel, *tensors):
        raise AssertionError(f"{kernel}: the CPU path reached the guard")

    monkeypatch.setattr(build, "refuse_grad", boom)
    call, _ = _calls("cpu", True)[name]
    call()


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "mamba_scan"])
def test_cpu_plain_versions_pass_gradients(name):
    """On the CPU the plain versions run, under grad, and their inputs get
    a gradient; the output equals the one of detached inputs."""
    call, _ = _calls("cpu", True)[name]
    out = call()
    out = out[0] if isinstance(out, tuple) else out
    assert out.requires_grad
    out.float().sum().backward()
    call_plain, _ = _calls("cpu", False)[name]
    ref = call_plain()
    ref = ref[0] if isinstance(ref, tuple) else ref
    assert torch.equal(out.detach(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_cuda_wrapper_refuses_grad_and_no_grad_is_bit_equal(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    call, launches = _calls("cuda", True)[name]
    before = launches()
    if name == WITH_BACKWARD:
        from repro_torch.kernels import ref

        # through FlashAttention: one forward launch, one backward launch,
        # the gradients those of the plain version
        q, k, v = (_t("cuda", 1, h, 8, 16, grad=True) for h in (2, 1, 1))
        out = flash_attention.flash_attention(q, k, v)
        bwd = flash_attention.BWD_LAUNCHES
        do = torch.randn_like(out)
        out.backward(do)
        assert flash_attention.BWD_LAUNCHES == bwd + 1
        want = ref.flash_attention_bwd_ref(
            q, k, v, out.detach(), ref.flash_attention_lse_ref(q, k), do)
        for got_g, want_g in zip((q.grad, k.grad, v.grad), want):
            torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-5)
        n = launches()
        with torch.no_grad():
            assert torch.equal(flash_attention.flash_attention(q, k, v), out)
        assert launches() == n + 1
        before = launches()
    else:
        with pytest.raises(RuntimeError, match=rf"^{name}: .*no backward"):
            call()
    assert launches() == before
    with torch.no_grad():
        got = call()
    plain, _ = _calls("cuda", False)[name]
    want = plain()
    torch.cuda.synchronize()
    assert launches() == before + 2
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
