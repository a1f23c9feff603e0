"""The port's kernel-benchmark kernels against the JAX reference: the
unmasked re-id top-k, flash attention, decode attention and the Mamba
scan, and the port's kernel benchmark (``repro_torch.benchmarks``).

On the CPU the wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``); each is held to the Pallas kernel in
interpret mode (``repro.kernels.ops``) on the same numpy-drawn inputs:
top-k scores within 1e-5 and indices exact, attention within 2e-5 in
float32 and 2e-2 in bfloat16, the scan within 1e-4.  Where
``repro.kernels.ref`` departs from the Pallas kernel (decode at
``length <= 0``, top-k with k > G) the port follows the kernel, and the
tests pin both.  The CUDA kernels run only on a card:
``test_torch_cuda.py`` holds them to the plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.benchmarks import kernels_bench
from repro_torch.kernels import (decode_attention, flash_attention,
                                 mamba_scan, ops, reid_topk)
from torch_cases import (DECODE_CASES, FLASH_CASES, SCAN_CASES, TOPK_CASES,
                         attention_inputs, attention_tol, scan_inputs,
                         topk_inputs)


def _both(arrays, bf16=False):
    """The same float32 numpy arrays as jax and torch tensors, both rounded
    to bfloat16 (to nearest even) when asked."""
    jx = tuple(jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
               for a in arrays)
    tx = tuple(torch.from_numpy(a).to(torch.bfloat16 if bf16
                                      else torch.float32) for a in arrays)
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("Q,G,D,k,ties", TOPK_CASES)
def test_reid_topk_plain_matches_pallas(Q, G, D, k, ties):
    q, g = topk_inputs(Q * 100 + G, Q, G, D, ties)
    jv, ji = jops.reid_topk(jnp.asarray(q), jnp.asarray(g), k,
                            interpret=True)
    pv, pi = ops.reid_topk(torch.from_numpy(q), torch.from_numpy(g), k)
    assert pv.shape == (Q, k) and pv.dtype == torch.float32
    assert pi.dtype == torch.int32
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    real = pi.numpy() >= 0
    got = np.take_along_axis(q @ g.T, np.where(real, pi.numpy(), 0), 1)
    np.testing.assert_allclose(got[real], pv.numpy()[real], rtol=1e-5,
                               atol=1e-5)


def test_reid_topk_k_past_gallery_follows_pallas_tail():
    """k > G: the Pallas kernel (and the port) give G real slots and then
    (NEG_INF, -1); ``repro.kernels.ref.reid_topk_ref`` has no tail — its
    ``lax.top_k`` refuses k > G."""
    q, g = topk_inputs(5, 5, 3, 16)
    pv, pi = ops.reid_topk(torch.from_numpy(q), torch.from_numpy(g), 8)
    jv, ji = jops.reid_topk(jnp.asarray(q), jnp.asarray(g), 8,
                            interpret=True)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    assert (pi.numpy()[:, 3:] == -1).all()
    assert (pv.numpy()[:, 3:] < -1e29).all()
    with pytest.raises(ValueError, match="top_k"):
        jref.reid_topk_ref(jnp.asarray(q), jnp.asarray(g), 8)


@pytest.mark.parametrize("Q,G", [(0, 12), (4, 0)])
def test_reid_topk_empty_gives_sentinels(Q, G):
    q, g = topk_inputs(1, Q, G, 8)
    before = reid_topk.UNMASKED_LAUNCHES
    pv, pi = ops.reid_topk(torch.from_numpy(q), torch.from_numpy(g), 3)
    jv, ji = jops.reid_topk(jnp.asarray(q), jnp.asarray(g), 3,
                            interpret=True)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert pv.shape == (Q, 3) and reid_topk.UNMASKED_LAUNCHES == before


def test_reid_topk_scores_any_float_in_float32():
    q, g = topk_inputs(2, 6, 40, 8)
    a = ops.reid_topk(torch.from_numpy(q).double(),
                      torch.from_numpy(g).double(), 4)
    b = ops.reid_topk(torch.from_numpy(q), torch.from_numpy(g), 4)
    assert a[0].dtype == torch.float32
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="k="):
        ops.reid_topk(torch.from_numpy(q), torch.from_numpy(g), 17)


@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,bf16", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(B, H, KV, S, T, hd, causal,
                                              bf16):
    (jq, jk, jv), (tq, tk, tv) = _both(
        attention_inputs(S + T + hd, B, H, KV, S, T, hd), bf16)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, hd)
    np.testing.assert_allclose(_np(got), _np(want), **attention_tol(bf16))


@pytest.mark.parametrize("B,H,KV,T,hd,bf16", DECODE_CASES)
def test_decode_attention_plain_matches_pallas(B, H, KV, T, hd, bf16):
    (jq, jk, jv), (tq, tk, tv) = _both(
        attention_inputs(T + hd, B, H, KV, 0, T, hd), bf16)
    length = np.random.default_rng(T).integers(1, T + 1, B).astype(np.int32)
    length[0] = T
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(length),
                                 block_k=128, interpret=True)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(length))
    assert got.dtype == tq.dtype and got.shape == (B, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), **attention_tol(bf16))


def test_decode_attention_zero_length_is_zeros_as_pallas():
    """A row with ``length <= 0``: the Pallas kernel skips every tile and
    gives zeros, and so does the port; ``repro.kernels.ref``'s softmax over
    an all-masked row gives the mean of V instead."""
    B, H, KV, T, hd = 3, 4, 2, 256, 32
    (jq, jk, jv), (tq, tk, tv) = _both(
        attention_inputs(9, B, H, KV, 0, T, hd))
    length = np.array([0, 100, -3], np.int32)
    want = _np(jops.decode_attention(jq, jk, jv, jnp.asarray(length),
                                     block_k=128, interpret=True))
    got = _np(ops.decode_attention(tq, tk, tv, torch.from_numpy(length)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert (got[0] == 0).all() and (got[2] == 0).all()
    mean_v = _np(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(length)))
    v_mean = np.repeat(_np(jv).mean(axis=2), H // KV, axis=1)
    np.testing.assert_allclose(mean_v[0], v_mean[0], rtol=1e-5, atol=1e-5)
    assert np.abs(mean_v[0]).max() > 1e-3


@pytest.mark.parametrize("B,L,D,N", SCAN_CASES)
def test_mamba_scan_plain_matches_pallas(B, L, D, N):
    arrays = scan_inputs(L + D + N, B, L, D, N)
    want = jops.mamba_scan(*(jnp.asarray(a) for a in arrays),
                           chunk=min(64, L), block_d=min(32, D),
                           interpret=True)
    got = ops.mamba_scan(*(torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.float32 and got.shape == (B, L, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the step-by-step plain version equals the JAX step-by-step oracle
    y, h = ops.ref.mamba_scan_ref(*(torch.from_numpy(a) for a in arrays),
                                  torch.zeros((B, D, N)))
    jy, jh = jref.mamba_scan_ref(*(jnp.asarray(a) for a in arrays),
                                 jnp.zeros((B, D, N)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_refuse_a_device_without_a_kernel():
    meta = torch.device("meta")
    q, k, v = (torch.empty(s, device=meta) for s in
               ((1, 2, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)))
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_attention(torch.empty((1, 2, 32), device=meta), k, v,
                             torch.ones(1, dtype=torch.int32, device=meta))
    u = torch.empty((1, 8, 4), device=meta)
    b = torch.empty((1, 8, 4), device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        ops.mamba_scan(u, u, b, b, torch.empty((4, 4), device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        ops.reid_topk(torch.empty((2, 8), device=meta),
                      torch.empty((3, 8), device=meta), 2)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(torch.zeros(1, 3, 8, 32), torch.zeros(1, 2, 8, 32),
                            torch.zeros(1, 2, 8, 32))
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(torch.zeros(1, 2, 8, 32),
                            torch.zeros(1, 2, 8, 32).double(),
                            torch.zeros(1, 2, 8, 32))


def test_plain_path_counts_no_launch(monkeypatch):
    before = (reid_topk.UNMASKED_LAUNCHES, flash_attention.LAUNCHES,
              decode_attention.LAUNCHES, mamba_scan.LAUNCHES)
    monkeypatch.setattr(kernels_bench, "SHAPES", {
        "reid_topk": dict(Q=5, G=40, D=8, k=3),
        "flash_attention": dict(B=1, H=2, KV=1, S=16, T=16, hd=8,
                                causal=True),
        "decode_attention": dict(B=2, H=2, KV=1, T=64, hd=8,
                                 length="random"),
        "mamba_scan": dict(B=1, L=16, D=8, N=4)})
    rows = kernels_bench.run("cpu")
    assert len(rows) == 4
    assert before == (reid_topk.UNMASKED_LAUNCHES, flash_attention.LAUNCHES,
                      decode_attention.LAUNCHES, mamba_scan.LAUNCHES)


def test_kernel_bench_on_the_cpu_at_its_shapes():
    record = {}
    rows = kernels_bench.run("cpu", record=record)
    assert [r[0] for r in rows] == [
        "kernels/reid_topk", "kernels/flash_attention",
        "kernels/decode_attention", "kernels/mamba_scan"]
    for (name, us, derived), kernel in zip(rows, kernels_bench.SHAPES):
        fields = dict(f.split("=") for f in derived.split(";"))
        assert us > 0 and float(fields["plain_us"]) > 0
        assert fields["device"] == "cpu" and fields["clock"] == "host"
        assert fields["bound_by"] in ("bytes", "operations")
        flops, nbytes = kernels_bench.cost(kernel, *record[kernel][:2])
        peak = kernels_bench.peak_flops(kernel, record[kernel][0])
        assert float(fields["peak"]) == pytest.approx(peak, rel=1e-3)
        b_ms, by = kernels_bench.bound_ms(flops, nbytes, peak)
        assert fields["bound_by"] == by
        assert float(fields["bound_us"]) == pytest.approx(b_ms * 1e3,
                                                          rel=1e-2)
        args, kwargs, out = record[kernel]
        want = kernels_bench.plain(kernel)(*args, **kwargs)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)
    # the bounds the JAX benchmark's shapes give (3.35 TB/s; fp32 at
    # 67 TFLOP/s for the re-id top-k and the scan, attention in float32 at
    # 165 TFLOP/s, 3xTF32 on the tensor cores): reid_topk 4.0 us, causal
    # flash 6.51 us (16.04 us at 67 TFLOP/s), decode 10.0 us (the cache),
    # mamba 0.98 us (bytes)
    bounds = {r[0]: float(dict(f.split("=") for f in r[2].split(";"))
                          ["bound_us"]) for r in rows}
    assert bounds == pytest.approx({
        "kernels/reid_topk": 4.01, "kernels/flash_attention": 6.51,
        "kernels/decode_attention": 10.02, "kernels/mamba_scan": 0.98},
        rel=1e-2)
    flops, nbytes = kernels_bench.cost("flash_attention",
                                       *record["flash_attention"][:2])
    assert kernels_bench.bound_ms(flops, nbytes)[0] * 1e3 == \
        pytest.approx(16.04, rel=1e-2)
    bf16 = tuple(a.to(torch.bfloat16) for a in record["flash_attention"][0])
    assert kernels_bench.peak_flops("flash_attention", bf16) == 989e12
    assert kernels_bench.peak_flops("reid_topk", record["reid_topk"][0]) \
        == kernels_bench.peak_flops("mamba_scan", record["mamba_scan"][0]) \
        == 67e12


def test_kernel_bench_cli_prints_the_runners_csv(capsys, monkeypatch):
    monkeypatch.setattr(kernels_bench, "SHAPES", {
        "mamba_scan": dict(B=1, L=8, D=8, N=4)})
    kernels_bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    name, us, derived = lines[1].split(",")
    assert name == "kernels/mamba_scan" and float(us) > 0
    assert "plain_us=" in derived and "clock=host" in derived


def test_kernel_bench_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernels_bench.run()
