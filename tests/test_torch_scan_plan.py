"""The Mamba scan kernel's launch plan and its association order, held on
the CPU.

``mamba_scan.scan_plan`` chooses the geometry of ``csrc/mamba_scan.cu``:
lanes a channel and entries a lane, warps a block, the chunk, the tiles
of the state axis and the segments of L.  Here the plan's properties are
checked against the kernel's index arithmetic, written out below, and
``ref.mamba_scan_chunked`` (each chunk scanned from zero, then composed
with the carry, as the kernel's segments are) is held to the step-by-step
plain version, to the JAX model's chunked scan and to the Pallas kernel
in interpret mode.  The
kernel itself runs only on a card (``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.ssm import _mamba1_scan_chunked
from repro_torch.kernels import mamba_scan, ops, ref
from torch_cases import scan_inputs

H100_SMS = 132
FALCON = (1, 4096, 8192, 16)       # falcon-mamba-7b's d_inner, N, 4,096 steps
BENCH = (1, 1024, 256, 16)         # the kernel benchmark's shape


def _cover(plan, B, L, D, N):
    """How often the kernel's blocks and threads touch each (b, d)
    channel, (b, t) step and (d, n) entry: counts from the index
    arithmetic of ``scan_kernel`` (block -> (b, segment, channel block),
    thread -> (channel, entry lane))."""
    cw = 32 // plan.nl
    db, np_ = plan.warps * cw, plan.nl * plan.eg
    ndb = -(-D // db)
    chans = np.zeros((B, D), np.int64)
    steps = np.zeros((B, L), np.int64)
    entries = np.zeros((D, N), np.int64)
    for x in range(plan.blocks):
        dblk, seg, b = x % ndb, x // ndb % plan.segments, \
            x // ndb // plan.segments
        t0, t1 = seg * plan.seg_len, min(L, (seg + 1) * plan.seg_len)
        assert b < B and t0 < t1
        steps[b, t0:t1] += 1
        for thread in range(plan.threads):
            lane, warp = thread % 32, thread // 32
            d = dblk * db + warp * cw + lane // plan.nl
            if d >= D:
                continue
            if lane % plan.nl == 0:
                chans[b, d] += 1
            if b == 0 and seg == 0:
                for tile in range(plan.tiles):
                    n0 = tile * np_ + lane % plan.nl * plan.eg
                    n = np.arange(n0, min(N, n0 + plan.eg))
                    entries[d, n] += 1
    return chans, steps, entries


@pytest.mark.parametrize("B,L,D,N,n_sms", [
    (1, 1024, 256, 16, 132), (2, 300, 65, 3, 132), (3, 77, 33, 17, 4),
    (1, 1, 1, 1, 132), (2, 129, 64, 64, 132), (1, 40, 40, 300, 8),
    (4, 513, 100, 8, 16), (1, 200, 63, 1, 132)])
def test_scan_plan_covers_every_channel_step_and_entry_once(B, L, D, N,
                                                            n_sms):
    plan = mamba_scan.scan_plan(B, L, D, N, n_sms)
    chans, steps, entries = _cover(plan, B, L, D, N)
    # each (b, d) channel is one channel-lane group in every segment, each
    # step in one segment, each entry on one lane
    assert (chans == plan.segments).all()
    assert (steps == -(-D // (plan.warps * 32 // plan.nl))).all()
    assert (entries == 1).all()
    assert plan.seg_len % plan.chunk == 0
    assert plan.chunk % mamba_scan.GROUP == 0
    assert (plan.segments - 1) * plan.seg_len < L <= plan.segments \
        * plan.seg_len
    assert plan.passes == (1 if plan.segments == 1 else 3)


@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 8, 16, 17, 32, 33, 64, 100,
                               128, 200, 255, 256])
@pytest.mark.parametrize("B,L,D", [(1, 4096, 8192), (1, 1024, 256),
                                   (2, 33, 65), (65536, 1, 1)])
def test_scan_plan_shared_memory_fits_for_any_state_size(B, L, D, N):
    plan = mamba_scan.scan_plan(B, L, D, N, H100_SMS)
    assert plan.smem <= mamba_scan.SMEM_BUDGET <= mamba_scan.MAX_SMEM
    assert plan.smem == mamba_scan.smem_bytes(plan.nl, plan.eg, plan.warps,
                                              plan.chunk)
    assert plan.tiles == -(-N // (plan.nl * plan.eg))
    assert N <= 256 or plan.tiles > 1
    if N <= 256:
        assert plan.tiles == 1      # the state stays in registers


@pytest.mark.parametrize("shape", [(65536, 1, 1, 1), FALCON,
                                   (65536, 8, 64, 16),
                                   (1, 4096, 2560 * 2, 64)])
def test_scan_plan_grid_stays_within_its_limits(shape):
    """One grid dimension holds every block, B folded in; no dimension
    holds B alone, so B past 65,535 launches."""
    plan = mamba_scan.scan_plan(*shape, H100_SMS)
    assert 1 <= plan.blocks <= mamba_scan.INT_MAX
    assert plan.threads <= 32 * mamba_scan.MAX_WARPS <= 1024
    assert plan.blocks >= shape[0]


def test_scan_plan_weighs_one_pass_against_segments():
    """falcon-mamba-7b's width fills the card in one pass (every input read
    once, one exp a step and entry) with at least a block an SM; the
    benchmark's 256 channels do not, and L is cut into segments."""
    falcon = mamba_scan.scan_plan(*FALCON, H100_SMS)
    assert falcon.passes == 1 and falcon.blocks >= H100_SMS
    bench = mamba_scan.scan_plan(*BENCH, H100_SMS)
    assert bench.passes == 3 and bench.blocks >= H100_SMS


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("N", [1, 3, 17])
@pytest.mark.parametrize("L,chunk", [(37, 8), (40, 40), (33, 32), (50, 7),
                                     (5, 16)])
def test_chunked_scan_matches_the_step_by_step_plain_version(N, L, chunk):
    B, D = 2, 6
    u, dt, Bm, Cm, A = _torch(scan_inputs(L * N + chunk, B, L, D, N))
    h0 = torch.from_numpy(np.random.default_rng(N).normal(
        size=(B, D, N)).astype(np.float32))
    want_y, want_h = ref.mamba_scan_ref(u, dt, Bm, Cm, A, h0)
    y, h = ref.mamba_scan_chunked(u, dt, Bm, Cm, A, h0, chunk)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L,D,N,chunk", [
    (2, 32, 8, 4, 8), (1, 48, 5, 16, 16), (2, 20, 3, 3, 4)])
def test_chunked_scan_matches_the_jax_model_chunked_scan(B, L, D, N, chunk):
    arrays = scan_inputs(B + L + N, B, L, D, N)
    h0 = np.random.default_rng(L).normal(size=(B, D, N)).astype(np.float32)
    jy, jh = _mamba1_scan_chunked(*(jnp.asarray(a) for a in arrays),
                                  jnp.asarray(h0), chunk)
    y, h = ref.mamba_scan_chunked(*_torch(arrays), torch.from_numpy(h0),
                                  chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,L,D,N,chunk,block_d", [(1, 32, 16, 3, 16, 8),
                                                   (2, 24, 8, 17, 8, 8)])
def test_chunked_scan_matches_the_pallas_kernel(B, L, D, N, chunk, block_d):
    arrays = scan_inputs(D + N, B, L, D, N)
    want = jops.mamba_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                           block_d=block_d, interpret=True)
    y, _ = ref.mamba_scan_chunked(*_torch(arrays), torch.zeros((B, D, N)),
                                  chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("N", [3, 64])
def test_wrapper_on_the_cpu_takes_any_state_size(N):
    """The kernel once took N of 4, 8 or 16 only; the wrapper's CPU path
    (the plain version) agrees with the Pallas kernel at N = 3 and 64."""
    B, L, D = 1, 16, 8
    arrays = scan_inputs(N, B, L, D, N)
    want = jops.mamba_scan(*(jnp.asarray(a) for a in arrays), chunk=8,
                           block_d=8, interpret=True)
    got = ops.mamba_scan(*_torch(arrays))
    assert got.shape == (B, L, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
