"""The design of the decode-attention CUDA kernel, on the CPU.

``csrc/decode_attention.cu`` runs only on a card; what can be held here is
held here: the plan it is launched with (``decode_plan``), that the plan's
blocks cover every (row, q head, key < length) exactly once, that its
shared memory, registers and grid fit the card for every head width and
group size the kernel takes, the wrapper's rule on head widths, and the
kernel's arithmetic (scores in log2 units, a running softmax per warp over
tiles dealt in turn, warps merged, splits combined by their common max)
through ``ref.decode_attention_split``, which is held to the plain version
and to the Pallas kernel (interpret mode) at head widths and group sizes
the first CUDA kernel refused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.benchmarks import decode_plans
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref
from torch_cases import attention_inputs, attention_tol

HEAD_DIMS = range(8, 257, 8)
DTYPES = (torch.float32, torch.bfloat16)
GROUPS = (1, 4, 8, 12, 40, 64)
H100_SMS = 132


def _covered(plan, B, H, KV, T, length):
    """(B, H, T) count of the blocks of ``plan`` that score each key."""
    b, h0, nh, a0, a1 = da.block_work(plan, B, H, KV, T, length)
    n = nh * (a1 - a0)
    blk = torch.repeat_interleave(torch.arange(len(b)), n)
    off = torch.arange(int(n.sum())) - torch.repeat_interleave(n.cumsum(0)
                                                                - n, n)
    h = h0[blk] + off % nh[blk]
    t = a0[blk] + off // nh[blk]
    count = torch.zeros(B * H * T, dtype=torch.int64)
    count.index_add_(0, (b[blk] * H + h) * T + t, torch.ones_like(t))
    return count.reshape(B, H, T)


@pytest.mark.parametrize("B,H,KV,T,dtype", [
    (4, 8, 2, 8192, torch.float32),          # the benchmark's shape
    (5, 8, 2, 700, torch.bfloat16),          # T off the tile
    (3, 40, 1, 333, torch.float32),          # five groups of 8 heads
    (2, 12, 1, 1, torch.bfloat16),           # T = 1, a partial group
    (7, 32, 32, 129, torch.bfloat16),        # MHA
    (65536, 2, 1, 3, torch.float32),         # a batch past the old grid
])
def test_decode_plan_covers_every_key_once(B, H, KV, T, dtype):
    rng = np.random.default_rng(B + T)
    lengths = rng.integers(0, T + 6, B)
    lengths[:4] = [0, 1, T, T + 5][:B] if B >= 4 else lengths[:4]
    length = torch.from_numpy(lengths)
    item = 2 if dtype == torch.bfloat16 else 4
    few = 8 if item == 2 else 1      # bfloat16 blocks take 8 heads
    for plan in (da.decode_plan(B, H, KV, T, 64, dtype, H100_SMS),
                 da.make_plan(B, H, KV, T, 64, dtype, heads=few,
                              tile=da.score_keys(64, few, item), split=37),
                 da.make_plan(B, H, KV, T, 64, dtype, heads=8,
                              tile=2 * da.score_keys(64, 8, item),
                              split=T + 3)):
        want = (torch.arange(T)[None, None, :]
                < length.clamp(0, T)[:, None, None]).expand(B, H, T)
        assert torch.equal(_covered(plan, B, H, KV, T, length),
                           want.to(torch.int64)), plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_decode_plan_fits_the_card(hd, dtype):
    item = 2 if dtype == torch.bfloat16 else 4
    for G in GROUPS:
        plan = da.decode_plan(8, 4 * G, 4, 32768, hd, dtype, H100_SMS)
        unit = 16 if dtype == torch.bfloat16 else 32    # an mma's K
        assert plan.hdp % unit == 0 and hd <= plan.hdp < hd + unit
        assert plan.heads in (1, 2, 4, 8)
        assert plan.heads >= min(G, da.MAX_HEADS)
        assert dtype == torch.float32 or plan.heads == 8   # mma's N
        assert plan.groups == -(-G // plan.heads)
        assert plan.warps in da.WARPS and plan.stages == da.STAGES == 3
        sk = da.score_keys(plan.hdp, plan.heads, item)
        assert plan.tile % sk == 0 and plan.tile >= sk
        assert plan.split % (plan.warps * plan.tile) == 0
        assert plan.smem == da.smem_bytes(plan.hdp, item, plan.heads,
                                          plan.tile, plan.warps)
        assert plan.smem <= da.MAX_SMEM
        # q, the accumulator and the partial scores within the 255
        # registers a thread, with room for the rest
        assert plan.regs <= 160


def test_decode_make_plan_refuses_what_the_launcher_refuses():
    """``plan_ok`` in the .cu refuses these; ``make_plan`` raises first."""
    good = dict(heads=8, tile=4, split=64)
    assert da.make_plan(2, 8, 1, 700, 128, torch.float32, **good).splits == 11
    for bad in (dict(good, heads=3), dict(good, tile=3), dict(good, tile=0),
                dict(good, split=0), dict(good, split=2),   # 350 splits
                dict(good, warps=2), dict(good, warps=16)):
        with pytest.raises(ValueError, match="no such plan"):
            da.make_plan(2, 8, 1, 700, 128, torch.float32, **bad)
    # bfloat16: 8 heads (mma's N) and whole 16-key blocks
    assert da.make_plan(2, 8, 1, 700, 128, torch.bfloat16, heads=8, tile=16,
                        split=64).hdp == 128
    for bad in (dict(heads=4, tile=16), dict(heads=8, tile=8)):
        with pytest.raises(ValueError, match="no such plan"):
            da.make_plan(2, 8, 1, 700, 128, torch.bfloat16, split=64, **bad)


@pytest.mark.parametrize("B,T", [(1, 1), (4, 8192), (128, 32768),
                                 (65536, 5), (1, 2 ** 31 - 1),
                                 (65536, 2 ** 20)])
def test_decode_plan_grid_stays_within_its_limits(B, T):
    for H, KV, hd, dtype in ((8, 2, 64, torch.float32),
                             (32, 4, 128, torch.bfloat16),
                             (32, 32, 80, torch.bfloat16),
                             (40, 1, 256, torch.float32)):
        plan = da.decode_plan(B, H, KV, T, hd, dtype, H100_SMS)
        assert plan.blocks == B * KV * plan.groups * plan.splits
        assert plan.blocks <= da.INT_MAX
        assert 1 <= plan.splits <= da.MAX_SPLITS
        assert plan.split * plan.splits >= T > plan.split * (plan.splits - 1)
    # small grids split the cache finely, large ones into splits of
    # SPLIT_KEYS keys; blocks take 8 warps where their rings fit
    small = da.decode_plan(4, 8, 2, 8192, 64, torch.float32, H100_SMS)
    assert small.splits > 8 and small.warps == 8
    large = da.decode_plan(128, 32, 4, 32768, 128, torch.bfloat16, H100_SMS)
    assert large.split == da.SPLIT_KEYS and large.warps == 8
    wide = da.decode_plan(128, 32, 4, 32768, 256, torch.bfloat16, H100_SMS)
    assert wide.warps == 4


def _decode_inputs(B, H, KV, T, hd, seed):
    q, k, v = (torch.from_numpy(a) for a in
               attention_inputs(seed, B, H, KV, 0, T, hd))
    length = torch.tensor([0, 1, T // 2, T, T + 5][:B])
    return q, k, v, length


@pytest.mark.parametrize("B,H,KV,T,hd", [
    (5, 8, 2, 700, 64), (5, 40, 1, 300, 40), (4, 4, 4, 129, 136),
    (5, 12, 1, 77, 8), (3, 32, 32, 200, 80), (2, 16, 2, 1, 256)])
def test_decode_split_equals_plain(B, H, KV, T, hd):
    q, k, v, length = _decode_inputs(B, H, KV, T, hd, T + hd)
    want = ref.decode_attention_ref(q, k, v, length)
    hdp = -(-hd // 32) * 32
    plans = [da.decode_plan(B, H, KV, T, hd, torch.float32, H100_SMS),
             da.make_plan(B, H, KV, T, hd, torch.float32, heads=8,
                          tile=da.score_keys(hdp, 8, 4), split=T + 5),
             da.make_plan(B, H, KV, T, hd, torch.float32, heads=8,
                          tile=da.score_keys(hdp, 8, 4), split=T // 3 + 1,
                          warps=8)]
    for heads in (1, 2, 4):
        sk = da.score_keys(hdp, heads, 4)
        plans.append(da.make_plan(B, H, KV, T, hd, torch.float32,
                                  heads=heads, tile=sk, split=3 * sk + 1))
    for plan in plans:
        got = ref.decode_attention_split(q, k, v, length, plan)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=str(plan))
        assert (got[0] == 0).all()


@pytest.mark.parametrize("H,KV,hd", [(8, 2, 40), (8, 2, 80), (8, 2, 136),
                                     (4, 4, 80), (40, 1, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_split_equals_pallas(H, KV, hd, bf16):
    """The split arithmetic against ``_decode_kernel`` in interpret mode,
    at head widths the first CUDA kernel refused (40, 80, 136) and at
    G = 1 and G = 40."""
    B, T = 3, 256
    arrays = attention_inputs(hd + H, B, H, KV, 0, T, hd)
    dtype = torch.bfloat16 if bf16 else torch.float32
    jx = tuple(jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
               for a in arrays)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    length = np.array([T, 100, 1], np.int32)
    want = jops.decode_attention(*jx, jnp.asarray(length), block_k=128,
                                 interpret=True)
    auto = da.decode_plan(B, H, KV, T, hd, dtype, H100_SMS)
    split = da.make_plan(B, H, KV, T, hd, dtype, heads=auto.heads,
                         tile=auto.tile, split=3 * auto.tile + 5)
    assert split.splits > 1
    for plan in (auto, split):
        got = ref.decode_attention_split(q, k, v, torch.from_numpy(length),
                                         plan)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jnp.asarray(want, jnp.float32)),
                                   **attention_tol(bf16), err_msg=str(plan))


@pytest.mark.parametrize("hd", [4, 12, 100, 257, 264, 512])
def test_decode_wrapper_refuses_head_widths_the_kernel_lacks(hd):
    """Off a multiple of 8 or past 256 the kernel has no build: the plan
    and the wrapper on a device other than the CPU raise (the CPU runs the
    plain version, which takes any width)."""
    with pytest.raises(ValueError, match=f"hd={hd}"):
        da.decode_plan(1, 2, 1, 16, hd, torch.float32, H100_SMS)
    meta = [torch.empty(s, device="meta")
            for s in ((1, 2, hd), (1, 1, 16, hd), (1, 1, 16, hd))]
    with pytest.raises(ValueError, match=f"hd={hd}"):
        ops.decode_attention(*meta, torch.ones(1, dtype=torch.int32,
                                               device="meta"))
    cpu = [torch.zeros(s) for s in ((1, 2, hd), (1, 1, 16, hd),
                                    (1, 1, 16, hd))]
    assert ops.decode_attention(*cpu, torch.ones(1, dtype=torch.int32)) \
        .shape == (1, 2, hd)


@pytest.mark.parametrize("hd,G", [(8, 1), (80, 1), (136, 12), (256, 40),
                                  (40, 64)])
def test_decode_wrapper_takes_any_width_and_group(hd, G):
    meta = [torch.empty(s, device="meta")
            for s in ((1, G, hd), (1, 1, 16, hd), (1, 1, 16, hd))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.decode_attention(*meta, torch.ones(1, dtype=torch.int32,
                                               device="meta"))


@pytest.mark.parametrize("label,shape,dtype", decode_plans.SHAPES)
def test_decode_plan_sweep_candidates_fit_and_hold_the_pick(label, shape,
                                                            dtype):
    """The card-only sweep ``benchmarks/decode_plans.py`` tries the plan
    ``decode_plan`` picks and neighbours of it the card can hold."""
    s = shape
    picked = da.decode_plan(s["B"], s["H"], s["KV"], s["T"], s["hd"], dtype,
                            H100_SMS)
    plans = decode_plans.candidates(s["B"], s["H"], s["KV"], s["T"],
                                    s["hd"], dtype, picked)
    assert picked in plans and len(plans) >= 6
    assert {p.warps for p in plans} == set(da.WARPS) or dtype == torch.bfloat16
    for p in plans:
        assert p.smem <= da.MAX_SMEM and p.splits <= da.MAX_SPLITS
        assert p.heads == picked.heads and p.hdp == picked.hdp
