"""The port on the card: the CUDA kernels against their plain versions
(the serving path's re-id top-k kernels and the kernel benchmark's four),
the tie rule of ``torch.argmax`` there, small served worlds (camera-
and tile-granular) traced on the card and on the CPU, and the zoo's
Mamba1 and hybrid smoke models on the card against their CPU runs.
Every test needs an NVIDIA GPU and nvcc and skips without them; the
module imports neither ``jax`` nor ``repro``, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.benchmarks import kernels_bench
from repro_torch.kernels import (decode_attention, flash_attention,
                                 mamba_scan, ops, ref, reid_topk)
from repro_torch.launch.serve import duke_world, run_stream
from torch_cases import (CASES, DECODE_CASES, FLASH_CASES, SCAN_CASES,
                         TILE_CASES, TOPK_CASES, attention_inputs,
                         attention_tol, camera_to_tiles, make_inputs,
                         make_tile_inputs, scan_inputs, topk_inputs)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,D,C,k,opts", CASES + [
    (64, 1000, 64, 130, 4, dict(masked_row=True, pad_rows=20)),
])
def test_cuda_kernel_matches_plain(card, Q, G, D, C, k, opts):
    arrays = [torch.from_numpy(a).to(card)
              for a in make_inputs(Q + G, Q, G, D, C, **opts)]
    before = reid_topk.LAUNCHES
    kv, ki = ops.reid_topk_segments(*arrays, k)
    torch.cuda.synchronize()
    assert reid_topk.LAUNCHES == before + 1
    pv, pi = ref.reid_topk_segments_ref(*arrays, k)
    torch.testing.assert_close(kv, pv, **TOL)
    if opts.get("ties"):
        assert torch.equal(ki, pi)


@pytest.mark.cuda
def test_cuda_argmax_takes_the_first_maximum(card):
    x = torch.tensor([[1.0, 3.0, 3.0], [0.0, 0.0, 0.0], [2.0, 1.0, 2.0]],
                     device=card)
    assert torch.argmax(x, 1).tolist() == [1, 0, 0]
    wide = torch.zeros((4, 4096), device=card)
    wide[:, 1000] = wide[:, 3000] = 1.0
    assert torch.argmax(wide, 1).tolist() == [1000] * 4


@pytest.mark.cuda
def test_cuda_engine_trace_equals_cpu(card):
    world = duke_world(n_queries=8, n_entities=300, horizon=900)
    model = api.profile(world.vis, time_limit=600, device=card)

    def trace(device):
        eng = api.serve(model.to(device), lambda x: x, api.SearchPolicy(),
                        geo_adj=world.net.geo_adjacent, topk=3,
                        device=device)
        records = []
        run_stream(eng, world, 400, records)
        return records

    reid_topk.LAUNCHES = 0
    on_card = trace(card)
    assert reid_topk.LAUNCHES > 0
    on_cpu = trace("cpu")
    assert len(on_card) == len(on_cpu) and any(r["matched"] for r in on_cpu)
    for a, b in zip(on_card, on_cpu):
        for f in ("qid", "f_curr", "phase", "matched", "match_cam",
                  "match_idx"):
            assert a[f] == b[f], (f, a, b)
        assert np.array_equal(a["mask"], b["mask"])
        assert [(c, fr) for _, c, fr in a["topk"]] == \
            [(c, fr) for _, c, fr in b["topk"]]
        np.testing.assert_allclose([v for v, _, _ in a["topk"]],
                                   [v for v, _, _ in b["topk"]], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,D,C,T,k,opts", TILE_CASES + [
    (64, 1000, 64, 130, 8, 4, dict(masked_row=True, unlabeled=20,
                                   out_of_range=20)),
    (40, 700, 32, 8, 8, 16, dict(ties=True, p_admit=0.05)),
])
def test_cuda_tile_kernel_matches_plain(card, Q, G, D, C, T, k, opts):
    arrays = [torch.from_numpy(a).to(card)
              for a in make_tile_inputs(Q + G, Q, G, D, C, T, **opts)]
    before = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
    kv, ki = ops.reid_topk_tiles(*arrays, k)
    torch.cuda.synchronize()
    assert (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES) == \
        (before[0], before[1] + 1)
    pv, pi = ref.reid_topk_tiles_ref(*arrays, k)
    torch.testing.assert_close(kv, pv, **TOL)
    if opts.get("ties"):
        assert torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,D,C,k,opts", CASES)
def test_cuda_tile_kernel_all_admitted_equals_camera_kernel(card, Q, G, D, C,
                                                            k, opts):
    cam = make_inputs(Q + G, Q, G, D, C, pad_rows=min(G // 4, 9), **opts)
    sv, si = ops.reid_topk_segments(
        *(torch.from_numpy(a).to(card) for a in cam), k)
    tv, ti = ops.reid_topk_tiles(
        *(torch.from_numpy(a).to(card) for a in camera_to_tiles(cam, 8)), k)
    assert torch.equal(tv, sv) and torch.equal(ti, si)


@pytest.mark.cuda
def test_cuda_tile_kernel_cell_limit(card):
    """No cell limit: cell axes past the first design's 54,688 (its packed
    admit rows in shared memory) run at a split shape and equal the plain
    version bit for bit, cells at the axis' far end and past it
    included."""
    Q, G = 70, 700
    assert _slices_of(card, Q, G) > 1
    for CT in (54688 + 32, 15 * 64 * 64, 1_000_003):
        arrays = list(make_tile_inputs(CT, Q, G, 16, 1, 2, ties=True,
                                       unlabeled=20))
        rng = np.random.default_rng(CT)
        admit_ct = rng.random((Q, CT)) < 0.3
        labeled = arrays[4] >= 0
        arrays[4][labeled] = np.where(
            rng.random(labeled.sum()) < 0.5,
            rng.integers(CT - 64, CT + 64, labeled.sum()),
            rng.integers(0, CT, labeled.sum())).astype(np.int32)
        arrays[2] = admit_ct
        t = [torch.from_numpy(a).to(card) for a in arrays]
        kv, ki = ops.reid_topk_tiles(*t, 3)
        pv, pi = ref.reid_topk_tiles_ref(*t, 3)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
        assert (ki >= 0).any()


@pytest.mark.cuda
def test_cuda_tile_engine_trace_equals_cpu(card):
    world = duke_world(n_queries=8, n_entities=300, horizon=900)
    model = api.profile(world.vis, time_limit=600, tile_grid=8, device=card)
    assert model.tile_learned and model.tile_admit.is_cuda

    def trace(device):
        eng = api.serve(model.to(device), lambda x: x, api.SearchPolicy(),
                        geo_adj=world.net.geo_adjacent, topk=3, tile_grid=8,
                        device=device)
        records = []
        run_stream(eng, world, 400, records)
        return eng, records

    reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
    eng_card, on_card = trace(card)
    assert reid_topk.TILE_LAUNCHES > 0 and reid_topk.LAUNCHES == 0
    eng_cpu, on_cpu = trace("cpu")
    assert len(on_card) == len(on_cpu) and any(r["matched"] for r in on_cpu)
    for a, b in zip(on_card, on_cpu):
        for f in ("qid", "f_curr", "phase", "matched", "match_cam",
                  "match_idx"):
            assert a[f] == b[f], (f, a, b)
        assert np.array_equal(a["mask"], b["mask"])
        assert [(c, fr) for _, c, fr in a["topk"]] == \
            [(c, fr) for _, c, fr in b["topk"]]
        np.testing.assert_allclose([v for v, _, _ in a["topk"]],
                                   [v for v, _, _ in b["topk"]], **TOL)
    for f in ("admitted_steps", "unique_frames", "admitted_tiles",
              "unique_tiles"):
        assert getattr(eng_card, f) == getattr(eng_cpu, f), f


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,D,k,ties", TOPK_CASES + [
    (256, 8192, 64, 16, False), (130, 1000, 32, 16, True)])
def test_cuda_unmasked_topk_matches_plain(card, Q, G, D, k, ties):
    q, g = (torch.from_numpy(a).to(card) for a in topk_inputs(Q + G, Q, G,
                                                               D, ties))
    before = reid_topk.UNMASKED_LAUNCHES
    kv, ki = ops.reid_topk(q, g, k)
    torch.cuda.synchronize()
    assert reid_topk.UNMASKED_LAUNCHES == before + 1
    pv, pi = ref.reid_topk_ref(q, g, k)
    torch.testing.assert_close(kv, pv, **TOL)
    if ties or G < 100:
        assert torch.equal(ki, pi)


def _slices_of(card, Q, G):
    return reid_topk.split_plan(
        Q, G, torch.cuda.get_device_properties(card).multi_processor_count)[1]


def _split_features(seed, Q, G, D, what):
    """Features in quarters of [-2, 2], whose products and sums are exact
    in float32, so card and CPU scores agree to the bit and indices must
    be equal; "ties" makes the rows either side of every slice boundary
    equal."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(-8, 9, (Q, D)) / 4).astype(np.float32)
    g = (rng.integers(-8, 9, (G, D)) / 4).astype(np.float32)
    if what == "ties":
        for b in range(reid_topk.SPLIT_GB, G - 1, reid_topk.SPLIT_GB):
            g[b] = g[b - 1]
            g[b + 1] = g[b - 2]
    return q, g


# (Q, G, D, k, what): shapes the plan splits into S > 1 slices
SPLIT_CASES = [
    (256, 8192, 64, 16, ""),          # the benchmark's shape
    (256, 8193, 64, 16, ""),          # one row past a whole tile
    (64, 2048, 16, 16, "ties"),       # ties across slice boundaries
    (33, 700, 16, 16, "one tile"),    # k = 16 over slices of one tile
    (20, 512, 64, 3, ""),             # the largest serving round
]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,D,k,what", SPLIT_CASES)
def test_cuda_unmasked_split_matches_plain(card, Q, G, D, k, what):
    S = _slices_of(card, Q, G)
    assert S > 1
    if what == "one tile":
        assert S == -(-G // reid_topk.SPLIT_GB)
    q, g = (torch.from_numpy(a).to(card)
            for a in _split_features(Q + G, Q, G, D, what))
    before = reid_topk.UNMASKED_LAUNCHES
    kv, ki = ops.reid_topk(q, g, k)
    torch.cuda.synchronize()
    assert reid_topk.UNMASKED_LAUNCHES == before + 1
    pv, pi = ref.reid_topk_ref(q, g, k)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,D,k,what", SPLIT_CASES + [
    (40, 1000, 16, 8, "masked slices"), (96, 4096, 32, 16, "130 cams")])
def test_cuda_camera_split_matches_plain(card, Q, G, D, k, what):
    assert _slices_of(card, Q, G) > 1
    C = 130 if what == "130 cams" else 8
    arrays = list(make_inputs(Q * 3 + G, Q, G, D, C, pad_rows=9))
    arrays[0], arrays[3] = _split_features(Q + G, Q, G, D, what)
    if what == "masked slices":
        # slices 1 and 3 hold only cameras 6 and 7, which nobody admits
        arrays[4][64:128] = 6
        arrays[4][192:256] = 7
        arrays[2][:, 6:] = False
    t = [torch.from_numpy(a).to(card) for a in arrays]
    before = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
    kv, ki = ops.reid_topk_segments(*t, k)
    torch.cuda.synchronize()
    assert (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES) == \
        (before[0] + 1, before[1])
    pv, pi = ref.reid_topk_segments_ref(*t, k)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert (ki >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [5000, 130000])
def test_cuda_camera_kernel_takes_any_camera_axis(card, C):
    """Past ``MAX_CAMS`` cameras the camera-masked call runs on the tile
    kernel (the same eligibility over any cell axis): sparse admission over
    cameras spread across the whole axis (past 4,096 and at C - 1), rows
    out of range (-1, C), ties between rows; exact scores and indices
    against the plain version, one launch counted."""
    assert C > reid_topk.MAX_CAMS
    Q, G, D, k = 40, 3000, 16, 8
    rng = np.random.default_rng(C)
    q, g = _split_features(C, Q, G, D, "ties")
    g[1::7] = g[::7][:len(g[1::7])]                  # equal rows: ties
    cams = np.concatenate([rng.integers(0, C, 60), [0, 4095, 4096, C - 1]])
    gal_cam = rng.choice(cams, G).astype(np.int32)
    gal_cam[::97] = -1
    gal_cam[5::101] = C
    admit = rng.random((Q, C)) < 0.001                  # sparse
    admit[:, cams] = rng.random((Q, len(cams))) < 0.5
    q_tag = rng.integers(0, 2, Q).astype(np.int32)
    gal_tag = rng.integers(0, 2, G).astype(np.int32)
    t = [torch.from_numpy(a).to(card)
         for a in (q, q_tag, admit, g, gal_cam, gal_tag)]
    before = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
    kv, ki = ops.reid_topk_segments(*t, k)
    torch.cuda.synchronize()
    assert (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES) == \
        (before[0] + 1, before[1])
    pv, pi = ref.reid_topk_segments_ref(*t, k)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    picked = gal_cam[ki[ki >= 0].cpu().numpy()]
    assert len(picked) > Q and (picked >= reid_topk.MAX_CAMS).any()


@pytest.mark.cuda
def test_cuda_split_normal_features_match_plain(card):
    """Normal features at the stress width: scores within 1e-5 (the card
    and the CPU sum in other orders)."""
    arrays = [torch.from_numpy(a).to(card) for a in
              make_inputs(5, 256, 8192, 2048, 130, pad_rows=80)]
    kv, _ = ops.reid_topk_segments(*arrays, 16)
    pv, _ = ref.reid_topk_segments_ref(*arrays, 16)
    torch.testing.assert_close(kv, pv, **TOL)
    uv, _ = ops.reid_topk(arrays[0], arrays[3], 16)
    torch.testing.assert_close(uv, ref.reid_topk_ref(arrays[0], arrays[3],
                                                     16)[0], **TOL)


@pytest.mark.cuda
def test_cuda_tile_kernel_all_admitted_equals_split_camera_kernel(card):
    """At a split shape the tile kernel with every tile admitted gives the
    camera kernel's bits: the same plan, eligibility and fmaf chain in
    depth order."""
    Q, G, C = 256, 8192, 130
    assert _slices_of(card, Q, G) > 1
    cam = make_inputs(9, Q, G, 64, C, pad_rows=9)
    sv, si = ops.reid_topk_segments(
        *(torch.from_numpy(a).to(card) for a in cam), 16)
    tv, ti = ops.reid_topk_tiles(
        *(torch.from_numpy(a).to(card) for a in camera_to_tiles(cam, 8)), 16)
    assert torch.equal(tv, sv) and torch.equal(ti, si)


# (Q, G, D, C, T, k, what): tile shapes the plan splits into S > 1 slices
TILE_SPLIT_CASES = [
    (64, 2048, 16, 8, 8, 16, "ties"),       # ties across slice boundaries
    (40, 1000, 16, 8, 8, 8, "dead"),        # tiles no query admits
    (256, 8193, 64, 130, 8, 16, ""),        # one row past a whole tile
    (128, 2048, 64, 8, 8, 3, "sparse"),     # admission p = 0.0005
    (33, 700, 16, 8, 8, 16, "one tile"),    # k = 16 over one-tile slices
]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,D,C,T,k,what", TILE_SPLIT_CASES)
def test_cuda_tile_split_matches_plain(card, Q, G, D, C, T, k, what):
    S = _slices_of(card, Q, G)
    assert S > 1
    if what == "one tile":
        assert S == -(-G // reid_topk.SPLIT_GB)
    arrays = list(make_tile_inputs(Q * 3 + G, Q, G, D, C, T, unlabeled=9,
                                   out_of_range=9,
                                   p_admit=0.0005 if what == "sparse"
                                   else 0.6))
    arrays[0], arrays[3] = _split_features(Q + G, Q, G, D, what)
    if what == "dead":
        # tiles 1 and 3 hold only camera C - 1's cells, which nobody admits
        TT = T * T
        arrays[4][64:128] = (C - 1) * TT + np.arange(64) % TT
        arrays[4][192:256] = (C - 1) * TT + np.arange(64) % TT
        arrays[2][:, (C - 1) * TT:] = False
    t = [torch.from_numpy(a).to(card) for a in arrays]
    before = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
    kv, ki = ops.reid_topk_tiles(*t, k)
    torch.cuda.synchronize()
    assert (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES) == \
        (before[0], before[1] + 1)
    pv, pi = ref.reid_topk_tiles_ref(*t, k)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert (ki >= 0).any()


#: bfloat16 outputs of the attention kernels that must equal the plain
#: version's bit for bit (p stays float32, as in the Pallas kernels)
BF16_SHARE = 0.99


def _hold_attention(out, want, bf16):
    torch.testing.assert_close(out.float(), want.float(),
                               **attention_tol(bf16))
    if bf16:
        assert float((out == want).float().mean()) >= BF16_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,bf16", FLASH_CASES + [
    (1, 8, 2, 1024, 1024, 64, True, False),
    (1, 8, 8, 100, 77, 128, False, False),
    (2, 4, 1, 77, 100, 32, True, True)] + [
    # any head width that is a multiple of 8, to 256
    (1, 4, 2, 150, 130, hd, causal, bf16) for hd in (8, 40, 80, 96, 136, 256)
    for causal, bf16 in ((True, False), (False, True))])
def test_cuda_flash_attention_matches_plain(card, B, H, KV, S, T, hd,
                                            causal, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.from_numpy(a).to(card, dtype) for a in
               attention_inputs(S + T, B, H, KV, S, T, hd))
    before = flash_attention.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1 and out.dtype == dtype
    _hold_attention(out, ref.flash_attention_ref(q, k, v, causal=causal),
                    bf16)


@pytest.mark.cuda
def test_cuda_flash_attention_takes_views_at_an_offset(card):
    """A contiguous view that does not start on 16 bytes is copied before
    the kernel stages it in 16-byte chunks."""
    q, k, v = (torch.from_numpy(a).to(card) for a in
               attention_inputs(5, 1, 2, 2, 64, 64, 40))
    base = torch.cat([torch.zeros(1, device=card), q.flatten()])
    qv = base[1:].view(q.shape)
    assert qv.data_ptr() % 16 != 0
    before = flash_attention.LAUNCHES
    out = ops.flash_attention(qv, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    _hold_attention(out, ref.flash_attention_ref(q, k, v, causal=True),
                    False)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_widths_without_a_build(card):
    q = torch.zeros((1, 2, 16, 264), device=card)
    with pytest.raises(ValueError, match="hd=264"):
        ops.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 16, 12), device=card)
    with pytest.raises(ValueError, match="hd=12"):
        ops.flash_attention(q, q, q)


def _decode_case(card, B, H, KV, T, hd, bf16):
    """Inputs of a decode hold: lengths drawn in [1, T], the last row of
    length 0 (zeros, as the Pallas kernel), the first two T and T + 50
    (past T means T)."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.from_numpy(a).to(card, dtype) for a in
               attention_inputs(T + hd, B, H, KV, 0, T, hd))
    lengths = np.random.default_rng(T).integers(1, T + 1, B)
    if B > 1:
        lengths[-1] = 0
    if B > 2:
        lengths[0], lengths[1] = T, T + 50
    return q, k, v, torch.from_numpy(lengths.astype(np.int32)).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,hd,bf16", DECODE_CASES + [
    (4, 8, 2, 8192, 64, False), (2, 32, 4, 1000, 128, True)] + [
    # any head width that is a multiple of 8, to 256
    (3, 8, 2, 300, hd, bf16) for hd in (8, 40, 80, 136, 256)
    for bf16 in (False, True)] + [
    # any number of q heads a kv head: 1, 12 (a partial group), 40
    (3, 4, 4, 300, 80, True), (3, 12, 1, 300, 64, False),
    (3, 40, 1, 300, 128, True), (3, 40, 2, 300, 40, False),
    (3, 8, 2, 1, 64, False), (3, 8, 2, 1, 128, True),     # T = 1
    (3, 8, 2, 8191, 64, False), (3, 8, 2, 777, 128, True),  # T off a tile
    (128, 32, 4, 64, 128, True), (128, 8, 8, 33, 64, False)])  # B = 128
def test_cuda_decode_attention_matches_plain(card, B, H, KV, T, hd, bf16):
    q, k, v, length = _decode_case(card, B, H, KV, T, hd, bf16)
    before = decode_attention.LAUNCHES
    out = ops.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert decode_attention.LAUNCHES == before + 1 and out.dtype == q.dtype
    assert B == 1 or (out[-1] == 0).all()
    _hold_attention(out, ref.decode_attention_ref(q, k, v, length), bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,tile,split,warps", [
    (8, 8, 10000, 4),        # one split
    (8, 8, 32, 4),           # many splits, each one round of the warps
    (4, 8, 37, 4),           # a split that is not a multiple of the tile
    (1, 16, 100, 4),         # one head a block: eight groups
    (2, 8, 3, 4),            # splits of 3 keys: 234 of them
    (8, 2, 13, 4),           # the score block's own tile
    (8, 8, 100, 8),          # eight warps a block
    (4, 8, 10000, 8)])
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_decode_plans_match_plain(card, heads, tile, split, warps,
                                       bf16):
    """Every path of the kernels, whatever ``decode_plan`` picks: one split
    or many (the partials combined by the last block of a row), ragged
    splits and tiles, 4 or 8 warps, in float32 a block's
    heads from 1 to 8 (bfloat16 takes 8, with tiles of 16 or 32 keys);
    with ``passes=1`` a row of one split is still written."""
    B, H, KV, T, hd = 5, 8, 1, 700, 64
    q, k, v, length = _decode_case(card, B, H, KV, T, hd, bf16)
    if bf16:                 # the tensor-core kernel: 8 heads, 16-key blocks
        heads, tile = 8, 16 * max(1, tile // 8)
    sk = decode_attention.score_keys(64, heads, 2 if bf16 else 4)
    plan = decode_attention.make_plan(B, H, KV, T, hd, q.dtype, heads=heads,
                                      tile=max(sk, tile // sk * sk),
                                      split=split, warps=warps)
    want = ref.decode_attention_ref(q, k, v, length)
    out = torch.empty_like(q)
    decode_attention.launch(q, k, v, length, out, plan)
    torch.cuda.synchronize()
    _hold_attention(out, want, bf16)
    assert (out[-1] == 0).all()
    if plan.splits == 1:
        part = torch.empty_like(q)
        decode_attention.launch(q, k, v, length, part, plan, passes=1)
        torch.cuda.synchronize()
        assert torch.equal(part, out)


@pytest.mark.cuda
def test_cuda_decode_counters_are_left_zero(card):
    """The combine's ticket counters are zero after every launch, so calls
    on a stream share them without a memset: repeated calls, on two
    streams, give the same output as the plain version."""
    q, k, v, length = _decode_case(card, 5, 8, 2, 3000, 64, False)
    want = ref.decode_attention_ref(q, k, v, length)
    plan = decode_attention.make_plan(5, 8, 2, 3000, 64, q.dtype, heads=4,
                                      tile=8, split=100)
    assert plan.splits > 1
    for stream in (torch.cuda.current_stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            for _ in range(3):
                out = torch.empty_like(q)
                decode_attention.launch(q, k, v, length, out, plan)
                torch.cuda.synchronize()
                _hold_attention(out, want, False)
    for c in decode_attention._COUNTERS.values():
        assert int(c.abs().sum()) == 0


@pytest.mark.cuda
def test_cuda_decode_refuses_widths(card):
    """Off a multiple of 8 or past 256 the kernel has no build and the
    wrapper raises before launching."""
    for hd in (264, 12):
        q = torch.zeros((1, 2, hd), device=card)
        k = torch.zeros((1, 1, 16, hd), device=card)
        before = decode_attention.LAUNCHES
        with pytest.raises(ValueError, match=f"hd={hd}"):
            ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                     device=card))
        assert decode_attention.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_decode_attention_takes_views_at_an_offset(card):
    """A contiguous view that does not start on 16 bytes is copied before
    the kernel stages it in 16-byte chunks."""
    q, k, v, length = _decode_case(card, 3, 8, 2, 300, 64, False)
    base = torch.cat([torch.zeros(1, device=card), k.flatten()])
    kv = base[1:].view(k.shape)
    assert kv.data_ptr() % 16 != 0
    out = ops.decode_attention(q, kv, v, length)
    torch.cuda.synchronize()
    _hold_attention(out, ref.decode_attention_ref(q, k, v, length), False)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,N", SCAN_CASES + [
    (1, 1024, 256, 16), (2, 100, 70, 8),
    # any state size (the kernel took 4, 8 and 16 only) and any batch
    (2, 300, 65, 1), (2, 300, 65, 3), (1, 200, 63, 17), (1, 129, 64, 64),
    (65536, 1, 1, 1)])
def test_cuda_mamba_scan_matches_plain(card, B, L, D, N):
    arrays = [torch.from_numpy(a).to(card)
              for a in scan_inputs(L + D, B, L, D, N)]
    before = mamba_scan.LAUNCHES
    y = ops.mamba_scan(*arrays)
    torch.cuda.synchronize()
    assert mamba_scan.LAUNCHES == before + 1
    want, _ = ref.mamba_scan_ref(*arrays, torch.zeros((B, D, N),
                                                      device=card))
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nl,eg,warps,chunk,segments", [
    (1, 1, 1, 8, 1), (4, 8, 4, 64, 1), (4, 8, 4, 16, 3), (2, 4, 8, 8, 1),
    (8, 1, 2, 24, 5), (32, 1, 8, 8, 1), (16, 4, 1, 64, 2), (1, 8, 1, 32, 1)])
def test_cuda_mamba_scan_plans_match_plain(card, nl, eg, warps, chunk,
                                           segments):
    """Every path of the kernel, whatever ``scan_plan`` picks: 1 to 32
    lanes a channel, 1, 4 or 8 entries a lane, one tile or several (the
    state between them in the workspace), one segment or several, on
    ragged L, D and N."""
    B, L, D, N = 2, 333, 45, 17
    arrays = [torch.from_numpy(a).to(card)
              for a in scan_inputs(nl + eg, B, L, D, N)]
    plan = mamba_scan.make_plan(B, L, D, N, nl=nl, eg=eg, warps=warps,
                                chunk=chunk, segments=segments)
    y = torch.empty((B, L, D), device=card)
    mamba_scan.launch(*arrays, y, plan)
    torch.cuda.synchronize()
    want, _ = ref.mamba_scan_ref(*arrays, torch.zeros((B, D, N),
                                                      device=card))
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,N", [
    (1, 1024, 256, 16),          # the bench shape: three passes
    (2, 64, 8192, 16),           # falcon-mamba-7b's width: one pass
    (1, 129, 64, 320),           # two tiles of the state axis
    (2, 333, 45, 17), (3, 5, 7, 3), (65536, 1, 1, 1)])
def test_cuda_mamba_scan_final_state_matches_plain(card, B, L, D, N):
    """``final_state=True``: one launch writes y and h_L; y equals the
    call without the end state bit for bit."""
    arrays = [torch.from_numpy(a).to(card)
              for a in scan_inputs(L + N, B, L, D, N)]
    before = mamba_scan.LAUNCHES
    y, h = ops.mamba_scan(*arrays, final_state=True)
    torch.cuda.synchronize()
    assert mamba_scan.LAUNCHES == before + 1
    want_y, want_h = ref.mamba_scan_ref(*arrays, torch.zeros((B, D, N),
                                                             device=card))
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    assert torch.equal(ops.mamba_scan(*arrays), y)


@pytest.mark.cuda
@pytest.mark.parametrize("nl,eg,warps,chunk,segments", [
    (1, 1, 1, 8, 1), (4, 8, 4, 16, 3), (8, 1, 2, 24, 5), (16, 4, 1, 64, 2)])
def test_cuda_mamba_scan_plans_write_the_end_state(card, nl, eg, warps,
                                                   chunk, segments):
    """The end state from every path: one tile or several, one segment or
    several (the last segment's blocks write it)."""
    B, L, D, N = 2, 333, 45, 17
    arrays = [torch.from_numpy(a).to(card)
              for a in scan_inputs(nl + eg, B, L, D, N)]
    plan = mamba_scan.make_plan(B, L, D, N, nl=nl, eg=eg, warps=warps,
                                chunk=chunk, segments=segments)
    y = torch.empty((B, L, D), device=card)
    h = torch.empty((B, D, N), device=card)
    mamba_scan.launch(*arrays, y, plan, h=h)
    torch.cuda.synchronize()
    want_y, want_h = ref.mamba_scan_ref(*arrays, torch.zeros((B, D, N),
                                                             device=card))
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_mamba1_model_matches_cpu(card):
    """falcon-mamba's smoke config in float32: forward, prefill (logits
    and state) and decode steps on the card against the CPU, a scan
    launch a layer a pass and none a step."""
    from repro_torch import models
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config("falcon_mamba_7b"),
                              dtype="float32")
    host = models.init_params(cfg, seed=1, device="cpu")
    params = _tree_to(host, card)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    out = {}
    for dev, p in (("cpu", host), ("cuda", params)):
        before = mamba_scan.LAUNCHES
        t = tokens.to(dev)
        whole = models.forward(p, {"tokens": t}, cfg, device=dev)[0]
        lg, st = models.prefill(p, {"tokens": t[:, :20]}, cfg, device=dev)
        steps = [lg]
        for i in range(20, 24):
            lg, st = models.decode_step(p, st, t[:, i], cfg, device=dev)
            steps.append(lg)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert mamba_scan.LAUNCHES == before + 2 * cfg.num_layers
        out[dev] = [whole, torch.stack(steps, 1), st["ssm"]["h"],
                    st["ssm"]["conv"]]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_hybrid_model_matches_cpu(card):
    """zamba2's smoke config in float32: forward, prefill (logits, every
    layer's h and conv, each super-block's K/V) and decode steps on the
    card against the CPU; the flash kernel launched once a super-block a
    pass, the decode kernel once a super-block a step, the scan never."""
    from repro_torch import models
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config("zamba2_2p7b"),
                              dtype="float32")
    n_super = cfg.num_layers // cfg.attn_every
    host = models.init_params(cfg, seed=2, device="cpu")
    params = _tree_to(host, card)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)))
    counters = (flash_attention, decode_attention, mamba_scan)
    out = {}
    for dev, p in (("cpu", host), ("cuda", params)):
        before = [mod.LAUNCHES for mod in counters]
        t = tokens.to(dev)
        whole = models.forward(p, {"tokens": t}, cfg, device=dev)[0]
        lg, st = models.prefill(p, {"tokens": t[:, :20]}, cfg, max_len=24,
                                device=dev)
        filled = [st["ssm"]["h"].clone(), st["ssm"]["conv"].clone(),
                  st["kv"]["k"].clone(), st["kv"]["v"].clone()]
        steps = [lg]
        for i in range(20, 24):
            lg, st = models.decode_step(p, st, t[:, i], cfg, device=dev)
            steps.append(lg)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert [mod.LAUNCHES - b for mod, b in zip(counters, before)] \
                == [2 * n_super, 4 * n_super, 0]
        out[dev] = [whole, torch.stack(steps, 1), *filled, st["ssm"]["h"],
                    st["kv"]["k"]]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(out["cuda"][1], out["cuda"][0][:, 19:],
                               rtol=2e-4, atol=2e-4)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_cuda_kernel_bench_launches_every_kernel(card):
    counters = (reid_topk, "UNMASKED_LAUNCHES"), (flash_attention,
                                                  "LAUNCHES"), \
        (decode_attention, "LAUNCHES"), (mamba_scan, "LAUNCHES")
    for mod, attr in counters:
        setattr(mod, attr, 0)
    rows = kernels_bench.run("cuda")
    for (name, us, derived), (mod, attr) in zip(rows, counters):
        fields = dict(f.split("=") for f in derived.split(";"))
        assert fields["device"] == "cuda" and us > 0
        assert getattr(mod, attr) == int(fields["calls"]) > 0, name
