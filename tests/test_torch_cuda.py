"""The port on the card: the CUDA kernels against their plain versions,
the tie rule of ``torch.argmax`` there, and small served worlds (camera-
and tile-granular) traced on the card and on the CPU.  Every test needs an NVIDIA GPU and nvcc and skips
without them; the module imports neither ``jax`` nor ``repro``, so it runs
on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import ops, ref, reid_topk
from repro_torch.launch.serve import duke_world, run_stream
from torch_cases import (CASES, TILE_CASES, camera_to_tiles, make_inputs,
                         make_tile_inputs)

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
    """``MAX_CELLS`` is what a block's shared memory holds: the kernel
    launches at it (every byte a block may opt into) and the wrapper
    refuses one word more."""
    arrays = [torch.from_numpy(a).to(card)
              for a in make_tile_inputs(0, 4, 40, 8, 1, 2, ties=True)]
    rng = np.random.default_rng(1)
    arrays[2] = torch.from_numpy(
        rng.random((4, reid_topk.MAX_CELLS)) < 0.5).to(card)
    arrays[4] = torch.from_numpy(rng.integers(
        0, reid_topk.MAX_CELLS, 40).astype(np.int32)).to(card)
    kv, ki = ops.reid_topk_tiles(*arrays, 3)
    pv, pi = ref.reid_topk_tiles_ref(*arrays, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(kv, pv, **TOL)
    assert torch.equal(ki, pi)
    arrays[2] = torch.zeros((4, reid_topk.MAX_CELLS + 32), dtype=torch.bool,
                            device=card)
    with pytest.raises(ValueError, match="cells exceeds"):
        ops.reid_topk_tiles(*arrays, 2)


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
