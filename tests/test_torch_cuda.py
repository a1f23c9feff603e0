"""The port on the card: the CUDA kernel against its plain version, the
tie rule of ``torch.argmax`` there, and a small served world traced on the
card and on the CPU.  Every test needs an NVIDIA GPU and nvcc and skips
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
from torch_cases import CASES, make_inputs

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
