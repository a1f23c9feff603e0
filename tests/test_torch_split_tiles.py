"""The gallery split of the tile-masked re-id top-k kernel
(``csrc/reid_topk_tiles.cu`` over ``csrc/reid_split.cuh``), held on the CPU.

The tile kernel cuts the gallery as the camera kernel does (the same
``reid_topk.split_plan`` and ``slices``), ranks each slice to its top-K
over the fused (camera x tile) cells, skips (64-row, 64-row) tiles with no
eligible pair, and merges.  Here the plain version run slice by slice and
merged by the plain merge pass (``ref.merge_topk``) must equal the unsplit
plain version bit for bit; the tile and camera launches must take one
plan; and split shapes, one past the cell axis the first tile kernel
took, are held against the Pallas kernel in interpret mode.  The kernel
itself runs only on a card (``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ref, reid_topk
from torch_cases import make_tile_inputs

TILE = reid_topk.SPLIT_GB


def _split_tiles(t, k, S):
    """``ref.reid_topk_tiles_ref`` on each of S slices of the gallery
    (lists of K = round_k(k), global indices), then the merge pass: what
    the kernel computes with S slices."""
    q, q_tag, admit_ct, g, gal_ct, gal_tag = t
    parts = []
    for a, b in reid_topk.slices(g.shape[0], S):
        v, i = ref.reid_topk_tiles_ref(q, q_tag, admit_ct, g[a:b],
                                       gal_ct[a:b], gal_tag[a:b],
                                       reid_topk.round_k(k))
        parts.append((v, torch.where(i >= 0, i + a, i)))
    return ref.merge_topk(parts, k)


def _quantised(rng, shape):
    """Features in quarters of [-2, 2]: every product and partial sum is
    exact in float32, so a score's bits do not depend on how the gallery
    is cut, and equal rows tie exactly."""
    return (rng.integers(-8, 9, shape) / 4).astype(np.float32)


# (Q, G, D, C, T, k, what): every shape splits into several slices
SPLIT_CASES = [
    (70, 517, 16, 8, 8, 5, "ragged Q and G"),
    (33, 517, 16, 8, 4, 3, "unlabeled and out-of-range cells"),
    (64, 256, 16, 8, 8, 8, "ties across slice boundaries"),
    (40, 400, 8, 8, 8, 6, "wholly dead slices"),
    (33, 300, 8, 8, 8, 16, "k = 16 over one-tile slices"),
    (129, 1000, 4, 130, 8, 4, "130 cameras, sparse admission"),
]


def _case(Q, G, D, C, T, k, what):
    opts = {}
    if what == "unlabeled and out-of-range cells":
        opts = dict(unlabeled=40, out_of_range=40)
    if what == "130 cameras, sparse admission":
        opts = dict(p_admit=0.01)
    arrays = list(make_tile_inputs(Q * 7 + G, Q, G, D, C, T, **opts))
    rng = np.random.default_rng(Q + G)
    arrays[0], arrays[3] = _quantised(rng, (Q, D)), _quantised(rng, (G, D))
    if what == "ties across slice boundaries":
        g = arrays[3]
        for b in range(TILE, G, TILE):          # the rows either side tie
            g[b] = g[b - 1]
            g[b + 1] = g[b - 2]
    if what == "wholly dead slices":
        # tiles 1 and 3 hold only camera C - 1's cells, which nobody
        # admits; tile 5 only unlabeled rows
        TT = T * T
        cells = arrays[4]
        cells[TILE:2 * TILE] = (C - 1) * TT + rng.integers(0, TT, TILE)
        cells[3 * TILE:4 * TILE] = (C - 1) * TT + rng.integers(0, TT, TILE)
        cells[5 * TILE:6 * TILE] = -1
        arrays[2][:, (C - 1) * TT:] = False
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("Q,G,D,C,T,k,what", SPLIT_CASES)
def test_tile_split_and_merge_equals_unsplit_bit_for_bit(Q, G, D, C, T, k,
                                                         what):
    t = _case(Q, G, D, C, T, k, what)
    want = ref.reid_topk_tiles_ref(*t, k)
    ng = -(-G // TILE)
    for S in sorted({2, ng, max(2, ng // 2),
                     reid_topk.split_plan(Q, G, 132)[1]}):
        got = _split_tiles(t, k, S)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] >= 0).any()
    if what == "ties across slice boundaries":
        # the boundary pairs tie and both rank: the lower index first
        sv, si = want
        tied = (sv[:, 1:] == sv[:, :-1]) & (si[:, 1:] >= 0)
        assert tied.any() and (si[:, 1:][tied] > si[:, :-1][tied]).all()
    if what == "wholly dead slices":
        hit = want[1][want[1] >= 0]
        for a, b in ((TILE, 2 * TILE), (3 * TILE, 4 * TILE),
                     (5 * TILE, 6 * TILE)):
            assert not ((hit >= a) & (hit < b)).any()


@pytest.mark.parametrize("Q,G", [(16, 128), (20, 512), (256, 8192),
                                 (256, 8193), (1, 1), (128, 2048)])
def test_tile_and_camera_launches_take_one_plan(monkeypatch, Q, G):
    """The serving rounds, the benchmark and the stress shape: the tile
    kernel's launch gets the camera kernel's slices S and a (Q, S, K)
    workspace exactly when S > 1, through the same launcher signature."""
    calls = {}

    def launcher(source, symbol, argtypes):
        def fn(*args):
            calls[symbol] = (argtypes, args)
            return 0
        return fn

    monkeypatch.setattr(build, "launcher", launcher)
    monkeypatch.setattr(build, "device_and_stream", lambda t: (0, 0))
    monkeypatch.setattr(reid_topk, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    t = _case(Q, G, 8, 8, 8, 16, "")
    cam = [t[0], t[1], t[2][:, :8].contiguous(), t[3],
           torch.where(t[4] >= 0, t[4] // 64, -1).to(torch.int32), t[5]]
    reid_topk._launch("reid_topk", "reid_topk_segment_masked", *cam, 16)
    reid_topk._launch("reid_topk_tiles", "reid_topk_tiles", *t, 16)
    (cam_types, cam_args), (tile_types, tile_args) = \
        calls["reid_topk_segment_masked"], calls["reid_topk_tiles"]
    S = reid_topk.split_plan(Q, G, 132)[1]
    assert cam_types == tile_types
    assert cam_args[-3] == tile_args[-3] == S
    # workspace pointers: both null or both given
    assert (cam_args[8] is None) == (tile_args[8] is None) == (S == 1)
    assert tile_args[10:15] == (Q, G, 8, 8 * 64, 16)


def test_tile_launch_refuses_sizes_past_int():
    class Wide:
        shape = (4, 2 ** 31)

    t = _case(4, 70, 8, 8, 8, 3, "")
    with pytest.raises(ValueError, match="exceeds the launcher's int"):
        reid_topk._launch("reid_topk_tiles", "reid_topk_tiles", t[0], t[1],
                          Wide(), t[3], t[4], t[5], 3)


def _jax(arrays, k):
    sv, si = jops.reid_topk_tiles(*(jnp.asarray(a) for a in arrays), k,
                                  interpret=True)
    return np.asarray(sv), np.asarray(si)


@pytest.mark.parametrize("what,Q,G,D,C,T,k,S", [
    ("split, unlabeled and out-of-range cells", 40, 300, 16, 8, 8, 5, 5),
    ("CT = 61,440 cells, past the first kernel's 54,688", 9, 200, 8, 15,
     64, 4, 4),
])
def test_tile_split_matches_pallas(what, Q, G, D, C, T, k, S):
    """Split and merged plain version against the Pallas kernel in
    interpret mode: scores within 1e-5, indices exact on integer-valued
    features (ties included)."""
    arrays = list(make_tile_inputs(Q + G + C, Q, G, D, C, T, ties=True,
                                   unlabeled=12, out_of_range=12,
                                   p_admit=0.3))
    CT = C * T * T
    if CT > 54688:
        # draw the cells from the whole axis, its far end included
        rng = np.random.default_rng(CT)
        labeled = arrays[4] >= 0
        arrays[4][labeled] = np.where(
            rng.random(labeled.sum()) < 0.5,
            rng.integers(CT - 64, CT + 64, labeled.sum()),
            rng.integers(0, CT, labeled.sum())).astype(np.int32)
    pv, pi = _split_tiles([torch.from_numpy(a) for a in arrays], k, S)
    jv, ji = _jax(arrays, k)
    np.testing.assert_allclose(pv.numpy(), jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pi.numpy(), ji)
    assert (pi >= 0).any()
