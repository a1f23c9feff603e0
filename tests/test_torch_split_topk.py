"""The gallery split of the camera-masked and unmasked re-id top-k kernels
(``csrc/reid_split.cuh``), held on the CPU.

The kernels split the gallery into slices of whole 64-row tiles
(``reid_topk.split_plan`` / ``slices``), rank each slice to its top-K and
merge.  Here the plan's properties are checked, and the plain versions run
slice by slice and merged by the plain merge pass (``ref.merge_topk``) must
equal the unsplit plain version bit for bit, masked and unmasked; one
split shape is also held against the Pallas kernels in interpret mode.
The kernels themselves run only on a card (``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref, reid_topk
from torch_cases import make_inputs, topk_inputs

TILE = reid_topk.SPLIT_GB


@pytest.mark.parametrize("Q,G,n_sms", [
    (16, 128, 132), (20, 512, 132), (256, 8192, 132), (256, 8193, 132),
    (1, 1, 132), (5000, 8192, 132), (33, 517, 4), (256, 8192, 16),
    (70, 64 * 3 + 1, 132), (1, 10 ** 6, 132)])
def test_split_plan_slices_are_whole_nonempty_tiles_covering_the_gallery(
        Q, G, n_sms):
    nq, S = reid_topk.split_plan(Q, G, n_sms)
    ng = -(-G // TILE)
    assert nq == -(-Q // reid_topk.SPLIT_QB) and 1 <= S <= ng
    if ng < reid_topk.MIN_SPLIT_TILES:
        assert S == 1
    cuts = reid_topk.slices(G, S)
    assert len(cuts) == S and cuts[0][0] == 0 and cuts[-1][1] == G
    for (a, b), (c, _) in zip(cuts, cuts[1:]):
        assert b == c                               # contiguous
    for a, b in cuts:
        assert a < b and a % TILE == 0              # non-empty, tile-aligned
        assert b % TILE == 0 or b == G
    # never more blocks than fill BLOCKS_PER_SM on every SM by more than
    # one q-block's worth of slices
    assert S == 1 or nq * (S - 1) < reid_topk.BLOCKS_PER_SM * n_sms


def test_split_plan_serving_and_benchmark_shapes():
    """The serving main round stays one block with no merge; the benchmark
    and stress shape (Q = 256, G = 8,192) gives at least two blocks per
    SM on 132 SMs; the largest serving round splits."""
    assert reid_topk.split_plan(16, 128, 132) == (1, 1)
    nq, S = reid_topk.split_plan(256, 8192, 132)
    assert nq * S >= 2 * 132 and S > 1
    assert reid_topk.split_plan(20, 512, 132)[1] > 1
    assert reid_topk.split_plan(256, 8193, 132)[1] > 1


@pytest.mark.parametrize("k,K", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8),
                                 (9, 16), (16, 16)])
def test_round_k_is_the_kernels_template(k, K):
    assert reid_topk.round_k(k) == K


def _split_plain(plain, args_of, G, k, S):
    """``plain`` on each slice of a G-row gallery (``args_of(a, b)`` gives
    its arguments for rows [a, b)), lists of K = round_k(k) with global
    indices, then the merge pass: what the kernels compute with S
    slices."""
    parts = []
    for a, b in reid_topk.slices(G, S):
        v, i = plain(*args_of(a, b), reid_topk.round_k(k))
        parts.append((v, torch.where(i >= 0, i + a, i)))
    return ref.merge_topk(parts, k)


def _unmasked(q, g):
    return lambda a, b: (q, g[a:b])


def _masked(arrays):
    q, q_tag, admit, g, gal_cam, gal_tag = arrays
    return lambda a, b: (q, q_tag, admit, g[a:b], gal_cam[a:b],
                         gal_tag[a:b])


def _quantised(rng, shape):
    """Features in quarters of [-2, 2]: every product and partial sum is
    exact in float32, so a score's bits do not depend on how the gallery
    is cut, and equal rows tie exactly."""
    return (rng.integers(-8, 9, shape) / 4).astype(np.float32)


# (Q, G, D, k, what): every shape splits into several slices
SPLIT_CASES = [
    (70, 517, 16, 5, "ragged Q and G"),
    (33, 300, 8, 16, "k = 16 over one-tile slices"),
    (7, 70, 8, 16, "k larger than the last slice's 6 rows"),
    (64, 256, 16, 8, "ties across slice boundaries"),
    (20, 512, 64, 3, "the largest serving round"),
    (129, 1000, 4, 4, "integer-valued features"),
]


def _case_inputs(Q, G, D, what, seed):
    rng = np.random.default_rng(seed)
    if what == "integer-valued features":
        q = rng.integers(0, 2, (Q, D)).astype(np.float32)
        g = rng.integers(0, 2, (G, D)).astype(np.float32)
    else:
        q, g = _quantised(rng, (Q, D)), _quantised(rng, (G, D))
    if what == "ties across slice boundaries":
        for b in range(TILE, G, TILE):          # the rows either side tie
            g[b] = g[b - 1]
            g[b + 1] = g[b - 2]
    return q, g


@pytest.mark.parametrize("Q,G,D,k,what", SPLIT_CASES)
def test_unmasked_split_and_merge_equals_unsplit_bit_for_bit(Q, G, D, k,
                                                             what):
    q, g = (torch.from_numpy(a) for a in _case_inputs(Q, G, D, what, Q + G))
    want = ref.reid_topk_ref(q, g, k)
    ng = -(-G // TILE)
    for S in sorted({2, ng, max(2, ng // 2), reid_topk.split_plan(
            Q, G, 1)[1]}):
        got = _split_plain(ref.reid_topk_ref, _unmasked(q, g), G, k, S)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if what == "ties across slice boundaries":
        # the boundary pairs tie and both rank: the lower index first
        sv, si = want
        assert (sv[:, 1:] == sv[:, :-1]).any()


@pytest.mark.parametrize("Q,G,D,k,what", SPLIT_CASES + [
    (40, 400, 8, 6, "wholly masked slices"),
    (24, 333, 8, 16, "wholly ineligible slices"),
])
def test_masked_split_and_merge_equals_unsplit_bit_for_bit(Q, G, D, k,
                                                           what):
    arrays = list(make_inputs(Q * 7 + G, Q, G, D, 8, ties=True,
                              pad_rows=min(G // 5, 9)))
    arrays[0], arrays[3] = _case_inputs(Q, G, D, what, Q + G)
    if what == "wholly masked slices":
        # slices 1 and 3 hold only cameras 6 and 7, which nobody admits
        arrays[4][TILE:2 * TILE] = 6
        arrays[4][3 * TILE:4 * TILE] = 7
        arrays[2][:, 6:] = False
    if what == "wholly ineligible slices":
        # padded rows (cam -1) and foreign tags fill the middle slices
        arrays[4][TILE:3 * TILE] = -1
        arrays[5][3 * TILE:4 * TILE] = 99
    t = [torch.from_numpy(a) for a in arrays]
    want = ref.reid_topk_segments_ref(*t, k)
    ng = -(-G // TILE)
    for S in sorted({2, ng, max(2, ng // 2)}):
        got = _split_plain(ref.reid_topk_segments_ref, _masked(t), G, k,
                          S)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] >= 0).any()


def test_merge_pads_with_sentinels_and_orders_ties_by_index():
    """Fewer candidates than k: the tail is (NEG_INF, -1); equal scores
    from two lists come out lower index first, whatever the lists'
    order."""
    a = (torch.tensor([[2.0, 1.0]]),
         torch.tensor([[70, 3]], dtype=torch.int32))
    b = (torch.tensor([[2.0, ref.NEG_INF]]),
         torch.tensor([[5, -1]], dtype=torch.int32))
    v, i = ref.merge_topk([a, b], 5)
    assert torch.equal(v, torch.tensor(
        [[2.0, 2.0, 1.0, ref.NEG_INF, ref.NEG_INF]], dtype=torch.float32))
    assert i.tolist() == [[5, 70, 3, -1, -1]]
    v2, i2 = ref.merge_topk([b, a], 5)
    assert torch.equal(v, v2) and torch.equal(i, i2)


def test_split_and_merge_matches_pallas():
    """One split shape (five slices of a ragged gallery) held against the
    Pallas kernels in interpret mode: scores within 1e-5, indices exact
    on integer-valued features."""
    Q, G, D, k, S = 40, 300, 16, 5, 5
    q, g = topk_inputs(11, Q, G, D, ties=True)
    tq, tg = torch.from_numpy(q), torch.from_numpy(g)
    pv, pi = _split_plain(ref.reid_topk_ref, _unmasked(tq, tg), G, k, S)
    jv, ji = jops.reid_topk(jnp.asarray(q), jnp.asarray(g), k,
                            interpret=True)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    arrays = make_inputs(3, Q, G, D, 8, ties=True, pad_rows=12)
    t = [torch.from_numpy(a) for a in arrays]
    mv, mi = _split_plain(ref.reid_topk_segments_ref, _masked(t), G, k, S)
    jv, ji = jops.reid_topk_segments(*(jnp.asarray(a) for a in arrays), k)
    np.testing.assert_allclose(mv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
