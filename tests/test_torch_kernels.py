"""The port's re-id top-k (segment-masked and tile-masked) against the JAX
reference.

On the CPU the wrappers run the plain PyTorch version (``kernels/ref.py``);
it is held to the Pallas kernel in interpret mode (``repro.kernels.ops``)
and to ``repro.kernels.ref``: scores within 1e-5, indices exact on
integer-valued ties.  The CUDA kernel itself runs only on a card:
``test_torch_cuda.py`` holds it to the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref, reid_topk
from repro_torch.runtime.engine import _rank_outcome
from torch_cases import (CASES, TILE_CASES, camera_to_tiles,
                         make_inputs as _inputs, make_tile_inputs)

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(fn, arrays, k):
    sv, si = fn(*(torch.from_numpy(a) for a in arrays), k)
    return sv.numpy(), si.numpy()


def _jax(fn, arrays, k):
    sv, si = fn(*(jnp.asarray(a) for a in arrays), k)
    return np.asarray(sv), np.asarray(si)


@pytest.mark.parametrize("Q,G,D,C,k,opts", CASES)
@pytest.mark.parametrize("entry", ["masked", "segments"])
def test_plain_matches_pallas_and_ref(entry, Q, G, D, C, k, opts):
    arrays = _inputs(Q * 1000 + G, Q, G, D, C, **opts)
    pv, pi = _port(getattr(ref, f"reid_topk_{entry}_ref"), arrays, k)
    assert pv.shape == (Q, k) and pv.dtype == np.float32
    assert pi.dtype == np.int32
    # the wrapper on CPU tensors is the plain version
    wv, wi = _port(getattr(ops, f"reid_topk_{entry}"), arrays, k)
    np.testing.assert_array_equal(wv, pv)
    np.testing.assert_array_equal(wi, pi)
    jv, ji = _jax(getattr(jops, f"reid_topk_{entry}"), arrays, k)
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_array_equal(pi, ji)
    kk = min(k, G)
    rv, ri = _jax(getattr(jref, f"reid_topk_{entry}_ref"), arrays, kk)
    np.testing.assert_allclose(pv[:, :kk], rv, **TOL)
    np.testing.assert_array_equal(pi[:, :kk], ri)
    assert (pi[:, kk:] == -1).all() and (pv[:, kk:] < -1e29).all()
    if opts.get("masked_row"):
        assert (pi[0] == -1).all() and (pv[0] < -1e29).all()


def test_padded_rows_match_pallas_not_wrapping():
    """``gal_cam = -1`` rows are never eligible, even where every camera is
    admitted: the Pallas kernel's one-hot ignores them, while a plain
    gather ``admit[q, -1]`` would wrap to the last camera — which
    ``repro.kernels.ref`` does."""
    Q, G, D, C, k = 6, 40, 8, 4, 6
    arrays = list(_inputs(7, Q, G, D, C, pad_rows=15))
    arrays[2][:] = True                # every camera is admitted
    arrays[5][:] = 0
    arrays[1][:] = 0
    pv, pi = _port(ops.reid_topk_segments, arrays, k)
    jv, ji = _jax(jops.reid_topk_segments, arrays, k)
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_array_equal(pi, ji)
    assert not np.isin(pi[pi >= 0], np.arange(G - 15, G)).any()
    _, wrapped = _jax(jref.reid_topk_segments_ref, arrays, k)
    assert np.isin(wrapped, np.arange(G - 15, G)).any()


def test_tie_break_lower_index_wins():
    q = np.ones((1, 4), np.float32)
    g = np.ones((6, 4), np.float32)
    arrays = (q, np.zeros(1, np.int32), np.ones((1, 2), bool), g,
              np.array([1, 0, 1, 0, 1, 0], np.int32), np.zeros(6, np.int32))
    _, pi = _port(ops.reid_topk_masked, arrays, 4)
    np.testing.assert_array_equal(pi, [[0, 1, 2, 3]])


def test_empty_gallery_and_queries_give_sentinels():
    for Q, G in ((4, 0), (0, 5)):
        arrays = _inputs(1, max(Q, 1), max(G, 1), 8, 3)
        arrays = (arrays[0][:Q], arrays[1][:Q], arrays[2][:Q],
                  arrays[3][:G], arrays[4][:G], arrays[5][:G])
        before = reid_topk.LAUNCHES
        sv, si = _port(ops.reid_topk_segments, arrays, 3)
        assert sv.shape == (Q, 3) and (si == -1).all() and (sv < -1e29).all()
        assert reid_topk.LAUNCHES == before


def test_cpu_tensors_never_count_launches():
    before = reid_topk.LAUNCHES
    _port(ops.reid_topk_segments, _inputs(3, 9, 30, 8, 3), 2)
    assert reid_topk.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "k", "shape", "device_mix",
                                 "contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    t = [torch.from_numpy(a) for a in _inputs(5, 4, 10, 8, 3)]
    k = 2
    if bad == "dtype":
        t[0] = t[0].double()
    elif bad == "k":
        k = reid_topk.MAX_K + 1
    elif bad == "shape":
        t[4] = t[4][:-1]
    elif bad == "device_mix":
        t[1] = t[1].to("meta")
    elif bad == "contiguous":
        t[3] = torch.from_numpy(np.asfortranarray(t[3].numpy()))
    with pytest.raises((TypeError, ValueError)):
        ops.reid_topk_segments(*t, k)


def test_argmax_takes_the_first_maximum():
    """``_rank_outcome`` relies on ``torch.argmax`` returning the first
    maximum, as ``jnp.argmax`` does (the card's side is in
    ``test_torch_cuda.py``)."""
    x = torch.tensor([[1.0, 3.0, 3.0], [0.0, 0.0, 0.0], [2.0, 1.0, 2.0]])
    np.testing.assert_array_equal(torch.argmax(x, 1).numpy(), [1, 0, 0])
    np.testing.assert_array_equal(np.asarray(jnp.argmax(jnp.asarray(
        x.numpy()), axis=1)), [1, 0, 0])
    b = torch.tensor([[False, True, True], [False, False, False]])
    np.testing.assert_array_equal(torch.argmax(b.to(torch.uint8), 1).numpy(),
                                  [1, 0])


@pytest.mark.parametrize("rerank", [False, True])
def test_rank_outcome_matches_reference(rerank):
    """The outcome half of a round against ``repro``'s: sentinel bands
    (idx -1) vote for no camera (``jax.nn.one_hot(-1)`` is all-zero, while
    ``torch.nn.functional.one_hot(-1)`` raises), and tied votes go to the
    first camera, as ``jnp.argmax`` gives."""
    from repro.runtime.engine import _rank_outcome as j_rank_outcome
    rng = np.random.default_rng(11)
    Q, k, G, D, C = 64, 4, 12, 8, 5
    sv = -np.sort(-rng.choice([0.9, 0.8, 0.75, 0.5], (Q, k)), axis=1)
    si = rng.integers(0, G, (Q, k)).astype(np.int32)
    tail = rng.integers(0, k + 1, Q)
    for q in range(Q):
        sv[q, tail[q]:], si[q, tail[q]:] = -1e30, -1
    sv = sv.astype(np.float32)
    gallery = rng.normal(size=(G, D)).astype(np.float32)
    gal_cam = rng.integers(0, C, G).astype(np.int32)
    gal_frame = rng.integers(0, 50, G).astype(np.int32)
    arrays = (sv, si, gallery, gal_cam, gal_frame)
    got = _rank_outcome(*(torch.from_numpy(a) for a in arrays), 0.28, C,
                        rerank)
    want = j_rank_outcome(*(jnp.asarray(a) for a in arrays), 0.28, C, rerank)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rank_outcome_empty_gallery_defined():
    """G == 0 (where the reference's gathers fail): nothing matches, band 0
    is (NEG_INF, -1), the embedding is zero."""
    Q, k, D = 3, 2, 8
    sv, si = reid_topk._empty(Q, k, "cpu")
    gal = torch.zeros((0, D))
    e = torch.zeros(0, dtype=torch.int32)
    for rerank in (False, True):
        m, mc, me, tv, ti, tc, tf = _rank_outcome(sv, si, gal, e, e, 0.28,
                                                  4, rerank)
        assert not m.any() and (mc == 0).all() and (me == 0).all()
        assert (ti[:, 0] == -1).all() and (tv[:, 0] < -1e29).all()
        assert (tc == -1).all() and (tf == -1).all()
        assert me.shape == (Q, D)


def test_build_names_library_by_source_hash():
    p = build.library_path("reid_topk")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p == build.library_path("reid_topk")
    assert (build.CSRC / "reid_topk.cu").is_file()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    if build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.build("reid_topk")


# -- the tile-masked variant ------------------------------------------------

@pytest.mark.parametrize("Q,G,D,C,T,k,opts", TILE_CASES)
def test_tiles_plain_matches_pallas_and_ref(Q, G, D, C, T, k, opts):
    arrays = make_tile_inputs(Q * 1000 + G, Q, G, D, C, T, **opts)
    pv, pi = _port(ref.reid_topk_tiles_ref, arrays, k)
    assert pv.shape == (Q, k) and pv.dtype == np.float32
    assert pi.dtype == np.int32
    wv, wi = _port(ops.reid_topk_tiles, arrays, k)
    np.testing.assert_array_equal(wv, pv)
    np.testing.assert_array_equal(wi, pi)
    jv, ji = _jax(jops.reid_topk_tiles, arrays, k)
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_array_equal(pi, ji)
    kk = min(k, G)
    rv, ri = _jax(jref.reid_topk_tiles_ref, arrays, kk)
    np.testing.assert_allclose(pv[:, :kk], rv, **TOL)
    np.testing.assert_array_equal(pi[:, :kk], ri)
    assert (pi[:, kk:] == -1).all() and (pv[:, kk:] < -1e29).all()
    if opts.get("masked_row"):
        assert (pi[0] == -1).all() and (pv[0] < -1e29).all()
    if opts.get("unlabeled"):
        unlabeled = np.flatnonzero(arrays[4] < 0)
        assert not np.isin(pi, unlabeled).any()


def test_tiles_out_of_range_cells_match_pallas_not_clamping():
    """Cells at or past CT are never eligible, as in the Pallas kernel's
    one-hot; ``repro.kernels.ref`` gathers them clamped to the last
    cell."""
    Q, G, D, C, T, k = 6, 60, 8, 3, 2, 6
    arrays = list(make_tile_inputs(9, Q, G, D, C, T, out_of_range=25,
                                   n_tags=1))
    arrays[2][:] = True                 # every cell is admitted
    far = np.flatnonzero(arrays[4] >= C * T * T)
    assert len(far) == 25
    pv, pi = _port(ops.reid_topk_tiles, arrays, k)
    jv, ji = _jax(jops.reid_topk_tiles, arrays, k)
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_array_equal(pi, ji)
    assert not np.isin(pi, far).any()
    _, clamped = _jax(jref.reid_topk_tiles_ref, arrays, k)
    assert np.isin(clamped, far).any()


@pytest.mark.parametrize("Q,G,D,C,k,opts", CASES)
@pytest.mark.parametrize("T", [2, 8])
def test_tiles_all_admitted_bit_identical_to_segments(T, Q, G, D, C, k,
                                                       opts):
    arrays = _inputs(Q * 1000 + G, Q, G, D, C, pad_rows=min(G // 4, 9),
                     **opts)
    sv, si = _port(ops.reid_topk_segments, arrays, k)
    tv, ti = _port(ops.reid_topk_tiles, camera_to_tiles(arrays, T), k)
    np.testing.assert_array_equal(tv, sv)
    np.testing.assert_array_equal(ti, si)


def test_tiles_empty_inputs_and_cpu_never_count_launches():
    before = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
    for Q, G in ((4, 0), (0, 5)):
        a = make_tile_inputs(1, max(Q, 1), max(G, 1), 8, 3, 2)
        a = (a[0][:Q], a[1][:Q], a[2][:Q], a[3][:G], a[4][:G], a[5][:G])
        sv, si = _port(ops.reid_topk_tiles, a, 3)
        assert sv.shape == (Q, 3) and (si == -1).all() and (sv < -1e29).all()
        jv, ji = _jax(jops.reid_topk_tiles, a, 3)
        np.testing.assert_array_equal(sv, jv)
        np.testing.assert_array_equal(si, ji)
    _port(ops.reid_topk_tiles, make_tile_inputs(2, 9, 30, 8, 3, 4), 2)
    assert (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["dtype", "k", "shape", "device_mix",
                                 "contiguous"])
def test_tiles_wrapper_rejects_bad_inputs(bad):
    t = [torch.from_numpy(a) for a in make_tile_inputs(5, 4, 10, 8, 3, 2)]
    k = 2
    if bad == "dtype":
        t[4] = t[4].long()
    elif bad == "k":
        k = 0
    elif bad == "shape":
        t[2] = t[2][:-1]
    elif bad == "device_mix":
        t[5] = t[5].to("meta")
    elif bad == "contiguous":
        t[0] = torch.from_numpy(np.asfortranarray(t[0].numpy()))
    with pytest.raises((TypeError, ValueError), match="|".join(
            ["gal_ct", "k=", "admit_ct", "gal_tag", "queries"])):
        ops.reid_topk_tiles(*t, k)


def test_tile_kernel_limits_and_source():
    """The tile kernel runs on the gallery-split design: it includes
    ``reid_split.cuh``, which skips dead tiles with ``__syncthreads_or``;
    the first design's header and its cell limit are gone; its library is
    its own."""
    assert not hasattr(reid_topk, "MAX_CELLS")
    assert not (build.CSRC / "topk.cuh").exists()
    src = (build.CSRC / "reid_topk_tiles.cu").read_text()
    assert '#include "reid_split.cuh"' in src
    assert "__syncthreads_or" in (build.CSRC / "reid_split.cuh").read_text()
    assert build.library_path("reid_topk_tiles") != \
        build.library_path("reid_topk")
