"""The training path's host parts against the JAX reference on the CPU:
``repro_torch.optim`` (the schedule, AdamW with and without master
weights, clipping, int8 error-feedback compression),
``repro_torch.data`` (the synthetic streams) and
``repro_torch.checkpoint`` (round trips, bfloat16 leaves, crash litter,
asynchronous retention, resume), mirroring ``tests/test_services.py`` and
``tests/test_perf_flags.py``'s master-weight case.

Tolerances: the schedule and the AdamW moments and parameters are float32
on both sides, computed by the same formulas in the same order of
operations per element; XLA may contract a multiply and an add into one
fused rounding, so they are held within 2 ulps (rtol 2.5e-7) where not
bit-equal.  The int8 codes, the scales and the residuals, the streams'
batches and every checkpoint round trip are bit-equal."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as RC
from repro import data as RD
from repro import optim as RO
from repro_torch import tree as T
from repro_torch.checkpoint import (CheckpointManager, gc_checkpoints,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.data import FrameEmbedStream, SyntheticLMStream
from repro_torch.optim import (OptConfig, adamw_update,
                               compress_with_feedback, dequantize_int8,
                               global_norm, init_compression_state,
                               init_opt_state, lr_at, quantize_int8)

RTOL = 2.5e-7


def _tree(seed: int) -> dict:
    """A parameter tree with a matrix, a vector and a list of layers."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(4, 3), "b": f(3),
            "layers": [{"a": f(2, 5), "s": f(5)} for _ in range(2)]}


def _torch(tree, dtype=torch.float32):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _assert_trees(got, want, rtol=RTOL, what=""):
    got_l, paths = T.flatten(got)
    want_l = T.leaves_at(jax.tree.map(np.asarray, want), paths)
    assert len(got_l) == len(T.leaves(want))
    for path, g, w in zip(paths, got_l, want_l):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=rtol,
                                   atol=0, err_msg=f"{what} {path}")


# -- the schedule and AdamW ---------------------------------------------------

@pytest.mark.parametrize("cfg", [
    OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    OptConfig(), OptConfig(warmup_steps=0, total_steps=7)])
def test_lr_at_over_a_step_sweep(cfg):
    ref_cfg = RO.OptConfig(**{f: getattr(cfg, f) for f in
                              cfg.__dataclass_fields__})
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 10_000, 20_000):
        got = lr_at(torch.tensor(step, dtype=torch.int32), cfg)
        want = RO.lr_at(jnp.asarray(step, jnp.int32), ref_cfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   err_msg=str(step))


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", [1.0, 1e6])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_against_the_reference(master, clip, steps):
    """One or three updates, clipping on (clip_norm 1 against gradients
    of norm ~30) or off; with master weights the parameters are
    bfloat16 and the update applies to the float32 master."""
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, clip_norm=clip)
    p_np = _tree(0)
    dtype_t = torch.bfloat16 if master else torch.float32
    dtype_j = jnp.bfloat16 if master else jnp.float32
    pt, pj = _torch(p_np, dtype_t), _jax(p_np, dtype_j)
    st = init_opt_state(pt, master_weights=master)
    sj = RO.init_opt_state(pj, master_weights=master)
    for i in range(steps):
        g_np = jax.tree.map(lambda a: 10 * a, _tree(100 + i))
        with torch.no_grad():
            pt, st, mt = adamw_update(pt, _torch(g_np), st, OptConfig(**cfg))
        pj, sj, mj = RO.adamw_update(pj, _jax(g_np), sj,
                                     RO.OptConfig(**cfg))
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=RTOL)
        assert float(mt["lr"]) == float(mj["lr"])
    assert int(st["step"]) == int(sj["step"]) == steps
    _assert_trees(st["m"], sj["m"], what="m")
    _assert_trees(st["v"], sj["v"], what="v")
    if master:
        _assert_trees(st["master"], sj["master"], what="master")
        # the bfloat16 parameters are the master's casts: bit-equal where
        # the masters agree to the bit, one bfloat16 ulp at most elsewhere
        _assert_trees(pt, pj, rtol=2 ** -7, what="params")
        assert all(p.dtype == torch.bfloat16 for p in T.leaves(pt))
    else:
        _assert_trees(pt, pj, what="params")


def test_adamw_reduces_quadratic_loss():
    w = {"w": torch.tensor([3.0, -2.0, 1.0])}
    opt = init_opt_state(w)
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    for _ in range(100):
        with torch.no_grad():
            w, opt, _ = adamw_update(w, {"w": 2 * w["w"]}, opt, cfg)
    assert float(w["w"].abs().max()) < 0.2
    assert int(opt["step"]) == 100


def test_grad_clipping_reports_the_norm_before_clipping():
    w = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 1e6)}
    _, _, m = adamw_update(w, g, init_opt_state(w),
                           OptConfig(lr=1e-3, warmup_steps=0,
                                     weight_decay=0.0))
    assert float(m["grad_norm"]) > 1e6
    assert float(global_norm(g)) == float(m["grad_norm"])


def test_master_weight_optimizer_matches_fp32():
    """bf16 params + fp32 master == fp32 params after a step (the master
    path), the port's counterpart of test_perf_flags' case."""
    w32 = {"w": torch.linspace(-1, 1, 64)}
    w16 = {"w": w32["w"].to(torch.bfloat16)}
    g = {"w": torch.sin(torch.arange(64.0)) * 0.1}
    cfg = OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.0)
    p32, _, _ = adamw_update(w32, g, init_opt_state(w32), cfg)
    p16, o16, _ = adamw_update(w16, {"w": g["w"].to(torch.bfloat16)},
                               init_opt_state(w16, master_weights=True), cfg)
    np.testing.assert_allclose(o16["master"]["w"].numpy(),
                               p32["w"].numpy(), rtol=1e-2, atol=1e-4)
    assert p16["w"].dtype == torch.bfloat16
    assert o16["master"]["w"].dtype == torch.float32


# -- int8 error-feedback compression ----------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_quantize_int8_codes_bit_equal(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(257) * 10.0 ** rng.integers(-3, 3)).astype(
        np.float32)
    x[:3] = [0.5, -0.5, 1.5]              # halves: round half to even
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = RO.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(RO.dequantize_int8(rq, rs)))
    err = (dequantize_int8(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_bit_equal_over_steps():
    """50 steps of ``compress_with_feedback``: the codes, scales and
    residuals equal the reference's bit for bit at every step, and the
    residual stays bounded (the compression error does not accumulate)."""
    rng = np.random.default_rng(0)
    err = init_compression_state({"g": torch.zeros(256)})["g"]
    rerr = jnp.zeros((256,))
    true_sum = np.zeros(256, np.float32)
    deq_sum = torch.zeros(256)
    for _ in range(50):
        g = rng.standard_normal(256).astype(np.float32)
        q, s, err = compress_with_feedback(torch.from_numpy(g), err)
        rq, rs, rerr = RO.compress.compress_with_feedback(jnp.asarray(g),
                                                          rerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(err.numpy(), np.asarray(rerr))
        deq_sum = deq_sum + dequantize_int8(q, s)
        true_sum = true_sum + g
    assert float((deq_sum + err - torch.from_numpy(true_sum)).abs().max()) \
        < 1e-3


# -- the data streams --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=64, seq_len=32, global_batch=4, seed=1),
    dict(vocab_size=8192, seq_len=256, global_batch=16, seed=0),
    dict(vocab_size=64, seq_len=16, global_batch=8, seed=2, branching=4,
         process_index=1, process_count=2)])
def test_stream_batches_and_state_bit_equal(kw):
    ours, theirs = SyntheticLMStream(**kw), RD.SyntheticLMStream(**kw)
    for _ in range(3):
        a, b = ours.next_batch()["tokens"], theirs.next_batch()["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert ours.state_dict() == theirs.state_dict()
    resumed = SyntheticLMStream(**kw)
    resumed.load_state_dict(theirs.state_dict())
    np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                  theirs.next_batch()["tokens"])
    with pytest.raises(ValueError, match="seed"):
        resumed.load_state_dict({"cursor": 0, "seed": kw["seed"] + 1})


def test_stream_host_sharding_disjoint():
    h0 = SyntheticLMStream(vocab_size=64, seq_len=16, global_batch=8, seed=2,
                           process_index=0, process_count=2)
    h1 = SyntheticLMStream(vocab_size=64, seq_len=16, global_batch=8, seed=2,
                           process_index=1, process_count=2)
    assert h0.local_batch == h1.local_batch == 4
    assert not np.array_equal(h0.next_batch()["tokens"],
                              h1.next_batch()["tokens"])


def test_frame_stream_bit_equal():
    ours = FrameEmbedStream(n_frames=30, d_model=16, global_batch=4, seed=3)
    theirs = RD.FrameEmbedStream(n_frames=30, d_model=16, global_batch=4,
                                 seed=3)
    for _ in range(2):
        np.testing.assert_array_equal(ours.next_batch()["frames"],
                                      theirs.next_batch()["frames"])


# -- checkpoints --------------------------------------------------------------

def test_checkpoint_roundtrip_with_bfloat16(tmp_path):
    """numpy arrays and scalars come back as the reference's do; tensors
    as numpy arrays of their dtype, bfloat16 ones bit for bit as bfloat16
    tensors (saved as uint16 bits)."""
    bf = torch.randn(5, 3).to(torch.bfloat16)
    tree = {"a": np.arange(6).reshape(2, 3), "b": {"c": np.float32(2.5)},
            "t": torch.arange(4, dtype=torch.int32), "bf": bf,
            "layers": [{"w": torch.randn(2, 2)}, {"w": torch.randn(2, 2)}]}
    save_checkpoint(str(tmp_path), 7, tree)
    step, back = restore_checkpoint(str(tmp_path))
    assert step == 7
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["b"]["c"] == tree["b"]["c"]
    np.testing.assert_array_equal(back["t"], tree["t"].numpy())
    assert back["bf"].dtype == torch.bfloat16 and torch.equal(back["bf"], bf)
    for i in range(2):
        np.testing.assert_array_equal(back["layers"][i]["w"],
                                      tree["layers"][i]["w"].numpy())
    rtree = {"a": np.arange(6).reshape(2, 3), "b": {"c": np.float32(2.5)}}
    RC.save_checkpoint(str(tmp_path / "ref"), 7, rtree)
    _, rback = RC.restore_checkpoint(str(tmp_path / "ref"))
    np.testing.assert_array_equal(back["a"], rback["a"])
    assert back["b"]["c"] == rback["b"]["c"]


def test_checkpoint_crash_litter_ignored_and_collected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": np.ones(3)})
    litter = tmp_path / "step_00000002.tmp-dead"
    litter.mkdir()
    (litter / "leaf_00000.npy").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == RC.latest_step(str(tmp_path)) == 1
    assert restore_checkpoint(str(tmp_path))[0] == 1
    gc_checkpoints(str(tmp_path), keep=3)
    assert not litter.exists()
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


def test_checkpoint_manager_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]
    step, tree = mgr.restore_latest()
    assert step == 4 and tree["x"][0] == 4


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """The snapshot is on the caller's thread: overwriting the tensor
    right after ``save`` does not change what is written."""
    mgr = CheckpointManager(str(tmp_path))
    x = torch.zeros(1000)
    mgr.save(1, {"x": x})
    x.fill_(7.0)
    mgr.wait()
    assert float(restore_checkpoint(str(tmp_path))[1]["x"].max()) == 0.0


def test_restart_resumes_from_latest(tmp_path):
    """Simulated failure: train 3 steps, crash, resume at step 3."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"w": torch.zeros(2), "stream": {"cursor": 0, "seed": 0}}
    for s in range(1, 4):
        state = {"w": state["w"] + 1, "stream": {"cursor": s, "seed": 0}}
        mgr.save(s, state, blocking=True)
    del mgr, state
    step, state = CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 3 and state["w"][0] == 3
    assert int(state["stream"]["cursor"]) == 3
