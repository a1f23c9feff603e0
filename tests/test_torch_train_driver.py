"""The training driver, ``repro_torch.launch.train``, on the CPU: its
logged losses against the reference driver's (``repro.launch.train``) at
the same flags, started from the same weights (the reference driver's
``init_params(cfg, PRNGKey(0))``, carried over by ``params_from_numpy``);
its checkpoints and a resume that ends bit-equal to the uninterrupted
run; ``scaled_config``; and ``examples/train_backbone.py``'s flags.

The smoke config computes in bfloat16 on both sides, which round at other
points (``tests/test_torch_models.py``), so the logged losses are held
within LOSS_TOL = 2e-3 relative (measured 1.4e-4 at both logged steps)
and the gradient norms within 2e-2 (measured 1.5e-3); the learning rates
are equal."""
import dataclasses
import functools
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_smoke_config
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.convert import params_from_numpy
from repro_torch.examples import train_backbone
from repro_torch.launch import train as PT
from repro_torch import tree as T

ARGS = ["--arch", "yi_6b", "--smoke", "--steps", "12", "--seq", "32",
        "--batch", "4", "--ckpt-every", "5"]
LOSS_TOL = 2e-3
LINE = re.compile(r"step\s+(\d+)\s+loss\s+([-\d.]+)\s+lr\s+(\S+)\s+gnorm\s+"
                  r"([-\d.]+)")


def _steps(out: str) -> dict:
    return {int(m.group(1)): (float(m.group(2)), float(m.group(3)),
                              float(m.group(4)))
            for m in LINE.finditer(out)}


@functools.lru_cache(maxsize=None)
def _reference_params():
    cfg = get_smoke_config("yi_6b")
    return jax.tree.map(np.asarray, R.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture
def same_start(monkeypatch):
    """The port's driver starts from the reference driver's weights."""
    def init(cfg, seed, *, device):
        held = dataclasses.replace(cfg, dtype=cfg.param_dtype)
        return params_from_numpy(held, _reference_params(), device=device)

    monkeypatch.setattr(PT, "init_train_params", init)


def _port(capsys, *extra):
    PT.main(ARGS + ["--device", "cpu", *extra])
    return capsys.readouterr().out


def test_losses_equal_the_reference_drivers(capsys, monkeypatch, same_start):
    import repro.launch.train as RT

    monkeypatch.setattr(sys, "argv", ["train"] + ARGS)
    RT.main()
    want = _steps(capsys.readouterr().out)
    out = _port(capsys)
    got = _steps(out)
    assert sorted(got) == sorted(want) == [1, 10]
    assert out.splitlines()[0] == "arch=yi-smoke family=dense params~0.2M"
    assert out.splitlines()[-1] == "done"
    for step, (loss, lr, gnorm) in want.items():
        assert abs(got[step][0] - loss) <= LOSS_TOL * loss, (step, got, want)
        assert got[step][1] == lr
        assert abs(got[step][2] - gnorm) <= 2e-2 * gnorm, (step, got, want)


def test_resume_ends_bit_equal_to_the_uninterrupted_run(capsys, tmp_path,
                                                        same_start):
    """A run killed after its step-10 checkpoint: its newest checkpoint
    (step 12, the final one) removed, run again, it resumes at step 10 and
    ends on the same bits as the uninterrupted run; the stream's cursor
    rides along."""
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    _port(capsys, "--ckpt", whole)
    _port(capsys, "--ckpt", cut)
    assert latest_step(cut) == 12
    import shutil
    shutil.rmtree(f"{cut}/step_00000012")
    out = _port(capsys, "--ckpt", cut)
    assert "resumed from step 10" in out
    assert sorted(_steps(out)) == []        # steps 11 and 12 log nothing
    (sw, tw), (sc, tc) = restore_checkpoint(whole), restore_checkpoint(cut)
    assert sw == sc == 12
    lw, paths = T.flatten(tw)
    lc = T.leaves_at(tc, paths)
    assert len(lw) == len(T.leaves(tc))
    for path, a, b in zip(paths, lw, lc):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    assert int(tw["stream"]["cursor"]) == 12


def test_scaled_config_is_the_references():
    from repro.launch.train import scaled_config as ref_scaled

    for arch in ("yi_6b", "qwen3_moe_30b", "zamba2_2p7b", "whisper_tiny"):
        got, want = PT.scaled_config(arch, 512, 8), ref_scaled(arch, 512, 8)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert got.param_count() == want.param_count()
    assert PT.scaled_config("yi_6b", 512, 8).param_count() == 30_351_872


def test_train_backbone_example_flags(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(train_backbone, "train_main", seen.append)
    train_backbone.main(device="cpu", ckpt=str(tmp_path))
    assert seen == [["--arch", "yi_6b", "--steps", "200", "--d-model", "384",
                     "--layers", "6", "--seq", "256", "--batch", "8",
                     "--ckpt", str(tmp_path), "--device", "cpu"]]


def test_the_driver_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.main(ARGS)


def test_flags_train_bf16_params_and_resume_bit_equal(capsys, tmp_path):
    """``--flags bf16_params,pad_vocab``: the parameters are held in
    bfloat16 with the optimizer's float32 master, both in the checkpoint,
    the parameters the master's casts; a resume from the step-10
    checkpoint ends on the uninterrupted run's bits, the master included."""
    flags = ["--flags", "bf16_params,pad_vocab"]
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    out = _port(capsys, "--ckpt", whole, *flags)
    assert sorted(_steps(out)) == [1, 10]
    assert all(np.isfinite(v[0]) for v in _steps(out).values())
    _port(capsys, "--ckpt", cut, *flags)
    import shutil
    shutil.rmtree(f"{cut}/step_00000012")
    assert "resumed from step 10" in _port(capsys, "--ckpt", cut, *flags)
    (sw, tw), (sc, tc) = restore_checkpoint(whole), restore_checkpoint(cut)
    assert sw == sc == 12
    lw, paths = T.flatten(tw)
    for path, a, b in zip(paths, lw, T.leaves_at(tc, paths)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), path
    params, paths = T.flatten(tw["params"])
    masters = T.leaves_at(tw["opt"]["master"], paths)
    assert params and len(masters) == len(params)
    for path, p, m in zip(paths, params, masters):
        p, m = torch.as_tensor(p), torch.as_tensor(m)
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32, path
        assert torch.equal(p, m.to(torch.bfloat16)), path


def test_the_driver_refuses_an_unknown_flag(capsys):
    with pytest.raises(SystemExit):
        PT.main(ARGS + ["--device", "cpu", "--flags", "causal_skip"])
    assert "causal_skip" in capsys.readouterr().err
