"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` pulls in ``jax`` or the JAX package ``repro`` (the
machine with the card has no JAX), and ``chip_smoke.py`` refuses to run
without a card or without the repository beside it."""
import os
import pkgutil
import shutil
import subprocess
import sys

import repro_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _run(code, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=180)


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.runtime.engine" in mods
    assert "repro_torch.kernels.reid_topk" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=180,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=180,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                PYTHONPATH=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
