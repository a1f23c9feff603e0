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
    for name in ("runtime.engine", "kernels.reid_topk",
                 "kernels.flash_attention", "kernels.decode_attention",
                 "kernels.mamba_scan", "kernels.ops", "kernels.build",
                 "benchmarks.kernels_bench", "core.tracker", "core.detect",
                 "examples.quickstart", "examples.identity_detection",
                 "runtime.recal", "benchmarks.drift",
                 "benchmarks.scenarios", "runtime.fleet", "runtime.cluster",
                 "runtime.transport", "runtime.gallery", "benchmarks.tables",
                 "benchmarks.run", "examples.serve_streams",
                 "models", "models.config", "models.layers",
                 "models.attention", "models.model", "configs",
                 "configs.yi_6b", "configs.command_r_plus_104b"):
        assert f"repro_torch.{name}" in mods, name
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
    # importing the examples runs nothing: their work waits for __main__
    assert r.stdout.strip() == "[]", r.stdout


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


def test_analysis_plane_and_its_gate_import_without_jax_or_repro():
    """``repro_torch.analysis`` and ``scripts/torch_check_invariants.py``
    (run at HEAD and on its corpus) pull in neither ``jax`` nor ``repro``."""
    mods = _port_modules()
    for name in ("analysis", "analysis.lint"):
        assert f"repro_torch.{name}" in mods, name
    script = os.path.join(REPO, "scripts", "torch_check_invariants.py")
    code = (
        "import importlib, importlib.util, sys\n"
        "importlib.import_module('repro_torch.analysis')\n"
        "importlib.import_module('repro_torch.analysis.lint')\n"
        "spec = importlib.util.spec_from_file_location('gate', "
        f"{script!r})\n"
        "gate = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(gate)\n"
        "head, fixtures = gate.main([]), gate.main(['--fixtures'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('RESULT', head, fixtures, bad)\n"
        "assert not bad, bad\n")
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "RESULT 0 1 []", r.stdout


def test_kernel_audit_and_its_gate_layer_import_without_jax_or_repro():
    """``repro_torch.analysis.kernel_audit`` and the gate's ``kernel``
    layer (``--only kernel``), run at HEAD, and the memcheck script's
    imports pull in neither ``jax`` nor ``repro``."""
    mods = _port_modules()
    assert "repro_torch.analysis.kernel_audit" in mods
    script = os.path.join(REPO, "scripts", "torch_check_invariants.py")
    memcheck = os.path.join(REPO, "scripts", "torch_kernel_memcheck.py")
    code = (
        "import importlib, importlib.util, sys\n"
        "importlib.import_module('repro_torch.analysis.kernel_audit')\n"
        "spec = importlib.util.spec_from_file_location('gate', "
        f"{script!r})\n"
        "gate = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(gate)\n"
        "spec = importlib.util.spec_from_file_location('memcheck', "
        f"{memcheck!r})\n"
        "memcheck = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(memcheck)\n"
        "rc = gate.main(['--only', 'kernel'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('RESULT', rc, bad)\n"
        "assert not bad, bad\n")
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "RESULT 0 []", r.stdout
