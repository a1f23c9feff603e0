"""The port's examples print what the JAX package's print: the same
lines, with the same numbers, on the CPU."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable] + argv, cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout.splitlines()


@pytest.mark.parametrize("name", ["quickstart", "identity_detection"])
def test_example_prints_the_reference_lines(name):
    want = _run([os.path.join("examples", f"{name}.py")])
    got = _run(["-m", f"repro_torch.examples.{name}", "--device", "cpu"])
    assert len(want) > 3
    assert got == want


def test_serve_streams_prints_the_reference_lines():
    """The serving demo: the reference's lines, the first with the device
    in front, all but the host-clock ``wall:`` line equal."""
    want = _run([os.path.join("examples", "serve_streams.py")])
    got = _run(["-m", "repro_torch.examples.serve_streams", "--device",
                "cpu"])
    assert len(want) > 6 and len(got) == len(want)
    assert got[0] == "device=cpu " + want[0]
    assert [ln for ln in got[1:] if not ln.startswith("wall:")] == \
        [ln for ln in want[1:] if not ln.startswith("wall:")]
    assert [ln.startswith("wall:") for ln in got] == \
        [ln.startswith("wall:") for ln in want]
