"""The paper's tables on the port (``repro_torch.benchmarks.tables``)
against ``benchmarks/tables.py``, on small worlds swapped into both
packages' scenario modules (``torch_bench_cases``): every row's name and
count columns equal, the host-clock microseconds left out.  Also the
suite's command line (``repro_torch.benchmarks.run``)."""
import os
import subprocess
import sys

import pytest

import torch_bench_cases as cases

one_thread = pytest.fixture(autouse=True)(cases.one_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TABLES = ["sec3_potential", "fig10_anoncampus", "fig11_duke", "fig12_porto",
          "fig13_camera_scaling", "fig14_frame_skipping", "fig15_replay",
          "fig16_profiling", "fig17_identity_detection"]


@pytest.mark.parametrize("name", TABLES)
def test_table_rows_equal_the_reference(monkeypatch, name):
    from benchmarks import tables as j_tables
    from repro_torch.benchmarks import tables as t_tables

    cases.small_worlds(monkeypatch)
    want, _ = cases.without_clock(getattr(j_tables, name)())
    got, _ = cases.without_clock(getattr(t_tables, name)(device="cpu"))
    assert len(want) >= 4
    assert got == want


def test_fig17_runs_the_detection_it_reports(monkeypatch):
    """The small duke world keeps fig17's search start inside its horizon:
    every theta row scans and reports at least one round."""
    from repro_torch.benchmarks import tables

    cases.small_worlds(monkeypatch)
    rows = dict((n, d) for n, _, d in tables.fig17_identity_detection(
        device="cpu"))
    for theta in (0.95, 0.85, 0.75):
        d = dict(kv.split("=", 1) for kv in rows[f"fig17/theta{theta}"]
                 .split(";"))
        assert int(d["rounds"]) >= 1 and float(d["cost"]) > 0


def test_run_has_the_reference_entries_each_taking_device():
    import inspect

    from benchmarks import run as j_run
    from repro_torch.benchmarks import run as t_run

    assert list(t_run.ALL) == list(j_run.ALL)
    for name, fn in t_run.ALL.items():
        assert "device" in inspect.signature(fn).parameters, name


def _run_cli(*argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run",
                           *argv], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_run_cli_prints_sec3_and_exits_0(tmp_path):
    r = _run_cli("--device", "cpu", "--only", "sec3_potential",
                 "--bench-dir", str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "sec3/peers_ge_5pct", "sec3/spatial_only_potential",
        "sec3/temporal_only_potential", "sec3/combined_potential",
        "sec3/travel_stats"]
    assert "# sec3_potential done in" in r.stderr


def test_run_cli_exits_nonzero_when_an_entry_raises(tmp_path):
    """An entry that raises prints the reference's ERROR row, the suite goes
    on to the next entry, and the exit code is 1."""
    script = tmp_path / "boom.py"
    script.write_text(
        "import sys\n"
        "from repro_torch.benchmarks import run, tables\n"
        "def boom(*, device):\n"
        "    raise RuntimeError('kernel failed')\n"
        "run.ALL['fig10_anoncampus'] = boom\n"
        "sys.exit(run.main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, str(script), "--device", "cpu",
                        "--only", "fig10_anoncampus", "sec3_potential"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "fig10_anoncampus/ERROR,0,RuntimeError: kernel failed" in r.stdout
    assert "sec3/travel_stats" in r.stdout


def test_run_cli_default_device_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    r = _run_cli("--only", "sec3_potential")
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr
    assert "sec3/" not in r.stdout
