#!/usr/bin/env python
"""The port's static invariant gate: the lint of ``repro_torch.analysis``
over ``src/repro_torch``, as one blocking step; the counterpart of
``scripts/check_invariants.py``.

Default mode runs every layer at HEAD, the lint under the host-sync
baseline (``repro_torch.analysis.lint.SYNC_BASELINE``), and exits non-zero
on ANY finding:

    PYTHONPATH=src python scripts/torch_check_invariants.py

Layers (select a subset with ``--only``):

* ``lint`` — AST rules REX001, REX002 and REX004 over ``src/repro_torch``
  (see ``repro_torch.analysis.lint.RULES``).  A hot function with more
  host syncs than its baseline entry, or fewer, is a finding.
* ``kernel`` — the launch-bounds proof of the CUDA launchers over the
  shape sweep at every SM count, the wrappers' routing and refusals, and
  the ``(NEG_INF, -1)`` sentinel probes on the plain versions
  (``repro_torch.analysis.kernel_audit.audit_kernels``; CPU only, about
  5 s).  The compiled guards and the guard bands need a card:
  ``chip_smoke.py`` phase 23.

``--fixtures`` mode lints the planted-violation corpus under
``tests/fixtures/torch_analysis`` instead, without the baseline, and exits
NON-zero when — and only when — every ``# rex-expect: REXNNN=n``
expectation is met exactly and every rule fired: run it as
``! torch_check_invariants.py --fixtures``, so that a rule that stops
firing (or fires somewhere unexpected) fails the inverted gate.
``tests/test_torch_analysis.py`` holds the per-rule exactness tests.
"""
from __future__ import annotations

import argparse
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_analysis")

LAYERS = ("lint", "kernel")
_EXPECT_RE = re.compile(r"#\s*rex-expect:\s*(REX\d+)\s*=\s*(\d+)")


def _read_expectations(root: str) -> dict[tuple[str, str], int]:
    """(relpath, rule) -> expected count, from # rex-expect: headers."""
    out: dict[tuple[str, str], int] = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            with open(path, encoding="utf-8") as fh:
                for rule, n in _EXPECT_RE.findall(fh.read()):
                    out[(rel, rule)] = out.get((rel, rule), 0) + int(n)
    return out


def run_fixtures() -> int:
    from repro_torch.analysis.lint import RULES, lint_paths
    if not os.path.isdir(FIXTURES):
        print(f"ERROR: fixture corpus missing at {FIXTURES}")
        return 0          # fails the inverted gate
    expected = _read_expectations(FIXTURES)
    got: dict[tuple[str, str], int] = {}
    for v in lint_paths([FIXTURES], rel_to=FIXTURES):
        print(v)
        got[(v.path, v.rule)] = got.get((v.path, v.rule), 0) + 1

    ok = True
    for key in sorted(set(expected) | set(got)):
        e, g = expected.get(key, 0), got.get(key, 0)
        if e != g:
            ok = False
            print(f"FIXTURE MISMATCH {key[0]}: {key[1]} expected {e}, "
                  f"got {g}")
    fired = {rule for (_p, rule) in got}
    for rule in sorted(set(RULES) - fired):
        ok = False
        print(f"FIXTURE MISMATCH: rule {rule} never fired on the corpus")
    if not ok:
        return 0          # fails the inverted gate
    print(f"fixtures OK: {len(got)} expectation group(s), every rule "
          "demonstrated — exiting non-zero as the gate demo")
    return 1


def run_head(layers: list[str]) -> int:
    findings = []
    if "lint" in layers:
        from repro_torch.analysis.lint import SYNC_BASELINE, lint_paths
        findings += lint_paths([os.path.join(REPO, "src", "repro_torch")],
                               rel_to=REPO, baseline=SYNC_BASELINE)
    if "kernel" in layers:
        from repro_torch.analysis.kernel_audit import audit_kernels
        findings += audit_kernels()
    for v in findings:
        print(v)
    n = len(findings)
    print(f"torch_check_invariants: {n} finding(s) across layers "
          f"[{', '.join(layers)}]")
    return 1 if n else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fixtures", action="store_true",
                    help="lint the planted-violation corpus; exits non-zero "
                         "iff every expectation is met (run it inverted)")
    ap.add_argument("--only", nargs="+", default=list(LAYERS),
                    choices=LAYERS, help="subset of audit layers to run")
    args = ap.parse_args(argv)
    if args.fixtures:
        return run_fixtures()
    return run_head(args.only)


if __name__ == "__main__":
    sys.exit(main())
