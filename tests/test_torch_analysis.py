"""The port's static invariant plane (``repro_torch.analysis``): rules
REX001, REX002 and REX004 on the port's planted-violation corpus, the
tree at HEAD under the host-sync baseline, the gate script's exit codes,
and the port's linter held to the reference's (``repro.analysis.lint``)
on the reference's own corpus, read-only.

The corpus under ``tests/fixtures/torch_analysis`` mirrors the port's
layout (runtime/, core/, kernels/, models/) because the rules scope by
path; every fixture declares its expected hits in
``# rex-expect: REXNNN=n`` headers and the tests assert EXACT counts.
Every line marked ``# planted`` must count: replacing it with ``pass``
must break its file's counts.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

from repro_torch.analysis import lint
from repro_torch.analysis.lint import (RULES, SYNC_BASELINE, Violation,
                                       lint_file, lint_paths)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(TESTS, ".."))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
FIXTURES = os.path.join(TESTS, "fixtures", "torch_analysis")
REF_FIXTURES = os.path.join(TESTS, "fixtures", "analysis")
SCRIPT = os.path.join(REPO, "scripts", "torch_check_invariants.py")

_EXPECT_RE = re.compile(r"#\s*rex-expect:\s*(REX\d+)\s*=\s*(\d+)")


def _fixture_files():
    out = []
    for dirpath, _dirs, files in os.walk(FIXTURES):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                out.append(os.path.relpath(path, FIXTURES).replace(os.sep,
                                                                   "/"))
    return sorted(out)


def _read(rel, root=FIXTURES):
    with open(os.path.join(root, *rel.split("/")), encoding="utf-8") as fh:
        return fh.read()


def _expected(text):
    out: dict[str, int] = {}
    for rule, n in _EXPECT_RE.findall(text):
        out[rule] = out.get(rule, 0) + int(n)
    return out


def _counts(violations):
    out: dict[str, int] = {}
    for v in violations:
        out[v.rule] = out.get(v.rule, 0) + 1
    return out


def _lint_text(rel, text, **kw):
    return lint_file(os.path.join(FIXTURES, rel), text=text,
                     virtual_path=rel, **kw)


# ---------------------------------------------------------------------------
# the port's corpus
# ---------------------------------------------------------------------------

def test_corpus_mirrors_the_port_layout():
    dirs = {rel.split("/")[0] for rel in _fixture_files()}
    assert {"runtime", "core", "kernels", "models"} <= dirs


@pytest.mark.parametrize("rel", _fixture_files())
def test_fixture_exact_counts(rel):
    """Each fixture's per-rule count matches its rex-expect header exactly
    (0 for undeclared rules): suppressed and clean lines stay quiet,
    planted lines all fire."""
    text = _read(rel)
    assert _counts(_lint_text(rel, text)) == _expected(text)


def test_corpus_demonstrates_every_rule():
    fired = {v.rule for v in lint_paths([FIXTURES], rel_to=FIXTURES)}
    assert fired == set(RULES), f"never fired: {set(RULES) - fired}"


@pytest.mark.parametrize("rel", [r for r in _fixture_files()
                                 if "# planted" in _read(r)])
def test_every_planted_line_counts(rel):
    """Replacing any one planted line with ``pass`` breaks the file's
    expectation, so the inverted gate would then exit 0."""
    lines = _read(rel).split("\n")
    want = _expected("\n".join(lines))
    planted = [i for i, line in enumerate(lines) if "# planted" in line]
    assert planted
    for i in planted:
        cut = list(lines)
        cut[i] = cut[i][:len(cut[i]) - len(cut[i].lstrip())] + "pass"
        assert _counts(_lint_text(rel, "\n".join(cut))) != want, \
            f"{rel}:{i + 1} is planted but counts for nothing"


def test_each_sync_kind_is_planted():
    """One planted hit for each kind of sync, the ``.item()`` in a
    ``_round_body`` and the ``.cpu()`` in a ``decode_step``."""
    msgs = [(v.path, v.msg) for v in lint_paths([FIXTURES], rel_to=FIXTURES)
            if v.rule == "REX001"]
    kinds = ["`.item()`", "`.cpu()`", "`.tolist()`", "`.numpy()`",
             "`.to(\"cpu\")`", "`.synchronize()`", "`.nonzero()`",
             "`torch.as_tensor(", "`torch.tensor(", "`torch.from_numpy(",
             "syncs in its body", "host numpy"]
    for kind in kinds:
        assert any(kind in m for _p, m in msgs), kind
    assert any(p.endswith("runtime/round_syncs.py") and "`_round_body`" in m
               and "`.item()`" in m for p, m in msgs)
    assert any(p.endswith("models/model.py") and "`decode_step`" in m
               and "`.cpu()`" in m for p, m in msgs)


@pytest.mark.parametrize("rel", ["runtime/clean_engine.py",
                                 "core/suppressed.py",
                                 "benchmarks/out_of_scope.py"])
def test_clean_fixtures_are_quiet(rel):
    assert _lint_text(rel, _read(rel)) == []


def test_seeded_draws_stay_quiet():
    """``torch.randn`` with a generator beside one without: only the
    unseeded draw reports, and likewise for ``.normal_()``."""
    text = ("import torch\n"
            "def f(n, x, gen):\n"
            "    a = torch.randn(n)\n"
            "    b = torch.randn(n, generator=gen)\n"
            "    x.normal_()\n"
            "    x.normal_(generator=gen)\n"
            "    return a, b\n")
    vs = _lint_text("core/draws.py", text)
    assert [(v.rule, v.line) for v in vs] == [("REX002", 3), ("REX002", 5)]


def test_sorted_set_stays_quiet():
    text = ("def f(keys):\n"
            "    s = set(keys)\n"
            "    a = [k for k in s]\n"
            "    b = [k for k in sorted(s)]\n"
            "    return a, b\n")
    vs = _lint_text("runtime/order.py", text)
    assert [(v.rule, v.line) for v in vs] == [("REX004", 3)]


@pytest.mark.parametrize("scope", ["line", "def", "file"])
def test_suppression_scopes(scope):
    """Line-, def- and file-level ``# rex: disable`` each silence what the
    same text reports without them."""
    body = ("import torch\n"
            "class E:\n"
            "    def _round_body(self, x):{def_c}\n"
            "        n = x.item(){line_c}\n"
            "        return n\n")
    comments = dict(def_c="", line_c="")
    head = ""
    if scope == "line":
        comments["line_c"] = "  # rex: disable=REX001"
    elif scope == "def":
        comments["def_c"] = "  # rex: disable=REX001"
    else:
        head = "# rex: disable-file=REX001\n"
    plain = body.format(def_c="", line_c="")
    assert [v.line for v in _lint_text("runtime/e.py", plain)] == [4]
    assert _lint_text("runtime/e.py", head + body.format(**comments)) == []


def test_corpus_suppressions_hold():
    """The corpus's own waivers: the line-level ``.item()`` and the
    def-level ``_skip_round`` of ``round_syncs.py``, the line-level draw
    of ``core/rng.py``, the file-level waiver of ``core/suppressed.py``."""
    syncs = _lint_text("runtime/round_syncs.py",
                       _read("runtime/round_syncs.py"))
    assert all("_skip_round" not in v.msg for v in syncs)
    waived = [i + 1 for i, line in enumerate(
        _read("runtime/round_syncs.py").split("\n")) if "rex: disable" in
        line and "def " not in line]
    assert waived and not {v.line for v in syncs} & set(waived)
    rng_text = _read("core/rng.py")
    rng_waived = [i + 1 for i, line in enumerate(rng_text.split("\n"))
                  if "rex: disable=REX002" in line]
    assert rng_waived
    assert not {v.line for v in _lint_text("core/rng.py", rng_text)} \
        & set(rng_waived)


def test_violation_rendering_is_greppable():
    v = Violation("REX001", "runtime/engine.py", 42, "boom")
    assert str(v) == "runtime/engine.py:42: REX001 boom"


# ---------------------------------------------------------------------------
# the port at HEAD, under the baseline
# ---------------------------------------------------------------------------

def test_port_tree_is_lint_clean_under_the_baseline():
    """The gate's zero-at-HEAD half."""
    vs = lint_paths([PORT], rel_to=REPO, baseline=SYNC_BASELINE)
    assert vs == [], "\n".join(str(v) for v in vs)


def test_port_tree_without_the_baseline_is_exactly_the_baseline():
    """Without the baseline the tree reports every sync site and nothing
    else: no unseeded draw, no set iteration, no heavy host numpy, and
    per hot function exactly its baseline's count."""
    vs = lint_paths([PORT], rel_to=REPO)
    assert {v.rule for v in vs} == {"REX001"}
    assert all("host sync in hot-path" in v.msg for v in vs)
    got: dict[tuple[str, str], int] = {}
    for v in vs:
        fn = re.search(r"hot-path `(\w+)`", v.msg).group(1)
        key = (v.path.split("repro_torch/", 1)[1], fn)
        got[key] = got.get(key, 0) + 1
    assert got == {k: n for k, (n, _why) in SYNC_BASELINE.items()}


def test_no_suppression_comment_in_the_port():
    """The tree is clean by its baseline, not by waivers."""
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    by_line, by_file = lint._parse_suppressions(fh.read())
                assert not by_line and not by_file, f


def test_every_baseline_entry_names_a_hot_function_with_a_reason():
    for (suffix, fn), (n, why) in SYNC_BASELINE.items():
        path = os.path.join(PORT, *suffix.split("/"))
        assert os.path.isfile(path), suffix
        assert fn in lint._hot_names(suffix), (suffix, fn)
        assert n > 0 and why.strip(), (suffix, fn)


@pytest.mark.parametrize("delta", [-1, 1])
@pytest.mark.parametrize("fn", ["_round_body", "_rank_outcome"])
def test_baseline_off_by_one_is_reported(fn, delta):
    """An entry above its function's count (stale) or below it (a new
    sync) is a finding, at the function's def."""
    key = ("runtime/engine.py", fn)
    n, why = SYNC_BASELINE[key]
    base = {**SYNC_BASELINE, key: (n + delta, why)}
    vs = lint_paths([os.path.join(PORT, "runtime", "engine.py")],
                    rel_to=REPO, baseline=base)
    assert len(vs) == 1 and vs[0].rule == "REX001", vs
    assert f"`{fn}`" in vs[0].msg
    assert ("stale baseline" in vs[0].msg) == (delta > 0)


def test_baseline_entry_for_a_quiet_function_is_stale():
    base = {**SYNC_BASELINE, ("runtime/engine.py", "_scatter"): (1, "none")}
    vs = lint_paths([os.path.join(PORT, "runtime", "engine.py")],
                    rel_to=REPO, baseline=base)
    assert len(vs) == 1 and "stale baseline" in vs[0].msg
    assert "`_scatter`" in vs[0].msg


def _insert_item(text, fn):
    """``text`` with ``x.item()`` as the first statement of ``fn``."""
    tree = ast.parse(text)
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == fn)
    first = node.body[0]
    lines = text.split("\n")
    lines.insert(first.lineno - 1, " " * first.col_offset + "x.item()")
    return "\n".join(lines)


@pytest.mark.parametrize("rel,fn", [("runtime/engine.py", "_round_body"),
                                    ("models/model.py", "decode_step")])
def test_gate_reports_an_inserted_item(rel, fn):
    """The HEAD gate catches one ``.item()`` put into the serving round or
    the zoo's decode step."""
    path = os.path.join(PORT, *rel.split("/"))
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    virtual = f"src/repro_torch/{rel}"
    assert lint_file(path, text=text, virtual_path=virtual,
                     baseline=SYNC_BASELINE) == []
    vs = lint_file(path, text=_insert_item(text, fn), virtual_path=virtual,
                   baseline=SYNC_BASELINE)
    assert len(vs) == 1 and vs[0].rule == "REX001", vs
    assert f"`{fn}`" in vs[0].msg


def test_gate_reports_an_uncached_mrope_index():
    """``_mrope_streams`` copies its index to the card once a device
    (``functools.cache``); without the cache every ``apply_mrope`` copies
    it, which only the card's sync debugger caught before, and the HEAD
    gate reports it."""
    path = os.path.join(PORT, "models", "layers.py")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    cached = "@functools.cache\ndef _mrope_streams("
    assert cached in text
    vs = lint_file(path, text=text.replace(cached, "def _mrope_streams("),
                   virtual_path="src/repro_torch/models/layers.py",
                   baseline=SYNC_BASELINE)
    assert len(vs) == 1 and "`apply_mrope`" in vs[0].msg, vs


def _zoo_reach():
    """Functions of ``models/`` reachable by name from forward, prefill,
    decode_step and lm_loss (the training loss), ``init_*`` and
    ``check_*`` left out, by file."""
    defs: dict[str, list[tuple[str, ast.FunctionDef]]] = {}
    models = os.path.join(PORT, "models")
    for f in sorted(os.listdir(models)):
        if f.endswith(".py"):
            with open(os.path.join(models, f), encoding="utf-8") as fh:
                for n in ast.parse(fh.read()).body:
                    if isinstance(n, ast.FunctionDef):
                        defs.setdefault(n.name, []).append((f, n))
    seen: set[str] = set()
    todo = ["forward", "prefill", "decode_step", "lm_loss"]
    while todo:
        name = todo.pop()
        if name in seen or name.lstrip("_").startswith(("init_", "check_")):
            continue
        seen.add(name)
        for _f, fn in defs[name]:
            for n in ast.walk(fn):
                ref = n.id if isinstance(n, ast.Name) else \
                    n.attr if isinstance(n, ast.Attribute) else None
                if ref in defs:
                    todo.append(ref)
    out: dict[str, set[str]] = {}
    for name in seen:
        for f, _fn in defs[name]:
            out.setdefault(f"models/{f}", set()).add(name)
    return out


def test_hot_table_is_what_the_zoo_entry_points_reach():
    reach = _zoo_reach()
    table = {k: set(v) for k, v in lint.HOT_FUNCTIONS.items()
             if k.startswith("models/")}
    assert table == reach
    assert "_mrope_streams" in reach["models/layers.py"]
    assert {"_route", "_dispatch_indices"} <= reach["models/moe.py"]


def test_hot_table_names_functions_that_exist():
    engine = ast.parse(_read("runtime/engine.py", PORT))
    tracker = ast.parse(_read("core/tracker.py", PORT))
    names = {n.name for t in (engine, tracker) for n in ast.walk(t)
             if isinstance(n, ast.FunctionDef)}
    assert lint.HOT_FUNCTIONS["runtime/"] <= names
    assert lint.HOT_FUNCTIONS["core/tracker.py"] <= names


# ---------------------------------------------------------------------------
# the gate script
# ---------------------------------------------------------------------------

def test_torch_check_invariants_script_contract():
    """Exit codes: HEAD (and ``--only lint``) exits 0; ``--fixtures``
    exits NON-zero, every rule demonstrated; a fixture corpus that stops
    matching would make it exit 0."""
    env = dict(os.environ, PYTHONPATH=SRC)

    def run(*args):
        return subprocess.run([sys.executable, SCRIPT, *args],
                              capture_output=True, text=True, env=env,
                              timeout=120, cwd=REPO)

    r = run()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout
    r = run("--only", "lint")
    assert r.returncode == 0, r.stdout + r.stderr
    r = run("--fixtures")
    assert r.returncode != 0, r.stdout + r.stderr
    assert "every rule demonstrated" in r.stdout
    assert "FIXTURE MISMATCH" not in r.stdout


# ---------------------------------------------------------------------------
# held to the reference's linter on the reference's corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", ["core/rng.py", "runtime/ordering.py",
                                 "runtime/hot_numpy.py",
                                 "runtime/clean_engine.py",
                                 "core/suppressed.py"])
def test_matches_reference_linter_on_its_corpus(rel):
    """REX002, REX004 and REX001's heavy-numpy half give the same
    (rule, line) lists as ``repro.analysis.lint`` on the reference's
    fixtures, each linted under its corpus-relative path."""
    from repro.analysis import lint as ref_lint

    path = os.path.join(REF_FIXTURES, *rel.split("/"))
    text = _read(rel, REF_FIXTURES)
    rules = set(RULES)

    def hits(mod):
        return [(v.rule, v.line) for v in
                mod.lint_file(path, text=text, virtual_path=rel)
                if v.rule in rules]

    assert hits(lint) == hits(ref_lint)
