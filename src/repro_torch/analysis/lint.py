"""AST lint for the port's hot paths and determinism (REX001, REX002,
REX004), the counterpart of ``repro.analysis.lint``.

  REX001  a host sync (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
          ``.to("cpu")``, ``.synchronize()``, ``.nonzero()``, host data made
          into a device tensor, or a call to a function of the same module
          that does one of these) or heavy host numpy inside a hot-path
          function
  REX002  unseeded ``default_rng()``, numpy's or the stdlib's global RNG,
          or torch's default generator (a draw without ``generator=``,
          ``torch.manual_seed``, ``torch.seed``)
  REX004  iteration over a set feeds downstream state

Suppression syntax, as the reference's (line- or def-level; file-level
with disable-file):

    x = np.linalg.norm(v)        # rex: disable=REX001
    # rex: disable-file=REX004

Rules are scoped by repo-relative path (``HOT_FUNCTIONS``, ``RNG_SCOPE``),
so the planted-violation corpus under ``tests/fixtures/torch_analysis``
mirrors the source layout (runtime/, core/, kernels/, models/).

A host sync is not always wrong: the serving round copies its outcome to
the host once a round, by design.  So the sync half of REX001 holds each
hot function to a count, ``SYNC_BASELINE``, when ``lint_paths`` or
``lint_file`` is given one (the gate at HEAD gives it): a function with
more sync sites than its entry is reported, and so is one with fewer, so
that the baseline cannot go stale.  Without a baseline (the fixture
corpus) every sync site is reported at its line.  The reference's REX003
and REX005 have no counterpart (see ``repro_torch.analysis``).
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

__all__ = ["Violation", "lint_file", "lint_paths", "RULES", "SYNC_BASELINE"]

RULES = {
    "REX001": "host sync or heavy host numpy in a hot-path function",
    "REX002": "unseeded rng in result-affecting code",
    "REX004": "iteration over an unordered set feeds downstream state",
}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


# ---------------------------------------------------------------------------
# Rule configuration.  Kept as data at module top so scope changes are diffs
# here, not code changes.
# ---------------------------------------------------------------------------

# REX001: the hot functions, by repo-relative path.  A key ending in "/"
# names a directory (any module under it: a subclass that overrides an
# engine method is as hot as the method); any other key names one file.
HOT_FUNCTIONS: dict[str, frozenset[str]] = {
    # the serving engine's round, and the step bodies it dispatches
    "runtime/": frozenset({
        "_gather", "_scatter", "_plan_round", "_round_body",
        "_issue_prefetch", "_skip_round",
        "rank_round", "rank_round_seg", "rank_round_tiles",
        "rank_advance_round", "rank_advance_round_seg",
        "rank_advance_round_tiles", "advance_round", "_rank_outcome"}),
    # one batched step of the tracker
    "core/tracker.py": frozenset({"_track_step", "_rank_galleries"}),
    # the zoo: every function that forward, prefill and decode_step reach
    # (init_* and check_* are not on the path)
    "models/model.py": frozenset({
        "forward", "forward_hidden", "prefill", "decode_step", "_inputs",
        "_tokens", "_floats", "_positions", "_encode", "_enc_len",
        "_blocks", "_fill_state", "_dense_layer_apply",
        "_ssm_layer_apply", "lm_loss"}),
    "models/layers.py": frozenset({
        "_dtype", "apply_norm", "rope_freqs", "_freqs", "_rotate",
        "apply_rope", "_mrope_streams", "apply_mrope", "apply_mlp",
        "embed_tokens", "unembed"}),
    "models/attention.py": frozenset({
        "qkv_project", "cross_q", "cross_kv", "blockwise_attention",
        "decode_attention", "attn_output"}),
    "models/moe.py": frozenset({
        "moe_block", "capacity", "_route", "_dispatch_indices",
        "_expert_ffn", "_moe_chunk_local"}),
    "models/ssm.py": frozenset({
        "mamba1_block", "mamba2_block", "_x_proj", "causal_conv1d",
        "conv1d_step", "ssd_chunked", "_gated_norm_out"}),
    # the zoo's training: the step, and the update it runs
    "launch/steps.py": frozenset({"train_step"}),
    "optim/adamw.py": frozenset({"adamw_update", "lr_at", "global_norm"}),
}

# REX001's heavy host numpy, as the reference's: reductions,
# factorizations, sorts.  Cheap marshalling (asarray/stack/full/
# flatnonzero) is fine.
HEAVY_NP_OPS = {
    "linalg", "argmin", "argmax", "sort", "argsort", "dot", "matmul",
    "einsum", "inner", "outer", "tensordot", "vdot", "exp", "log", "sqrt",
    "percentile", "quantile", "median", "mean", "std", "var", "histogram",
    "cumsum", "cumprod", "corrcoef", "cov", "fft", "unique", "lexsort",
}

# REX001's host syncs: methods that wait for the card and copy to the host
SYNC_METHODS = {
    "item": "copies a scalar to the host",
    "cpu": "copies to the host",
    "tolist": "copies to the host",
    "numpy": "reads host memory (after a copy from the card)",
    "synchronize": "waits for the card",
    "nonzero": "waits for the card to size its output",
}
# torch factories that copy host data to ``device=``
H2D_FACTORIES = {"as_tensor", "tensor"}
# torch factories of host tensors that a following ``.to(device)`` or
# ``.cuda()`` copies to the card
HOST_FACTORIES = {"from_numpy", "as_tensor", "tensor"}
# decorators whose function runs once per argument set: a call to such a
# helper is not a sync site (its own body still counts where it is hot)
CACHE_DECORATORS = {"cache", "lru_cache"}

# REX001's baseline at HEAD: (path suffix, function) -> (sync sites, why).
# A site is a sync in the function's own body (not a nested def's) or a
# call to a function of its module whose body syncs; a call to a cached
# helper is none.  Raise an entry only with its reason; lower it when a
# sync goes.
SYNC_BASELINE: dict[tuple[str, str], tuple[int, str]] = {
    ("runtime/engine.py", "_gather"): (
        6, "the batched PhaseState's six columns, each copied to the card "
           "by `col`"),
    ("runtime/engine.py", "_plan_round"): (
        4, "`_gather`; the tile anchors copied to the card; `_to_host` of "
           "the admission, in the tile or the camera branch"),
    ("runtime/engine.py", "_round_body"): (
        22, "`dev_t` of the round's inputs (18 calls over the three ranking "
            "branches, at most 8 a round); `_plan_round`; `_defer_late`'s "
            "late rows; one `_to_host` of the outcome, ranked or not"),
    ("runtime/engine.py", "_issue_prefetch"): (
        2, "`_gather` of the speculated cohort; `_to_host` of its "
           "admission"),
    ("runtime/engine.py", "_rank_outcome"): (
        1, "the match threshold made a device scalar"),
    ("runtime/engine.py", "rank_round"): (1, "`_rank_outcome`"),
    ("runtime/engine.py", "rank_round_seg"): (1, "`_rank_outcome`"),
    ("runtime/engine.py", "rank_round_tiles"): (1, "`_rank_outcome`"),
    ("core/tracker.py", "_rank_galleries"): (
        1, "`.nonzero()` of the admitted pairs sizes the scoring gather"),
    ("core/tracker.py", "_track_step"): (1, "`_rank_galleries`"),
    ("models/layers.py", "_freqs"): (
        1, "the rotary frequencies, copied once a (width, theta, device) "
           "by functools.cache"),
    ("models/layers.py", "_mrope_streams"): (
        1, "the M-RoPE stream index, copied once a (sections, width, "
           "device) by functools.cache"),
    ("models/model.py", "_tokens"): (
        1, "the caller's integers made a device tensor: a copy only where "
           "they come from the host"),
    ("models/model.py", "_floats"): (
        1, "the caller's embeddings or frames made a device tensor: a copy "
           "only where they come from the host"),
    ("models/model.py", "_inputs"): (
        3, "`_floats` of a VLM's embeds; `_tokens` of the tokens and of the "
           "M-RoPE positions"),
    ("models/model.py", "_encode"): (1, "`_floats` of the audio frames"),
    ("models/model.py", "decode_step"): (1, "`_tokens` of the step's token"),
    ("models/model.py", "lm_loss"): (
        2, "`_tokens` of the labels' tokens and the loss mask made a device "
           "tensor: copies only where they come from the host"),
}

# REX002: numpy's legacy global-RNG entry points and the stdlib's, as the
# reference's; ``default_rng()`` with no arguments is the other half.
NP_GLOBAL_RNG = {
    "random", "rand", "randn", "randint", "random_sample", "choice",
    "shuffle", "permutation", "normal", "uniform", "poisson", "exponential",
    "standard_normal", "beta", "gamma", "seed",
}
STDLIB_RANDOM_FNS = {
    "random", "randint", "choice", "choices", "shuffle", "uniform",
    "randrange", "sample", "gauss", "normalvariate", "seed", "betavariate",
}
# torch draws from the default generator unless given ``generator=``
TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
}
# in-place tensor draws (``trunc_normal_`` is ``torch.nn.init``'s, which
# the zoo's init uses)
TORCH_INPLACE_DRAWS = {
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "trunc_normal_",
}
# calls that seed or reseed torch's default generators
TORCH_GLOBAL_SEEDS = {"manual_seed", "seed", "manual_seed_all"}

# REX002 and REX004 apply under these directories
RNG_SCOPE = ("core/", "runtime/", "kernels/", "models/", "optim/", "data/",
             "checkpoint/", "launch/")

_SUPPRESS_RE = re.compile(r"#\s*rex:\s*disable(-file)?\s*=\s*([A-Z0-9,\s]+)")


def _in_scope(key: str, path: str) -> bool:
    p = "/" + path.replace("\\", "/")
    return f"/{key}" in p if key.endswith("/") else p.endswith(f"/{key}")


def _hot_names(path: str) -> set[str]:
    names: set[str] = set()
    for key, fns in HOT_FUNCTIONS.items():
        if _in_scope(key, path):
            names |= fns
    return names


def _rule_applies(rule: str, path: str) -> bool:
    if rule == "REX001":
        return bool(_hot_names(path))
    return any(_in_scope(d, path) for d in RNG_SCOPE)


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

def _parse_suppressions(text: str):
    """-> (line -> {rules}, file-level {rules})."""
    by_line: dict[int, set[str]] = {}
    file_level: set[str] = set()
    try:
        toks = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
            if m.group(1):          # disable-file
                file_level |= rules
            else:
                by_line.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass
    return by_line, file_level


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------

def _attr_chain(node: ast.AST) -> list[str]:
    """x.a.b -> ["x", "a", "b"]; non-name roots -> []."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


class _Imports(ast.NodeVisitor):
    """Alias maps: which local names refer to numpy / numpy.random /
    stdlib random / the rng factory / torch / torch's draws."""

    def __init__(self):
        self.numpy: set[str] = set()          # import numpy as np
        self.np_random: set[str] = set()      # from numpy import random as r
        self.stdlib_random: set[str] = set()  # import random
        self.default_rng: set[str] = set()    # from numpy.random import default_rng
        self.torch: set[str] = set()          # import torch
        self.torch_fns: dict[str, str] = {}   # from torch import randn as r

    def visit_Import(self, node):
        for a in node.names:
            name = a.asname or a.name
            if a.name == "numpy":
                self.numpy.add(name)
            elif a.name == "numpy.random":
                self.np_random.add(name)
            elif a.name == "random":
                self.stdlib_random.add(name)
            elif a.name == "torch" or (a.name.startswith("torch.")
                                       and a.asname is None):
                self.torch.add(name.split(".")[0])

    def visit_ImportFrom(self, node):
        for a in node.names:
            name = a.asname or a.name
            if node.module == "numpy" and a.name == "random":
                self.np_random.add(name)
            elif node.module == "numpy.random" and a.name == "default_rng":
                self.default_rng.add(name)
            elif node.module == "torch":
                self.torch_fns[name] = a.name


def _is_np_call(chain: list[str], imports: _Imports) -> str | None:
    """np.<op>(...) / numpy.<sub>.<op> -> the first attr after the root."""
    if len(chain) >= 2 and chain[0] in imports.numpy:
        return chain[1]
    return None


def _torch_fn(chain: list[str], imports: _Imports) -> str | None:
    """torch.<fn>(...) or a name imported from torch -> fn."""
    if len(chain) == 2 and chain[0] in imports.torch:
        return chain[1]
    if len(chain) == 1 and chain[0] in imports.torch_fns:
        return imports.torch_fns[chain[0]]
    return None


def _kwarg(node: ast.Call, name: str) -> ast.AST | None:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_constant(node: ast.AST) -> bool:
    """A literal: a constant, a signed one, or a tuple or list of them."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return _is_constant(node.operand)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_constant(e) for e in node.elts)
    return False


def _is_cpu(node: ast.AST | None) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and _attr_chain(node.func)[-1:] == \
            ["device"] and node.args:
        return _is_cpu(node.args[0])
    return False


def _own_nodes(fn: ast.AST):
    """The nodes of ``fn``'s body, without the bodies of the functions
    defined inside it."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# The per-file linter
# ---------------------------------------------------------------------------

class _FileLinter:
    def __init__(self, path: str, text: str, baseline=None):
        self.path = path
        self.text = text
        self.baseline = baseline
        self.tree = ast.parse(text, filename=path)
        self.imports = _Imports()
        self.imports.visit(self.tree)
        self.suppress_lines, self.suppress_file = _parse_suppressions(text)
        self.violations: list[Violation] = []
        # line span of every function def, for def-level suppression
        self._def_spans: list[tuple[int, int, int]] = []   # (start, end, defline)
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._def_spans.append(
                    (node.lineno, node.end_lineno or node.lineno, node.lineno))

    # -- emission with suppression ----------------------------------------
    def _suppressed(self, rule: str, line: int) -> bool:
        if rule in self.suppress_file:
            return True
        if rule in self.suppress_lines.get(line, set()):
            return True
        return any(start <= line <= end
                   and rule in self.suppress_lines.get(defline, set())
                   for start, end, defline in self._def_spans)

    def _emit(self, rule: str, line: int, msg: str) -> None:
        if not self._suppressed(rule, line):
            self.violations.append(Violation(rule, self.path, line, msg))

    def run(self) -> list[Violation]:
        if _rule_applies("REX001", self.path):
            self._rex001()
        if _rule_applies("REX002", self.path):
            self._rex002()
        if _rule_applies("REX004", self.path):
            self._rex004()
        return self.violations

    def _functions(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.FunctionDef):
                yield node

    # -- REX001 ------------------------------------------------------------
    def _sync_kind(self, node: ast.Call) -> str | None:
        """What makes call ``node`` a host sync, or None."""
        func = node.func
        chain = _attr_chain(func)
        if chain and chain[0] in self.imports.numpy:
            return None             # host numpy: nothing on the card
        fn = _torch_fn(chain, self.imports)
        if fn in H2D_FACTORIES:
            dev = _kwarg(node, "device")
            if dev is not None and not _is_cpu(dev) and not (
                    fn == "tensor" and node.args
                    and _is_constant(node.args[0])):
                return f"`torch.{fn}(..., device=...)` copies host data to " \
                       "the card"
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr in SYNC_METHODS:
            return f"`.{func.attr}()` {SYNC_METHODS[func.attr]}"
        if func.attr == "to" and (
                _is_cpu(node.args[0] if node.args else None)
                or _is_cpu(_kwarg(node, "device"))):
            return "`.to(\"cpu\")` copies to the host"
        if func.attr in ("to", "cuda") and isinstance(func.value, ast.Call):
            inner = _torch_fn(_attr_chain(func.value.func), self.imports)
            if inner in HOST_FACTORIES and \
                    _kwarg(func.value, "device") is None and \
                    self._moves_to_device(node):
                return f"`torch.{inner}(...).{func.attr}(...)` copies host " \
                       "data to the card"
        return None

    def _moves_to_device(self, node: ast.Call) -> bool:
        """``.cuda(...)``, or ``.to(...)`` with a device: not a dtype alone
        (``torch.float32``, ``dtype=``), not ``"cpu"``."""
        if node.func.attr == "cuda":
            return True
        dev = _kwarg(node, "device")
        if dev is not None:
            return not _is_cpu(dev)
        if not node.args:
            return False
        first = node.args[0]
        is_dtype = _torch_fn(_attr_chain(first), self.imports) is not None
        return not is_dtype and not _is_cpu(first)

    def _sync_table(self) -> tuple[dict[str, bool], set[str]]:
        """(function name -> its body, nested defs included, holds a
        direct sync; the names of cached functions)."""
        syncs: dict[str, bool] = {}
        cached: set[str] = set()
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            direct = any(isinstance(n, ast.Call) and self._sync_kind(n)
                         for n in ast.walk(fn))
            syncs[fn.name] = syncs.get(fn.name, False) or direct
            for dec in fn.decorator_list:
                chain = _attr_chain(dec.func if isinstance(dec, ast.Call)
                                    else dec)
                if chain and chain[-1] in CACHE_DECORATORS:
                    cached.add(fn.name)
        return syncs, cached

    def _sync_sites(self, fn: ast.FunctionDef, syncs, cached):
        """[(line, why)] of ``fn``'s own body: direct syncs, and calls to
        a function of this module (``f(...)``, ``self.f(...)``,
        ``cls.f(...)``) whose body syncs, unless it is cached."""
        sites = []
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            why = self._sync_kind(node)
            if why is None:
                chain = _attr_chain(node.func)
                name = None
                if len(chain) == 1:
                    name = chain[0]
                elif len(chain) == 2 and chain[0] in ("self", "cls"):
                    name = chain[1]
                if name is not None and name != fn.name and \
                        syncs.get(name) and name not in cached:
                    why = f"`{'.'.join(chain)}` syncs in its body"
            if why is not None and not self._suppressed("REX001",
                                                        node.lineno):
                sites.append((node.lineno, why))
        return sorted(sites)

    def _rex001(self) -> None:
        hot = _hot_names(self.path)
        syncs, cached = self._sync_table()
        counts: dict[str, tuple[int, list[int]]] = {}
        for fn in self._functions():
            if fn.name not in hot:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                op = _is_np_call(chain, self.imports)
                if op in HEAVY_NP_OPS:
                    self._emit("REX001", node.lineno,
                               f"host numpy `{'.'.join(chain)}` inside "
                               f"hot-path `{fn.name}` — compute it on the "
                               "card (or hoist it out of the round)")
            sites = self._sync_sites(fn, syncs, cached)
            if self.baseline is None:
                for line, why in sites:
                    self.violations.append(Violation(
                        "REX001", self.path, line,
                        f"host sync in hot-path `{fn.name}`: {why}"))
            else:
                n, lines = counts.get(fn.name, (0, []))
                counts[fn.name] = (n + len(sites),
                                   lines + [line for line, _ in sites])
        if self.baseline is not None:
            self._against_baseline(counts)

    def _against_baseline(self, counts) -> None:
        defs = {fn.name: fn.lineno for fn in self._functions()}
        entries = {fn: n for (suffix, fn), (n, _why) in self.baseline.items()
                   if _in_scope(suffix, self.path)}
        for name in sorted(set(counts) | set(entries)):
            n, lines = counts.get(name, (0, []))
            want = entries.get(name, 0)
            line = defs.get(name, 1)
            if n > want:
                self._emit("REX001", line,
                           f"hot-path `{name}` has {n} host sync site(s) "
                           f"(lines {', '.join(map(str, lines))}), its "
                           f"baseline {want}: move the new one off the "
                           "path, or raise the baseline with its reason")
            elif n < want:
                self._emit("REX001", line,
                           f"stale baseline: hot-path `{name}` has {n} "
                           f"host sync site(s), its baseline {want}: lower "
                           "the entry")

    # -- REX002 ------------------------------------------------------------
    def _rex002(self) -> None:
        imp = self.imports
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            self._torch_rng(node, chain)
            if not chain:
                continue
            root, leaf = chain[0], chain[-1]
            is_default_rng = (
                leaf == "default_rng"
                and (root in imp.default_rng
                     or root in imp.np_random
                     or (len(chain) >= 3 and root in imp.numpy
                         and chain[1] == "random")))
            if is_default_rng and not node.args and not node.keywords:
                self._emit("REX002", node.lineno,
                           "`default_rng()` without a seed — randomness "
                           "that reaches a result must derive from an "
                           "explicit seed")
                continue
            is_np_global = leaf in NP_GLOBAL_RNG and (
                (len(chain) == 2 and root in imp.np_random)
                or (len(chain) >= 3 and root in imp.numpy
                    and chain[1] == "random"))
            if is_np_global:
                self._emit("REX002", node.lineno,
                           f"legacy global-RNG `{'.'.join(chain)}` — use a "
                           "seeded Generator (default_rng(seed))")
                continue
            if (len(chain) == 2 and root in imp.stdlib_random
                    and leaf in STDLIB_RANDOM_FNS):
                self._emit("REX002", node.lineno,
                           f"stdlib `{'.'.join(chain)}` uses the process "
                           "global RNG — use a seeded Generator")

    def _torch_rng(self, node: ast.Call, chain: list[str]) -> None:
        """Flag a draw from, or a seeding of, torch's default generator."""
        imp = self.imports
        fn = _torch_fn(chain, imp)
        seeded = _kwarg(node, "generator") is not None
        where = ".".join(chain)
        if fn in TORCH_DRAWS and not seeded:
            self._emit("REX002", node.lineno,
                       f"`{where}` draws from torch's default generator — "
                       "pass generator= (a torch.Generator seeded "
                       "explicitly)")
            return
        seeds_global = fn in TORCH_GLOBAL_SEEDS or (
            len(chain) == 3 and chain[0] in imp.torch
            and chain[1] in ("cuda", "random")
            and chain[2] in TORCH_GLOBAL_SEEDS)
        if seeds_global:
            self._emit("REX002", node.lineno,
                       f"`{where}` seeds torch's process-global generator "
                       "— seed a torch.Generator and pass it instead")
            return
        func = node.func
        if isinstance(func, ast.Attribute) and \
                func.attr in TORCH_INPLACE_DRAWS and not seeded:
            self._emit("REX002", node.lineno,
                       f"`.{func.attr}()` draws from torch's default "
                       "generator — pass generator=")

    # -- REX004 ------------------------------------------------------------
    def _rex004(self) -> None:
        # Set-typed names are tracked PER SCOPE (innermost enclosing
        # function, else module) — a `keys: set` in one method must not
        # taint an unrelated `keys` list in another.
        fns = sorted(self._functions(), key=lambda f: f.lineno)

        def innermost_fn(line: int):
            best = None
            for f in fns:
                if f.lineno <= line <= (f.end_lineno or f.lineno):
                    if best is None or f.lineno >= best.lineno:
                        best = f
            return best

        def set_names_of(scope) -> set[str]:
            names: set[str] = set()
            nodes = ast.walk(scope) if scope is not None else (
                n for n in ast.walk(self.tree) if innermost_fn(
                    getattr(n, "lineno", 0) or 0) is None)
            for node in nodes:
                ann = None
                if isinstance(node, ast.arg):
                    ann = node.annotation
                elif isinstance(node, ast.AnnAssign):
                    ann = node.annotation
                if ann is not None and "set" in ast.unparse(ann).lower():
                    name = node.arg if isinstance(node, ast.arg) else (
                        node.target.id
                        if isinstance(node.target, ast.Name) else None)
                    if name:
                        names.add(name)
                if isinstance(node, ast.Assign) and \
                        self._is_set_expr(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            names.add(tgt.id)
            return names

        tables: dict[int, set[str]] = {}     # id of scope fn (or 0) -> names

        def names_for(line: int) -> set[str]:
            scope = innermost_fn(line)
            key = id(scope) if scope is not None else 0
            if key not in tables:
                tables[key] = set_names_of(scope)
            return tables[key]

        def iter_is_set(it: ast.AST, set_named: set[str]) -> bool:
            # unwrap enumerate/list/tuple — they preserve the set's
            # (arbitrary) order, so they don't launder it
            if isinstance(it, ast.Call):
                chain = _attr_chain(it.func)
                if chain in (["sorted"],):
                    return False
                if chain in (["enumerate"], ["list"], ["tuple"]) and it.args:
                    return iter_is_set(it.args[0], set_named)
            if self._is_set_expr(it):
                return True
            return isinstance(it, ast.Name) and it.id in set_named

        for node in ast.walk(self.tree):
            iters = []
            if isinstance(node, ast.For):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            for it in iters:
                if iter_is_set(it, names_for(it.lineno)):
                    self._emit(
                        "REX004", it.lineno,
                        "iterating a set — order is arbitrary; wrap in "
                        "sorted(...) before it feeds order or placement")

    @staticmethod
    def _is_set_expr(node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            return chain in (["set"], ["frozenset"])
        return False


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_file(path: str | Path, text: str | None = None,
              virtual_path: str | None = None, *,
              baseline=None) -> list[Violation]:
    """Lint one file.  ``virtual_path`` overrides the path used for rule
    scoping and reporting (fixture corpora mirror the source layout).
    ``baseline`` (``SYNC_BASELINE``'s shape) holds each hot function to
    its count of host syncs instead of reporting every sync."""
    path = Path(path)
    if text is None:
        text = path.read_text()
    report_as = virtual_path or str(path)
    return _FileLinter(report_as, text, baseline).run()


def lint_paths(roots: list[str | Path],
               rel_to: str | Path | None = None, *,
               baseline=None) -> list[Violation]:
    """Lint every .py under ``roots`` (files or directories).  Paths are
    reported (and rule-scoped) relative to ``rel_to`` when given; the
    baseline applies only when given (the gate at HEAD gives
    ``SYNC_BASELINE``)."""
    out: list[Violation] = []
    for root in roots:
        root = Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            rel = str(f.relative_to(rel_to)) if rel_to else str(f)
            out.extend(lint_file(f, virtual_path=rel, baseline=baseline))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))
