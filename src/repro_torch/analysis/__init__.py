"""The static invariant plane of the port, the counterpart of
``repro.analysis``: an AST lint over ``src/repro_torch`` and the
launch-bounds proof of the CUDA launchers
(``scripts/torch_check_invariants.py`` is their gate).

``lint`` keeps three of the reference's five rules, re-targeted at eager
PyTorch:

  REX001  no host sync, and no heavy host numpy, in a hot-path function
          beyond its baseline (``lint.SYNC_BASELINE``)
  REX002  no unseeded or process-global RNG (numpy, stdlib ``random``,
          torch's default generator)
  REX004  no set iteration feeding order

Parts of the reference with no counterpart here, by decision:

* REX003 (python control flow on a traced value) and REX005 (jit entry
  points without declared statics).  The port compiles nothing: every
  function runs eagerly, so there is no tracer to branch on and no static
  argument to declare.  The reference's table of traced functions
  (``TRACED_FUNCTION_STATICS``) matches the port's eager kernel wrappers
  by file and name, and run over ``src/repro_torch`` its REX003 gives 24
  findings, every one of them false.
* ``jaxpr_audit.py`` and ``RecompileGuard``: there is no jaxpr to walk
  and nothing is compiled, so nothing can recompile.
* ``registry.py``: it lists the jit entry points the jaxpr audit traces.
* ``sanitize.py``'s ``jax_debug_nans`` half: a JAX config switch.  Its
  other half, the transport callbacks' reentrancy check, already has its
  counterpart in ``repro_torch.runtime.transport`` (``_sanitize_enabled``,
  switched by ``REPRO_SANITIZE``).

``kernel_audit`` is the launch-bounds half, the counterpart of the
reference's ``kernel_audit.py``: a launch table in place of the
intercepted ``pallas_call`` records, the geometry proof of every CUDA launcher and second
pass from the planners over a shape sweep at several SM counts, the
Python mirror of each launcher's guard (held to the compiled guards on a
card), guard-banded launches, and the ``(NEG_INF, -1)`` sentinel probes.
The port captures no CUDA graph, so the reference's ``RecompileGuard``
has nothing to guard.
"""
from __future__ import annotations

from repro_torch.analysis.lint import (RULES, SYNC_BASELINE,  # noqa: F401
                                       Violation, lint_file, lint_paths)
