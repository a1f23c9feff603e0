"""Simulators, the correlation model M, the profiler and the admission
control plane (``policy.admit`` / ``policy.advance``).

The profiler's entry points are exported here as ``repro.core`` exports
them, resolved at first use: ``convert`` and the profiler import each
other's modules, so an eager import here would be circular."""
import importlib

_PROFILER = ("build_model", "merge_reprofiled_rows",
             "transitions_from_visits")


def __getattr__(name):
    if name in _PROFILER:
        return getattr(importlib.import_module("repro_torch.core.profiler"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
