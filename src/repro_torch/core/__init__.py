"""Simulators, the correlation model M, the profiler and the admission
control plane (``policy.admit`` / ``policy.advance``)."""
