"""Performance toggles of the training path (``flags``)."""
from repro_torch.perf.flags import (  # noqa: F401
    PerfFlags, get_flags, perf_flags, set_flags)
