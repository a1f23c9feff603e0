"""The serving plane: frame store, gallery store, ``ServingEngine`` and
the §6 recalibration loop."""
from repro_torch.runtime.recal import (RecalibrationController,  # noqa: F401
                                       RecalibrationPolicy, match_log_source,
                                       visits_window_source)
