"""The spatio-temporal correlation model M (paper §5.1), as tensors.

  S(c_s, c_d)            spatial correlation: fraction of c_s's outbound
                         traffic seen next at c_d (row-stochastic incl. exit).
  T(c_s, c_d, [f0, f])   temporal correlation: CDF of inter-camera travel
                         times, evaluated at elapsed time since last sighting.
  f0(c_s, c_d)           earliest historical arrival — search starts there.

  M(c_s, c_d, f) = [S ≥ s_thresh] ∧ [f ≥ f0] ∧ [CDF(elapsed) ≤ 1 - t_thresh]

The threshold interface (mask construction, window exhaustion) lives in
``repro_torch.core.policy``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INF_TIME = np.int32(2 ** 30)

#: the tensor fields of the model, in constructor order
FIELDS = ("S", "exit_frac", "cdf", "f0", "entry", "counts")


@dataclasses.dataclass(frozen=True)
class SpatioTemporalModel:
    """C = number of cameras, NB = travel-time bins; all on one device."""

    S: torch.Tensor          # (C, C)  float32 next-camera traffic fractions
    exit_frac: torch.Tensor  # (C,)    float32 fraction that exits the network
    cdf: torch.Tensor        # (C, C, NB) float32 travel-time CDF
    f0: torch.Tensor         # (C, C)  int32 earliest travel time; INF_TIME if none
    entry: torch.Tensor      # (C,)    float32 first-appearance distribution
    counts: torch.Tensor     # (C, C)  float32 raw transition counts
    bin_width: int = 1
    # model version: 0 = the offline profile, +1 per hot-swap
    epoch: int = 0
    # CrossRoI-style sub-frame admission (kept out of FIELDS: a camera-
    # granular model has none): tile_admit[c_s, c_d, t] says whether tile t
    # of camera c_d's T x T grid ever receives c_s -> c_d handoff traffic.
    # tile_grid = 0 means no tile plane.  tile_learned is True when the
    # masks were profiled, False for the all-admitted tensor the engine
    # synthesises for a tile-less model; it decides the self-camera column
    # (``policy.tile_admission``).
    tile_admit: torch.Tensor | None = None   # (C, C, T*T) bool, or None
    tile_grid: int = 0
    tile_learned: bool = False

    @property
    def n_cams(self) -> int:
        return self.S.shape[0]

    @property
    def n_bins(self) -> int:
        return self.cdf.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.S.device

    def to(self, device) -> "SpatioTemporalModel":
        """The same model with every tensor (``tile_admit`` too) on
        ``device``."""
        moved = {f: getattr(self, f).to(device) for f in FIELDS}
        if self.tile_admit is not None:
            moved["tile_admit"] = self.tile_admit.to(device)
        return dataclasses.replace(self, **moved)
