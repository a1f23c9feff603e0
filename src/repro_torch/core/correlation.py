"""The spatio-temporal correlation model M (paper §5.1), as tensors.

  S(c_s, c_d)            spatial correlation: fraction of c_s's outbound
                         traffic seen next at c_d (row-stochastic incl. exit).
  T(c_s, c_d, [f0, f])   temporal correlation: CDF of inter-camera travel
                         times, evaluated at elapsed time since last sighting.
  f0(c_s, c_d)           earliest historical arrival — search starts there.

  M(c_s, c_d, f) = [S ≥ s_thresh] ∧ [f ≥ f0] ∧ [CDF(elapsed) ≤ 1 - t_thresh]

The threshold interface (mask construction, window exhaustion, potential
savings) lives in ``repro_torch.core.policy``; the methods below delegate
to it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import fporder, policy

INF_TIME = np.int32(2 ** 30)

#: the tensor fields of the model, in constructor order
FIELDS = ("S", "exit_frac", "cdf", "f0", "entry", "counts")

#: Model fields whose value at source-camera row ``r`` depends only on
#: transitions departing r (and exits at r): counts, the travel-time CDF
#: and f0 accumulate per (src, dst) pair, and the S / exit_frac normaliser
#: is the row's own outbound total.  ``entry`` is the one global field
#: (normalised over every camera's first appearances): a row-targeted
#: re-profile always recomputes it from the full window.  This is what
#: makes ``profiler.merge_reprofiled_rows`` equal a full rebuild on
#: untouched rows, bit for bit.
ROW_LOCAL_FIELDS = ("S", "exit_frac", "cdf", "f0", "counts", "tile_admit")


def splice_rows(model: "SpatioTemporalModel", rows, updates: dict, *,
                entry=None, epoch: int | None = None) -> "SpatioTemporalModel":
    """Replace source-camera rows of the row-local fields with freshly
    profiled blocks, carrying every untouched row bit for bit.

    ``updates`` maps a field name (in ``ROW_LOCAL_FIELDS``) to a
    ``(len(rows), ...)`` block.  The splice runs on the host in numpy in
    the base array's dtype, so a float64 profiling block is cast exactly
    as ``build_model``'s own float32 cast would; the result goes back to
    the model's device.  ``entry`` (global) is replaced as a float32
    tensor and ``epoch`` as an int.  Shapes never change, so the result
    hot-swaps through ``engine.swap_model``."""
    rows = np.asarray(rows, np.int64)
    repl = {}
    for name, block in updates.items():
        if name not in ROW_LOCAL_FIELDS:
            raise ValueError(f"splice_rows: {name!r} is not row-local "
                             f"(row-local fields: {ROW_LOCAL_FIELDS})")
        base = getattr(model, name)
        if base is None:
            raise ValueError(f"splice_rows: base model has no {name!r} to "
                             f"splice into")
        arr = np.asarray(base.cpu()).copy()
        arr[rows] = block
        repl[name] = torch.from_numpy(arr).to(base.device)
    if entry is not None:
        repl["entry"] = torch.from_numpy(
            np.asarray(entry).astype(np.float32)).to(model.device)
    if epoch is not None:
        repl["epoch"] = int(epoch)
    return dataclasses.replace(model, **repl)


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

    @functools.cached_property
    def host_counts(self) -> np.ndarray:
        """``counts`` as a float64 host array, copied off the device once
        per model (a swap makes a new model): what ``drift_score`` reads
        at every poll."""
        return self.counts.cpu().numpy().astype(np.float64)

    def to(self, device) -> "SpatioTemporalModel":
        """The same model with every tensor (``tile_admit`` too) on
        ``device``."""
        moved = {f: getattr(self, f).to(device) for f in FIELDS}
        if self.tile_admit is not None:
            moved["tile_admit"] = self.tile_admit.to(device)
        return dataclasses.replace(self, **moved)

    # -- the paper's query interface (delegates to repro_torch.core.policy)
    def spatial_mask(self, c_s, s_thresh) -> torch.Tensor:
        """(C,) bool: destinations spatially correlated with c_s."""
        return policy.spatial_mask(self, c_s, s_thresh)

    def temporal_mask(self, c_s, elapsed, t_thresh) -> torch.Tensor:
        """(C,) bool: destinations temporally correlated at `elapsed`
        steps."""
        return policy.temporal_mask(self, c_s, elapsed, t_thresh)

    def correlated(self, c_s, elapsed, s_thresh, t_thresh) -> torch.Tensor:
        """M(c_s, ·, elapsed): (C,) bool mask over destination cameras."""
        return policy.correlated(self, c_s, elapsed, s_thresh, t_thresh)

    def window_end(self, s_thresh: float, t_thresh: float) -> torch.Tensor:
        """(C,) per-source elapsed time at which every admitted
        destination's temporal window has closed (Alg. 1 line 21)."""
        return policy.window_end(self, s_thresh, t_thresh)

    # -- §5.4 identity detection needs window-binned temporal mass --------
    def window_transfer(self, window: int, n_windows: int) -> torch.Tensor:
        """Tw (C, C, n_windows): fraction of c_s->c_d traffic arriving with
        a delay of exactly w windows (w = dt // window).  Each window's
        bins are summed in ``fporder.seq_sum``'s order, the reference's."""
        C, _, NB = self.cdf.shape
        pdf = torch.diff(self.cdf, dim=-1,
                         prepend=self.cdf.new_zeros((C, C, 1)))
        bins_per_w = max(window // self.bin_width, 1)
        nw_src = NB // bins_per_w
        trimmed = fporder.seq_sum(pdf[:, :, :nw_src * bins_per_w].reshape(
            C, C, nw_src, bins_per_w))
        if nw_src >= n_windows:
            return trimmed[:, :, :n_windows]
        return torch.nn.functional.pad(trimmed, (0, n_windows - nw_src))

    def potential_savings(self, s_thresh: float, t_thresh: float,
                          weight_by_traffic: bool = True) -> float:
        """Analytic potential (paper §3.2): baseline camera-steps over the
        camera-steps M admits.  Spatial-only: t_thresh=0.  Temporal-only:
        s_thresh=0."""
        return policy.potential_savings(self, s_thresh, t_thresh,
                                        weight_by_traffic)
