"""Carry state between the numpy world and the port's tensors.

The JAX package's model fields, read out as numpy arrays, become the
port's ``SpatioTemporalModel`` here, so both engines can be handed the
same M; the profiler builds its model through the same function."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.correlation import FIELDS, SpatioTemporalModel
from repro_torch.core.policy import PhaseState

_MODEL_DTYPES = dict(S=np.float32, exit_frac=np.float32, cdf=np.float32,
                     f0=np.int32, entry=np.float32, counts=np.float32)
_STATE_DTYPES = dict(f_q=np.int32, c_q=np.int32, f_curr=np.int32,
                     phase=np.int32, live_f=np.float32, done=np.bool_)


def model_from_numpy(fields: dict, bin_width: int = 1, epoch: int = 0, *,
                     tile_admit=None, tile_grid: int = 0,
                     tile_learned: bool = False,
                     device="cpu") -> SpatioTemporalModel:
    """``fields`` maps each of ``S, exit_frac, cdf, f0, entry, counts`` to
    an array; each is cast once to the model's dtype (float32, f0 int32).
    ``tile_admit`` ((C, C, T*T) bool, or None) with ``tile_grid`` and
    ``tile_learned`` carries the sub-frame tile plane across."""
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise ValueError(f"model fields missing: {missing}")
    if tile_admit is not None:
        tile_admit = torch.from_numpy(np.ascontiguousarray(
            np.asarray(tile_admit).astype(np.bool_))).to(device)
    return SpatioTemporalModel(
        **{f: torch.from_numpy(np.ascontiguousarray(
            np.asarray(fields[f]).astype(_MODEL_DTYPES[f]))).to(device)
           for f in FIELDS},
        bin_width=int(bin_width), epoch=int(epoch), tile_admit=tile_admit,
        tile_grid=int(tile_grid), tile_learned=bool(tile_learned))


def model_to_numpy(model: SpatioTemporalModel) -> dict:
    """The model's tensor fields as host numpy arrays."""
    return {f: getattr(model, f).cpu().numpy() for f in FIELDS}


def phase_state_from_numpy(fields: dict, device="cpu") -> PhaseState:
    """A batched ``PhaseState`` from numpy columns ``f_q, c_q, f_curr,
    phase, live_f, done`` (int32 x4, float32, bool)."""
    return PhaseState(**{
        f: torch.from_numpy(np.ascontiguousarray(
            np.asarray(fields[f]).astype(dt))).to(device)
        for f, dt in _STATE_DTYPES.items()})
