"""Carry state between the numpy world and the port's tensors.

The JAX package's model fields, read out as numpy arrays, become the
port's ``SpatioTemporalModel`` here, so both engines can be handed the
same M; the profiler builds its model through the same function.  The
backbone zoo's parameters and decode state cross the same way
(``params_from_numpy``, ``decode_state_from_numpy``,
``decode_state_to_numpy``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.correlation import FIELDS, SpatioTemporalModel
from repro_torch.core.policy import PhaseState
from repro_torch.device import resolve_device
from repro_torch.models.attention import head_mask
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ATTENTION_FAMILIES, check_family
from repro_torch.models.ssm import PARAM_DTYPE_LEAVES

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


def _tensor(a, dtype, dev) -> torch.Tensor:
    """A copy of a numpy array (float32, or bfloat16 as the JAX package
    reads one out) as a tensor of ``dtype`` on ``dev``, through float32,
    which holds both exactly."""
    return torch.tensor(np.asarray(a, dtype=np.float32)).to(device=dev,
                                                            dtype=dtype)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The reference's parameter tree (``repro.models.init_params`` read
    out as numpy: layers stacked on axis 0, query heads padded to
    ``cfg.num_padded_heads``) as the port's parameters on ``device``: one
    dict a layer, and a hybrid's ``shared_attn`` (one dense layer, not
    stacked) as it is; the pad heads' columns of ``wq`` and ``bq`` and
    rows of ``wo`` dropped, so the port runs ``cfg.num_heads`` heads (the
    pads are zero and masked in the reference, so the output is
    unchanged); the norms, and the Mamba leaves of
    ``ssm.PARAM_DTYPE_LEAVES`` (``conv_w``, ``conv_b``, ``A_log``,
    ``dt_bias``, ``D`` and Mamba2's ``norm_scale``), in
    ``cfg.param_dtype``, a moe layer's router in float32 (the reference
    routes on float32 logits, whatever ``cfg.param_dtype`` is) and every
    other tensor, the experts' ``wi``, ``wg`` and ``wo`` too, cast once to
    ``cfg.dtype``, the casts the reference makes at each use."""
    check_family(cfg)
    dev = resolve_device(device)
    dt, pdt = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
    mask = head_mask(cfg)
    real = slice(None) if mask is None else np.repeat(mask > 0, cfg.head_dim)

    def leaf(group: str, name: str, a):
        if group == "attn" and name in ("wq", "bq"):
            a = a[..., real]
        elif group == "attn" and name == "wo":
            a = a[real]
        if group == "moe" and name == "router":
            return _tensor(a, torch.float32, dev)
        held = group in ("ln1", "ln2", "final_norm") or (
            group == "mamba" and name in PARAM_DTYPE_LEAVES)
        return _tensor(a, pdt if held else dt, dev)

    def layer(groups: dict, index=None) -> dict:
        return {group: {n: leaf(group, n, np.asarray(a) if index is None
                                else np.asarray(a)[index])
                        for n, a in sub.items()}
                for group, sub in groups.items()}

    out = {
        "embed": {n: leaf("embed", n, a) for n, a in tree["embed"].items()},
        "final_norm": {n: leaf("final_norm", n, a)
                       for n, a in tree["final_norm"].items()},
        "layers": [layer(tree["layers"], i) for i in range(cfg.num_layers)]}
    if cfg.family == "hybrid":
        out["shared_attn"] = layer(tree["shared_attn"])
    return out


def decode_state_from_numpy(cfg: ModelConfig, state: dict,
                            device="cuda") -> dict:
    """The reference's decode state (``pos``; caches (n,B,T,KV,hd); the
    ssm layers' h and conv; read out as numpy) as the port's on
    ``device``: ``pos`` an int, caches (n,B,KV,T,hd) in ``cfg.dtype``, and
    the ssm states in their own layout, h (L,B,di,N) or Mamba2's
    (L,B,nh,hd,N) float32 and conv (L,B,W-1,channels) in ``cfg.dtype``;
    a hybrid's state carries both, a moe model's the caches alone."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    out: dict = {"pos": int(state["pos"])}
    if cfg.family not in ATTENTION_FAMILIES:
        out["ssm"] = {"h": _tensor(state["ssm"]["h"], torch.float32, dev),
                      "conv": _tensor(state["ssm"]["conv"], dt, dev)}
    if cfg.family != "ssm":
        out["kv"] = {n: _tensor(state["kv"][n], dt, dev)
                     .permute(0, 1, 3, 2, 4).contiguous() for n in ("k", "v")}
    return out


def decode_state_to_numpy(state: dict) -> dict:
    """The port's decode state in the reference's layout: ``pos`` an
    int32 scalar, the caches (n,B,T,KV,hd) and the ssm layers' h and conv
    where the state has them, as float32 arrays (numpy has no bfloat16;
    float32 holds a bfloat16 tensor's values exactly)."""
    out: dict = {"pos": np.int32(state["pos"])}
    if "ssm" in state:
        out["ssm"] = {n: t.float().cpu().numpy()
                      for n, t in state["ssm"].items()}
    if "kv" in state:
        out["kv"] = {n: state["kv"][n].permute(0, 1, 3, 2, 4).float().cpu()
                     .numpy() for n in ("k", "v")}
    return out
