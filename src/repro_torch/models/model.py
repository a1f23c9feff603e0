"""Model assembly: init / forward / prefill / decode, the counterpart of
``repro.models.model`` for the dense family (llama-style GQA + SwiGLU:
deepseek, yi, phi3, and command-r's parallel block with LayerNorm), the
moe family (phi3.5-moe, qwen3-moe: the dense block with ``moe.moe_block``
in place of the MLP), the ssm family (falcon-mamba: a norm and a Mamba1
or Mamba2 block a layer) and the hybrid family (zamba2: super-blocks of
``attn_every`` Mamba2 layers, each followed by one shared dense block).

Parameters are a dict as in the reference, with one dict a layer in
``params["layers"]`` where the reference stacks the layers on axis 0 for
``lax.scan``, and the hybrid's shared block in ``params["shared_attn"]``
(one dense layer, its weights the same in every super-block); the weights
are held in ``cfg.dtype`` (see ``layers``).  The decode state is
``{"pos": int}`` with, for attention, ``"kv": {"k", "v"}``, the caches
(n, B, KV, T, hd) in ``cfg.dtype`` (n the layers, or the hybrid's
super-blocks: the shared block keeps a cache a super-block): the kernels'
head-major layout, so a decode step writes its token's K/V in place at
``pos`` and hands each cache to the decode kernel as it lies; and for the
ssm layers ``"ssm": {"h", "conv"}``, the reference's layout, h (L, B, di,
N) float32 for Mamba1 or (L, B, nh, hd, N) for Mamba2 and conv (L, B,
W-1, channels) in ``cfg.dtype``; a step overwrites each layer's entries
in place.

Every entry point takes ``device=`` (default ``"cuda"``, which raises
without a card; ``"cpu"`` runs the kernels' plain versions) and expects
the parameters, and a given state, on that device.  On the card, each
prefill or forward launches the flash kernel once an attention block (a
layer, or a hybrid's super-block), and each decode step the decode kernel
once an attention block; each prefill or forward of a Mamba1 model
launches the scan kernel once a layer (a prefill's launch also writes the
layer's end state), and a decode step none.  Mamba2 launches no kernel:
its SSD is a chunked matmul form in PyTorch, as the reference's is jnp.
A moe layer launches what a dense layer does (flash a forward or
prefill, decode a step) and no kernel for its router, dispatch and
experts, which are PyTorch ops (sorts, a scatter, a gather and batched
matmuls) as the reference's are jnp; ``forward`` returns the layers'
mean aux and z losses.

The dense, moe, ssm and hybrid families are ported.  The others raise
``NotImplementedError`` naming the slice of ``ROADMAP.md`` (Queue 1, item
2) that will port them.  The reference's remat, ``scan_layers``, mesh
constraints, logical axes, ``abstract_params``, sequence-sharded caches
and ``lm_loss`` (training) have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, _dtype, apply_mlp, apply_norm,
                                       embed_tokens, init_embed, init_mlp,
                                       init_norm, unembed)

#: the families of attention layers alone, a cache each (the reference's
#: ("dense", "vlm", "moe") grouping, less the VLM not ported yet)
ATTENTION_FAMILIES = ("dense", "moe")
#: the slice of ROADMAP.md's Queue 1 item 2 that ports each other family
PENDING_SLICES = {
    "vlm": "the VLM slice (qwen2-vl, M-RoPE, the vision stub)",
    "audio": "the audio slice (whisper: encoder and cross attention)",
}


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is of a family this
    package ports (dense, moe, ssm or hybrid), and ``ValueError`` for an ssm
    version other than 1 or 2 or a hybrid whose ``num_layers`` is not a
    multiple of ``attn_every`` (the reference's reshape into super-blocks
    fails there)."""
    if cfg.family in PENDING_SLICES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; "
            f"ROADMAP.md Queue 1 item 2(a) queues it as "
            f"{PENDING_SLICES[cfg.family]}")
    if cfg.family not in ATTENTION_FAMILIES:
        ssm.check_version(cfg)
    if cfg.family == "hybrid" and cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is not a "
                         f"multiple of attn_every {cfg.attn_every}")


def _check_on(params: Params, dev: torch.device) -> None:
    where = params["embed"]["tok"].device
    if where.type != dev.type:
        raise ValueError(f"the parameters are on {where}, device={dev}")


def _tokens(tokens, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(tokens, device=dev)
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"tokens must be integers, got {t.dtype}")
    return t.long()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_dense_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    p: Params = {"ln1": init_norm(cfg, gen.device),
                 "attn": attn.init_attention(gen, cfg)}
    if not cfg.parallel_block:
        p["ln2"] = init_norm(cfg, gen.device)
    if cfg.family == "moe":
        p["moe"] = moe.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    init = ssm.init_mamba1 if cfg.ssm_version == 1 else ssm.init_mamba2
    return {"ln1": init_norm(cfg, gen.device), "mamba": init(gen, cfg)}


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``, with the reference's distributions (truncated
    normal at fan-in scale, embeddings normal x 0.02, norms ones and
    zeros; Mamba1's and Mamba2's as ``ssm.init_mamba1`` and
    ``ssm.init_mamba2`` say); a hybrid's shared block is drawn after its
    layers."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_layer = _init_dense_layer if cfg.family in ATTENTION_FAMILIES \
        else _init_ssm_layer
    p = {"embed": init_embed(gen, cfg),
         "final_norm": init_norm(cfg, dev),
         "layers": [init_layer(gen, cfg) for _ in range(cfg.num_layers)]}
    if cfg.family == "hybrid":
        p["shared_attn"] = _init_dense_layer(gen, cfg)
    return p


# ---------------------------------------------------------------------------
# layer application (forward / prefill / decode share one code path)
# ---------------------------------------------------------------------------

def _dense_layer_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                       positions, *, cache=None, pos: int = 0, length=None):
    """One dense block over x (B,S,D).  Without ``cache``, causal
    attention over x's own tokens (the flash kernel).  With ``cache``, a
    block's (k, v) caches (B,KV,T,hd), x is one token at ``pos``: its K/V
    are written into the caches in place and it attends over the first
    ``length`` (B,) keys (the decode kernel).  Returns (x_out, k, v,
    losses), k and v (B,KV,S,hd) of x's tokens and losses a moe layer's
    (aux, z), None for a dense one.  The parallel block (command-r) sums
    attention and MLP as the reference's default ``PerfFlags`` do
    (``parallel_fused_ar`` off)."""
    h = apply_norm(lp["ln1"], x, cfg)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions)
    if cache is None:
        o = attn.blockwise_attention(q, k, v, cfg)
    else:
        ck, cv = cache
        ck[:, :, pos] = k[:, :, 0]
        cv[:, :, pos] = v[:, :, 0]
        o = attn.decode_attention(q[:, :, 0], ck, cv, length, cfg)[:, :, None]
    a_out = attn.attn_output(lp["attn"], o, cfg)
    if cfg.parallel_block:
        return x + a_out + apply_mlp(lp["mlp"], h, cfg), k, v, None
    x = x + a_out
    h2 = apply_norm(lp["ln2"], x, cfg)
    if "moe" in lp:
        m_out, aux, z = moe.moe_block(lp["moe"], h2, cfg)
        return x + m_out, k, v, (aux, z)
    return x + apply_mlp(lp["mlp"], h2, cfg), k, v, None


def _ssm_layer_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                     state=None, capture: bool = False):
    """One ssm layer, x + mamba(norm(x)), Mamba1 or Mamba2 by
    ``cfg.ssm_version``: over x's tokens (Mamba1 one scan launch; with
    ``capture`` also the layer's end state), or one step from ``state``.
    Returns (x_out, the layer's new state or None)."""
    block = ssm.mamba1_block if cfg.ssm_version == 1 else ssm.mamba2_block
    o, st = block(lp["mamba"], apply_norm(lp["ln1"], x, cfg), cfg, state,
                  return_final_state=capture)
    return x + o, st


def _blocks(params: Params, cfg: ModelConfig):
    """The trunk in order, as (kind, index, block params): ("ssm", layer,
    ...) for an ssm layer, ("attn", cache, ...) for a dense block, the
    index naming its entry of the decode state (a moe layer is a dense
    block).  A hybrid walks its ``num_layers // attn_every``
    super-blocks: ``attn_every`` Mamba2 layers, then the shared block
    with the super-block's own cache."""
    layers = params["layers"]
    if cfg.family in ATTENTION_FAMILIES:
        return [("attn", i, lp) for i, lp in enumerate(layers)]
    walk = [("ssm", i, lp) for i, lp in enumerate(layers)]
    if cfg.family == "ssm":
        return walk
    E = cfg.attn_every
    return [b for sb in range(cfg.num_layers // E)
            for b in walk[sb * E:(sb + 1) * E]
            + [("attn", sb, params["shared_attn"])]]


def _positions(B: int, S: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)


# ---------------------------------------------------------------------------
# trunk forward (full teacher-forced sequence -> final hidden)
# ---------------------------------------------------------------------------

def forward_hidden(params: Params, batch: dict, cfg: ModelConfig, *,
                   device="cuda"):
    """Returns (hidden (B,S,D) after the final norm, aux losses dict:
    a moe model's ``moe_aux`` and ``moe_z`` the sums of its layers' over
    ``num_layers``, as the reference's; the other families' zero)."""
    check_family(cfg)
    dev = resolve_device(device)
    _check_on(params, dev)
    tokens = _tokens(batch["tokens"], dev)
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = _positions(*tokens.shape, dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    for kind, _, lp in _blocks(params, cfg):
        if kind == "ssm":
            x, _ = _ssm_layer_apply(lp, x, cfg)
            continue
        x, _, _, losses = _dense_layer_apply(lp, x, cfg, positions)
        if losses is not None:
            aux, z = aux + losses[0], z + losses[1]
    x = apply_norm(params["final_norm"], x, cfg)
    n = max(cfg.num_layers, 1)
    return x, {"moe_aux": aux / n, "moe_z": z / n}


def forward(params: Params, batch: dict, cfg: ModelConfig, *, device="cuda"):
    """Full logits (B,S,V) in ``cfg.dtype`` and the aux dict."""
    h, aux = forward_hidden(params, batch, cfg, device=device)
    return unembed(params["embed"], h, cfg), aux


# ---------------------------------------------------------------------------
# decode: state init / prefill / single-token step
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device="cuda") -> dict:
    """An empty decode state: ``pos`` 0; for attention zeroed caches
    (n, batch, KV, max_len, hd) in ``cfg.dtype``, n the dense or moe
    layers or the hybrid's super-blocks; for the ssm layers zeroed states
    (L, ...) as ``ssm.mamba1_state_init`` or ``ssm.mamba2_state_init``
    makes them (an ssm model does not read ``max_len``, as in the
    reference)."""
    check_family(cfg)
    dev = resolve_device(device)
    state: dict = {"pos": 0}
    if cfg.family not in ATTENTION_FAMILIES:
        init = ssm.mamba1_state_init if cfg.ssm_version == 1 \
            else ssm.mamba2_state_init
        state["ssm"] = {n: t[None].repeat((cfg.num_layers,) + (1,) * t.ndim)
                        for n, t in init(cfg, batch, dev).items()}
    if cfg.family != "ssm":
        n = cfg.num_layers if cfg.family in ATTENTION_FAMILIES \
            else cfg.num_layers // cfg.attn_every
        shape = (n, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        state["kv"] = {
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}
    return state


def _fill_state(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                state: dict) -> torch.Tensor:
    """One pass over the trunk that writes each attention block's K/V of
    ``tokens`` (B,S) into the first S slots of its cache in ``state``
    (its q/k/v computed once, where the reference computes them twice with
    the same numbers), and each ssm layer's end state (h from its scan or
    SSD, conv the last W-1 inputs of its convolution) into
    ``state["ssm"]``; returns the hidden state before the final norm."""
    B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = _positions(B, S, tokens.device)
    for kind, i, lp in _blocks(params, cfg):
        if kind == "ssm":
            x, st = _ssm_layer_apply(lp, x, cfg, capture=True)
            state["ssm"]["h"][i] = st["h"]
            state["ssm"]["conv"][i] = st["conv"]
        else:
            x, k, v, _ = _dense_layer_apply(lp, x, cfg, positions)
            state["kv"]["k"][i, :, :, :S] = k
            state["kv"]["v"][i, :, :, :S] = v
    return x


def prefill(params: Params, batch: dict, cfg: ModelConfig,
            max_len: int | None = None, *, device="cuda"):
    """Prefill: one trunk pass that emits (last-position logits (B,V), a
    decode state whose caches of ``max_len or S`` slots hold the prompt's
    K/V, ``pos`` = S).  The ssm layers' states hold each layer's end
    state (a Mamba1 model does not read ``max_len``); a prompt shorter
    than ``ssm_conv - 1`` raises ``ValueError`` on a model with ssm layers
    (its conv state would be short, and the reference's decode refuses
    it); any longer one runs, a multiple of ``ssm_chunk`` or not."""
    check_family(cfg)
    dev = resolve_device(device)
    _check_on(params, dev)
    tokens = _tokens(batch["tokens"], dev)
    B, S = tokens.shape
    max_len = max_len or S
    if cfg.family != "ssm" and max_len < S:
        raise ValueError(f"max_len={max_len} is shorter than the prompt's "
                         f"{S} tokens")
    state = init_decode_state(cfg, B, max_len, device=dev)
    x = _fill_state(params, tokens, cfg, state)
    state["pos"] = S
    h = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return unembed(params["embed"], h, cfg)[:, 0], state


def decode_step(params: Params, state: dict, token, cfg: ModelConfig, *,
                device="cuda"):
    """token: (B,) integers.  Returns (logits (B,V), new state).  The new
    state shares the given state's tensors, into which this step writes
    in place (each cache its token's K/V at ``pos``; each ssm layer its h
    and conv): the given state is consumed."""
    check_family(cfg)
    dev = resolve_device(device)
    _check_on(params, dev)
    pos = int(state["pos"])
    token = _tokens(token, dev)
    B = token.shape[0]
    x = embed_tokens(params["embed"], token[:, None], cfg)          # (B,1,D)
    if "kv" in state:
        ck, cv = state["kv"]["k"], state["kv"]["v"]
        if pos >= ck.shape[3]:
            raise ValueError(f"the cache's {ck.shape[3]} slots are full "
                             f"(pos {pos})")
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        length = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    for kind, i, lp in _blocks(params, cfg):
        if kind == "ssm":
            hs, cs = state["ssm"]["h"], state["ssm"]["conv"]
            x, st = _ssm_layer_apply(lp, x, cfg,
                                     state={"h": hs[i], "conv": cs[i]})
            hs[i] = st["h"]
            cs[i] = st["conv"]
        else:
            x, _, _, _ = _dense_layer_apply(lp, x, cfg, positions,
                                            cache=(ck[i], cv[i]), pos=pos,
                                            length=length)
    x = apply_norm(params["final_norm"], x, cfg)
    return unembed(params["embed"], x, cfg)[:, 0], dict(state, pos=pos + 1)
