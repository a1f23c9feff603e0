"""Model assembly: init / forward / prefill / decode, the counterpart of
``repro.models.model`` for all six families: dense (llama-style GQA +
SwiGLU: deepseek, yi, phi3, and command-r's parallel block with
LayerNorm), vlm (qwen2-vl: the dense block with qkv and MLP biases and
M-RoPE over three position streams; the vision frontend is the
reference's stub, precomputed patch embeddings in ``batch["embeds"]``),
moe (phi3.5-moe, qwen3-moe: the dense block with ``moe.moe_block`` in
place of the MLP), ssm (falcon-mamba: a norm and a Mamba1 or Mamba2 block
a layer), hybrid (zamba2: super-blocks of ``attn_every`` Mamba2 layers,
each followed by one shared dense block) and audio (whisper: an encoder
of dense layers over the conv frontend's stub, precomputed frame
embeddings in ``batch["frames"]``, and a decoder of dense layers with
cross attention over the encoder's output).

Parameters are a dict as in the reference, with one dict a layer in
``params["layers"]`` (and the audio encoder's in ``params["enc_layers"]``)
where the reference stacks the layers on axis 0 for ``lax.scan``, and the
hybrid's shared block in ``params["shared_attn"]`` (one dense layer, its
weights the same in every super-block); the weights are held in
``cfg.dtype`` (see ``layers``).  The decode state is ``{"pos": int}``
with, for attention, ``"kv": {"k", "v"}``, the caches (n, B, KV, T, hd)
in ``cfg.dtype`` (n the layers, or the hybrid's super-blocks: the shared
block keeps a cache a super-block): the kernels' head-major layout, so a
decode step writes its token's K/V in place at ``pos`` and hands each
cache to the decode kernel as it lies; for audio also ``"enc_kv": {"k",
"v", "len"}``, each decoder layer's cross K/V over the encoder's T
frames (L, B, KV, T, hd) and the frames' count (B,) int32; and for the
ssm layers ``"ssm": {"h", "conv"}``, the reference's layout, h (L, B, di,
N) float32 for Mamba1 or (L, B, nh, hd, N) for Mamba2 and conv (L, B,
W-1, channels) in ``cfg.dtype``; a step overwrites each layer's entries
in place.

Every entry point takes ``device=`` (default ``"cuda"``, which raises
without a card; ``"cpu"`` runs the kernels' plain versions) and expects
the parameters, and a given state, on that device.  On the card, each
prefill or forward launches the flash kernel once an attention block (a
layer, a hybrid's super-block, an audio encoder layer, and an audio
decoder layer twice: its causal self attention and its non-causal cross
attention over the encoder's frames), and each decode step the decode
kernel once an attention block (an audio decoder layer twice: its own
cache and the cross cache); each prefill or forward of a Mamba1 model
launches the scan kernel once a layer (a prefill's launch also writes the
layer's end state), and a decode step none.  Mamba2 launches no kernel:
its SSD is a chunked matmul form in PyTorch, as the reference's is jnp.
A moe layer launches what a dense layer does (flash a forward or
prefill, decode a step) and no kernel for its router, dispatch and
experts, which are PyTorch ops (sorts, a scatter, a gather and batched
matmuls) as the reference's are jnp; ``forward`` returns the layers'
mean aux and z losses.

``lm_loss`` is the training loss over ``forward_hidden``; its gradient
runs through the flash kernel's backward (``kernels.flash_attention``'s
``FlashAttention``) on the card.  To train, hold the parameters in
``cfg.param_dtype`` (``init_params(dataclasses.replace(cfg,
dtype=cfg.param_dtype))``, as ``launch.steps.init_train_params`` does):
every function casts its weights to ``cfg.dtype`` at use, as the
reference does, so the forward's numbers are the same and the gradients
land on the parameters themselves.

The reference's remat, ``scan_layers``, mesh constraints, logical axes,
``abstract_params`` and sequence-sharded caches have no counterpart here.
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

#: the families of dense layers alone, a cache each (the reference's
#: ("dense", "vlm", "moe") grouping)
ATTENTION_FAMILIES = ("dense", "vlm", "moe")
#: the families with Mamba layers
SSM_FAMILIES = ("ssm", "hybrid")
FAMILIES = ATTENTION_FAMILIES + SSM_FAMILIES + ("audio",)
#: positions a chunk of the loss's logits (the reference's bound on the
#: (B, chunk, V) float32 buffer)
LOSS_CHUNK = 2048


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the reference does not know, an
    ssm version other than 1 or 2, or a hybrid whose ``num_layers`` is not
    a multiple of ``attn_every`` (the reference's reshape into
    super-blocks fails there)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.family in SSM_FAMILIES:
        ssm.check_version(cfg)
    if cfg.family == "hybrid" and cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is not a "
                         f"multiple of attn_every {cfg.attn_every}")


def _check_on(params: Params, dev: torch.device) -> None:
    where = params["embed"]["tok"].device
    if where.type != dev.type:
        raise ValueError(f"the parameters are on {where}, device={dev}")


def _tokens(tokens, dev: torch.device, what: str = "tokens") -> torch.Tensor:
    t = torch.as_tensor(tokens, device=dev)
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"{what} must be integers, got {t.dtype}")
    return t.long()


def _floats(a, dev: torch.device, cfg: ModelConfig,
            what: str) -> torch.Tensor:
    """Embeddings (B, S, D) from outside (a tensor or an array) in
    ``cfg.dtype`` on ``dev``, as the reference's ``astype``."""
    t = torch.as_tensor(a, device=dev)
    if not t.dtype.is_floating_point or t.ndim != 3 or \
            t.shape[-1] != cfg.d_model:
        raise ValueError(f"{what} must be floats (B, S, {cfg.d_model}), got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.to(_dtype(cfg))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_dense_layer(gen: torch.Generator, cfg: ModelConfig,
                      with_cross: bool = False) -> Params:
    p: Params = {"ln1": init_norm(cfg, gen.device),
                 "attn": attn.init_attention(gen, cfg)}
    if not cfg.parallel_block:
        p["ln2"] = init_norm(cfg, gen.device)
    if with_cross:
        p["lnx"] = init_norm(cfg, gen.device)
        p["xattn"] = attn.init_attention(gen, cfg)
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
    zeros, biases zeros; Mamba1's and Mamba2's as ``ssm.init_mamba1`` and
    ``ssm.init_mamba2`` say); a hybrid's shared block is drawn after its
    layers, an audio model's encoder layers after its decoder layers (each
    with ``lnx`` and the cross attention ``xattn``)."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family in SSM_FAMILIES:
        layers = [_init_ssm_layer(gen, cfg) for _ in range(cfg.num_layers)]
    else:
        layers = [_init_dense_layer(gen, cfg, cfg.family == "audio")
                  for _ in range(cfg.num_layers)]
    p = {"embed": init_embed(gen, cfg), "final_norm": init_norm(cfg, dev),
         "layers": layers}
    if cfg.family == "hybrid":
        p["shared_attn"] = _init_dense_layer(gen, cfg)
    if cfg.family == "audio":
        p["enc_layers"] = [_init_dense_layer(gen, cfg)
                           for _ in range(cfg.encoder_layers)]
        p["enc_norm"] = init_norm(cfg, dev)
    return p


# ---------------------------------------------------------------------------
# layer application (forward / prefill / decode share one code path)
# ---------------------------------------------------------------------------

def _dense_layer_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                       positions, *, causal: bool = True, cache=None,
                       pos: int = 0, length=None, enc_kv=None):
    """One dense block over x (B,S,D).  Without ``cache``, attention over
    x's own tokens, causal or not (the flash kernel).  With ``cache``, a
    block's (k, v) caches (B,KV,T,hd), x is one token at ``pos``: its K/V
    are written into the caches in place and it attends over the first
    ``length`` (B,) keys (the decode kernel).  With ``enc_kv`` (k, v, len:
    the encoder's cross K/V (B,KV,T,hd) and its (B,) valid frames), the
    audio decoder's cross attention follows: ``lnx``, then ``xattn``'s
    queries without bias or RoPE, as the reference's, over the encoder's
    keys (flash non-causal, or the decode kernel over ``len`` where x is
    one token).  Returns (x_out, k, v, losses), k and v (B,KV,S,hd) of
    x's tokens and losses a moe layer's (aux, z), None for the others.
    The parallel block (command-r) sums attention and MLP as the
    reference's default ``PerfFlags`` do (``parallel_fused_ar`` off)."""
    h = apply_norm(lp["ln1"], x, cfg)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions)
    if cache is None:
        o = attn.blockwise_attention(q, k, v, cfg, causal=causal)
    else:
        ck, cv = cache
        ck[:, :, pos] = k[:, :, 0]
        cv[:, :, pos] = v[:, :, 0]
        o = attn.decode_attention(q[:, :, 0], ck, cv, length, cfg)[:, :, None]
    a_out = attn.attn_output(lp["attn"], o, cfg)
    if cfg.parallel_block:
        return x + a_out + apply_mlp(lp["mlp"], h, cfg), k, v, None
    x = x + a_out
    if enc_kv is not None:
        ek, ev, elen = enc_kv
        qx = attn.cross_q(lp["xattn"], apply_norm(lp["lnx"], x, cfg), cfg)
        if qx.shape[2] == 1:
            ox = attn.decode_attention(qx[:, :, 0], ek, ev, elen,
                                       cfg)[:, :, None]
        else:
            ox = attn.blockwise_attention(qx, ek, ev, cfg, causal=False)
        x = x + attn.attn_output(lp["xattn"], ox, cfg)
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
    index naming its entry of the decode state (a moe layer and an audio
    decoder layer are dense blocks).  A hybrid walks its ``num_layers //
    attn_every`` super-blocks: ``attn_every`` Mamba2 layers, then the
    shared block with the super-block's own cache."""
    layers = params["layers"]
    if cfg.family not in SSM_FAMILIES:
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


def _inputs(params: Params, batch: dict, cfg: ModelConfig,
            dev: torch.device):
    """The trunk's input x (B,S,D) and its positions: a VLM's
    ``batch["embeds"]`` cast to ``cfg.dtype`` where the batch has them
    (its tokens are then not read, as in the reference), else the
    tokens' embeddings; positions (B,S) ``arange(S)``, or where
    ``cfg.mrope`` (3,B,S), ``batch["positions"]`` or three copies of
    ``arange(S)``."""
    if cfg.family == "vlm" and "embeds" in batch:
        x = _floats(batch["embeds"], dev, cfg, "embeds")
    else:
        x = embed_tokens(params["embed"], _tokens(batch["tokens"], dev), cfg)
    B, S = x.shape[:2]
    if not cfg.mrope:
        return x, _positions(B, S, dev)
    if batch.get("positions") is None:
        return x, _positions(B, S, dev)[None].expand(3, B, S)
    positions = _tokens(batch["positions"], dev, "positions")
    if positions.shape != (3, B, S):
        raise ValueError(f"positions {tuple(positions.shape)} are not "
                         f"(3, {B}, {S})")
    return x, positions


def _encode(params: Params, frames, cfg: ModelConfig,
            dev: torch.device) -> torch.Tensor:
    """The audio encoder over frames (B,T,D): its layers with RoPE over
    ``arange(T)`` and non-causal attention, then ``enc_norm``."""
    x = _floats(frames, dev, cfg, "frames")
    positions = _positions(*x.shape[:2], dev)
    for lp in params["enc_layers"]:
        x = _dense_layer_apply(lp, x, cfg, positions, causal=False)[0]
    return apply_norm(params["enc_norm"], x, cfg)


def encode_audio(params: Params, frames, cfg: ModelConfig, *,
                 device="cuda") -> torch.Tensor:
    """Whisper's encoder over precomputed (stub) conv-frontend frame
    embeddings (B,T,D): (B,T,D) in ``cfg.dtype`` after ``enc_norm``."""
    check_family(cfg)
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: a {cfg.family} model has no encoder")
    dev = resolve_device(device)
    _check_on(params, dev)
    return _encode(params, frames, cfg, dev)


def _enc_len(enc: torch.Tensor) -> torch.Tensor:
    B, T = enc.shape[:2]
    return torch.full((B,), T, dtype=torch.int32, device=enc.device)


# ---------------------------------------------------------------------------
# trunk forward (full teacher-forced sequence -> final hidden)
# ---------------------------------------------------------------------------

def forward_hidden(params: Params, batch: dict, cfg: ModelConfig, *,
                   device="cuda"):
    """Returns (hidden (B,S,D) after the final norm, aux losses dict:
    a moe model's ``moe_aux`` and ``moe_z`` the sums of its layers' over
    ``num_layers``, as the reference's; the other families' zero).  An
    audio model encodes ``batch["frames"]`` once, and each decoder layer
    takes its cross K/V from the encoder's output."""
    check_family(cfg)
    dev = resolve_device(device)
    _check_on(params, dev)
    x, positions = _inputs(params, batch, cfg, dev)
    enc = _encode(params, batch["frames"], cfg, dev) \
        if cfg.family == "audio" else None
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    for kind, _, lp in _blocks(params, cfg):
        if kind == "ssm":
            x, _ = _ssm_layer_apply(lp, x, cfg)
            continue
        enc_kv = None if enc is None else (
            *attn.cross_kv(lp["xattn"], enc, cfg), _enc_len(enc))
        x, _, _, losses = _dense_layer_apply(lp, x, cfg, positions,
                                             enc_kv=enc_kv)
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
# loss (chunked over the sequence to bound the logits buffer)
# ---------------------------------------------------------------------------

def lm_loss(params: Params, batch: dict, cfg: ModelConfig, *,
            device="cuda"):
    """The next-token loss: the mean over the unmasked positions of the
    float32 negative log likelihood of ``batch["tokens"]`` shifted by one
    (the last position has no label), times ``batch["loss_mask"]`` where
    the batch has one; the logits made ``LOSS_CHUNK`` positions at a time.
    A moe model adds ``aux_loss_coef`` x ``moe_aux`` and ``router_z_coef``
    x ``moe_z``.  Returns (loss, {"loss", "ntok", "moe_aux", "moe_z"}), all
    float32 scalar tensors."""
    h, aux = forward_hidden(params, batch, cfg, device=device)
    dev = h.device
    tokens = _tokens(batch["tokens"], dev)
    B, S = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    mask = torch.cat([torch.ones((B, S - 1), dtype=torch.float32,
                                 device=dev),
                      torch.zeros((B, 1), dtype=torch.float32, device=dev)],
                     dim=1)
    if "loss_mask" in batch:
        mask = mask * torch.as_tensor(batch["loss_mask"],
                                      device=dev).to(torch.float32)
    C = min(LOSS_CHUNK, S)
    if S % C:
        raise ValueError(f"S={S} is not a multiple of the loss's chunk {C}")
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for c0 in range(0, S, C):
        logits = unembed(params["embed"], h[:, c0:c0 + C], cfg).to(
            torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, c0:c0 + C, None])[..., 0]
        total = total + ((lse - gold) * mask[:, c0:c0 + C]).sum()
    ntok = torch.clamp(mask.sum(), min=1.0)
    loss = total / ntok
    if cfg.family == "moe":
        loss = loss + cfg.aux_loss_coef * aux["moe_aux"] \
            + cfg.router_z_coef * aux["moe_z"]
    return loss, {"loss": loss, "ntok": ntok, **aux}


# ---------------------------------------------------------------------------
# decode: state init / prefill / single-token step
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device="cuda") -> dict:
    """An empty decode state: ``pos`` 0; for attention zeroed caches
    (n, batch, KV, max_len, hd) in ``cfg.dtype``, n the dense, moe or
    audio decoder layers or the hybrid's super-blocks; for audio the
    cross caches (L, batch, KV, ``cfg.encoder_seq``, hd) and ``len``
    (batch,) int32, zeroed; for the ssm layers zeroed states (L, ...) as
    ``ssm.mamba1_state_init`` or ``ssm.mamba2_state_init`` makes them (an
    ssm model does not read ``max_len``, as in the reference)."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    state: dict = {"pos": 0}
    if cfg.family in SSM_FAMILIES:
        init = ssm.mamba1_state_init if cfg.ssm_version == 1 \
            else ssm.mamba2_state_init
        state["ssm"] = {n: t[None].repeat((cfg.num_layers,) + (1,) * t.ndim)
                        for n, t in init(cfg, batch, dev).items()}
    if cfg.family != "ssm":
        n = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" \
            else cfg.num_layers
        shape = (n, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        state["kv"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.family == "audio":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.encoder_seq,
                 cfg.head_dim)
        state["enc_kv"] = {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    return state


def _fill_state(params: Params, x: torch.Tensor, positions, enc,
                cfg: ModelConfig, state: dict) -> torch.Tensor:
    """One pass over the trunk from its input x (B,S,D) that writes each
    attention block's K/V into the first S slots of its cache in
    ``state`` (its q/k/v computed once, where the reference computes them
    twice with the same numbers), an audio decoder layer's cross K/V over
    the encoder's output ``enc`` (B,T,D) into ``state["enc_kv"]``, made
    anew at T frames as the reference replaces it, and each ssm layer's
    end state (h from its scan or SSD, conv the last W-1 inputs of its
    convolution) into ``state["ssm"]``; returns the hidden state before
    the final norm."""
    S = x.shape[1]
    if enc is not None:
        B, T = enc.shape[:2]
        shape = (cfg.num_layers, B, cfg.num_kv_heads, T, cfg.head_dim)
        state["enc_kv"] = {
            "k": torch.empty(shape, dtype=_dtype(cfg), device=enc.device),
            "v": torch.empty(shape, dtype=_dtype(cfg), device=enc.device),
            "len": _enc_len(enc)}
    for kind, i, lp in _blocks(params, cfg):
        if kind == "ssm":
            x, st = _ssm_layer_apply(lp, x, cfg, capture=True)
            state["ssm"]["h"][i] = st["h"]
            state["ssm"]["conv"][i] = st["conv"]
            continue
        enc_kv = None
        if enc is not None:
            ek, ev = attn.cross_kv(lp["xattn"], enc, cfg)
            state["enc_kv"]["k"][i] = ek
            state["enc_kv"]["v"][i] = ev
            enc_kv = (ek, ev, state["enc_kv"]["len"])
        x, k, v, _ = _dense_layer_apply(lp, x, cfg, positions,
                                        enc_kv=enc_kv)
        state["kv"]["k"][i, :, :, :S] = k
        state["kv"]["v"][i, :, :, :S] = v
    return x


def prefill(params: Params, batch: dict, cfg: ModelConfig,
            max_len: int | None = None, *, device="cuda"):
    """Prefill: one trunk pass that emits (last-position logits (B,V), a
    decode state whose caches of ``max_len or S`` slots hold the prompt's
    K/V, ``pos`` = S).  A VLM's prompt is ``batch["embeds"]`` where the
    batch has them (B and S from them), an audio model's also encodes
    ``batch["frames"]`` (its cross caches hold T = the frames' count, not
    ``cfg.encoder_seq``, and ``len`` = T).  The ssm layers' states hold
    each layer's end state (a Mamba1 model does not read ``max_len``); a
    prompt shorter than ``ssm_conv - 1`` raises ``ValueError`` on a model
    with ssm layers (its conv state would be short, and the reference's
    decode refuses it); any longer one runs, a multiple of ``ssm_chunk``
    or not."""
    check_family(cfg)
    dev = resolve_device(device)
    _check_on(params, dev)
    x, positions = _inputs(params, batch, cfg, dev)
    B, S = x.shape[:2]
    max_len = max_len or S
    if cfg.family != "ssm" and max_len < S:
        raise ValueError(f"max_len={max_len} is shorter than the prompt's "
                         f"{S} tokens")
    enc = _encode(params, batch["frames"], cfg, dev) \
        if cfg.family == "audio" else None
    state = init_decode_state(cfg, B, max_len, device=dev)
    x = _fill_state(params, x, positions, enc, cfg, state)
    state["pos"] = S
    h = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return unembed(params["embed"], h, cfg)[:, 0], state


def decode_step(params: Params, state: dict, token, cfg: ModelConfig, *,
                device="cuda"):
    """token: (B,) integers.  Returns (logits (B,V), new state).  The new
    state shares the given state's tensors, into which this step writes
    in place (each cache its token's K/V at ``pos``; each ssm layer its h
    and conv): the given state is consumed.  A VLM's token sits at
    ``pos`` on all three M-RoPE streams, as in the reference; an audio
    decoder layer attends over its cross cache's first ``len`` frames."""
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
        shape = (3, B, 1) if cfg.mrope else (B, 1)
        positions = torch.full(shape, pos, dtype=torch.int32, device=dev)
        length = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    cross = state.get("enc_kv")
    for kind, i, lp in _blocks(params, cfg):
        if kind == "ssm":
            hs, cs = state["ssm"]["h"], state["ssm"]["conv"]
            x, st = _ssm_layer_apply(lp, x, cfg,
                                     state={"h": hs[i], "conv": cs[i]})
            hs[i] = st["h"]
            cs[i] = st["conv"]
        else:
            enc_kv = None if cross is None else (
                cross["k"][i], cross["v"][i], cross["len"])
            x, _, _, _ = _dense_layer_apply(lp, x, cfg, positions,
                                            cache=(ck[i], cv[i]), pos=pos,
                                            length=length, enc_kv=enc_kv)
    x = apply_norm(params["final_norm"], x, cfg)
    return unembed(params["embed"], x, cfg)[:, 0], dict(state, pos=pos + 1)
