"""Plain PyTorch versions of the hand-written kernels.

The CPU tests hold the port to the JAX reference through these, the
engine runs them when its tensors lie on the CPU, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

Ranking order is the total order (score descending, gallery index
ascending): a stable descending sort keeps the lower index first among
equal scores, as ``jax.lax.top_k`` does.  ``torch.topk`` promises no
order among ties, so it is not used.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


#: elements of the (rows, G, D) products one host score pass holds
_HOST_CHUNK = 1 << 24


def masked_scores(queries, gallery):
    """(Q, G) float32 inner products for the masked kernels' plain version.

    On the card: ``queries @ gallery.T``.  On the host each score is its
    own depth-ordered chain: ``cumsum`` sums the float32 products in depth
    order in a float64 accumulator, and the last step is rounded to
    float32.  So a score depends on its query and gallery rows alone, but
    it is not the card kernel's float32 FMA chain and need not equal it
    bit for bit.  The host's matrix product rounds a row by how many rows
    share the call, which would part a fleet's worker blocks from the
    single engine's round and the consolidated round from the per-frame
    one."""
    q, g = queries.to(torch.float32), gallery.to(torch.float32)
    if q.device.type != "cpu":
        return q @ g.T
    (Q, D), G = q.shape, g.shape[0]
    if Q == 0 or G == 0 or D == 0:
        return q.new_zeros((Q, G))
    rows = max(1, _HOST_CHUNK // (G * D))
    return torch.cat([(q[a:a + rows, None, :] * g[None]).cumsum(-1)[..., -1]
                      for a in range(0, Q, rows)])


def _segment_masked_ref(queries, q_tag, admit, gallery, gal_cam, gal_tag,
                        k: int):
    Q, C = admit.shape
    G = gallery.shape[0]
    s = masked_scores(queries, gallery)
    # cam outside [0, C) (padded rows carry -1) is "no camera": ineligible
    cam_ok = (gal_cam >= 0) & (gal_cam < C)
    cams = torch.where(cam_ok, gal_cam, 0).to(torch.int64)
    valid = admit.gather(1, cams[None, :].expand(Q, G)) & cam_ok[None, :] & \
        (gal_tag[None, :] == q_tag[:, None])
    return _topk_rows(torch.where(valid, s, torch.full_like(s, NEG_INF)), k)


def reid_topk_masked_ref(queries, q_frame, admit, gallery, gal_cam,
                         gal_frame, k: int):
    """Query q may only score gallery row g when ``admit[q, gal_cam[g]]``
    and ``gal_frame[g] == q_frame[q]``.  Returns (scores (Q, k) float32,
    idx (Q, k) int32); fully masked slots (and slots past G) come back as
    (NEG_INF, -1)."""
    return _segment_masked_ref(queries, q_frame, admit, gallery, gal_cam,
                               gal_frame, k)


def reid_topk_segments_ref(queries, q_seg, admit, gallery, gal_cam,
                           gal_seg, k: int):
    """The consolidated variant: identical math to ``reid_topk_masked_ref``
    with the frame tags swapped for round-scoped segment ids."""
    return _segment_masked_ref(queries, q_seg, admit, gallery, gal_cam,
                               gal_seg, k)


def reid_topk_tiles_ref(queries, q_tag, admit_ct, gallery, gal_ct, gal_tag,
                        k: int):
    """The tile-granular variant: query q may only score gallery row g when
    ``admit_ct[q, gal_ct[g]]`` (the fused (camera, tile) cell is admitted)
    and ``gal_tag[g] == q_tag[q]``.  A cell outside [0, C*T*T) (unlabeled
    or padded rows carry -1) is never admitted, as in the Pallas kernel's
    one-hot.  The segment version's math with the camera axis widened to
    C*T*T cells."""
    return _segment_masked_ref(queries, q_tag, admit_ct, gallery, gal_ct,
                               gal_tag, k)


def _topk_rows(scores, k: int):
    """(Q, k) best of each row in the order (score desc, index asc), with
    the ``(NEG_INF, -1)`` tail past the row length and wherever the score
    is a sentinel."""
    Q, G = scores.shape
    if G < k:
        scores = torch.cat([scores, torch.full((Q, k - G), NEG_INF,
                                               dtype=torch.float32,
                                               device=scores.device)], dim=1)
    sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
    sv, si = sv[:, :k].contiguous(), si[:, :k].to(torch.int32)
    return sv, torch.where(sv > NEG_INF / 2, si, torch.full_like(si, -1))


def merge_topk(parts, k: int):
    """The merge pass of the gallery-split kernels: the (Q, k) best of
    several top-k lists of the same queries, each (scores, idx) best first
    with global gallery indices and ``(NEG_INF, -1)`` slots, in the order
    (score desc, index asc), sentinels past the last real candidate."""
    v = torch.cat([p[0] for p in parts], dim=1)
    i = torch.cat([p[1] for p in parts], dim=1).to(torch.int64)
    # index ascending first (sentinels last), so that the stable sort on
    # the score leaves equal scores in index order
    by_index = torch.argsort(torch.where(i < 0, torch.iinfo(torch.int64).max,
                                         i), dim=1, stable=True)
    v, i = v.gather(1, by_index), i.gather(1, by_index)
    sv, pos = torch.sort(v, dim=1, descending=True, stable=True)
    si = i.gather(1, pos).to(torch.int32)
    Q, n = sv.shape
    if n < k:
        sv = torch.cat([sv, torch.full((Q, k - n), NEG_INF,
                                       dtype=torch.float32,
                                       device=sv.device)], dim=1)
        si = torch.cat([si, torch.full((Q, k - n), -1, dtype=torch.int32,
                                       device=si.device)], dim=1)
    sv, si = sv[:, :k].contiguous(), si[:, :k]
    return sv, torch.where(sv > NEG_INF / 2, si, torch.full_like(si, -1))


def reid_topk_ref(queries, gallery, k: int):
    """Top-k of the inner products ``queries @ gallery.T`` (any float
    dtype, computed in float32): (scores (Q, k) float32, idx (Q, k)
    int32), best first.  As the Pallas kernel and unlike
    ``repro.kernels.ref.reid_topk_ref``, k > G gives a ``(NEG_INF, -1)``
    tail, and Q == 0 or G == 0 gives sentinels."""
    Q, G = queries.shape[0], gallery.shape[0]
    if Q == 0 or G == 0:
        return (torch.full((Q, k), NEG_INF, dtype=torch.float32,
                           device=queries.device),
                torch.full((Q, k), -1, dtype=torch.int32,
                           device=queries.device))
    s = queries.to(torch.float32) @ gallery.to(torch.float32).T
    return _topk_rows(s, k)


def _flash_scores(q, k, causal: bool):
    """The scores of prefill attention, (B, KV, H / KV, S, T) float32:
    q . k * hd**-0.5, NEG_INF where ``causal`` masks the key."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    qr = q.reshape(B, KV, H // KV, S, hd).to(torch.float32)
    s = torch.einsum("bkgqh,bkth->bkgqt", qr, k.to(torch.float32)) \
        * hd ** -0.5
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= \
            torch.arange(T, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Prefill attention.  q (B, H, S, hd); k, v (B, KV, T, hd) with
    H % KV == 0, q head h reading kv head h // (H / KV); softmax in float32
    with scale hd**-0.5; ``causal`` masks key positions past the query's
    (both counted from 0) with NEG_INF.  Returns (B, H, S, hd) in q's
    dtype."""
    B, H, S, hd = q.shape
    p = torch.softmax(_flash_scores(q, k, causal), dim=-1)
    o = torch.einsum("bkgqt,bkth->bkgqh", p, v.to(torch.float32))
    return o.reshape(B, H, S, hd).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal: bool = True):
    """Each row's logsumexp of ``flash_attention_ref``'s scaled, masked
    scores, the natural log, float32 (B, H, S): what the kernel's forward
    writes for the backward (``flash_attention.FlashAttention``)."""
    B, H, S, _ = q.shape
    return torch.logsumexp(_flash_scores(q, k, causal),
                           dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True):
    """The gradients (dq, dk, dv) of ``flash_attention_ref`` at (q, k, v)
    against the output gradient ``do``: ``torch.autograd.grad`` of the
    plain forward on float32 copies of q, k, v and ``do``, cast to the
    inputs' dtype.  dk and dv sum over the H / KV query heads that read
    each kv head.  ``o`` (the forward's output) and ``lse`` (its
    logsumexp, ``flash_attention_lse_ref``'s, which the kernel reads) are
    the kernel's arguments and are not read: the plain version recomputes
    the forward."""
    with torch.enable_grad():
        q32, k32, v32 = (t.detach().to(torch.float32).requires_grad_()
                         for t in (q, k, v))
        out = flash_attention_ref(q32, k32, v32, causal=causal)
        grads = torch.autograd.grad(out, (q32, k32, v32),
                                    do.to(torch.float32))
    return tuple(g.to(q.dtype) for g in grads)


def decode_attention_ref(q, k_cache, v_cache, length):
    """One-token attention over a cache.  q (B, H, hd); caches
    (B, KV, T, hd); length (B,) valid keys per row (a length past T means
    T).  Returns (B, H, hd) in q's dtype.  A row with ``length <= 0`` is
    zeros, as the Pallas kernel gives (every tile skipped); the softmax of
    ``repro.kernels.ref.decode_attention_ref`` would give the mean of V."""
    B, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bkgh,bkth->bkgt", qr, k_cache.to(torch.float32)) \
        * hd ** -0.5
    length = length.to(device=q.device, dtype=torch.int64)
    mask = torch.arange(T, device=q.device)[None] < length[:, None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bkth->bkgh", p, v_cache.to(torch.float32))
    o = torch.where((length > 0)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_split(q, k_cache, v_cache, length, plan):
    """``decode_attention_ref`` in the CUDA kernel's association order
    under ``plan`` (a ``decode_attention.DecodePlan``): scores in log2 units
    (``q . k * hd**-0.5 * log2(e)``); in each split of ``plan.split`` keys,
    ``plan.warps`` running (max, sum, accumulator) states over the split's
    tiles of ``plan.tile`` keys dealt in turn, merged at the end of the
    split; the splits a row reaches combined by their common max.  Same
    arguments and result; a test reference for the plan's arithmetic (the
    products' own order within a tile is the card's: CUDA-core sums in
    float32, tensor-core sums in bfloat16)."""
    B, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    warps, log2e = plan.warps, 1.4426950408889634
    qr = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    k, v = k_cache.to(torch.float32), v_cache.to(torch.float32)
    scale = torch.tensor(hd ** -0.5 * log2e, dtype=torch.float32)
    s = torch.einsum("bkgh,bkth->bkgt", qr, k) * scale
    n = length.to(device=q.device, dtype=torch.int64).clamp(0, T)
    s = torch.where((torch.arange(T, device=q.device)[None] < n[:, None])
                    [:, None, None], s, torch.full_like(s, NEG_INF))
    shape = s.shape[:3]

    def state():
        return (torch.full(shape, NEG_INF, device=q.device),
                torch.zeros(shape, device=q.device),
                torch.zeros(shape + (hd,), device=q.device))

    def merge(states, live):
        """(m, l, acc) of the live states by their common max."""
        m = torch.stack([x[0] for x in states])
        m = torch.where(live, m, torch.full_like(m, NEG_INF))
        top = m.max(0).values
        w = torch.where(live, torch.exp2(m - top), torch.zeros_like(m))
        return (top, (torch.stack([x[1] for x in states]) * w).sum(0),
                (torch.stack([x[2] for x in states]) * w[..., None]).sum(0))

    parts, reached = [], []
    for a0 in range(0, max(T, 1), plan.split):
        a1 = min(a0 + plan.split, T)
        per_warp = []
        for w in range(warps):
            m, l, acc = state()
            for t0 in range(a0 + w * plan.tile, a1, warps * plan.tile):
                t1 = min(t0 + plan.tile, a1)
                tile = s[..., t0:t1]
                m_new = torch.maximum(m, tile.max(-1).values)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(tile - m_new[..., None])
                run = (n > t0)[:, None, None]     # the row reaches the tile
                l = torch.where(run, l * corr + p.sum(-1), l)
                acc = torch.where(run[..., None], acc * corr[..., None]
                                  + torch.einsum("bkgt,bkth->bkgh", p,
                                                 v[:, :, t0:t1]), acc)
                m = torch.where(run, m_new, m)
            per_warp.append((m, l, acc))
        parts.append(merge(per_warp, torch.ones((warps, 1, 1, 1),
                                                dtype=torch.bool,
                                                device=q.device)))
        reached.append((n > a0)[:, None, None])
    m, l, acc = merge(parts, torch.stack(reached))
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    o = torch.where((n > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, H, hd).to(q.dtype)


def mamba_scan_ref(u, dt, Bm, Cm, A, h0):
    """The Mamba1 selective scan, one step at a time, in float32:
    ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t`` and
    ``y_t = h_t . C_t``.  u, dt (B, L, D); Bm, Cm (B, L, N); A (D, N);
    h0 (B, D, N).  Returns (y (B, L, D), h_L (B, D, N))."""
    u, dt, Bm, Cm, A = (x.to(torch.float32) for x in (u, dt, Bm, Cm, A))
    h = h0.to(torch.float32)
    ys = []
    for t in range(u.shape[1]):
        da = torch.exp(dt[:, t, :, None] * A)                  # (B, D, N)
        h = da * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) if ys else u.new_zeros(u.shape)
    return y, h


def mamba_scan_chunked(u, dt, Bm, Cm, A, h0, chunk: int):
    """The selective scan in the CUDA kernel's association order: each
    chunk of ``chunk`` steps (the last one ragged) is scanned from a zero
    state, and its states are then composed with the carry,
    ``h_t = exp(A * sum(dt over the chunk up to t)) * carry + hl_t``.
    Same arguments and result as ``mamba_scan_ref``."""
    u, dt, Bm, Cm, A = (x.to(torch.float32) for x in (u, dt, Bm, Cm, A))
    h = h0.to(torch.float32)
    ys = []
    for c0 in range(0, u.shape[1], chunk):
        c1 = min(c0 + chunk, u.shape[1])
        dtc = dt[:, c0:c1]
        hl, hls = torch.zeros_like(h), []
        for t in range(c1 - c0):                      # from zero
            hl = torch.exp(dtc[:, t, :, None] * A) * hl + \
                (dtc[:, t] * u[:, c0 + t])[..., None] * Bm[:, c0 + t, None, :]
            hls.append(hl)
        decay = torch.exp(torch.cumsum(dtc, 1)[..., None] * A)  # (B, c, D, N)
        hc = decay * h[:, None] + torch.stack(hls, 1)             # + carry
        ys.append((hc * Cm[:, c0:c1, None, :]).sum(-1))
        h = hc[:, -1]
    y = torch.cat(ys, 1) if ys else u.new_zeros(u.shape)
    return y, h
