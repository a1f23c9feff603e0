"""Decode attention (one token against a cache): the wrapper of the CUDA
kernel ``csrc/decode_attention.cu``, the counterpart of
``repro.kernels.decode_attention``.

q (B, H, hd); k_cache, v_cache (B, KV, T, hd), H a multiple of KV; float32
or bfloat16, all three alike; length (B,) integers, the valid prefix of
each row's cache (past T means T).  Returns (B, H, hd) in q's dtype; a row
with ``length <= 0`` is zeros, as the Pallas kernel gives.

Dispatch is by the tensors' device: on the CPU the plain version
``ref.decode_attention_ref`` runs; on a CUDA tensor the kernel launches
(any hd that is a multiple of 8 up to ``MAX_HEAD_DIM``, any number of q
heads per kv head, any B and T an ``int`` holds) or the wrapper raises.
``LAUNCHES`` counts the calls that launched, one a call.

``decode_plan`` chooses the kernel's geometry from the shape and the
card's SM count.  A block takes the q heads of one kv head (``heads`` of
them; more are taken in ``groups``) against one split of the cache, its
4 or 8 warps taking tiles of the split in turn, each through its own
cp.async ring; float32 computes on the CUDA cores, bfloat16 on the tensor
cores (``mma.sync``, 8 heads a block).  With one split the blocks write
the output; with more, each writes a float32 partial (max, sum,
accumulator) to a workspace, and the last block of a (row, kv head,
group) to finish, found by a ticket counter, combines them
(``launch(..., passes=1)`` runs the partials alone, to time the
combine).  The counters live per (card, stream) and the kernel leaves
them zero.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import DTYPES, _aligned, check_heads

#: the widest head the kernel takes (a template per padded width)
MAX_HEAD_DIM = 256
#: warps a block, each with its own ring of tiles: 8 where the ring fits,
#: so that a warp's serial share of a split is short, else 4
WARPS = (4, 8)
#: q heads a block scores at once (float32: a template, 1, 2, 4 or 8;
#: bfloat16: always 8, mma's N)
MAX_HEADS = 8
#: tiles in each warp's ring: one computed while the next two load
STAGES = 3
#: keys of a warp's tile at least (bfloat16: an mma's 16)
TILE_KEYS = 8
#: rounds of the block's warps a split holds at least
MIN_ROUNDS = 4
#: blocks the plan aims at on each SM, over the whole launch
BLOCKS_PER_SM = 8
#: keys a split holds at most, so that long rows are dealt over more blocks
SPLIT_KEYS = 2048
#: splits a (row, kv head) at most: the combine keeps one weight a split
MAX_SPLITS = 256
#: an H100 block's shared memory at most, 227 KB
MAX_SMEM = 232448
#: the largest size a launcher's ``int`` argument holds
INT_MAX = 2 ** 31 - 1
#: the longest cache the kernel takes: the key a warp loads, STAGES - 1
#: rounds ahead of the one it scores, is an int, at most T - 1 + STAGES
#: rounds of 8 warps' tiles of at most 32 keys
MAX_KEYS = INT_MAX + 1 - STAGES * 8 * 32

#: calls that launched the kernel since the last reset
LAUNCHES = 0

#: the ticket counters of each (card, stream): int32 zeros, which every
#: launch leaves zero (the combining block zeroes its own), so a call needs
#: no memset; launches on one stream run in turn and may share them.  Each
#: buffer ever handed out is kept, since a captured CUDA graph may name it.
_COUNTERS: dict = {}
_KEPT: list = []


class DecodePlan(NamedTuple):
    """One launch geometry of ``csrc/decode_attention.cu``."""
    hdp: int         # hd padded (zeros in shared memory): to a multiple of
                     # 32 in float32, of 16 in bfloat16
    heads: int       # q heads a block scores: 1, 2, 4 or 8
    groups: int      # blocks along the q heads of a kv head
    tile: int        # keys of a warp's tile, whole score blocks
    stages: int      # tiles in each warp's cp.async ring (STAGES)
    split: int       # keys of a split (a block's share of a row's cache)
    splits: int      # blocks along T; 1: no partials, no combine
    warps: int       # warps a block (4 or 8), 32 threads each
    smem: int        # bytes of shared memory a block
    blocks: int
    regs: int        # registers a thread keeps in arrays: q, accumulator,
                     # (partial) scores

    @property
    def threads(self) -> int:
        return 32 * self.warps

    def __str__(self):
        return (f"{self.blocks}x{self.threads} hdp{self.hdp} "
                f"heads{self.heads}x{self.groups} split{self.split}"
                f"x{self.splits} tile{self.tile} stages{self.stages} "
                f"{self.smem} B")


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def key_groups(hdp: int) -> int:
    """float32: keys a warp scores side by side; lane groups of
    32 / key_groups lanes split a key's hdp dims, at most 8 dims a lane."""
    dpl = hdp // 32
    return 8 if dpl == 1 else 4 if dpl == 2 else 2 if dpl <= 4 else 1


def score_keys(hdp: int, heads: int, item: int) -> int:
    """Keys of a score block: in float32 each lane group scores 8 / heads
    keys (at most 4 KB of K in the block) before its partial scores are
    reduced; in bfloat16 an mma takes 16 keys."""
    if item == 2:
        return 16
    kq = key_groups(hdp)
    return kq * min(8 // heads, _pow2_floor(4096 // (kq * hdp * item)))


def pad_width(hd: int, item: int) -> int:
    """hdp: hd rounded up to 32 (float32) or 16 (bfloat16, an mma's K)."""
    unit = 16 if item == 2 else 32
    return -(-hd // unit) * unit


def smem_bytes(hdp: int, item: int, heads: int, tile: int,
               warps: int) -> int:
    """Shared memory of a block, as the kernel lays it out: each warp's ring
    of K and V tiles of ``tile`` rows (float32 rows of hdp floats, with the
    warp's scores and rescales beside the ring; bfloat16 rows of hdp + 8,
    16 bytes of padding for ldmatrix); reused after the loop by the merge
    of the warps and by the combine (a weight a split and head, a float4 a
    thread)."""
    if item == 2:
        ring = warps * STAGES * 2 * tile * (hdp + 8) * 2
    else:
        ring = warps * (STAGES * 2 * tile * hdp * 4
                        + -(-tile * heads * 4 // 16) * 16 + 32)
    merge = 4 * (warps * heads * (hdp + 3) + 2 * heads)
    combine = 4 * (heads * MAX_SPLITS + 8) + 16 * 32 * warps
    return max(ring, merge, combine)


def check_width(hd: int) -> None:
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"hd={hd}: the kernel takes a multiple of 8 from 8 "
                         f"to {MAX_HEAD_DIM}")


def make_plan(B: int, H: int, KV: int, T: int, hd: int, dtype, *,
              heads: int, tile: int, split: int,
              warps: int = 4) -> DecodePlan:
    """The plan of a given geometry (the rest follows from the shape)."""
    check_width(hd)
    if dtype not in DTYPES:
        raise TypeError(f"no kernel for {dtype}")
    item = 2 if dtype == torch.bfloat16 else 4
    hdp = pad_width(hd, item)
    G = H // KV
    groups = -(-G // heads)
    sk = score_keys(hdp, heads, item)
    splits = -(-T // max(split, 1)) if T > 0 else 1
    if heads not in (1, 2, 4, MAX_HEADS) or (item == 2 and heads != 8) or \
            tile < sk or tile % sk or split < 1 or splits > MAX_SPLITS or \
            warps not in WARPS:
        raise ValueError(f"heads={heads}, tile={tile}, split={split}, "
                         f"warps={warps}: no such plan (heads 1, 2, 4 or 8, "
                         f"8 in bfloat16; a tile of whole {sk}-key score "
                         f"blocks; at most {MAX_SPLITS} splits; 4 or 8 "
                         f"warps)")
    smem = smem_bytes(hdp, item, heads, tile, warps)
    if smem > MAX_SMEM:
        raise ValueError(f"tile={tile}, warps={warps}: {smem} bytes of "
                         f"shared memory, past the card's {MAX_SMEM}")
    if item == 2:     # q's B fragments, O^T's accumulators, S
        regs = hdp // 16 * 6 + 4
    else:             # q, the accumulator, the partial scores
        kq = key_groups(hdp)
        regs = heads * (hdp // 32) * (kq + 1) + heads * (sk // kq)
    return DecodePlan(hdp=hdp, heads=heads, groups=groups, tile=tile,
                      stages=STAGES, split=split, splits=splits, warps=warps,
                      smem=smem, blocks=B * KV * groups * splits,
                      regs=regs)


def decode_plan(B: int, H: int, KV: int, T: int, hd: int, dtype,
                n_sms: int) -> DecodePlan:
    """The launch plan of a (B, H, KV, T, hd) decode on a card of ``n_sms``
    SMs.

    A block scores the q heads of one kv head together, up to
    ``MAX_HEADS`` (in float32 a power of two at least G = H / KV, in
    bfloat16 always 8; larger G is taken in groups of 8), so each K and V
    element leaves device memory once per group and shared memory once
    per block.  It has 8 warps where their rings fit, else 4, so that
    each warp takes few of a split's tiles in turn.  A warp's tile holds
    ``TILE_KEYS`` keys or a whole score block, fewer score blocks where
    the ring would not fit.  The split length follows the shape: as many
    splits as bring the grid to ``BLOCKS_PER_SM`` blocks an SM or cut a
    row into ``SPLIT_KEYS`` keys, whichever is more, none shorter than
    ``MIN_ROUNDS`` rounds of the block's warps, at most ``MAX_SPLITS``;
    whole rounds, so only a row's last split is ragged.  Splits that
    start at or past a row's length do nothing; at one split there are no
    partials."""
    check_width(hd)
    if dtype not in DTYPES:
        raise TypeError(f"no kernel for {dtype}")
    item = 2 if dtype == torch.bfloat16 else 4
    hdp = pad_width(hd, item)
    G = H // KV
    heads = MAX_HEADS if item == 2 else \
        min(MAX_HEADS, 1 << (G - 1).bit_length())
    sk = score_keys(hdp, heads, item)
    units = B * KV * -(-G // heads)
    warps, tile = next(
        (w, t) for w in WARPS[::-1] for t in range(max(sk, TILE_KEYS), 0, -sk)
        if smem_bytes(hdp, item, heads, t, w) <= MAX_SMEM)
    rounds = warps * tile
    splits = min(max(-(-BLOCKS_PER_SM * n_sms // units), T // SPLIT_KEYS),
                 MAX_SPLITS, max(1, T // (MIN_ROUNDS * rounds)))
    split = -(-max(T, 1) // (splits * rounds)) * rounds
    return make_plan(B, H, KV, T, hd, dtype, heads=heads, tile=tile,
                     split=split, warps=warps)


def block_work(plan: DecodePlan, B: int, H: int, KV: int, T: int, length):
    """What each block of ``plan`` takes, as the kernel decodes
    ``blockIdx.x``: (b, first q head, q heads, key start, key end) of the
    blocks that score keys, as (n,) int64 tensors.  A block whose split
    starts at or past the row's length does nothing (split 0 of a row of
    length 0 writes its zeros)."""
    idx = torch.arange(plan.blocks, dtype=torch.int64)
    s = idx % plan.splits
    u = idx // plan.splits
    grp = u % plan.groups
    u = u // plan.groups
    kvh, b = u % KV, u // KV
    G = H // KV
    n = length.to(torch.int64).clamp(0, T)[b]
    start = s * plan.split
    end = torch.minimum(start + plan.split, n)
    keep = start < end
    heads = (G - grp * plan.heads).clamp(max=plan.heads)
    return (b[keep], (kvh * G + grp * plan.heads)[keep], heads[keep],
            start[keep], end[keep])


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k_cache, v_cache, length):
    """One-token attention over a cache (see the module docstring)."""
    global LAUNCHES
    check_heads(q, k_cache, v_cache, 3)
    B, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    if not isinstance(length, torch.Tensor) or length.shape != (B,) or \
            length.dtype.is_floating_point or length.dtype == torch.bool:
        raise TypeError(f"length must be a ({B},) integer tensor")
    if length.device != q.device:
        raise ValueError(f"length is on {length.device}, q on {q.device}")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, length)
    from repro_torch.kernels import build

    build.refuse_grad("decode_attention", q, k_cache, v_cache)
    check_width(hd)
    if T > MAX_KEYS:
        raise ValueError(f"T={T}: the key a warp loads (up to T - 1 + "
                         f"STAGES rounds of tiles) is an int in the kernel; "
                         f"T must be at most {MAX_KEYS}")
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if max(B, H, T) > INT_MAX:
        raise ValueError(f"B={B}, H={H}, T={T}: each must fit the "
                         f"launcher's int")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = decode_plan(B, H, KV, T, hd, q.dtype, _sm_count(index))
    if plan.blocks > INT_MAX:
        raise ValueError(f"{plan.blocks} blocks exceed the launcher's int")
    if length.dtype != torch.int32:
        length = length.clamp(-1, T).to(torch.int32)
    launch(_aligned(q), _aligned(k_cache), _aligned(v_cache),
           length.contiguous(), out, plan)
    LAUNCHES += 1
    return out


def _counters(device, stream: int, n: int):
    """At least ``n`` zeroed ticket counters for launches on ``stream``."""
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
        _KEPT.append(c)
    return c


def launch(q, k_cache, v_cache, length, out, plan: DecodePlan,
           passes: int = 2) -> None:
    """Run ``plan`` on contiguous CUDA tensors (16-byte aligned; length
    int32) into ``out``, on the current stream: the workspace and the
    stream's ticket counters where the plan has more than one split.  With
    ``passes=1`` the blocks write their partials and nobody combines them
    (the output is then left unwritten where a row has several splits),
    to time the partial pass alone.  Counts nothing (``decode_attention``
    does)."""
    from repro_torch.kernels import build

    if passes not in (1, 2):
        raise ValueError(f"passes={passes}: 1 (partials) or 2 (with the "
                         f"combine)")
    B, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    device, stream = build.device_and_stream(q)
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(B * H * plan.splits * (hd + 2), dtype=torch.float32,
                         device=q.device)
        if passes == 2:
            counters = _counters(q.device, stream, B * KV * plan.groups)
    fn = build.launcher("decode_attention", "decode_attention",
                        (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 14
                        + (ctypes.c_void_p,))
    build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   length.data_ptr(), out.data_ptr(),
                   None if ws is None else ws.data_ptr(),
                   None if counters is None else counters.data_ptr(),
                   B, H, KV, T, hd, int(q.dtype == torch.bfloat16),
                   plan.heads, plan.tile, plan.split, plan.splits,
                   plan.warps, plan.smem, int(passes == 2),
                   device, stream), "decode_attention")
