"""Prefill attention: the wrapper of the CUDA kernel
``csrc/flash_attention.cu``, the counterpart of
``repro.kernels.flash_attention``.

q (B, H, S, hd); k, v (B, KV, T, hd), H a multiple of KV, q head h reading
kv head h // (H / KV); float32 or bfloat16, all three alike.  Softmax in
float32 with scale hd**-0.5, and p kept in float32 for the PV product;
``causal`` lets query position i see key positions j <= i (both counted
from 0, so S may differ from T).  Returns (B, H, S, hd) in q's dtype.

Dispatch is by the tensors' device: on the CPU the plain version
``ref.flash_attention_ref`` runs; on a CUDA tensor the kernel launches
(any hd that is a multiple of 8 up to ``MAX_HEAD_DIM``) or the wrapper
raises.  ``flash_plan`` chooses the kernel's tiles from hd and the dtype;
the kernel is built for exactly that plan.  ``LAUNCHES`` counts the
kernel's launches.

The gradient: ``flash_attention_bwd`` runs ``csrc/flash_attention_bwd.cu``
(the plain version ``ref.flash_attention_bwd_ref`` on the CPU), which
returns (dq, dk, dv) from q, k, v, the forward's output, its logsumexp
and its gradient; ``flash_bwd_plan`` chooses its tiles, and
``BWD_LAUNCHES`` counts its launches (one a call, its passes together).
Where grad mode is on and an input requires grad, ``flash_attention``
runs through ``FlashAttention``, a
``torch.autograd.Function`` whose forward is the same launch (bit for bit
the ``no_grad`` output) that also writes each row's logsumexp, and whose
backward is ``flash_attention_bwd`` given that logsumexp.  The logsumexp
is the natural log of each row's sum of exp(scaled score) over the keys
it sees, float32 (B, H, S), in the kernel, the plain version
(``ref.flash_attention_lse_ref``) and the wrapper alike.  The Pallas
kernel has no backward: the reference trains through XLA's autodiff of
jnp attention.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import ref

#: the widest head the kernel takes (wgmma's largest N)
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)
#: an H100 block's shared memory at most, 227 KB
MAX_SMEM = 232448
#: float32 takes a third stage only within this, so two blocks fit an SM
SMEM_PAIR = 116 * 1024
#: the longest S and T the kernel takes: it forms a block's row bound
#: (q0 + rows) and its last key tile's bound (kend + keys x splits - 1) in
#: int, each at most 127 past S or T
MAX_LEN = 2 ** 31 - 128

#: kernel launches since the last reset
LAUNCHES = 0
#: backward launches since the last reset (``flash_attention_bwd``)
BWD_LAUNCHES = 0
#: the backward's keys a block of its dk / dv pass and rows a block of its
#: dq pass, 64 each: one warpgroup (four warps) of wgmma or mma.sync
BWD_KEYS = BWD_ROWS = 64


class FlashPlan(NamedTuple):
    """One launch geometry of ``csrc/flash_attention.cu``."""
    hdp: int         # hd padded to a multiple of 16 (zeros in shared memory)
    rows: int        # query rows a block, 64 a warpgroup
    keys: int        # keys a tile
    splits: int      # warp sets that share the rows and split the keys: a
                     # stage holds `splits` tiles, one a set
    stages: int      # K / V stages in the cp.async ring
    smem: int        # bytes of shared memory a block
    acc_regs: int    # accumulator registers a thread: O and S, in bfloat16
                     # also P's two pieces for two tiles

    def __str__(self):
        return (f"rows{self.rows} keys{self.keys}"
                + (f"x{self.splits}" if self.splits > 1 else "")
                + f" stages{self.stages} hdp{self.hdp} {self.smem} B")


def smem_bytes(hdp: int, bf16: bool, rows: int, keys: int, splits: int,
               stages: int) -> int:
    """Shared memory of a block, as the kernel lays it out: Q's rows and
    ``stages`` stages of ``splits`` K and V tiles; bfloat16 rows of hdp,
    float32 rows padded to hdp + 4 floats."""
    item, row = (2, hdp) if bf16 else (4, hdp + 4)
    return item * row * (rows + 2 * stages * splits * keys)


def flash_plan(hd: int, dtype) -> FlashPlan:
    """The kernel's tiles for head width ``hd`` and ``dtype``.  Up to
    hdp = 128, 64-key tiles and 128 query rows a block (two warpgroups in
    bfloat16, eight warps in float32), except in float32 up to hdp = 64:
    64 rows a block and two sets of four warps that split the keys, tile
    by tile, merged at the end, so the benchmark's causal shape (8 heads x
    1,024 rows) fills the card with twice the blocks and each block's
    longest row takes half the steps.  Past hdp = 128, 64 rows and 32
    keys, which keep the O accumulator (hdp / 2 registers a thread) and
    the score tile within the registers at hd 256.  bfloat16 takes three
    stages (the tile scored, the tile whose P V runs, the tile loading),
    float32 three where a block still fits twice an SM, else two."""
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"hd={hd}: the kernel takes a multiple of 8 from 8 "
                         f"to {MAX_HEAD_DIM}")
    if dtype not in DTYPES:
        raise TypeError(f"no kernel for {dtype}")
    bf16 = dtype == torch.bfloat16
    hdp = -(-hd // 16) * 16
    rows = 64 if hdp > 128 or (not bf16 and hdp <= 64) else 128
    keys = 64 if hdp <= 128 else 32
    splits = 2 if not bf16 and hdp <= 64 else 1
    stages = 3 if bf16 or smem_bytes(hdp, bf16, rows, keys, splits, 3) \
        <= SMEM_PAIR else 2
    return FlashPlan(hdp, rows, keys, splits, stages,
                     smem_bytes(hdp, bf16, rows, keys, splits, stages),
                     hdp // 2 + keys // 2 + (keys if bf16 else 0))


def check_heads(q, k, v, q_ndim: int) -> None:
    """The checks shared with ``decode_attention``: tensors of one dtype
    (float32 or bfloat16) on one device, contiguous, ``k`` and ``v`` of
    one shape (B, KV, T, hd), q's batch and width matching, H a multiple
    of KV."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}; q, k and v must share "
                            f"one dtype of {DTYPES}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.ndim != q_ndim or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not q {q_ndim}-d and k, v "
                         f"(B, KV, T, hd)")
    B, H, hd = q.shape[0], q.shape[1], q.shape[-1]
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head width")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes
    (a view at an offset), since the kernel stages 16-byte chunks."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_lengths(S: int, T: int) -> None:
    if max(S, T) > MAX_LEN:
        raise ValueError(f"S={S}, T={T}: the kernel's row and key bounds "
                         f"are int; each must be at most {MAX_LEN}")


def _forward(q, k, v, causal: bool, with_lse: bool = False):
    """The forward's dispatch: the plain version on the CPU, else one
    launch of the kernel (or a raise).  With ``with_lse``, returns (out,
    lse), the launch writing lse too (the plain version's on the CPU)."""
    global LAUNCHES
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q, k, v, causal=causal)
        if with_lse:
            return out, ref.flash_attention_lse_ref(q, k, causal=causal)
        return out
    from repro_torch.kernels import build

    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    plan = flash_plan(hd, q.dtype)
    _check_lengths(S, T)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    fn = build.launcher("flash_attention", "flash_attention",
                        (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 13
                        + (ctypes.c_void_p,))
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr() if with_lse else None,
                   B, H, KV, S, T, hd, int(q.dtype == torch.bfloat16),
                   int(causal), plan.rows, plan.keys, plan.splits,
                   plan.stages,
                   *build.device_and_stream(q)), "flash_attention")
    LAUNCHES += 1
    return (out, lse) if with_lse else out


class FlashAttention(torch.autograd.Function):
    """Prefill attention with a gradient: the forward's launch writing the
    logsumexp too, saving q, k, v, the output and the logsumexp, and
    ``flash_attention_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """Prefill attention (see the module docstring); through
    ``FlashAttention`` where grad mode is on and an input requires grad."""
    check_heads(q, k, v, 4)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


def flash_attention_lse(q, k, v, *, causal: bool = True):
    """(out, lse): the forward as ``FlashAttention`` runs it under grad,
    one launch that also writes each row's logsumexp (float32 (B, H, S),
    natural log), outside autograd; ``out`` is ``flash_attention``'s bits.
    On the CPU the plain versions."""
    check_heads(q, k, v, 4)
    return _forward(q, k, v, causal, with_lse=True)


class BwdPlan(NamedTuple):
    """The launch geometry of ``csrc/flash_attention_bwd.cu``."""
    hdp: int         # the template's width: hd up to 32, 64, 128 or 256
    rows: int        # query rows a tile of the dk / dv pass
    keys: int        # keys a block of the dk / dv pass (BWD_KEYS)
    q_rows: int      # rows a block of the dq pass (BWD_ROWS)
    q_keys: int      # keys a tile of the dq pass
    cols: int        # warpgroups of a dk / dv block, splitting dk's and
                     # dv's columns
    stages: int      # buffers of each pass's cp.async ring
    threads: int     # a dk / dv block's; a dq block has 128
    smem: int        # bytes of shared memory a dk / dv block
    q_smem: int      # bytes of shared memory a dq block

    def __str__(self):
        return (f"rows{self.rows} keys{self.keys}"
                + (f"x{self.cols}" if self.cols > 1 else "")
                + f" dq rows{self.q_rows} keys{self.q_keys}"
                f" stages{self.stages} hdp{self.hdp}"
                f" {self.smem}/{self.q_smem} B")


def bwd_smem_bytes(hdp: int, bf16: bool, rows: int, q_keys: int,
                   stages: int) -> tuple[int, int]:
    """Shared memory of a (dk / dv, dq) block, as the kernel lays it out:
    K and V of the block's keys and ``stages`` tiles of ``rows`` rows of Q
    and dO with their lse and D floats; Q and dO of the block's rows and
    ``stages`` tiles of ``q_keys`` keys of K and V.  bfloat16 rows of hdp,
    float32 rows padded to hdp + 4 floats."""
    item, row = (2, hdp) if bf16 else (4, hdp + 4)
    return (item * row * (2 * BWD_KEYS + 2 * stages * rows)
            + 4 * 2 * stages * rows,
            item * row * (2 * BWD_ROWS + 2 * stages * q_keys))


def flash_bwd_plan(hd: int, dtype) -> BwdPlan:
    """The backward kernel's plan for head width ``hd`` and ``dtype``: the
    widths the forward takes (a multiple of 8 from 8 to 256), in the
    template of hdp = 32, 64, 128 or 256.  64 keys a dk / dv block and 64
    rows a dq block, a warpgroup each; the tiles that stream past them,
    query rows (dk / dv) and keys (dq), 64 up to hdp = 64, then narrower
    as the accumulators (hdp / 2 registers a thread each) and the float32
    rows (hdp + 4 floats) grow: 32 query rows and 64 keys (bfloat16) or
    32 and 32 (float32) at hdp = 128, 32 and 32 (bfloat16) or 16 and 16
    (float32) at hdp = 256, where two warpgroups share a dk / dv block's
    keys, each with half of dk's and dv's columns.  Three stages where
    both passes' blocks fit twice an SM (``SMEM_PAIR``), else two."""
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"hd={hd}: the kernel takes a multiple of 8 from 8 "
                         f"to {MAX_HEAD_DIM}")
    if dtype not in DTYPES:
        raise TypeError(f"no kernel for {dtype}")
    bf16 = dtype == torch.bfloat16
    hdp = next(w for w in (32, 64, 128, 256) if hd <= w)
    rows = 64 if hdp <= 64 else 32 if bf16 or hdp <= 128 else 16
    q_keys = 64 if hdp <= 64 or (bf16 and hdp <= 128) else \
        32 if bf16 or hdp <= 128 else 16
    cols = 2 if hdp > 128 else 1
    stages = 3 if max(bwd_smem_bytes(hdp, bf16, rows, q_keys, 3)) \
        <= SMEM_PAIR else 2
    smem, q_smem = bwd_smem_bytes(hdp, bf16, rows, q_keys, stages)
    return BwdPlan(hdp, rows, BWD_KEYS, BWD_ROWS, q_keys, cols, stages,
                   128 * cols, smem, q_smem)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=causal)`` = ``o``
    against its output gradient ``do`` ((B, H, S, hd) like q and o), each
    in the inputs' dtype; dk and dv sum over the query heads of each kv
    head.  ``lse`` is the forward's logsumexp (float32 (B, H, S), natural
    log: ``FlashAttention`` saves it, ``ref.flash_attention_lse_ref`` is
    its plain version); nothing here computes it.  On the CPU the plain
    version; on a CUDA tensor one launch of the backward kernel (its
    passes: D, dk / dv, where H > KV the heads' partials summed, dq), or
    the wrapper raises.  With S = 0 or T = 0 the gradients are zeros and
    nothing launches."""
    global BWD_LAUNCHES
    check_heads(q, k, v, 4)
    for name, t in (("o", o), ("do", do)):
        if not isinstance(t, torch.Tensor) or t.shape != q.shape or \
                t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be a tensor of q's shape, dtype "
                             f"and device {tuple(q.shape)} {q.dtype} "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not isinstance(lse, torch.Tensor) or lse.shape != q.shape[:3] or \
            lse.dtype != torch.float32 or lse.device != q.device or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 tensor "
                         f"{tuple(q.shape[:3])} on {q.device}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal)
    from repro_torch.kernels import build

    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    plan = flash_bwd_plan(hd, q.dtype)
    _check_lengths(S, T)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    # the heads' float32 partials of dk and dv, summed by the kernel's
    # third pass, where a kv head has more than one query head
    ws = [torch.empty((B, H, T, hd), dtype=torch.float32, device=q.device)
          if H > KV else None for _ in range(2)]
    q, k, v, o, lse, do = (_aligned(t) for t in (q, k, v, o, lse, do))
    fn = build.launcher("flash_attention_bwd", "flash_attention_bwd",
                        (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 13
                        + (ctypes.c_void_p,))
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                   *(w.data_ptr() if w is not None else None for w in ws),
                   B, H, KV, S, T, hd, int(q.dtype == torch.bfloat16),
                   int(causal), plan.rows, plan.keys, plan.q_keys,
                   plan.stages, *build.device_and_stream(q)),
                "flash_attention_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv
