"""Static checks over the port's CUDA launchers, the counterpart of
``repro.analysis.kernel_audit``.

The reference intercepts ``pl.pallas_call`` and proves every BlockSpec
index map in bounds.  The port has no ``pallas_call`` to intercept: each
kernel is a hand-written CUDA launcher whose grid comes from a Python
planner.  So the launch table (``LAUNCH_TABLE``) names, for each launcher
and second pass, the Pallas kernel it stands for, its source, its
``extern "C"`` symbol, its exported plan query and its planner, and the
geometry is derived from the planners.  Four parts:

1. **The geometry proof** (``check_launch``, the counterpart of
   ``check_record``).  For one (kernel, shape, dtype, SM count) the
   planner's plan is turned into every launch the wrapper makes (the
   first pass and its second passes), block by block as the kernel decodes
   ``blockIdx``, as vectors of ``[start, stop)`` element offsets: interval
   arithmetic per block, never per element.  It proves the grid, block and
   shared-memory limits (dynamic shared memory equal to the kernel's own
   layout, transcribed here from the sources), every read and write range
   of every operand and workspace inside its extent, every offset the CUDA
   code forms in ``int`` within ``INT_MAX``, and that the blocks' outputs
   cover every output element exactly once (``_cover``: a difference array
   over the grid the boxes' edges cut).  One finding per (launch,
   property).
2. **The sweep** (``sweep``, the counterpart of ``_bounds_findings``): the
   reference's ragged shapes, shapes one below, at and one past each
   planner's tile, every head width the attention kernels take, the
   zero-length cases, and every config of ``repro_torch.configs`` at full
   width, each at ``SM_COUNTS`` (the plan depends on the card's SMs).
3. **The guard mirror** (``launcher_accepts``): each launcher's guard,
   transcribed from its source (``split::plan_ok`` and ``accepts`` in the
   re-id sources, ``plan_ok`` in the others).  Every plan the planners emit
   must pass it, and each single-field perturbation (``perturbations``)
   must fail it.  On the card, ``compiled_accepts`` asks the sources'
   exported ``<symbol>_plan_ok`` the same questions (``chip_smoke.py``
   phase 23).
4. **The sentinel probes** (``sentinel_probes``, the counterpart of
   ``_sentinel_findings``), one for one through ``repro_torch.kernels.ops``:
   the plain versions on the CPU, the kernels on a card.

``guard_band_run`` launches a kernel through ``build.launcher`` on views
inside larger buffers whose 4 KB guard bands hold a NaN bit pattern, for
``chip_smoke.py`` phase 23 and ``scripts/torch_kernel_memcheck.py``.

The port captures no CUDA graph, so there is no counterpart of the
reference's ``RecompileGuard`` (no graph to recapture).  Findings are
``repro_torch.analysis.lint.Violation`` with rule ``KERNEL`` and path
``<cuda:name>``.  Nothing here imports ``jax`` or ``repro``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.analysis.lint import Violation
from repro_torch.kernels import (decode_attention, flash_attention,
                                 mamba_scan, ops, ref, reid_topk)

__all__ = ["LAUNCH_TABLE", "SM_COUNTS", "audit_kernels", "check_launch",
           "compiled_accepts", "guard_band_cases", "guard_band_run",
           "launcher_accepts", "perturbations", "plan_args", "routed",
           "sentinel_probes", "sweep"]

RULE = "KERNEL"
INT_MAX = 2 ** 31 - 1
#: gridDim.x, and gridDim.y and z, at most
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535
MAX_THREADS = 1024
#: an H100 block's shared memory at most, static and dynamic together
MAX_SMEM = 232448
#: the SM counts every shape is planned for: one SM, a small card, the
#: H100 PCIe, the H100 SXM
SM_COUNTS = (1, 16, 114, 132)
#: blocks enumerated per launch at most (the reference's budget)
_MAX_GRID_POINTS = 200_000
#: a pointer the launcher may take: non-null and 16-byte aligned; the
#: guards read pointers only for being null and aligned
ADDR = 1 << 12


@dataclasses.dataclass(frozen=True)
class Entry:
    """One row of the launch table."""
    replaces: tuple[str, ...]   # the Pallas kernel(s) it stands for
    source: str                 # under src/repro_torch/kernels/
    symbol: str | None          # its extern "C" launcher; None: launched by
    guard: str | None           # the exported plan query
    planner: str
    pointers: tuple[str, ...] = ()   # the launcher's pointer arguments
    ints: tuple[str, ...] = ()       # its int arguments, before the device


_REID_PTRS = ("q", "q_tag", "admit", "g", "gal_cam", "gal_tag", "out_v",
              "out_i", "ws_v", "ws_i")
_REID_PLAN = "reid_topk.split_plan, slices, round_k"
LAUNCH_TABLE = {
    "reid_topk_segment_masked": Entry(
        ("_reid_masked_kernel",), "csrc/reid_topk.cu",
        "reid_topk_segment_masked", "reid_topk_segment_masked_plan_ok",
        _REID_PLAN, _REID_PTRS, ("Q", "G", "D", "C", "k", "S")),
    "reid_topk_tiles": Entry(
        ("_reid_tiles_kernel",), "csrc/reid_topk_tiles.cu",
        "reid_topk_tiles", "reid_topk_tiles_plan_ok", _REID_PLAN,
        _REID_PTRS, ("Q", "G", "D", "CT", "k", "S")),
    "reid_topk_unmasked": Entry(
        ("_reid_kernel",), "csrc/reid_topk_plain.cu", "reid_topk_unmasked",
        "reid_topk_unmasked_plan_ok", _REID_PLAN,
        ("q", "g", "out_v", "out_i", "ws_v", "ws_i"),
        ("Q", "G", "D", "k", "S")),
    "flash_attention": Entry(
        ("_flash_kernel",), "csrc/flash_attention.cu", "flash_attention",
        "flash_attention_plan_ok",
        "flash_attention.flash_plan",
        ("q", "k", "v", "o", "lse"),
        ("B", "H", "KV", "S", "T", "hd", "bf16", "causal", "rows", "bk",
         "splits", "stages")),
    "flash_attention_bwd": Entry(
        ("_flash_kernel",), "csrc/flash_attention_bwd.cu",
        "flash_attention_bwd", "flash_attention_bwd_plan_ok",
        "flash_attention.flash_bwd_plan",
        ("q", "k", "v", "o", "lse", "do", "dq", "dk", "dv", "delta", "ws_k",
         "ws_v"),
        ("B", "H", "KV", "S", "T", "hd", "bf16", "causal", "rows", "keys",
         "q_keys", "stages")),
    "decode_attention": Entry(
        ("_decode_kernel",), "csrc/decode_attention.cu", "decode_attention",
        "decode_attention_plan_ok",
        "decode_attention.decode_plan, make_plan, block_work",
        ("q", "k", "v", "length", "o", "ws", "counters"),
        ("B", "H", "KV", "T", "hd", "bf16", "heads", "tile", "split",
         "splits", "warps", "smem", "combine")),
    "mamba_scan": Entry(
        ("_scan_kernel",), "csrc/mamba_scan.cu", "mamba_scan",
        "mamba_scan_plan_ok",
        "mamba_scan.scan_plan, make_plan",
        ("u", "dt", "Bm", "Cm", "A", "y", "hL", "ws_h", "ws_p"),
        ("B", "L", "D", "N", "nl", "eg", "warps", "chunk", "segs",
         "seg_len")),
    # second passes: launched by the launchers above, no symbol of their own
    "merge_slices": Entry(
        ("_reid_masked_kernel", "_reid_tiles_kernel", "_reid_kernel"),
        "csrc/reid_split.cuh", None, None,
        "after a split re-id launch (S > 1): " + _REID_PLAN),
    "flash_bwd_dkdv": Entry(
        ("_flash_kernel",), "csrc/flash_attention_bwd.cu", None, None,
        "after flash_attention_bwd's D pass: "
        "flash_attention.flash_bwd_plan"),
    "flash_bwd_sum": Entry(
        ("_flash_kernel",), "csrc/flash_attention_bwd.cu", None, None,
        "after the dk / dv pass where H > KV: the heads' partials summed"),
    "flash_bwd_dq": Entry(
        ("_flash_kernel",), "csrc/flash_attention_bwd.cu", None, None,
        "after flash_attention_bwd's dk / dv pass: "
        "flash_attention.flash_bwd_plan"),
    "decode_combine": Entry(
        ("_decode_kernel",), "csrc/decode_attention.cu", None, None,
        "the last block of a (row, kv head, group) with more than one "
        "split: decode_attention.decode_plan"),
    "scan_carry": Entry(
        ("_scan_kernel",), "csrc/mamba_scan.cu", None, None,
        "between the two scan passes of a segmented plan: "
        "mamba_scan.scan_plan"),
}
#: the wrapper-level kernels of the sweep: a LAUNCH_TABLE key with a symbol
KERNELS = tuple(k for k, e in LAUNCH_TABLE.items() if e.symbol)


def _finding(kernel: str, msg: str) -> Violation:
    return Violation(RULE, f"<cuda:{kernel}>", 0, msg)


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# The kernels' own constants and layouts, transcribed from csrc/
# ---------------------------------------------------------------------------

# reid_split.cuh: the split kernels
_BQ = _BG = 64
_NT = 64
_MERGE_THREADS = 128
_MAX_K = 16
_MAX_CAMS = 4096                       # reid_topk.cu
_DEFAULT_SMEM = 48 * 1024
# struct Smem: union {op[2][2][BQ][36], score[BQ][72]} floats, lv and li
# [BQ][MAX_K], thr and qtag [BQ], gcam and gtag [2][BG]; TileSmem adds
# elig[2][BG] 64-bit masks; merge_slices keeps hk[8][MAX_K] 64-bit keys
_SMEM_STATIC = 4 * (max(2 * 2 * _BQ * 36, _BQ * 72) + 2 * _BQ * _MAX_K
                    + 2 * _BQ + 4 * _BG)
_TILE_SMEM_STATIC = _SMEM_STATIC + 8 * 2 * _BG
_MERGE_STATIC = 8 * (_MERGE_THREADS // 16) * _MAX_K


def _flash_rows(hdp, bf16):
    return 64 if hdp > 128 or (not bf16 and hdp <= 64) else 128


def _flash_bk(hdp):
    return 64 if hdp <= 128 else 32


def _flash_splits(hdp, bf16):
    return 2 if not bf16 and hdp <= 64 else 1


def _flash_smem(hdp, bf16, rows, bk, splits, stages):
    return (2 if bf16 else 4) * (hdp if bf16 else hdp + 4) * \
        (rows + 2 * stages * splits * bk)


def _flash_stages(hdp, bf16):
    return 3 if bf16 or _flash_smem(hdp, False, _flash_rows(hdp, False),
                                    _flash_bk(hdp), _flash_splits(hdp, False),
                                    3) <= 116 * 1024 else 2


# flash_attention_bwd.cu: 64 keys a dk / dv block, 64 rows a dq block; the
# template's width, the streamed tiles, the column warpgroups, the layouts
# (dkdv_smem, dq_smem) and the stages; bwd_delta's rows (warps) a block and
# bwd_sum's threads and grid at most
_BWD_KEYS = _BWD_QROWS = 64
_BWD_DELTA_ROWS, _BWD_SUM_THREADS, _BWD_SUM_BLOCKS = 8, 256, 132 * 8


def _bwd_hdp(hd):
    return 32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 else 256


def _bwd_rows(hdp, bf16):
    return 64 if hdp <= 64 else 32 if bf16 or hdp <= 128 else 16


def _bwd_qkeys(hdp, bf16):
    return 64 if hdp <= 64 or (bf16 and hdp <= 128) else \
        32 if bf16 or hdp <= 128 else 16


def _bwd_cols(hdp):
    return 2 if hdp > 128 else 1


def _bwd_smem(hdp, bf16, rows, qkeys, stages):
    item, row = (2, hdp) if bf16 else (4, hdp + 4)
    return (item * row * (2 * _BWD_KEYS + 2 * stages * rows)
            + 4 * 2 * stages * rows,
            item * row * (2 * _BWD_QROWS + 2 * stages * qkeys))


def _bwd_stages(hdp, bf16):
    return 3 if max(_bwd_smem(hdp, bf16, _bwd_rows(hdp, bf16),
                              _bwd_qkeys(hdp, bf16), 3)) <= 116 * 1024 else 2


# decode_attention.cu
_DEC_STAGES, _DEC_MAX_HEADS, _DEC_MAX_SPLITS = 3, 8, 256
_DEC_MAX_THREADS = 256


def _dec_key_groups(dpl):
    return 8 if dpl == 1 else 4 if dpl == 2 else 2 if dpl <= 4 else 1


def _dec_group_keys(dpl, heads):
    cap = 1
    while 2 * cap <= 4096 // (_dec_key_groups(dpl) * 32 * dpl * 4):
        cap *= 2
    return min(8 // heads, cap)


def _dec_smem(hdp, bf16, heads, tile, warps):
    ring = _DEC_STAGES * 2 * tile * (hdp + 8 if bf16 else hdp) * \
        (2 if bf16 else 4)
    if not bf16:
        ring += _cdiv(tile * heads * 4, 16) * 16 + 32
    merge = 4 * (warps * heads * (hdp + 3) + 2 * heads)
    combine = 4 * (heads * _DEC_MAX_SPLITS + 8) + 16 * 32 * warps
    return max(warps * ring, merge, combine)


# mamba_scan.cu
_SCAN_MAX_WARPS, _SCAN_GROUP = 8, 8


def _scan_smem(nl, eg, warps, chunk):
    return 4 * (5 * chunk * warps * (32 // nl) + 4 * chunk * nl * eg)


# ---------------------------------------------------------------------------
# The guard mirror
# ---------------------------------------------------------------------------

def _split_plan_ok(Q, G, S, ws_v, ws_i):
    """``split::plan_ok`` (reid_split.cuh)."""
    nq, ng = _cdiv(Q, _BQ), _cdiv(G, _BG)
    return 1 <= S <= ng and nq * S <= INT_MAX and \
        (S == 1 or (ws_v != 0 and ws_i != 0))


def launcher_accepts(kernel: str, args: dict) -> bool:
    """Whether the launcher of ``kernel`` (a ``KERNELS`` name) takes
    ``args``, its arguments by name (``LAUNCH_TABLE[kernel]``'s pointers
    as integer addresses, 0 for null, and ints): the Python mirror of the
    guard the launcher runs before it launches anything."""
    a = args
    if kernel in ("reid_topk_segment_masked", "reid_topk_tiles",
                  "reid_topk_unmasked"):
        width = {"reid_topk_segment_masked": "C",
                 "reid_topk_tiles": "CT"}.get(kernel)
        ok = a["Q"] >= 1 and a["G"] >= 1 and a["D"] >= 1 and \
            1 <= a["k"] <= _MAX_K
        if width:
            ok = ok and a[width] >= 1
        if kernel == "reid_topk_segment_masked":
            ok = ok and a["C"] <= _MAX_CAMS
        return ok and _split_plan_ok(a["Q"], a["G"], a["S"], a["ws_v"],
                                     a["ws_i"])
    if kernel == "flash_attention":
        hd, bf16 = a["hd"], a["bf16"] != 0
        hdp = _cdiv(hd, 16) * 16
        return (a["B"] >= 1 and a["H"] >= 1 and a["KV"] >= 1
                and a["H"] % a["KV"] == 0 and a["S"] >= 1 and a["T"] >= 0
                and max(a["S"], a["T"]) <= INT_MAX - 127
                and 8 <= hd <= 256 and hd % 8 == 0 and a["H"] <= GRID_YZ_MAX
                and a["B"] <= GRID_YZ_MAX
                and a["rows"] == _flash_rows(hdp, bf16)
                and a["bk"] == _flash_bk(hdp)
                and a["splits"] == _flash_splits(hdp, bf16)
                and a["stages"] == _flash_stages(hdp, bf16)
                and (a["q"] | a["k"] | a["v"] | a["o"] | a["lse"]) & 15 == 0)
    if kernel == "flash_attention_bwd":
        hd, bf16 = a["hd"], a["bf16"] != 0
        need = ("q", "k", "v", "o", "lse", "do", "dq", "dk", "dv", "delta")
        if not all(a[p] != 0 and a[p] & 15 == 0 for p in need) or any(
                a[p] & 15 or (a[p] == 0 and a["H"] != a["KV"])
                for p in ("ws_k", "ws_v")):
            return False
        if not (a["B"] >= 1 and a["H"] >= 1 and a["KV"] >= 1
                and a["H"] % a["KV"] == 0 and a["S"] >= 1 and a["T"] >= 1
                and max(a["S"], a["T"]) <= INT_MAX - 127
                and 8 <= hd <= 256 and hd % 8 == 0 and a["H"] <= GRID_YZ_MAX
                and a["B"] <= GRID_YZ_MAX):
            return False
        hdp = _bwd_hdp(hd)
        return (_cdiv(a["B"] * a["H"] * a["S"], _BWD_DELTA_ROWS) <= INT_MAX
                and a["rows"] == _bwd_rows(hdp, bf16)
                and a["keys"] == _BWD_KEYS
                and a["q_keys"] == _bwd_qkeys(hdp, bf16)
                and a["stages"] == _bwd_stages(hdp, bf16))
    if kernel == "decode_attention":
        B, H, KV, T, hd = a["B"], a["H"], a["KV"], a["T"], a["hd"]
        bf16, heads, tile = a["bf16"] != 0, a["heads"], a["tile"]
        split, splits, warps = a["split"], a["splits"], a["warps"]
        if (B < 1 or H < 1 or KV < 1 or H % KV or T < 0 or hd < 8
                or hd > 256 or warps not in (4, 8) or hd % 8
                or heads not in (1, 2, 4, 8) or (bf16 and heads != 8)
                or split < 1 or splits < 1 or splits > _DEC_MAX_SPLITS):
            return False
        hdp = _cdiv(hd, 16) * 16 if bf16 else _cdiv(hd, 32) * 32
        sk = 16 if bf16 else \
            _dec_key_groups(hdp // 32) * _dec_group_keys(hdp // 32, heads)
        if tile < sk or tile % sk:
            return False
        if splits != (_cdiv(T, split) if T > 0 else 1):
            return False
        if a["smem"] != _dec_smem(hdp, bf16, heads, tile, warps) or \
                a["smem"] > MAX_SMEM:
            return False
        if B * KV * _cdiv(H // KV, heads) * splits > INT_MAX or \
                T - 1 + _DEC_STAGES * warps * tile > INT_MAX:
            return False
        return splits == 1 or (a["ws"] != 0 and (not a["combine"]
                                                 or a["counters"] != 0))
    if kernel == "mamba_scan":
        B, L, D, N = a["B"], a["L"], a["D"], a["N"]
        nl, eg, warps, chunk = a["nl"], a["eg"], a["warps"], a["chunk"]
        segs, seg_len = a["segs"], a["seg_len"]

        def pow2(v):
            return v >= 1 and v & (v - 1) == 0

        if not (B >= 1 and L >= 1 and D >= 1 and N >= 0 and pow2(nl)
                and nl <= 32 and eg in (1, 4, 8) and pow2(warps)
                and warps <= _SCAN_MAX_WARPS and chunk >= _SCAN_GROUP
                and chunk % _SCAN_GROUP == 0 and segs >= 1 and seg_len >= 1
                and seg_len % chunk == 0 and segs * seg_len >= L
                and (segs - 1) * seg_len < L
                and (a["ws_h"] != 0 or (segs == 1 and N <= nl * eg))
                and (a["ws_p"] != 0 or segs == 1)):
            return False
        DB = warps * (32 // nl)
        return B * segs * _cdiv(D, DB) <= INT_MAX and \
            _scan_smem(nl, eg, warps, chunk) <= MAX_SMEM
    raise KeyError(kernel)


def compiled_accepts(kernel: str, args: dict) -> bool:
    """The compiled guard's answer on ``args``: the source's exported
    ``<symbol>_plan_ok``, which runs the launcher's own guard and launches
    nothing (needs ``nvcc`` to build the source; no card)."""
    from repro_torch.kernels import build

    e = LAUNCH_TABLE[kernel]
    fn = build.launcher(e.source[len("csrc/"):-len(".cu")], e.guard,
                        (ctypes.c_void_p,) * len(e.pointers)
                        + (ctypes.c_int,) * len(e.ints))
    return bool(fn(*(a or None for a in (args[p] for p in e.pointers)),
                   *(args[i] for i in e.ints)))


# ---------------------------------------------------------------------------
# Cases and the planners' arguments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Case:
    """One wrapper call of the sweep: ``kernel`` a ``KERNELS`` name,
    ``shape`` its sizes (re-id: Q, G, D, k and C or CT; flash: B, H, KV,
    S, T, hd, causal; decode: B, H, KV, T, hd and ``length``, a tuple of
    B; scan: B, L, D, N, final_state), ``dtype`` float32 or bfloat16."""
    kernel: str
    shape: tuple            # sorted (name, value) pairs, hashable
    dtype: str = "float32"
    label: str = ""

    @property
    def s(self) -> dict:
        return dict(self.shape)

    def __str__(self):
        s = {k: (f"<{len(v)} lengths>" if isinstance(v, tuple) and
                 len(v) > 8 else v) for k, v in self.shape}
        return (f"{self.kernel} {self.dtype} {s}"
                + (f" [{self.label}]" if self.label else ""))


def case(kernel: str, dtype: str = "float32", label: str = "", **shape):
    return Case(kernel, tuple(sorted(shape.items())), dtype, label)


def _torch_dtype(dtype: str):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def launches_at_all(c: Case) -> bool:
    """Whether the wrapper launches on ``c``: the zero-length calls are
    answered without a launch (re-id: Q or G zero; the others: an empty
    output)."""
    s = c.s
    if c.kernel.startswith("reid"):
        return s["Q"] > 0 and s["G"] > 0
    if c.kernel == "flash_attention":
        return s["B"] * s["H"] * s["S"] * s["hd"] > 0
    if c.kernel == "flash_attention_bwd":
        return s["B"] * s["H"] * s["S"] * s["T"] * s["hd"] > 0
    if c.kernel == "decode_attention":
        return s["B"] * s["H"] * s["hd"] > 0
    return s["B"] * s["L"] * s["D"] > 0


def plan_args(c: Case, n_sms: int) -> dict:
    """The launcher's arguments as the wrapper passes them on ``c`` for a
    card of ``n_sms`` SMs: the planner's plan, the workspace pointers the
    wrapper allocates (``ADDR``) or leaves null (0)."""
    s = c.s
    if c.kernel.startswith("reid"):
        nq, S = reid_topk.split_plan(s["Q"], s["G"], n_sms)
        ws = ADDR if S > 1 else 0
        a = dict(Q=s["Q"], G=s["G"], D=s["D"], k=s["k"], S=S)
        if c.kernel != "reid_topk_unmasked":
            a["C" if c.kernel == "reid_topk_segment_masked" else "CT"] = \
                s["C"]
        ptrs = {p: ADDR for p in LAUNCH_TABLE[c.kernel].pointers}
        ptrs.update(ws_v=ws, ws_i=ws)
        return dict(ptrs, **a)
    dtype = _torch_dtype(c.dtype)
    if c.kernel == "flash_attention":
        p = flash_attention.flash_plan(s["hd"], dtype)
        # the launch under grad, which writes the logsumexp too (the
        # no_grad launch passes lse null and writes o alone)
        return dict(q=ADDR, k=ADDR, v=ADDR, o=ADDR, lse=ADDR, B=s["B"],
                    H=s["H"],
                    KV=s["KV"], S=s["S"], T=s["T"], hd=s["hd"],
                    bf16=int(c.dtype == "bfloat16"),
                    causal=int(s["causal"]), rows=p.rows, bk=p.keys,
                    splits=p.splits, stages=p.stages, smem=p.smem)
    if c.kernel == "flash_attention_bwd":
        p = flash_attention.flash_bwd_plan(s["hd"], dtype)
        ptrs = {name: ADDR for name in LAUNCH_TABLE[c.kernel].pointers}
        ws = ADDR if s["H"] > s["KV"] else 0
        return dict(ptrs, ws_k=ws, ws_v=ws, B=s["B"], H=s["H"], KV=s["KV"],
                    S=s["S"], T=s["T"], hd=s["hd"],
                    bf16=int(c.dtype == "bfloat16"),
                    causal=int(s["causal"]), rows=p.rows, keys=p.keys,
                    q_keys=p.q_keys, stages=p.stages, hdp=p.hdp,
                    threads=p.threads, smem=p.smem, q_smem=p.q_smem,
                    plan=p)
    if c.kernel == "decode_attention":
        p = decode_attention.decode_plan(s["B"], s["H"], s["KV"], s["T"],
                                         s["hd"], dtype, n_sms)
        ws = ADDR if p.splits > 1 else 0
        return dict(q=ADDR, k=ADDR, v=ADDR, length=ADDR, o=ADDR, ws=ws,
                    counters=ws, B=s["B"], H=s["H"], KV=s["KV"], T=s["T"],
                    hd=s["hd"], bf16=int(c.dtype == "bfloat16"),
                    heads=p.heads, tile=p.tile, split=p.split,
                    splits=p.splits, warps=p.warps, smem=p.smem, combine=1,
                    plan=p)
    p = mamba_scan.scan_plan(s["B"], s["L"], s["D"], s["N"], n_sms)
    return dict(plan=p, u=ADDR, dt=ADDR, Bm=ADDR, Cm=ADDR, A=ADDR, y=ADDR,
                hL=ADDR if s.get("final_state") else 0,
                ws_h=ADDR if p.segments > 1 or p.tiles > 1 else 0,
                ws_p=ADDR if p.segments > 1 else 0, B=s["B"], L=s["L"],
                D=s["D"], N=s["N"], nl=p.nl, eg=p.eg, warps=p.warps,
                chunk=p.chunk, segs=p.segments, seg_len=p.seg_len,
                smem=p.smem)


def perturbations(kernel: str, args: dict) -> list[tuple[str, dict]]:
    """Single-field changes of the planner's ``args`` that the launcher's
    contract refuses, each (label, args)."""
    out = []

    def change(label, **kw):
        out.append((label, dict(args, **kw)))

    a = args
    if kernel.startswith("reid"):
        ng = _cdiv(a["G"], _BG)
        change("S > tiles", S=ng + 1)
        change("S = 0", S=0)
        change("k > MAX_K", k=_MAX_K + 1)
        if ng >= 2:
            change("missing workspace", S=max(a["S"], 2), ws_v=0)
        if kernel == "reid_topk_segment_masked":
            change("C > MAX_CAMS", C=_MAX_CAMS + 1)
    elif kernel == "flash_attention":
        change("splits + 1", splits=a["splits"] + 1)
        change("splits - 1", splits=a["splits"] - 1)
        change("stages + 1", stages=a["stages"] + 1)
        change("rows off the plan", rows=a["rows"] * 2)
        change("keys off the plan", bk=a["bk"] // 2)
        change("hd 264", hd=264)
        change("H % KV != 0", KV=a["H"] + 1)
        change("o off 16 bytes", o=a["o"] + 8)
        change("lse off 16 bytes", lse=a["lse"] + 4)
    elif kernel == "flash_attention_bwd":
        change("rows off the plan", rows=a["rows"] * 2)
        change("keys off the plan", keys=a["keys"] // 2)
        change("dq keys off the plan", q_keys=a["q_keys"] * 2)
        change("stages + 1", stages=a["stages"] + 1)
        change("hd 264", hd=264)
        change("H % KV != 0", KV=a["H"] + 1)
        change("T = 0", T=0)
        change("S past MAX_LEN", S=INT_MAX - 126)
        change("do off 16 bytes", do=a["do"] + 8)
        change("missing lse", lse=0)
        change("missing workspace", delta=0)
        if a["H"] > a["KV"]:
            change("missing partials", ws_v=0)
    elif kernel == "decode_attention":
        change("splits + 1", splits=a["splits"] + 1)
        change("splits - 1", splits=a["splits"] - 1)
        change("smem + 16", smem=a["smem"] + 16)
        change("tile off its score block", tile=a["tile"] + 1)
        change("hd 264", hd=264)
        change("H % KV != 0", KV=a["H"] + 1)
        change("heads 3", heads=3)
        top = INT_MAX + 2 - _DEC_STAGES * a["warps"] * a["tile"]
        split = _cdiv(top, a["splits"])
        change("T one past the loaded key's int bound", T=top, split=split,
               splits=_cdiv(top, split))
        if a["splits"] > 1:
            change("missing workspace", ws=0)
            change("missing counters", counters=0)
    elif kernel == "mamba_scan":
        change("segs + 1", segs=a["segs"] + 1)
        change("segs - 1", segs=a["segs"] - 1)
        change("chunk off its group", chunk=a["chunk"] + 4)
        change("eg 2", eg=2)
        change("nl 3", nl=3)
        if a["segs"] > 1:
            change("missing workspace", ws_p=0)
    return out


# ---------------------------------------------------------------------------
# The geometry: every launch of a call, block by block
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Launch:
    """One launch (or second pass) as its blocks see it.  Each access is
    (name, lo, hi): per block a ``[lo, hi)`` element range of operand
    ``name`` (hulls where a block touches a strided set); each cover is
    (what, shape, lo, hi, need): boxes (n, d) over a logical index space
    that must hold every element of ``need`` (boxes, or None for the whole
    space) exactly once and nothing else."""
    kernel: str
    grid: tuple
    threads: int
    smem: int                 # dynamic, as the launcher asks
    layout: int               # dynamic, as the kernel lays it out
    static: int = 0
    launch_bound: int = MAX_THREADS
    extents: dict = dataclasses.field(default_factory=dict)
    reads: list = dataclasses.field(default_factory=list)
    writes: list = dataclasses.field(default_factory=list)
    covers: list = dataclasses.field(default_factory=list)
    ints: dict = dataclasses.field(default_factory=dict)
    counts: list = dataclasses.field(default_factory=list)


def _i64(x):
    return np.asarray(x, dtype=np.int64)


def _box(*dims):
    """(lo, hi) arrays (n, d) of boxes from per-dimension (lo, hi) pairs
    of scalars or (n,) arrays."""
    sizes = [np.size(v) for d in dims for v in d if np.ndim(v)]
    n = sizes[0] if sizes else 1
    lo = np.stack([np.broadcast_to(_i64(d[0]), (n,)) for d in dims], 1)
    hi = np.stack([np.broadcast_to(_i64(d[1]), (n,)) for d in dims], 1)
    return lo, hi


def _reid_launches(kernel: str, a: dict) -> list[Launch]:
    Q, G, D, k, S = a["Q"], a["G"], a["D"], a["k"], a["S"]
    K = reid_topk.round_k(k)
    nq, ng = _cdiv(Q, _BQ), _cdiv(G, _BG)
    width = a.get("C", a.get("CT"))
    if kernel == "reid_topk_segment_masked":
        dyn, static = 4 * _BQ * _cdiv(width, 32), _SMEM_STATIC
    elif kernel == "reid_topk_tiles":
        dyn, static = 0, _TILE_SMEM_STATIC
    else:
        dyn, static = 0, _SMEM_STATIC
    first = Launch(kernel, (nq * S, 1, 1), _NT, dyn, dyn, static, _NT)
    # the last tile row a block stages, t * BG + c, is the last slice's
    first.ints = {"nq * S (the grid)": nq * S,
                  "t * BG + c (a staged gallery row)": ng * _BG - 1}
    if nq * S > _MAX_GRID_POINTS:
        return [first]
    i = np.arange(nq * S, dtype=np.int64)
    s = i // nq
    q0 = (i - s * nq) * _BQ
    q1 = np.minimum(q0 + _BQ, Q)
    cut = np.array(reid_topk.slices(G, S), dtype=np.int64).reshape(-1, 2)
    g0, g1 = cut[s, 0], cut[s, 1]
    first.extents = dict(q=Q * D, g=G * D, out_v=Q * k, out_i=Q * k,
                         ws_v=Q * S * K, ws_i=Q * S * K)
    first.reads = [("q", q0 * D, q1 * D), ("g", g0 * D, g1 * D)]
    if width is not None:
        first.extents.update(q_tag=Q, admit=Q * width, gal_cam=G, gal_tag=G)
        first.reads += [("q_tag", q0, q1), ("admit", q0 * width, q1 * width),
                        ("gal_cam", g0, g1), ("gal_tag", g0, g1)]
    first.covers.append(("(query, gallery) pairs", (Q, G),
                         *_box((q0, q1), (g0, g1)), None))
    out = [first]
    if S == 1:
        for name in ("out_v", "out_i"):
            first.writes.append((name, q0 * k, q1 * k))
        first.covers.append(("out (Q, k)", (Q, k), *_box((q0, q1), (0, k)),
                             None))
        return out
    for name in ("ws_v", "ws_i"):
        first.writes.append((name, (q0 * S + s) * K,
                             ((q1 - 1) * S + s) * K + K))
    first.covers.append(("workspace (Q, S, K)", (Q, S, K),
                         *_box((q0, q1), (s, s + 1), (0, K)), None))
    row = np.arange(Q, dtype=np.int64)
    merge = Launch("merge_slices", (Q, 1, 1), _MERGE_THREADS, 0, 0,
                   _MERGE_STATIC, _MERGE_THREADS)
    merge.extents = dict(ws_v=Q * S * K, ws_i=Q * S * K, out_v=Q * k,
                         out_i=Q * k)
    merge.reads = [(n, row * S * K, (row + 1) * S * K)
                   for n in ("ws_v", "ws_i")]
    merge.writes = [(n, row * k, (row + 1) * k) for n in ("out_v", "out_i")]
    merge.covers.append(("out (Q, k)", (Q, k),
                         *_box((row, row + 1), (0, k)), None))
    return out + [merge]


def _flash_launches(a: dict) -> list[Launch]:
    B, H, KV, S, T, hd = a["B"], a["H"], a["KV"], a["S"], a["T"], a["hd"]
    bf16, rows, bk = a["bf16"] != 0, a["rows"], a["bk"]
    hdp = _cdiv(hd, 16) * 16
    gx = _cdiv(S, rows)
    threads = rows * 2 * (1 if bf16 else a["splits"])
    layout = _flash_smem(hdp, bf16, _flash_rows(hdp, bf16), _flash_bk(hdp),
                         _flash_splits(hdp, bf16), _flash_stages(hdp, bf16))
    # __launch_bounds__(ROWS * 2 * KS) of the template built for hdp
    bound = _flash_rows(hdp, bf16) * 2 * \
        (1 if bf16 else _flash_splits(hdp, bf16))
    L = Launch("flash_attention", (gx, H, B), threads, a["smem"], layout, 0,
               bound)
    step = bk * (1 if bf16 else a["splits"])
    L.ints = {"q0 + rows (a block's last row bound)": gx * rows,
              "kend + step - 1 (its key tiles)":
              (min(T, gx * rows) if a["causal"] else T) + step - 1}
    if gx * H * B > _MAX_GRID_POINTS:
        return [L]
    i = np.arange(gx * H * B, dtype=np.int64)
    bx, h, b = i % gx, i // gx % H, i // (gx * H)
    q0 = (gx - 1 - bx) * rows                 # heaviest first
    q1 = np.minimum(q0 + rows, S)
    kvh = h // (H // KV)
    kend = np.minimum(T, q0 + rows) if a["causal"] else \
        np.full_like(q0, T)
    qrow, kvrow = (b * H + h) * S, (b * KV + kvh) * T
    L.extents = dict(q=B * H * S * hd, k=B * KV * T * hd,
                     v=B * KV * T * hd, o=B * H * S * hd, lse=B * H * S)
    L.reads = [("q", (qrow + q0) * hd, (qrow + q1) * hd),
               ("k", kvrow * hd, (kvrow + kend) * hd),
               ("v", kvrow * hd, (kvrow + kend) * hd)]
    L.writes = [("o", (qrow + q0) * hd, (qrow + q1) * hd)]
    rows_box = _box((b, b + 1), (h, h + 1), (q0, q1))
    L.covers.append(("o (B, H, S)", (B, H, S), *rows_box, None))
    if a["lse"]:
        L.writes.append(("lse", qrow + q0, qrow + q1))
        L.covers.append(("lse (B, H, S)", (B, H, S), *rows_box, None))
    return [L]


def _flash_bwd_launches(a: dict) -> list[Launch]:
    """The backward's passes: D a warp a row (8 rows a block); dk / dv a
    (key tile, query head h, b), writing dk and dv, or the head's float32
    partials where H > KV; the partials' sum over each kv head's query
    heads (a grid-stride loop of 1,024-element spans); dq a (row tile, h,
    b), heaviest causal tile first."""
    B, H, KV, S, T, hd = a["B"], a["H"], a["KV"], a["S"], a["T"], a["hd"]
    bf16, causal = a["bf16"] != 0, a["causal"]
    R, K, QK = a["rows"], a["keys"], a["q_keys"]
    G = H // KV
    hdp = _bwd_hdp(hd)
    kv_layout, q_layout = _bwd_smem(hdp, bf16, _bwd_rows(hdp, bf16),
                                    _bwd_qkeys(hdp, bf16),
                                    _bwd_stages(hdp, bf16))
    bound = 128 * _bwd_cols(hdp)          # __launch_bounds__(128 * CS, 1)
    nrows = B * H * S
    nd = _cdiv(nrows, _BWD_DELTA_ROWS)
    gk, gq = _cdiv(T, K), _cdiv(S, _BWD_QROWS)
    kend_max = min(T, gq * _BWD_QROWS) if causal else T
    ext_q, ext_k, ext_ws = B * H * S * hd, B * KV * T * hd, B * H * T * hd
    delta = Launch("flash_attention_bwd", (nd, 1, 1), 32 * _BWD_DELTA_ROWS,
                   0, 0, 0, 32 * _BWD_DELTA_ROWS,
                   ints={"B H S / 8 (bwd_delta's grid)": nd})
    dkdv = Launch("flash_bwd_dkdv", (gk, H, B), a["threads"], a["smem"],
                  kv_layout, 0, bound,
                  ints={"k0 + KEYS (a block's key bound)": gk * K,
                        "q0 + rows at the row loop's end": _cdiv(S, R) * R})
    dq = Launch("flash_bwd_dq", (gq, H, B), 128, a["q_smem"], q_layout, 0,
                128, ints={"q0 + 64 (a block's row bound)": gq * _BWD_QROWS,
                           "k0 + q_keys at the key loop's end":
                           _cdiv(kend_max, QK) * QK})
    n = B * KV * T * hd
    want = _cdiv(n // 4, _BWD_SUM_THREADS)
    sums = Launch("flash_bwd_sum", (min(want, _BWD_SUM_BLOCKS), 1, 1),
                  _BWD_SUM_THREADS, 0, 0, 0, _BWD_SUM_THREADS)
    # the sum only where H > KV
    out = [delta, dkdv] + ([sums] if G > 1 else []) + [dq]
    if max(nd, gk * H * B, gq * H * B, _cdiv(n, 1024)) > _MAX_GRID_POINTS:
        return out
    # D: rows [r0, r1) of o and do, into delta
    r0 = np.arange(nd, dtype=np.int64) * _BWD_DELTA_ROWS
    r1 = np.minimum(r0 + _BWD_DELTA_ROWS, nrows)
    delta.extents = dict(o=ext_q, do=ext_q, delta=nrows)
    delta.reads = [("o", r0 * hd, r1 * hd), ("do", r0 * hd, r1 * hd)]
    delta.writes = [("delta", r0, r1)]
    delta.covers.append(("D (B H S)", (nrows,), *_box((r0, r1)), None))
    # dk / dv
    j = np.arange(gk * H * B, dtype=np.int64)
    kx, h, b = j % gk, j // gk % H, j // (gk * H)
    k0 = kx * K
    k1 = np.minimum(k0 + K, T)
    qrow, kvrow = (b * H + h) * S, (b * KV + h // G) * T
    qstart = np.minimum(k0, S) if causal else np.zeros_like(k0)
    dkdv.extents = dict(q=ext_q, k=ext_k, v=ext_k, do=ext_q, lse=nrows,
                        delta=nrows, dk=ext_k, dv=ext_k, ws_k=ext_ws,
                        ws_v=ext_ws)
    dkdv.reads = [("k", (kvrow + k0) * hd, (kvrow + k1) * hd),
                  ("v", (kvrow + k0) * hd, (kvrow + k1) * hd),
                  ("q", (qrow + qstart) * hd, (qrow + S) * hd),
                  ("do", (qrow + qstart) * hd, (qrow + S) * hd),
                  ("lse", qrow + qstart, qrow + S),
                  ("delta", qrow + qstart, qrow + S)]
    if G > 1:
        wrow = (b * H + h) * T
        dkdv.writes = [(n_, (wrow + k0) * hd, (wrow + k1) * hd)
                       for n_ in ("ws_k", "ws_v")]
        dkdv.covers.append(("dk and dv partials (B, H, T)", (B, H, T),
                            *_box((b, b + 1), (h, h + 1), (k0, k1)), None))
    else:
        dkdv.writes = [(n_, (kvrow + k0) * hd, (kvrow + k1) * hd)
                       for n_ in ("dk", "dv")]
        dkdv.covers.append(("dk and dv (B, KV, T)", (B, KV, T),
                            *_box((b, b + 1), (h, h + 1), (k0, k1)), None))
    if G > 1:
        # spans [e0, e1) of dk and dv (elements), each from the G heads'
        # partials at (u G + g) per + r, u = e // per, r = e % per
        per = T * hd
        e0 = np.arange(_cdiv(n, 1024), dtype=np.int64) * 1024
        e1 = np.minimum(e0 + 1024, n)
        u0, u1 = e0 // per, (e1 - 1) // per
        lo = u0 * G * per + (e0 - u0 * per)
        hi = (u1 * G + G - 1) * per + (e1 - 1 - u1 * per) + 1
        sums.extents = dict(ws_k=ext_ws, ws_v=ext_ws, dk=ext_k, dv=ext_k)
        sums.reads = [("ws_k", lo, hi), ("ws_v", lo, hi)]
        sums.writes = [("dk", e0, e1), ("dv", e0, e1)]
        sums.covers.append(("dk and dv (B KV T hd)", (n,), *_box((e0, e1)),
                            None))
    # dq
    i = np.arange(gq * H * B, dtype=np.int64)
    bx, h, b = i % gq, i // gq % H, i // (gq * H)
    q0 = (gq - 1 - bx) * _BWD_QROWS           # heaviest first
    q1 = np.minimum(q0 + _BWD_QROWS, S)
    kend = np.minimum(T, q0 + _BWD_QROWS) if causal else np.full_like(q0, T)
    qrow, kvrow = (b * H + h) * S, (b * KV + h // G) * T
    dq.extents = dict(q=ext_q, k=ext_k, v=ext_k, do=ext_q, lse=nrows,
                      delta=nrows, dq=ext_q)
    dq.reads = [("q", (qrow + q0) * hd, (qrow + q1) * hd),
                ("do", (qrow + q0) * hd, (qrow + q1) * hd),
                ("k", kvrow * hd, (kvrow + kend) * hd),
                ("v", kvrow * hd, (kvrow + kend) * hd),
                ("lse", qrow + q0, qrow + q1),
                ("delta", qrow + q0, qrow + q1)]
    dq.writes = [("dq", (qrow + q0) * hd, (qrow + q1) * hd)]
    dq.covers.append(("dq (B, H, S)", (B, H, S),
                      *_box((b, b + 1), (h, h + 1), (q0, q1)), None))
    return out


def _decode_keys(length, T, split, splits, tile, warps) -> dict:
    """The largest keys a warp of a scoring block forms in ``int``, over
    every (row length, split, warp) of the call: its first key t_begin +
    w tile, the key t0 its loop steps to by rounds of warps tiles (the
    first at or past the split's end) and the key ld_t0 that ``issue()``
    steps to, STAGES - 1 rounds ahead of t0."""
    ln = np.unique(np.clip(_i64(length), 0, T))
    ln = ln[ln > 0]
    if not len(ln):
        return {}
    rnd = warps * tile
    s = np.arange(min(splits, _cdiv(int(ln.max()), split)), dtype=np.int64)
    t_begin = s[None, :] * split
    t_end = np.minimum(t_begin + split, ln[:, None])
    live = t_begin < ln[:, None]
    first = t_begin[..., None] + np.arange(warps, dtype=np.int64) * tile
    steps = np.maximum(_cdiv(t_end[..., None] - first, rnd), 0)
    last = np.where(live[..., None], first + steps * rnd, 0)
    first = np.where(live[..., None], first, 0)
    return {"t_begin + w * tile (a warp's first key)": int(first.max()),
            "t0 (the key a warp's loop steps to)": int(last.max()),
            "ld_t0 (the key issue() steps to, STAGES - 1 rounds ahead)":
            int(last.max()) + (_DEC_STAGES - 1) * rnd}


def _decode_launches(a: dict, length) -> list[Launch]:
    B, H, KV, T, hd = a["B"], a["H"], a["KV"], a["T"], a["hd"]
    bf16, heads, tile = a["bf16"] != 0, a["heads"], a["tile"]
    split, splits, warps = a["split"], a["splits"], a["warps"]
    G = H // KV
    groups = _cdiv(G, heads)
    hdp = _cdiv(hd, 16) * 16 if bf16 else _cdiv(hd, 32) * 32
    nblk = B * KV * groups * splits
    L = Launch("decode_attention", (nblk, 1, 1), 32 * warps, a["smem"],
               _dec_smem(hdp, bf16, heads, tile, warps), 4,
               _DEC_MAX_THREADS)
    L.ints = {"B KV groups splits (the grid)": nblk,
              **_decode_keys(length, T, split, splits, tile, warps)}
    if nblk > _MAX_GRID_POINTS:
        return [L]
    # locate(): blockIdx.x as (row b, kv head, group, split s), s fastest
    i = np.arange(nblk, dtype=np.int64)
    s, unit = i % splits, i // splits
    grp, u = unit % groups, unit // groups
    kvh, b = u % KV, u // KV
    h0 = kvh * G + grp * heads
    gv = np.minimum(heads, G - grp * heads)
    ln = np.clip(_i64(length), 0, T)[b]
    n_valid = _cdiv(ln, split)
    orow = (b * H + h0) * hd
    active = (s < n_valid) & (ln > 0)
    zero = (s == 0) & (ln == 0)
    direct = active & (n_valid == 1)
    partial = active & (n_valid > 1)
    t0 = s * split
    t1 = np.minimum(t0 + split, ln)
    kv0 = (b * KV + kvh) * T * hd
    wsz = B * H * splits
    hrow = (b * H + h0) * splits
    L.extents = dict(q=B * H * hd, k=B * KV * T * hd, v=B * KV * T * hd,
                     length=B, o=B * H * hd, ws=wsz * (hd + 2),
                     counters=B * KV * groups)
    ex = active
    L.reads = [("q", orow[ex], (orow + gv * hd)[ex]),
               ("k", (kv0 + t0 * hd)[ex], (kv0 + t1 * hd)[ex]),
               ("v", (kv0 + t0 * hd)[ex], (kv0 + t1 * hd)[ex]),
               ("length", b, b + 1)]
    wr = direct | zero
    last = (hrow + (gv - 1) * splits + s)[partial]
    L.writes = [("o", orow[wr], (orow + gv * hd)[wr]),
                ("ws", (hrow + s)[partial] * hd, (last + 1) * hd),
                ("ws", wsz * hd + 2 * (hrow + s)[partial],
                 wsz * hd + 2 * (last + 1)),
                ("counters", unit[partial], unit[partial] + 1)]
    keys = _box((b, b + 1), (h0, h0 + gv), (t0, t1))
    rows = np.arange(B, dtype=np.int64)
    need = _box((rows, rows + 1), (0, H),
                (0, np.clip(_i64(length), 0, T)))
    L.covers.append(("keys (B, H, key < length)", (B, H, max(T, 1)),
                     keys[0][active], keys[1][active], need))
    out = [L]
    # the combine: the last block of each (row, kv head, group) with more
    # than one split, found by the unit's ticket counter
    units = np.flatnonzero(partial & (s == 0))
    done = np.bincount(unit[partial], minlength=B * KV * groups)
    ub = unit[units]
    L.counts.append(("ticket counter increments a unit",
                     done[ub], n_valid[units]))
    C = Launch("decode_combine", (nblk, 1, 1), 32 * warps, a["smem"],
               L.layout, 4, _DEC_MAX_THREADS)
    C.extents = L.extents
    cb, ch0, cgv, cn = b[units], h0[units], gv[units], n_valid[units]
    crow, corow = hrow[units], orow[units]
    clast = crow + (cgv - 1) * splits
    C.reads = [("ws", crow * hd, (clast + cn) * hd),
               ("ws", wsz * hd + 2 * crow, wsz * hd + 2 * (clast + cn))]
    C.writes = [("o", corow, corow + cgv * hd)]
    written = _box((b, b + 1), (h0, h0 + gv), (s, s + 1))
    C.covers.append(("partials (B, H, splits) each combine reads",
                     (B, H, splits), written[0][partial],
                     written[1][partial],
                     _box((cb, cb + 1), (ch0, ch0 + cgv), (0, cn))))
    olo, ohi = _box((b, b + 1), (h0, h0 + gv), (0, hd))
    clo, chi = _box((cb, cb + 1), (ch0, ch0 + cgv), (0, hd))
    C.covers.append(("o (B, H, hd)", (B, H, hd),
                     np.concatenate([olo[wr], clo]),
                     np.concatenate([ohi[wr], chi]), None))
    return out + [C]


def _scan_launches(a: dict) -> list[Launch]:
    B, L_, D, N = a["B"], a["L"], a["D"], a["N"]
    nl, eg, warps, chunk = a["nl"], a["eg"], a["warps"], a["chunk"]
    segs, seg_len = a["segs"], a["seg_len"]
    DB = warps * (32 // nl)
    ndb = _cdiv(D, DB)
    NP = nl * eg
    tiles = _cdiv(N, NP)
    layout = _scan_smem(nl, eg, warps, chunk)
    ints = {"B segs ceil(D / DB) (the grid)": B * segs * ndb,
            "chunk * NP, chunk * DB (staged words)": chunk * max(NP, DB)}
    if B * segs * ndb > _MAX_GRID_POINTS:
        return [Launch("mamba_scan", (B * segs * ndb, 1, 1), 32 * warps,
                       a["smem"], layout, 0, 32 * _SCAN_MAX_WARPS,
                       ints=ints)]
    i = np.arange(B * segs * ndb, dtype=np.int64)
    dblk, seg, b = i % ndb, i // ndb % segs, i // ndb // segs
    d0 = dblk * DB
    d1 = np.minimum(d0 + DB, D)
    t0 = seg * seg_len
    t1 = np.minimum(t0 + seg_len, L_)
    live = t1 > t0
    row = b * L_
    wsb = (b * segs + seg) * N
    extents = dict(u=B * L_ * D, dt=B * L_ * D, Bm=B * L_ * N,
                   Cm=B * L_ * N, A=D * N, y=B * L_ * D, hL=B * D * N,
                   ws_h=B * segs * N * D, ws_p=B * segs * N * D)

    def bld(name):
        return (name, np.where(live, (row + t0) * D + d0, 0),
                np.where(live, (row + t1 - 1) * D + d1, 0))

    reads = [bld("u"), bld("dt"), ("Bm", (row + t0) * N, (row + t1) * N),
             ("Cm", (row + t0) * N, (row + t1) * N), ("A", d0 * N, d1 * N)]
    ws_rng = (wsb * D + d0, (wsb + max(N, 1) - 1) * D + d1) if N else \
        (wsb * D, wsb * D)
    ws_box = _box((b, b + 1), (seg, seg + 1), (0, N), (d0, d1))
    out = []
    count, nd = B * N * D, N * D
    if segs > 1:
        tot = Launch("mamba_scan", (i.size, 1, 1), 32 * warps, a["smem"],
                     layout, 0, 32 * _SCAN_MAX_WARPS, dict(extents),
                     list(reads), [("ws_h", *ws_rng), ("ws_p", *ws_rng)])
        tot.covers += [(f"{n} (B, segs, N, D), the totals pass",
                        (B, segs, N, D), *ws_box, None)
                       for n in ("ws_h", "ws_p")]
        tot.ints = ints
        out.append(tot)
    if segs > 1 and count > 0:
        e0 = np.arange(_cdiv(count, 256), dtype=np.int64) * 256
        e1 = np.minimum(e0 + 256, count)
        b0, b1 = e0 // nd, (e1 - 1) // nd
        lo = (b0 * segs) * nd + (e0 - b0 * nd)
        hi = (b1 * segs + segs - 1) * nd + (e1 - 1 - b1 * nd) + 1
        carry = Launch("scan_carry", (e0.size, 1, 1), 256, 0, 0, 0, 256,
                       dict(ws_h=extents["ws_h"], ws_p=extents["ws_p"]),
                       [("ws_h", lo, hi), ("ws_p", lo, hi)],
                       [("ws_h", lo, hi)])
        carry.covers.append(("(b, n, d) carried", (count,),
                             *_box((e0, e1)), None))
        out.append(carry)
    ypass = Launch("mamba_scan", (i.size, 1, 1), 32 * warps, a["smem"],
                   layout, 0, 32 * _SCAN_MAX_WARPS, dict(extents),
                   list(reads), [bld("y")])
    if segs > 1 or tiles > 1:
        ypass.reads.append(("ws_h", *ws_rng))
    if tiles > 1:
        ypass.writes.append(("ws_h", *ws_rng))
    ypass.covers.append(("y (B, L, D)", (B, L_, D),
                         *_box((b, b + 1), (t0, t1), (d0, d1)), None))
    if a["hL"]:
        last = seg == segs - 1
        ypass.writes.append(("hL", ((b * D + d0) * N)[last],
                             ((b * D + d1) * N)[last]))
        lo, hi = _box((b, b + 1), (d0, d1), (0, N))
        ypass.covers.append(("hL (B, D, N)", (B, D, N), lo[last], hi[last],
                             None))
    ypass.ints = ints
    return out + [ypass]


def launches(c: Case, args: dict) -> list[Launch]:
    """Every launch the wrapper makes on ``c`` with ``args`` (from
    ``plan_args``), in order."""
    if c.kernel.startswith("reid"):
        return _reid_launches(c.kernel, args)
    if c.kernel == "flash_attention":
        return _flash_launches(args)
    if c.kernel == "flash_attention_bwd":
        return _flash_bwd_launches(args)
    if c.kernel == "decode_attention":
        return _decode_launches(args, c.s["length"])
    return _scan_launches(args)


# ---------------------------------------------------------------------------
# The proof
# ---------------------------------------------------------------------------

def _cover(shape, lo, hi, need):
    """Where the boxes [lo, hi) (n, d) fail to hold every element of
    ``need`` (boxes, or None for all of ``shape``) exactly once and
    nothing else: None, or (element, times, wanted).  Counts run over the
    cells that the boxes' edges cut, through a difference array."""
    d = len(shape)
    full = _i64(shape)
    lo = np.clip(_i64(lo).reshape(-1, d), 0, full)
    hi = np.clip(_i64(hi).reshape(-1, d), lo, full)
    if need is None:
        need = (np.zeros((1, d), np.int64), full[None])
    nlo = np.clip(_i64(need[0]).reshape(-1, d), 0, full)
    nhi = np.clip(_i64(need[1]).reshape(-1, d), nlo, full)
    cuts = [np.unique(np.concatenate([[0, full[j]], lo[:, j], hi[:, j],
                                      nlo[:, j], nhi[:, j]]))
            for j in range(d)]

    def density(blo, bhi):
        il = [np.searchsorted(cuts[j], blo[:, j]) for j in range(d)]
        ih = [np.searchsorted(cuts[j], bhi[:, j]) for j in range(d)]
        diff = np.zeros([len(c) for c in cuts], np.int64)
        for corner in itertools.product((0, 1), repeat=d):
            index = tuple(ih[j] if up else il[j]
                          for j, up in enumerate(corner))
            np.add.at(diff, index, (-1) ** sum(corner))
        for j in range(d):
            diff = diff.cumsum(axis=j)
        return diff[tuple(slice(0, len(c) - 1) for c in cuts)]

    got, want = density(lo, hi), density(nlo, nhi)
    bad = np.argwhere(got != want)
    if not len(bad):
        return None
    cell = tuple(bad[0])
    return (tuple(int(cuts[j][cell[j]]) for j in range(d)),
            int(got[cell]), int(want[cell]))


def _check(launch: Launch, where: str) -> list[str]:
    """What ``launch`` breaks, one line a property."""
    out = []
    gx, gy, gz = launch.grid
    if not (1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX
            and 1 <= gz <= GRID_YZ_MAX):
        out.append(f"grid {launch.grid} outside (2^31-1, 65535, 65535)")
    if not 1 <= launch.threads <= min(MAX_THREADS, launch.launch_bound):
        out.append(f"{launch.threads} threads a block, past "
                   f"{min(MAX_THREADS, launch.launch_bound)} (the card or "
                   f"the kernel's __launch_bounds__)")
    if launch.smem != launch.layout:
        out.append(f"asks {launch.smem} B of dynamic shared memory, the "
                   f"kernel lays out {launch.layout} B")
    for what, dyn in (("asked", launch.smem), ("laid out", launch.layout)):
        if dyn + launch.static > MAX_SMEM:
            out.append(f"{dyn} B dynamic shared memory {what} + "
                       f"{launch.static} B static, past MAX_SMEM "
                       f"{MAX_SMEM}")
    for name, value in launch.ints.items():
        if value > INT_MAX:
            out.append(f"int offset {name} reaches {value}, past INT_MAX")
    points = gx * gy * gz
    if points > _MAX_GRID_POINTS:
        out.append(f"grid {launch.grid} too large to enumerate ({points} "
                   f"blocks) — shrink the audit shapes")
        return out
    for kind, accesses in (("reads", launch.reads),
                           ("writes", launch.writes)):
        seen = set()
        for name, lo, hi in accesses:
            lo, hi = _i64(lo), _i64(hi)
            ext = launch.extents[name]
            bad = (lo < 0) | (hi > ext) | (lo > hi)
            if name not in seen and bad.any():
                j = int(np.argmax(bad))
                out.append(f"a block {kind} {name}[{int(lo.flat[j])}, "
                           f"{int(hi.flat[j])}), outside its {ext} "
                           f"elements")
                seen.add(name)
    for what, shape, lo, hi, need in launch.covers:
        miss = _cover(shape, lo, hi, need)
        if miss is not None:
            out.append(f"{what}: element {miss[0]} written {miss[1]} "
                       f"times, wanted {miss[2]}")
    for what, got, want in launch.counts:
        if not np.array_equal(got, want):
            j = int(np.argmax(got != want))
            out.append(f"{what}: {int(got[j])}, the combine waits for "
                       f"{int(want[j])}")
    return [f"{where}: {m}" for m in out]


def check_launch(kernel: str, shape: dict, dtype: str = "float32",
                 n_sms: int = 132) -> list[Violation]:
    """Prove the launches of one wrapper call (``kernel`` a ``KERNELS``
    name, ``shape`` as ``Case``'s) on a card of ``n_sms`` SMs: the planner
    emits a plan, the launcher's guard takes it, and every launch keeps the
    limits, the bounds, the ``int`` offsets and the exact cover."""
    c = case(kernel, dtype, **shape)
    where = f"{c} at {n_sms} SMs"
    if not launches_at_all(c):
        return []
    try:
        args = plan_args(c, n_sms)
    except (ValueError, TypeError) as e:
        return [_finding(kernel, f"{where}: the planner refuses a shape "
                                 f"the wrapper launches: {e}")]
    out = []
    if not launcher_accepts(kernel, args):
        out.append(_finding(kernel, f"{where}: the launcher's guard refuses "
                                    f"the planner's plan {args}"))
    if kernel.startswith("reid"):
        ng = _cdiv(c.s["G"], _BG)
        kernel_cut = [(s * ng // args["S"] * _BG,
                       min((s + 1) * ng // args["S"] * _BG, c.s["G"]))
                      for s in range(args["S"])]
        theirs = reid_topk.slices(c.s["G"], args["S"])
        if theirs != kernel_cut:
            j = next((j for j, (x, y) in enumerate(zip(theirs, kernel_cut))
                      if x != y), min(len(theirs), len(kernel_cut)))
            out.append(_finding(kernel, f"{where}: slices() is not the "
                                        f"kernel's cut: slice {j} "
                                        f"{theirs[j:j + 1]} against "
                                        f"{kernel_cut[j:j + 1]}"))
    if kernel == "decode_attention":
        out += _block_work_findings(c, args, where)
    for launch in launches(c, args):
        out += [_finding(launch.kernel, m) for m in _check(launch, where)]
    return out


def _block_work_findings(c: Case, args: dict, where: str):
    """``decode_attention.block_work`` (the planner's account of the blocks
    that score keys) against the kernel's ``locate``."""
    s = c.s
    blocks = s["B"] * s["KV"] * _cdiv(s["H"] // s["KV"], args["heads"]) * \
        args["splits"]
    if args["plan"].blocks != blocks:
        return [_finding("decode_attention", f"{where}: the plan's "
                                             f"{args['plan'].blocks} blocks "
                                             f"are not the launcher's grid "
                                             f"of {blocks}")]
    b, h0, heads, start, end = (t.numpy() for t in decode_attention.block_work(
        args["plan"], s["B"], s["H"], s["KV"], s["T"],
        torch.tensor(s["length"], dtype=torch.int64)))
    _, _, lo, hi, _ = _decode_launches(args, s["length"])[0].covers[0]
    if not (np.array_equal(lo, np.stack([b, h0, start], 1).reshape(-1, 3))
            and np.array_equal(hi, np.stack([b + 1, h0 + heads, end],
                                            1).reshape(-1, 3))):
        return [_finding("decode_attention", f"{where}: block_work is not "
                                             f"the kernel's locate()")]
    return []


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def _lengths(B: int, T: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(int(x) for x in rng.integers(1, max(T, 1) + 1, B))


def sweep() -> list[Case]:
    """Every case the proof runs at each of ``SM_COUNTS``."""
    out = []
    # -- the reference's ragged shapes (repro/analysis/kernel_audit.py)
    for Q, G, D, k in [(1, 1, 8, 1), (5, 120, 16, 3), (100, 700, 32, 2),
                       (130, 1024, 64, 1), (8, 129, 8, 4)]:
        out.append(case("reid_topk_unmasked", "float32", "reference",
                        Q=Q, G=G, D=D, k=k))
    for Q, C, G, k in [(1, 4, 1, 1), (5, 30, 120, 3), (100, 30, 700, 2),
                       (16, 130, 257, 1)]:
        out.append(case("reid_topk_segment_masked", label="reference",
                        Q=Q, G=G, D=16, k=k, C=C))
        out.append(case("reid_topk_tiles", label="reference", Q=Q, G=G,
                        D=16, k=k, C=C * 4))
    for B, H, S, hd, KV, T in [(2, 4, 256, 64, 2, 512),
                               (1, 2, 512, 32, 2, 256)]:
        for dtype in ("float32", "bfloat16"):
            out.append(case("flash_attention", dtype, "reference", B=B,
                            H=H, KV=KV, S=S, T=T, hd=hd, causal=True))
    for dtype in ("float32", "bfloat16"):
        out.append(case("decode_attention", dtype, "reference", B=2, H=4,
                        KV=2, T=1024, hd=64, length=_lengths(2, 1023, 3)))
    out.append(case("mamba_scan", label="reference", B=2, L=256, D=256,
                    N=16, final_state=False))
    # -- one below, at and one past each planner's tile
    for Q in (63, 64, 65):
        for G in (63, 64, 65, 255, 256, 257):
            for D, k in ((31, 1), (33, 16)):
                out.append(case("reid_topk_unmasked", label="tile edges",
                                Q=Q, G=G, D=D, k=k))
                out.append(case("reid_topk_segment_masked",
                                label="tile edges", Q=Q, G=G, D=D, k=k,
                                C=33))
                out.append(case("reid_topk_tiles", label="tile edges",
                                Q=Q, G=G, D=D, k=k, C=33 * 64))
    for kernel, C in (("reid_topk_segment_masked", _MAX_CAMS),
                      ("reid_topk_tiles", 15 * 64 * 64)):
        out.append(case(kernel, label="widest admission", Q=70, G=700, D=16,
                        k=5, C=C))
    for hd, dtype in ((64, "float32"), (64, "bfloat16"), (256, "float32"),
                      (80, "bfloat16")):
        p = flash_attention.flash_plan(hd, _torch_dtype(dtype))
        for S in (p.rows - 1, p.rows, p.rows + 1):
            for T in (p.keys - 1, p.keys, p.keys + 1, S):
                for causal in (True, False):
                    out.append(case("flash_attention", dtype, "tile edges",
                                    B=2, H=4, KV=2, S=S, T=T, hd=hd,
                                    causal=causal))
    for hd, dtype, H, KV in ((64, "float32", 8, 2), (64, "bfloat16", 8, 2),
                             (128, "float32", 40, 4), (80, "bfloat16", 12,
                                                       12)):
        T = 4096
        p = decode_attention.decode_plan(2, H, KV, T, hd,
                                         _torch_dtype(dtype), 132)
        edges = (0, 1, p.tile - 1, p.tile, p.tile + 1, p.split - 1, p.split,
                 p.split + 1, T - 1, T)
        out.append(case("decode_attention", dtype, "split and tile edges",
                        B=len(edges), H=H, KV=KV, T=T, hd=hd,
                        length=tuple(max(0, e) for e in edges)))
        out.append(case("decode_attention", dtype, "no keys", B=2, H=H,
                        KV=KV, T=0, hd=hd, length=(0, 0)))
    p = mamba_scan.scan_plan(1, 1024, 256, 16, 132)
    for L in (p.chunk - 1, p.chunk, p.chunk + 1, p.seg_len - 1, p.seg_len,
              p.seg_len + 1, 1001):
        for D, N in ((256, 16), (65, 5), (31, 17)):
            out.append(case("mamba_scan", label="chunk and segment edges",
                            B=2, L=L, D=D, N=N, final_state=True))
    for N in (1, 4, 5, 255, 256, 257, 320):
        out.append(case("mamba_scan", label="state tiles", B=2, L=300, D=65,
                        N=N, final_state=True))
    # -- every head width the attention kernels take, both dtypes
    for hd in range(8, 257, 8):
        for dtype in ("float32", "bfloat16"):
            out.append(case("flash_attention", dtype, "widths", B=1, H=2,
                            KV=1, S=65, T=65, hd=hd, causal=True))
            out.append(case("decode_attention", dtype, "widths", B=2, H=12,
                            KV=4, T=300, hd=hd, length=(300, 7)))
    # -- the flash backward: its tile edges (64 keys and 64 rows a block;
    # 16, 32 or 64 rows and keys a streamed tile), every head width, and
    # the training shapes (launch.train's scaled yi-6b; whisper at full
    # width: the decoder's self and cross attention, the encoder); causal
    # with H / KV = 2 (the heads' partials), not causal with one head a
    # kv head
    for hd, dtype in ((8, "float32"), (64, "bfloat16"), (128, "float32"),
                      (256, "float32"), (136, "bfloat16")):
        for S in (31, 33, 63, 64, 65):
            for T in (31, 63, 64, 65, 129):
                for causal in (True, False):
                    out.append(case("flash_attention_bwd", dtype,
                                    "tile edges", B=2, H=4,
                                    KV=2 if causal else 4, S=S, T=T, hd=hd,
                                    causal=causal))
    for hd in range(8, 257, 8):
        for dtype in ("float32", "bfloat16"):
            out.append(case("flash_attention_bwd", dtype, "widths", B=1,
                            H=2, KV=1, S=65, T=65, hd=hd, causal=True))
    for dtype in ("float32", "bfloat16"):
        for label, shape in TRAIN_SHAPES:
            out.append(case("flash_attention_bwd", dtype, label, **shape))
    # -- the zero-length calls, answered without a launch
    for kernel in ("reid_topk_unmasked", "reid_topk_segment_masked",
                   "reid_topk_tiles"):
        for Q, G in ((0, 12), (4, 0)):
            out.append(case(kernel, label="zero length", Q=Q, G=G, D=8, k=3,
                            **({} if kernel == "reid_topk_unmasked"
                               else dict(C=8))))
    return out + full_widths()


#: the flash backward's training shapes: (label, shape)
TRAIN_SHAPES = (
    ("yi_6b scaled train", dict(B=16, H=4, KV=1, S=256, T=256, hd=128,
                                causal=True)),
    ("whisper_tiny decoder train", dict(B=8, H=6, KV=6, S=448, T=448,
                                        hd=64, causal=True)),
    ("whisper_tiny encoder train", dict(B=8, H=6, KV=6, S=1500, T=1500,
                                        hd=64, causal=False)),
    ("whisper_tiny cross train", dict(B=8, H=6, KV=6, S=448, T=1500,
                                      hd=64, causal=False)),
)


def full_widths() -> list[Case]:
    """Every config of ``repro_torch.configs`` at full width, at the
    shapes ``chip_smoke.py`` runs them (``PERF.md`` §6): flash at B 8, S
    1,024, causal; decode at B 8 over 1,056 of 2,048 keys; whisper's
    encoder flash at S = T = 1,500, not causal, its cross and self decode;
    the scan of each Mamba1 config at B 8, L 1,024, with and without h_L;
    the kernel benchmark's widths (yi-6b decode at B 128 over 32,768 keys,
    zamba2's at B 32) and the re-id stress shape."""
    from repro_torch.configs import all_configs

    out = []
    for arch, cfg in all_configs().items():
        if cfg.has_attention:
            H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            S, T, causal = (1500, 1500, False) if cfg.is_encdec else \
                (1024, 1024, True)
            for dtype in ("float32", "bfloat16"):
                out.append(case("flash_attention", dtype, arch, B=8, H=H,
                                KV=KV, S=S, T=T, hd=hd, causal=causal))
                for T_, n in ((2048, 1056),) + (((1500, 1500), (448, 65))
                                               if cfg.is_encdec else ()):
                    out.append(case("decode_attention", dtype, arch, B=8,
                                    H=H, KV=KV, T=T_, hd=hd,
                                    length=(n,) * 8))
        if cfg.family == "ssm" and cfg.ssm_version == 1:
            for final in (True, False):
                out.append(case("mamba_scan", label=arch, B=8, L=1024,
                                D=cfg.d_inner, N=cfg.ssm_state,
                                final_state=final))
    for dtype in ("float32", "bfloat16"):
        out.append(case("decode_attention", dtype, "yi_6b decode_32k",
                        B=128, H=32, KV=4, T=32768, hd=128,
                        length=_lengths(128, 32768, 1)))
    out.append(case("decode_attention", "bfloat16", "zamba2_2p7b decode",
                    B=32, H=32, KV=32, T=32768, hd=80,
                    length=_lengths(32, 32768, 2)))
    out.append(case("mamba_scan", label="falcon_mamba_7b train", B=1,
                    L=4096, D=8192, N=16, final_state=True))
    for kernel, C in (("reid_topk_segment_masked", 130),
                      ("reid_topk_segment_masked", 8192),
                      ("reid_topk_tiles", 130 * 64),
                      ("reid_topk_unmasked", None)):
        out.append(case(kernel, label="stress", Q=256, G=8192, D=2048,
                        k=16, **({} if C is None else dict(C=C))))
    return out


def routed(c: Case) -> Case:
    """The case as its launcher sees it: a camera-masked call over more
    than ``MAX_CAMS`` cameras runs on the tile launcher
    (``reid_topk.camera_route``)."""
    if c.kernel == "reid_topk_segment_masked":
        symbol = reid_topk.camera_route(c.s["C"])[1]
        if symbol != c.kernel:
            return Case(symbol, c.shape, c.dtype, c.label)
    return c


def _case_findings(c: Case, n_sms: int) -> list[Violation]:
    if c.kernel.startswith("reid") and not launches_at_all(c):
        return _zero_length_findings(c)
    c = routed(c)
    return check_launch(c.kernel, c.s, c.dtype, n_sms)


def _zero_length_findings(c: Case) -> list[Violation]:
    """A re-id call with Q or G zero returns the (NEG_INF, -1) bands
    before it reaches the device dispatch: on meta tensors, which have no
    kernel, it must still answer."""
    s = c.s
    Q, G, D, k = s["Q"], s["G"], s["D"], s["k"]
    meta = dict(device="meta")
    q = torch.empty((Q, D), **meta)
    g = torch.empty((G, D), **meta)
    try:
        if c.kernel == "reid_topk_unmasked":
            out = ops.reid_topk(q, g, k)
        else:
            call = ops.reid_topk_segments if \
                c.kernel == "reid_topk_segment_masked" else ops.reid_topk_tiles
            out = call(q, torch.empty(Q, dtype=torch.int32, **meta),
                       torch.empty((Q, s["C"]), dtype=torch.bool, **meta), g,
                       torch.empty(G, dtype=torch.int32, **meta),
                       torch.empty(G, dtype=torch.int32, **meta), k)
    except ValueError as e:
        return [_finding(c.kernel, f"{c}: reaches the device dispatch "
                                   f"({e}) instead of answering")]
    if tuple(out[0].shape) != (Q, k) or tuple(out[1].shape) != (Q, k):
        return [_finding(c.kernel, f"{c}: answers {tuple(out[0].shape)}, "
                                   f"not ({Q}, {k})")]
    return []


def _routing_findings() -> list[Violation]:
    """The wrappers' routing and refusals: past ``MAX_CAMS`` cameras the
    tile launcher; ``k`` past ``MAX_K`` and head widths the launchers
    refuse raise ``ValueError`` in the wrapper, before any launch; every
    plan the attention planners give for a width they take passes the
    guard (the sweep's widths), and the guard refuses the rest."""
    out = []
    if reid_topk.MAX_CAMS != _MAX_CAMS or reid_topk.MAX_K != _MAX_K:
        out.append(_finding("reid_topk_segment_masked",
                            f"reid_topk.MAX_CAMS / MAX_K "
                            f"({reid_topk.MAX_CAMS}, {reid_topk.MAX_K}) "
                            f"are not the kernel's ({_MAX_CAMS}, {_MAX_K})"))
    for C in (1, _MAX_CAMS, _MAX_CAMS + 1, 8192):
        want = "reid_topk_segment_masked" if C <= _MAX_CAMS else \
            "reid_topk_tiles"
        if reid_topk.camera_route(C)[1] != want:
            out.append(_finding("reid_topk_segment_masked",
                                f"C={C} routes to "
                                f"{reid_topk.camera_route(C)}, not {want}"))
        a = plan_args(case("reid_topk_segment_masked", Q=4, G=4, D=8, k=1,
                           C=C), 132)
        if launcher_accepts("reid_topk_segment_masked", a) != \
                (C <= _MAX_CAMS):
            out.append(_finding("reid_topk_segment_masked",
                                f"the camera guard at C={C} disagrees with "
                                f"the route"))
    x = torch.zeros((2, 8))
    tag = torch.zeros(2, dtype=torch.int32)
    adm = torch.ones((2, 4), dtype=torch.bool)
    for name, call in (("reid_topk_unmasked",
                        lambda k: ops.reid_topk(x, x, k)),
                       ("reid_topk_segment_masked",
                        lambda k: ops.reid_topk_segments(x, tag, adm, x, tag,
                                                         tag, k)),
                       ("reid_topk_tiles",
                        lambda k: ops.reid_topk_tiles(x, tag, adm, x, tag,
                                                      tag, k))):
        try:
            call(_MAX_K + 1)
            out.append(_finding(name, f"k={_MAX_K + 1} is served"))
        except ValueError:
            pass
    for hd in (4, 12, 264, 272):
        for dtype in (torch.float32, torch.bfloat16):
            for planner in (lambda: flash_attention.flash_plan(hd, dtype),
                            lambda: decode_attention.check_width(hd)):
                try:
                    planner()
                    out.append(_finding("flash_attention", f"hd={hd} "
                                        f"{dtype}: a planner takes it"))
                except ValueError:
                    pass
    q = torch.zeros((1, 3, 4, 8))
    kv = torch.zeros((1, 2, 4, 8))
    try:
        flash_attention.check_heads(q, kv, kv, 4)
        out.append(_finding("flash_attention", "H=3 over KV=2 passes the "
                                               "wrapper's check"))
    except ValueError:
        pass
    return out


def audit_kernels(sm_counts=SM_COUNTS) -> list[Violation]:
    """The geometry proof over the sweep at every SM count, the routing,
    and the sentinel probes on the plain versions; empty list = clean."""
    out = _routing_findings()
    for c in sweep():
        for n in sm_counts:
            out += _case_findings(c, n)
    return out + sentinel_probes("cpu")[0]


# ---------------------------------------------------------------------------
# Sentinel-convention probes
# ---------------------------------------------------------------------------

def sentinel_inputs() -> dict:
    """The probes' numpy inputs, drawn as the reference draws them."""
    rng = np.random.default_rng(5)
    D, C, G, TT = 8, 4, 6, 4
    x = dict(q=rng.normal(size=(3, D)).astype(np.float32),
             g2=rng.normal(size=(2, D)).astype(np.float32))
    x["g"] = rng.normal(size=(G, D)).astype(np.float32)
    x["gc"] = rng.integers(0, C, G).astype(np.int32)
    x["g_tile"] = rng.integers(0, TT, G).astype(np.int32)
    adm = np.zeros((3, C), bool)
    adm[1] = True                        # rows 0 and 2 fully masked
    x.update(adm=adm, D=D, C=C, G=G, TT=TT)
    return x


def sentinel_probes(device="cpu") -> tuple[list[Violation], list]:
    """The reference's sentinel probes, one for one, through
    ``repro_torch.kernels.ops`` on ``device``: the plain versions on the
    CPU, the kernels on a card.  Returns (findings, outputs): each output
    (probe, scores, idx) as numpy, in the reference's call order."""
    out: list[Violation] = []
    calls = []

    def expect(cond, msg):
        if not cond:
            out.append(Violation(RULE, "<cuda:sentinel>", 0, msg))

    def run(label, fn, *args):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             if isinstance(a, np.ndarray) else a for a in args]
        sv, si = fn(*t)
        sv, si = sv.cpu().numpy(), si.cpu().numpy()
        calls.append((label, sv, si))
        return sv, si

    def sentinel(sv, si):
        return bool((sv == ref.NEG_INF).all() and (si == -1).all())

    expect(float(ref.NEG_INF) == -1e30,
           f"NEG_INF is {ref.NEG_INF!r}, expected -1e30 — the sentinel the "
           "tie-break differentials encode")
    x = sentinel_inputs()
    q, g, gc, adm, G, C, TT = (x["q"], x["g"], x["gc"], x["adm"], x["G"],
                               x["C"], x["TT"])
    sv, si = run("bands past the gallery", ops.reid_topk, q, x["g2"], 5)
    expect(sentinel(sv[:, 2:], si[:, 2:]),
           "reid_topk: bands beyond the gallery are not (NEG_INF, -1)")
    sv, si = run("empty gallery", ops.reid_topk, q,
                 np.zeros((0, x["D"]), np.float32), 3)
    expect(sentinel(sv, si),
           "reid_topk: empty gallery does not return (NEG_INF, -1)")
    gf = np.full(G, 7, np.int32)
    qf = np.full(3, 7, np.int32)
    msv, msi = run("fully masked rows", ops.reid_topk_masked, q, qf, adm, g,
                   gc, gf, 2)
    expect(sentinel(msv[[0, 2]], msi[[0, 2]]),
           "reid_topk_masked: fully-masked rows are not (NEG_INF, -1)")
    expect(bool((msi[1] >= 0).all()),
           "reid_topk_masked: an admitted row with matching frames "
           "unexpectedly hit the sentinel")
    ones = np.ones((3, C), bool)
    sv, si = run("frame mismatch", ops.reid_topk_masked, q, qf, ones, g, gc,
                 gf + 1, 2)
    expect(sentinel(sv, si), "reid_topk_masked: frame-mismatched galleries "
                             "are not (NEG_INF, -1)")
    q_seg = np.full(3, 2, np.int32)        # frame 7 -> segment 2
    g_seg = np.full(G, 2, np.int32)
    ssv, ssi = run("segments relabelled", ops.reid_topk_segments, q, q_seg,
                   adm, g, gc, g_seg, 2)
    msv, msi = run("the frame variant", ops.reid_topk_masked, q, qf, adm, g,
                   gc, gf, 2)
    expect(np.array_equal(ssv, msv) and np.array_equal(ssi, msi),
           "reid_topk_segments: relabeled segment tags diverge from the "
           "frame-tag variant")
    sv, si = run("segment mismatch", ops.reid_topk_segments, q, q_seg, ones,
                 g, gc, g_seg + 1, 2)
    expect(sentinel(sv, si), "reid_topk_segments: segment-mismatched "
                             "galleries are not (NEG_INF, -1)")
    g_ct = (gc * TT + x["g_tile"]).astype(np.int32)
    adm_ct = np.repeat(adm, TT, axis=1)
    tsv, tsi = run("every tile admitted", ops.reid_topk_tiles, q, q_seg,
                   adm_ct, g, g_ct, g_seg, 2)
    expect(np.array_equal(tsv, msv) and np.array_equal(tsi, msi),
           "reid_topk_tiles: all-tiles-admitted diverges from the segment "
           "variant")
    adm_wrong = np.zeros((3, C * TT), bool)
    adm_wrong[:, 0] = True
    off_cell0 = np.where(g_ct == 0, 1, g_ct).astype(np.int32)
    sv, si = run("masked tile", ops.reid_topk_tiles, q, q_seg, adm_wrong, g,
                 off_cell0, g_seg, 2)
    expect(sentinel(sv, si), "reid_topk_tiles: tile-mismatched galleries "
                             "are not (NEG_INF, -1)")
    sv, si = run("unlabelled rows", ops.reid_topk_tiles, q, q_seg,
                 np.ones((3, C * TT), bool), g, np.full(G, -1, np.int32),
                 g_seg, 2)
    expect(sentinel(sv, si), "reid_topk_tiles: unlabeled (cell -1) rows are "
                             "not (NEG_INF, -1)")
    return out, calls


# ---------------------------------------------------------------------------
# Guard bands: launches into views inside larger buffers (on a card)
# ---------------------------------------------------------------------------

#: bytes of guard band on each side of every operand
GUARD = 4096
#: the guard bands' fill: a NaN in float32 and bfloat16, -1 in int32
GUARD_BYTE = 0xFF


def guard_band_cases() -> dict[str, list[Case]]:
    """For each launcher, ragged shapes and, last, its largest full-width
    shape (``full_widths``; the backward's, a training shape)."""
    reid = [(1, 1, 8, 1, 4), (5, 120, 16, 3, 30), (100, 700, 32, 2, 30),
            (16, 257, 16, 1, 130), (63, 63, 31, 16, 8), (64, 64, 32, 3, 8),
            (65, 65, 33, 5, 8), (33, 517, 64, 3, 8), (7, 70, 64, 16, 8),
            (130, 1024, 64, 1, 8), (64, 2048, 16, 16, 8),
            (256, 8193, 64, 16, 130), (256, 8192, 2048, 16, 130)]
    out = {
        "reid_topk_segment_masked": [
            case("reid_topk_segment_masked", Q=Q, G=G, D=D, k=k, C=C)
            for Q, G, D, k, C in reid],
        "reid_topk_tiles": [
            case("reid_topk_tiles", Q=Q, G=G, D=D, k=k, C=C * 64)
            for Q, G, D, k, C in reid],
        "reid_topk_unmasked": [
            case("reid_topk_unmasked", Q=Q, G=G, D=D, k=k)
            for Q, G, D, k, _ in reid]}
    out["flash_attention"] = [
        case("flash_attention", dtype, B=B, H=H, KV=KV, S=S, T=T, hd=hd,
             causal=causal)
        for B, H, KV, S, T, hd, causal, dtype in (
            (2, 4, 2, 256, 512, 64, True, "float32"),
            (1, 2, 2, 512, 256, 32, True, "float32"),
            (2, 4, 2, 63, 65, 64, True, "float32"),
            (2, 4, 2, 65, 63, 64, False, "bfloat16"),
            (1, 8, 1, 129, 127, 128, True, "bfloat16"),
            (1, 8, 1, 127, 129, 128, False, "float32"),
            (2, 4, 4, 100, 260, 8, True, "float32"),
            (2, 4, 4, 260, 100, 40, False, "bfloat16"),
            (1, 4, 2, 33, 31, 256, True, "float32"),
            (1, 4, 2, 65, 33, 256, False, "bfloat16"),
            (2, 6, 6, 150, 150, 80, False, "bfloat16"),
            (1, 2, 1, 1, 1, 136, True, "float32"),
            (8, 64, 8, 1024, 1024, 128, True, "bfloat16"))]
    out["flash_attention_bwd"] = [
        case("flash_attention_bwd", dtype, B=B, H=H, KV=KV, S=S, T=T, hd=hd,
             causal=causal)
        for B, H, KV, S, T, hd, causal, dtype in (
            (2, 4, 2, 33, 65, 64, True, "float32"),
            (2, 4, 2, 65, 31, 64, False, "bfloat16"),
            (1, 8, 1, 40, 40, 128, True, "bfloat16"),
            (2, 4, 4, 17, 70, 8, False, "float32"),
            (1, 4, 2, 33, 31, 256, True, "float32"),
            (1, 2, 1, 1, 1, 136, True, "bfloat16"),
            (2, 6, 6, 150, 150, 80, False, "float32"))] + [
        case("flash_attention_bwd", "bfloat16", **dict(TRAIN_SHAPES)[
            "whisper_tiny cross train"])]
    out["decode_attention"] = [
        case("decode_attention", dtype, B=len(length), H=H, KV=KV, T=T,
             hd=hd, length=length)
        for H, KV, T, hd, dtype, length in (
            (4, 2, 1024, 64, "float32", _lengths(2, 1023, 3)),
            (8, 2, 300, 64, "bfloat16", (0, 1, 300)),
            (32, 4, 2048, 128, "float32", (1056, 2048)),
            (12, 12, 700, 80, "bfloat16", (699, 1)),
            (40, 4, 4096, 128, "float32", (4096, 4095, 513, 1)),
            (8, 1, 17, 8, "float32", (17,)),
            (8, 8, 64, 256, "bfloat16", (63, 64)),
            (6, 6, 1500, 64, "bfloat16", (1500, 1500)),
            (24, 8, 513, 40, "float32", (0, 512, 513)),
            (64, 8, 2048, 128, "bfloat16", (1056, 1056)),
            (2, 1, 129, 136, "float32", (128, 129, 1, 0, 64)),
            (32, 32, 32768, 80, "bfloat16", _lengths(4, 32768, 2)),
            (32, 4, 32768, 128, "bfloat16", _lengths(128, 32768, 1)))]
    out["mamba_scan"] = [
        case("mamba_scan", B=B, L=L, D=D, N=N, final_state=final)
        for B, L, D, N, final in (
            (2, 256, 256, 16, False), (1, 1, 1, 1, True),
            (2, 63, 65, 4, True), (1, 65, 31, 5, True),
            (2, 300, 65, 320, True), (2, 1001, 192, 16, True),
            (1, 33, 257, 17, False), (3, 129, 64, 16, True),
            (1, 1024, 256, 16, True), (2, 17, 100, 8, True),
            (1, 2048, 512, 64, True), (4, 64, 4096, 16, False),
            (8, 1024, 8192, 16, True))]
    return out


def _guarded(shape, dtype, device, fill=None):
    """(buffer, view): ``view`` of ``shape`` and ``dtype`` inside a uint8
    buffer with ``GUARD`` bytes of ``GUARD_BYTE`` on each side; the view
    holds ``fill`` (a tensor) where given, else the guard pattern."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = torch.full((n + 2 * GUARD,), GUARD_BYTE, dtype=torch.uint8,
                     device=device)
    view = buf[GUARD:GUARD + n].view(dtype).view(shape)
    if fill is not None:
        view.copy_(fill)
    return buf, view


def _reid_inputs(c: Case, gen, device):
    s = c.s
    Q, G, D = s["Q"], s["G"], s["D"]

    def ints(lo, hi, *size, dtype=torch.int32):
        return torch.randint(lo, hi, size, generator=gen, device=device,
                             dtype=dtype)

    # small integers: every score exact in float32, so kernel and plain
    # version agree bit for bit, ties included
    q = ints(-2, 3, Q, D, dtype=torch.int64).float()
    g = ints(-2, 3, G, D, dtype=torch.int64).float()
    if c.kernel == "reid_topk_unmasked":
        return dict(q=q, g=g)
    W = s["C"]
    admit = torch.rand((Q, W), generator=gen, device=device) < 0.7
    return dict(q=q, q_tag=ints(0, 3, Q), admit=admit, g=g,
                gal_cam=ints(-1, W, G), gal_tag=ints(0, 3, G))


def guard_band_run(c: Case, device="cuda", seed=0) -> dict:
    """Run the launcher of ``c`` once, through ``build.launcher``, on
    views inside guarded buffers (inputs, outputs and workspace alike),
    with the plan the wrapper would use on this card.  Returns the
    outputs, the plain version's outputs on the same inputs, the bytes of
    guard band and of input that changed, the ticket counters left
    nonzero (decode) and the plan."""
    from repro_torch.kernels import build
    from repro_torch.kernels.inputs import make_inputs

    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    args = plan_args(c, torch.cuda.get_device_properties(
        index).multi_processor_count)
    s, e = c.s, LAUNCH_TABLE[c.kernel]
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = _torch_dtype(c.dtype)
    if c.kernel.startswith("reid"):
        inputs = _reid_inputs(c, gen, device)
        Q, k, K = s["Q"], s["k"], reid_topk.round_k(s["k"])
        outs = dict(out_v=((Q, k), torch.float32),
                    out_i=((Q, k), torch.int32))
        work = dict(ws_v=((Q, args["S"], K), torch.float32),
                    ws_i=((Q, args["S"], K), torch.int32)) \
            if args["S"] > 1 else {}
    elif c.kernel == "flash_attention":
        (q, k_, v), _ = make_inputs(c.kernel, s, device, seed)
        inputs = dict(q=q.to(dtype), k=k_.to(dtype), v=v.to(dtype))
        del k_, v
        # the launch under grad: o and each row's logsumexp
        outs = dict(o=(tuple(q.shape), dtype),
                    lse=((s["B"], s["H"], s["S"]), torch.float32))
        work = {}
    elif c.kernel == "flash_attention_bwd":
        (q, k_, v), _ = make_inputs("flash_attention", s, device, seed)
        q, k_, v = q.to(dtype), k_.to(dtype), v.to(dtype)
        do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
        inputs = dict(q=q, k=k_, v=v, o=ref.flash_attention_ref(
            q, k_, v, causal=s["causal"]), lse=ref.flash_attention_lse_ref(
                q, k_, causal=s["causal"]), do=do)
        del k_, v
        outs = dict(dq=(tuple(q.shape), dtype),
                    dk=(tuple(inputs["k"].shape), dtype),
                    dv=(tuple(inputs["k"].shape), dtype))
        work = dict(delta=((s["B"], s["H"], s["S"]), torch.float32))
        if args["ws_k"]:
            work.update({n: ((s["B"], s["H"], s["T"], s["hd"]),
                             torch.float32) for n in ("ws_k", "ws_v")})
    elif c.kernel == "decode_attention":
        (q, k_, v, _), _ = make_inputs(
            c.kernel, dict(s, length="full"), device, seed)
        inputs = dict(q=q.to(dtype), k=k_.to(dtype), v=v.to(dtype),
                      length=torch.tensor(s["length"], dtype=torch.int32,
                                          device=device))
        del k_, v                  # float32 copies of a long cache
        outs = dict(o=(tuple(q.shape), dtype))
        work = dict(ws=((s["B"] * s["H"] * args["splits"] * (s["hd"] + 2),),
                        torch.float32)) if args["splits"] > 1 else {}
    else:
        (u, dt, Bm, Cm, A), _ = make_inputs(c.kernel, s, device, seed)
        inputs = dict(u=u, dt=dt, Bm=Bm, Cm=Cm, A=A)
        outs = dict(y=(tuple(u.shape), torch.float32))
        if s["final_state"]:
            outs["hL"] = ((s["B"], s["D"], s["N"]), torch.float32)
        ws = ((s["B"], args["segs"], s["N"], s["D"]), torch.float32)
        work = {name: ws for name in ("ws_h", "ws_p") if args[name]}
    bufs, views, before = {}, {}, {}
    for name, t in inputs.items():
        bufs[name], views[name] = _guarded(tuple(t.shape), t.dtype, device, t)
        before[name] = bufs[name][GUARD:len(bufs[name]) - GUARD].clone()
    for name, (shape, dt_) in {**outs, **work}.items():
        bufs[name], views[name] = _guarded(shape, dt_, device)
    if c.kernel == "decode_attention" and args["splits"] > 1:
        n = s["B"] * s["KV"] * args["plan"].groups
        bufs["counters"], views["counters"] = _guarded(
            (n,), torch.int32, device, torch.zeros(n, dtype=torch.int32))
    fn = build.launcher(e.source[len("csrc/"):-len(".cu")], e.symbol,
                        (ctypes.c_void_p,) * len(e.pointers)
                        + (ctypes.c_int,) * (len(e.ints) + 1)
                        + (ctypes.c_void_p,))
    ptrs = [views[p].data_ptr() if p in views else None for p in e.pointers]
    first = next(iter(views.values()))
    build.check(fn(*ptrs, *(args[i] for i in e.ints),
                   *build.device_and_stream(first)), e.symbol)
    torch.cuda.synchronize(device)
    guard_bytes = sum(
        int((b[:GUARD] != GUARD_BYTE).sum() + (b[-GUARD:] != GUARD_BYTE).sum())
        for b in bufs.values())
    input_bytes = sum(
        int((bufs[n][GUARD:len(bufs[n]) - GUARD] != before[n]).sum())
        for n in inputs)
    counters = int((views["counters"] != 0).sum()) if "counters" in views \
        else 0
    return dict(outputs=tuple(views[n] for n in outs),
                plain=_plain(c, inputs), guard_bytes=guard_bytes,
                input_bytes=input_bytes, counters_left=counters,
                plan=_plan_text(c, args))


def _plain(c: Case, x: dict) -> tuple:
    """The plain version's outputs on the inputs of ``guard_band_run``."""
    k = c.s.get("k")
    if c.kernel == "reid_topk_unmasked":
        return ref.reid_topk_ref(x["q"], x["g"], k)
    if c.kernel == "reid_topk_segment_masked":
        return ref.reid_topk_segments_ref(x["q"], x["q_tag"], x["admit"],
                                          x["g"], x["gal_cam"],
                                          x["gal_tag"], k)
    if c.kernel == "reid_topk_tiles":
        return ref.reid_topk_tiles_ref(x["q"], x["q_tag"], x["admit"],
                                       x["g"], x["gal_cam"], x["gal_tag"], k)
    if c.kernel == "flash_attention":
        return (ref.flash_attention_ref(x["q"], x["k"], x["v"],
                                        causal=c.s["causal"]),
                ref.flash_attention_lse_ref(x["q"], x["k"],
                                            causal=c.s["causal"]))
    if c.kernel == "flash_attention_bwd":
        return ref.flash_attention_bwd_ref(x["q"], x["k"], x["v"], x["o"],
                                           x["lse"], x["do"],
                                           causal=c.s["causal"])
    if c.kernel == "decode_attention":
        # eight rows at a time: the plain version's float32 copies of a
        # long bfloat16 cache would not fit the card at once
        return (torch.cat([ref.decode_attention_ref(
            x["q"][b:b + 8], x["k"][b:b + 8], x["v"][b:b + 8],
            x["length"][b:b + 8]) for b in range(0, c.s["B"], 8)]),)
    s = c.s
    h0 = torch.zeros((s["B"], s["D"], s["N"]), dtype=torch.float32,
                     device=x["u"].device)
    y, h = ref.mamba_scan_ref(x["u"], x["dt"], x["Bm"], x["Cm"], x["A"], h0)
    return (y, h) if s["final_state"] else (y,)


def _plan_text(c: Case, a: dict) -> str:
    if c.kernel.startswith("reid"):
        return f"{_cdiv(a['Q'], _BQ)}x{a['S']}"
    if c.kernel == "flash_attention":
        return f"rows{a['rows']} keys{a['bk']}x{a['splits']} " \
               f"stages{a['stages']}"
    if c.kernel == "flash_attention_bwd":
        return str(a["plan"])
    return str(a["plan"])
