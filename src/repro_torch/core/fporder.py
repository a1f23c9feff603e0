"""float32 reductions in a fixed order, spelled out in elementwise ops.

A library reduction (``einsum``, ``sum``, ``linalg.norm``) sums in an
order of its own, and the order differs between the host's and the card's
libraries, so the same inputs can give results one ulp apart.  Where such
a result decides an integer (the tracker's ``d < match_thresh`` and its
argmin feed every later step of a query), this port sums through the
functions below instead.  Each one is elementwise float32 arithmetic in an
order written out here, so the card and the host give the same bits.  The
orders are those of the JAX reference's compiled CPU program, so the
host's bits also equal the reference's:

- ``dot8`` is XLA's CPU matrix-vector product: eight lanes, lane l
  accumulating elements l, l + 8, ... by fused multiply-add from 0; a row
  in a full tile of eight rows folds its lanes as
  ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)), a row after the last full
  tile as ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7)); the D % 8 tail is an
  FMA chain of its own, added last.  (A lone row, R = 1, takes another
  lowering there; the tracker's rows are C * K > 1.)
- ``seq_sum`` is XLA's CPU reduce: a sequential sum up to 32 terms; past
  32, sequential sums over 32-term windows of the axis padded evenly with
  zeros on both sides, summed in turn.

The fused multiply-add is emulated in float64 and rounded once (``fma``).
The host's float32 ``sqrt`` and division are not always correctly
rounded (one ulp off at times), so ``sqrt`` and ``div`` take float64,
where one rounding to float32 after the exact float64 result's own is
still correct (53 >= 2 * 24 + 2 bits).

``tree_sum`` is a plain pairwise sum for a contraction whose reference
order this module does not reproduce (identity detection's propagation):
it gives the host and the card the same bits, not the reference's.
"""
from __future__ import annotations

import torch


_MID = 1 << 28          # the float64 mantissa bits below float32's: a tie
_LOW = (1 << 29) - 1


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once.

    The product of two float32s is exact in float64; the float64 sum s and
    its exact error e (Knuth's two-sum) give a + b * c = s + e.  Rounding s
    to float32 is then right unless s lies on a float32 tie while e != 0:
    there s moves one float64 ulp towards e first."""
    p = a.double() * torch.as_tensor(b).double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    tie = (s.view(torch.int64) & _LOW) == _MID
    off = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(tie & (e != 0), torch.nextafter(s, off), s)
    return s.float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 quotient."""
    return (a.double() / b.double()).float()


def _fold_pairs(a: torch.Tensor) -> torch.Tensor:
    """((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)) over the last axis."""
    return ((a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])) + \
        ((a[..., 4] + a[..., 5]) + (a[..., 6] + a[..., 7]))


def _fold_halves(a: torch.Tensor) -> torch.Tensor:
    """((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7)) over the last axis."""
    return ((a[..., 0] + a[..., 4]) + (a[..., 2] + a[..., 6])) + \
        ((a[..., 1] + a[..., 5]) + (a[..., 3] + a[..., 7]))


def dot8(g: torch.Tensor, q: torch.Tensor,
         tail_row: torch.Tensor) -> torch.Tensor:
    """(n,) float32 dot products of the rows of ``g`` and ``q`` (both
    (n, D) float32) in XLA's CPU matrix-vector order.  ``tail_row`` (n,)
    bool marks rows that lie after the last full tile of eight rows of
    their matrix (row index >= R - R % 8), which fold their lanes the
    other way."""
    n, D = g.shape
    D8 = D - D % 8
    g8 = g[:, :D8].reshape(n, D8 // 8, 8)
    q8 = q[:, :D8].reshape(n, D8 // 8, 8)
    acc = g.new_zeros((n, 8))
    for j in range(D8 // 8):
        acc = fma(g8[:, j], q8[:, j], acc)
    out = torch.where(tail_row, _fold_halves(acc), _fold_pairs(acc))
    if D8 < D:
        tail = g.new_zeros((n,))
        for k in range(D8, D):
            tail = fma(g[:, k], q[:, k], tail)
        out = out + tail
    return out


def _seq(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU reduce order."""
    n = x.shape[-1]
    if n <= 32:
        return _seq(x)
    # 32-term windows over the axis zero-padded evenly on both sides (a
    # sequential sum from 0 passes the zeros unchanged)
    pad = -n % 32
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return _seq(_seq(x.unflatten(-1, (-1, 32))))


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Pairwise sum over the last axis: halves added until one is left,
    the axis zero-padded to a power of two first."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]
