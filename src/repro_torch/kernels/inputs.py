"""Inputs of the kernel wrappers (``repro_torch.kernels.ops``) drawn from a
seeded ``torch.Generator``, with the JAX benchmark's distributions: the
kernel benchmark (``repro_torch.benchmarks.kernels_bench``), its plan
sweeps and the launch-bounds audit (``repro_torch.analysis.kernel_audit``)
draw theirs here."""
from __future__ import annotations

import torch


def make_inputs(name: str, shape: dict, device, seed: int = 0):
    """(args, kwargs) of ``ops.<name>`` at ``shape``, float32, drawn on
    ``device`` from a generator seeded with ``seed``; distributions as the
    JAX benchmark's.  Decode lengths are T (``length="full"``) or drawn in
    [1, T] (``"random"``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*size, scale=1.0):
        return torch.randn(size, generator=gen, device=device) * scale

    s = shape
    if name == "reid_topk":
        return (normal(s["Q"], s["D"]), normal(s["G"], s["D"]), s["k"]), {}
    if name == "flash_attention":
        return ((normal(s["B"], s["H"], s["S"], s["hd"]),
                 normal(s["B"], s["KV"], s["T"], s["hd"]),
                 normal(s["B"], s["KV"], s["T"], s["hd"])),
                dict(causal=s["causal"]))
    if name == "decode_attention":
        B, T = s["B"], s["T"]
        if s["length"] == "full":
            length = torch.full((B,), T, dtype=torch.int32, device=device)
        else:
            length = torch.randint(1, T + 1, (B,), generator=gen,
                                   device=device, dtype=torch.int32)
        return (normal(B, s["H"], s["hd"]),
                normal(B, s["KV"], T, s["hd"]),
                normal(B, s["KV"], T, s["hd"]), length), {}
    if name == "mamba_scan":
        B, L, D, N = s["B"], s["L"], s["D"], s["N"]
        u = normal(B, L, D, scale=0.5)
        dt = torch.nn.functional.softplus(normal(B, L, D)) * 0.1
        Bm, Cm = normal(B, L, N, scale=0.5), normal(B, L, N, scale=0.5)
        A = -torch.exp(normal(D, N, scale=0.3))
        return (u, dt, Bm, Cm, A), {}
    raise KeyError(name)
