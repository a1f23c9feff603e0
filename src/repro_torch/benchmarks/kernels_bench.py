"""Kernel benchmark of the PyTorch/CUDA port, the counterpart of
``benchmarks/kernels_bench.py`` (``benchmarks/run.py --only kernels``).

Runs the four kernels that benchmark runs, each at its shape, on inputs
drawn from a ``torch.Generator`` seed, through ``repro_torch.kernels.ops``:

    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench [--device cpu|cuda]

prints the JAX runner's CSV, ``name,us_per_call,derived``, one row per
kernel.  On the card (``--device cuda``, the default; it raises without
one) ``us_per_call`` is the kernel's device time and ``plain_us`` its
plain version's, both from CUDA events around CUDA-graph replays of
back-to-back calls (``device_ms``); ``bound_us`` is the larger of the
bytes the call must move over 3.35 TB/s and its operations over the peak
of the unit the kernel computes on (``peak_flops``: the CUDA cores' fp32
67 TFLOP/s for the re-id top-k and the scan; for attention the tensor
cores, 989 TFLOP/s in bfloat16 and 495 / 3 = 165 TFLOP/s in float32,
which takes three TF32 products; the H100 SXM data sheet's peaks), and
``bound_by`` says which.
On the CPU (``--device cpu``) both times are host-clock times of the plain
versions, marked ``clock=host``: no device figure.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.inputs import make_inputs

FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM, bf16 on the tensor cores, dense
TF32X3_FLOPS = 495e12 / 3   # H100 SXM, fp32 as three TF32 tensor products
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3

#: the JAX benchmark's shapes (``benchmarks/kernels_bench.py``), all float32
SHAPES = {
    "reid_topk": dict(Q=256, G=8192, D=64, k=16),
    "flash_attention": dict(B=1, H=8, KV=2, S=1024, T=1024, hd=64,
                            causal=True),
    "decode_attention": dict(B=4, H=8, KV=2, T=8192, hd=64, length="full"),
    "mamba_scan": dict(B=1, L=1024, D=256, N=16),
}


def plain(name: str):
    """The plain PyTorch version of ``ops.<name>``, with its signature."""
    if name == "mamba_scan":
        def scan(u, dt, Bm, Cm, A):
            h0 = torch.zeros((u.shape[0], u.shape[2], Bm.shape[2]),
                             dtype=torch.float32, device=u.device)
            return ref.mamba_scan_ref(u, dt, Bm, Cm, A, h0)[0]
        return scan
    return getattr(ref, f"{name}_ref")


def cost(name: str, args, kwargs) -> tuple[float, float]:
    """(operations, bytes) the call needs on these inputs: each
    input read once and each output written once; attention counts only
    the (query, key) pairs the causal mask or the valid lengths leave."""
    if name == "reid_topk":
        q, g, k = args
        Q, D = q.shape
        G = g.shape[0]
        return 2.0 * Q * G * D, 4.0 * (Q * D + G * D) + 8.0 * Q * k
    if name == "flash_attention":
        q, k, v = args
        B, H, S, hd = q.shape
        T = k.shape[2]
        if kwargs.get("causal", True):
            pos = torch.arange(S, dtype=torch.float64)
            pairs = float(torch.clamp(pos + 1, max=T).sum())
        else:
            pairs = float(S * T)
        item = q.element_size()
        return (4.0 * B * H * pairs * hd,
                item * (2.0 * q.numel() + k.numel() + v.numel()))
    if name == "decode_attention":
        q, k, v, length = args
        B, H, hd = q.shape
        KV, T = k.shape[1], k.shape[2]
        keys = float(length.clamp(0, T).sum())
        item = q.element_size()
        return (4.0 * H * keys * hd,
                item * (2.0 * q.numel() + 2.0 * KV * keys * hd) + 4.0 * B)
    if name == "mamba_scan":
        u, dt, Bm, Cm, A = args
        B, L, D = u.shape
        N = Bm.shape[2]
        # per (b, t, d, n): dt*A, exp, two products and a sum into h, one
        # FMA into y; per (b, t, d): dt*u; with ``final_state`` h_L written
        # too
        return (B * L * D * (7.0 * N + 1),
                4.0 * (3 * u.numel() + 2 * Bm.numel() + A.numel()
                       + (B * D * N if kwargs.get("final_state") else 0)))
    raise KeyError(name)


def peak_flops(name: str, args) -> float:
    """The peak rate of the unit ``ops.<name>`` computes on, for these
    inputs: the tensor cores for attention (bfloat16, or float32 as
    3xTF32), the CUDA cores' fp32 for the re-id top-k and the scan, whose
    contracts keep one fp32 FMA chain per output."""
    if name in ("flash_attention", "decode_attention"):
        return BF16_FLOPS if args[0].dtype == torch.bfloat16 \
            else TF32X3_FLOPS
    return FP32_FLOPS


def bound_ms(flops: float, nbytes: float,
             peak: float = FP32_FLOPS) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it:
    ``flops`` at ``peak`` per second or ``nbytes`` at the memory's rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, calls: int = 10, replays: int = 25) -> float:
    """Median device time of one ``fn()`` call on the card: ``calls``
    back-to-back calls captured in a CUDA graph, replayed ``replays``
    times, each replay timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_ms(fn, calls: int = 3) -> float:
    """Median host-clock time of one ``fn()`` call (CPU runs only)."""
    fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device="cuda", *, record: dict | None = None):
    """Run every kernel once at its ``SHAPES`` entry, on inputs drawn from
    seed 0, and time it beside its plain version; returns ``(name,
    us_per_call, derived)`` rows named ``kernels/<kernel>``.  ``record``,
    when given, receives ``{kernel: (args, kwargs, output)}`` of each first
    call, for a caller to check."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rows = []
    for name, shape in SHAPES.items():
        args, kwargs = make_inputs(name, shape, dev)
        calls = [0]
        op, base = getattr(ops, name), plain(name)

        def kernel():
            calls[0] += 1
            return op(*args, **kwargs)

        out = kernel()
        if record is not None:
            record[name] = (args, kwargs, out)
        if on_card:
            us = device_ms(kernel) * 1e3
            # fewer calls: the plain scan is thousands of small launches
            plain_us = device_ms(lambda: base(*args, **kwargs), calls=3,
                                 replays=10) * 1e3
        else:
            us = host_ms(kernel) * 1e3
            plain_us = host_ms(lambda: base(*args, **kwargs)) * 1e3
        flops, nbytes = cost(name, args, kwargs)
        peak = peak_flops(name, args)
        b_ms, b_by = bound_ms(flops, nbytes, peak)
        derived = (f"plain_us={plain_us:.3f};bound_us={b_ms * 1e3:.4f};"
                   f"bound_by={b_by};flops={flops:.4g};peak={peak:.4g};"
                   f"bytes={nbytes:.4g};"
                   f"calls={calls[0]};device={dev.type}"
                   + ("" if on_card else ";clock=host"))
        rows.append((f"kernels/{name}", us, derived))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for name, us, derived in run(args.device):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
