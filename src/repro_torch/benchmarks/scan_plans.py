"""The Mamba scan kernel under several launch plans, on one card:

    PYTHONPATH=src python -m repro_torch.benchmarks.scan_plans

At the kernel benchmark's shape and at falcon-mamba-7b's width
(``kernels_bench.SHAPES`` and ``chip_smoke.py``'s phase 10), each
candidate plan of ``csrc/mamba_scan.cu`` (warps across time, steps a
thread, segments of L) is run on the same inputs, held to the plain
version within 1e-4 and timed (``kernels_bench.device_ms``).  One line a
(shape, plan); ``*`` marks the plan ``mamba_scan.scan_plan`` picks.  This
is how the plan's weighing of one pass against segments is measured; the
port runs only ``scan_plan``'s choice.  Raises without a card.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks import kernels_bench
from repro_torch.kernels import mamba_scan

SHAPES = {"bench": dict(B=1, L=1024, D=256, N=16),
          "falcon-mamba-7b": dict(B=1, L=4096, D=8192, N=16)}
#: (lanes a channel, entries a lane, warps a block, chunk, segments)
#: tried at every shape
CANDIDATES = ((4, 4, 4, 64, 1), (4, 4, 8, 64, 1), (4, 4, 4, 32, 1),
              (2, 8, 2, 64, 1), (8, 1, 8, 64, 1), (4, 4, 4, 64, 2),
              (4, 4, 4, 64, 16), (4, 4, 4, 32, 32), (4, 4, 4, 16, 64),
              (4, 4, 8, 32, 32), (8, 1, 8, 16, 64), (2, 8, 2, 32, 32))
TOL = 1e-4


def sweep(device="cuda"):
    """Rows of (shape name, plan, ms, max abs err, picked)."""
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, s in SHAPES.items():
        args, _ = kernels_bench.make_inputs("mamba_scan", s, device, seed=1)
        want = kernels_bench.plain("mamba_scan")(*args)
        picked = mamba_scan.scan_plan(s["B"], s["L"], s["D"], s["N"], n_sms)
        plans = {mamba_scan.make_plan(s["B"], s["L"], s["D"], s["N"], nl=nl,
                                      eg=eg, warps=w, chunk=c, segments=sg)
                 for nl, eg, w, c, sg in CANDIDATES} | {picked}
        for plan in sorted(plans, key=lambda p: (p.segments, p.nl, p.warps,
                                                 p.chunk)):
            y = torch.empty_like(args[0])

            def call(plan=plan, y=y):
                mamba_scan.launch(*args, y, plan)

            call()
            err = float((y - want).abs().max())
            if not torch.allclose(y, want, rtol=TOL, atol=TOL):
                raise AssertionError(f"{label} {plan}: max abs err {err}")
            rows.append((label, plan, kernels_bench.device_ms(call), err,
                         plan == picked))
        del args, want
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    for label, plan, ms, err, picked in sweep():
        print(f"{'*' if picked else ' '} {label} {plan}: {ms:.4f} ms "
              f"(max abs err {err:.3g})")


if __name__ == "__main__":
    main()
