"""The decode-attention kernel under several launch plans, on one card:

    PYTHONPATH=src python -m repro_torch.benchmarks.decode_plans

At the kernel benchmark's shape and at the model widths of
``chip_smoke.py``'s phase 10 (yi-6b's ``decode_32k`` at batch 8 and 128,
zamba2-2.7b at batch 32), each candidate plan of ``csrc/decode_attention.cu``
(4 or 8 warps a block; half, the same or twice the tile; half, the same
or twice the split of ``decode_attention.decode_plan``'s pick) is run on
the same inputs, held to the plain version on the first 8 rows (2e-5 in
float32, 2e-2 in bfloat16) and timed with its combine
(``kernels_bench.device_ms``), beside the byte bound of the run's lengths.
One line a (shape, plan); ``*`` marks the plan ``decode_plan`` picks.
This is how the plan's split length, tile and warps are weighed; the
port runs only ``decode_plan``'s choice.  Raises without a card.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks import kernels_bench
from repro_torch.kernels import decode_attention, ref

#: (label, shape, dtype): the benchmark's shape and phase 10's widths
SHAPES = (
    ("bench", dict(B=4, H=8, KV=2, T=8192, hd=64, length="full"),
     torch.float32),
    ("yi-6b B8", dict(B=8, H=32, KV=4, T=32768, hd=128, length="random"),
     torch.float32),
    ("yi-6b B128", dict(B=128, H=32, KV=4, T=32768, hd=128,
                        length="random"), torch.bfloat16),
    ("yi-6b B128", dict(B=128, H=32, KV=4, T=32768, hd=128,
                        length="random"), torch.float32),
    ("zamba2-2.7b B32", dict(B=32, H=32, KV=32, T=32768, hd=80,
                             length="random"), torch.bfloat16),
)
HOLD_ROWS = 8
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def candidates(B, H, KV, T, hd, dtype, picked):
    """``picked`` and its neighbours: 4 or 8 warps, the tile halved or
    doubled, the split halved or doubled; those the card cannot hold are
    left out."""
    item = 2 if dtype == torch.bfloat16 else 4
    sk = decode_attention.score_keys(picked.hdp, picked.heads, item)
    plans = {picked}
    for warps in decode_attention.WARPS:
        for tf in (0.5, 1, 2):
            tile = max(sk, int(picked.tile * picked.warps / warps * tf)
                       // sk * sk)
            rounds = warps * tile
            for sf in (0.5, 1, 2):
                split = max(rounds, round(picked.split * sf / rounds)
                            * rounds)
                try:
                    plans.add(decode_attention.make_plan(
                        B, H, KV, T, hd, dtype, heads=picked.heads,
                        tile=tile, split=split, warps=warps))
                except ValueError:
                    pass
    return sorted(plans, key=lambda p: (p.warps, p.tile, p.split))


def sweep(device="cuda"):
    """Rows of (label, dtype, plan, ms, bound ms, max abs err, picked)."""
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, s, dtype in SHAPES:
        args, _ = kernels_bench.make_inputs("decode_attention", s, device,
                                            seed=1)
        args = tuple(a.to(dtype) if a.is_floating_point() else a
                     for a in args)
        q, k, v, length = args
        B, H, hd = q.shape
        KV, T = k.shape[1], k.shape[2]
        bound, _ = kernels_bench.bound_ms(
            *kernels_bench.cost("decode_attention", args, {}),
            kernels_bench.peak_flops("decode_attention", args))
        want = ref.decode_attention_ref(*(a[:HOLD_ROWS] for a in args))
        picked = decode_attention.decode_plan(B, H, KV, T, hd, dtype, n_sms)
        out = torch.empty_like(q)
        for plan in candidates(B, H, KV, T, hd, dtype, picked):
            def call(plan=plan):
                decode_attention.launch(q, k, v, length, out, plan)

            call()
            got = out[:HOLD_ROWS].float()
            err = float((got - want.float()).abs().max())
            if not torch.allclose(got, want.float(), rtol=TOL[dtype],
                                  atol=TOL[dtype]):
                raise AssertionError(f"{label} {plan}: max abs err {err}")
            rows.append((label, dtype, plan,
                         kernels_bench.device_ms(call, calls=5, replays=10),
                         bound, err, plan == picked))
        del args, q, k, v, out, want
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    for label, dtype, plan, ms, bound, err, picked in sweep():
        print(f"{'*' if picked else ' '} {label} {str(dtype)[6:]} {plan}: "
              f"{ms:.4f} ms, {ms / bound:.2f}x the bound {bound:.4f} ms "
              f"(max abs err {err:.3g})")


if __name__ == "__main__":
    main()
