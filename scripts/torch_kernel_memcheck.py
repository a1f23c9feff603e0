#!/usr/bin/env python
"""The ragged guard-band launches of ``chip_smoke.py`` phase 23(b) under
``compute-sanitizer --tool memcheck``, which catches the out-of-bounds
reads and misaligned accesses that guard bands cannot see.

    python scripts/torch_kernel_memcheck.py

Builds the seven CUDA sources (``kernels.build``), then reruns itself with
``--child`` under ``compute-sanitizer --tool memcheck --error-exitcode 1``
with PyTorch's caching allocator off (``PYTORCH_NO_CUDA_MEMORY_CACHING``),
so that every tensor is an allocation of its own and a stray access past
one is an error.  The child runs each launcher once at each ragged shape
of ``kernel_audit.guard_band_cases`` (all but the full-width one: the
sanitizer slows a kernel by orders of magnitude) and holds the guard
bands, the inputs and the outputs as phase 23 does.  Exits with the
child's code, 0 when memcheck reports no error; exits 2, and passes
nothing, where there is no card, the toolkit has no
``compute-sanitizer``, or the sanitizer does not support the card.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("reid_topk", "reid_topk_tiles", "reid_topk_plain",
           "flash_attention", "flash_attention_bwd", "decode_attention",
           "mamba_scan")


def find_sanitizer() -> str | None:
    """``compute-sanitizer`` beside nvcc, on ``PATH``, or under
    ``/usr/local/cuda``; None where there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin")
    on_path = shutil.which("compute-sanitizer")
    if on_path:
        return on_path
    candidates += [Path("/usr/local/cuda/bin"),
                   Path("/usr/local/cuda/compute-sanitizer")]
    for d in candidates:
        if (d / "compute-sanitizer").is_file():
            return str(d / "compute-sanitizer")
    return None


def child() -> int:
    """The launches under the sanitizer: 0 when every hold passes."""
    import torch

    from repro_torch.analysis import kernel_audit as ka

    torch.backends.cuda.matmul.allow_tf32 = False
    bad = n = 0
    for kernel, cases in ka.guard_band_cases().items():
        for c in cases[:-1]:
            r = ka.guard_band_run(c, "cuda", seed=23)
            faults = []
            if r["guard_bytes"] or r["input_bytes"] or r["counters_left"]:
                faults.append(f"{r['guard_bytes']} guard and "
                              f"{r['input_bytes']} input bytes changed, "
                              f"{r['counters_left']} counters left")
            for got, want in zip(r["outputs"], r["plain"]):
                if kernel.startswith("reid"):
                    ok = torch.equal(got, want)
                else:
                    tol = 2e-2 if got.dtype == torch.bfloat16 else \
                        1e-4 if kernel == "mamba_scan" else 2e-5
                    ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                        atol=tol)
                if not ok:
                    faults.append("outputs differ from the plain version")
            n += 1
            bad += bool(faults)
            print(f"{c}: plan {r['plan']}: "
                  + ("; ".join(faults) if faults else "held"), flush=True)
    print(f"memcheck child: {n} guarded launches, {bad} failed", flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, str(REPO / "src"))
    if argv == ["--child"]:
        return child()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_memcheck: no card (torch.cuda.is_available() is "
              "False); nothing checked")
        return 2
    sanitizer = find_sanitizer()
    if sanitizer is None:
        print("torch_kernel_memcheck: the CUDA toolkit here has no "
              "compute-sanitizer; nothing checked, so this is no pass")
        return 2
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for path in pool.map(build.build, SOURCES):
            print(f"built {path.name}", flush=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")] + [p for p in [
                       os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sanitizer, "--tool", "memcheck",
                           "--error-exitcode", "1", sys.executable,
                           str(Path(__file__).resolve()), "--child"],
                          env=env, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    print(proc.stdout, end="", flush=True)
    took = time.perf_counter() - t0
    if "Device not supported" in proc.stdout:
        print(f"torch_kernel_memcheck: {sanitizer} does not support this "
              f"card, and every CUDA call under it failed; nothing checked "
              f"({took:.1f} s), so this is no pass")
        return 2
    print(f"torch_kernel_memcheck: {sanitizer} exited {proc.returncode} "
          f"after {took:.1f} s", flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
