"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source compiles to its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), for ``sm_90a`` only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \\
         src/repro_torch/kernels/csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root, named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header rebuilds and an unchanged one loads at once.  Nothing is built when a module is imported:
the first launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes, keyed by source, headers
    and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path.  The compiler's register and spill report goes to
    ``<library>.log``."""
    path = library_path(name)
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    path.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed on {name}.cu (exit {proc.returncode}):"
                         f"\n{proc.stdout}")
    os.replace(tmp, path)       # atomic: a reader never sees half a file
    return path


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it on first use."""
    return ctypes.CDLL(str(build(name)))
